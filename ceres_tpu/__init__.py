"""ceres_tpu — a differentiable ray tracer in JAX.

A from-scratch JAX/XLA/Pallas reimagining of the capabilities of the CERES
ray tracer (C++17/OpenMP). Not a port: the acceleration structure is a
flattened, device-resident set of morton-ordered triangle clusters (plus an
LBVH), and the hot loop is a Pallas walk kernel (Triton route on the GPU)
over per-tile candidate lists, with Möller-Trumbore intersection factored
into per-ray features times per-triangle weights. Gradients flow to vertex
positions, normals, and camera parameters.

Layer map (mirrors SURVEY.md §1):
  L4 apps/CLI      ceres_tpu.cli (render/anim drivers)
  L3 renderer      ceres_tpu.render (camera ray-gen, shading, shadow rays)
  L2 scene I/O     ceres_tpu.io (OBJ loading, vertex-normal averaging)
  L1 accel + math  ceres_tpu.ops (intersection, clusters, LBVH, Pallas kernels)
  parallel         ceres_tpu.parallel (shard_map over device meshes)
"""

from ceres_tpu.models.camera import Camera, camera_rays
from ceres_tpu.models.mesh import Mesh, TriangleSoup, triangle_soup, vertex_normals
from ceres_tpu.models.transform import Transform
from ceres_tpu.io.obj import load_obj
from ceres_tpu.render.renderer import render, RenderConfig

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "camera_rays",
    "Mesh",
    "TriangleSoup",
    "triangle_soup",
    "vertex_normals",
    "Transform",
    "load_obj",
    "render",
    "RenderConfig",
]
