"""Large scenes: subdivided geometry through the two-level walk.

Subdivision preserves the surface, so a subdivided bunny must render
near-identically to the original mesh at a low resolution.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ceres_tpu.models.mesh import subdivide
from ceres_tpu.render.renderer import RenderConfig, render
from ceres_tpu.render import scenes


def test_subdivide_watertight(bunny):
    scene = scenes.bunny_scene()
    v2, f2 = subdivide(scene.vertices, scene.faces, 1)
    assert f2.shape[0] == 4 * scene.faces.shape[0]
    # Shared midpoints: Euler bookkeeping — V' = V + E where each interior
    # edge is counted once.
    edges = np.sort(np.concatenate([
        scene.faces[:, [0, 1]], scene.faces[:, [1, 2]],
        scene.faces[:, [2, 0]]]), axis=1)
    n_edges = np.unique(edges, axis=0).shape[0]
    assert v2.shape[0] == scene.vertices.shape[0] + n_edges


def test_hierarchical_large_scene_renders_like_base(bunny, monkeypatch):
    """The TWO-LEVEL walk end to end through render() on a 3x-subdivided
    bunny (318k triangles -> ~5k blocks): super-candidate prepass and
    in-kernel block gating engage (the production threshold is 12288
    blocks; forcing it down here keeps the scene small enough for the
    interpreter). The image must still match the base-mesh render.
    """
    from ceres_tpu.accel import clusters as cl
    from ceres_tpu.ops import megakernel as mk

    scene = scenes.bunny_scene()
    v3, f3 = subdivide(scene.vertices, scene.faces, 3)   # ~318k tris
    cfg = RenderConfig(width=32, height=32, mode="flat",
                       backend="megakernel")
    base, bstats = render(scene.vertices, scene.faces, scene.camera,
                          scene.sun, config=cfg)
    monkeypatch.setattr(mk, "_HIER_MIN_CLUSTERS", 2048)
    jax.clear_caches()   # render() is jitted; retrace with the threshold
    try:
        n_blocks = 2 * (-(-f3.shape[0] // cl.CLUSTER_SIZE))
        assert mk._super_factor(n_blocks) > 1  # the two-level walk engages
        img, stats = render(v3, f3, scene.camera, scene.sun, config=cfg)
    finally:
        monkeypatch.undo()
        jax.clear_caches()  # drop executables traced with the low threshold
    base = np.asarray(base)
    img = np.asarray(img)
    diff = np.abs(img - base).max(axis=-1)
    assert (diff < 2e-2).mean() > 0.97, f"{(diff >= 2e-2).mean():.3%} off"
    assert abs(int(stats["primary_hits"]) - int(bstats["primary_hits"])) \
        <= 0.02 * 32 * 32
