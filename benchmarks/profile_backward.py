"""Decompose the 1080p forward+backward step (VERDICT r4 item 5).

The hypothesis to confirm or refute: the backward of the winner
row-gather — a scatter-add over the (N_c*C, 13+P) winner table —
dominates the bwd/fwd gap. AD can't be timed piecewise, so this
isolates paths by DIFFERENCING jitted variants whose unused cotangent
paths XLA dead-code-eliminates:

  fwd          forward only (config-2 frame)
  bwd_full     grad wrt (vertices, eye)        — the 4b configuration
  bwd_eye      grad wrt eye only               — table/vertex scatters DCE'd
               (the winner-table cotangent is zero: its columns are soup
               gathers, independent of eye)
  bwd_geom     grad wrt vertices, corner-normal payload detached —
               drops the vertex-normal segment-sum path, keeps the
               table scatter

bwd_full - bwd_eye    ~ cost of the vertex cotangent paths
                        (table scatter-add + vertex-normal accumulation)
bwd_full - bwd_geom   ~ cost of the corner-normal accumulation alone

Optionally writes an xplane trace of the full step (TRACE=1).
Writes chiprun_out/backward_profile.json.
"""

import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from ceres_tpu.io.obj import load_obj
from ceres_tpu.models.camera import Camera
from ceres_tpu.models.mesh import triangle_soup
from ceres_tpu.render.renderer import RenderConfig, render_pipeline
from ceres_tpu.render.scenes import data_dir

REPS = int(os.environ.get("REPS", 10))


def marginal_ms(make_body, v):
    @functools.partial(jax.jit, static_argnames="k")
    def run(v_, k):
        def body(i, acc):
            return acc + make_body(v_, i)
        return jax.lax.fori_loop(0, k, body, jnp.float32(0.0))

    res = {}
    for k in (1, REPS + 1):
        float(run(v, k))
        ts = []
        for _ in range(2):
            t0 = time.perf_counter()
            float(run(v, k))
            ts.append(time.perf_counter() - t0)
        res[k] = min(ts)
    return (res[REPS + 1] - res[1]) / REPS * 1e3


def main():
    verts, faces = load_obj(os.path.join(data_dir(), "bunny.obj"))
    eye = np.asarray([0.0, 0.1, -0.3], np.float32)
    cam = Camera.make(eye=eye, dir=verts.mean(axis=0) - eye, up=(0, 1, 0),
                      fov=60.0)
    sun = jnp.asarray([-50.0, 100.0, 0.0], jnp.float32)
    cfg = RenderConfig(width=1920, height=1080, mode="smooth",
                       backend="megakernel")
    vj = jnp.asarray(verts)
    fj = jnp.asarray(faces)
    ej = jnp.asarray(eye)

    from ceres_tpu.accel.clusters import build_clusters_treelet

    target, _ = render_pipeline(vj, fj, cam, sun, cfg)
    target = jax.lax.stop_gradient(target)

    def loss_of(v, e, i, detach_normals=False):
        camera = Camera(eye=e, dir=cam.dir, up=cam.up, fov=cam.fov)
        if detach_normals:
            soup = triangle_soup(v, fj, with_normals=True)
            soup = type(soup)(
                p0=soup.p0, e1=soup.e1, e2=soup.e2, n=soup.n,
                corner_normals=jax.lax.stop_gradient(soup.corner_normals))
            from ceres_tpu.render.renderer import render_wavefront_cols
            from ceres_tpu.models.camera import camera_ray_columns
            from ceres_tpu.utils import tiling

            planes = camera_ray_columns(camera, cfg.width, cfg.height)
            dir_cols = tuple(tiling.swizzle_plane(p) for p in planes)
            color, _ = render_wavefront_cols(soup, camera, sun + i * 1e-3,
                                             dir_cols, cfg)
            img = jnp.stack(
                [tiling.unswizzle_plane(c, cfg.height, cfg.width)
                 for c in color], axis=-1)
        else:
            img, _ = render_pipeline(v, fj, camera, sun + i * 1e-3, cfg)
        return jnp.mean((img - target) ** 2)

    results = {}

    def fwd_body(v, i):
        img, _ = render_pipeline(
            v, fj, cam, sun + i * 1e-3, cfg,
            clusters=build_clusters_treelet(
                triangle_soup(v, fj, with_normals=False)))
        return img.sum()

    # NOTE: the grad bodies do NOT hoist the cluster build (matching the
    # run_all 4b config exactly); fwd_hoisted is the config-2 denominator
    # and fwd_inline the apples-to-apples forward with in-loop build.
    results["fwd_hoisted"] = marginal_ms(fwd_body, vj)

    def fwd_inline_body(v, i):
        img, _ = render_pipeline(v, fj, cam, sun + i * 1e-3, cfg)
        return img.sum()

    results["fwd_inline"] = marginal_ms(fwd_inline_body, vj)

    def full_body(v, i):
        val, (gv, ge) = jax.value_and_grad(
            lambda vv, ee: loss_of(vv, ee, i), argnums=(0, 1))(v, ej)
        return val + gv.sum() * 1e-9 + ge.sum() * 1e-9

    results["bwd_full"] = marginal_ms(full_body, vj)

    def eye_body(v, i):
        val, ge = jax.value_and_grad(
            lambda ee: loss_of(v, ee, i))(ej)
        return val + ge.sum() * 1e-9

    results["bwd_eye_only"] = marginal_ms(eye_body, vj)

    def geom_body(v, i):
        val, gv = jax.value_and_grad(
            lambda vv: loss_of(vv, ej, i, detach_normals=True))(v)
        return val + gv.sum() * 1e-9

    results["bwd_geom_only"] = marginal_ms(geom_body, vj)

    results["derived"] = {
        "bwd_over_fwd": round(results["bwd_full"]
                              / results["fwd_hoisted"] - 1.0, 3),
        "vertex_paths_ms": round(results["bwd_full"]
                                 - results["bwd_eye_only"], 2),
        "normal_accum_ms": round(results["bwd_full"]
                                 - results["bwd_geom_only"], 2),
    }
    for k, v in results.items():
        print(k, v, flush=True)

    if os.environ.get("TRACE"):
        out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "traces", "backward")
        step = jax.jit(lambda v: full_body(v, 0))
        float(step(vj))
        with jax.profiler.trace(out_dir):
            for _ in range(2):
                float(step(vj))
        print("trace written:", out_dir)

    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "backward_profile.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
