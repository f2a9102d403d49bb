"""A/B the builder menu ON THE DEVICE PATH: ms/frame + executed visits.

The reference's builder choice exists because tree quality buys traversal
time (anim.cpp:62 picks SweepSAH + layout for the hot app). Here every
quality tree is cut into a ClusterSet (accel.cuts) and fed to the SAME
walk kernel; this harness measures, per builder, the full-frame time and
the kernel's MEASURED executed block visits on the attached device, plus
the host build cost (which amortizes outside the frame loop exactly like
the reference's pre-loop build).

Scenes: the run_all.py sweep cameras (bunny config 2, dragon config 3) at
1080p smooth + shadows. Env: MESH=bunny|dragon|both, KINDS=csv filter.
Writes/updates chiprun_out/builder_ab.json.

NOTE optimize_node_layout is intentionally absent: it only reorders node
memory, and the treelet cut consumes topology — the layout step is a
no-op for cluster quality (the device path re-sorts candidates
front-to-back per tile every frame, which IS the layout analog).
"""

import dataclasses
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import jax
import jax.numpy as jnp

from ceres_tpu.accel import clusters as cl
from ceres_tpu.accel import cuts, golden_builders as gb, ploc
from ceres_tpu.io.obj import load_obj
from ceres_tpu.models.camera import Camera
from ceres_tpu.models.mesh import triangle_soup
from ceres_tpu.render.renderer import RenderConfig, render_pipeline
from ceres_tpu.render.scenes import data_dir

REPS = int(os.environ.get("REPS", 10))
KINDS = os.environ.get(
    "KINDS", "lbvh,sweep,binned,sbvh,ploc,reinsert").split(",")


def _tri_bounds(soup):
    p0 = np.asarray(soup.p0)
    p1 = p0 - np.asarray(soup.e1)
    p2 = np.asarray(soup.e2) + p0
    pts = np.stack([p0, p1, p2], 1)
    return pts.min(1), pts.max(1), pts.mean(1)


def build(kind, soup):
    """Host-side build -> (ClusterSet, build_seconds)."""
    t0 = time.perf_counter()
    if kind == "lbvh":
        cs = jax.jit(cl.build_clusters_treelet)(soup)
        jax.block_until_ready(cs.lo)
        return cs, time.perf_counter() - t0
    lo, hi, centers = _tri_bounds(soup)
    if kind == "sweep":
        bvh = gb.build_sweep_sah(lo, hi, centers)
    elif kind == "binned":
        from ceres_tpu.accel import native

        if native.available():
            bvh = native.build_binned_sah_fast(lo, hi, centers)
        else:
            bvh = gb.build_binned_sah(lo, hi, centers)
    elif kind == "sbvh":
        from ceres_tpu.accel.sbvh import build_sbvh

        p0 = np.asarray(soup.p0)
        bvh = build_sbvh(p0, p0 - np.asarray(soup.e1),
                         np.asarray(soup.e2) + p0)
    elif kind == "ploc":
        tree = ploc.build_ploc(soup)
        cs = cuts.clusters_from_ploc(soup, tree)
        return cs, time.perf_counter() - t0
    elif kind == "reinsert":
        from ceres_tpu.accel.reinsertion import optimize_reinsertion

        bvh = optimize_reinsertion(gb.build_sweep_sah(lo, hi, centers))
    else:
        raise ValueError(kind)
    cs = cuts.clusters_from_flatbvh(soup, bvh)
    return cs, time.perf_counter() - t0


def measure(verts, faces, cam, sun, cs):
    """(ms/frame, executed visits fwd+shadow) with prebuilt clusters."""
    cfg = RenderConfig(width=1920, height=1080, mode="smooth",
                       backend="megakernel")
    vj = jnp.asarray(verts)
    fj = jnp.asarray(faces)

    @functools.partial(jax.jit, static_argnames="k")
    def run(v, cs_, k):
        def body(i, acc):
            img, _ = render_pipeline(v, fj, cam, sun + i * 1e-3, cfg,
                                     clusters=cs_)
            return acc + img.sum()
        return jax.lax.fori_loop(0, k, body, jnp.float32(0.0))

    res = {}
    for k in (1, REPS + 1):
        float(run(vj, cs, k))
        ts = []
        for _ in range(2):
            t0 = time.perf_counter()
            float(run(vj, cs, k))
            ts.append(time.perf_counter() - t0)
        res[k] = min(ts)
    ms = (res[REPS + 1] - res[1]) / REPS * 1e3

    cfg_s = dataclasses.replace(cfg, traversal_stats=True)

    @jax.jit
    def stats_frame(v, cs_):
        _, stats = render_pipeline(v, fj, cam, sun, cfg_s, clusters=cs_)
        return stats

    st = {k: int(v) for k, v in stats_frame(vj, cs).items()}
    return ms, st


def main():
    mesh_sel = os.environ.get("MESH", "both")
    scenes_ = []
    if mesh_sel in ("bunny", "both"):
        scenes_.append("bunny")
    if mesh_sel in ("dragon", "both"):
        scenes_.append("dragon")

    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, "builder_ab.json")
    results = []
    if os.path.exists(out_path):
        with open(out_path) as fh:
            results = json.load(fh)

    sun = jnp.asarray([-50.0, 100.0, 0.0], jnp.float32)
    for scene in scenes_:
        verts, faces = load_obj(os.path.join(data_dir(), f"{scene}.obj"))
        eye = (np.asarray([0.0, 0.1, -0.3], np.float32) if scene == "bunny"
               else np.asarray([0.0, 2.0, -8.0], np.float32))
        cam = Camera.make(eye=eye, dir=verts.mean(axis=0) - eye,
                          up=(0, 1, 0), fov=60.0)
        soup = triangle_soup(jnp.asarray(verts), jnp.asarray(faces),
                             with_normals=False)
        for kind in KINDS:
            cs, bt = build(kind, soup)
            ms, st = measure(verts, faces, cam, sun, cs)
            line = {
                "scene": scene, "builder": kind,
                "clusters": int(cs.num_clusters),
                "host_build_s": round(bt, 3),
                "ms_per_frame": round(ms, 3),
                "rays_per_sec": round(st["rays"] / (ms * 1e-3), 1),
                "mt_block_visits": st["mt_block_visits"],
                "traversal_steps": st["traversal_steps"],
            }
            results = [r for r in results
                       if not (r["scene"] == scene and r["builder"] == kind)]
            results.append(line)
            print(json.dumps(line), flush=True)

    with open(out_path, "w") as fh:
        json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
