"""Large-scene benchmark: subdivided bunny (>=1M triangles) at 1080p.

The regime where the two-level walk carries the frame (above
megakernel._HIER_MIN_CLUSTERS blocks).
Renders a LEVELS-times midpoint-subdivided bunny (levels=4: 1,271,808
triangles) with the same camera/shading as the bench.py north star and
reports ms/frame, Mrays/s, and the kernel's measured executed block
visits. SUPERS=tree|uniform A/Bs the tree-derived super cut against
uniform S-runs of consecutive blocks (the r4 structure).

Methodology matches run_all.py: k frames inside one jitted fori_loop,
marginal (k=REPS+1 vs k=1) per-frame time, forced by a scalar fetch;
the treelet build runs once
outside the frame loop (the reference builds its BVH before the loop,
include/anim.cpp:62-66).
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

from ceres_tpu.io.obj import load_obj
from ceres_tpu.models.camera import Camera
from ceres_tpu.models.mesh import subdivide, triangle_soup
from ceres_tpu.render.renderer import RenderConfig, render_pipeline
from ceres_tpu.render.scenes import data_dir

LEVELS = int(os.environ.get("LEVELS", 4))
REPS = int(os.environ.get("REPS", 3))
SUPERS = os.environ.get("SUPERS", "tree")  # tree | uniform
# lbvh = on-device treelet cut (tree-derived supers); binned = native
# C++ BinnedSAH quality cut (host build; supers fall back to uniform
# runs over the SAH cut order).
BUILDER = os.environ.get("BUILDER", "lbvh")


def main():
    verts, faces = load_obj(os.path.join(data_dir(), "bunny.obj"))
    verts, faces = subdivide(verts, faces, LEVELS)
    T = int(faces.shape[0])
    print(f"triangles={T} levels={LEVELS} supers={SUPERS}", flush=True)

    eye = np.asarray([0.0, 0.1, -0.3], np.float32)
    cam = Camera.make(eye=eye, dir=verts.mean(axis=0) - eye, up=(0, 1, 0),
                      fov=60.0)
    sun = jnp.asarray([-50.0, 100.0, 0.0], jnp.float32)
    cfg = RenderConfig(width=1920, height=1080, mode="smooth",
                       backend="megakernel")
    vj = jnp.asarray(verts)
    fj = jnp.asarray(faces)

    from ceres_tpu.accel.clusters import build_clusters_treelet
    from ceres_tpu.render.renderer import prepare_winner_table

    if BUILDER != "lbvh":
        from ceres_tpu.accel.cuts import build_clusters_quality

        t0 = time.perf_counter()
        cs_q = build_clusters_quality(
            triangle_soup(vj, fj, with_normals=False), builder=BUILDER)
        print(f"{BUILDER} host build+cut: "
              f"{time.perf_counter() - t0:.1f}s "
              f"({cs_q.num_clusters} clusters)", flush=True)

    def prepare(v):
        soup = triangle_soup(v, fj, with_normals=True)
        if BUILDER != "lbvh":
            cs = cs_q
        else:
            cs = build_clusters_treelet(
                triangle_soup(v, fj, with_normals=False))
        if SUPERS == "uniform":
            cs = dataclasses.replace(cs, super_first=None, super_S=0)
        return cs, prepare_winner_table(soup, cs, cfg)

    @functools.partial(jax.jit, static_argnames="k")
    def run(v, k):
        clusters, table = prepare(v)

        def body(i, acc):
            img, _ = render_pipeline(v, fj, cam, sun + i * 1e-3, cfg,
                                     clusters=clusters, table_cols=table)
            return acc + img.sum()
        return jax.lax.fori_loop(0, k, body, jnp.float32(0.0))

    res = {}
    for k in (1, REPS + 1):
        t0 = time.perf_counter()
        float(run(vj, k))  # compile + warm
        print(f"k={k} compile+first: {time.perf_counter() - t0:.1f}s",
              flush=True)
        ts = []
        for _ in range(2):
            t0 = time.perf_counter()
            float(run(vj, k))
            ts.append(time.perf_counter() - t0)
        res[k] = min(ts)
        print(f"k={k} best: {res[k]:.3f}s", flush=True)
    ms = (res[REPS + 1] - res[1]) / REPS * 1e3

    # Rays (reference counting) + measured executed visits, one frame.
    cfg_stats = dataclasses.replace(cfg, traversal_stats=True)

    @jax.jit
    def one_frame_stats(v):
        clusters, table = prepare(v)
        _, stats = render_pipeline(v, fj, cam, sun, cfg_stats,
                                   clusters=clusters, table_cols=table)
        return stats

    stats = {k: int(v) for k, v in one_frame_stats(vj).items()}
    rays = stats["rays"]
    line = {
        "config": f"6_bunny_subdiv{LEVELS}_1080p_smooth",
        "supers": SUPERS,
        "builder": BUILDER,
        "triangles": T,
        "rays_per_sec": round(rays / (ms * 1e-3), 1),
        "ms_per_frame": round(ms, 3),
        "rays": rays,
        "hits": stats["hits"],
        "mt_block_visits": stats["mt_block_visits"],
    }
    print(json.dumps(line), flush=True)

    # Merge into the sweep record (tree supers are the production path).
    if SUPERS == "tree" and BUILDER == "lbvh":
        out_dir = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, "run_all_results.json")
        results = []
        if os.path.exists(path):
            with open(path) as fh:
                results = json.load(fh)
        results = [r for r in results if r.get("config") != line["config"]]
        results.append(line)
        with open(path, "w") as fh:
            json.dump(results, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
