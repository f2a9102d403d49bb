"""Walk kernel A/B on the card: the Pallas (Triton) walk vs the plain walk.

Times the two implementations of the same search — the hand-written walk
kernel (ops/megakernel.py) and the plain-JAX tile walk that XLA compiles
(ops/walk_f64.py in float32, products at Precision.HIGHEST) — on the
primary (closest-hit) and shadow (segment, any_seg) wavefronts of bunny
and dragon at 1920x1080 and of the 4x-subdivided bunny
(1,271,808 triangles). Each number is the median of REPS runs, each
ending in block_until_ready, after one warm-up run; prepass and walk are
both inside the timed call. Also reports the executed block visits and
that the two agree. ``--sweep`` then times the kernel alone at other
register-block sizes and warp counts, on the same scenes and modes.

    python benchmarks/walk_ab.py [--sweep] [--scenes bunny,dragon,big]

Needs the GPU. Prints one JSON line per measurement, each naming the card
(nvidia-smi name and power limit); writes them to chiprun_out/walk_ab.json.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REPS = 7
BIG_PLAIN_REPS = 3   # the plain walk takes seconds per call on the big scene


def _median_time(fn, *args, reps=REPS):
    import jax

    jax.block_until_ready(fn(*args))          # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times), min(times), max(times)


def _wavefronts(verts, faces, cam, sun):
    """Clusters, swizzled 1080p primary rays and the shadow wavefront."""
    import jax
    import jax.numpy as jnp

    from ceres_tpu.accel import clusters as cl
    from ceres_tpu.models.camera import camera_ray_columns
    from ceres_tpu.models.mesh import triangle_soup
    from ceres_tpu.ops import megakernel as mk
    from ceres_tpu.utils import tiling

    soup = triangle_soup(jnp.asarray(verts), jnp.asarray(faces),
                         with_normals=False)
    cs = jax.jit(cl.build_clusters_treelet)(soup)
    dirs = tuple(tiling.swizzle_plane(p)
                 for p in camera_ray_columns(cam, 1920, 1080))

    @jax.jit
    def shadow(soup, cs, eye, sun, dirs):
        hit = mk.closest_hit_common_origin(soup, eye, dirs, clusters=cs)
        t = jnp.where(hit.mask, hit.t, 0.0)
        pts = tuple(eye[a] + t * dirs[a] for a in range(3))
        seg = tuple(sun[a] - pts[a] for a in range(3))
        inv = jax.lax.rsqrt(sum(c * c for c in seg))
        org = tuple(pts[a] + 1e-4 * seg[a] * inv for a in range(3))
        seg = tuple(sun[a] - org[a] for a in range(3))
        return org, seg, ~hit.mask

    org, seg, skip = shadow(soup, cs, cam.eye, sun, dirs)
    return soup, cs, dirs, org, seg, skip


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true",
                    help="also time the kernel at other chunk x num_warps")
    ap.add_argument("--scenes", default="bunny,dragon,big")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from ceres_tpu.models.mesh import subdivide
    from ceres_tpu.ops import megakernel as mk
    from ceres_tpu.ops import walk_f64 as plain
    from ceres_tpu.render import scenes
    from ceres_tpu.utils import runtime

    dev = runtime.require_gpu()
    runtime.enable_compile_cache()
    card = runtime.nvidia_smi_line()
    rows = []

    def emit(rec):
        rec.update(card=card, device_kind=dev["kind"])
        rows.append(rec)
        print(json.dumps(rec), flush=True)

    sweeps = []
    for name in args.scenes.split(","):
        s = scenes.dragon_scene() if name == "dragon" else \
            scenes.bunny_scene()
        verts, faces = s.vertices, s.faces
        if name == "big":
            verts, faces = subdivide(verts, faces, 4)
        sun = jnp.asarray(s.sun)
        soup, cs, dirs, org, seg, skip = _wavefronts(
            verts, faces, s.camera, sun)
        center = jnp.mean(soup.p0, axis=0)
        n_c = int(cs.num_clusters)
        base = dict(scene=name, triangles=int(faces.shape[0]), blocks=n_c,
                    walk="two-level" if mk._super_factor(n_c) > 1
                    else "flat")
        impls = {
            ("closest", "triton"): (jax.jit(mk._closest_search),
                                    (cs, s.camera.eye, dirs)),
            ("closest", "plain"): (jax.jit(plain.closest_search),
                                   (cs, s.camera.eye, dirs)),
            ("any_seg", "triton"): (
                jax.jit(lambda c, so, ce, o, g, k: mk.any_hit(
                    so, ce, o, g, skip=k, clusters=c, with_counts=True,
                    segment=True)),
                (cs, soup, center, org, seg, skip)),
            ("any_seg", "plain"): (
                jax.jit(lambda c, ce, o, g, k: plain.any_hit(
                    c, ce, o, g, skip=k, segment=True)),
                (cs, center, org, seg, skip)),
        }
        outs = {}
        for (mode, impl), (fn, fargs) in impls.items():
            reps = BIG_PLAIN_REPS if (name, impl) == ("big", "plain") \
                else REPS
            med, lo, hi = _median_time(fn, *fargs, reps=reps)
            out, cnt = fn(*fargs)
            outs[(mode, impl)] = np.asarray(out)
            if impl == "triton":
                base_i = dict(base, chunk=mk._CHUNK_TRIS,
                              num_warps=mk._NUM_WARPS)
            else:
                base_i = base
            emit(dict(base_i, mode=mode, impl=impl, median_s=med, min_s=lo,
                      max_s=hi, reps=reps,
                      visits=int(cnt["traversal_steps"])))
        for mode in ("closest", "any_seg"):
            a, b = outs[(mode, "triton")], outs[(mode, "plain")]
            emit(dict(base, mode=mode, impl="agreement",
                      differ_share=float((a != b).mean())))
            sweeps.append((base, mode) + impls[(mode, "triton")])

    default = (mk._CHUNK_TRIS, mk._NUM_WARPS)
    for chunk, warps in ((4, 4), (4, 16), (8, 8)) if args.sweep else ():
        mk._CHUNK_TRIS, mk._NUM_WARPS = chunk, warps
        jax.clear_caches()
        for base, mode, fn, fargs in sweeps:
            med, lo, hi = _median_time(jax.jit(fn.__wrapped__), *fargs)
            emit(dict(base, mode=mode, impl="triton", chunk=chunk,
                      num_warps=warps, median_s=med, min_s=lo, max_s=hi,
                      reps=REPS))
    mk._CHUNK_TRIS, mk._NUM_WARPS = default

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "walk_ab.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
