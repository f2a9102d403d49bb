"""Scaling-efficiency harness: rays/s on 1 device vs an N-device mesh.

BASELINE.json north star: ">= 85% rays/s scaling efficiency 1 chip -> N".
By default this runs the *same shard_map code path* on an N-virtual-device
CPU mesh (the mechanism the tests validate for correctness), which measures
overhead, not speedup; with --attached it runs unmodified on the attached
devices (the cards) in this one process.

Usage:
    python benchmarks/scaling.py [--devices 8] [--width 1920 --height 1080]
Prints one JSON line per device count plus a final efficiency line.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _spawn_distributed(args) -> int:
    """Launch N coordinator-joined worker copies of this script."""
    import socket
    import subprocess

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coordinator = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "host_platform_device_count" not in f)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--devices", str(args.devices), "--width", str(args.width),
             "--height", str(args.height), "--reps", str(args.reps),
             "--backend", args.backend,
             "--_worker", coordinator, str(args.distributed), str(pid)],
            env=env)
        for pid in range(args.distributed)
    ]
    rc = 0
    for p in procs:
        rc |= p.wait()
    return rc


def _distributed_worker(args) -> int:
    """One process of the multi-process measurement (prints on pid 0)."""
    from ceres_tpu.parallel import distributed

    coordinator, num_procs, pid = (args._worker[0], int(args._worker[1]),
                                   int(args._worker[2]))
    distributed.initialize(coordinator, num_procs, pid,
                           local_device_count=args.devices, cpu=True)
    import jax
    import numpy as np

    from ceres_tpu.io.obj import load_obj
    from ceres_tpu.models.camera import Camera
    from ceres_tpu.parallel.distributed import global_mesh
    from ceres_tpu.parallel.sharded import render_sharded
    from ceres_tpu.render.scenes import bunny_path

    verts, faces = load_obj(bunny_path())
    eye = np.asarray([0.0, 0.1, -0.3], np.float32)
    camera = Camera.make(eye=eye, dir=verts.mean(axis=0) - eye,
                         up=(0, 1, 0), fov=60.0)
    sun = np.asarray([-50.0, 100.0, 0.0], np.float32)
    mesh = global_mesh()

    def run():
        img, stats = render_sharded(
            verts, faces, camera, sun, mesh=mesh, width=args.width,
            height=args.height, mode="smooth", backend=args.backend)
        jax.block_until_ready(img)
        return stats

    stats = run()  # compile
    t0 = time.perf_counter()
    for _ in range(args.reps):
        stats = run()
    dt = (time.perf_counter() - t0) / args.reps
    if pid == 0:
        print(json.dumps({
            "metric": "rays_per_sec_distributed",
            "processes": num_procs,
            "devices_per_process": args.devices,
            "value": round(float(stats["rays"]) / dt, 1),
            "unit": "rays/s",
            "note": ("CPU processes share one core pool: validates the "
                     "multi-host path, not parallel speedup"),
        }))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--backend", default="megakernel")
    ap.add_argument("--attached", action="store_true",
                    help="use the attached devices (the cards) instead of "
                         "forcing a virtual CPU mesh")
    ap.add_argument("--distributed", type=int, default=0, metavar="N",
                    help="spawn N real OS processes joined by "
                         "jax.distributed (CPU backend, --devices virtual "
                         "devices EACH) and measure the cross-process "
                         "sharded render — the multi-host code path")
    ap.add_argument("--_worker", nargs=3, default=None,
                    help=argparse.SUPPRESS)  # coordinator num_procs pid
    args = ap.parse_args()

    if args.distributed and args._worker is None:
        return _spawn_distributed(args)
    if args._worker is not None:
        return _distributed_worker(args)

    if not args.attached:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.devices)
    else:
        import jax

    import numpy as np

    from ceres_tpu.io.obj import load_obj
    from ceres_tpu.models.camera import Camera
    from ceres_tpu.parallel.sharded import device_mesh, render_sharded
    from ceres_tpu.render.scenes import bunny_path

    verts, faces = load_obj(bunny_path())
    eye = np.asarray([0.0, 0.1, -0.3], np.float32)
    camera = Camera.make(eye=eye, dir=verts.mean(axis=0) - eye,
                         up=(0, 1, 0), fov=60.0)
    sun = np.asarray([-50.0, 100.0, 0.0], np.float32)

    def measure(n_dev: int):
        import functools

        import jax.numpy as jnp

        from ceres_tpu.parallel.sharded import _render_sharded_jit
        from ceres_tpu.render.renderer import RenderConfig

        mesh = device_mesh(devices=jax.devices()[:n_dev])
        cfg = RenderConfig(width=args.width, height=args.height,
                           mode="smooth", backend=args.backend)
        vj = jnp.asarray(verts)
        fj = jnp.asarray(faces)
        sj = jnp.asarray(sun, vj.dtype)

        # In-graph frame loop (the repo-wide timing methodology): the
        # eager per-call form re-traces shard_map every frame, so it
        # measures HOST dispatch, not the sharded render — the round-4
        # "79% efficiency" artifact came entirely from that overhead.
        @functools.partial(jax.jit, static_argnames="k")
        def run_k(v, k):
            def body(i, acc):
                img, _ = _render_sharded_jit(v, fj, camera, sj + i * 1e-3,
                                             cfg, mesh)
                return acc + img.sum()
            return jax.lax.fori_loop(0, k, body, jnp.float32(0.0))

        _, stats = _render_sharded_jit(vj, fj, camera, sj, cfg, mesh)
        rays = int(stats["rays"])
        float(run_k(vj, args.reps))  # compile + warm
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            float(run_k(vj, args.reps))
            best = min(best, time.perf_counter() - t0)
        dt = best / args.reps
        return rays / dt, rays

    counts = sorted({1, 2, args.devices} & set(
        range(1, len(jax.devices()) + 1)))
    rates = {}
    for n in counts:
        rates[n], rays = measure(n)
        print(json.dumps({"metric": "rays_per_sec", "devices": n,
                          "value": round(rates[n], 1), "unit": "rays/s",
                          "rays_per_frame": rays}))
    base = rates[counts[0]]
    n_max = counts[-1]
    eff = rates[n_max] / (n_max * base)
    print(json.dumps({
        "metric": "scaling_efficiency",
        "value": round(eff, 4),
        "unit": f"fraction of linear, 1 -> {n_max} devices",
        "target": 0.85,
        "note": ("virtual CPU mesh: all N 'devices' share one physical "
                 "core pool, so this exercises the shard_map path and "
                 "measures its overhead, NOT parallel speedup; the >= 85% "
                 "target applies to --attached runs on real devices"
                 if not args.attached else "real devices"),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
