"""Record per-round scaling evidence -> SCALING_r{N}.json at the repo root.

This records the sharding machinery's overheads on the CPU (no card is
involved; speedup across real devices is measured on the card, not
here):

  1. shard_map OVERHEAD on the virtual 8-device CPU mesh: the same
     render executed on a 1-device vs an 8-device mesh. All virtual
     devices share one core pool, so ideal behavior is rate_8 == rate_1
     (total work unchanged, partitioning machinery free); the recorded
     ``sharding_overhead_efficiency`` = rate_8 / rate_1.
  2. The 2-process jax.distributed (multi-host) path executing the same
     sharded render end to end.

The north-star ">= 85% rays/s efficiency 1 chip -> N hosts"
(BASELINE.json) is supported, not directly measured: the forward render
is embarrassingly parallel over rays (no cross-device collectives except
the psum'd stats scalar), so per-device efficiency is bounded below by
the overheads recorded here.

Usage: python benchmarks/record_scaling.py [--round 4]
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cpu_mesh(width=480, height=270, reps=3):
    """scaling.py on the virtual CPU mesh, parsed from its JSON lines."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmarks", "scaling.py"),
         "--devices", "8", "--width", str(width), "--height", str(height),
         "--reps", str(reps)],
        env=env, capture_output=True, text=True, timeout=3600)
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    rates = {l["devices"]: l["value"] for l in lines
             if l.get("metric") == "rays_per_sec"}
    rays = next((l.get("rays_per_frame") for l in lines
                 if l.get("metric") == "rays_per_sec"), None)
    return rates, rays, out.returncode


def _run_contention_control(n=8, width=480, height=270, reps=3):
    """N independent 1-device processes rendering 1/N-height shards,
    CONCURRENTLY (file barrier): the contention-matched ideal throughput
    for the N-virtual-device mesh. Aggregate rate = one full frame's
    rays / the slowest worker's per-frame time — what N meshless workers
    achieve under the same core contention, so mesh_rate / this rate
    isolates shard_map overhead from contention."""
    import tempfile

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "host_platform_device_count" not in f)
    with tempfile.TemporaryDirectory() as syncdir:
        procs = [
            subprocess.Popen(
                [sys.executable,
                 os.path.join(ROOT, "benchmarks", "contention_worker.py"),
                 str(i), str(n), str(width), str(height), str(reps),
                 syncdir],
                env=env)
            for i in range(n)
        ]
        deadline = time.time() + 1800
        while time.time() < deadline:
            ready = sum(os.path.exists(os.path.join(syncdir, f"ready_{i}"))
                        for i in range(n))
            if ready == n:
                break
            if any(p.poll() not in (None, 0) for p in procs):
                for p in procs:
                    p.kill()
                return None
            time.sleep(0.05)
        open(os.path.join(syncdir, "go"), "w").close()
        rc = 0
        for p in procs:
            rc |= p.wait()
        if rc:
            return None
        secs = []
        for i in range(n):
            with open(os.path.join(syncdir, f"result_{i}.json")) as fh:
                secs.append(json.load(fh)["seconds"] / reps)
        # Rays counted as the mesh harness does: pixels + primary hits of
        # the full frame (identical scene/camera); the slowest worker
        # bounds the frame like the mesh's slowest shard does.
        from ceres_tpu.render.scenes import bunny_path  # noqa: F401
        return {"n_processes": n, "per_frame_s_per_worker":
                [round(s, 4) for s in secs],
                "frame_s": round(max(secs), 4)}


def _run_distributed(width=320, height=180, reps=2):
    env = dict(os.environ)
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmarks", "scaling.py"),
         "--devices", "2", "--width", str(width), "--height", str(height),
         "--reps", str(reps), "--distributed", "2"],
        env=env, capture_output=True, text=True, timeout=3600)
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    dist = next((l for l in lines
                 if l.get("metric") == "rays_per_sec_distributed"), None)
    return dist, out.returncode


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--round", type=int, default=4)
    args = ap.parse_args()

    out_path = os.path.join(ROOT, f"SCALING_r{args.round:02d}.json")
    result = {"host_cores": os.cpu_count()}
    if os.path.exists(out_path):
        # Merge over a previous partial run.
        with open(out_path) as fh:
            result = json.load(fh)
        result["host_cores"] = os.cpu_count()

    rates, rays, rc = _run_cpu_mesh()
    base = rates.get(1)
    r8 = rates.get(8)
    result["virtual_cpu_mesh"] = {
        "rays_per_sec": rates,
        "sharding_overhead_efficiency":
            round(r8 / base, 4) if base and r8 else None,
        "note": ("8 virtual devices share this host's "
                 f"{os.cpu_count()} cores: ideal is rate_8 == rate_1 "
                 "(partitioning free), NOT 8x; rate_8/rate_1 conflates "
                 "shard_map overhead with core contention — "
                 "mesh_vs_control is the deconfounded number"),
    }

    # Contention-normalized control: 8 independent 1-device processes
    # rendering 1/8-height shards CONCURRENTLY — the ideal-throughput
    # denominator under identical core contention (VERDICT r4 item 8).
    ctl = _run_contention_control()
    if ctl is not None and r8 and rays:
        ctl_rate = rays / ctl["frame_s"]
        ctl["rays_per_sec"] = round(ctl_rate, 1)
        ctl["mesh_vs_control_efficiency"] = round(r8 / ctl_rate, 4)
        ctl["note"] = (
            "8 meshless single-device processes, file-barrier "
            "synchronized so the timed frames overlap; frame time = "
            "slowest worker (the mesh is bounded by its slowest shard "
            "the same way). mesh_vs_control = mesh rate_8 / this rate: "
            "shard_map overhead with contention factored out.")
    result["contention_control"] = ctl

    dist, rc2 = _run_distributed()
    result["distributed_2proc"] = dist

    result["north_star_note"] = (
        "Forward render is embarrassingly parallel over rays (no "
        "cross-device collective except the stats psum); real-device "
        "efficiency is bounded below by the overheads recorded here, "
        "all of which must stay >= 0.85 for the >= 85% target.")

    with open(out_path, "w") as fh:
        json.dump(result, fh, indent=1)
    print(json.dumps(result))
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    raise SystemExit(main())
