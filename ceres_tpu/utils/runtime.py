"""Process set-up shared by the entry points: compile cache and device.

``enable_compile_cache`` points JAX's persistent compilation cache at
``$JAX_COMPILATION_CACHE_DIR`` when it is set, else at the fixed
``<checkout>/.jax_cache`` (listed in .gitignore): a fixed path, because the
path is part of the cache key. ``device_report`` names the card a
measurement ran on; ``require_gpu`` refuses to measure anywhere else.
"""

from __future__ import annotations

import os
import subprocess

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    import jax

    path = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(_CHECKOUT, ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def nvidia_smi_line() -> str:
    """The card's name and power limit as nvidia-smi reports them.

    Runs in a child process that stays off JAX; returns "not available"
    where there is no nvidia-smi.
    """
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "not available"
    lines = out.stdout.strip().splitlines()
    if len(lines) > 1 and len(set(lines)) == 1:
        return f"{len(lines)} x {lines[0]}"
    return "; ".join(lines)


def device_report() -> dict:
    """{"platform", "kind", "count"} of JAX's default devices."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> dict:
    """The device report, or SystemExit when JAX found no GPU: a speed or
    on-card check never falls back to the CPU."""
    dev = device_report()
    if dev["platform"] != "gpu":
        raise SystemExit(f"no GPU: JAX runs on {dev['platform']!r} "
                         f"({dev['kind']}); this needs the card")
    return dev
