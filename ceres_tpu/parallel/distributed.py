"""Multi-host execution: jax.distributed initialization + global meshes.

The reference's only concurrency is one OpenMP ``parallel for`` inside a
single shared-memory process (include/render.hpp:104). The scale-out axis
beyond one host is PROCESSES: each host runs one process owning its local
devices, joined into a single SPMD program by ``jax.distributed``. Meshes
then span every global device — the existing shard_map pipelines
(ceres_tpu.parallel.sharded) run unchanged, with XLA routing the psum'd
gradient / stats collectives between devices and hosts.

The same machinery runs on CPUs for tests without a cluster: N processes
x M virtual CPU devices with gloo collectives (tests/test_multihost.py
spawns 2 x 4 and asserts sharded == single-device renders and
cross-process-psum'd gradients).
"""

from __future__ import annotations

import os
from typing import Optional


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_count: Optional[int] = None,
    cpu: bool = False,
) -> None:
    """Join this process to a multi-process JAX runtime.

    Must run before any JAX computation. The coordinator address
    (``host:port``), process count and this process's id are always
    given explicitly. ``cpu=True`` forces the CPU backend with
    ``local_device_count`` virtual devices per process and gloo
    collectives — the multi-host test/CI path (SURVEY.md §4 item 5).
    """
    if cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")
        if local_device_count is not None:
            jax.config.update("jax_num_cpu_devices", local_device_count)
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(num_frames_axis: int = 1):
    """("frames", "rays") mesh over EVERY device in the global runtime.

    After :func:`initialize`, ``jax.devices()`` spans all processes; the
    mesh therefore shards rays/frames across hosts, not just local chips.
    """
    import jax

    from ceres_tpu.parallel.sharded import device_mesh

    return device_mesh(num_frames_axis, devices=jax.devices())


def process_info():
    """(process_id, num_processes, local_devices, global_devices)."""
    import jax

    return (jax.process_index(), jax.process_count(),
            len(jax.local_devices()), len(jax.devices()))
