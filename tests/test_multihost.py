"""Multi-host execution test: 2 processes x 4 virtual CPU devices.

SURVEY.md §4 item 5: spawn two real OS processes, join them with
jax.distributed (CPU backend, gloo collectives), and assert the sharded
render and cross-process-psum'd gradients match single-device results.
This is the CI stand-in for a multi-host cluster — the mesh construction
and collective paths are identical; only the transport differs (gloo
here). Worker logic: tests/multihost_worker.py.
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_render_and_grads():
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    env = dict(os.environ)
    # Fresh processes must come up on the CPU backend with their own
    # device counts; scrub inherited forced device counts from the test
    # environment.
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "host_platform_device_count" not in f)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coordinator, "2", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO)
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n"
                    + "\n".join(o or "" for o in outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"worker {pid}: OK" in out
