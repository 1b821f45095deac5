"""Emulated multi-host distributed solve: 2 processes x 4 virtual devices.

Exercises the `jax.distributed` initialization path (`parallel/mesh.py:
init_distributed`) that a real cluster uses across hosts — the one line of
the distributed story a single-process virtual mesh cannot cover.  Each
process owns half the scenario batch; cross-process collectives (Gloo on
CPU, NCCL across GPU hosts) carry the fleet-statistics reductions.
"""
import os
import socket
import subprocess
import sys


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sharded_solve():
    port = _free_port()
    script = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    # workers pin their own platform/devices; scrub pytest's settings
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, script, str(pid), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=540)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert "MULTIHOST OK" in out, f"proc {pid} output:\n{out[-3000:]}"
