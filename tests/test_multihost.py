"""Multi-host bring-up smoke test (VERDICT r1 item 7; SURVEY.md §2.3 P7).

Launches TWO real OS processes that form a ``jax.distributed`` cluster on
faked CPU devices, covering ``initialize_distributed``,
``host_local_to_global``, and one cross-process ``psum`` — the pieces a
multi-host run needs at startup, validated without a cluster.
"""
import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_psum():
    # (no pytest-timeout in this env — communicate(timeout=) bounds the run)
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    # the workers set their own XLA_FLAGS / platform; scrub any forced count
    env.pop("XLA_FLAGS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(port), str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=_REPO,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"MULTIHOST_OK {pid}" in out, out
