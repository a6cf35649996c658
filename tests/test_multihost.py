"""Multi-host path: 2 spawned processes, jax.distributed over CPU.

The reference has NO distributed backend (SURVEY §2.3: no
init_process_group anywhere; DataParallel pinned to one GPU).  This test
proves the framework's multi-host story without hardware: two processes
(one per emulated host, 4 virtual chips each) join a coordinator, build
the ('host', 'chip') mesh, run one data-parallel sharded train step whose
gradient all-reduce crosses the process boundary, and one sharded
encrypted bootstrap batch with replicated server keys — the sharding
layout a multi-host fleet uses.
"""
import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_cpu_mesh(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    # each worker builds its own 4-device CPU runtime; drop the parent
    # test-session's 8-device forcing
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coord, "2", str(pid), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=1200)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out.decode(errors="replace"))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert os.path.exists(tmp_path / f"proc{pid}.ok"), out[-3000:]
    # the sharded train step must produce the SAME loss on both hosts
    # (fully-replicated params + all-reduced grads)
    losses = [(tmp_path / f"proc{p}.ok").read_text().strip()
              for p in range(2)]
    assert losses[0] == losses[1], losses
