"""Two-process jax.distributed bring-up over localhost (SURVEY.md §2.4(c):
multi-host orchestration). Spawns two REAL processes that rendezvous at a
gRPC coordinator, build the (hosts, chips) global mesh, broadcast a scene
pytree from host 0, and run a global reduction across the host axis — the
multi-process path parallel/distributed.py exists for."""

import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_bringup():
    coord = f"127.0.0.1:{_free_port()}"
    worker = os.path.join(HERE, "distributed_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS", "PYTHONPATH")}
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, "2", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=300)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"worker {pid}: OK" in out
