"""Execute the REAL multi-process branches once per CI run: two
`jax.distributed` CPU processes forming one global 8-device mesh, driving
the pair-sharded wavefront end-to-end.  This reaches what the
single-process fake mesh cannot: `jax.process_count() > 1` feeding
(make_array_from_callback over non-addressable shards) and the
`multihost_utils.process_allgather` branch of dist.gather_to_host.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_cpu_mesh():
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")
    env = {
        k: v
        for k, v in os.environ.items()
        if not k.startswith(("JAX_", "XLA_"))
    }
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 and "distributed" in out and (
            "not supported" in out or "Unimplemented" in out
        ):
            pytest.skip(f"jax.distributed unsupported here:\n{out[-2000:]}")
        assert p.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"
        assert f"MULTIHOST-OK p{i}" in out, out[-2000:]
