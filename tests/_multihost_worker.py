"""Worker process for tests/test_multihost.py (NOT a test module).

Runs one of two cooperating `jax.distributed` CPU processes: 4 local CPU
devices each, one global 8-device 'pairs' mesh spanning both.  Drives
align_batch and align_all_vs_all through the pair-sharded wavefront so the
REAL multi-process branches execute: per-process feeding (dist._place's
make_array_from_callback) and the process_allgather in
dist.gather_to_host — the branch SURVEY.md §4.4's single-process fake
mesh can never reach.

Usage: python _multihost_worker.py <process_id> <coordinator_port>
"""

import os
import sys

pid = int(sys.argv[1])
port = sys.argv[2]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address=f"127.0.0.1:{port}",
    num_processes=2,
    process_id=pid,
)
assert jax.process_count() == 2, jax.process_count()
assert jax.local_device_count() == 4, jax.local_device_count()
assert jax.device_count() == 8, jax.device_count()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from seqalib import ScoringParams, align_all_vs_all, align_batch  # noqa: E402
from seqalib.oracle import align_oracle  # noqa: E402

mesh = jax.make_mesh((8,), ("pairs",))
sp = ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
# both processes seed identically: every host holds the full input (the
# feeding callback slices out each process's own shards)
rng = np.random.default_rng(123)
qs = [rng.integers(0, 4, size=rng.integers(40, 90)).astype(np.uint8)
      for _ in range(16)]
ts = [rng.integers(0, 4, size=rng.integers(40, 90)).astype(np.uint8)
      for _ in range(16)]

for mode in ("local", "global"):
    res = align_batch(
        qs, ts, scoring=sp, mode=mode, mesh=mesh, traceback=True,
    )
    for b in range(16):
        ref = align_oracle(qs[b], ts[b], sp, mode=mode)
        assert str(res[b]) == str(ref), (pid, mode, b, res[b], ref)

# banded global across the process boundary
res = align_batch(qs, qs[::-1], scoring=sp, mode="global", band=48, mesh=mesh)
for b in range(16):
    ref = align_oracle(qs[b], qs[15 - b], sp, mode="global", band=48)
    assert str(res[b]) == str(ref), (pid, "banded", b, res[b], ref)

# the chunked all-vs-all product: every process sees the whole result
out = align_all_vs_all(qs[:6], ts[:5], scoring=sp, mesh=mesh, chunk_pairs=8)
for i in range(6):
    for j in range(5):
        ref = align_oracle(qs[i], ts[j], sp, mode="local")
        got = tuple(int(out[f][i, j]) for f in ("score", "qs", "qe", "ts", "te"))
        assert got == (ref.score, ref.query_start, ref.query_end,
                       ref.target_start, ref.target_end), (pid, i, j)

print(f"MULTIHOST-OK p{pid}", flush=True)
