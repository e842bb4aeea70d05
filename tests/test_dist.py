"""Distribution-layer tests on a faked 8-device CPU mesh (SURVEY.md §4.4).

Asserts the sharded pair-stream path (bucket -> shard -> gather -> unpermute)
is bit-exact vs the oracle, including batches not divisible by the mesh and
mixed-length bucketing.
"""

import numpy as np
import pytest

import jax

from seqalib import ScoringParams, align_batch
from seqalib.oracle import align_oracle
from seqalib.parallel.dist import make_pair_mesh

from conftest import random_dna, random_protein


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device (faked CPU) backend")
    return make_pair_mesh()


def _check(results, qs, ts, sp, mode):
    for r, q, t in zip(results, qs, ts):
        o = align_oracle(q, t, sp, mode=mode)
        assert (r.score, r.query_start, r.query_end, r.target_start, r.target_end) == (
            o.score,
            o.query_start,
            o.query_end,
            o.target_start,
            o.target_end,
        )
        assert r.cigar == o.cigar


def test_sharded_local_linear_dna(mesh, rng):
    sp = ScoringParams.linear()
    qs = [random_dna(rng, int(n)) for n in rng.integers(20, 120, size=13)]
    ts = [random_dna(rng, int(n)) for n in rng.integers(20, 120, size=13)]
    res = align_batch(qs, ts, scoring=sp, mode="local", backend="xla", mesh=mesh)
    _check(res, qs, ts, sp, "local")


def test_sharded_global_affine_protein(mesh, rng):
    sp = ScoringParams.blosum62()
    qs = [random_protein(rng, int(n)) for n in rng.integers(10, 60, size=9)]
    ts = [random_protein(rng, int(n)) for n in rng.integers(10, 60, size=9)]
    res = align_batch(qs, ts, scoring=sp, mode="global", backend="xla", mesh=mesh)
    _check(res, qs, ts, sp, "global")


def test_sharded_matches_unsharded(mesh, rng):
    sp = ScoringParams.affine()
    qs = [random_dna(rng, 64) for _ in range(16)]
    ts = [random_dna(rng, 64) for _ in range(16)]
    a = align_batch(qs, ts, scoring=sp, mode="local", backend="xla", mesh=mesh)
    b = align_batch(qs, ts, scoring=sp, mode="local", backend="xla")
    assert a == b


def test_sharded_local_blosum62_parity(mesh, rng):
    """Local + traceback over the mesh, batch not divisible by it."""
    sp = ScoringParams.blosum62()
    qs = [random_protein(rng, int(n)) for n in rng.integers(15, 80, size=11)]
    ts = [random_protein(rng, int(n)) for n in rng.integers(15, 80, size=11)]
    res = align_batch(qs, ts, scoring=sp, mode="local", mesh=mesh)
    _check(res, qs, ts, sp, "local")


def test_sharded_local_matches_unsharded_odd_batch(mesh, rng):
    sp = ScoringParams.affine()
    qs = [random_dna(rng, 48) for _ in range(10)]
    ts = [random_dna(rng, 48) for _ in range(10)]
    a = align_batch(qs, ts, scoring=sp, mode="local", mesh=mesh)
    b = align_batch(qs, ts, scoring=sp, mode="local")
    assert a == b


def test_sharded_global_blosum62_parity(mesh, rng):
    sp = ScoringParams.blosum62()
    qs = [random_protein(rng, int(n)) for n in rng.integers(10, 70, size=11)]
    ts = [random_protein(rng, int(n)) for n in rng.integers(10, 70, size=11)]
    res = align_batch(qs, ts, scoring=sp, mode="global", mesh=mesh)
    _check(res, qs, ts, sp, "global")


def test_sharded_global_matches_unsharded(mesh, rng):
    sp = ScoringParams.affine()
    qs = [random_dna(rng, 48) for _ in range(10)]
    ts = [random_dna(rng, 52) for _ in range(10)]
    a = align_batch(qs, ts, scoring=sp, mode="global", mesh=mesh)
    b = align_batch(qs, ts, scoring=sp, mode="global")
    assert a == b


def _mutated_pairs(rng, lengths):
    qs, ts = [], []
    for n in lengths:
        q = random_dna(rng, int(n))
        t = q.copy()
        k = max(1, int(n) // 10)
        idx = rng.choice(int(n), k, replace=False)
        t[idx] = (t[idx] + 1 + rng.integers(0, 3, k)) % 4
        qs.append(q)
        ts.append(t)
    return qs, ts


def test_sharded_banded_parity(mesh, rng):
    """mesh + band: the masked-band engine, pair-sharded."""
    sp = ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
    qs, ts = _mutated_pairs(rng, rng.integers(40, 90, size=9))
    res = align_batch(qs, ts, scoring=sp, mode="global", band=16, mesh=mesh)
    for r, q, t in zip(res, qs, ts):
        assert r == align_oracle(q, t, sp, mode="global", band=16)


def test_sharded_banded_matches_unsharded(mesh, rng):
    sp = ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
    qs = [random_dna(rng, 60) for _ in range(6)]
    ts = [random_dna(rng, 64) for _ in range(6)]
    a = align_batch(qs, ts, scoring=sp, mode="global", band=16, mesh=mesh)
    b = align_batch(qs, ts, scoring=sp, mode="global", band=16)
    assert a == b


def test_sharded_launch_only_defers_the_fetch(mesh, monkeypatch):
    """run_bucket(launch_only=True) under a mesh returns before any host
    fetch; the finalizer fetches, and equals the synchronous call."""
    from seqalib.oracle import sw_affine
    from seqalib.parallel import dispatch, dist

    rng = np.random.default_rng(5)
    sp = ScoringParams.affine(match=2, mismatch=-3, gap_open=-4,
                              gap_extend=-1)
    n = 200
    base = rng.integers(0, 4, n).astype(np.int32)
    q = np.stack([base] * 8)
    t = q.copy()
    t[1, 50] = (t[1, 50] + 1) % 4
    lens = np.full(8, n, np.int32)
    out = dispatch.run_bucket(q, t, lens, lens, sp, "local", None, False,
                              mesh=mesh)
    fetched = []
    real = dist.gather_to_host
    monkeypatch.setattr(
        dist, "gather_to_host", lambda tree: fetched.append(1) or real(tree)
    )
    fin = dispatch.run_bucket(q, t, lens, lens, sp, "local", None, False,
                              mesh=mesh, launch_only=True)
    assert not fetched
    out2 = fin()
    assert fetched
    for b in range(8):
        ref = sw_affine(q[b], t[b], sp)
        want = (ref.score, ref.query_start, ref.query_end, ref.target_start,
                ref.target_end)
        for o in (out, out2):
            got = tuple(int(o[k][b]) for k in ("score", "qs", "qe", "ts", "te"))
            assert got == want, (b, got)
