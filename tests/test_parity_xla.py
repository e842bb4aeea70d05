"""XLA wavefront backend vs NumPy oracle: exact score/coords/CIGAR parity
(SURVEY.md §4.2). Runs on the faked CPU mesh env from conftest."""

import numpy as np
import pytest

from seqalib.api import align_batch
from seqalib.oracle import align_oracle
from seqalib.types import ScoringParams

LIN = ScoringParams.linear(match=2, mismatch=-3, gap=-2)
AFF = ScoringParams.affine(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
BLO = ScoringParams.blosum62(gap_open=-10, gap_extend=-1)


def _rand_pairs(rng, n_pairs, lo, hi, alpha=4):
    qs, ts = [], []
    for _ in range(n_pairs):
        qs.append(rng.integers(0, alpha, size=int(rng.integers(lo, hi + 1))).astype(np.uint8))
        ts.append(rng.integers(0, alpha, size=int(rng.integers(lo, hi + 1))).astype(np.uint8))
    return qs, ts


def _mutate(rng, s, sub=0.1, indel=0.05, alpha=4):
    """Realistic homologous pair: mutate s by substitutions and indels."""
    out = []
    for c in s:
        r = rng.random()
        if r < indel / 2:
            continue  # deletion
        if r < indel:
            out.append(int(rng.integers(0, alpha)))  # insertion
        if rng.random() < sub:
            out.append(int(rng.integers(0, alpha)))
        else:
            out.append(int(c))
    return np.array(out, dtype=np.uint8)


def assert_parity(qs, ts, sp, mode, band=None, backend="xla"):
    got = align_batch(qs, ts, scoring=sp, mode=mode, band=band, backend=backend)
    for q, t, g in zip(qs, ts, got):
        want = align_oracle(q, t, sp, mode=mode, band=band)
        assert str(g) == str(want), f"\n got={g}\nwant={want}\nq={q}\nt={t}"


@pytest.mark.parametrize("mode,sp", [("global", LIN), ("local", LIN)])
def test_linear_random_parity(rng, mode, sp):
    qs, ts = _rand_pairs(rng, 24, 1, 40)
    assert_parity(qs, ts, sp, mode)


@pytest.mark.parametrize("mode,sp", [("global", AFF), ("local", AFF)])
def test_affine_random_parity(rng, mode, sp):
    qs, ts = _rand_pairs(rng, 24, 1, 40)
    assert_parity(qs, ts, sp, mode)


def test_blosum62_local_parity(rng):
    qs, ts = _rand_pairs(rng, 12, 5, 60, alpha=20)
    assert_parity(qs, ts, BLO, "local")


def test_blosum62_global_parity(rng):
    qs, ts = _rand_pairs(rng, 8, 5, 50, alpha=20)
    assert_parity(qs, ts, BLO, "global")


def test_homologous_pairs_parity(rng):
    qs, ts = [], []
    for _ in range(8):
        q = rng.integers(0, 4, size=96).astype(np.uint8)
        qs.append(q)
        ts.append(_mutate(rng, q))
    assert_parity(qs, ts, LIN, "global")
    assert_parity(qs, ts, AFF, "local")


def test_banded_parity(rng):
    qs, ts = [], []
    for _ in range(6):
        q = rng.integers(0, 4, size=64).astype(np.uint8)
        qs.append(q)
        ts.append(_mutate(rng, q, sub=0.05, indel=0.03))
    for w in (2, 8, 64):
        assert_parity(qs, ts, AFF, "global", band=w)


def test_adversarial_shapes(rng):
    # len-1, equal seqs, disjoint alphabets, empty-ish, bucket-boundary sizes
    cases = [
        ("A", "A"),
        ("A", "G"),
        ("A", "GGGGGGGG"),
        ("ACGT" * 4, "ACGT" * 4),
        ("AAAAAAAA", "CCCCCCCC"),
        ("ACGT" * 4, "TGCA"),
        ("A" * 16, "A" * 17),  # straddles bucket boundary
        ("A" * 15, "A" * 16),
    ]
    from seqalib.types import encode_dna

    qs = [encode_dna(a) for a, _ in cases]
    ts = [encode_dna(b) for _, b in cases]
    for mode in ("global", "local"):
        for sp in (LIN, AFF):
            assert_parity(qs, ts, sp, mode)


def test_score_only_local_coords(rng):
    """Start-coordinate propagation (no traceback) must match traceback."""
    qs, ts = _rand_pairs(rng, 16, 4, 48)
    with_tb = align_batch(qs, ts, scoring=AFF, mode="local", backend="xla")
    no_tb = align_batch(
        qs, ts, scoring=AFF, mode="local", backend="xla", traceback=False
    )
    for a, b in zip(with_tb, no_tb):
        assert (a.score, a.query_start, a.query_end, a.target_start, a.target_end) == (
            b.score,
            b.query_start,
            b.query_end,
            b.target_start,
            b.target_end,
        )


def test_property_symmetry(rng):
    """score(q,t) == score(t,q); NW(x,x) == len*match; SW >= 0."""
    qs, ts = _rand_pairs(rng, 6, 10, 30)
    fw = align_batch(qs, ts, scoring=LIN, mode="global", backend="xla")
    bw = align_batch(ts, qs, scoring=LIN, mode="global", backend="xla")
    for a, b in zip(fw, bw):
        assert a.score == b.score
    same = align_batch(qs, qs, scoring=LIN, mode="global", backend="xla")
    for q, r in zip(qs, same):
        assert r.score == 2 * len(q) and r.cigar == f"{len(q)}M"
    loc = align_batch(qs, ts, scoring=LIN, mode="local", backend="xla")
    assert all(r.score >= 0 for r in loc)
