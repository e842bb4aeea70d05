"""Identities every correct aligner satisfies (ROADMAP C.3), checked on
the device engine, and a seeded differential fuzz of the three
implementations of one semantics: the scalar oracle, its vectorized twin
and the engine."""

import numpy as np
import pytest

from seqalib import oracle, oracle_fast
from seqalib.parallel.dispatch import dispatch_batch
from seqalib.types import ScoringParams
from seqalib.utils.cigar import cigar_to_ops, transpose_cigar, OP_I, OP_M

LIN = ScoringParams.linear(match=2, mismatch=-3, gap=-2)
AFF = ScoringParams.affine(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
BLOS = ScoringParams.blosum62()
SCORINGS = {"linear": LIN, "affine": AFF, "blosum62": BLOS}


def _pairs(rng, sp, n_pairs, lo, hi):
    alpha = 4 if sp.matrix is None else 20
    qs = [rng.integers(0, alpha, int(rng.integers(lo, hi + 1))).astype(np.uint8)
          for _ in range(n_pairs)]
    ts = [rng.integers(0, alpha, int(rng.integers(lo, hi + 1))).astype(np.uint8)
          for _ in range(n_pairs)]
    return qs, ts


def rescore(q, t, r, sp) -> int:
    """Score of the alignment r.cigar places at r's coordinates."""
    i, j, s, prev = r.query_start, r.target_start, 0, None
    for op in cigar_to_ops(r.cigar):
        if op == OP_M:
            s += sp.substitution(int(q[i]), int(t[j]))
            i += 1
            j += 1
        else:
            s += sp.gap_extend + (sp.gap_open if op != prev else 0)
            i += op == OP_I
            j += op != OP_I
        prev = op
    assert (i, j) == (r.query_end, r.target_end)
    return s


@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("mode", ["global", "local"])
def test_transpose_symmetry(rng, name, mode):
    """align(t, q) is align(q, t) with query and target swapped: same
    score, swapped coordinates, and (global) the CIGAR with I and D
    swapped whenever the transposed path is itself canonical."""
    sp = SCORINGS[name]
    qs, ts = _pairs(rng, sp, 6, 8, 40)
    fw = dispatch_batch(qs, ts, sp, mode=mode)
    bw = dispatch_batch(ts, qs, sp, mode=mode)
    for a, b, q, t in zip(fw, bw, qs, ts):
        assert a.score == b.score
        if mode == "global":
            assert (a.query_end, a.target_end) == (b.target_end, b.query_end)
            # both CIGARs are optimal paths of the other's problem
            swapped = b.__class__(b.score, 0, len(q), 0, len(t),
                                  transpose_cigar(b.cigar))
            assert rescore(q, t, swapped, sp) == a.score


@pytest.mark.parametrize("name", list(SCORINGS))
def test_self_global_is_all_matches(rng, name):
    """NW(x, x) = sum of the diagonal scores, CIGAR all M (DNA: len*match)."""
    sp = SCORINGS[name]
    qs, _ = _pairs(rng, sp, 6, 1, 50)
    got = dispatch_batch(qs, qs, sp, mode="global")
    for q, r in zip(qs, got):
        assert r.score == sum(sp.substitution(int(c), int(c)) for c in q)
        assert r.cigar == f"{len(q)}M"
        if sp.matrix is None:
            assert r.score == len(q) * sp.match


@pytest.mark.parametrize("name", list(SCORINGS))
def test_local_score_nonnegative_and_bounded(rng, name):
    """0 <= SW(q, t) and SW >= NW restricted to any window, in particular
    SW(q, t) >= NW(q, t)."""
    sp = SCORINGS[name]
    qs, ts = _pairs(rng, sp, 8, 1, 40)
    loc = dispatch_batch(qs, ts, sp, mode="local")
    glo = dispatch_batch(qs, ts, sp, mode="global")
    for a, b in zip(loc, glo):
        assert a.score >= 0
        assert a.score >= b.score


@pytest.mark.parametrize("name", list(SCORINGS))
@pytest.mark.parametrize("mode", ["global", "local"])
def test_cigar_rescore_equals_score(rng, name, mode):
    sp = SCORINGS[name]
    qs, ts = _pairs(rng, sp, 8, 1, 60)
    for q, t, r in zip(qs, ts, dispatch_batch(qs, ts, sp, mode=mode)):
        assert rescore(q, t, r, sp) == r.score, r


def test_banded_cigar_rescore_equals_score(rng):
    qs, ts = _pairs(rng, AFF, 8, 30, 60)
    for w in (4, 16):
        got = dispatch_batch(qs, ts, AFF, mode="global", band=w)
        for q, t, r in zip(qs, ts, got):
            assert rescore(q, t, r, AFF) == r.score, r


@pytest.mark.parametrize("seed", range(8))
def test_differential_fuzz(seed):
    """oracle == oracle_fast == engine on a seeded random mix of scoring,
    mode, band and ragged lengths (including empty sequences)."""
    rng = np.random.default_rng(1000 + seed)
    name = ("linear", "affine", "blosum62")[seed % 3]
    sp = SCORINGS[name]
    mode = "global" if seed % 2 else "local"
    band = int(rng.integers(2, 12)) if mode == "global" and seed % 4 == 1 else None
    qs, ts = _pairs(rng, sp, 10, 0, 70)
    if band is not None:  # the band must contain the end cell
        ts = [t[: len(q) + band] if len(t) > len(q) + band else t
              for q, t in zip(qs, ts)]
        qs = [q[: len(t) + band] if len(q) > len(t) + band else q
              for q, t in zip(qs, ts)]
    got = dispatch_batch(qs, ts, sp, mode=mode, band=band)
    for q, t, g in zip(qs, ts, got):
        a = oracle.align_oracle(q, t, sp, mode=mode, band=band)
        b = oracle_fast.align_oracle(q, t, sp, mode=mode, band=band)
        assert a == b == g, (q, t, a, b, g)
