"""Oracle unit tests: hand-worked tiny examples with known optimal alignments,
tie-break cases, BLOSUM62 spot values, CIGAR round-trip (SURVEY.md §4.1)."""

import numpy as np
import pytest

from seqalib.oracle import nw_affine, nw_linear, sw_affine, sw_linear
from seqalib.types import (
    BLOSUM62,
    PROTEIN_ALPHABET,
    ScoringParams,
    encode_dna,
    encode_protein,
)
from seqalib.utils.cigar import (
    cigar_consumed,
    cigar_to_ops,
    ops_to_cigar,
    transpose_cigar,
)

LIN = ScoringParams.linear(match=2, mismatch=-3, gap=-2)
AFF = ScoringParams.affine(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)


# ---------------------------------------------------------------- CIGAR codec
def test_cigar_roundtrip():
    ops = [0, 0, 0, 1, 1, 2, 0]
    assert ops_to_cigar(ops) == "3M2I1D1M"
    assert cigar_to_ops("3M2I1D1M") == ops
    assert cigar_consumed("3M2I1D1M") == (6, 5)
    assert transpose_cigar("3M2I1D1M") == "3M2D1I1M"
    assert ops_to_cigar([]) == ""
    assert ops_to_cigar([0, 255, 1]) == "1M"  # stops at padding


# ------------------------------------------------------------------- BLOSUM62
def test_blosum62_spot_values():
    idx = {c: i for i, c in enumerate(PROTEIN_ALPHABET)}
    assert BLOSUM62[idx["W"], idx["W"]] == 11
    assert BLOSUM62[idx["A"], idx["A"]] == 4
    assert BLOSUM62[idx["A"], idx["R"]] == -1
    assert BLOSUM62[idx["E"], idx["Z"]] == 4
    assert BLOSUM62[idx["*"], idx["*"]] == 1
    assert BLOSUM62[idx["C"], idx["C"]] == 9
    assert BLOSUM62[idx["L"], idx["I"]] == 2


# ------------------------------------------------------------------ NW linear
def test_nw_identical():
    q = encode_dna("ACGTACGT")
    r = nw_linear(q, q, LIN)
    assert r.score == 2 * 8
    assert r.cigar == "8M"


def test_nw_single_mismatch():
    r = nw_linear(encode_dna("ACGT"), encode_dna("AGGT"), LIN)
    assert r.score == 3 * 2 - 3
    assert r.cigar == "4M"


def test_nw_simple_gap():
    # q=ACGT t=ACT: delete G -> 3M with one I (query consumed extra)
    r = nw_linear(encode_dna("ACGT"), encode_dna("ACT"), LIN)
    assert r.score == 3 * 2 - 2
    assert r.query_end == 4 and r.target_end == 3
    q_used, t_used = cigar_consumed(r.cigar)
    assert (q_used, t_used) == (4, 3)
    assert r.cigar == "2M1I1M"


def test_nw_empty_vs_seq():
    r = nw_linear(encode_dna(""), encode_dna("ACG"), LIN)
    assert r.score == -6
    assert r.cigar == "3D"
    r = nw_linear(encode_dna("ACG"), encode_dna(""), LIN)
    assert r.score == -6
    assert r.cigar == "3I"


def test_nw_tiebreak_diag_over_gaps():
    # A vs G: mismatch -3 vs gap route I+D = -4: diag wins outright;
    # with mismatch == 2*gap it's a tie and DIAG must win canonically.
    sp = ScoringParams.linear(match=2, mismatch=-4, gap=-2)
    r = nw_linear(encode_dna("A"), encode_dna("G"), sp)
    assert r.score == -4
    assert r.cigar == "1M"  # canonical: DIAG > UP > LEFT


def test_nw_tiebreak_up_over_left():
    # q=AC t=A then q=A t=AC: symmetric; verify I/D orientation.
    r = nw_linear(encode_dna("AC"), encode_dna("A"), LIN)
    assert r.cigar == "1M1I"
    r = nw_linear(encode_dna("A"), encode_dna("AC"), LIN)
    assert r.cigar == "1M1D"


def test_nw_symmetry_transpose(rng):
    for _ in range(5):
        q = rng.integers(0, 4, size=17).astype(np.uint8)
        t = rng.integers(0, 4, size=23).astype(np.uint8)
        r1 = nw_linear(q, t, LIN)
        r2 = nw_linear(t, q, LIN)
        assert r1.score == r2.score


# ------------------------------------------------------------------ SW linear
def test_sw_exact_substring():
    q = encode_dna("CGT")
    t = encode_dna("AACGTAA")
    r = sw_linear(q, t, LIN)
    assert r.score == 6
    assert (r.query_start, r.query_end) == (0, 3)
    assert (r.target_start, r.target_end) == (2, 5)
    assert r.cigar == "3M"


def test_sw_all_negative():
    sp = ScoringParams.linear(match=2, mismatch=-3, gap=-2)
    r = sw_linear(encode_dna("AAAA"), encode_dna("CCCC"), sp)
    assert r.score == 0
    assert r.cigar == ""


def test_sw_argmax_tiebreak_smallest_ij():
    # Two identical maximal hits; must report the first (smallest i, then j).
    q = encode_dna("AC")
    t = encode_dna("ACGGAC")
    r = sw_linear(q, t, LIN)
    assert r.score == 4
    assert (r.target_start, r.target_end) == (0, 2)


def test_sw_internal_mismatch_bridge():
    # Bridging a mismatch pays when flanks are long enough.
    q = encode_dna("AAAATAAAA")
    t = encode_dna("AAAAGAAAA")
    r = sw_linear(q, t, LIN)
    assert r.score == 8 * 2 - 3
    assert r.cigar == "9M"


# ----------------------------------------------------------------- NW affine
def test_nw_affine_prefers_one_long_gap():
    # Two isolated 1-gaps cost 2*(o+e); one 2-gap costs o+2e: with o=-4,e=-1
    # a contiguous gap is cheaper -- classic affine behavior.
    q = encode_dna("ACGTACGT")
    t = encode_dna("ACACGT")  # drop "GT" at positions 2-3 contiguously
    r = nw_affine(q, t, AFF)
    assert r.cigar in ("2M2I4M",)
    assert r.score == 6 * 2 + (-4 - 2)


def test_nw_affine_equals_linear_score_when_open_zero(rng):
    sp_aff = ScoringParams(match=2, mismatch=-3, gap_open=0, gap_extend=-2)
    for _ in range(5):
        q = rng.integers(0, 4, size=13).astype(np.uint8)
        t = rng.integers(0, 4, size=19).astype(np.uint8)
        assert nw_affine(q, t, sp_aff).score == nw_linear(q, t, sp_aff).score


def test_nw_affine_gap_runs_consistent():
    q = encode_dna("AAAA")
    t = encode_dna("")
    r = nw_affine(q, t, AFF)
    assert r.score == -4 - 4 * 1
    assert r.cigar == "4I"


# ---------------------------------------------------------- CIGAR re-scoring
def rescore(q, t, r, sp):
    """Recompute an AlignResult's score from its CIGAR (consistency check)."""
    i, j = r.query_start, r.target_start
    score = 0
    in_gap = None
    for op in cigar_to_ops(r.cigar):
        if op == 0:  # M
            score += sp.substitution(int(q[i]), int(t[j]))
            i += 1
            j += 1
            in_gap = None
        else:  # I consumes query, D consumes target
            if in_gap != op:
                score += sp.gap_open
            score += sp.gap_extend
            in_gap = op
            if op == 1:
                i += 1
            else:
                j += 1
    assert (i, j) == (r.query_end, r.target_end)
    return score


# ----------------------------------------------------------------- SW affine
def test_sw_affine_blosum62():
    # Durbin et al. style example (scored here with BLOSUM62, o=-10, e=-1).
    sp = ScoringParams.blosum62(gap_open=-10, gap_extend=-1)
    q = encode_protein("HEAGAWGHEE")
    t = encode_protein("PAWHEAE")
    r = sw_affine(q, t, sp)
    assert r.score == rescore(q, t, r, sp)
    # Hand-checkable lower bound: HEA vs HEA scores 8+5+4 = 17.
    assert r.score >= 17


def test_sw_affine_all_negative():
    sp = ScoringParams.blosum62()
    q = encode_protein("WWWW")
    t = encode_protein("PPPP")
    r = sw_affine(q, t, sp)
    assert r.score == 0 and r.cigar == ""


# ----------------------------------------------------------------- banded NW
def test_banded_equals_full_when_band_wide(rng):
    for _ in range(3):
        q = rng.integers(0, 4, size=24).astype(np.uint8)
        t = rng.integers(0, 4, size=30).astype(np.uint8)
        full = nw_affine(q, t, AFF)
        banded = nw_affine(q, t, AFF, band=64)
        assert full.score == banded.score
        assert full.cigar == banded.cigar


def test_banded_narrow_band_still_valid():
    q = encode_dna("ACGTACGTACGT")
    t = encode_dna("ACGTACGTACGT")
    r = nw_affine(q, t, AFF, band=1)
    assert r.score == 24 and r.cigar == "12M"


def test_banded_score_le_full(rng):
    # A narrow band can only restrict the solution space.
    for _ in range(5):
        q = rng.integers(0, 4, size=20).astype(np.uint8)
        t = rng.integers(0, 4, size=20).astype(np.uint8)
        assert nw_affine(q, t, AFF, band=2).score <= nw_affine(q, t, AFF).score
