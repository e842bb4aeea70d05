"""Generic-container aligner (reference template-API equivalent) tests."""

import numpy as np

from seqalib.models.generic import (
    FOGSAA,
    AlignedSequence,
    DiagonalWindowsSA,
    HirschbergSA,
    NeedlemanWunschSA,
    ScoringSystem,
    SmithWatermanSA,
)
from seqalib.oracle import align_oracle
from seqalib.types import ScoringParams, encode_dna


def test_nw_matches_oracle_on_dna():
    sc = ScoringSystem(gap_penalty=-2, match_profit=2, mismatch_penalty=-3)
    sa = NeedlemanWunschSA(sc)
    q, t = "ACGTACGT", "ACGACGT"
    got = sa.get_alignment(q, t)
    want = align_oracle(
        encode_dna(q), encode_dna(t), ScoringParams.linear(2, -3, -2), mode="global"
    )
    assert got.score == want.score
    assert got.cigar() == want.cigar


def test_sw_matches_oracle_on_dna():
    sc = ScoringSystem(gap_penalty=-2, match_profit=2, mismatch_penalty=-3)
    sa = SmithWatermanSA(sc)
    q, t = "TTTACGTACGTTT", "GGACGTACGG"
    got = sa.get_alignment(q, t)
    want = align_oracle(
        encode_dna(q), encode_dna(t), ScoringParams.linear(2, -3, -2), mode="local"
    )
    assert got.score == want.score


def test_hirschberg_score_equals_nw():
    rng = np.random.default_rng(3)
    sc = ScoringSystem(gap_penalty=-1, match_profit=2, mismatch_penalty=-1)
    for _ in range(5):
        s1 = list(rng.integers(0, 4, rng.integers(1, 40)))
        s2 = list(rng.integers(0, 4, rng.integers(1, 40)))
        nw = NeedlemanWunschSA(sc).get_alignment(s1, s2)
        hb = HirschbergSA(sc).get_alignment(s1, s2)
        assert hb.score == nw.score
        # both must be valid full alignments of the inputs
        assert [e.a for e in hb if e.a is not None] == s1
        assert [e.b for e in hb if e.b is not None] == s2


def test_banded_wide_equals_full():
    rng = np.random.default_rng(4)
    sc = ScoringSystem(gap_penalty=-1, match_profit=2, mismatch_penalty=-1)
    s1 = list(rng.integers(0, 4, 30))
    s2 = list(rng.integers(0, 4, 33))
    full = NeedlemanWunschSA(sc).get_alignment(s1, s2)
    wide = DiagonalWindowsSA(sc, window=64).get_alignment(s1, s2)
    assert wide.score == full.score


def test_arbitrary_objects_and_match_fn():
    """The reference aligns arbitrary element streams (e.g. instructions)."""
    sc = ScoringSystem(gap_penalty=-1, match_profit=3, allow_mismatch=False)
    ops1 = [("add", 1), ("mul", 2), ("ld", 3), ("st", 4)]
    ops2 = [("add", 9), ("ld", 7), ("st", 4)]
    # match on opcode only
    sa = NeedlemanWunschSA(sc, match_fn=lambda a, b: a[0] == b[0])
    res = sa.get_alignment(ops1, ops2)
    assert isinstance(res, AlignedSequence)
    assert res.matches() == 3  # add, ld, st
    # mul must be gapped (allow_mismatch=False)
    gapped = [e for e in res if e.b is None]
    assert len(gapped) == 1 and gapped[0].a == ("mul", 2)


def _score_of(ents, sc, match_fn=lambda a, b: a == b):
    s = 0
    for e in ents:
        if e.a is None or e.b is None:
            s += sc.gap_penalty
        elif match_fn(e.a, e.b):
            s += sc.match_profit
        else:
            s += sc.mismatch_penalty
    return s


def test_fogsaa_score_equals_nw():
    rng = np.random.default_rng(7)
    sc = ScoringSystem(gap_penalty=-2, match_profit=2, mismatch_penalty=-3)
    for _ in range(8):
        s1 = list(rng.integers(0, 4, rng.integers(0, 35)))
        s2 = list(rng.integers(0, 4, rng.integers(0, 35)))
        nw = NeedlemanWunschSA(sc).get_alignment(s1, s2)
        fg = FOGSAA(sc).get_alignment(s1, s2)
        assert fg.score == nw.score
        # valid full alignment of both inputs, score self-consistent
        assert [e.a for e in fg if e.a is not None] == s1
        assert [e.b for e in fg if e.b is not None] == s2
        assert _score_of(fg.entries, sc) == fg.score


def test_fogsaa_prunes_on_similar_sequences():
    rng = np.random.default_rng(8)
    sc = ScoringSystem(gap_penalty=-3, match_profit=2, mismatch_penalty=-3)
    s1 = list(rng.integers(0, 4, 60))
    s2 = list(s1)
    s2[30] = (s2[30] + 1) % 4
    sa = FOGSAA(sc)
    res = sa.get_alignment(s1, s2)
    assert res.score == NeedlemanWunschSA(sc).get_alignment(s1, s2).score
    # branch-and-bound must expand far fewer nodes than the full DP grid
    assert sa.expanded < (len(s1) + 1) * (len(s2) + 1) // 4


def test_fogsaa_no_mismatch_mode():
    sc = ScoringSystem(gap_penalty=-1, match_profit=3, allow_mismatch=False)
    ops1 = [("add", 1), ("mul", 2), ("ld", 3)]
    ops2 = [("add", 9), ("ld", 7)]
    fn = lambda a, b: a[0] == b[0]
    fg = FOGSAA(sc, match_fn=fn).get_alignment(ops1, ops2)
    nw = NeedlemanWunschSA(sc, match_fn=fn).get_alignment(ops1, ops2)
    assert fg.score == nw.score
    assert fg.matches() == 2


def test_aligned_sequence_container():
    sc = ScoringSystem()
    res = NeedlemanWunschSA(sc).get_alignment("AB", "AB")
    assert len(res) == 2
    assert all(e.is_match for e in res)
    assert res.cigar() == "2M"


def test_myers_miller_matches_gotoh_oracle():
    """Linear-space affine global alignment: optimal score must equal the
    full-matrix Gotoh oracle on randomized pairs, and the emitted columns
    must be a valid alignment whose re-score equals the reported score."""
    from seqalib.models.generic import MyersMillerSA
    from seqalib.oracle import nw_affine

    rng = np.random.default_rng(0)
    sc = ScoringSystem(gap_penalty=-1, match_profit=3, mismatch_penalty=-2)
    for o, e in [(-5, -1), (-3, -2), (0, -2), (-11, -1)]:
        sa = MyersMillerSA(sc, gap_open=o, gap_extend=e)
        sp = ScoringParams(match=3, mismatch=-2, gap_open=o, gap_extend=e)
        for _ in range(12):
            n = int(rng.integers(0, 40))
            m = int(rng.integers(0, 40))
            q = rng.integers(0, 4, n)
            t = rng.integers(0, 4, m)
            got = sa.get_alignment(list(q), list(t))
            want = nw_affine(q, t, sp)
            assert got.score == want.score, (o, e, n, m, got.score, want.score)
            # validity: columns consume q and t exactly, in order
            qa = [ent.a for ent in got if ent.a is not None]
            ta = [ent.b for ent in got if ent.b is not None]
            assert qa == list(q) and ta == list(t)


def test_myers_miller_long_gappy_pair():
    """A pair whose optimum is one long straddling deletion (the case the
    midline gap-merge credit exists for)."""
    from seqalib.models.generic import MyersMillerSA
    from seqalib.oracle import nw_affine

    rng = np.random.default_rng(7)
    core = rng.integers(0, 4, 60)
    ins = rng.integers(0, 4, 31)
    q = np.concatenate([core[:30], ins, core[30:]])
    t = core
    sc = ScoringSystem(match_profit=2, mismatch_penalty=-3)
    sa = MyersMillerSA(sc, gap_open=-8, gap_extend=-1)
    sp = ScoringParams(match=2, mismatch=-3, gap_open=-8, gap_extend=-1)
    got = sa.get_alignment(list(q), list(t))
    assert got.score == nw_affine(q, t, sp).score


def test_gotoh_generic_matches_oracle():
    """GotohSA (full-matrix affine, generic elements): global and local
    results must match the engine oracle exactly, CIGAR included."""
    from seqalib.models.generic import GotohSA
    from seqalib.oracle import nw_affine, sw_affine

    rng = np.random.default_rng(3)
    sc = ScoringSystem(match_profit=2, mismatch_penalty=-3)
    sp = ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
    for _ in range(6):
        n, m = int(rng.integers(0, 35)), int(rng.integers(0, 35))
        q = rng.integers(0, 4, n)
        t = rng.integers(0, 4, m)
        g = GotohSA(sc, gap_open=-5, gap_extend=-2).get_alignment(list(q), list(t))
        ref = nw_affine(q, t, sp)
        assert g.score == ref.score
        assert g.cigar() == ref.cigar
        gl = GotohSA(sc, gap_open=-5, gap_extend=-2, local=True).get_alignment(
            list(q), list(t)
        )
        refl = sw_affine(q, t, sp)
        assert gl.score == refl.score
