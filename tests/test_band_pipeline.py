"""Sequence-parallel pipelined wavefront (one pair over the mesh) vs the
oracle's Gotoh score, on the conftest-faked 8-device CPU mesh.
"""

import numpy as np
import pytest

from seqalib.oracle import nw_affine
from seqalib.oracle_fast import nw_affine as nw_affine_fast
from seqalib.parallel.band_pipeline import make_band_mesh, nw_affine_score_sp
from seqalib.types import ScoringParams

SP = ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)


@pytest.fixture(scope="module")
def mesh():
    return make_band_mesh()


@pytest.mark.parametrize(
    "n,m,C",
    [
        (300, 280, 64),  # rows not divisible by D, cols not by C
        (256, 256, 32),  # exact multiples
        (97, 203, 50),  # skewed shapes
        (5, 400, 64),  # fewer rows than devices * 1
        (40, 7, 16),  # target shorter than one tile
        (300, 100, 8),  # row-block R far exceeds tile width C
    ],
)
def test_sp_score_matches_oracle(mesh, n, m, C):
    rng = np.random.default_rng(n * 1000 + m)
    q = rng.integers(0, 4, n).astype(np.int32)
    t = rng.integers(0, 4, m).astype(np.int32)
    got = nw_affine_score_sp(q, t, SP, mesh, C=C)
    want = nw_affine(q, t, SP).score
    assert got == want


@pytest.mark.parametrize(
    "n,m,C",
    [
        (2100, 450, 128),  # several 128-row strips per device block
        (520, 260, 64),
        (260, 245, 64),
        (129, 130, 32),  # one row past a 128 boundary
        (16, 300, 128),  # two rows per device
    ],
)
def test_sp_score_long_and_odd_blocks(mesh, n, m, C):
    rng = np.random.default_rng(n * 1000 + m + 7)
    q = rng.integers(0, 4, n).astype(np.int32)
    t = rng.integers(0, 4, m).astype(np.int32)
    got = nw_affine_score_sp(q, t, SP, mesh, C=C)
    assert got == nw_affine_fast(q, t, SP).score


def test_sp_matrix_scoring(mesh):
    """Substitution-matrix scoring on the xla tile body (per-cell gather):
    BLOSUM62 protein long-pair score matches the oracle exactly."""
    rng = np.random.default_rng(5)
    sp = ScoringParams.blosum62()
    q = rng.integers(0, 20, 150).astype(np.int32)
    t = rng.integers(0, 20, 190).astype(np.int32)
    got = nw_affine_score_sp(q, t, sp, mesh, C=48)
    assert got == nw_affine(q, t, sp).score


def test_sp_matrix_scoring_wide(mesh):
    """BLOSUM62 on a pair wider than a 128-row strip per device."""
    rng = np.random.default_rng(9)
    sp = ScoringParams.blosum62()
    q = rng.integers(0, 20, 270).astype(np.int32)
    t = rng.integers(0, 20, 210).astype(np.int32)
    assert nw_affine_score_sp(q, t, sp, mesh, C=64) == nw_affine(q, t, sp).score


def test_sp_wide_range_matrix(mesh):
    """A table with scores of +-40: the per-cell gather takes any table."""
    mat = np.full((4, 4), -40, np.int32)
    np.fill_diagonal(mat, 40)
    sp = ScoringParams(gap_open=-5, gap_extend=-2, matrix=mat)
    rng = np.random.default_rng(3)
    q = rng.integers(0, 4, 50).astype(np.int32)
    t = rng.integers(0, 4, 61).astype(np.int32)
    assert nw_affine_score_sp(q, t, sp, mesh, C=16) == nw_affine(q, t, sp).score


def test_sp_mutated_copy(mesh):
    """Realistic long-pair case: target = query with SNPs + indels."""
    rng = np.random.default_rng(11)
    n = 384
    q = rng.integers(0, 4, n).astype(np.int32)
    t = q.copy()
    idx = rng.choice(n, 20, replace=False)
    t[idx] = (t[idx] + 1 + rng.integers(0, 3, 20)) % 4
    t = np.delete(t, [100, 101])
    t = np.insert(t, 250, [1, 2, 3]).astype(np.int32)
    got = nw_affine_score_sp(q, t, SP, mesh, C=96)
    assert got == nw_affine(q, t, SP).score


def test_sp_degenerate(mesh):
    assert nw_affine_score_sp([], [], SP, mesh) == 0
    assert nw_affine_score_sp([1, 2], [], SP, mesh) == SP.gap_open + 2 * SP.gap_extend


def test_sp_matrix_single_letter(mesh):
    """Degenerate 1x1 matrix-scoring pair (was the rejection case before
    the xla body grew gather-based matrix scoring)."""
    sp = ScoringParams.blosum62()
    got = nw_affine_score_sp([1], [1], sp, mesh)
    assert got == nw_affine(np.array([1]), np.array([1]), sp).score


# ---------------------------------------------------------------------------
# SP traceback: score + CIGAR over the mesh
# ---------------------------------------------------------------------------

from seqalib.parallel.band_pipeline import nw_affine_align_sp  # noqa: E402


@pytest.mark.parametrize(
    "n,m,C",
    [
        (400, 520, 128),  # path crosses every device block
        (333, 290, 64),   # odd shapes, R not divisible by C
        (97, 203, 50),    # small
        (5, 400, 64),     # fewer rows than devices
        (40, 7, 16),      # target shorter than one tile
    ],
)
def test_sp_align_matches_oracle(mesh, n, m, C):
    """str-level parity: score, full-span coords AND canonical CIGAR."""
    rng = np.random.default_rng(n * 1000 + m)
    q = rng.integers(0, 4, n).astype(np.int32)
    t = rng.integers(0, 4, m).astype(np.int32)
    got = nw_affine_align_sp(q, t, SP, mesh, C=C)
    want = nw_affine(q, t, SP)
    assert str(got) == str(want)


def test_sp_align_mutated_copy(mesh):
    """Indel-rich realistic case: long gap runs cross tile boundaries in
    E/F state (the extend-bit handoff between pointer tiles)."""
    rng = np.random.default_rng(17)
    n = 384
    q = rng.integers(0, 4, n).astype(np.int32)
    t = q.copy()
    idx = rng.choice(n, 20, replace=False)
    t[idx] = (t[idx] + 1 + rng.integers(0, 3, 20)) % 4
    t = np.delete(t, np.arange(100, 112))  # 12-col gap: E-extend chain
    t = np.insert(t, 250, rng.integers(0, 4, 9)).astype(np.int32)
    got = nw_affine_align_sp(q, t, SP, mesh, C=96)
    want = nw_affine(q, t, SP)
    assert str(got) == str(want)


def test_sp_align_matrix_scoring(mesh):
    sp = ScoringParams.blosum62()
    rng = np.random.default_rng(29)
    q = rng.integers(0, 20, 200).astype(np.int32)
    t = rng.integers(0, 20, 240).astype(np.int32)
    got = nw_affine_align_sp(q, t, sp, mesh, C=64)
    want = nw_affine(q, t, sp)
    assert str(got) == str(want)


def test_sp_align_degenerate(mesh):
    got = nw_affine_align_sp([1, 2], [], SP, mesh)
    assert (got.score, got.cigar) == (SP.gap_open + 2 * SP.gap_extend, "2I")
    got = nw_affine_align_sp([], [3], SP, mesh)
    assert (got.score, got.cigar) == (SP.gap_open + SP.gap_extend, "1D")


def test_sp_align_10kb(mesh):
    """One 10 kb pair.  The oracle is O(n*m)
    Python loops (infeasible here), so correctness splits into (a) the
    fill score vs an independent engine (the XLA wavefront via the
    public API) and (b) the in-function rescore assert, which proves the
    returned CIGAR attains that optimal score — together a complete
    optimality proof for the traceback."""
    from seqalib.api import align

    rng = np.random.default_rng(41)
    n = 10240
    q = rng.integers(0, 4, n).astype(np.uint8)
    t = q[: n - 2048].copy()
    idx = rng.choice(len(t), 150, replace=False)
    t[idx] = (t[idx] + 1 + rng.integers(0, 3, 150)) % 4
    got = nw_affine_align_sp(
        q.astype(np.int32), t.astype(np.int32), SP, mesh, C=256
    )
    ref = align(q, t, scoring=SP, mode="global", backend="xla")
    assert got.score == ref.score
    assert (got.query_end, got.target_end) == (n, len(t))
    from seqalib.utils.cigar import cigar_consumed

    assert cigar_consumed(got.cigar) == (n, len(t))


@pytest.mark.parametrize(
    "n,m,C",
    [
        (300, 280, 64),
        (97, 203, 50),
        (40, 7, 16),
    ],
)
def test_sp_local_score_matches_oracle(mesh, n, m, C):
    """SW (local) mode on the SP path."""
    from seqalib.oracle import sw_affine
    from seqalib.parallel.band_pipeline import sw_affine_score_sp

    rng = np.random.default_rng(n * 7 + m)
    q = rng.integers(0, 4, n).astype(np.int32)
    t = rng.integers(0, 4, m).astype(np.int32)
    got = sw_affine_score_sp(q, t, SP, mesh, C=C)
    assert got == sw_affine(q, t, SP).score


def test_sp_local_empty_and_disjoint(mesh):
    from seqalib.parallel.band_pipeline import sw_affine_score_sp

    assert sw_affine_score_sp(np.zeros(0, np.int32), np.arange(3, dtype=np.int32) % 4, SP, mesh) == 0
    # disjoint alphabets: best local alignment is empty -> score 0
    q = np.zeros(40, np.int32)
    t = np.ones(35, np.int32)
    assert sw_affine_score_sp(q, t, SP, mesh, C=16) == 0


@pytest.mark.parametrize("n,m,C", [(260, 245, 64), (8, 8, 8)])
def test_sp_local_score_odd_shapes(mesh, n, m, C):
    from seqalib.oracle import sw_affine
    from seqalib.parallel.band_pipeline import sw_affine_score_sp

    rng = np.random.default_rng(n + m)
    q = rng.integers(0, 4, n).astype(np.int32)
    t = rng.integers(0, 4, m).astype(np.int32)
    assert sw_affine_score_sp(q, t, SP, mesh, C=C) == sw_affine(q, t, SP).score


def test_sp_align_odd_block(mesh):
    """Traceback over blocks that are no multiple of the tile width."""
    from seqalib.parallel.band_pipeline import nw_affine_align_sp

    rng = np.random.default_rng(17)
    n, m = 260, 245
    q = rng.integers(0, 4, n).astype(np.int32)
    t = rng.integers(0, 4, m).astype(np.int32)
    got = nw_affine_align_sp(q, t, SP, mesh, C=64)
    assert str(got) == str(nw_affine(q, t, SP))
