"""Constructed canonical ties: the engine must return the oracle's
canonical local start exactly.

The local start is canonical when, among all optimal alignments ending at
the canonical end, it is the one the anchored reverse extension reaches
first (smallest ri, then smallest rj; oracle.py docstring).  Two problems
below are built so that a co-optimal start exists far off that cell:
engines that search a window around the end (band or column clamp) could
return the other start with no score shortfall to betray it.  The device
engine's pass 2 spans the full reversed prefixes, so it has no such
window; these cases pin that.

Construction (a) (in pass-2 reversed space; scoring: diag +11, off -4,
linear gap -1):

  rq = [A-block 7][M-block 7][junk 28][N-block 7]            (49 rows)
  rt = [A-block 7][junk][N-block 7 @43..49][junk][M @78..84] (84 cols)

Two extension paths tie at the global max 84 = 7*11 - 70 + 7*11:
  P1 (canonical, ri=14): A-block, 70 deletions, M-block -> cell (14, 84)
     with a net gap of 70;
  P2 (ri=49): A-block, 35I+35D, N-block -> cell (49, 49), on the diagonal.
Interior blocks alone score 77 < 84, and block order makes every other
combination geometrically impossible, so the tie is exact and unique.
"""

import numpy as np
import pytest

from seqalib.oracle import align_oracle
from seqalib.parallel.dispatch import dispatch_batch
from seqalib.types import ScoringParams


def _tie_problem():
    A = list(range(0, 7))
    M = list(range(7, 14))
    N = list(range(14, 21))
    JQ, JT = 28, 29
    rq = np.full(49, JQ, np.uint8)
    rq[0:7] = A
    rq[7:14] = M
    rq[42:49] = N
    rt = np.full(84, JT, np.uint8)
    rt[0:7] = A
    rt[42:49] = N
    rt[77:84] = M
    q = rq[::-1].copy()
    t = rt[::-1].copy()
    mat = np.full((30, 30), -4, np.int32)
    for L in A + M + N:
        mat[L, L] = 11
    sp = ScoringParams(gap_open=0, gap_extend=-1, matrix=mat)
    return q, t, sp


def _run(q, t, sp, traceback=True, mesh=None):
    return dispatch_batch(
        [q], [t], sp, mode="local", traceback=traceback, mesh=mesh
    )[0]


def test_oracle_tie_is_as_constructed():
    q, t, sp = _tie_problem()
    o = align_oracle(q, t, sp, mode="local")
    # canonical (min-ri) start = the 70-deletion-imbalance path
    assert (o.score, o.query_start, o.query_end, o.target_start, o.target_end) == (
        84, 35, 49, 0, 84
    )
    assert o.cigar == "7M70D7M"


@pytest.mark.parametrize("traceback", [True, False])
def test_engine_returns_canonical_tie(traceback):
    q, t, sp = _tie_problem()
    r = _run(q, t, sp, traceback)
    assert r.score == 84
    assert (r.query_end, r.target_end) == (49, 84)
    assert (r.query_start, r.target_start) == (35, 0)
    if traceback:
        assert r.cigar == "7M70D7M"


def test_engine_canonical_tie_on_a_mesh():
    """The pair-sharded path runs the same program per device."""
    from seqalib.parallel.dist import make_pair_mesh

    q, t, sp = _tie_problem()
    assert _run(q, t, sp, mesh=make_pair_mesh()) == align_oracle(
        q, t, sp, mode="local"
    )


def test_engine_canonical_tie_in_a_batch():
    """The tie pair beside ordinary pairs of another length bucket."""
    q, t, sp = _tie_problem()
    rng = np.random.default_rng(3)
    qs = [q] + [rng.integers(0, 21, 150).astype(np.uint8) for _ in range(3)]
    ts = [t] + [rng.integers(0, 21, 170).astype(np.uint8) for _ in range(3)]
    got = dispatch_batch(qs, ts, sp, mode="local")
    for g, qq, tt in zip(got, qs, ts):
        assert g == align_oracle(qq, tt, sp, mode="local")


def test_clean_pairs_exact():
    """Full-coords parity on a random BLOSUM62 batch."""
    rng = np.random.default_rng(7)
    sp = ScoringParams.blosum62()
    B, L = 8, 96
    qs = [rng.integers(0, 20, L).astype(np.uint8) for _ in range(B)]
    ts = [rng.integers(0, 20, L).astype(np.uint8) for _ in range(B)]
    got = dispatch_batch(qs, ts, sp, mode="local", traceback=False)
    for g, q, t in zip(got, qs, ts):
        o = align_oracle(q, t, sp, mode="local")
        assert (g.score, g.query_start, g.query_end, g.target_start,
                g.target_end) == (o.score, o.query_start, o.query_end,
                                  o.target_start, o.target_end)


# ---- class (b): a tie beyond a 256-column window --------------------------
#
# Construction (reversed space; matrix diag X=Z=+11, Y=+4, else -4,
# linear gap -1; a 12-letter table):
#
#   rq = [X*28][Z*28][junk*28][Y*40]                      (124 rows)
#   rt = [X*28][Y*40][junk][Z*28 @232..259]               (260 cols)
#
# Two extension paths tie at 412:
#   P1 (canonical, ri=56):  X-block, 204 D, Z-block -> cell (56, 260),
#      with rj = 260 past any 256-column window and a net gap of 204;
#   P2 (ri=124): X-block, 56 I, Y-block -> cell (124, 68).
# The distinct Z suffix block pins P1's prefix to rows 0-27 (an X
# suffix let the prefix slide and moved the forward END off the anchor).


def _tie_problem_b():
    X, Z, Y, JQ, JT = 0, 1, 2, 3, 4
    rq = np.full(124, JQ, np.uint8)
    rq[0:28] = X
    rq[28:56] = Z
    rq[84:124] = Y
    rt = np.full(260, JT, np.uint8)
    rt[0:28] = X
    rt[28:68] = Y
    rt[232:260] = Z
    q = rq[::-1].copy()
    t = rt[::-1].copy()
    mat = np.full((12, 12), -4, np.int32)
    mat[X, X] = 11
    mat[Z, Z] = 11
    mat[Y, Y] = 4
    sp = ScoringParams(gap_open=0, gap_extend=-1, matrix=mat)
    return q, t, sp


def test_oracle_class_b_tie_is_as_constructed():
    q, t, sp = _tie_problem_b()
    o = align_oracle(q, t, sp, mode="local")
    assert (o.score, o.query_start, o.query_end, o.target_start, o.target_end) == (
        412, 68, 124, 0, 260
    )
    assert o.cigar == "28M204D28M"


@pytest.mark.parametrize("traceback", [True, False])
def test_engine_returns_canonical_class_b_tie(traceback):
    q, t, sp = _tie_problem_b()
    r = _run(q, t, sp, traceback)
    assert r.score == 412
    assert (r.query_end, r.target_end) == (124, 260)
    assert (r.query_start, r.target_start) == (68, 0)
    if traceback:
        assert r.cigar == "28M204D28M"


def test_engine_canonical_class_b_tie_on_a_mesh():
    from seqalib.parallel.dist import make_pair_mesh

    q, t, sp = _tie_problem_b()
    assert _run(q, t, sp, mesh=make_pair_mesh()) == align_oracle(
        q, t, sp, mode="local"
    )


def test_engine_canonical_class_b_tie_transposed():
    """Query and target swapped: the oracle's canonical start moves, and
    the engine follows it."""
    q, t, sp = _tie_problem_b()
    assert _run(t, q, sp) == align_oracle(t, q, sp, mode="local")
