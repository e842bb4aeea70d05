"""The device engine (ops.wavefront_xla through parallel.dispatch) vs the
oracle: score, coordinates and CIGAR, field for field.  The input grids
are those that pinned the removed strip, fused and per-backend engines:
the same pairs now pin the one engine that replaced them."""

import numpy as np
import pytest

from conftest import check_parity, fields, reference
from seqalib.parallel.dispatch import run_bucket
from seqalib.types import ScoringParams, encode_dna

DNA_AFF = ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
DNA_LIN = ScoringParams(match=2, mismatch=-3, gap_open=0, gap_extend=-2)
BLOS = ScoringParams.blosum62(gap_open=-10, gap_extend=-1)
AFF = ScoringParams.affine(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)


def _batch(rng, sp, B, n, m):
    alpha = 4 if sp.matrix is None else 20
    qs = [rng.integers(0, alpha, n).astype(np.uint8) for _ in range(B)]
    ts = [rng.integers(0, alpha, m).astype(np.uint8) for _ in range(B)]
    return qs, ts


# ---- local coordinates (score + start/end) --------------------------------


@pytest.mark.parametrize(
    "sp,B,n,m",
    [
        (DNA_AFF, 4, 100, 120),
        (DNA_AFF, 2, 300, 260),  # several 128-row and -column blocks
        (DNA_LIN, 4, 100, 120),
        (BLOS, 2, 150, 140),
        (DNA_AFF, 1, 10, 10),
        (BLOS, 1, 129, 257),  # just past 128-multiple boundaries
    ],
)
def test_local_coords_parity(rng, sp, B, n, m):
    qs, ts = _batch(rng, sp, B, n, m)
    check_parity(qs, ts, sp, "local", traceback=False)


def test_local_coords_ragged_lengths(rng):
    qs, ts = _batch(rng, DNA_AFF, 3, 90, 110)
    qs = [q[:k] for q, k in zip(qs, (90, 40, 64))]
    ts = [t[:k] for t, k in zip(ts, (110, 50, 20))]
    check_parity(qs, ts, DNA_AFF, "local", traceback=False)


# ---- local full CIGAR ------------------------------------------------------


@pytest.mark.parametrize(
    "sp,B,n,m",
    [
        (DNA_AFF, 3, 100, 120),
        (DNA_LIN, 3, 100, 120),
        (BLOS, 2, 150, 140),
        (DNA_AFF, 2, 300, 260),
    ],
)
def test_local_traceback_parity(rng, sp, B, n, m):
    qs, ts = _batch(rng, sp, B, n, m)
    check_parity(qs, ts, sp, "local")


# ---- global ----------------------------------------------------------------


@pytest.mark.parametrize(
    "sp,B,n,m,traceback",
    [
        (DNA_AFF, 3, 60, 70, True),
        (DNA_LIN, 3, 60, 70, True),
        (BLOS, 2, 100, 90, True),
        (DNA_AFF, 2, 256, 256, True),  # config-1 shape
        (DNA_AFF, 2, 200, 180, False),
    ],
)
def test_global_parity(rng, sp, B, n, m, traceback):
    qs, ts = _batch(rng, sp, B, n, m)
    check_parity(qs, ts, sp, "global", traceback=traceback)


@pytest.mark.parametrize("traceback", [True, False])
def test_global_rows_padded_past_final_row(rng, traceback):
    """A bucket padded far past the true lengths (512 rows for a 300-row
    pair): the score is captured at the pair's own final cell."""
    B, n, m = 2, 300, 280
    q = np.zeros((B, 512), np.int32)
    t = np.zeros((B, 512), np.int32)
    q[:, :n] = rng.integers(0, 4, (B, n))
    t[:, :m] = rng.integers(0, 4, (B, m))
    lens_q = np.full(B, n, np.int32)
    lens_t = np.full(B, m, np.int32)
    out = run_bucket(q, t, lens_q, lens_t, DNA_AFF, "global", None, traceback)
    from seqalib.parallel.dispatch import _decode_ops_rev

    for b in range(B):
        ref = reference(q[b, :n], t[b, :m], DNA_AFF, "global")
        assert out["score"][b] == ref.score, b
        if traceback:
            assert _decode_ops_rev(out["ops_rev"][b]) == ref.cigar, b


def test_global_degenerate_lengths(rng):
    q = rng.integers(0, 4, 50).astype(np.uint8)
    t = rng.integers(0, 4, 60).astype(np.uint8)
    check_parity([q, q[:30], q[:0]], [t, t[:35], t[:20]], DNA_AFF, "global")


def test_local_all_mismatch_is_empty():
    """Disjoint alphabets: score 0, zero coordinates, empty CIGAR."""
    got = check_parity(
        [np.zeros(40, np.uint8)], [np.ones(40, np.uint8)], DNA_AFF, "local"
    )
    assert fields(got[0]) == (0, 0, 0, 0, 0, "")


def test_local_long_insertion(rng):
    """A local alignment whose path carries a 100-letter insertion: the
    start lies far off the end's diagonal."""
    n = 160
    q = rng.integers(0, 4, n).astype(np.uint8)
    ins = rng.integers(0, 4, 100).astype(np.uint8)
    t = np.concatenate([q[:80], ins, q[80:]])
    sp = ScoringParams(match=4, mismatch=-3, gap_open=-5, gap_extend=-1)
    check_parity([q], [t], sp, "local")


# ---- the on-card smoke shapes ----------------------------------------------


def _mutated(rng, n, k, alpha=4):
    q = rng.integers(0, alpha, n).astype(np.uint8)
    t = q.copy()
    idx = rng.choice(n, k, replace=False)
    t[idx] = (t[idx] + 1 + rng.integers(0, alpha - 1, k)) % alpha
    return q, t


@pytest.mark.parametrize(
    "case",
    [
        "local_blosum_coords",
        "local_dna_linear_coords",
        "local_affine_traceback",
        "global_affine_traceback",
        "self_alignment_200",
        "banded_traceback_512",
        "banded_blosum_traceback_256",
        "banded_relay_300",
    ],
)
def test_smoke_shapes(rng, case):
    if case == "local_blosum_coords":
        qs, ts = _batch(rng, BLOS, 8, 150, 140)
        check_parity(qs, ts, BLOS, "local", traceback=False)
    elif case == "local_dna_linear_coords":
        qs, ts = _batch(rng, DNA_LIN, 8, 100, 120)
        check_parity(qs, ts, DNA_LIN, "local", traceback=False)
    elif case == "local_affine_traceback":
        qs, ts = _batch(rng, DNA_AFF, 8, 150, 170)
        check_parity(qs, ts, DNA_AFF, "local")
    elif case == "global_affine_traceback":
        qs, ts = _batch(rng, DNA_AFF, 8, 128, 128)
        check_parity(qs, ts, DNA_AFF, "global")
    elif case == "self_alignment_200":
        base = rng.integers(0, 4, 200).astype(np.uint8)
        check_parity([base] * 8, [base] * 8, DNA_AFF, "local", traceback=False)
    elif case == "banded_traceback_512":
        pairs = [_mutated(rng, 512, 10) for _ in range(2)]
        check_parity(*zip(*pairs), DNA_AFF, "global", band=64)
    elif case == "banded_blosum_traceback_256":
        pairs = [_mutated(rng, 256, 12, alpha=20) for _ in range(2)]
        check_parity(*zip(*pairs), BLOS, "global", band=32)
    else:
        q = np.random.default_rng(23).integers(0, 4, 300).astype(np.uint8)
        t = q.copy()
        t[::13] = (t[::13] + 1) % 4
        check_parity([q], [t], DNA_AFF, "global", band=16)


# ---- small random and adversarial pairs -------------------------------------


def _rand_pairs(rng, n_pairs, lo, hi, alpha=4):
    qs = [rng.integers(0, alpha, int(rng.integers(lo, hi + 1))).astype(np.uint8)
          for _ in range(n_pairs)]
    ts = [rng.integers(0, alpha, int(rng.integers(lo, hi + 1))).astype(np.uint8)
          for _ in range(n_pairs)]
    return qs, ts


LIN = ScoringParams.linear(match=2, mismatch=-3, gap=-2)


@pytest.mark.parametrize(
    "mode,sp", [("global", LIN), ("local", LIN), ("global", AFF), ("local", AFF)]
)
def test_small_random_parity(rng, mode, sp):
    qs, ts = _rand_pairs(rng, 6, 1, 36)
    check_parity(qs, ts, sp, mode)


@pytest.mark.parametrize("mode", ["global", "local"])
def test_small_blosum62_parity(rng, mode):
    qs, ts = _rand_pairs(rng, 5, 5, 40, alpha=20)
    check_parity(qs, ts, BLOS, mode)


def test_small_banded_with_indel(rng):
    q = rng.integers(0, 4, size=48).astype(np.uint8)
    t = np.concatenate([q[:20], rng.integers(0, 4, 6).astype(np.uint8), q[24:]])
    for w in (3, 16):
        check_parity([q], [t], AFF, "global", band=w)


def test_small_adversarial_shapes():
    cases = [("A", "A"), ("A", "G"), ("A", "GGGGGGGG"), ("AAAAAAAA", "CCCCCCCC"),
             ("ACGT" * 4, "TGCA"), ("A" * 16, "A" * 17)]
    qs = [encode_dna(a) for a, _ in cases]
    ts = [encode_dna(b) for _, b in cases]
    for mode in ("global", "local"):
        check_parity(qs, ts, LIN, mode)
        check_parity(qs, ts, AFF, mode)


def test_coords_without_traceback_match_traceback(rng):
    from seqalib.parallel.dispatch import dispatch_batch

    qs, ts = _rand_pairs(rng, 6, 4, 32)
    with_tb = dispatch_batch(qs, ts, AFF, mode="local")
    no_tb = dispatch_batch(qs, ts, AFF, mode="local", traceback=False)
    for a, b in zip(with_tb, no_tb):
        assert fields(a, False) == fields(b, False)


# ---- batch invariance: a pair's result does not depend on its batch ---------


@pytest.mark.parametrize(
    "protein,B,L",
    [
        (True, 160, 72),
        (True, 256, 72),
        (False, 160, 72),
        (False, 256, 72),
        (True, 160, 328),
    ],
)
def test_batch_equals_its_halves(protein, B, L):
    rng = np.random.default_rng(7)
    sp = BLOS if protein else DNA_AFF
    alpha = 20 if protein else 4
    q = rng.integers(0, alpha, (B, L)).astype(np.int32)
    t = rng.integers(0, alpha, (B, L)).astype(np.int32)
    lens = np.full(B, L, np.int32)
    big = run_bucket(q, t, lens, lens, sp, "local", None, False)
    H = B // 2
    halves = [
        run_bucket(q[lo : lo + H], t[lo : lo + H], lens[:H], lens[:H], sp,
                   "local", None, False)
        for lo in (0, H)
    ]
    for k in ("score", "qs", "qe", "ts", "te"):
        np.testing.assert_array_equal(
            big[k], np.concatenate([h[k] for h in halves]), err_msg=k
        )
    assert (big["score"] > 0).any()


@pytest.mark.parametrize(
    "protein,B,L",
    [
        (True, 1, 96),
        (True, 8, 96),
        (True, 32, 96),
        (True, 8, 200),
        (True, 8, 328),  # a width that is no power of two
        (True, 2, 200),
        (True, 4, 200),
        (False, 2, 200),
        (False, 4, 200),
        (False, 8, 200),
        (True, 4, 328),
        (False, 4, 328),
    ],
)
def test_local_coords_square_buckets(protein, B, L):
    rng = np.random.default_rng(11 + B + L)
    sp = BLOS if protein else DNA_AFF
    qs, ts = _batch(rng, sp, B, L, L)
    check_parity(qs[:4], ts[:4], sp, "local", traceback=False)
    if B > 4:  # the rest of the bucket rides along unchecked
        from seqalib.parallel.dispatch import dispatch_batch

        got = dispatch_batch(qs, ts, sp, mode="local", traceback=False)
        head = dispatch_batch(qs[:4], ts[:4], sp, mode="local", traceback=False)
        assert got[:4] == head


# ---- traceback shapes the device walk must handle ---------------------------


def test_global_traceback_ragged_and_empty(rng):
    """Ragged lengths over several blocks, with an empty query and an
    empty target in the batch."""
    qs = [rng.integers(0, 20, int(n)).astype(np.uint8)
          for n in rng.integers(1, 151, 8)]
    ts = [rng.integers(0, 20, int(n)).astype(np.uint8)
          for n in rng.integers(1, 181, 8)]
    qs[0] = qs[0][:0]
    ts[2] = ts[2][:0]
    check_parity(qs, ts, BLOS, "global")


@pytest.mark.parametrize("sp", [DNA_AFF, DNA_LIN])
def test_local_traceback_planted_region(sp):
    """A planted similar region makes the local windows span several
    128-letter blocks; two pairs are shortened."""
    rng = np.random.default_rng(9)
    qs, ts = [], []
    for b in range(8):
        q = rng.integers(0, 4, 300).astype(np.uint8)
        t = rng.integers(0, 4, 260).astype(np.uint8)
        t[50:150] = q[100:200]
        qs.append(q[:140] if b == 3 else q)
        ts.append(t[:90] if b == 4 else t)
    check_parity(qs, ts, sp, "local")


@pytest.mark.parametrize("protein", [False, True])
def test_local_traceback_homologous(protein):
    rng = np.random.default_rng(13)
    sp = BLOS if protein else DNA_AFF
    alpha = 20 if protein else 4
    pairs = [_mutated(rng, 180, 12, alpha) for _ in range(4)]
    check_parity(*zip(*pairs), sp, "local")


def test_global_traceback_large_batch(rng):
    """More pairs than one 128-row block of the old engines."""
    qs, ts = _rand_pairs(rng, 140, 20, 40)
    check_parity(qs, ts, DNA_AFF, "global")
