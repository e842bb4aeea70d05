"""Banded global alignment (config 4) on the device engine vs the oracle's
banded Gotoh recurrence (SURVEY.md §2.2-4): out-of-band cells are masked
to -inf inside the full-matrix fill.  The (qlens, tlens, band) grids are
those that pinned the removed O(n*w) banded engine and its sequence-
parallel relay."""

import numpy as np
import pytest

from conftest import check_parity, reference
from seqalib.parallel import dispatch
from seqalib.types import ScoringParams

SP = ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
BLOS = ScoringParams.blosum62()


def _random_pairs(rng, qlens, tlens, alpha=4):
    qs = [rng.integers(0, alpha, n).astype(np.uint8) for n in qlens]
    ts = [rng.integers(0, alpha, m).astype(np.uint8) for m in tlens]
    return qs, ts


def _mutated(rng, n, k, alpha=4):
    q = rng.integers(0, alpha, n).astype(np.uint8)
    t = q.copy()
    idx = rng.choice(n, k, replace=False)
    t[idx] = (t[idx] + 1 + rng.integers(0, alpha - 1, k)) % alpha
    return q, t


@pytest.mark.parametrize(
    "qlens,tlens,band",
    [
        ([64, 64], [64, 64], 12),  # square, delta 0
        ([50, 40, 30], [54, 44, 34], 6),  # mixed lengths, uniform delta
        ([40], [30], 8),  # negative delta (target shorter)
        ([33], [47], 16),  # band wider than needed
        ([17], [19], 3),  # tiny
        ([200, 180], [190, 200], 20),  # several 128-letter blocks
        ([150], [150], 63),
        ([150], [150], 64),
        ([150], [150], 7),
    ],
)
def test_banded_parity(rng, qlens, tlens, band):
    qs, ts = _random_pairs(rng, qlens, tlens)
    check_parity(qs, ts, SP, "global", band=band)


def test_banded_mutated_copy(rng):
    """Realistic long-read case: target = query with SNPs + indels."""
    q, t = _mutated(rng, 192, 16)
    t = np.insert(np.delete(t, [50, 51, 52]), 120, [0, 1]).astype(np.uint8)
    check_parity([q], [t], SP, "global", band=10)


@pytest.mark.parametrize("alpha,sp", [(4, SP), (20, BLOS)])
def test_banded_score_only(rng, alpha, sp):
    qs, ts = _random_pairs(rng, [48, 64], [52, 70], alpha)
    check_parity(qs, ts, sp, "global", band=12, traceback=False)


def test_banded_wide_band_equals_unbanded(rng):
    """banded(w >= max(n, m)) == the full matrix (SURVEY.md §4.3)."""
    qs, ts = _random_pairs(rng, [40], [44])
    got = check_parity(qs, ts, SP, "global", band=64)
    assert got[0] == reference(qs[0], ts[0], SP, "global")


def test_banded_mixed_delta_batch(rng):
    """One launch covering pairs with different tlen - qlen: each pair
    keeps its own band."""
    lens = [(60, 60), (50, 64), (64, 48), (40, 40)]
    qs, ts = _random_pairs(rng, [a for a, _ in lens], [b for _, b in lens])
    check_parity(qs, ts, SP, "global", band=8)


@pytest.mark.parametrize(
    "qlens,tlens,band",
    [
        ([48, 48], [48, 48], 10),  # square protein bucket
        ([40, 56], [44, 50], 8),  # mixed lengths + deltas
        ([17], [19], 4),  # tiny
        ([90, 70], [84, 77], 10),
    ],
)
def test_banded_blosum62_parity(rng, qlens, tlens, band):
    qs, ts = _random_pairs(rng, qlens, tlens, alpha=20)
    check_parity(qs, ts, BLOS, "global", band=band)


def test_banded_wide_range_matrix(rng):
    """A substitution table with scores of +-20 (outside any packed
    range): the engine takes it like any other table."""
    wide = np.full((4, 4), -20, np.int32)
    np.fill_diagonal(wide, 20)
    sp = ScoringParams(gap_open=-5, gap_extend=-2, matrix=wide)
    qs, ts = _random_pairs(rng, [16, 30], [16, 26])
    check_parity(qs, ts, sp, "global", band=4)


def test_banded_blosum62_through_align_batch(rng):
    from seqalib.api import align_batch

    q = rng.integers(0, 20, 200).astype(np.uint8)
    t = rng.integers(0, 20, 210).astype(np.uint8)
    got = align_batch([q], [t], scoring=BLOS, mode="global", band=32)[0]
    assert got == reference(q, t, BLOS, "global", band=32)


def test_banded_split_launches_match_one_launch(rng, monkeypatch):
    """A pointer-stash budget of one pair per launch splits the bucket;
    results are identical to the single launch, in order."""
    qs, ts = _random_pairs(rng, [48] * 5, [52] * 5)
    full = dispatch.dispatch_batch(qs, ts, SP, mode="global", band=8)
    monkeypatch.setattr(
        dispatch, "stash_budget",
        lambda: dispatch.stash_bytes_per_pair(64, 64),
    )
    split = dispatch.dispatch_batch(qs, ts, SP, mode="global", band=8)
    assert split == full


# ---- long pairs (the relay's grid) ------------------------------------------


@pytest.mark.parametrize(
    "qlens,tlens,band",
    [
        ([257], [251], 16),  # blocks shorter than the band
        ([1000], [970], 24),  # uneven lengths
        ([512], [600], 32),  # asymmetric delta
        ([300, 280, 311], [300, 301, 280], 20),  # batch of mixed deltas
        ([64] * 9, [64] * 9, 8),  # more pairs than devices
    ],
)
def test_banded_long_parity(rng, qlens, tlens, band):
    qs, ts = [], []
    for n, m in zip(qlens, tlens):
        q, t = _mutated(rng, max(n, m), max(n, m) // 20)
        qs.append(q[:n])
        ts.append(t[:m])
    check_parity(qs, ts, SP, "global", band=band)


def test_banded_long_mutated_with_indels(rng):
    q, t = _mutated(rng, 900, 40)
    t = np.delete(t, np.arange(300, 306))
    t = np.insert(t, 600, rng.integers(0, 4, 4)).astype(np.uint8)
    check_parity([q], [t], SP, "global", band=24)


def test_banded_empty_and_tiny():
    one = np.array([1], np.uint8)
    check_parity([one, one[:0]], [one, np.array([2, 3], np.uint8)], SP,
                 "global", band=4)


def test_banded_cross_scoring_batch(rng):
    """BLOSUM62 and DNA scoring on the same lengths: one program per
    table, both exact."""
    qs, ts = _random_pairs(rng, [120, 100], [110, 104], alpha=20)
    check_parity(qs, ts, BLOS, "global", band=16)
    qs, ts = _random_pairs(rng, [120, 100], [110, 104])
    check_parity(qs, ts, SP, "global", band=16)
