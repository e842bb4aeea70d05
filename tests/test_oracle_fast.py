"""oracle_fast must be BIT-IDENTICAL to the scalar oracle.

The vectorized fills exist only so host-side parity gates run in seconds;
any divergence from oracle.py would silently corrupt the gates, so this
suite compares full fill outputs (H, PH, EXT_E, EXT_F) and end-to-end
results across randomized and adversarial cases.
"""

import numpy as np
import pytest

from seqalib import oracle, oracle_fast
from seqalib.types import ScoringParams

DNA_LIN = ScoringParams(match=2, mismatch=-3, gap_open=0, gap_extend=-2)
DNA_AFF = ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
BL62 = ScoringParams.blosum62()


def _rand_pair(rng, alpha, max_len=90):
    n = int(rng.integers(0, max_len))
    m = int(rng.integers(0, max_len))
    return (
        rng.integers(0, alpha, n).astype(np.int32),
        rng.integers(0, alpha, m).astype(np.int32),
    )


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize(
    "sp,alpha",
    [(DNA_LIN, 4), (DNA_AFF, 4), (BL62, 20)],
    ids=["dna-linear", "dna-affine", "blosum62"],
)
def test_fill_and_results_equal(seed, sp, alpha):
    rng = np.random.default_rng(seed)
    for _ in range(4):
        q, t = _rand_pair(rng, alpha)
        if sp.is_affine:
            ref = oracle._gotoh_fill(q, t, sp, local=False)
            got = oracle_fast._gotoh_fill(q, t, sp, local=False)
            for a, b in zip(ref, got):
                assert np.array_equal(a, b)
            ref = oracle._gotoh_fill(q, t, sp, local=True)
            got = oracle_fast._gotoh_fill(q, t, sp, local=True)
            for a, b in zip(ref, got):
                assert np.array_equal(a, b)
        for mode in ("global", "local"):
            if mode == "local" and not sp.is_affine:
                r = oracle.sw_linear(q, t, sp)
                f = oracle_fast.sw_linear(q, t, sp)
            else:
                r = oracle.align_oracle(q, t, sp, mode=mode)
                f = oracle_fast.align_oracle(q, t, sp, mode=mode)
            assert r == f, (mode, r, f)


@pytest.mark.parametrize("band", [1, 3, 8, 64])
def test_banded_fill_equal(band):
    rng = np.random.default_rng(band)
    for _ in range(3):
        q, t = _rand_pair(rng, 4, max_len=60)
        ref = oracle._gotoh_fill(q, t, DNA_AFF, local=False, band=band)
        got = oracle_fast._gotoh_fill(q, t, DNA_AFF, local=False, band=band)
        for a, b in zip(ref, got):
            assert np.array_equal(a, b)
        r = oracle.align_oracle(q, t, DNA_AFF, mode="global", band=band)
        f = oracle_fast.align_oracle(q, t, DNA_AFF, mode="global", band=band)
        assert r == f


def test_adversarial_cases():
    for q, t in [
        (np.zeros(0, np.int32), np.zeros(0, np.int32)),
        (np.zeros(0, np.int32), np.array([1, 2], np.int32)),
        (np.array([1], np.int32), np.zeros(0, np.int32)),
        (np.array([3] * 40, np.int32), np.array([3] * 40, np.int32)),
        (np.array([0] * 30, np.int32), np.array([1] * 30, np.int32)),
    ]:
        for sp in (DNA_LIN, DNA_AFF):
            for mode in ("global", "local"):
                r = oracle.align_oracle(q, t, sp, mode=mode)
                f = oracle_fast.align_oracle(q, t, sp, mode=mode)
                assert r == f, (mode, sp, r, f)


def test_fill_equal_at_gate_scale():
    """One moderate-size case (~400bp): the CLI parity gate trusts
    oracle_fast at kb scale, so check equality well beyond the small
    randomized sweep above (scalar oracle cost caps the size here)."""
    rng = np.random.default_rng(42)
    q = rng.integers(0, 20, 380).astype(np.int32)
    t = rng.integers(0, 20, 420).astype(np.int32)
    r = oracle.sw_affine(q, t, BL62)
    f = oracle_fast.sw_affine(q, t, BL62)
    assert r == f
    r2 = oracle.nw_affine(q, t, BL62)
    f2 = oracle_fast.nw_affine(q, t, BL62)
    assert r2 == f2
