"""Property tests promised by SURVEY.md §4.2-4.3: banded(w >= n+m) ==
unbanded; affine(gap_open=0) == linear; int32 score headroom at long
lengths; canonical starts of tall local alignments.
"""

import numpy as np
import pytest

from seqalib.api import align_batch
from seqalib.oracle import align_oracle, nw_affine, sw_affine, sw_linear
from seqalib.types import ScoringParams

AFF = ScoringParams.affine(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)


def _rand(rng, n, alpha=4):
    return rng.integers(0, alpha, size=n).astype(np.uint8)


def test_banded_wide_band_equals_full(rng):
    """A band wider than n+m can exclude nothing: banded == unbanded,
    score and CIGAR, oracle and xla backend."""
    for _ in range(4):
        q = _rand(rng, int(rng.integers(10, 40)))
        t = _rand(rng, int(rng.integers(10, 40)))
        w = len(q) + len(t)
        full_o = nw_affine(q, t, AFF)
        band_o = nw_affine(q, t, AFF, band=w)
        assert (full_o.score, full_o.cigar) == (band_o.score, band_o.cigar)
        got = align_batch([q], [t], scoring=AFF, mode="global", band=w,
                          backend="xla")[0]
        assert (got.score, got.cigar) == (full_o.score, full_o.cigar)


def test_affine_zero_open_equals_linear_score(rng):
    """gap_open=0 degrades Gotoh to the linear recurrence: scores equal."""
    sp_aff = ScoringParams(match=2, mismatch=-3, gap_open=0, gap_extend=-2)
    for mode in ("global", "local"):
        qs = [_rand(rng, int(rng.integers(5, 40))) for _ in range(6)]
        ts = [_rand(rng, int(rng.integers(5, 40))) for _ in range(6)]
        # oracle dispatches gap_open == 0 to the linear recurrence; force
        # the affine fill via the backend kernels and compare scores
        from seqalib.ops.wavefront_xla import wavefront_bucket
        from seqalib.parallel.dispatch import sentinel_table
        import jax.numpy as jnp

        L = max(max(len(q) for q in qs), max(len(t) for t in ts))
        qb = np.zeros((len(qs), L), np.int32)
        tb = np.zeros((len(ts), L), np.int32)
        for i, (q, t) in enumerate(zip(qs, ts)):
            qb[i, : len(q)] = q
            tb[i, : len(t)] = t
        qlen = np.array([len(q) for q in qs], np.int32)
        tlen = np.array([len(t) for t in ts], np.int32)
        table = jnp.asarray(sentinel_table(sp_aff))
        aff = wavefront_bucket(
            jnp.asarray(qb), jnp.asarray(tb), jnp.asarray(qlen),
            jnp.asarray(tlen), table, mode=mode, gap_open=0, gap_extend=-2,
            band=None, affine=True, want_tb=False,
        )
        lin = wavefront_bucket(
            jnp.asarray(qb), jnp.asarray(tb), jnp.asarray(qlen),
            jnp.asarray(tlen), table, mode=mode, gap_open=0, gap_extend=-2,
            band=None, affine=False, want_tb=False,
        )
        assert np.array_equal(np.asarray(aff["score"]), np.asarray(lin["score"]))


def test_score_range_headroom_long_pair(rng):
    """The engine's int32 state: -inf (NEG_INF) stays below any reachable
    score by a wide margin at 100 kb, and a 2 kb global pair scores as
    the oracle does."""
    from seqalib.oracle_fast import nw_affine as nw_fast
    from seqalib.types import BLOSUM62, NEG_INF

    worst = 4 + 2 * 100_000 * int(np.abs(BLOSUM62).max())
    assert worst < abs(NEG_INF) // 2
    q = rng.integers(0, 4, 2000).astype(np.uint8)
    t = rng.integers(0, 4, 1900).astype(np.uint8)
    got = align_batch([q], [t], scoring=AFF, mode="global", traceback=False)
    assert got[0].score == nw_fast(q, t, AFF).score


def test_tall_local_alignment(rng):
    """A local alignment spanning 200 rows (self-alignment with one
    mismatch) keeps canonical coordinates."""
    sp = ScoringParams.affine(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    base = rng.integers(0, 4, 200).astype(np.uint8)
    t = base.copy()
    t[50] = (t[50] + 1) % 4
    got = align_batch([base, base], [t, base], scoring=sp, mode="local",
                      traceback=False)
    for g, tt in zip(got, (t, base)):
        ref = sw_affine(base, tt, sp)
        assert (g.score, g.query_start, g.query_end, g.target_start,
                g.target_end) == (ref.score, ref.query_start, ref.query_end,
                                  ref.target_start, ref.target_end)
        assert g.query_end - g.query_start > 128


def test_local_coords_are_reverse_canonical(rng):
    """The canonical start maximizes (qs, ts) among optimal starts: build a
    tie case with two optimal hits of the same end-anchored score."""
    sp = ScoringParams.linear(match=2, mismatch=-3, gap=-2)
    # q = AC, t = ACxxAC: end tie-break picks the FIRST end (te=2);
    # the start of that alignment is (0, 0) — degenerate but explicit.
    from seqalib.types import encode_dna

    q = encode_dna("AC")
    t = encode_dna("ACGGAC")
    r = sw_linear(q, t, sp)
    assert (r.query_start, r.query_end, r.target_start, r.target_end) == (
        0, 2, 0, 2,
    )
    got = align_batch([q], [t], scoring=sp, mode="local", backend="xla")[0]
    assert str(got) == str(r)


def test_mutated_self_alignments_exact(rng):
    """384-letter self-alignments with a few substitutions each: the
    start recovered by the reverse extension equals the oracle's."""
    from seqalib.oracle_fast import sw_affine as sw_fast

    sp = ScoringParams.affine(match=2, mismatch=-3, gap_open=-4, gap_extend=-1)
    base = rng.integers(0, 4, 384).astype(np.uint8)
    ts = []
    for _ in range(8):
        t = base.copy()
        idx = rng.choice(384, 6, replace=False)
        t[idx] = (t[idx] + 1) % 4
        ts.append(t)
    got = align_batch([base] * 8, ts, scoring=sp, mode="local")
    for g, t in zip(got, ts):
        assert g == sw_fast(base, t, sp)


def test_banded_local_raises_uniformly():
    """band= with mode="local" is out of contract; every backend raises
    the same API-level ValueError."""
    import pytest

    from seqalib import align, align_batch
    from seqalib.types import ScoringParams

    sp = ScoringParams.affine()
    q = np.array([0, 1, 2, 3], np.uint8)
    t = np.array([0, 1, 1, 3], np.uint8)
    for backend in ("oracle", "xla"):
        with pytest.raises(ValueError, match="banded local"):
            align(q, t, sp, mode="local", band=4, backend=backend)
        with pytest.raises(ValueError, match="banded local"):
            align_batch([q], [t], sp, mode="local", band=4, backend=backend)
