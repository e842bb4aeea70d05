"""align_all_vs_all (config 5 surface) vs the oracle, including the
chunked product streaming and the sharded mesh path."""

import numpy as np

import seqalib as sa
from seqalib.oracle import sw_linear
from seqalib.types import ScoringParams

SP = ScoringParams(match=2, mismatch=-3, gap_open=0, gap_extend=-2)


def _mk(rng, n_reads=4, n_refs=3):
    reads = [
        rng.integers(0, 4, int(rng.integers(20, 40))).astype(np.uint8)
        for _ in range(n_reads)
    ]
    refs = [
        rng.integers(0, 4, int(rng.integers(40, 80))).astype(np.uint8)
        for _ in range(n_refs)
    ]
    return reads, refs


def _assert_matches(out, reads, refs):
    for i, q in enumerate(reads):
        for j, t in enumerate(refs):
            ref = sw_linear(q, t, SP)
            got = (
                out["score"][i, j],
                out["qs"][i, j],
                out["qe"][i, j],
                out["ts"][i, j],
                out["te"][i, j],
            )
            want = (
                ref.score,
                ref.query_start,
                ref.query_end,
                ref.target_start,
                ref.target_end,
            )
            assert got == want, (i, j, got, want)


def test_all_vs_all_chunked(rng):
    reads, refs = _mk(rng)
    out = sa.align_all_vs_all(reads, refs, scoring=SP, chunk_pairs=5)
    assert out["score"].shape == (4, 3)
    _assert_matches(out, reads, refs)


def test_all_vs_all_sharded(rng):
    from seqalib.parallel.dist import make_pair_mesh

    reads, refs = _mk(rng)
    out = sa.align_all_vs_all(
        reads, refs, scoring=SP, backend="xla", mesh=make_pair_mesh()
    )
    _assert_matches(out, reads, refs)


def test_all_vs_all_resume(rng, tmp_path, monkeypatch):
    """Chunk-shard checkpoint/resume (SURVEY.md §5): a rerun with the same
    inputs loads finished shards and never realigns them."""
    sp = ScoringParams(match=2, mismatch=-3, gap_open=0, gap_extend=-2)
    reads = [rng.integers(0, 4, 24).astype(np.uint8) for _ in range(5)]
    refs = [rng.integers(0, 4, 40).astype(np.uint8) for _ in range(3)]
    d = str(tmp_path / "shards")
    base = sa.align_all_vs_all(reads, refs, scoring=sp, backend="xla",
                               chunk_pairs=4)
    first = sa.align_all_vs_all(reads, refs, scoring=sp, backend="xla",
                                chunk_pairs=4, resume_dir=d)
    for f in base:
        assert np.array_equal(base[f], first[f])

    import seqalib.api as api

    def boom(*a, **k):
        raise AssertionError("resume must not realign finished chunks")

    monkeypatch.setattr(api, "align_batch", boom)
    second = sa.align_all_vs_all(reads, refs, scoring=sp, backend="xla",
                                 chunk_pairs=4, resume_dir=d)
    for f in base:
        assert np.array_equal(base[f], second[f])


def test_all_vs_all_resume_invalidates_on_scoring_change(rng, tmp_path):
    """Review regression: a resume_dir reused with different scoring (or
    mode) must recompute, not silently return the old run's results."""
    reads = [rng.integers(0, 4, 18).astype(np.uint8) for _ in range(3)]
    refs = [rng.integers(0, 4, 24).astype(np.uint8) for _ in range(2)]
    d = str(tmp_path / "shards")
    sp1 = ScoringParams(match=2, mismatch=-3, gap_open=0, gap_extend=-2)
    sp2 = ScoringParams(match=9, mismatch=-1, gap_open=0, gap_extend=-1)
    sa.align_all_vs_all(reads, refs, scoring=sp1, backend="xla",
                        chunk_pairs=2, resume_dir=d)
    got = sa.align_all_vs_all(reads, refs, scoring=sp2, backend="xla",
                              chunk_pairs=2, resume_dir=d)
    fresh = sa.align_all_vs_all(reads, refs, scoring=sp2, backend="xla",
                                chunk_pairs=2)
    for f in fresh:
        assert np.array_equal(got[f], fresh[f])
