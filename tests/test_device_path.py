"""The device path's contract outside the alignment numbers: the backends
it accepts, the traceback pointer-stash guard, where the compile cache
goes, that the package holds nothing TPU-only, that its programs lower for
CUDA, and that the in-jit traceback walk equals a plain walk."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import seqalib
from seqalib.parallel import dispatch
from seqalib.types import AlignConfig, ScoringParams

ROOT = pathlib.Path(__file__).resolve().parent.parent
SP = ScoringParams.affine()
Q = np.array([0, 1, 2, 3, 1], np.uint8)
T = np.array([0, 1, 3, 1], np.uint8)


# ---- backends ----------------------------------------------------------------


@pytest.mark.parametrize(
    "call",
    [
        lambda b: seqalib.align(Q, T, SP, backend=b),
        lambda b: seqalib.align_batch([Q], [T], SP, backend=b),
        lambda b: seqalib.align_all_vs_all([Q], [T], scoring=SP, backend=b),
        lambda b: AlignConfig(backend=b),
    ],
    ids=["align", "align_batch", "align_all_vs_all", "AlignConfig"],
)
def test_removed_backend_raises_listing_valid_ones(call):
    with pytest.raises(ValueError, match=r"'pallas'.*'oracle', 'xla'"):
        call("pallas")


def test_default_backend_is_the_device_engine():
    assert AlignConfig().backend == "xla"
    got = seqalib.align_batch([Q], [T], SP, mode="local")[0]
    assert got == seqalib.align(Q, T, SP, mode="local", backend="oracle")


# ---- the pointer-stash guard -------------------------------------------------


@pytest.mark.parametrize(
    "B,ndev,cap_pairs,want",
    [
        (16, 1, 16, 16),  # fits: one launch
        (16, 1, 5, 4),  # 4 launches of 4 rows, not 5+5+5+1
        (64, 8, 3, 24),  # 8 rows per device -> 3 launches of 3 per device
        (8, 8, 1, 8),  # one pair per device fits exactly
        (3, 1, 1, 1),
    ],
)
def test_launch_rows(B, ndev, cap_pairs, want):
    per_pair = dispatch.stash_bytes_per_pair(128, 256)
    rows = dispatch.launch_rows(B, 128, 256, ndev, cap_pairs * per_pair)
    assert rows == want
    assert rows % ndev == 0 and rows // ndev <= cap_pairs


def test_one_pair_over_budget_raises():
    with pytest.raises(ValueError, match="traceback pointers"):
        # a 100 kb pair against a quarter of an 80 GB card's 60 GB limit
        dispatch.launch_rows(4, 100_096, 100_096, 1, 15 << 30)


def test_budget_comes_from_the_device_or_the_constant(monkeypatch):
    class Dev:
        def __init__(self, stats):
            self.stats = stats

        def memory_stats(self):
            return self.stats

    monkeypatch.setattr(jax, "local_devices", lambda: [Dev({"bytes_limit": 1000})])
    assert dispatch.stash_budget() == int(1000 * dispatch.STASH_FRACTION)
    monkeypatch.setattr(jax, "local_devices", lambda: [Dev(None)])
    assert dispatch.stash_budget() == dispatch.DEFAULT_STASH_BUDGET


@pytest.mark.parametrize("mode", ["global", "local"])
def test_split_bucket_matches_one_launch(rng, monkeypatch, mode):
    """A bucket split into launches returns what one launch returns, and
    every launch has the same shape (one program)."""
    qs = [rng.integers(0, 4, int(n)).astype(np.uint8)
          for n in rng.integers(33, 65, 7)]
    ts = [rng.integers(0, 4, int(n)).astype(np.uint8)
          for n in rng.integers(33, 65, 7)]
    one = dispatch.dispatch_batch(qs, ts, SP, mode=mode)
    shapes = []

    import seqalib.ops.wavefront_xla as wx

    orig = wx.wavefront_bucket

    def spy(q, *a, **k):
        shapes.append(q.shape)
        return orig(q, *a, **k)

    monkeypatch.setattr(wx, "wavefront_bucket", spy)
    monkeypatch.setattr(
        dispatch, "stash_budget",
        lambda: 3 * dispatch.stash_bytes_per_pair(64, 64),
    )
    split = dispatch.dispatch_batch(qs, ts, SP, mode=mode)
    assert split == one
    assert shapes == [(3, 64)] * 3


def test_traceback_pair_too_large_raises_before_launch(monkeypatch):
    monkeypatch.setattr(dispatch, "stash_budget", lambda: 100)
    with pytest.raises(ValueError, match="traceback=False"):
        seqalib.align_batch([Q], [T], SP, mode="global")
    # score-only fills stack no pointers: no guard
    got = seqalib.align_batch([Q], [T], SP, mode="global", traceback=False)
    assert got[0].score == seqalib.align(Q, T, SP, backend="oracle").score


# ---- compile cache -----------------------------------------------------------


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_dir_unset_goes_to_repo(monkeypatch, restore_cache_dir):
    from seqalib.utils.compile_cache import DEFAULT_DIR, use_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert DEFAULT_DIR == str(ROOT / ".jax_cache")
    assert use_compile_cache() == DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == DEFAULT_DIR
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_cache_dir_set_is_left_alone(monkeypatch, tmp_path, restore_cache_dir):
    from seqalib.utils.compile_cache import use_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert use_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


# ---- nothing TPU-only --------------------------------------------------------

SOURCES = sorted((ROOT / "seqalib").rglob("*.py")) + [
    ROOT / "bench.py", ROOT / "chip_smoke.py", ROOT / "__graft_entry__.py",
]


@pytest.mark.parametrize(
    "pattern",
    [
        r"pallas\.tpu|pallas import tpu|\bpltpu\b",
        r"""["']tpu["']""",  # a branch on the TPU platform name
        r"\binterpret\s*=",
    ],
    ids=["tpu_pallas_import", "tpu_platform_branch", "interpret_mode"],
)
def test_sources_hold_nothing_tpu_only(pattern):
    hits = [
        f"{p.relative_to(ROOT)}:{n}"
        for p in SOURCES
        for n, line in enumerate(p.read_text().splitlines(), 1)
        if re.search(pattern, line)
    ]
    assert not hits, hits


# ---- the programs lower for CUDA ---------------------------------------------


def _cuda_lowering(mode, band, traceback, sp=SP, B=4, Lq=32, Lt=48):
    from seqalib.ops.wavefront_xla import wavefront_bucket

    s = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.int32)  # noqa: E731
    return wavefront_bucket.trace(
        s(B, Lq), s(B, Lt), s(B), s(B),
        jnp.asarray(dispatch.sentinel_table(sp)), mode=mode,
        gap_open=sp.gap_open, gap_extend=sp.gap_extend, band=band,
        affine=sp.is_affine or band is not None, want_tb=traceback,
    ).lower(lowering_platforms=("cuda",))


@pytest.mark.parametrize(
    "mode,band,traceback",
    [
        ("global", None, True),  # config 1
        ("local", None, False),  # configs 2 and 5
        ("local", None, True),  # config 3
        ("global", 16, True),  # config 4
    ],
)
def test_engine_programs_lower_for_cuda(mode, band, traceback):
    text = _cuda_lowering(mode, band, traceback).as_text()
    assert "tpu" not in text.lower()
    assert "custom_call" not in text


def test_sharded_program_lowers_for_cuda():
    """The pair-sharded jit(shard_map(engine)) of align_all_vs_all."""
    from functools import partial

    from jax.sharding import PartitionSpec as P

    from seqalib.ops.wavefront_xla import wavefront_bucket
    from seqalib.parallel.dist import PAIR_AXIS, make_pair_mesh

    mesh = make_pair_mesh(jax.devices()[:4])
    fn = partial(wavefront_bucket, mode="local", gap_open=0, gap_extend=-2,
                 band=None, affine=False, want_tb=False)
    spec = P(PAIR_AXIS)
    sharded = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=(P(PAIR_AXIS, None),) * 2 + (spec, spec, P()),
        out_specs=spec, check_vma=False,
    ))
    s = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.int32)  # noqa: E731
    text = sharded.trace(
        s(8, 32), s(8, 48), s(8), s(8), s(5, 5)
    ).lower(lowering_platforms=("cuda",)).as_text()
    assert "tpu" not in text.lower()


# ---- the in-jit traceback walk vs a plain walk -------------------------------


def _random_pointer_field(rng, n, m, B, affine):
    """Walkable pointers: every step decreases i + j, borders point to the
    origin, each pair its own field."""
    P = np.zeros((n + m + 1, B, n + 1), np.uint8)
    for b in range(B):
        for i in range(n + 1):
            for j in range(m + 1):
                if i == 0 and j == 0:
                    p = 0
                elif i == 0:
                    p = 3
                elif j == 0:
                    p = 2
                else:
                    p = int(rng.integers(1, 4))
                if affine:
                    p |= int(rng.integers(0, 4)) << 2
                P[i + j, b, i] = p
    return P


def _plain_walk(P, b, i, j, affine):
    """Reference state machine (oracle._walk_affine's, on packed bytes)."""
    ops, st = [], "H"
    while True:
        byte = int(P[i + j, b, i])
        if st == "H":
            ph = byte & 3
            if ph == 0:
                break
            if ph == 1:
                ops.append(0)
                i, j = i - 1, j - 1
                continue
            st = "F" if ph == 2 else "E"
            if not affine:
                ops.append(1 if ph == 2 else 2)
                i, j = (i - 1, j) if ph == 2 else (i, j - 1)
                st = "H"
                continue
        if st == "F":
            ops.append(1)
            st = "F" if (byte >> 3) & 1 else "H"
            i -= 1
        elif st == "E":
            ops.append(2)
            st = "E" if (byte >> 2) & 1 else "H"
            j -= 1
    return ops, i, j


@pytest.mark.parametrize("affine", [False, True])
def test_device_walk_matches_plain_walk(rng, affine):
    from seqalib.ops.wavefront_xla import _global_walk
    from seqalib.utils.cigar import OP_PAD

    n, m, B = 12, 15, 5
    P = _random_pointer_field(rng, n, m, B, affine)
    si = rng.integers(1, n + 1, B).astype(np.int32)
    sj = rng.integers(1, m + 1, B).astype(np.int32)
    done0 = np.zeros(B, bool)
    done0[2] = True
    fi, fj, ops = jax.jit(
        lambda *a: _global_walk(*a, affine=affine, B=B, N1=n + 1, steps=n + m)
    )(jnp.asarray(P), jnp.asarray(si), jnp.asarray(sj), jnp.asarray(done0))
    ops = np.asarray(ops).T
    for b in range(B):
        row = [int(o) for o in ops[b] if o != OP_PAD]
        if done0[b]:
            assert row == [] and (fi[b], fj[b]) == (si[b], sj[b])
            continue
        want, wi, wj = _plain_walk(P, b, int(si[b]), int(sj[b]), affine)
        assert row == want, b
        assert (int(fi[b]), int(fj[b])) == (wi, wj)


def test_cigar_run_length_roundtrip(rng):
    from seqalib.utils.cigar import cigar_to_ops, ops_to_cigar

    for _ in range(20):
        ops = rng.integers(0, 3, int(rng.integers(0, 40))).tolist()
        assert cigar_to_ops(ops_to_cigar(ops)) == ops
