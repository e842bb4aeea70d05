"""Test env: a faked 8-device CPU mesh unless JAX_PLATFORMS names another
platform (SURVEY.md §4.4: multi-host-without-a-cluster technique).

Must run before the first `import jax` anywhere in the test process.
Tests that need the card take the ``gpu`` fixture, which skips them
elsewhere; ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`` runs them
on a GPU.
"""

import os

if os.environ.setdefault("JAX_PLATFORMS", "cpu") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    # A site-installed accelerator plugin may have already forced
    # jax_platforms via jax.config at interpreter startup (overriding the
    # env var); re-force CPU before any backend initializes.
    import jax

    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU (the `gpu` fixture skips it elsewhere): "
        "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/",
    )
    config.addinivalue_line(
        "markers",
        "slow: contract-scale shapes (minutes on the CPU mesh); excluded "
        "from the default suite — run with `pytest -m slow`",
    )


def pytest_collection_modifyitems(config, items):
    """Enforce the `slow` marker's contract: slow tests run only under an
    explicit `-m` selection (e.g. `pytest -m slow`)."""
    if config.getoption("-m"):
        return
    skip_slow = pytest.mark.skip(reason="slow: run with `pytest -m slow`")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)


@pytest.fixture
def gpu():
    """JAX's first device, when it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {dev.platform}")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    """Drop compiled executables between modules, so one worker process
    does not accumulate every module's programs."""
    yield
    import jax

    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_dna(rng, n):
    return rng.integers(0, 4, size=n).astype(np.uint8)


def random_protein(rng, n):
    # 0..19 = the 20 real residues; skip B/Z/X/* for realistic data
    return rng.integers(0, 20, size=n).astype(np.uint8)


def reference(q, t, sp, mode, band=None):
    """The oracle's result: the scalar contract for small pairs, its
    vectorized twin (bit-identical by tests/test_oracle_fast.py) above
    ~100k cells."""
    if len(q) * len(t) <= 100_000:
        from seqalib.oracle import align_oracle
    else:
        from seqalib.oracle_fast import align_oracle
    return align_oracle(np.asarray(q), np.asarray(t), sp, mode=mode, band=band)


def fields(r, traceback=True):
    """Score and coordinates, plus the CIGAR with traceback."""
    out = (r.score, r.query_start, r.query_end, r.target_start, r.target_end)
    return out + (r.cigar,) if traceback else out


def check_parity(qs, ts, sp, mode, band=None, traceback=True, mesh=None):
    """Engine results through the dispatcher == the oracle's, field for
    field; returns the engine results."""
    from seqalib.parallel.dispatch import dispatch_batch

    qs = [np.asarray(q, np.uint8) for q in qs]
    ts = [np.asarray(t, np.uint8) for t in ts]
    got = dispatch_batch(
        qs, ts, sp, mode=mode, band=band, traceback=traceback, mesh=mesh
    )
    for k, (g, q, t) in enumerate(zip(got, qs, ts)):
        want = reference(q, t, sp, mode, band)
        assert fields(g, traceback) == fields(want, traceback), (k, g, want)
    return got
