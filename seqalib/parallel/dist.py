"""Data-parallel distribution of the pair stream over a device mesh.

Scale-out layer (SURVEY.md §1.2 layer 3, §2.3; new-build — the reference
is a sequential single-thread library, SURVEY.md §2.1).  The unit of
parallelism is the *pair*: a padded bucket (B, L) is sharded over the mesh
axis ``'pairs'`` with ``shard_map``; every device runs the identical
wavefront program on its shard, with no collectives.  Cross-host result
assembly uses ``multihost_utils.process_allgather`` when more than one
process is present.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.wavefront_xla import wavefront_bucket

PAIR_AXIS = "pairs"


def make_pair_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis name 'pairs'."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (PAIR_AXIS,))


def _out_specs_like(fn, args):
    """P('pairs', None, ...) for every output leaf (all are batch-major)."""
    shapes = jax.eval_shape(
        fn, *[jax.ShapeDtypeStruct(a.shape, a.dtype) for a in args]
    )
    return jax.tree.map(
        lambda s: P(PAIR_AXIS, *([None] * (len(s.shape) - 1))), shapes
    )


_SHARDED_JIT_CACHE: dict = {}


def _cached_sharded_jit(key, build):
    """Reuse jit(shard_map(...)) callables across calls.

    A fresh wrapper per call has a new Python identity, so jax.jit's trace
    cache misses and every chunk of a streaming product would re-trace and
    re-compile.  ``build()`` constructs the jitted callable once per static
    config; jit's own cache then handles shapes within a config."""
    fn = _SHARDED_JIT_CACHE.get(key)
    if fn is None:
        fn = _SHARDED_JIT_CACHE[key] = build()
    return fn


def _place(mesh: Mesh, x: np.ndarray, spec: P) -> jax.Array:
    """Commit a host array to the mesh with ``spec``.

    Each process materializes only its own shards: a plain host array
    cannot be committed to a mesh whose devices other processes own
    (exercised by tests/test_multihost.py on a 2-process CPU mesh)."""
    x = np.asarray(x)
    sharding = jax.NamedSharding(mesh, spec)
    return jax.make_array_from_callback(x.shape, sharding, lambda idx: x[idx])


def wavefront_sharded(
    mesh: Mesh,
    q: np.ndarray,
    t: np.ndarray,
    qlen: np.ndarray,
    tlen: np.ndarray,
    table: np.ndarray,
    *,
    mode: str,
    gap_open: int,
    gap_extend: int,
    band: Optional[int],
    affine: bool,
    want_tb: bool,
):
    """shard_map'ed wavefront_bucket over the mesh's 'pairs' axis.

    B must be a multiple of the axis size (the dispatcher pads the bucket,
    seqalib.parallel.dispatch.dispatch_batch ``pad_batch_to``).  Returns
    the engine's output dict as device arrays sharded over 'pairs'.
    """
    ndev = mesh.shape[PAIR_AXIS]
    B = q.shape[0]
    if B % ndev != 0:
        raise ValueError(f"bucket batch {B} not divisible by mesh axis {ndev}")

    fn = functools.partial(
        wavefront_bucket,
        mode=mode,
        gap_open=gap_open,
        gap_extend=gap_extend,
        band=band,
        affine=affine,
        want_tb=want_tb,
    )
    in_specs = (P(PAIR_AXIS, None), P(PAIR_AXIS, None), P(PAIR_AXIS),
                P(PAIR_AXIS), P(None, None))
    args = tuple(
        _place(mesh, np.asarray(a, np.int32), s)
        for a, s in zip((q, t, qlen, tlen, table), in_specs)
    )

    def build():
        # check_vma=False: the wavefront scan's init carry is device-
        # invariant (jnp.full inside the body) while its output is pair-
        # varying, which the varying-manual-axes checker would reject;
        # per-device execution is still fully independent (pure data
        # parallelism, no collectives).
        sharded = jax.shard_map(
            fn, mesh=mesh, in_specs=in_specs,
            out_specs=_out_specs_like(fn, args), check_vma=False,
        )
        return jax.jit(sharded)

    key = ("wavefront", mesh, mode, gap_open, gap_extend, band, affine,
           want_tb)
    return _cached_sharded_jit(key, build)(*args)


def gather_to_host(tree):
    """Bring a (possibly multi-host sharded) result pytree to every host.

    Single-process: plain device_get.  Multi-process: process_allgather so
    each host sees the full pair stream's results (SURVEY.md §3.2-1 "cross-
    host boundary")."""
    if jax.process_count() == 1:
        return jax.tree.map(np.asarray, tree)
    from jax.experimental import multihost_utils

    return multihost_utils.process_allgather(tree, tiled=True)
