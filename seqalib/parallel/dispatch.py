"""Batched alignment dispatcher: length bucketing, padding, the device
engine call, result assembly (SURVEY.md §1.2 layer 2, §3.2-1; new-build —
the reference is a single-pair sequential library with no batching,
SURVEY.md §2.1).

Pipeline: sort pairs into (Lq, Lt) buckets -> pad -> run each bucket
through the device engine (``ops.wavefront_xla``, shard_map'ed over a
mesh's 'pairs' axis by ``parallel.dist`` when a mesh is given) -> decode
tracebacks -> unpermute to input order.  ``run_bucket`` is the one place
that maps (mode, band, traceback, mesh) to an engine call.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..types import AlignResult, ScoringParams
from ..utils.cigar import OP_PAD, ops_to_cigar

MIN_BUCKET = 16

# Share of the device's memory limit that one launch's traceback pointer
# stash may take: the fill's working set, the walk and the next launch in
# flight need the rest.
STASH_FRACTION = 0.25
# Stash budget where the device reports no memory limit (the CPU backend).
DEFAULT_STASH_BUDGET = 2 << 30


def bucket_len(n: int) -> int:
    """Bucket width for a sequence of length n.

    n <= 128: smallest power of two >= n (>= MIN_BUCKET), so tiny pairs get
    fine-grained buckets.  n > 128: the next multiple of 128, which at the
    config-5 read/reference distribution (reads 128-256 x refs 512-1024)
    pads less than power-of-two buckets.  ROADMAP A.7 re-derives this
    quantum from measurement on the card."""
    if n <= 128:
        b = MIN_BUCKET
        while b < n:
            b <<= 1
        return b
    return -(-n // 128) * 128


def _pad_stack(seqs: List[np.ndarray], L: int) -> np.ndarray:
    out = np.zeros((len(seqs), L), dtype=np.int32)
    for r, s in enumerate(seqs):
        out[r, : len(s)] = s
    return out


def sentinel_table(sp: ScoringParams) -> np.ndarray:
    """(A+1, A+1) int32 substitution table with a zero sentinel row/col.

    The sentinel (last index) scores 0 against everything so padded lattice
    slots drift by 0 instead of accumulating junk (SURVEY.md §2.1
    'ScoringSystem' equivalent)."""
    m = sp.substitution_matrix()
    a = m.shape[0]
    out = np.zeros((a + 1, a + 1), dtype=np.int32)
    out[:a, :a] = m
    return out


def stash_bytes_per_pair(Lq: int, Lt: int) -> int:
    """Bytes of traceback pointers one (Lq, Lt) pair stacks on the device:
    one uint8 per lattice slot, (Lq + Lt + 1) anti-diagonals of Lq + 1
    slots (ops.wavefront_xla._scan_fill)."""
    return (Lq + Lt + 1) * (Lq + 1)


def stash_budget() -> int:
    """Pointer-stash bytes one launch may take on one device."""
    import jax

    stats = jax.local_devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return DEFAULT_STASH_BUDGET
    return int(limit * STASH_FRACTION)


def launch_rows(B: int, Lq: int, Lt: int, ndev: int, budget: int) -> int:
    """Rows per launch so that each device's pointer stash fits ``budget``.

    B is a multiple of ``ndev``; the result is too, and the launches of a
    bucket all take this one shape (the last is padded), so a split bucket
    compiles one program."""
    per_pair = stash_bytes_per_pair(Lq, Lt)
    cap = budget // per_pair
    if cap == 0:
        raise ValueError(
            f"one {Lq}x{Lt} pair needs {per_pair} bytes of traceback "
            f"pointers, over the {budget}-byte budget of one device; "
            "align it with traceback=False or split the pair"
        )
    per_dev = B // ndev
    if per_dev <= cap:
        return B
    n_launch = -(-per_dev // cap)
    return -(-per_dev // n_launch) * ndev


def run_bucket(
    q: np.ndarray,
    t: np.ndarray,
    qlen: np.ndarray,
    tlen: np.ndarray,
    sp: ScoringParams,
    mode: str,
    band: Optional[int],
    traceback: bool,
    mesh=None,
    launch_only: bool = False,
):
    """Run one padded bucket (B, Lq) x (B, Lt) on the device engine.

    Returns the host result dict, or with ``launch_only`` a 0-arg
    finalizer: the device work is left in flight, and the finalizer
    fetches it, so the caller can prepare the next bucket meanwhile
    (align_all_vs_all's chunk lookahead).  With ``traceback`` the bucket
    is split into launches whose pointer stash fits ``stash_budget``."""
    import jax.numpy as jnp

    from ..ops.wavefront_xla import wavefront_bucket
    from .dist import PAIR_AXIS, gather_to_host, wavefront_sharded

    kwargs = dict(
        mode=mode,
        gap_open=sp.gap_open,
        gap_extend=sp.gap_extend,
        band=band,
        affine=sp.is_affine or band is not None,
        want_tb=traceback,
    )
    table = sentinel_table(sp)
    B, Lq = q.shape
    ndev = 1 if mesh is None else mesh.shape[PAIR_AXIS]
    rows = B
    if traceback:
        rows = launch_rows(B, Lq, t.shape[1], ndev, stash_budget())
    n_launch = -(-B // rows)
    pad = n_launch * rows - B
    if pad:
        # zero-length sentinel rows: masked in the fill, sliced off below
        q = np.concatenate([q, np.zeros((pad, Lq), q.dtype)])
        t = np.concatenate([t, np.zeros((pad, t.shape[1]), t.dtype)])
        qlen = np.concatenate([qlen, np.zeros(pad, qlen.dtype)])
        tlen = np.concatenate([tlen, np.zeros(pad, tlen.dtype)])

    launches = []
    for lo in range(0, n_launch * rows, rows):
        sl = slice(lo, lo + rows)
        args = (q[sl], t[sl], qlen[sl], tlen[sl], table)
        if mesh is not None:
            launches.append(wavefront_sharded(mesh, *args, **kwargs))
        else:
            launches.append(
                wavefront_bucket(*(jnp.asarray(a) for a in args), **kwargs)
            )

    def finalize() -> Dict[str, np.ndarray]:
        parts = [gather_to_host(o) for o in launches]
        if len(parts) == 1:
            res = parts[0]
        else:
            res = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        return {k: v[:B] for k, v in res.items()}

    return finalize if launch_only else finalize()


def _decode_ops_rev(row: np.ndarray) -> str:
    """end->start op codes, OP_PAD padded -> CIGAR string."""
    n = int((row != OP_PAD).sum())
    return ops_to_cigar(row[:n][::-1])


def dispatch_batch(
    qs: List[np.ndarray],
    ts: List[np.ndarray],
    sp: ScoringParams,
    mode: str = "local",
    band: Optional[int] = None,
    traceback: bool = True,
    mesh=None,
    pad_batch_to: int = 1,
) -> List[AlignResult]:
    """Align all pairs on the device engine; returns results in input
    order."""
    n_pairs = len(qs)
    if mesh is not None and pad_batch_to == 1:
        from .dist import PAIR_AXIS

        pad_batch_to = mesh.shape[PAIR_AXIS]
    # bucket key: (padded Lq, padded Lt)
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for idx, (q, t) in enumerate(zip(qs, ts)):
        key = (bucket_len(len(q)), bucket_len(len(t)))
        buckets.setdefault(key, []).append(idx)

    results: List[Optional[AlignResult]] = [None] * n_pairs
    # two-phase: launch every bucket before fetching any, so the buckets
    # queue on the device back to back instead of one host round trip each
    pending = []
    for (Lq, Lt), idxs in sorted(buckets.items()):
        B = len(idxs)
        Bp = max(B, 1)
        if pad_batch_to > 1:
            Bp = ((B + pad_batch_to - 1) // pad_batch_to) * pad_batch_to
        # tail padding uses ZERO-LENGTH sentinels, not replicated real
        # pairs: padded slots then do no traceback/start-recovery work and
        # their fill lanes are masked out
        zpad = [np.zeros(0, np.int32)] * (Bp - B)
        qb = _pad_stack([qs[i] for i in idxs] + zpad, Lq)
        tb = _pad_stack([ts[i] for i in idxs] + zpad, Lt)
        qlen = np.array([len(qs[i]) for i in idxs] + [0] * (Bp - B), np.int32)
        tlen = np.array([len(ts[i]) for i in idxs] + [0] * (Bp - B), np.int32)
        fin = run_bucket(
            qb, tb, qlen, tlen, sp, mode, band, traceback,
            mesh=mesh, launch_only=True,
        )
        pending.append((idxs, fin))
    for idxs, fin in pending:
        out = fin()
        for r, idx in enumerate(idxs):
            cigar = _decode_ops_rev(out["ops_rev"][r]) if traceback else ""
            results[idx] = AlignResult(
                int(out["score"][r]),
                int(out["qs"][r]),
                int(out["qe"][r]),
                int(out["ts"][r]),
                int(out["te"][r]),
                cigar,
            )
    return results  # type: ignore[return-value]
