"""Sequence-parallel pipelined wavefront for ONE long pair over a mesh.

The data-parallel layer (`dist.py`) scales the *pair stream*; this module
scales a *single long alignment* across devices — the SP/CP role in
SURVEY.md §2.3 ("intra-pair ... one pair or band per core"), which the
sequential reference has no analog of (SURVEY.md §2.1).

Design (the ring-attention-shaped pipeline for DP matrices):

* The query's rows are split into ``D`` contiguous row-blocks, one per
  device on mesh axis ``'band'``; the target's columns into tiles of
  ``C`` columns.
* Device ``d`` computes tile ``t`` of its row-block at pipeline step
  ``s = t + d``.  The only cross-device dependency of a row-block tile
  is its *top boundary* — H/F of the row immediately above, for that
  tile's columns — produced by device ``d-1`` one step earlier and
  streamed with a single ``lax.ppermute`` per step (neighbor traffic,
  no all-to-all).  Left-boundary column state (H/E) is local and
  carried between a device's own consecutive tiles.
* Inside a tile, the Gotoh recurrence runs as an anti-diagonal wavefront
  (`lax.scan` over R+C-1 substeps, lanes = the block's R rows), exactly
  the oracle's affine cell (oracle.py::_gotoh_fill).  Pipeline
  fill/drain overhead is ``(D-1)/(n_tiles + D - 1)``.

Pure XLA (shard_map + scan + ppermute), so it compiles for any mesh,
including a faked CPU mesh.  Scores: global (``nw_affine_score_sp``) and
local (``sw_affine_score_sp``); full CIGAR: ``nw_affine_align_sp``
(boundary checkpoints + visited-tile pointer recompute).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.wavefront_xla import SP_NEG as NEG, tile_scan as _tile_scan
from ..types import PTR_DIAG, PTR_LEFT, PTR_UP

BAND_AXIS = "band"


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pipeline_body(q, t, table=None, *, n, m, R, C, D, n_tiles, match,
                   mismatch, o, e, axis=BAND_AXIS, want_tb=False,
                   local=False):
    """Per-device shard_map body: scan over pipeline steps with ppermute.

    With want_tb, additionally returns the per-tile DP boundary state the
    device consumed — resolved top packets (H row incl. corner + F row)
    and entering left columns (H/E) — the checkpoints the traceback
    recomputes tiles from (the banded path's checkpoint+recompute scheme,
    SURVEY.md §5 'checkpoint/resume', applied to the SP grid)."""
    d = jax.lax.axis_index(axis)
    i0 = d * R
    qb = jax.lax.dynamic_slice(q, (i0,), (R,))
    col0 = jnp.arange(C + 1, dtype=jnp.int32)

    def init_top(j0):
        # DP row 0: global H(0, j) = o + j*e (H(0,0) = 0); local H(0, j)
        # = 0 (SW).  F(0, j) = -inf either way.
        jcols = j0 + col0
        if local:
            H_top = jnp.zeros((C + 1,), jnp.int32)
        else:
            H_top = jnp.where(jcols == 0, 0, o + jcols * e)
        return H_top, jnp.full((C,), NEG, jnp.int32)

    # left boundary column 0: global H(i, 0) = o + i*e, local 0;
    # E(i, 0) = -inf
    if local:
        Hcol_init = jnp.zeros((R,), jnp.int32)
    else:
        Hcol_init = (o + (i0 + jnp.arange(R) + 1) * e).astype(jnp.int32)
    Ecol_init = jnp.full((R,), NEG, jnp.int32)

    def step(carry, s):
        Hcol, Ecol, cap, pkt = carry
        t_idx = s - d
        active = (t_idx >= 0) & (t_idx < n_tiles)
        j0 = jnp.clip(t_idx, 0, n_tiles - 1) * C
        H0, F0 = init_top(j0)
        H_top = jnp.where(d == 0, H0, pkt[: C + 1])
        F_top = jnp.where(d == 0, F0, pkt[C + 1 :])

        def compute(_):
            return _tile_scan(
                qb, t, j0, H_top, F_top, Hcol, Ecol, cap,
                C=C, i0=i0, n=n, m=m, match=match, mismatch=mismatch, o=o, e=e,
                table=table, local=local,
            )

        def skip(_):
            # pipeline fill/drain: true work-skipping, not work-masking —
            # an inactive step's packet is never consumed by an active
            # neighbor tile
            z = jnp.zeros((C,), jnp.int32)
            return z, z, Hcol, Ecol, cap

        corner = Hcol[R - 1 :]  # pre-tile left boundary's bottom lane
        Hcol_in, Ecol_in = Hcol, Ecol
        bot_H, bot_F, Hcol, Ecol, cap = jax.lax.cond(active, compute, skip, None)
        # next device's top-row packet: corner H(i0+R, j0) = this tile's
        # left boundary bottom lane, then the tile's bottom H and F rows
        pkt_out = jnp.concatenate([corner, bot_H, bot_F])
        pkt_next = jax.lax.ppermute(
            pkt_out, axis, [(i, (i + 1) % D) for i in range(D)]
        )
        ys = None
        if want_tb:
            # the resolved boundaries this tile was computed FROM —
            # inactive steps store don't-care values never indexed later
            ys = (jnp.concatenate([H_top, F_top]), Hcol_in, Ecol_in)
        return (Hcol, Ecol, cap, pkt_next), ys

    steps = jnp.arange(n_tiles + D - 1, dtype=jnp.int32)
    init = (
        Hcol_init,
        Ecol_init,
        jnp.int32(NEG),
        jnp.zeros((2 * C + 1,), jnp.int32),
    )
    (Hcol, Ecol, cap, _), ys = jax.lax.scan(step, init, steps)
    score = jax.lax.pmax(cap, axis)
    if want_tb:
        return score, ys[0], ys[1], ys[2]
    return score


def make_band_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis name 'band'."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (BAND_AXIS,))


def _sp_fill(q, t, sp, mesh: Mesh, C, want_tb, local=False):
    """Shared SP pipeline fill.  Returns (score, geom) or, with want_tb,
    (score, geom, tops (D, steps, 2C+1), hcols (D, steps, R),
    ecols (D, steps, R)) — the per-(device, step) boundary checkpoints."""
    q = np.asarray(q)
    t = np.asarray(t)
    n, m = len(q), len(t)
    D = mesh.shape[BAND_AXIS]
    R = max(1, _ceil_to(n, D) // D)
    n_tiles = max(1, _ceil_to(m, C) // C)
    # pad: extra rows/cols never feed cell (n, m) (DP flows down/right);
    # pad letters must stay valid table indices in matrix mode
    pad_letter = 0 if sp.matrix is not None else 4
    q_pad = np.full(D * R, 0, np.int32)
    q_pad[:n] = q
    t_pad = np.full(n_tiles * C + C + 2, pad_letter, np.int32)
    t_pad[1 : 1 + m] = t  # t_pad[x] = t[x - 1] (1-based column indexing)

    body = functools.partial(
        _pipeline_body,
        n=n, m=m, R=R, C=C, D=D, n_tiles=n_tiles,
        match=sp.match, mismatch=sp.mismatch,
        o=sp.gap_open, e=sp.gap_extend,
        want_tb=want_tb,
        local=local,
    )
    in_specs = (P(None), P(None))
    args = [jnp.asarray(q_pad), jnp.asarray(t_pad)]
    if sp.matrix is not None:
        in_specs = (P(None), P(None), P(None, None))
        args.append(jnp.asarray(sp.substitution_matrix(), jnp.int32))
    out_specs = P()
    if want_tb:
        out_specs = (P(), P(BAND_AXIS, None), P(BAND_AXIS, None),
                     P(BAND_AXIS, None))
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=out_specs,
        check_vma=False,
    )
    out = jax.jit(fn)(*args)
    geom = dict(n=n, m=m, D=D, R=R, C=C, n_tiles=n_tiles,
                q_pad=q_pad, t_pad=t_pad)
    if not want_tb:
        return int(out), geom
    score, tops, hcols, ecols = out
    steps = n_tiles + D - 1
    # checkpoints stay ON DEVICE: at 100kb the left-column checkpoints
    # are O(n * m/C) ints (~hundreds of MB) — the walk fetches only the
    # per-tile slices it visits
    return (
        int(score),
        geom,
        tops.reshape(D, steps, 2 * C + 1),
        hcols.reshape(D, steps, R),
        ecols.reshape(D, steps, R),
    )


def nw_affine_score_sp(q, t, sp, mesh: Mesh, C: int = 128) -> int:
    """Global affine-gap alignment SCORE of one long pair, computed
    cooperatively by every device on ``mesh``'s 'band' axis.

    Exact (full-matrix) Gotoh score, identical to oracle.nw_affine.
    Scoring: scalar match/mismatch (the long-read domain), or a
    substitution matrix (per-cell gather).  q/t: 1-D int letter codes.
    Pipeline: row-blocks x column-tiles of the lax.scan tile body, one
    ppermute per step.
    """
    n, m = len(np.asarray(q)), len(np.asarray(t))
    if n == 0 or m == 0:
        if n == 0 and m == 0:
            return 0
        return sp.gap_open + max(n, m) * sp.gap_extend
    score, _ = _sp_fill(q, t, sp, mesh, C, want_tb=False)
    return score


def sw_affine_score_sp(q, t, sp, mesh: Mesh, C: int = 128) -> int:
    """LOCAL (Smith-Waterman) affine-gap alignment SCORE of one long pair
    over ``mesh``'s 'band' axis.  Exact max-over-all-cells Gotoh-SW score,
    identical to oracle.sw_affine."""
    n, m = len(np.asarray(q)), len(np.asarray(t))
    if n == 0 or m == 0:
        return 0
    score, _ = _sp_fill(q, t, sp, mesh, C, want_tb=False, local=True)
    return max(0, score)


_PTR_TILE_CACHE: dict = {}


def _ptr_tile_fn(C, match, mismatch, o, e, has_table):
    """Cached jitted pointer-tile recompute (one program per static
    config).  A fresh @jax.jit inside nw_affine_align_sp would have a
    new identity per call and re-trace/re-compile the identical program
    every alignment — the stale-wrapper cost dist._cached_sharded_jit
    exists to avoid.  n=m=0 disables the (irrelevant) end-cell capture;
    i0 only feeds that check, so it is fixed out of the cache key."""
    key = (C, match, mismatch, o, e, has_table)
    fn = _PTR_TILE_CACHE.get(key)
    if fn is None:

        def _ptr_tile(qb, tp, j0, H_top, F_top, Hcol0, Ecol0, tbl):
            return _tile_scan(
                qb, tp, j0, H_top, F_top, Hcol0, Ecol0, jnp.int32(NEG),
                C=C, i0=0, n=0, m=0, match=match, mismatch=mismatch,
                o=o, e=e, table=tbl if has_table else None, want_ptr=True,
            )[5]

        fn = _PTR_TILE_CACHE[key] = jax.jit(_ptr_tile)
    return fn


def _rescore_global_affine(q, t, ops, sp) -> int:
    """Score a global alignment given as a CIGAR op list (verification)."""
    from ..utils.cigar import OP_D, OP_I, OP_M

    if sp.matrix is not None:
        tbl = np.asarray(sp.substitution_matrix())
        _subst = lambda a, b: int(tbl[a, b])  # noqa: E731
    else:
        _subst = lambda a, b: sp.match if a == b else sp.mismatch  # noqa: E731
    i = j = s = 0
    prev = None
    for op in ops:
        if op == OP_M:
            s += _subst(int(q[i]), int(t[j]))
            i += 1
            j += 1
        else:
            s += sp.gap_extend + (sp.gap_open if op != prev else 0)
            if op == OP_I:
                i += 1
            else:
                j += 1
        prev = op
    if i != len(q) or j != len(t):  # survives python -O
        raise RuntimeError("CIGAR must consume both sequences")
    return s


def nw_affine_align_sp(q, t, sp, mesh: Mesh, C: int = 128):
    """Global affine alignment of one long pair over the mesh — score AND
    CIGAR.

    Fill: the SP pipeline with boundary checkpointing —
    each device keeps the top packets + left columns every tile consumed
    (O((n/D + m) * m/C) ints, gathered host-side).  Traceback: the
    banded path's checkpoint+recompute scheme on the SP grid — the walk
    recomputes only the tiles the optimal path visits (~(n+m)/min(R,C)
    of n*m/(R*C)), each as a jitted pointer tile on the device, and a
    host state machine identical to oracle._walk_affine follows the
    packed pointers, hopping tiles/devices as the path crosses block
    boundaries.  Tie-breaks are the oracle's exactly; the result CIGAR
    is verified by rescoring against the fill score before returning.
    """
    from ..types import AlignResult
    from ..utils.cigar import OP_D, OP_I, OP_M, ops_to_cigar

    q = np.asarray(q)
    t = np.asarray(t)
    n, m = len(q), len(t)
    if n == 0 or m == 0:
        score = 0 if n == m else sp.gap_open + max(n, m) * sp.gap_extend
        return AlignResult(
            int(score), 0, n, 0, m,
            (f"{m}D" if m else "") if n == 0 else f"{n}I",
        )
    score, geom, tops, hcols, ecols = _sp_fill(q, t, sp, mesh, C, want_tb=True)
    R, D, n_tiles = geom["R"], geom["D"], geom["n_tiles"]
    q_pad, t_pad = geom["q_pad"], geom["t_pad"]
    tbl = (
        jnp.asarray(sp.substitution_matrix(), jnp.int32)
        if sp.matrix is not None
        else None
    )
    t_dev = jax.device_put(np.asarray(t_pad))
    _ptr_tile = _ptr_tile_fn(
        C, sp.match, sp.mismatch, sp.gap_open, sp.gap_extend,
        sp.matrix is not None,
    )
    tbl_arg = tbl if tbl is not None else jnp.zeros((1, 1), jnp.int32)

    ptr_cache: dict = {}

    def tile_ptrs(d, tt):
        key = (d, tt)
        if key not in ptr_cache:
            s_idx = tt + d
            top = tops[d, s_idx]
            ptr_cache[key] = np.asarray(
                _ptr_tile(
                    jnp.asarray(q_pad[d * R : (d + 1) * R]),
                    t_dev,
                    tt * C,
                    top[: C + 1],
                    top[C + 1 :],
                    hcols[d, s_idx],
                    ecols[d, s_idx],
                    tbl_arg,
                )
            )
        return ptr_cache[key]

    # host walk: oracle._walk_affine's state machine over on-demand tiles
    ops: list = []
    i, j, state = n, m, "H"
    while True:
        if i == 0:
            ops.extend([OP_D] * j)
            break
        if j == 0:
            ops.extend([OP_I] * i)
            break
        d, tt = (i - 1) // R, (j - 1) // C
        i0, j0 = d * R, tt * C
        P = tile_ptrs(d, tt)
        while i > i0 and j > j0:
            byte = int(P[(j - j0) + (i - i0 - 1) - 1, i - i0 - 1])
            if state == "H":
                ph = byte & 3
                if ph == PTR_DIAG:
                    ops.append(OP_M)
                    i -= 1
                    j -= 1
                elif ph == PTR_UP:
                    state = "F"
                else:
                    assert ph == PTR_LEFT, (ph, i, j)
                    state = "E"
            elif state == "F":
                ops.append(OP_I)
                if not (byte >> 3) & 1:
                    state = "H"
                i -= 1
            else:  # E
                ops.append(OP_D)
                if not (byte >> 2) & 1:
                    state = "H"
                j -= 1
    ops.reverse()
    walked = _rescore_global_affine(q, t, ops, sp)
    if walked != score:  # not an assert: must survive python -O
        raise RuntimeError(
            f"SP traceback rescore {walked} != fill score {score}"
        )
    return AlignResult(int(score), 0, n, 0, m, ops_to_cigar(ops))
