"""Anti-diagonal wavefront DP in pure JAX (lax.scan) — the device engine.

Re-design of the reference's row-major DP loops (SeqALib
``NeedlemanWunschSA::buildMatrix`` etc., SURVEY.md §3.1): instead of a
sequential double loop, every cell of an anti-diagonal is computed at once
as a vector op, batched across pairs (SURVEY.md §1.2 layer 4 semantics,
expressed in XLA, which compiles it for any backend).  Every path of the
package that touches a device runs this module: the bucketed dispatcher,
the pair-sharded mesh path (parallel.dist) and, for one long pair, the
same recurrence tiled in parallel.band_pipeline.

Bit-exactness contract (vs seqalib.oracle):
  * identical max-cascade tie-breaks (DIAG > UP(F) > LEFT(E); extend >= open);
  * identical local-mode stop rule (candidate <= 0 -> 0/STOP) and argmax
    tie-break (smallest i, then smallest j);
  * local coords + CIGAR via the TWO-PASS canonical scheme (oracle.py module
    docstring): end from the local fill's argmax; start from an anchored
    reverse-extension fill over the reversed prefixes; CIGAR from the
    canonical global traceback of the [qs:qe] x [ts:te] window.  No per-cell
    start-lineage state is carried;
  * banded (global only): out-of-band lanes are forced to exactly NEG_INF
    each diagonal, reproducing the oracle's skipped-cell semantics.

Diagonal-index layout: diagonal k holds cells (i, j=k-i) in a dense vector
indexed by i in [0, Lq]; target letters for a diagonal are a contiguous
window of the reversed target (host pre-reversal trick, SURVEY.md §7).
Lanes beyond the wavefront hold ~NEG_INF junk whose drift is bounded by
(n+m)*max|score| << |NEG_INF|, so it can never win a max against any real
candidate (see SURVEY.md §7 "Dtype/overflow").
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..types import NEG_INF, PTR_DIAG, PTR_LEFT, PTR_STOP, PTR_UP
from ..utils.cigar import OP_D, OP_I, OP_M, OP_PAD

# Packed pointer byte: bits 0-1 = H provenance, bit 2 = E-extend, bit 3 = F-extend.
_EXT_E_BIT = 2
_EXT_F_BIT = 3


def _shift1(x, fill):
    """y[..., i] = x[..., i-1]; y[..., 0] = fill."""
    return jnp.concatenate(
        [jnp.full(x.shape[:-1] + (1,), fill, x.dtype), x[..., :-1]], axis=-1
    )


def _scan_fill(
    q: jax.Array,  # (B, Lq) int32 codes, padded with the sentinel code
    t: jax.Array,  # (B, Lt) int32 codes
    qlen: jax.Array,  # (B,) int32 true lengths
    tlen: jax.Array,  # (B,) int32
    table: jax.Array,  # (A1, A1) int32 substitution, sentinel row/col = last
    *,
    kind: str,  # "local" | "global" | "extension"
    gap_open: int,
    gap_extend: int,
    band: Optional[int],
    affine: bool,
    want_tb: bool,
):
    """One wavefront fill over a padded bucket.

    kind="local":      SW clamp/STOP semantics; returns per-slot argmax
                       (bv, bk) for the canonical end reduction.
    kind="extension":  anchored global recurrence (gap boundaries, no
                       clamp) with the same argmax tracking — pass 2 of
                       the two-pass local coords scheme.
    kind="global":     NW; returns the captured final-cell score.
    want_tb (global only): additionally stacks the packed pointer bytes
    per diagonal for the traceback walk.
    """
    B, Lq = q.shape
    Lt = t.shape[1]
    n, m = Lq, Lt
    N1 = n + 1
    K = n + m + 1
    o, e = gap_open, gap_extend
    g = gap_extend  # linear gap
    A1 = table.shape[0]
    SENT = A1 - 1
    local = kind == "local"
    track = kind in ("local", "extension")
    assert not (want_tb and track), "pointer stash is a global-fill feature"
    assert band is None or kind == "global", "banded fills are global-only"
    table_flat = table.reshape(-1)

    NEG = jnp.int32(NEG_INF)
    iarr = jnp.arange(N1, dtype=jnp.int32)  # slot index i

    # Reversed-window target: REV[b, p] = t[b, n+m-p] (sentinel outside).
    REV = jnp.full((B, 2 * n + m + 2), SENT, dtype=jnp.int32)
    REV = jax.lax.dynamic_update_slice(
        REV, jnp.flip(t, axis=1).astype(jnp.int32), (0, n + 1)
    )
    # check: slice starts at n+m-Lt+1 = n+1 since Lt == m.
    qpad = jnp.concatenate(
        [jnp.full((B, 1), SENT, jnp.int32), q.astype(jnp.int32)], axis=1
    )  # qpad[i] = q[i-1]

    if band is not None:
        delta = tlen - qlen
        dlo = jnp.minimum(0, delta) - band  # (B,)
        dhi = jnp.maximum(0, delta) + band

    def band_mask_apply(k, *arrs):
        """Force out-of-band slots to exactly NEG_INF (oracle semantics)."""
        if band is None:
            return arrs
        dkj = k - 2 * iarr[None, :]  # j - i per slot, (1, N1) vs (B, 1)
        out = (dkj < dlo[:, None]) | (dkj > dhi[:, None])
        return tuple(jnp.where(out, NEG, a) for a in arrs)

    def subst_diag(k):
        """s_vec[b, i] = subst(q[i-1], t[k-i-1]) via the reversed window."""
        W = jax.lax.dynamic_slice(REV, (0, n + m + 1 - k), (B, N1))
        idx = qpad * A1 + W
        return jnp.take(table_flat, idx, axis=0)

    def track_update(k, Hn, bv, bk):
        j = k - iarr[None, :]
        valid = (
            (iarr[None, :] >= 1)
            & (iarr[None, :] <= qlen[:, None])
            & (j >= 1)
            & (j <= tlen[:, None])
        )
        v = jnp.where(valid, Hn, 0)
        upd = v > bv  # strict >: first max in scan order per slot
        return jnp.where(upd, v, bv), jnp.where(upd, k, bk)

    if not affine:

        def body(carry, k):
            H1, H2, score, bv, bk = carry
            s_vec = subst_diag(k)
            d = _shift1(H2, NEG) + s_vec
            u = _shift1(H1, NEG) + g
            l = H1 + g
            best = jnp.maximum(jnp.maximum(d, u), l)
            ptr = jnp.where(
                d == best,
                PTR_DIAG,
                jnp.where(u == best, PTR_UP, PTR_LEFT),
            ).astype(jnp.uint8)
            if local:
                stop = best <= 0
                Hn = jnp.where(stop, 0, best)
                ptr = jnp.where(stop, PTR_STOP, ptr).astype(jnp.uint8)
            else:
                Hn = best
            # boundaries: i == 0 (cell (0, k)) and i == k (cell (k, 0))
            bmask = (iarr[None, :] == 0) | (iarr[None, :] == k)
            if local:
                Hn = jnp.where(bmask, 0, Hn)
                ptr = jnp.where(bmask, PTR_STOP, ptr).astype(jnp.uint8)
            else:
                Hn = jnp.where(bmask, k * g, Hn)
                bptr = jnp.where(iarr[None, :] == 0, PTR_LEFT, PTR_UP)
                bptr = jnp.where(k == 0, PTR_STOP, bptr)
                ptr = jnp.where(bmask, bptr, ptr).astype(jnp.uint8)
            (Hn,) = band_mask_apply(k, Hn)

            if track:
                bv, bk = track_update(k, Hn, bv, bk)
            else:
                fin = k == (qlen + tlen)
                sc_k = jnp.take_along_axis(Hn, qlen[:, None], axis=1)[:, 0]
                score = jnp.where(fin, sc_k, score)
            ys = ptr if want_tb else None
            return (Hn, H1, score, bv, bk), ys

        init = (
            jnp.full((B, N1), NEG, jnp.int32),
            jnp.full((B, N1), NEG, jnp.int32),
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((B, N1), jnp.int32),
            jnp.zeros((B, N1), jnp.int32),
        )
        (_, _, score, bv, bk), P = jax.lax.scan(
            body, init, jnp.arange(K, dtype=jnp.int32)
        )
    else:

        def body(carry, k):
            H1, H2, E1, F1, score, bv, bk = carry
            s_vec = subst_diag(k)
            E_ext = E1 + e
            E_opn = H1 + o + e
            ext_e = E_ext >= E_opn  # tie-break: extend > open
            En = jnp.maximum(E_ext, E_opn)
            F_ext = _shift1(F1, NEG) + e
            F_opn = _shift1(H1, NEG) + o + e
            ext_f = F_ext >= F_opn
            Fn = jnp.maximum(F_ext, F_opn)
            d = _shift1(H2, NEG) + s_vec
            best = jnp.maximum(jnp.maximum(d, Fn), En)
            ptr = jnp.where(
                d == best,
                PTR_DIAG,
                jnp.where(Fn == best, PTR_UP, PTR_LEFT),
            )
            if local:
                stop = best <= 0
                Hn = jnp.where(stop, 0, best)
                ptr = jnp.where(stop, PTR_STOP, ptr)
            else:
                Hn = best
            # k == 0 origin: H[0,0] = 0, ptr STOP (slot 0 only)
            origin = (k == 0) & (iarr[None, :] == 0)
            Hn = jnp.where(origin, 0, Hn)
            ptr = jnp.where(origin, PTR_STOP, ptr)
            if local:
                bmask = (iarr[None, :] == 0) | (iarr[None, :] == k)
                Hn = jnp.where(bmask, 0, Hn)
                ptr = jnp.where(bmask, PTR_STOP, ptr)
            Hn, En, Fn = band_mask_apply(k, Hn, En, Fn)

            if track:
                bv, bk = track_update(k, Hn, bv, bk)
            else:
                fin = k == (qlen + tlen)
                sc_k = jnp.take_along_axis(Hn, qlen[:, None], axis=1)[:, 0]
                score = jnp.where(fin, sc_k, score)
            if want_tb:
                pbyte = (
                    ptr.astype(jnp.uint8)
                    | (ext_e.astype(jnp.uint8) << _EXT_E_BIT)
                    | (ext_f.astype(jnp.uint8) << _EXT_F_BIT)
                )
                ys = pbyte
            else:
                ys = None
            return (Hn, H1, En, Fn, score, bv, bk), ys

        init = (
            jnp.full((B, N1), NEG, jnp.int32),
            jnp.full((B, N1), NEG, jnp.int32),
            jnp.full((B, N1), NEG, jnp.int32),
            jnp.full((B, N1), NEG, jnp.int32),
            jnp.zeros((B,), jnp.int32),
            jnp.zeros((B, N1), jnp.int32),
            jnp.zeros((B, N1), jnp.int32),
        )
        (_, _, _, _, score, bv, bk), P = jax.lax.scan(
            body, init, jnp.arange(K, dtype=jnp.int32)
        )

    out = {}
    if track:
        # per-slot bests -> global argmax with smallest-i, then smallest-j.
        maxv = jnp.max(bv, axis=1)  # (B,)
        big = jnp.int32(1 << 30)
        cand_i = jnp.where(bv == maxv[:, None], iarr[None, :], big)
        bi = jnp.min(cand_i, axis=1).astype(jnp.int32)
        bkk = jnp.take_along_axis(bk, bi[:, None], axis=1)[:, 0]
        bj = bkk - bi
        empty = maxv <= 0
        out["score"] = maxv
        out["bi"] = jnp.where(empty, 0, bi)
        out["bj"] = jnp.where(empty, 0, bj)
    else:
        out["score"] = score
    if want_tb:
        out["P"] = P
    return out


def _global_walk(P, start_i, start_j, done0, *, affine, B, N1, steps):
    """In-jit pointer walk from (start_i, start_j) back to the origin.

    P: (K, B, N1) packed pointer bytes from a global fill.  Returns
    (fi, fj, ops_rev) with ops_rev (steps, B) in end->start order.
    """
    P_flat = P.reshape(-1)
    barr = jnp.arange(B, dtype=jnp.int32)

    def cell_byte(i, j):
        idx = (i + j) * (B * N1) + barr * N1 + i
        return jnp.take(P_flat, idx, axis=0)

    if not affine:

        def tb_body(carry, _):
            i, j, done = carry
            p = cell_byte(i, j) & 3
            stop = p == PTR_STOP
            done_n = done | stop
            act = ~done_n
            is_d = act & (p == PTR_DIAG)
            is_u = act & (p == PTR_UP)
            is_l = act & (p == PTR_LEFT)
            op = jnp.where(
                is_d, OP_M, jnp.where(is_u, OP_I, jnp.where(is_l, OP_D, OP_PAD))
            ).astype(jnp.uint8)
            i = i - (is_d | is_u).astype(jnp.int32)
            j = j - (is_d | is_l).astype(jnp.int32)
            return (i, j, done_n), op

        (fi, fj, _), ops_rev = jax.lax.scan(
            tb_body, (start_i, start_j, done0), None, length=steps
        )
    else:
        ST_H, ST_E, ST_F = 0, 1, 2

        def tb_body(carry, _):
            i, j, st, done = carry
            byte = cell_byte(i, j)
            ph = (byte & 3).astype(jnp.int32)
            ext_e = ((byte >> _EXT_E_BIT) & 1).astype(bool)
            ext_f = ((byte >> _EXT_F_BIT) & 1).astype(bool)
            in_h = st == ST_H
            stop = in_h & (ph == PTR_STOP)
            done_n = done | stop
            act = ~done_n
            act_m = act & in_h & (ph == PTR_DIAG)
            act_i = act & ((in_h & (ph == PTR_UP)) | (st == ST_F))
            act_d = act & ((in_h & (ph == PTR_LEFT)) | (st == ST_E))
            op = jnp.where(
                act_m, OP_M, jnp.where(act_i, OP_I, jnp.where(act_d, OP_D, OP_PAD))
            ).astype(jnp.uint8)
            st_n = jnp.where(
                act_m,
                ST_H,
                jnp.where(
                    act_i,
                    jnp.where(ext_f, ST_F, ST_H),
                    jnp.where(act_d, jnp.where(ext_e, ST_E, ST_H), st),
                ),
            )
            i = i - (act_m | act_i).astype(jnp.int32)
            j = j - (act_m | act_d).astype(jnp.int32)
            return (i, j, st_n, done_n), op

        st0 = jnp.zeros((B,), jnp.int32)
        (fi, fj, _, _), ops_rev = jax.lax.scan(
            tb_body, (start_i, start_j, st0, done0), None, length=steps
        )
    return fi, fj, ops_rev


# Minus infinity of the tile body: dominates any reachable score and is
# safe from int32 overflow.
SP_NEG = -(1 << 28)


def tile_scan(qb, t, j0, H_top, F_top, Hcol0, Ecol0, cap0, *, C, i0, n, m,
              match, mismatch, o, e, table=None, want_ptr=False,
              local=False):
    """One R x C tile of the Gotoh fill — the per-device body of the
    sequence-parallel pipeline (parallel.band_pipeline), one pair at a time
    with the lanes along the tile's R rows.

    qb: (R,) block query letters.  t: full padded target (replicated).
    H_top/F_top: (C+1,)/(C,) top boundary rows (H includes the corner at
    index 0).  Hcol0/Ecol0: (R,) left boundary (H/E of column j0).
    Returns (bottom_H (C,), bottom_F (C,), Hcol' (R,), Ecol' (R,), cap');
    with want_ptr additionally a (R+C-1, R) uint8 array of packed
    per-cell pointers in anti-diagonal layout — cell (i0+p+1, j0+k-p+1)
    at [k, p] — packing PH (2b, oracle PTR_* codes) | EXT_E<<2 |
    EXT_F<<3 with the oracle's exact tie-breaks (_gotoh_fill: diag >
    up(F) > left(E); gap extend >= open).
    """
    R = qb.shape[0]
    lanes = jnp.arange(R)
    lane0 = lanes == 0
    lane_last = R - 1
    ivec = i0 + lanes + 1  # global DP row per lane
    Hcol0_up = jnp.roll(Hcol0, 1)  # Hcol0[p-1]; lane0 slot replaced below

    def substep(carry, k):
        H1, H2, E1, F1, W, Hcol_n, Ecol_n, cap = carry
        c = k - lanes + 1  # local column per lane
        at_c1 = c == 1
        # target letter at global column j0 + c (streamed via lane roll)
        W = jnp.where(lane0, t[j0 + k + 1], jnp.roll(W, 1))
        if table is None:
            s_vec = jnp.where(qb == W, match, mismatch)
        else:
            s_vec = table[qb, W]  # gather: parity-grade on the XLA body
        up_H = jnp.where(lane0, H_top[jnp.minimum(k + 1, C)], jnp.roll(H1, 1))
        up_F = jnp.where(lane0, F_top[jnp.minimum(k, C - 1)], jnp.roll(F1, 1))
        diag_H = jnp.where(
            lane0,
            H_top[jnp.minimum(k, C)],
            jnp.where(at_c1, Hcol0_up, jnp.roll(H2, 1)),
        )
        left_H = jnp.where(at_c1, Hcol0, H1)
        left_E = jnp.where(at_c1, Ecol0, E1)

        E_new = jnp.maximum(left_E + e, left_H + o + e)
        F_new = jnp.maximum(up_F + e, up_H + o + e)
        H_new = jnp.maximum(diag_H + s_vec, jnp.maximum(E_new, F_new))
        if local:
            # Smith-Waterman: clamp at 0.  Padded cells (i > n or j > m)
            # only feed cells further down/right, never valid ones, so
            # the in-matrix mask on the capture below suffices.
            H_new = jnp.maximum(H_new, 0)

        at_cC = c == C
        Hcol_n = jnp.where(at_cC, H_new, Hcol_n)
        Ecol_n = jnp.where(at_cC, E_new, Ecol_n)
        jvec = j0 + c
        # own-column guard: lanes keep running past the tile edge (c > C,
        # with clamped top-boundary reads), so only the tile that owns
        # column m may capture cell (n, m)
        if local:
            # local capture: the running max over every VALID cell
            hit = (ivec <= n) & (jvec <= m) & (c >= 1) & (c <= C)
        else:
            hit = (ivec == n) & (jvec == m) & (c >= 1) & (c <= C)
        cap = jnp.maximum(cap, jnp.max(jnp.where(hit, H_new, SP_NEG)))
        new_carry = (H_new, H1, E_new, F_new, W, Hcol_n, Ecol_n, cap)
        ys = (H_new[lane_last], F_new[lane_last])
        if want_ptr:
            # oracle-exact provenance (oracle._gotoh_fill): H's choice is
            # diag if it TIES the max, else F (up) if F ties, else E;
            # gap extension wins ties over re-opening
            dval = diag_H + s_vec
            ph = jnp.where(
                dval == H_new,
                PTR_DIAG,
                jnp.where(F_new == H_new, PTR_UP, PTR_LEFT),
            )
            exte = (left_E + e >= left_H + o + e).astype(jnp.uint8)
            extf = (up_F + e >= up_H + o + e).astype(jnp.uint8)
            ys = ys + ((ph.astype(jnp.uint8) | (exte << 2) | (extf << 3)),)
        return new_carry, ys

    init = (
        jnp.full((R,), SP_NEG, jnp.int32),  # H1
        jnp.full((R,), SP_NEG, jnp.int32),  # H2
        jnp.full((R,), SP_NEG, jnp.int32),  # E1
        jnp.full((R,), SP_NEG, jnp.int32),  # F1
        jnp.zeros((R,), jnp.int32),  # W
        Hcol0,
        Ecol0,
        cap0,
    )
    carry, ys = jax.lax.scan(
        substep, init, jnp.arange(R + C - 1, dtype=jnp.int32)
    )
    bot_H, bot_F = ys[0], ys[1]
    _, _, _, _, _, Hcol_n, Ecol_n, cap = carry
    out = (bot_H[R - 1 :], bot_F[R - 1 :], Hcol_n, Ecol_n, cap)
    if want_ptr:
        out = out + (ys[2],)
    return out


def _gather_window(x: jax.Array, start: jax.Array, length: jax.Array, sent: int):
    """(B, L) gather: out[b, k] = x[b, start[b]+k] for k < length[b], else
    the sentinel code.  Static output shape == input shape."""
    B, L = x.shape
    k = jnp.arange(L, dtype=jnp.int32)[None, :]
    idx = start[:, None].astype(jnp.int32) + k
    vals = jnp.take_along_axis(x.astype(jnp.int32), jnp.clip(idx, 0, L - 1), axis=1)
    return jnp.where(k < length[:, None], vals, sent)


def _gather_reversed(x: jax.Array, end: jax.Array, sent: int):
    """(B, L) gather: out[b, k] = x[b, end[b]-1-k] for k < end[b], else the
    sentinel code — the reversed prefix for the extension pass."""
    B, L = x.shape
    k = jnp.arange(L, dtype=jnp.int32)[None, :]
    idx = end[:, None].astype(jnp.int32) - 1 - k
    vals = jnp.take_along_axis(x.astype(jnp.int32), jnp.clip(idx, 0, L - 1), axis=1)
    return jnp.where(idx >= 0, vals, sent)


@functools.partial(
    jax.jit,
    static_argnames=(
        "mode",
        "gap_open",
        "gap_extend",
        "band",
        "affine",
        "want_tb",
    ),
)
def wavefront_bucket(
    q: jax.Array,  # (B, Lq) int32 codes, padded with any valid code
    t: jax.Array,  # (B, Lt) int32 codes
    qlen: jax.Array,  # (B,) int32 true lengths
    tlen: jax.Array,  # (B,) int32
    table: jax.Array,  # (A1, A1) int32 substitution, sentinel row/col = last
    *,
    mode: str,
    gap_open: int,
    gap_extend: int,
    band: Optional[int],
    affine: bool,
    want_tb: bool,
):
    """Run the wavefront DP over one padded bucket; returns result arrays.

    Returns dict with:
      score (B,) i32; qs/qe/ts/te (B,) i32;
      ops_rev (B, Lq+Lt) u8 traceback ops in end->start order, OP_PAD padded
      (only when want_tb).

    Local mode composes three fills (end, reverse-extension start, window
    CIGAR) entirely inside jit with static shapes, so the whole contract —
    including the mesh-sharded path — stays a single pure SPMD program.
    """
    B, Lq = q.shape
    Lt = t.shape[1]
    n, m = Lq, Lt
    A1 = table.shape[0]
    SENT = A1 - 1
    kw = dict(gap_open=gap_open, gap_extend=gap_extend, affine=affine)

    if mode == "global":
        res = _scan_fill(
            q, t, qlen, tlen, table, kind="global", band=band, want_tb=want_tb, **kw
        )
        score = res["score"]
        out = {
            "score": score,
            "qs": jnp.zeros_like(score),
            "qe": qlen.astype(jnp.int32),
            "ts": jnp.zeros_like(score),
            "te": tlen.astype(jnp.int32),
        }
        if want_tb:
            fi, fj, ops_rev = _global_walk(
                res["P"],
                qlen.astype(jnp.int32),
                tlen.astype(jnp.int32),
                jnp.zeros((B,), bool),
                affine=affine,
                B=B,
                N1=n + 1,
                steps=n + m,
            )
            out["ops_rev"] = ops_rev.T  # (B, n+m), end->start order
        return out

    if mode != "local":
        raise ValueError(f"unknown mode {mode!r}")
    if band is not None:
        raise ValueError("banded local alignment is out of contract")

    # ---- pass 1: local fill, canonical end --------------------------------
    p1 = _scan_fill(
        q, t, qlen, tlen, table, kind="local", band=None, want_tb=False, **kw
    )
    score, qe, te = p1["score"], p1["bi"], p1["bj"]

    # ---- pass 2: anchored reverse extension, canonical start --------------
    qr = _gather_reversed(q, qe, SENT)
    tr = _gather_reversed(t, te, SENT)
    p2 = _scan_fill(
        qr, tr, qe, te, table, kind="extension", band=None, want_tb=False, **kw
    )
    # the extension max equals the local score by construction; its first-max
    # cell (ri, rj) maps to the canonical start (qe - ri, te - rj).
    qs = qe - p2["bi"]
    ts = te - p2["bj"]
    empty = score <= 0
    qs = jnp.where(empty, 0, qs)
    ts = jnp.where(empty, 0, ts)

    out = {"score": score, "qs": qs, "qe": qe, "ts": ts, "te": te}
    if not want_tb:
        return out

    # ---- pass 3: canonical CIGAR = global walk of the window --------------
    qw = _gather_window(q, qs, qe - qs, SENT)
    tw = _gather_window(t, ts, te - ts, SENT)
    p3 = _scan_fill(
        qw, tw, qe - qs, te - ts, table, kind="global", band=None, want_tb=True, **kw
    )
    _, _, ops_rev = _global_walk(
        p3["P"],
        (qe - qs).astype(jnp.int32),
        (te - ts).astype(jnp.int32),
        empty,
        affine=affine,
        B=B,
        N1=n + 1,
        steps=n + m,
    )
    out["ops_rev"] = ops_rev.T
    return out
