"""Public alignment API.

``align``: one pair.  ``align_batch``: many pairs through the bucketed
dispatcher (SURVEY.md §3.2).  Sequences may be strings (DNA by default,
protein when the scoring uses a substitution matrix sized for proteins)
or pre-encoded uint8 code arrays.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .types import (
    PROTEIN_SIZE,
    AlignConfig,
    AlignResult,
    ScoringParams,
    check_backend,
    encode_dna,
    encode_protein,
)


def _coerce(seq, sp: ScoringParams) -> np.ndarray:
    if isinstance(seq, np.ndarray):
        if seq.dtype != np.uint8:
            return seq.astype(np.uint8)
        return seq
    if sp.matrix is not None and sp.matrix.shape[0] >= PROTEIN_SIZE:
        return encode_protein(seq)
    return encode_dna(seq)


def align(
    query,
    target,
    scoring: Optional[ScoringParams] = None,
    mode: str = "global",
    band: Optional[int] = None,
    backend: str = "xla",
) -> AlignResult:
    """Align one query/target pair and return score, coords, CIGAR."""
    sp = scoring if scoring is not None else ScoringParams.linear()
    if band is not None and mode == "local":
        raise ValueError(
            "banded local alignment is out of contract: band= applies to "
            'mode="global" only (BASELINE.json:10 is banded affine NW)'
        )
    cfg = AlignConfig(mode=mode, band=band, backend=backend)
    q = _coerce(query, sp)
    t = _coerce(target, sp)

    if cfg.backend == "oracle":
        from .oracle import align_oracle

        return align_oracle(q, t, sp, mode=cfg.mode, band=cfg.band)

    return align_batch(
        [q], [t], scoring=sp, mode=cfg.mode, band=cfg.band, backend=cfg.backend
    )[0]


def align_batch(
    queries: Sequence,
    targets: Sequence,
    scoring: Optional[ScoringParams] = None,
    mode: str = "local",
    band: Optional[int] = None,
    backend: str = "xla",
    traceback: bool = True,
    mesh=None,
) -> List[AlignResult]:
    """Align pairs[i] = (queries[i], targets[i]) through the batched
    length-bucketed dispatcher (device-parallel when a mesh is given).

    ``band`` runs the full-matrix engine with out-of-band cells masked:
    exact, O(n*m) work.  With ``traceback`` a bucket is split into
    launches whose pointer stash fits the device's memory; a pair too
    large on its own raises ValueError."""
    if band is not None and mode == "local":
        # one behavior for every backend
        raise ValueError(
            "banded local alignment is out of contract: band= applies to "
            'mode="global" only (BASELINE.json:10 is banded affine NW)'
        )
    check_backend(backend)
    sp = scoring if scoring is not None else ScoringParams.linear()
    qs = [_coerce(q, sp) for q in queries]
    ts = [_coerce(t, sp) for t in targets]
    if len(qs) != len(ts):
        raise ValueError("queries and targets must have equal length")

    if backend == "oracle":
        from .oracle import align_oracle

        return [align_oracle(q, t, sp, mode=mode, band=band) for q, t in zip(qs, ts)]

    from .parallel.dispatch import dispatch_batch

    return dispatch_batch(
        qs,
        ts,
        sp,
        mode=mode,
        band=band,
        traceback=traceback,
        mesh=mesh,
    )


def _avall_key(qs, rs, chunk_pairs: int, sp: ScoringParams, mode: str) -> str:
    """Content key for resume shards: inputs, chunking, scoring, and mode
    must all match (backend is deliberately excluded — all backends are
    bit-exact by contract, so shards are interchangeable across them)."""
    import hashlib

    h = hashlib.blake2b(digest_size=16)
    h.update(
        str(
            (
                "avall-v2-grouped",  # chunk layout version: bucket-grouped
                len(qs),
                len(rs),
                chunk_pairs,
                mode,
                sp.match,
                sp.mismatch,
                sp.gap_open,
                sp.gap_extend,
            )
        ).encode()
    )
    if sp.matrix is not None:
        h.update(np.asarray(sp.matrix).tobytes())
    h.update(b"#")
    for s in qs:
        h.update(s.tobytes())
        h.update(b"|")
    h.update(b"#")
    for s in rs:
        h.update(s.tobytes())
        h.update(b"|")
    return h.hexdigest()


def align_all_vs_all(
    queries: Sequence,
    references: Sequence,
    scoring: Optional[ScoringParams] = None,
    mode: str = "local",
    backend: str = "xla",
    mesh=None,
    chunk_pairs: int = 4096,
    resume_dir: Optional[str] = None,
):
    """All-vs-all alignment (BASELINE.json config 5): every query against
    every reference, streamed through the bucketed dispatcher in chunks
    (optionally shard_map'ed over a device mesh).

    Returns a dict of (n_queries, n_references) int32 arrays:
    score, qs, qe, ts, te.  Tracebacks are deliberately excluded at this
    scale; realign the hits you care about with `align`.

    ``resume_dir``: checkpoint/resume at chunk granularity (SURVEY.md §5
    "Checkpoint/resume": the unit of work is deterministic and
    idempotent, so recovery = skip completed result shards).  Each chunk
    writes ``chunk_NNNNNN.npz`` atomically (tmp + rename); a rerun with
    the same inputs and chunking loads finished shards instead of
    realigning them.

    Scale notes (contract scale = 10k x 1k = 10M pairs, BASELINE.json:11):
    both sides are padded into per-bucket matrices ONCE and each chunk is
    a vectorized row-gather of the cross product — no per-pair Python
    objects anywhere on the hot path (10M AlignResult constructions cost
    more than the kernels).  The dense output dict is 5 x nq x nr int32 =
    20 bytes/pair host RAM (200 MB at contract scale); beyond ~100M pairs
    stream the per-chunk shards to disk via ``resume_dir`` and reduce
    them instead of materializing `out`.
    """
    import logging
    import os

    import numpy as np

    log = logging.getLogger("seqalib.api")

    check_backend(backend)
    if backend == "oracle":
        raise ValueError(
            "align_all_vs_all runs on the device engine (backend='xla'); "
            "use align_batch(backend='oracle') for reference results"
        )
    sp = scoring if scoring is not None else ScoringParams.linear()
    qs = [_coerce(q, sp) for q in queries]
    rs = [_coerce(r, sp) for r in references]
    nq, nr = len(qs), len(rs)
    fields = ("score", "qs", "qe", "ts", "te")
    out = {f: np.zeros((nq, nr), np.int32) for f in fields}
    key = ""
    if resume_dir is not None:
        os.makedirs(resume_dir, exist_ok=True)
        key = _avall_key(qs, rs, chunk_pairs, sp, mode)

    from .parallel.dispatch import _pad_stack, bucket_len, run_bucket

    def _groups(seqs):
        g = {}
        for i, s in enumerate(seqs):
            g.setdefault(bucket_len(len(s)), []).append(i)
        return {
            bl: (
                np.asarray(idx, np.int64),
                _pad_stack([seqs[i] for i in idx], bl),
                np.asarray([len(seqs[i]) for i in idx], np.int32),
            )
            for bl, idx in sorted(g.items())
        }

    qg = _groups(qs)
    rg = _groups(rs)

    ci = 0
    resumed = 0
    pending = None  # in-flight chunk: (finalize, n_valid, ii, jj, shard)

    def _collect(p):
        fin, nflat, ii_, jj_, shard_ = p
        res = fin()
        vals = {f: np.asarray(res[f][:nflat], np.int32) for f in fields}
        for f in fields:
            out[f][ii_, jj_] = vals[f]
        if shard_ is not None:
            tmp = shard_ + ".tmp.npz"
            np.savez(tmp, n=np.int64(nflat), key=key, ii=ii_, jj=jj_, **vals)
            os.replace(tmp, shard_)
    for qbl, (qidx, Qmat, qleng) in qg.items():
        for rbl, (ridx, Rmat, rleng) in rg.items():
            NRg = len(ridx)
            total = len(qidx) * NRg
            for lo in range(0, total, chunk_pairs):
                hi = min(lo + chunk_pairs, total)
                shard = (
                    os.path.join(resume_dir, f"chunk_{ci:06d}.npz")
                    if resume_dir is not None
                    else None
                )
                ci += 1
                flat = np.arange(lo, hi, dtype=np.int64)
                ai = flat // NRg
                bj = flat % NRg
                ii = qidx[ai]
                jj = ridx[bj]
                if shard is not None and os.path.exists(shard):
                    vals = np.load(shard)
                    kv = str(vals["key"]) if "key" in vals.files else ""
                    # a shard passing the key check is this layout version
                    # and ALWAYS stores its own index vectors — loading a
                    # shard without them under the bucket-grouped chunk
                    # order would scatter results to the wrong pairs
                    if (
                        int(vals["n"]) == len(flat)
                        and kv == key
                        and "ii" in vals.files
                        and "jj" in vals.files
                    ):
                        si = vals["ii"]
                        sj = vals["jj"]
                        for f in fields:
                            out[f][si, sj] = vals[f]
                        resumed += 1
                        continue
                    log.warning(
                        "resume shard %s is stale (inputs or chunking "
                        "changed); recomputing",
                        shard,
                    )
                Qc, Rc = Qmat[ai], Rmat[bj]
                qlc, rlc = qleng[ai], rleng[bj]
                # tail-chunk shape pinning: when this bucket pair spans
                # multiple chunks, pad the tail to the FULL chunk row
                # count — a distinct tail batch shape would compile its
                # own program; the zero-length sentinel rows are masked
                # in the fill and skipped in result writes
                if total > chunk_pairs:
                    pad_rows = chunk_pairs
                else:
                    # single-chunk bucket pairs round up to the next
                    # power of two (capped at chunk_pairs): a bounded
                    # shape set instead of one compile per batch size
                    pad_rows = 8
                    while pad_rows < len(flat):
                        pad_rows *= 2
                    pad_rows = min(pad_rows, chunk_pairs)
                if mesh is not None:
                    # zero-length sentinel tail: the sharded paths need the
                    # batch divisible by the mesh axis (dispatch_batch's
                    # pad_batch_to, kept here since we bypass it)
                    from .parallel.dist import PAIR_AXIS

                    pad_rows += (-pad_rows) % mesh.shape[PAIR_AXIS]
                padn = pad_rows - len(flat)
                if padn:
                    Qc = np.concatenate(
                        [Qc, np.zeros((padn, Qc.shape[1]), Qc.dtype)]
                    )
                    Rc = np.concatenate(
                        [Rc, np.zeros((padn, Rc.shape[1]), Rc.dtype)]
                    )
                    qlc = np.concatenate([qlc, np.zeros(padn, np.int32)])
                    rlc = np.concatenate([rlc, np.zeros(padn, np.int32)])
                fin = run_bucket(
                    Qc,
                    Rc,
                    qlc,
                    rlc,
                    sp,
                    mode,
                    None,
                    False,
                    mesh=mesh,
                    launch_only=True,
                )
                # one-chunk lookahead: this chunk's device work is in
                # flight; finalize the PREVIOUS chunk now so its
                # gather/assembly overlaps with this one's compute and
                # the next iteration's host prep overlaps with this
                # one's transfer (JAX dispatch is async)
                if pending is not None:
                    _collect(pending)
                pending = (fin, len(flat), ii, jj, shard)
    if pending is not None:
        _collect(pending)
    if resumed:
        log.info("align_all_vs_all resumed %d finished chunk shards", resumed)
    return out
