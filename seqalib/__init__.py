"""seqalib — batched pairwise sequence alignment on an accelerator.

A from-scratch re-design of the capabilities of ``przemektmalon/SeqALib``
(Needleman-Wunsch global, Smith-Waterman local, Gotoh affine-gap, banded
alignment, full CIGAR traceback; SURVEY.md §2) as JAX programs: an
anti-diagonal wavefront DP engine compiled by XLA, a length-bucketing
batch dispatcher, and shard_map parallelism over device meshes, both over
the pair stream and within one long pair.
"""

from .types import (  # noqa: F401
    BLOSUM62,
    DNA_ALPHABET,
    NEG_INF,
    PROTEIN_ALPHABET,
    AlignConfig,
    AlignResult,
    ScoringParams,
    decode_dna,
    decode_protein,
    encode_dna,
    encode_protein,
)

__version__ = "0.3.0"


def align(query, target, scoring=None, mode="global", band=None, backend="xla"):
    """Align one pair. Thin convenience wrapper; see `seqalib.api`."""
    from .api import align as _align

    return _align(query, target, scoring=scoring, mode=mode, band=band, backend=backend)


def align_batch(queries, targets, scoring=None, mode="global", backend="xla", **kw):
    """Align many pairs (length-bucketed, device-batched). See `seqalib.api`."""
    from .api import align_batch as _align_batch

    return _align_batch(
        queries, targets, scoring=scoring, mode=mode, backend=backend, **kw
    )


def align_all_vs_all(queries, references, **kw):
    """Every query vs every reference (config 5). See `seqalib.api`."""
    from .api import align_all_vs_all as _ava

    return _ava(queries, references, **kw)


def align_score_sp(query, target, scoring, mesh, mode="global", **kw):
    """Affine score of ONE long pair computed cooperatively by every
    device on ``mesh``'s 'band' axis (sequence parallelism — row-block x
    column-tile pipeline with ppermute boundary streaming).  ``mode``:
    "global" (NW) or "local" (SW).  See
    `seqalib.parallel.band_pipeline.nw_affine_score_sp` /
    `sw_affine_score_sp`."""
    from .parallel.band_pipeline import nw_affine_score_sp, sw_affine_score_sp

    if mode == "local":
        return sw_affine_score_sp(query, target, scoring, mesh, **kw)
    if mode != "global":
        raise ValueError(f"mode must be 'global' or 'local', got {mode!r}")
    return nw_affine_score_sp(query, target, scoring, mesh, **kw)


def align_sp(query, target, scoring, mesh, **kw):
    """Global affine alignment (score + full CIGAR) of ONE long pair over
    ``mesh``'s 'band' axis: SP pipeline fill with boundary checkpointing,
    then a traceback that recomputes only the pointer tiles the optimal
    path visits.  See
    `seqalib.parallel.band_pipeline.nw_affine_align_sp`."""
    from .parallel.band_pipeline import nw_affine_align_sp

    return nw_affine_align_sp(query, target, scoring, mesh, **kw)
