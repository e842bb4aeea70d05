"""CIGAR codec.

The reference returns an explicit aligned-pair container (``AlignedSequence``
with Blank-sentinel gap entries; SURVEY.md §2.1).  This engine's compact
equivalent is a CIGAR string plus coordinates (BASELINE.json:2,5): M = both
consumed (match or mismatch), I = query consumed (gap in target), D = target
consumed (gap in query) — SAM semantics with query=rows, target=reference.

Device-side tracebacks emit fixed-width int8 op arrays (op codes below,
padded with OP_PAD); this module run-length-encodes them to strings and back.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

OP_M = 0
OP_I = 1
OP_D = 2
OP_PAD = 255

OP_CHARS = "MID"
_CHAR_TO_OP = {c: i for i, c in enumerate(OP_CHARS)}


def ops_to_cigar(ops: Sequence[int]) -> str:
    """Run-length-encode a sequence of op codes (query-to-target order)."""
    out: List[str] = []
    run_op = -1
    run_len = 0
    for op in ops:
        op = int(op)
        if op == OP_PAD:
            break
        if op == run_op:
            run_len += 1
        else:
            if run_len:
                out.append(f"{run_len}{OP_CHARS[run_op]}")
            run_op = op
            run_len = 1
    if run_len:
        out.append(f"{run_len}{OP_CHARS[run_op]}")
    return "".join(out)


def cigar_to_ops(cigar: str) -> List[int]:
    ops: List[int] = []
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + int(ch)
        else:
            if ch not in _CHAR_TO_OP or num == 0:
                raise ValueError(f"bad CIGAR {cigar!r}")
            ops.extend([_CHAR_TO_OP[ch]] * num)
            num = 0
    if num:
        raise ValueError(f"trailing count in CIGAR {cigar!r}")
    return ops


def cigar_consumed(cigar: str) -> Tuple[int, int]:
    """(query_consumed, target_consumed) lengths implied by a CIGAR."""
    q = t = 0
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + int(ch)
        else:
            if ch == "M":
                q += num
                t += num
            elif ch == "I":
                q += num
            elif ch == "D":
                t += num
            else:
                raise ValueError(f"bad CIGAR op {ch!r}")
            num = 0
    return q, t


def transpose_cigar(cigar: str) -> str:
    """CIGAR of the alignment with query and target swapped (I <-> D)."""
    return cigar.translate(str.maketrans("ID", "DI"))


def ops_batch_to_cigars(ops: np.ndarray) -> List[str]:
    """Decode a (B, L) int array of padded op codes to B CIGAR strings."""
    ops = np.asarray(ops)
    return [ops_to_cigar(row) for row in ops]
