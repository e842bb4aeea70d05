#!/usr/bin/env python
"""Device-engine benchmark: GCUPS of batched 1 kb affine-gap Smith-Waterman
with start/end coordinates (config-3 style: BLOSUM62 protein, gap -10/-1),
B=512 pairs in one (1024, 1024) bucket through ``ops.wavefront_xla``.

    python bench.py        # BENCH_B, BENCH_L, BENCH_REPS override sizes

Runs only on a GPU.  Warm-up (compile) first, then ``BENCH_REPS`` timed
calls, each ending in ``block_until_ready``; the reported value is the
median.  Eight pairs of the timed bucket are checked against the oracle.
Prints the card line, then ONE JSON line.
"""

import json
import os
import statistics
import sys
import time

import numpy as np


def main() -> int:
    from seqalib.utils.compile_cache import use_compile_cache
    from seqalib.utils.device import card_line, require_gpu

    dev = require_gpu()
    use_compile_cache()
    import jax
    import jax.numpy as jnp

    from seqalib import ScoringParams
    from seqalib.ops.wavefront_xla import wavefront_bucket
    from seqalib.oracle_fast import sw_affine
    from seqalib.parallel.dispatch import sentinel_table

    B = int(os.environ.get("BENCH_B", "512"))
    L = int(os.environ.get("BENCH_L", "1024"))
    reps = int(os.environ.get("BENCH_REPS", "9"))
    card = card_line()
    print(f"card: {card}", flush=True)

    sp = ScoringParams.blosum62()
    rng = np.random.default_rng(0)
    q = rng.integers(0, 20, size=(B, L)).astype(np.int32)
    t = rng.integers(0, 20, size=(B, L)).astype(np.int32)
    lens = np.full(B, L, np.int32)
    args = [jnp.asarray(a) for a in (q, t, lens, lens, sentinel_table(sp))]

    def run():
        return jax.block_until_ready(
            wavefront_bucket(
                *args, mode="local", gap_open=sp.gap_open,
                gap_extend=sp.gap_extend, band=None, affine=True,
                want_tb=False,
            )
        )

    t0 = time.perf_counter()
    out = run()
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    per_call = statistics.median(times)

    bad = 0
    for b in range(8):
        ref = sw_affine(q[b], t[b], sp)
        got = tuple(int(out[k][b]) for k in ("score", "qs", "qe", "ts", "te"))
        bad += got != (ref.score, ref.query_start, ref.query_end,
                       ref.target_start, ref.target_end)
    print(
        json.dumps(
            {
                "metric": f"GCUPS sw-affine-blosum62-{L}x{L} B={B} "
                "coords=start+end engine=wavefront_xla",
                "value": B * L * L / per_call / 1e9,
                "unit": "GCUPS",
                "median_s": per_call,
                "min_s": min(times),
                "max_s": max(times),
                "reps": reps,
                "compile_s": compile_s,
                "parity_pairs": 8,
                "mismatches": bad,
                "device": {"platform": dev.platform, "kind": dev.device_kind,
                           "count": len(jax.devices())},
                "card": card,
            }
        )
    )
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
