#!/usr/bin/env python
"""Run the alignment engine's main paths once, compiled on one GPU, and
check every result class against the oracle.

    python chip_smoke.py            # configs 1-5 on the first GPU
    python chip_smoke.py --quick    # the same widths, few pairs, plus
                                    # compiled.memory_analysis() per config
    python chip_smoke.py --four     # only the multi-device paths, 4 GPUs

Every phase goes through the public ``align_batch`` / ``align_all_vs_all``
(``align_sp`` under ``--four``), prints one JSON line with its cold
(compile included) and warm wall time and its oracle mismatch count, and
the run fails unless every phase matches.  The last line of a passing run
is ``{"ok": true, "device": {...}}``; a run without a GPU exits non-zero
before any phase.  All phases share this one process.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from seqalib import ScoringParams, align_all_vs_all, align_batch, align_sp
from seqalib.cli import long_read_pairs, synth_pairs
from seqalib.oracle_fast import align_oracle, nw_affine

DNA_LINEAR = ScoringParams(match=2, mismatch=-3, gap_open=0, gap_extend=-2)
DNA_AFFINE = ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2)
PROTEIN = ScoringParams.blosum62()


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _fields(r, traceback):
    out = (r.score, r.query_start, r.query_end, r.target_start, r.target_end)
    return out + (r.cigar,) if traceback else out


def _mismatches(got, qs, ts, sp, mode, band, traceback) -> int:
    bad = 0
    for g, q, t in zip(got, qs, ts):
        ref = align_oracle(q, t, sp, mode=mode, band=band)
        bad += _fields(g, traceback) != _fields(ref, traceback)
    return bad


def _batch_phase(name, qs, ts, sp, mode, band, traceback, parity):
    """Cold and warm align_batch over (qs, ts); parity over ``parity``
    pairs, aligned on the same path."""

    def run():
        return align_batch(
            qs, ts, scoring=sp, mode=mode, band=band, traceback=traceback
        )

    _, cold = _timed(run)
    _, warm = _timed(run)
    pq, pt = parity
    got = align_batch(
        pq, pt, scoring=sp, mode=mode, band=band, traceback=traceback
    )
    return {
        "phase": name,
        "pairs": len(qs),
        "cold_s": cold,
        "warm_s": warm,
        "parity_pairs": len(pq),
        "mismatches": _mismatches(got, pq, pt, sp, mode, band, traceback),
    }


def config1(n_pairs=1024, length=256, n_check=32, seed=1):
    """NW global, linear gaps, DNA pairs of ``length`` bp, full CIGAR."""
    rng = np.random.default_rng(seed)
    qs = [rng.integers(0, 4, length).astype(np.uint8) for _ in range(n_pairs)]
    ts = [rng.integers(0, 4, length).astype(np.uint8) for _ in range(n_pairs)]
    par = (qs[:n_check], ts[:n_check])
    return _batch_phase("config1", qs, ts, DNA_LINEAR, "global", None, True, par)


def config2(n_pairs=512, length=1024, n_check=32, seed=2):
    """SW local, linear gaps, DNA pairs up to ``length`` bp, coordinates."""
    qs, ts = synth_pairs(np.random.default_rng(seed), n_pairs, length, length, 4)
    par = (qs[:n_check], ts[:n_check])
    return _batch_phase("config2", qs, ts, DNA_LINEAR, "local", None, False, par)


def config3(n_pairs=512, length=1024, n_check=32, seed=3):
    """SW local, affine gaps, BLOSUM62 protein pairs up to ``length``
    residues, full CIGAR."""
    qs, ts = synth_pairs(np.random.default_rng(seed), n_pairs, length, length, 20)
    par = (qs[:n_check], ts[:n_check])
    return _batch_phase("config3", qs, ts, PROTEIN, "local", None, True, par)


def config4(n_pairs=8, length=10000, band=128, window=1024, n_check=32,
            seed=4):
    """Banded affine NW long reads of ``length`` bp, full CIGAR.  Parity
    runs the same path on ``window``-bp slices of those reads (the oracle
    is quadratic), as ``cli bench --parity-check`` does."""
    qs, ts = long_read_pairs(np.random.default_rng(seed), n_pairs, length)
    pq, pt = [], []
    step = max(1, (length - window - band) // max(1, n_check // n_pairs))
    for k in range(n_check):
        i, lo = k % n_pairs, (k // n_pairs) * step
        pq.append(qs[i][lo : lo + window])
        pt.append(ts[i][lo : lo + window + band // 2])
    return _batch_phase(
        "config4", qs, ts, DNA_AFFINE, "global", band, True, (pq, pt)
    )


def config5(n_reads=2000, n_refs=200, read_len=256, ref_len=1024,
            n_check=32, seed=5, devices=None, name="config5"):
    """All-vs-all SW (linear gaps, coordinates) of reads against references
    through ``align_all_vs_all`` on a pair mesh over ``devices`` (default:
    the first device).  Returns (phase record, output arrays)."""
    import jax

    from seqalib.parallel.dist import make_pair_mesh

    rng = np.random.default_rng(seed)
    reads, _ = synth_pairs(rng, n_reads, read_len, read_len, 4)
    refs, _ = synth_pairs(rng, n_refs, ref_len, ref_len, 4)
    mesh = make_pair_mesh(devices if devices is not None else jax.devices()[:1])

    def run():
        return align_all_vs_all(
            reads, refs, scoring=DNA_LINEAR, mode="local", mesh=mesh
        )

    _, cold = _timed(run)
    out, warm = _timed(run)
    bad = 0
    for _ in range(n_check):
        i, j = int(rng.integers(n_reads)), int(rng.integers(n_refs))
        ref = align_oracle(reads[i], refs[j], DNA_LINEAR, mode="local")
        got = tuple(int(out[f][i, j]) for f in ("score", "qs", "qe", "ts", "te"))
        bad += got != (ref.score, ref.query_start, ref.query_end,
                       ref.target_start, ref.target_end)
    rec = {
        "phase": name,
        "pairs": n_reads * n_refs,
        "devices": len(mesh.devices.flat),
        "cold_s": cold,
        "warm_s": warm,
        "parity_pairs": n_check,
        "mismatches": bad,
    }
    return rec, out


def shard_placement(devices) -> int:
    """Number of distinct devices holding shards of one pair-sharded
    engine launch over ``devices``."""
    from seqalib.parallel.dispatch import sentinel_table
    from seqalib.parallel.dist import make_pair_mesh, wavefront_sharded

    B, L = 2 * len(devices), 32
    x = np.zeros((B, L), np.int32)
    lens = np.full(B, L, np.int32)
    out = wavefront_sharded(
        make_pair_mesh(devices), x, x, lens, lens, sentinel_table(DNA_LINEAR),
        mode="local", gap_open=0, gap_extend=-2, band=None, affine=False,
        want_tb=False,
    )
    return len({s.device for s in out["score"].addressable_shards})


def sp_phase(devices, length=8192, C=128, seed=6):
    """``align_sp`` of one long affine pair over a 'band' mesh of
    ``devices``, against the oracle."""
    from seqalib.parallel.band_pipeline import make_band_mesh

    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, length).astype(np.uint8)
    t = q.copy()
    idx = rng.choice(length, length // 50, replace=False)
    t[idx] = (t[idx] + 1) % 4
    t = np.delete(t, rng.choice(length, length // 200, replace=False))
    mesh = make_band_mesh(devices)
    got, cold = _timed(lambda: align_sp(q, t, DNA_AFFINE, mesh, C=C))
    _, warm = _timed(lambda: align_sp(q, t, DNA_AFFINE, mesh, C=C))
    ref = nw_affine(q, t, DNA_AFFINE)
    return {
        "phase": "align_sp",
        "pairs": 1,
        "length": length,
        "devices": len(devices),
        "cold_s": cold,
        "warm_s": warm,
        "parity_pairs": 1,
        "mismatches": int(str(got) != str(ref)),
    }


def memory_report(B, Lq, Lt, sp, mode, band, traceback) -> str:
    """compiled.memory_analysis() of the engine program for one bucket."""
    import jax
    import jax.numpy as jnp

    from seqalib.ops.wavefront_xla import wavefront_bucket
    from seqalib.parallel.dispatch import sentinel_table

    def s(*shape):
        return jax.ShapeDtypeStruct(shape, jnp.int32)

    compiled = wavefront_bucket.trace(
        s(B, Lq), s(B, Lt), s(B), s(B), jnp.asarray(sentinel_table(sp)),
        mode=mode, gap_open=sp.gap_open, gap_extend=sp.gap_extend, band=band,
        affine=sp.is_affine or band is not None, want_tb=traceback,
    ).lower().compile()
    return str(compiled.memory_analysis())


def result_line(devices) -> str:
    """The last line of a passing run."""
    d = devices[0]
    return json.dumps(
        {"ok": True,
         "device": {"platform": d.platform, "kind": d.device_kind,
                    "count": len(devices)}}
    )


def _emit(rec):
    print(json.dumps(rec), flush=True)
    return rec["mismatches"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--quick", action="store_true",
                      help="few pairs at the full widths, and each config's "
                      "compiled memory analysis")
    mode.add_argument("--four", action="store_true",
                      help="only the paths across four GPUs")
    args = ap.parse_args(argv)

    from seqalib.utils.compile_cache import use_compile_cache
    from seqalib.utils.device import card_line, require_gpu

    require_gpu()
    import jax

    use_compile_cache()
    print(f"card: {card_line()}", flush=True)
    bad = 0
    if args.four:
        devs = jax.devices()
        if len(devs) < 4:
            raise SystemExit(f"--four needs 4 GPUs, found {len(devs)}")
        devs = devs[:4]
        placed = shard_placement(devs)
        print(json.dumps({"phase": "shard_placement", "devices": placed}),
              flush=True)
        bad += placed != 4
        one, out1 = config5(devices=devs[:1], name="config5_1dev")
        bad += _emit(one)
        four, out4 = config5(devices=devs, name="config5_4dev")
        four["identical_to_1dev"] = all(
            np.array_equal(out1[f], out4[f]) for f in out1
        )
        bad += _emit(four) + (not four["identical_to_1dev"])
        bad += _emit(sp_phase(devs))
    else:
        if args.quick:
            for name, shape in (
                ("config1", (1024, 256, 256, DNA_LINEAR, "global", None, True)),
                ("config2", (32, 1024, 1024, DNA_LINEAR, "local", None, False)),
                ("config3", (32, 1024, 1024, PROTEIN, "local", None, True)),
                ("config4", (8, 10112, 10112, DNA_AFFINE, "global", 128, True)),
                ("config5", (4096, 256, 1024, DNA_LINEAR, "local", None, False)),
            ):
                print(f"{name} memory: {memory_report(*shape)}", flush=True)
            n = dict(n_pairs=32)
            bad += _emit(config1(**n))
            bad += _emit(config2(**n))
            bad += _emit(config3(**n))
            bad += _emit(config4(n_pairs=8))
            bad += _emit(config5(n_reads=64, n_refs=8)[0])
        else:
            bad += _emit(config1())
            bad += _emit(config2())
            bad += _emit(config3())
            bad += _emit(config4())
            bad += _emit(config5()[0])
        devs = jax.devices()
    if bad:
        print(f"FAILED: {bad} mismatching phase results", file=sys.stderr)
        return 1
    print(result_line(devs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
