"""CLI surface (`python -m seqalib.cli`) smoke + parity tests.

Oracle backend only: instant, no kernel compiles; the device backends'
correctness is covered by the parity suites.
"""

import json

import pytest

from seqalib.cli import main
from seqalib.oracle import align_oracle
from seqalib.types import ScoringParams, encode_dna, encode_protein


@pytest.fixture(autouse=True)
def _no_compile_cache(monkeypatch, tmp_path):
    """main() enables the persistent compile cache unless this variable is
    set; set it so the tests leave the process's cache config alone."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))


def _run_align(capsys, *argv):
    assert main(["align", *argv, "--backend", "oracle"]) == 0
    return json.loads(capsys.readouterr().out.strip())

def test_cli_align_global_dna(capsys):
    out = _run_align(capsys, "ACGTACGT", "ACGACGT")
    ref = align_oracle(
        encode_dna("ACGTACGT"),
        encode_dna("ACGACGT"),
        ScoringParams(match=2, mismatch=-3, gap_open=0, gap_extend=-2),
        mode="global",
    )
    assert out["score"] == ref.score
    assert out["cigar"] == ref.cigar


def test_cli_align_local_blosum62(capsys):
    out = _run_align(
        capsys,
        "HEAGAWGHEE",
        "PAWHEAE",
        "--mode", "local", "--blosum62", "--gap-open", "-10", "--gap-extend", "-1",
    )
    ref = align_oracle(
        encode_protein("HEAGAWGHEE"),
        encode_protein("PAWHEAE"),
        ScoringParams.blosum62(gap_open=-10, gap_extend=-1),
        mode="local",
    )
    assert out["score"] == ref.score
    assert (out["query_start"], out["query_end"]) == (ref.query_start, ref.query_end)
    assert out["cigar"] == ref.cigar


def test_cli_align_banded(capsys):
    out = _run_align(
        capsys, "ACGTACGTACGT", "ACGTACGAACGT", "--band", "4",
        "--gap-open", "-5",
    )
    ref = align_oracle(
        encode_dna("ACGTACGTACGT"),
        encode_dna("ACGTACGAACGT"),
        ScoringParams(match=2, mismatch=-3, gap_open=-5, gap_extend=-2),
        mode="global",
        band=4,
    )
    assert out["score"] == ref.score


def test_cli_rejects_bad_mode():
    with pytest.raises(SystemExit):
        main(["align", "A", "A", "--mode", "sideways"])


@pytest.mark.parametrize("cmd", [["align", "A", "A"], ["bench", "1"]])
def test_cli_rejects_removed_backend(cmd, capsys):
    with pytest.raises(SystemExit):
        main([*cmd, "--backend", "pallas"])
    assert "oracle, xla" in capsys.readouterr().err


def test_cli_bench_config1_xla_parity(capsys):
    """cmd_bench end-to-end on CPU: config 1 (NW global + traceback) with
    the full parity gate on the xla backend, tiny pairs."""
    rc = main([
        "bench", "1", "--pairs", "6", "--backend", "xla",
        "--parity-check", "--parity-pairs", "6",
    ])
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 0
    assert out["config"] == 1 and out["parity_ok"] is True
    assert out["pairs"] == 6 and out["pairs_per_sec"] > 0


def test_cli_bench_config4_banded_parity(capsys):
    """cmd_bench config 4 (banded long reads) at test scale with the
    oracle-truncated banded parity gate, on the default device engine."""
    rc = main([
        "bench", "4", "--pairs", "8", "--long-len", "600", "--band", "32",
        "--parity-check", "--parity-pairs", "1",
    ])
    out = json.loads(capsys.readouterr().out.strip())
    assert rc == 0
    assert out["config"] == 4 and out["parity_ok"] is True
