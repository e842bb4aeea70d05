"""chip_smoke.py: its phases at tiny sizes on the CPU mesh, its refusal to
run without a GPU, and its last line.  The full-size run belongs to the
card (`python chip_smoke.py`); the `gpu` test below runs it there."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_config1_tiny():
    rec = chip_smoke.config1(n_pairs=5, length=40, n_check=5)
    assert (rec["phase"], rec["pairs"], rec["mismatches"]) == ("config1", 5, 0)
    assert rec["cold_s"] > 0 and rec["warm_s"] > 0


def test_config2_tiny():
    rec = chip_smoke.config2(n_pairs=5, length=60, n_check=5)
    assert (rec["parity_pairs"], rec["mismatches"]) == (5, 0)


def test_config3_tiny():
    rec = chip_smoke.config3(n_pairs=5, length=60, n_check=5)
    assert (rec["parity_pairs"], rec["mismatches"]) == (5, 0)


def test_config4_tiny():
    rec = chip_smoke.config4(n_pairs=2, length=300, band=16, window=100,
                             n_check=4)
    assert (rec["pairs"], rec["parity_pairs"], rec["mismatches"]) == (2, 4, 0)


def test_config5_tiny_one_device_matches_four():
    """The --four comparison at tiny size: the product on a 4-device mesh
    is bit-identical to the one-device product."""
    kw = dict(n_reads=5, n_refs=3, read_len=30, ref_len=60, n_check=6)
    one, out1 = chip_smoke.config5(devices=jax.devices()[:1], **kw)
    four, out4 = chip_smoke.config5(devices=jax.devices()[:4], **kw)
    assert (one["devices"], four["devices"]) == (1, 4)
    assert one["mismatches"] == four["mismatches"] == 0
    for f in out1:
        assert (out1[f] == out4[f]).all(), f


def test_shard_placement_four_devices():
    assert chip_smoke.shard_placement(jax.devices()[:4]) == 4


def test_sp_phase_tiny():
    rec = chip_smoke.sp_phase(jax.devices()[:4], length=200, C=32)
    assert (rec["devices"], rec["mismatches"]) == (4, 0)


def test_result_line_format():
    line = chip_smoke.result_line(jax.devices()[:1])
    d = json.loads(line)
    assert d == {"ok": True, "device": {"platform": "cpu", "kind": "cpu",
                                        "count": 1}}
    assert "\n" not in line


def test_refuses_cpu_device():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stderr


def test_fails_without_the_package(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.mark.gpu
def test_quick_on_card(gpu, capsys):
    assert chip_smoke.main(["--quick"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["device"]["platform"] == "gpu"
