"""The device a measurement runs on, and the card's name and power limit.

Measurement entry points (``chip_smoke.py``, ``bench.py``) call
``require_gpu`` first: a number taken on another platform must never be
reported as a GPU number."""

from __future__ import annotations

import subprocess


def require_gpu():
    """Return JAX's first device; exit non-zero unless it is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is {dev.platform} "
            f"({dev.device_kind}); this program measures only on a GPU"
        )
    return dev


def card_line() -> str:
    """`name, power.limit` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()
