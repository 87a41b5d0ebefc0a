"""What the measuring scripts record about the accelerator they run on."""

from __future__ import annotations

import subprocess


def require_gpu():
    """The JAX devices, or RuntimeError when the first one is not a GPU:
    a measurement never falls back to timing the CPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(f"JAX found no GPU (platform {devices[0].platform})")
    return devices


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them, read by a
    child process that stays off JAX (and off the card's memory)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]
