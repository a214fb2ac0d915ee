"""Accelerator identity for the scripts that run on the card: refuse any
platform but a GPU (a measurement never falls back to the CPU), and read
the card's name and power limit, which belong beside every time taken
on it."""
from __future__ import annotations

import subprocess
from typing import List

import jax

__all__ = ["require_gpu", "card_name_and_power_limit"]


def require_gpu() -> List[jax.Device]:
    """All JAX devices; SystemExit (non-zero) unless they are GPUs."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"this script needs a GPU; JAX found {len(devices)} "
            f"{devices[0].platform} device(s) ({devices[0].device_kind})")
    return devices


def card_name_and_power_limit() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` (one line per card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
