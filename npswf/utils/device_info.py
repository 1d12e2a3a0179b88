"""The device a measurement ran on: refuse anything but a GPU, and name the
card and its power limit beside every number (a card set below its maximum
power runs slower under load)."""
from __future__ import annotations

import subprocess


class NotOnGPU(RuntimeError):
    """A measurement path found no GPU; it never falls back to the CPU."""


def require_gpu():
    """The first JAX device, which must be a GPU; raises ``NotOnGPU``."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise NotOnGPU(f"platform is {dev.platform!r} ({dev.device_kind}), "
                       "not 'gpu': no device number is measured here")
    return dev


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for every card, one line
    each, as nvidia-smi prints them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return res.stdout.strip()
