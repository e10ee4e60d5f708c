"""The accelerator a run uses: refuse to run without a GPU, and name the
card (its power limit decides how fast it runs under load)."""

from __future__ import annotations

import subprocess


def require_gpu(jax):
    """The first device must be a GPU; exits non-zero otherwise."""
    devs = jax.devices()
    if not devs or devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX reports {devs}")
    return devs


def gpu_name_and_power() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()
