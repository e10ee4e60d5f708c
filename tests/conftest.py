"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set the platform env vars *before* jax is imported anywhere, so this
sits at the very top of conftest. Parity/golden tests use the same math on
CPU; sharding tests get 8 fake devices (SURVEY.md section 4).

Tests marked ``gpu`` need the card: they skip here and run on the GPU
from chip_smoke.py, which sets ODC_TEST_DEVICE=gpu so that the backend
it already holds is kept.
"""

import os

ON_GPU = os.environ.get("ODC_TEST_DEVICE") == "gpu"

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax

if not ON_GPU:
    # in case jax was imported before this conftest: backends are not
    # initialized yet, so the config API still takes effect
    jax.config.update("jax_platforms", "cpu")

import pathlib

import numpy as np
import pytest

GOLDEN_DIR = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="session")
def golden():
    """Loader for committed oracle golden files (tests/golden/*.npz)."""

    def load(name: str):
        path = GOLDEN_DIR / f"{name}.npz"
        if not path.exists():
            pytest.skip(f"golden file {name}.npz not generated (tools/gen_goldens.py)")
        return np.load(path)

    return load


@pytest.fixture
def gpu():
    """The GPU for a ``gpu``-marked test; skips where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: runs on the card from chip_smoke.py")
    return dev
