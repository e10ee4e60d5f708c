"""Multi-chip sharding: template-bank TP x frame DP over a jax Mesh.

The reference is a single-process CPU pipeline (SURVEY.md section 2.3);
its scaling axes are the template bank and the frame/camera stream. The
device mapping:

* **data axis (DP)**: frames/cameras shard over ``data`` — each device
  quantizes and builds response maps for its own frames (configs 4-5:
  multi-camera streaming, YCB multi-object).
* **model axis (TP)**: the packed template bank shards over ``model`` —
  each device sweeps its template shard against (replicated) response
  maps of its frame shard, then candidates merge with one
  ``all_gather`` + top-k over the model axis (the only collective in
  the coarse path).
* **hypothesis axis (SP-analog)**: the ICP hypothesis batch also shards
  over ``model`` (hypotheses are embarrassingly parallel; one
  ``all_gather`` collects refined poses).

Everything is expressed with ``shard_map`` over a ``jax.sharding.Mesh``
so XLA inserts the collectives; no custom transport exists or is needed.

The sharded programs themselves live WITH the programs they shard:
``match/program.py:_sharded_run`` (coarse match, templates TP x frames
DP) and ``api/detect_program.py`` (full detect incl. hypothesis-sharded
ICP and device NMS). This module only builds the mesh. Tested on a
CPU-simulated mesh (tests/test_sharding.py drives the production entry
points) and dry-run by the driver via __graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None) -> Mesh:
    """2D (data, model) mesh over the first ``n_devices`` devices.

    The model (template/hypothesis) axis is the smallest divisor of n
    whose square is >= n (4 devices -> 2 x 2, 8 -> 2 x 4). Every device
    reaches every other at the same rate, so the split follows the
    algorithm alone: the model axis must divide the bank and the
    hypothesis count, the data axis the frame batch.

    Raises a clear error when the runtime exposes fewer devices than
    requested — callers that need a virtual mesh must provision it via
    ``JAX_PLATFORMS=cpu`` + ``--xla_force_host_platform_device_count``
    *before* jax initializes (see tests/conftest.py and
    __graft_entry__.dryrun_multichip).
    """
    devs = jax.devices()
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(
            f"make_mesh({n}) needs {n} devices but jax.devices() has "
            f"{len(devs)} ({jax.default_backend()} backend). Provision a "
            "virtual CPU mesh with JAX_PLATFORMS=cpu and "
            f"XLA_FLAGS=--xla_force_host_platform_device_count={n} before "
            "jax initializes."
        )
    tp = min(d for d in range(1, n + 1) if n % d == 0 and d * d >= n)
    arr = np.array(devs[:n]).reshape(n // tp, tp)
    return Mesh(arr, axis_names=("data", "model"))
