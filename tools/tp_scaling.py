#!/usr/bin/env python3
"""Template-parallel (TP) scaling measurement on the virtual CPU mesh.

Runs the fused match program over a 1200-template bank unsharded and
sharded over the (data=2, model=4) 8-virtual-device CPU mesh, on the
same host core, and reports the wall-clock ratio. On one physical core
the virtual devices serialize, so the ratio directly exposes the
OVERHEAD of the TP decomposition (per-shard program + the one
candidate-merge all_gather): a ratio near 1.0 means TP costs nothing
beyond the compute it divides, i.e. on tp real chips the coarse sweep's
per-chip cost drops ~tp-fold. Writes its findings to stdout; the
numbers are recorded in ARCHITECTURE.md's scaling notes.

Usage: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
           python3 tools/tp_scaling.py
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402


def main():
    from object_detector_6d_tpu.data.synthetic import synthetic_bank
    from object_detector_6d_tpu.match import program as mp
    from object_detector_6d_tpu.parallel.sharding import make_mesh

    assert len(jax.devices()) >= 8, jax.devices()
    mesh = make_mesh(8)
    dp, tp = mesh.shape["data"], mesh.shape["model"]

    det = synthetic_bank(n_classes=12, per_class=100, bbox_px=120, seed=0)
    bank = mp.pack_bank(det.class_templates, 2, 2,
                        t0=det.t_at_level[0], t1=det.t_at_level[1], pad_to=tp)
    print(f"bank: {bank.num_templates} templates; mesh data={dp} model={tp}",
          flush=True)
    max_dr = ((bank.max_dr // 16) + 1) * 16
    H, W = 480, 640
    B = dp

    rng = np.random.RandomState(0)
    bgrs = jnp.asarray(
        rng.randint(0, 256, (B, H, W, 3), dtype=np.int64).astype(np.uint8))
    deps = jnp.asarray((900 + rng.randint(0, 700, (B, H, W))).astype(np.uint16))
    args = (
        [bgrs, deps],
        bank.kernels_low,
        (bank.feat_plane, bank.feat_dr, bank.feat_dc, bank.feat_n),
        jnp.asarray(bank.nfeat[0]), jnp.asarray(bank.nfeat[1]),
        jnp.asarray(bank.sizes[0]), jnp.asarray(bank.sizes[1]),
        jnp.float32(80.0),
    )

    results = {}
    for label, m in (("unsharded", None), ("sharded", mesh)):
        prog = mp.make_match_program(
            det.modality_names, det.t_at_level, (H, W),
            det.dn_params, det.cg_params,
            max_candidates=8, max_dr=max_dr,
            batch=B, mesh=m,
        )
        t0 = time.time()
        out = np.asarray(prog(*args))
        print(f"[{label}] compile+first: {time.time()-t0:.1f}s", flush=True)
        best = 1e9
        for _ in range(3):
            t0 = time.time()
            out = np.asarray(prog(*args))
            best = min(best, time.time() - t0)
        results[label] = (best, out)
        print(f"[{label}] steady: {best*1e3:.0f} ms/batch of {B}", flush=True)

    np.testing.assert_array_equal(results["sharded"][1],
                                  results["unsharded"][1])
    ratio = results["sharded"][0] / results["unsharded"][0]
    print(f"equality OK; sharded/unsharded wall-clock on ONE core: "
          f"{ratio:.2f}x (1.0 = TP decomposition is overhead-free; "
          f"per-chip compute on {tp} real chips is ~1/{tp} of this)",
          flush=True)


if __name__ == "__main__":
    main()
