#!/usr/bin/env python3
"""Ablation split of the production fused detect program (run on the GPU).

Standalone ICP timings with worst-case (non-converging) poses
mis-attribute the per-batch budget: inside the production program the
while_loops exit early on real seeds. This tool measures the REAL split
by building
variants of the production program (api/detect_program.py, batch 16,
flat/cluster output) and diffing steady-state device time:

  full              the production program (device NMS, S=3, no compaction)
  no_nms            device_nms off (flat output)   -> cluster-NMS cost
  s1_seeds          num_seeds=1                    -> extra-seed coarse cost
  compact8          fine_compact=8                 -> fine-lane halving
  compact8+s2       fine_compact=8, num_seeds=2    -> combined economy
  lift_sort         lift_impl="sort"               -> lift estimator delta
  iters_down        icp 24 iters / 4 levels        -> iteration ceiling
  solves2           2 GN solves per association    -> gather-traffic halving
  solves2_all       solves2 + compact8 + 2 seeds   -> full promoted economy

Every variant is detection-equivalent on the headline scene except
iters_down (accuracy knob) — parity is re-run whenever a variant is
promoted into the production config.
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
import scenes  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

B = 16
H, W = 480, 640


def log(*a):
    print(*a, flush=True)


def main():
    from chip_smoke import gpu_name_and_power, require_gpu
    from object_detector_6d_tpu.utils import compile_cache

    require_gpu(jax)
    compile_cache.enable()
    log("devices:", jax.devices(), "|", gpu_name_and_power())
    from object_detector_6d_tpu.api import detect_program as dp_mod
    from object_detector_6d_tpu.api.pipeline import PoseDetector
    from object_detector_6d_tpu.core.config import DetectParams, ICPParams
    from object_detector_6d_tpu.data.synthetic import synthetic_bank
    from object_detector_6d_tpu.match import program as mp

    K = scenes.K_DEFAULT
    pd = PoseDetector(
        params=DetectParams(match_threshold=80.0, max_hypotheses=16,
                            icp=ICPParams(iterations=32, num_levels=4)),
        model_points=512,
    )
    synthetic_bank(n_classes=12, per_class=10, bbox_px=120, seed=0,
                   detector=pd.detector)
    depA, grayA, maskA = scenes.snowman_scene()
    pd.add_view("objA", depA, K, maskA.astype(np.uint8) * 255,
                rgb=np.repeat(grayA[..., None], 3, axis=2))
    depB, grayB, maskB = scenes.snowman_scene(scale=0.78)
    pd.add_view("objB", depB, K, maskB.astype(np.uint8) * 255,
                rgb=np.repeat(grayB[..., None], 3, axis=2))

    rng = np.random.RandomState(1)
    depths, rgbs = [], []
    for _ in range(B):
        tA = np.array([rng.uniform(-0.05, 0.05), rng.uniform(-0.04, 0.04),
                       rng.uniform(-0.04, 0.04)])
        tB = np.array([-0.26 + rng.uniform(-0.03, 0.03),
                       0.11 + rng.uniform(-0.03, 0.03),
                       0.04 + rng.uniform(-0.03, 0.03)])
        rA = scenes.render_translated(depA, maskA, K, tA)
        rB = scenes.render_translated(depB, maskB, K, tB)
        d, _, g = scenes.merge_scenes([rA, rB])
        depths.append(d)
        rgbs.append(np.repeat(g[..., None], 3, axis=2))
    depths_d = jnp.asarray(np.stack(depths))
    rgbs_d = jnp.asarray(np.stack(rgbs))

    bank = pd.detector.get_bank(None)
    max_dr = ((bank.max_dr // 16) + 1) * 16
    views = dp_mod.pack_views(bank, pd.views, pd.model_points)
    index = {}
    cls_of_tid = jnp.asarray(
        np.array([index.setdefault(c, len(index)) for c in bank.class_ids],
                 np.int32))
    nms_scalars = jnp.asarray([0.05, 0.02], jnp.float32)
    margs = (
        [rgbs_d, depths_d],
        bank.kernels_low,
        (bank.feat_plane, bank.feat_dr, bank.feat_dc, bank.feat_n),
        jnp.asarray(bank.nfeat[0]), jnp.asarray(bank.nfeat[1]),
        jnp.asarray(bank.sizes[0]), jnp.asarray(bank.sizes[1]),
    )

    def device_time(name, fn, args, iters=6, reps=3):
        @jax.jit
        def many(args):
            def step(acc, _):
                out = fn(*args, acc * 1e-30)
                s = jnp.float32(0)
                for x in jax.tree_util.tree_leaves(out):
                    # posinf/neginf -> 0: inf residuals in the flat output
                    # otherwise overflow the accumulator and degenerate
                    # scan iterations 2..N
                    s = s + jnp.sum(jnp.nan_to_num(
                        x.astype(jnp.float32), posinf=0.0, neginf=0.0,
                    )) * 1e-30
                return s, None
            acc, _ = jax.lax.scan(step, jnp.float32(0), None, length=iters)
            return acc

        t0 = time.time()
        np.asarray(many(args))
        log(f"  [{name}] compile+first: {time.time()-t0:.1f}s")
        best = 1e9
        for _ in range(reps):
            t0 = time.time()
            np.asarray(many(args))
            best = min(best, time.time() - t0)
        ms = best / iters * 1e3
        log(f"  [{name}] {ms:8.2f} ms/batch-{B}")
        return ms

    # auto-sized fine-phase window (same formula as pipeline.py)
    iw_auto = min(256, max(96, -(-(int(np.max(bank.sizes[0])) + 64) // 8) * 8))

    def build(device_nms=True, num_seeds=3, fine_compact=0,
              lift_impl="hist", icp=None, icp_window=0):
        return dp_mod.make_detect_program(
            pd.detector.modality_names, pd.detector.t_at_level, (H, W),
            pd.detector.dn_params, pd.detector.cg_params, K,
            max_candidates=16, max_dr=max_dr,
            icp=icp or pd.params.icp, batch=B,
            flat_output=True, device_nms=device_nms,
            num_seeds=num_seeds, fine_compact=fine_compact,
            lift_impl=lift_impl, icp_window=icp_window,
        )

    def run_variant(name, **kw):
        prog = build(**kw)
        nms = kw.get("device_nms", True)

        def fn(sources, *rest, _p=prog, _nms=nms):
            *bank_args, views, eps = rest
            if _nms:
                return _p(sources, *bank_args, views,
                          jnp.float32(80.0) + eps, cls_of_tid, nms_scalars)
            return _p(sources, *bank_args, views, jnp.float32(80.0) + eps)

        return device_time(name, fn, margs + (views,))

    full = run_variant("full")
    deltas = {}
    deltas["cluster_nms"] = full - run_variant("no_nms", device_nms=False)
    deltas["extra_seeds(3->1)"] = full - run_variant("s1_seeds", num_seeds=1)
    deltas["fine_tail(compact8)"] = full - run_variant(
        "compact8", fine_compact=8)
    deltas["combined(c8,s2)"] = full - run_variant(
        "compact8_s2", fine_compact=8, num_seeds=2)
    deltas["lift(sort-hist)"] = run_variant(
        "lift_sort", lift_impl="sort") - full
    from object_detector_6d_tpu.core.config import ICPParams as _I
    deltas["iters(32->24)"] = full - run_variant(
        "iters_down", icp=_I(iterations=24, num_levels=4))
    deltas["solves2"] = full - run_variant(
        "solves2", icp=_I(iterations=32, num_levels=4, solves_per_assoc=2))
    deltas["solves2+c8+s2"] = full - run_variant(
        "solves2_all", fine_compact=8, num_seeds=2,
        icp=_I(iterations=32, num_levels=4, solves_per_assoc=2))
    deltas["finest2"] = full - run_variant(
        "finest2", icp=_I(iterations=32, num_levels=4, finest_assoc=2))
    deltas["window(assoc)"] = full - run_variant(
        "window", icp_window=iw_auto)
    deltas["win+solves2"] = full - run_variant(
        "win_solves2", icp_window=iw_auto,
        icp=_I(iterations=32, num_levels=4, solves_per_assoc=2))
    deltas["promoted(s2,c8,sv2,f2)"] = full - run_variant(
        "promoted", fine_compact=8, num_seeds=2,
        icp=_I(iterations=32, num_levels=4, solves_per_assoc=2,
               finest_assoc=2))
    deltas["win+promoted"] = full - run_variant(
        "win_promoted", fine_compact=8, num_seeds=2, icp_window=iw_auto,
        icp=_I(iterations=32, num_levels=4, solves_per_assoc=2,
               finest_assoc=2))
    log("\n  deltas vs full:")
    for k, v in deltas.items():
        log(f"    {k:24s} {v:+7.2f} ms/batch-{B}")


if __name__ == "__main__":
    main()
