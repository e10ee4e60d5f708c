#!/usr/bin/env python3
"""Multi-execution shape sweep for the fused detect path.

For each (G batches/execution, B frames/batch) shape: steady marginal
ms/batch, plus a dispatch / device+transfer / host-finalize breakdown
of one pipelined round. Run after any change to the dispatch/finalize
economy (device NMS, kernel layout changes) to pick the bench shape.

Usage: python3 tools/exp_shapes.py [G,B [G,B ...]]   (default sweep)
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def log(*a):
    print(*a, flush=True)


def main():
    shapes = [(4, 32), (8, 16), (2, 64)]
    if len(sys.argv) > 1:
        shapes = [tuple(map(int, a.split(","))) for a in sys.argv[1:]]

    import jax
    import jax.numpy as jnp

    log("devices:", jax.devices())
    import scenes

    from object_detector_6d_tpu.api.pipeline import PoseDetector
    from object_detector_6d_tpu.core.config import DetectParams, ICPParams
    from object_detector_6d_tpu.data.synthetic import synthetic_bank

    pd = PoseDetector(
        params=DetectParams(match_threshold=80.0, max_hypotheses=16,
                            icp=ICPParams(iterations=32, num_levels=4)),
        model_points=512,
    )
    synthetic_bank(n_classes=12, per_class=10, bbox_px=120, seed=0,
                   detector=pd.detector)
    K = scenes.K_DEFAULT
    depA, grayA, maskA = scenes.snowman_scene()
    pd.add_view("objA", depA, K, maskA.astype(np.uint8) * 255,
                rgb=np.repeat(grayA[..., None], 3, axis=2))
    depB, grayB, maskB = scenes.snowman_scene(scale=0.78)
    pd.add_view("objB", depB, K, maskB.astype(np.uint8) * 255,
                rgb=np.repeat(grayB[..., None], 3, axis=2))

    def make_frames(B, seed):
        rng = np.random.RandomState(seed)
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
        return np.stack(depths), np.stack(rgbs)

    base = [make_frames(16, seed) for seed in range(4)]

    for G, B in shapes:
        # device-resident [G, B, ...] inputs built from the 16-frame pool
        multis = []
        for m in range(2):
            deps = np.concatenate([base[i % 4][0] for i in range(2 * m, 2 * m + max(1, G * B // 16))])[: G * B]
            rgbs = np.concatenate([base[i % 4][1] for i in range(2 * m, 2 * m + max(1, G * B // 16))])[: G * B]
            multis.append((jnp.asarray(deps.reshape(G, B, 480, 640)),
                           jnp.asarray(rgbs.reshape(G, B, 480, 640, 3))))

        t0 = time.time()
        h = pd.detect_fused_dispatch_multi(multis[0][0], K, multis[0][1])
        out = pd.detect_fused_finalize_multi(h)
        ndet = sum(len(f) for g in out for f in g)
        log(f"[G={G},B={B}] compile+first: {time.time()-t0:.1f}s, "
            f"{ndet} detections/{G*B} frames")

        def run(n):
            t0 = time.time()
            hs = [pd.detect_fused_dispatch_multi(multis[i % 2][0], K,
                                                 multis[i % 2][1])
                  for i in range(n)]
            for h in hs:
                pd.detect_fused_finalize_multi(h)
            return time.time() - t0

        run(1)
        t2 = run(2)
        tn = run(6)
        marginal = (tn - t2) / 4 / G * 1e3
        log(f"[G={G},B={B}] total {tn/(6*G)*1e3:.1f} ms/batch "
            f"({6*G*B/tn:.1f} fps); marginal {marginal:.1f} ms/batch "
            f"-> {B/marginal*1e3:.1f} fps")

        # breakdown of one pipelined round of 4 multis
        for rep in range(2):
            t0 = time.time()
            hs = [pd.detect_fused_dispatch_multi(multis[i % 2][0], K,
                                                 multis[i % 2][1])
                  for i in range(4)]
            t_disp = time.time() - t0
            t0 = time.time()
            flats = [np.asarray(h[1]) for h in hs]
            t_wait = time.time() - t0
            t0 = time.time()
            for h, big in zip(hs, flats):
                (_tag, _fl, Gh, Bh, K_cap, bank, depths_g, rgbs_g, Kh,
                 class_ids, mt) = h
                for g in range(Gh):
                    sub = (None, Bh, K_cap, bank,
                           None if depths_g is None else depths_g[g],
                           None if rgbs_g is None else rgbs_g[g],
                           Kh, class_ids, mt)
                    pd._finalize_host(big[g], sub)
            t_fin = time.time() - t0
            tot = t_disp + t_wait + t_fin
            nb = 4 * G
            log(f"[G={G},B={B}] rep{rep}: dispatch {t_disp/nb*1e3:.1f} + "
                f"device/xfer {t_wait/nb*1e3:.1f} + finalize "
                f"{t_fin/nb*1e3:.1f} = {tot/nb*1e3:.1f} ms/batch "
                f"({4*G*B/tot:.1f} fps unpipelined)")


if __name__ == "__main__":
    main()
