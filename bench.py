#!/usr/bin/env python3
"""Benchmark: detect() / match / streaming throughput (configs 1-5).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "frames/sec/chip", "vs_baseline": N,
   "detail": {...}}

Headline metric = full detect() pipeline fps (match -> hypothesis lift ->
multi-hypothesis projective ICP -> NMS, the BASELINE.json north_star
workload) on a two-object-class 122-template bank over two-object scenes
(multi-class lift + NMS exercised per frame), batch 32, PIPELINED: the
bench dispatches batch i+1 before finalizing batch i (the
detect_fused_dispatch/finalize API), which is the streaming deployment
shape — device execution overlaps result transfer and host NMS. A
sequential (dispatch+finalize per call) number and a marginal device
rate ((t_12batches - t_4batches) / 8, transfers overlapped) are reported
in detail.

detail fields:
  detect_sequential_fps     round-2-comparable blocking-call throughput
  detect_marginal_ms_batch  marginal per-batch cost under pipelining
  detect_device_fps         frames/sec implied by the marginal rate
  match_only_fps_120tpl     fused match, 120-template bank (round-1 headline)
  match_fps_1200tpl         fused match, 1200-template bank (SURVEY 6 scaling)
  match_fps_4000tpl         fused match, 4000-template bank (YCB-scale point
                            pinning the sweep-scaling curve)
  streaming_4cam_fps        aggregate fps of 4-camera ticks, pipelined
  streaming_tick_ms         mean blocking latency of one 4-camera tick
  detect_fps_192lanes       config-4 shape: 64 hyp slots x 3 seeds = 192
                            ICP lanes/frame at threshold 75
  detect_fps_1200tpl_192lanes  YCB-scale composite: full detect() on a
                            1202-template bank in the 192-lane regime
                            (BASELINE configs 2+4 at once)
  detections_per_class      headline-scene detection counts (2 GT objects)
  device_split_ms_batch16   {geometry, match, detect_full} ms per 16-frame
                            batch (scan-chained executions; icp_lift_ms =
                            full - match - geometry)

CPU baselines (BASELINE.md, the OpenCV oracle on one x86 core): match
32.7 fps at 120 templates, 22.9 fps at 1200; end-to-end detect ~15 fps
midpoint.

Runs on a GPU only: it exits non-zero when JAX finds none, and prints
the device (name, power limit) on stderr.
"""

import json
import os
import sys
import time

import numpy as np

TOOLS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools")

CPU_MATCH_FPS = 32.7  # measured: oracle match, 120 templates, 1-core x86
CPU_MATCH_1200_FPS = 22.9  # measured: oracle match, 1200 templates
CPU_DETECT_FPS = 15.0  # BASELINE.md derived end-to-end midpoint


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def bench_match(jax, jnp, B=8, n_batches=12, n_classes=12, per_class=10,
                label="120tpl"):
    from object_detector_6d_tpu.data.synthetic import synthetic_bank
    from object_detector_6d_tpu.match import program as mp

    det = synthetic_bank(n_classes=n_classes, per_class=per_class,
                         bbox_px=120, seed=0)
    bank = mp.pack_bank(det.class_templates, 2, 2,
                        t0=det.t_at_level[0], t1=det.t_at_level[1])
    log(f"[{label}] bank: {bank.num_templates} templates, max_dr={bank.max_dr}")
    max_dr = ((bank.max_dr // 16) + 1) * 16
    H, W = 480, 640
    prog = mp.make_match_program(
        det.modality_names, det.t_at_level, (H, W),
        det.dn_params, det.cg_params,
        max_candidates=32, max_dr=max_dr, batch=B,
    )

    rng = np.random.RandomState(0)
    inputs = []
    for _ in range(4):  # distinct frame batches, device-resident
        bgrs = jnp.asarray(
            rng.randint(0, 256, (B, H, W, 3), dtype=np.int64).astype(np.uint8))
        deps = jnp.asarray(
            (900 + rng.randint(0, 700, (B, H, W))).astype(np.uint16))
        inputs.append((bgrs, deps))
    rest = (
        bank.kernels_low,
        (bank.feat_plane, bank.feat_dr, bank.feat_dc, bank.feat_n),
        jnp.asarray(bank.nfeat[0]), jnp.asarray(bank.nfeat[1]),
        jnp.asarray(bank.sizes[0]), jnp.asarray(bank.sizes[1]),
        jnp.float32(80.0),
    )

    t0 = time.time()
    np.asarray(prog(inputs[0], *rest))
    log(f"[{label}] match compile+first batch: {time.time()-t0:.1f}s")

    # pipelined throughput: dispatch all executions, sync once
    t0 = time.time()
    outs = [prog(inputs[i % 4], *rest) for i in range(n_batches)]
    np.asarray(outs[-1])
    [np.asarray(o) for o in outs]
    dt = time.time() - t0
    fps = (n_batches * B) / dt
    log(f"[{label}] match steady: {dt/n_batches*1e3:.1f} ms/batch of {B} "
        f"-> {fps:.1f} fps")
    return fps


def _add_views(pd, K, scenes):
    """Register the two benchmark object classes (objA snowman + objB
    0.78-scale variant) as training views on ``pd``. Returns the scene
    ingredients for frame rendering."""
    depA, grayA, maskA = scenes.snowman_scene()
    tid = pd.add_view("objA", depA, K, maskA.astype(np.uint8) * 255,
                      rgb=np.repeat(grayA[..., None], 3, axis=2))
    assert tid == 0
    depB, grayB, maskB = scenes.snowman_scene(scale=0.78)
    tid = pd.add_view("objB", depB, K, maskB.astype(np.uint8) * 255,
                      rgb=np.repeat(grayB[..., None], 3, axis=2))
    assert tid == 0
    return (depA, maskA), (depB, maskB)


def build_detector(jnp):
    """Two object classes with registered views + 120 distractor templates.

    objA = the standard snowman; objB = a 0.78-scale variant (distinct
    geometry and template). Scenes contain BOTH objects at random rigid
    offsets (z-min composed), so every frame exercises multi-class
    hypothesis lift and per-class cluster NMS.
    """
    sys.path.insert(0, TOOLS)
    import scenes

    from object_detector_6d_tpu.api.pipeline import PoseDetector
    from object_detector_6d_tpu.core.config import DetectParams, ICPParams
    from object_detector_6d_tpu.data.synthetic import synthetic_bank

    # shipping schedule: 32 ICP iterations over 4 levels with 2 GN
    # solves per association and a 2-association finest-level polish
    # cap, 512-pt model clouds, 16 hypothesis slots x 2 depth seeds with
    # fine-phase compaction to the 8 best coarse survivors (two-object
    # scenes produce 10-20 coarse candidates per frame). ADD parity is
    # measured at this schedule (tools/parity_add.py, PARITY.md).
    pd = PoseDetector(
        params=DetectParams(match_threshold=80.0, max_hypotheses=16,
                            icp=ICPParams(iterations=32, num_levels=4,
                                          solves_per_assoc=2,
                                          finest_assoc=2),
                            num_seeds=2, fine_compact=8),
        model_points=512,
    )
    synthetic_bank(n_classes=12, per_class=10, bbox_px=120, seed=0,
                   detector=pd.detector)
    K = scenes.K_DEFAULT
    (depA, maskA), (depB, maskB) = _add_views(pd, K, scenes)
    log(f"detect bank: {pd.detector.num_templates()} templates, "
        f"2 object classes with views")

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
        return jnp.asarray(np.stack(depths)), jnp.asarray(np.stack(rgbs))

    return pd, K, make_frames


def bench_detect(jax, jnp, pd, K, make_frames, B=32, G=4, n_multi=6):
    # 4 distinct device-resident frame batches (the streaming model
    # uploads each frame once)
    inputs = [make_frames(B, seed) for seed in range(4)]

    t0 = time.time()
    out = pd.detect_fused_batch(inputs[0][0], K, inputs[0][1])
    per_class = {}
    for frame in out:
        for p in frame:
            per_class[p.class_id] = per_class.get(p.class_id, 0) + 1
    log(f"detect compile+first batch: {time.time()-t0:.1f}s, "
        f"detections/class over {B} frames: {per_class}, "
        f"overflow fallbacks: {pd.counters.counts['overflow_fallback']}")

    # sequential (round-2-comparable): block on each batch
    t0 = time.time()
    for i in range(4):
        pd.detect_fused_batch(inputs[i % 4][0], K, inputs[i % 4][1])
    dt = time.time() - t0
    seq_fps = 4 * B / dt
    log(f"detect sequential: {dt/4*1e3:.1f} ms/batch of {B} -> {seq_fps:.1f} fps")

    # grouped-retrieval pipelining: dispatch every batch up front,
    # retrieve results in groups of 4 (one transfer per group,
    # detect_fused_finalize_many); the headline takes the better of this
    # and the scanned-execution mode below.
    def pipelined(n, group=4):
        t0 = time.time()
        handles = [
            pd.detect_fused_dispatch(inputs[i % 4][0], K, inputs[i % 4][1])
            for i in range(n)
        ]
        for i in range(0, n, group):
            pd.detect_fused_finalize_many(handles[i:i + group])
        return time.time() - t0

    pipelined(4)  # warm the dispatch path and the group-stack program
    t4 = pipelined(4)
    t12 = pipelined(12)
    group_fps = 12 * B / t12
    log(f"detect group-pipelined: {t12/12*1e3:.1f} ms/batch of {B} "
        f"-> {group_fps:.1f} fps (marginal {(t12-t4)/8*1e3:.1f} ms/batch)")

    # multi-batch scanned executions: ONE device execution runs G
    # batches (lax.scan) and ONE transfer returns their results.
    # Throughput deployment shape (batching latency G*B frames).
    multis = []
    for m in range(2):
        dg = jnp.stack([inputs[(2 * m + g) % 4][0] for g in range(G)])
        rg = jnp.stack([inputs[(2 * m + g) % 4][1] for g in range(G)])
        multis.append((dg, rg))
    t0 = time.time()
    pd.detect_fused_finalize_multi(
        pd.detect_fused_dispatch_multi(multis[0][0], K, multis[0][1]))
    log(f"detect multi compile+first: {time.time()-t0:.1f}s")

    def run(n):
        t0 = time.time()
        hs = [pd.detect_fused_dispatch_multi(multis[i % 2][0], K,
                                             multis[i % 2][1])
              for i in range(n)]
        for h in hs:
            pd.detect_fused_finalize_multi(h)
        return time.time() - t0

    run(1)  # steady-state warmup
    t2 = run(2)
    tn = run(n_multi)
    multi_fps = n_multi * G * B / tn
    marginal_ms = (tn - t2) / (n_multi - 2) / G * 1e3
    dev_fps = B / (marginal_ms / 1e3)
    log(f"detect multi-pipelined: {tn/(n_multi*G)*1e3:.1f} ms/batch of {B} "
        f"(G={G} batches/execution) -> {multi_fps:.1f} fps "
        f"(marginal {marginal_ms:.1f} ms/batch -> {dev_fps:.1f} fps rate)")
    pipe_fps = max(group_fps, multi_fps)
    return pipe_fps, seq_fps, marginal_ms, dev_fps, per_class, group_fps, multi_fps


def bench_device_split(jax, jnp, pd, K, make_frames, B=16):
    """Per-stage time of the production detect program, batch 16.

    Times geometry (backproject + FALS + scene pack), the fused match
    program, and the complete detect program with a scan harness
    (iterations chained through a data dependency, one execution per
    sample). icp_lift = detect_full - match - geometry. Returns a dict
    of ms/batch-16."""
    from object_detector_6d_tpu.api import detect_program as dp_mod
    from object_detector_6d_tpu.geom.backproject import depth_to_3d
    from object_detector_6d_tpu.geom.normals import FalsNormals
    from object_detector_6d_tpu.match import program as mp
    from object_detector_6d_tpu.refine.projective import pack_scene7

    depths_d, rgbs_d = make_frames(B, 900)
    Kj = jnp.asarray(K)

    def device_time(name, fn, args, iters=6, reps=3):
        @jax.jit
        def many(args):
            def step(acc, _):
                out = fn(*args, acc * 1e-30)
                s = jnp.float32(0)
                for x in jax.tree_util.tree_leaves(out):
                    # posinf/neginf -> 0: the detect program's flat output
                    # carries jnp.inf residuals for failed/padded lanes;
                    # the default nan_to_num maps them to float32-max and
                    # two of them overflow the accumulator to inf, which
                    # feeds the NEXT iteration's threshold and degenerates
                    # scan iterations 2..N (icp_lift would read low)
                    s = s + jnp.sum(jnp.nan_to_num(
                        x.astype(jnp.float32), posinf=0.0, neginf=0.0,
                    )) * 1e-30
                return s, None
            acc, _ = jax.lax.scan(step, jnp.float32(0), None, length=iters)
            return acc

        t0 = time.time()
        np.asarray(many(args))
        log(f"[split] {name} compile+first: {time.time()-t0:.1f}s")
        best = 1e9
        for _ in range(reps):
            t0 = time.time()
            np.asarray(many(args))
            best = min(best, time.time() - t0)
        ms = best / iters * 1e3
        log(f"[split] {name}: {ms:.2f} ms/batch-{B}")
        return ms

    # the SAME geometry composition the detect program runs
    est = FalsNormals(480, 640, K)

    def geometry(depths, eps):
        def one(d):
            cloud = depth_to_3d(d, Kj) + eps
            return pack_scene7(jnp.concatenate([cloud, est(cloud)], -1))
        return jax.vmap(one)(depths)

    geom_ms = device_time("geometry", geometry, (depths_d,))

    bank = pd.detector.get_bank(None)
    max_dr = ((bank.max_dr // 16) + 1) * 16
    match_prog = mp.make_match_program(
        pd.detector.modality_names, pd.detector.t_at_level, (480, 640),
        pd.detector.dn_params, pd.detector.cg_params,
        max_candidates=16, max_dr=max_dr, batch=B,
    )
    margs = (
        [rgbs_d, depths_d],
        bank.kernels_low,
        (bank.feat_plane, bank.feat_dr, bank.feat_dc, bank.feat_n),
        jnp.asarray(bank.nfeat[0]), jnp.asarray(bank.nfeat[1]),
        jnp.asarray(bank.sizes[0]), jnp.asarray(bank.sizes[1]),
    )

    def match_fn(sources, *rest):
        *bank_args, eps = rest
        return match_prog(sources, *bank_args, jnp.float32(80.0) + eps)

    match_ms = device_time("match", match_fn, margs)

    views = dp_mod.pack_views(bank, pd.views, pd.model_points)
    # the SAME schedule the headline detector ships (build_detector):
    # promoted ICP knobs + seed count + fine compaction
    prog = dp_mod.make_detect_program(
        pd.detector.modality_names, pd.detector.t_at_level, (480, 640),
        pd.detector.dn_params, pd.detector.cg_params, K,
        max_candidates=16, max_dr=max_dr, icp=pd.params.icp, batch=B, flat_output=True,
        num_seeds=pd.params.num_seeds, fine_compact=pd.params.fine_compact,
    )

    def detect_fn(sources, *rest):
        *bank_args, views, eps = rest
        return prog(sources, *bank_args, views, jnp.float32(80.0) + eps)

    full_ms = device_time("detect_full", detect_fn, margs + (views,))
    split = {
        "geometry": round(geom_ms, 2),
        "match": round(match_ms, 2),
        "detect_full": round(full_ms, 2),
        "icp_lift": round(full_ms - match_ms - geom_ms, 2),
    }
    log(f"[split] icp+lift residual: {split['icp_lift']:.2f} ms/batch-{B} "
        f"-> device ceiling {B / (full_ms / 1e3):.0f} fps")
    return split


def bench_hyp_scaling(jax, jnp, pd, K, make_frames, B=16):
    """Config-4 shape (YCB-style multi-hypothesis): 64 hypothesis slots
    x 3 depth seeds = 192 projective-ICP lanes per frame, lower match
    threshold so more coarse candidates survive into the lift. Shares
    the template bank and views with the headline detector; only the
    hypothesis capacity (and therefore the fused program) differs."""
    import dataclasses as dc

    from object_detector_6d_tpu.api.pipeline import PoseDetector

    pd4 = PoseDetector(
        detector=pd.detector,
        params=dc.replace(pd.params, max_hypotheses=64, match_threshold=75.0,
                          num_seeds=3,
                          fine_compact=16),
        model_points=pd.model_points,
    )
    pd4.views = pd.views
    inputs = [make_frames(B, 200 + s) for s in range(2)]

    # adaptive threshold: a coarse-candidate overflow (> 64 slots) would
    # fall back to the slow host path and distort the measurement — back
    # off toward the headline threshold until the first batch is clean
    thr = 75.0
    while True:
        t0 = time.time()
        out = pd4.detect_fused_batch(inputs[0][0], K, inputs[0][1],
                                     match_threshold=thr)
        n_det = sum(len(p) for p in out)
        n_over = pd4.counters.counts["overflow_fallback"]
        log(f"hyp192 thr={thr:.0f} compile+first batch: {time.time()-t0:.1f}s, "
            f"{n_det} detections over {B} frames, overflow fallbacks: {n_over}")
        if n_over == 0 or thr >= 80.0:
            break
        pd4.counters.counts["overflow_fallback"] = 0
        thr += 2.0

    # pipelined dispatch, grouped retrieval (one transfer per group)
    def run(n, group=4):
        t0 = time.time()
        hs = [pd4.detect_fused_dispatch(inputs[i % 2][0], K, inputs[i % 2][1],
                                        match_threshold=thr)
              for i in range(n)]
        for i in range(0, n, group):
            pd4.detect_fused_finalize_many(hs[i:i + group])
        return time.time() - t0

    run(4)  # warm the group-stack program
    dt = run(8)
    fps = 8 * B / dt
    log(f"hyp192 pipelined: {dt/8*1e3:.1f} ms/batch of {B} -> {fps:.1f} fps "
        f"(192 ICP lanes/frame)")
    return fps


def bench_detect_scale(jax, jnp, pd, K, make_frames, B=16):
    """YCB-scale composite point (BASELINE configs 2+4): full detect()
    on a 1202-template bank (12 classes x 100 distractors + the two
    view classes) in the 192-ICP-lane hypothesis regime (64 slots x 3
    seeds, threshold 75, fine_compact 16). Pins the cost composition the
    SURVEY section-6 model predicts: coarse sweep scales with nT while
    the refine/ICP stages scale with lanes — the two big knobs at once."""
    import dataclasses as dc

    sys.path.insert(0, TOOLS)
    import scenes

    from object_detector_6d_tpu.api.pipeline import PoseDetector
    from object_detector_6d_tpu.data.synthetic import synthetic_bank

    pdl = PoseDetector(
        params=dc.replace(pd.params, max_hypotheses=64, num_seeds=3,
                          match_threshold=75.0, fine_compact=16),
        model_points=pd.model_points,
    )
    synthetic_bank(n_classes=12, per_class=100, bbox_px=120, seed=0,
                   detector=pdl.detector)
    _add_views(pdl, K, scenes)
    log(f"scale bank: {pdl.detector.num_templates()} templates, 192 lanes")
    inputs = [make_frames(B, 300 + s) for s in range(2)]

    thr = 75.0
    while True:
        t0 = time.time()
        out = pdl.detect_fused_batch(inputs[0][0], K, inputs[0][1],
                                     match_threshold=thr)
        n_det = sum(len(p) for p in out)
        n_over = pdl.counters.counts["overflow_fallback"]
        log(f"scale1200 thr={thr:.0f} compile+first batch: "
            f"{time.time()-t0:.1f}s, {n_det} detections over {B} frames, "
            f"overflow fallbacks: {n_over}")
        if n_over == 0 or thr >= 80.0:
            break
        pdl.counters.counts["overflow_fallback"] = 0
        thr += 2.0

    def run(n, group=4):
        t0 = time.time()
        hs = [pdl.detect_fused_dispatch(inputs[i % 2][0], K,
                                        inputs[i % 2][1],
                                        match_threshold=thr)
              for i in range(n)]
        for i in range(0, n, group):
            pdl.detect_fused_finalize_many(hs[i:i + group])
        return time.time() - t0

    run(4)  # warm the group-stack program
    dt = run(8)
    fps = 8 * B / dt
    log(f"scale1200 pipelined: {dt/8*1e3:.1f} ms/batch of {B} -> "
        f"{fps:.1f} fps (1202 templates, 192 ICP lanes/frame)")
    return fps


def bench_streaming(jax, jnp, pd, K, make_frames, n_cam=4, n_ticks=16):
    """Config 5: one tick = one fused call over the 4-camera batch."""
    from object_detector_6d_tpu.api.streaming import StreamingDetector

    sd = StreamingDetector(pd, n_cameras=n_cam)
    ticks = [make_frames(n_cam, 100 + s) for s in range(4)]

    t0 = time.time()
    out = sd.process(ticks[0][0], K, ticks[0][1])
    n_det = sum(len(p) for p in out)
    log(f"streaming compile+first tick: {time.time()-t0:.1f}s, "
        f"{n_det} detections")

    # blocking tick latency (what a lockstep 4x30 FPS driver would see)
    lat = []
    for i in range(8):
        t0 = time.time()
        sd.process(ticks[i % 4][0], K, ticks[i % 4][1])
        lat.append(time.time() - t0)
    tick_ms = float(np.mean(sorted(lat)[:6]) * 1e3)

    # pipelined ticks (dispatch tick i+1 before finalizing tick i,
    # results retrieved in groups of 8 ticks — one transfer per group):
    # per-camera frame queues hide the tick latency
    group = 8
    warm = [pd.detect_fused_dispatch(ticks[i % 4][0], K, ticks[i % 4][1])
            for i in range(group)]
    pd.detect_fused_finalize_many(warm)  # compile the group-stack program
    t0 = time.time()
    handles = [
        pd.detect_fused_dispatch(ticks[i % 4][0], K, ticks[i % 4][1])
        for i in range(n_ticks)
    ]
    for i in range(0, n_ticks, group):
        pd.detect_fused_finalize_many(handles[i:i + group])
    dt = time.time() - t0
    tickwise_fps = n_ticks * n_cam / dt
    log(f"streaming: tick latency {tick_ms:.1f} ms blocking; pipelined "
        f"{dt/n_ticks*1e3:.1f} ms/tick -> {tickwise_fps:.1f} fps aggregate "
        f"tick-wise (target 4x30 = 120)")

    # multi-tick scanned executions (G=4 ticks per device execution,
    # one transfer per execution; +100 ms result latency at the 30 FPS
    # camera rate)
    Gt = 4
    tick_multis = []
    for m in range(2):
        dg = jnp.stack([ticks[(2 * m + g) % 4][0] for g in range(Gt)])
        rg = jnp.stack([ticks[(2 * m + g) % 4][1] for g in range(Gt)])
        tick_multis.append((dg, rg))
    t0 = time.time()
    pd.detect_fused_finalize_multi(
        pd.detect_fused_dispatch_multi(tick_multis[0][0], K,
                                       tick_multis[0][1]))
    log(f"streaming multi compile+first: {time.time()-t0:.1f}s")
    n_m = 8
    hs = [pd.detect_fused_dispatch_multi(tick_multis[0][0], K,
                                         tick_multis[0][1])]
    pd.detect_fused_finalize_multi(hs[0])  # steady-state warmup
    t0 = time.time()
    hs = [pd.detect_fused_dispatch_multi(tick_multis[i % 2][0], K,
                                         tick_multis[i % 2][1])
          for i in range(n_m)]
    for h in hs:
        pd.detect_fused_finalize_multi(h)
    dt = time.time() - t0
    agg_fps = n_m * Gt * n_cam / dt
    log(f"streaming {Gt}-tick scanned executions: {dt/(n_m*Gt)*1e3:.1f} ms/tick "
        f"-> {agg_fps:.1f} fps aggregate (target 120)")
    # Both modes are tick-shaped 4-camera measurements; report the best as
    # the config-5 number (tick-wise pipelining dispatches one tick per
    # call — lower latency; scanned executions dispatch once per 4 ticks).
    if tickwise_fps >= agg_fps:
        mode = "tick-wise pipelined (one dispatch per 4-camera tick)"
        best = tickwise_fps
    else:
        mode = "4-tick scanned executions (one dispatch per 16 frames)"
        best = agg_fps
    return best, mode, agg_fps, tickwise_fps, tick_ms


def main():
    import jax
    import jax.numpy as jnp

    from object_detector_6d_tpu.utils import compile_cache
    from object_detector_6d_tpu.utils.device import gpu_name_and_power, require_gpu

    require_gpu(jax)
    compile_cache.enable()
    log("devices:", jax.devices(), "|", gpu_name_and_power())
    match_fps = bench_match(jax, jnp, n_classes=12, per_class=10,
                            label="120tpl")
    match_1200 = bench_match(jax, jnp, n_classes=12, per_class=100,
                             label="1200tpl")
    # YCB-scale bank: one more point on the sweep-scaling curve
    # (120 / 1200 / 4000). Smaller batch count: the point is the
    # marginal per-template cost, not retrieval-mode tuning.
    match_4000 = bench_match(jax, jnp, n_batches=8, n_classes=40,
                             per_class=100, label="4000tpl")
    pd, K, make_frames = build_detector(jnp)
    (pipe_fps, seq_fps, marginal_ms, dev_fps, per_class, group_fps,
     multi_fps) = bench_detect(jax, jnp, pd, K, make_frames)
    (stream_fps, stream_mode, scan_fps, tickwise_fps,
     tick_ms) = bench_streaming(jax, jnp, pd, K, make_frames)
    hyp192_fps = bench_hyp_scaling(jax, jnp, pd, K, make_frames)
    scale1200_fps = bench_detect_scale(jax, jnp, pd, K, make_frames)
    split = bench_device_split(jax, jnp, pd, K, make_frames)

    print(
        json.dumps(
            {
                "metric": "full detect() 640x480, 122-template bank, "
                          "2 object classes/frame, 16 hyp x 2 seeds, "
                          "batch 32 pipelined (best retrieval mode)",
                "value": round(pipe_fps, 2),
                "unit": "frames/sec/chip",
                "vs_baseline": round(pipe_fps / CPU_DETECT_FPS, 2),
                "detail": {
                    "detect_sequential_fps": round(seq_fps, 2),
                    "detect_group_pipelined_fps": round(group_fps, 2),
                    "detect_multi_scan_fps": round(multi_fps, 2),
                    "detect_marginal_ms_batch": round(marginal_ms, 2),
                    "detect_device_fps": round(dev_fps, 2),
                    "match_only_fps_120tpl": round(match_fps, 2),
                    "match_fps_1200tpl": round(match_1200, 2),
                    "match_fps_4000tpl": round(match_4000, 2),
                    "match_vs_cpu": round(match_fps / CPU_MATCH_FPS, 2),
                    "match_1200_vs_cpu": round(
                        match_1200 / CPU_MATCH_1200_FPS, 2),
                    "streaming_4cam_fps": round(stream_fps, 2),
                    "streaming_mode": stream_mode,
                    "streaming_scan_fps": round(scan_fps, 2),
                    "streaming_tickwise_fps": round(tickwise_fps, 2),
                    "streaming_tick_ms": round(tick_ms, 2),
                    "detect_fps_192lanes": round(hyp192_fps, 2),
                    "detect_fps_1200tpl_192lanes": round(scale1200_fps, 2),
                    "device_split_ms_batch16": split,
                    "detections_per_class_16f": per_class,
                    "cpu_detect_baseline_fps": CPU_DETECT_FPS,
                    "cpu_match_baseline_fps": CPU_MATCH_FPS,
                },
            }
        )
    )


if __name__ == "__main__":
    main()
