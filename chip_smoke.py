#!/usr/bin/env python3
"""Smoke run of the detector on one GPU, or on four with ``--four``.

    python chip_smoke.py          # one GPU: phases 1-7 below
    python chip_smoke.py --four   # four GPUs: the sharded detect program
                                  # against the single-device one, only

It drives the production path once at the headline shapes (640x480
RGB-D, a 122-template bank, 16 hypothesis slots x 2 depth seeds, ICP 32
iterations over 4 levels, 512-point models, batch 32) through the
public entry points, and checks each stage against its plain reference:

1. device: JAX must report a GPU; prints JAX's version, the device kind
   and the card's name and power limit (nvidia-smi)
2. stage parity at real widths: both quantizers against the OpenCV
   goldens (bit-exact), the coarse sweep and the level-0 refine against
   numpy (exact integers), geometry against the golden cloud and normals
3. ``Detector.match`` on the golden end-to-end scenes against the
   oracle's match lists
4. ``PoseDetector.detect_fused_batch`` on the headline batch, on the GPU
   and then through the same program on the host CPU: the same confident
   detections (see ``compare_detections``), poses within POSE_TOL_MM /
   POSE_TOL_DEG
5. ``StreamingDetector.process``: 4 cameras, a few ticks
6. ADD-0.1d on the 64-scene ``base`` and ``occl`` parity sets through
   ``detect_fused`` at the shipping schedule, against the checked-in
   oracle results (``occl`` is where the GPU's f32 rounding costs
   scenes, so a further loss shows there first)
7. the card-only tests (``pytest -m gpu``), in this process

Everything runs in one process. Any failed check raises, so the process
exits non-zero; the last stdout line, one JSON object, is printed only
when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")

# GPU vs host-CPU pose agreement (phase 4) and sharded vs single-device
# (--four). The two runs share every integer stage exactly; their poses
# differ only through f32 summation order in the ICP normal equations,
# which moves the update-norm early exit (3e-4) by an iteration at most.
# 2 mm / 1 deg is well above that and over an order of magnitude below
# the ADD-0.1d threshold of the parity sets (70.4 mm on ``base``), so a
# difference within it cannot flip a detection's ADD verdict.
POSE_TOL_MM = 2.0
POSE_TOL_DEG = 1.0
# detections with an ICP residual (RMS point-to-plane, m) at most this
# fraction of DetectParams.max_residual count as confident fits; true
# fits on the headline scene sit near 0.1 of the gate
CONFIDENT = 0.5
HEADLINE_BATCH = 32
ADD_MARGIN_PP = 0.5  # ours may trail the oracle's ADD-0.1d by at most this
# parity sets of phase 6: base, and occl, where the GPU's f32 rounding
# already costs scenes against the CPU and no margin over the oracle is left
ADD_SETS = ("base", "occl")


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def log(*a) -> None:
    print(*a, flush=True)


def _keep_host_cpu() -> None:
    """Phase 4 reruns the batch on the host CPU: keep that backend
    available when JAX_PLATFORMS names only the GPU."""
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"


# ----------------------------------------------------------------------
# phase 2: stages against their plain references
# ----------------------------------------------------------------------


def stage_quantizers():
    """Both quantizers on every golden frame: (mismatching pixels, total)."""
    from object_detector_6d_tpu.quant.color_gradient import quantized_orientations
    from object_detector_6d_tpu.quant.depth_normal import quantized_normals

    bad = total = 0
    g = np.load(os.path.join(GOLDEN, "cg_quantize.npz"))
    for case in ("noise", "sphere"):
        q, _ = quantized_orientations(g[case + "_in"])
        m = int((np.asarray(q) != g[case + "_q"]).sum())
        log(f"  ColorGradient {case} {g[case + '_in'].shape[:2]}: "
            f"{m} mismatching pixels")
        bad, total = bad + m, total + g[case + "_q"].size
    g = np.load(os.path.join(GOLDEN, "dn_quantize.npz"))
    for case in sorted({k[:-3] for k in g.files if k.endswith("_in")}):
        q = quantized_normals(g[case + "_in"])
        m = int((np.asarray(q) != g[case + "_q"]).sum())
        log(f"  DepthNormal {case} {g[case + '_in'].shape}: "
            f"{m} mismatching pixels")
        bad, total = bad + m, total + g[case + "_q"].size
    return bad, total


def _numpy_coarse(D, k):
    """Plain sum over the non-zero kernel cells (numpy, int64)."""
    nT, _, kd, _ = k.shape
    oh, ow = D.shape[1] - kd + 1, D.shape[2] - kd + 1
    out = np.zeros((nT, oh, ow), np.int64)
    for t, p, i, j in zip(*np.nonzero(k)):
        out[t] += int(k[t, p, i, j]) * D[p, i:i + oh, j:j + ow]
    return out


def stage_coarse(bank, frame_shape, t1, seed=0):
    """Coarse sweep of every bank template over random level-1 response
    planes at the frame's real width: (mismatches, max |error|)."""
    import jax

    from object_detector_6d_tpu.match import program as mp

    rng = np.random.RandomState(seed)
    H1, W1 = frame_shape[0] // 2, frame_shape[1] // 2
    bad, worst = 0, 0
    for k_dev in bank.kernels_low:
        kd = k_dev.shape[3]
        D = rng.randint(0, 5, (k_dev.shape[1], H1 // t1 + kd - 1,
                               W1 // t1 + kd - 1)).astype(np.uint8)
        got = np.asarray(jax.jit(mp.coarse_sweep)(D, k_dev))
        want = _numpy_coarse(D.astype(np.int64), np.asarray(k_dev, np.int64))
        check(got.shape == want.shape, f"coarse shape {got.shape} vs {want.shape}")
        bad += int((got != want).sum())
        worst = max(worst, int(np.abs(got - want).max()))
        log(f"  coarse sweep {bank.num_templates} templates x "
            f"{D.shape} planes: {int((got != want).sum())} mismatches, "
            f"max |err| {int(np.abs(got - want).max())}")
    return bad, worst


def stage_refine(bank, frame_shape, t0, max_dr, n_cand=16, seed=0):
    """Level-0 refine of ``n_cand`` bank templates at random in-frame
    anchors over random decimated planes at the production shape, with
    two zero-feature slots: (mismatches, max |error|)."""
    import jax
    import jax.numpy as jnp

    from object_detector_6d_tpu.match import program as mp

    rng = np.random.RandomState(seed)
    P, Hp, Wp = mp.refine_planes_shape(frame_shape, t0, max_dr)
    D = rng.randint(0, 5, (P, Hp, Wp)).astype(np.int8)
    sizes = bank.sizes[0]
    bad, worst = 0, 0
    for mod in range(len(bank.feat_plane)):
        tids = rng.randint(0, bank.num_templates, n_cand)
        plane = np.asarray(bank.feat_plane[mod])[tids]
        dr = np.asarray(bank.feat_dr[mod])[tids]
        dc = np.asarray(bank.feat_dc[mod])[tids]
        nfe = np.asarray(bank.feat_n[mod])[tids].copy()
        nfe[:2] = 0  # invalid top-K slots
        H, W = frame_shape
        br = rng.randint(0, np.maximum(1, (H - sizes[tids, 1]) // t0 - 15))
        bc = rng.randint(0, np.maximum(1, (W - sizes[tids, 0]) // t0 - 15))
        r0 = (br[:, None] + dr).astype(np.int32)
        c0 = (bc[:, None] + dc).astype(np.int32)
        got = np.asarray(jax.jit(mp.refine_tiles)(
            jnp.asarray(D), jnp.asarray(plane), jnp.asarray(r0),
            jnp.asarray(c0), jnp.asarray(nfe)))
        want = np.zeros((n_cand, 16, 16), np.int64)
        for k in range(n_cand):
            for f in range(nfe[k]):
                want[k] += D[plane[k, f], r0[k, f]:r0[k, f] + 16,
                             c0[k, f]:c0[k, f] + 16]
        m = int((got != want).sum())
        bad += m
        worst = max(worst, int(np.abs(got - want).max()))
        log(f"  refine {n_cand} candidates x {plane.shape[1]} feature "
            f"slots over {D.shape} planes (modality {mod}): {m} "
            f"mismatches, max |err| {int(np.abs(got - want).max())}")
    return bad, worst


def stage_geometry():
    """Cloud and FALS normals (the detect program's geometry) on the
    golden frame: (cloud max |err| m, normal p99 deg, normal mean deg)."""
    import jax
    import jax.numpy as jnp

    from object_detector_6d_tpu.geom.backproject import depth_to_3d
    from object_detector_6d_tpu.geom.normals import FalsNormals

    g = np.load(os.path.join(GOLDEN, "geom.npz"))
    H, W = g["depth_u16"].shape
    est = FalsNormals(H, W, g["K"])
    Kj = jnp.asarray(g["K"])

    @jax.jit
    def geometry(d):
        cloud = depth_to_3d(d, Kj)
        return cloud, est(cloud)

    cloud, n = (np.asarray(x) for x in geometry(jnp.asarray(g["depth_u16"])))
    want = g["p3d"]
    check((np.isfinite(cloud) == np.isfinite(want)).all(),
          "cloud NaN structure differs from the golden")
    fin = np.isfinite(want)
    cloud_err = float(np.abs(cloud[fin] - want[fin]).max())
    exp = g["normals_fals"]
    m = np.isfinite(n).all(-1) & np.isfinite(exp).all(-1)
    m[:4] = m[-4:] = False
    m[:, :4] = m[:, -4:] = False
    ang = np.degrees(np.arccos(np.clip(np.abs((n[m] * exp[m]).sum(-1)), 0, 1)))
    p99, mean = float(np.quantile(ang, 0.99)), float(ang.mean())
    log(f"  geometry {H}x{W}: cloud max |err| {cloud_err:.3g} m (bound 1e-5); "
        f"normals p99 {p99:.3f} deg (bound 2.0), mean {mean:.3f} deg "
        f"(bound 0.5)")
    return cloud_err, p99, mean


def phase_stages(bank, frame_shape, t_at_level, max_dr):
    bad, total = stage_quantizers()
    check(bad == 0, f"quantizers: {bad} of {total} pixels differ from the "
          "OpenCV goldens")
    bad, worst = stage_coarse(bank, frame_shape, t_at_level[1])
    check(bad == 0, f"coarse sweep: {bad} mismatches (max {worst})")
    bad, worst = stage_refine(bank, frame_shape, t_at_level[0], max_dr)
    check(bad == 0, f"refine: {bad} mismatches (max {worst})")
    cloud_err, p99, mean = stage_geometry()
    check(cloud_err <= 1e-5 and p99 < 2.0 and mean < 0.5,
          "geometry outside its oracle bounds")


# ----------------------------------------------------------------------
# phase 3: Detector.match against the golden match lists
# ----------------------------------------------------------------------


def phase_match():
    from object_detector_6d_tpu.api.detector import Detector
    from object_detector_6d_tpu.quant.features import Feature, Template

    g = np.load(os.path.join(GOLDEN, "match_e2e.npz"))
    classes = ["sphA", "sphB"]
    det = Detector()
    for cid in classes:
        tps = []
        for i in range(4):
            w, h, lvl = g[f"{cid}_meta{i}"]
            tps.append(Template(int(w), int(h), int(lvl), [
                Feature(int(x), int(y), int(lab))
                for x, y, lab in g[f"{cid}_feat{i}"]]))
        det.add_synthetic_template(tps, cid)
    for scene, thr in (("sceneA", 80.0), ("sceneS", 80.0), ("scene2", 70.0),
                       ("scene0", 50.0)):
        ms = det.match([g[f"{scene}_bgr"], g[f"{scene}_dep"]], thr)
        got = np.array([(m.x, m.y, m.similarity, classes.index(m.class_id),
                         m.template_id) for m in ms], np.float64).reshape(-1, 5)
        want = g[f"{scene}_matches"]
        same = (got.shape == want.shape
                and (got[:, [0, 1, 3, 4]] == want[:, [0, 1, 3, 4]]).all())
        err = float(np.abs(got[:, 2] - want[:, 2]).max()) if same and len(got) else 0.0
        log(f"  match {scene} @ {thr:.0f}: {len(got)} matches "
            f"(golden {len(want)}), max |similarity err| {err:.2g}")
        check(same and err <= 1e-3, f"match list differs on {scene}")


# ----------------------------------------------------------------------
# phase 4: headline batch on the GPU vs the same program on the CPU
# ----------------------------------------------------------------------


def _rot_deg(a, b):
    """Angle between two rotations; the chord form stays accurate near 0."""
    chord = np.linalg.norm(a[:3, :3] - b[:3, :3]) / np.sqrt(8.0)
    return float(np.degrees(2.0 * np.arcsin(min(1.0, chord))))


def compare_detections(out_a, out_b, label, confident_residual):
    """Detections of two runs of the same batch, per frame, keyed by
    (class, template, match x/y).

    A detection whose ICP residual is at most ``confident_residual`` on
    either side must appear on both, with poses within POSE_TOL_MM /
    POSE_TOL_DEG. A fit whose residual sits near the acceptance gate
    (``max_residual``) did not lock onto a surface: f32 summation order
    moves it by centimetres and across the gate, so such marginal
    detections are counted, not compared. Returns (n_confident, max
    translation mm, max rotation deg, n_marginal_unmatched)."""
    check(len(out_a) == len(out_b), f"{label}: frame counts differ")
    n, dt, dr, loose = 0, 0.0, 0.0, 0
    for f, (a, b) in enumerate(zip(out_a, out_b)):
        ka = {(p.class_id, p.template_id, p.match_x, p.match_y): p for p in a}
        kb = {(p.class_id, p.template_id, p.match_x, p.match_y): p for p in b}
        for key in ka.keys() | kb.keys():
            pa, pb = ka.get(key), kb.get(key)
            if min(p.residual for p in (pa, pb) if p is not None) > confident_residual:
                loose += (pa is None) != (pb is None)
                continue
            check(pa is not None and pb is not None,
                  f"{label}: frame {f}: confident detection {key} on one side only")
            dt = max(dt, float(np.linalg.norm(pa.pose[:3, 3] - pb.pose[:3, 3])) * 1e3)
            dr = max(dr, _rot_deg(pa.pose, pb.pose))
            n += 1
    log(f"  {label}: {n} confident detections (residual <= "
        f"{confident_residual:g} m), max translation diff {dt:.4f} mm (tol "
        f"{POSE_TOL_MM}), max rotation diff {dr:.4f} deg (tol {POSE_TOL_DEG}); "
        f"{loose} marginal fits on one side only")
    check(n > 0, f"{label}: no confident detections to compare")
    check(dt <= POSE_TOL_MM and dr <= POSE_TOL_DEG,
          f"{label}: poses differ beyond tolerance")
    return n, dt, dr, loose


def per_class(out):
    counts = {}
    for frame in out:
        for p in frame:
            counts[p.class_id] = counts.get(p.class_id, 0) + 1
    return counts


def phase_detect(jax, pd, K, depths, rgbs, cpu_device):
    pd.counters.counts["overflow_fallback"] = 0
    t = time.time()
    out = pd.detect_fused_batch(depths, K, rgbs)
    log(f"  detect_fused_batch B={len(out)}: {time.time() - t:.1f} s "
        f"(compile + run); detections per class {per_class(out)}; "
        f"overflow fallbacks {pd.counters.counts['overflow_fallback']}")
    check(sum(len(f) for f in out) > 0, "headline batch detected nothing")
    for frame in out:
        for p in frame:
            check(np.isfinite(p.pose).all(), "non-finite pose")
    # the same program, compiled for the host CPU: rebuild the bank and
    # program caches with the CPU as default device, then drop them
    cache = pd.detector._kernel_cache
    cache.clear()
    t = time.time()
    with jax.default_device(cpu_device):
        out_cpu = pd.detect_fused_batch(np.asarray(depths), K, np.asarray(rgbs))
    cache.clear()
    log(f"  same batch on {cpu_device}: {time.time() - t:.1f} s")
    compare_detections(out, out_cpu, "GPU vs CPU", CONFIDENT * pd.params.max_residual)
    return out


def phase_streaming(pd, K, make_frames, n_cam=4, n_ticks=3):
    from object_detector_6d_tpu.api.streaming import StreamingDetector

    sd = StreamingDetector(pd, n_cameras=n_cam)
    for tick in range(n_ticks):
        d, g = make_frames(n_cam, 100 + tick)
        t = time.time()
        out = sd.process(d, K, g)
        dt = time.time() - t
        check(len(out) == n_cam, "streaming tick returned the wrong frame count")
        n = sum(len(f) for f in out)
        check(n > 0 and all(np.isfinite(p.pose).all() for f in out for p in f),
              "streaming tick: no detections or non-finite poses")
        log(f"  tick {tick}: {n_cam} cameras, {n} detections, {dt * 1e3:.1f} ms")


def phase_add(n_scenes=64):
    """ADD-0.1d of each of ADD_SETS, ours against the oracle; returns
    {set: parity_add.run_ours summary}."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import parity_add

    out = {}
    for name in ADD_SETS:
        r = parity_add.run_ours(name, promoted=True, n_scenes=n_scenes,
                                per_scene=False)
        ours = 100.0 * r["ours_hits"] / r["n"]
        orc = 100.0 * r["oracle_hits"] / r["n"]
        log(f"  {name} ADD-0.1d over {r['n']} scenes: ours {ours:.1f}% "
            f"(mean ADD {r['ours_mean_add_mm']:.3f} mm), oracle {orc:.1f}% "
            f"(mean ADD {r['oracle_mean_add_mm']:.3f} mm)")
        check(ours >= orc - ADD_MARGIN_PP,
              f"{name}: ADD-0.1d {ours:.1f}% trails the oracle's {orc:.1f}%")
        out[name] = r
    return out


def phase_gpu_tests():
    """Run the card-only tests in this process (conftest keeps the GPU
    when ODC_TEST_DEVICE=gpu)."""
    import pytest

    class Count:
        passed = failed = skipped = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1
            elif report.failed:
                Count.failed += 1
            elif report.skipped:
                Count.skipped += 1

    os.environ["ODC_TEST_DEVICE"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")], plugins=[Count()])
    log(f"  pytest -m gpu: {Count.passed} passed, {Count.failed} failed, "
        f"{Count.skipped} skipped (exit {int(rc)})")
    check(int(rc) == 0 and Count.passed > 0 and Count.failed == 0
          and Count.skipped == 0, "card-only tests failed")


def phase_four(jax, pd, K, depths, rgbs):
    """Sharded detect on a 2x2 (data, model) mesh vs the single-device
    program on device 0."""
    from object_detector_6d_tpu.api.pipeline import PoseDetector
    from object_detector_6d_tpu.parallel.sharding import make_mesh

    mesh = make_mesh(4)
    log(f"  mesh {dict(mesh.shape)} over {mesh.devices.ravel().tolist()}")
    pdm = PoseDetector(detector=pd.detector, params=pd.params,
                       model_points=pd.model_points, mesh=mesh)
    pdm.views = pd.views
    t = time.time()
    out_mesh = pdm.detect_fused_batch(depths, K, rgbs)
    log(f"  sharded detect_fused_batch B={len(out_mesh)}: "
        f"{time.time() - t:.1f} s; detections per class {per_class(out_mesh)}")
    with jax.default_device(jax.devices()[0]):
        out_one = pd.detect_fused_batch(np.asarray(depths), K, np.asarray(rgbs))
    check(sum(len(f) for f in out_one) > 0, "single-device batch detected nothing")
    compare_detections(out_mesh, out_one, "4-GPU mesh vs 1 GPU",
                       CONFIDENT * pd.params.max_residual)


def _phase(name, fn, *a, **kw):
    log(f"[{name}]")
    t = time.time()
    r = fn(*a, **kw)
    log(f"[{name}] ok ({time.time() - t:.1f} s)")
    return r


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU sharded detect check")
    args = ap.parse_args(argv)

    _keep_host_cpu()
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    from object_detector_6d_tpu.utils.device import gpu_name_and_power, require_gpu

    devs = require_gpu(jax)
    import bench
    from object_detector_6d_tpu.utils import compile_cache

    log(f"[device] jax {jax.__version__}, {len(devs)} x {devs[0].device_kind}")
    log("[device] nvidia-smi --query-gpu=name,power.limit:")
    log(gpu_name_and_power())
    log(f"[device] compile cache: {compile_cache.enable()}")

    pd, K, make_frames = bench.build_detector(jnp)
    depths, rgbs = make_frames(HEADLINE_BATCH, 0)
    if args.four:
        check(len(devs) >= 4, f"--four needs 4 GPUs, JAX reports {len(devs)}")
        _phase("four", phase_four, jax, pd, K, depths, rgbs)
    else:
        bank = pd.detector.get_bank(None)
        max_dr = ((bank.max_dr // 16) + 1) * 16
        _phase("stages", phase_stages, bank, (480, 640),
               pd.detector.t_at_level, max_dr)
        _phase("match", phase_match)
        _phase("detect", phase_detect, jax, pd, K, depths, rgbs,
               jax.devices("cpu")[0])
        _phase("streaming", phase_streaming, pd, K, make_frames)
        _phase("add", phase_add)
        _phase("gpu-tests", phase_gpu_tests)
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}), flush=True)


if __name__ == "__main__":
    main()
