"""Fused single-call detect() vs the host-orchestrated pipeline.

The fused program (api/detect_program.py) must recover the same poses
as PoseDetector.detect() — same match candidates, same multi-depth
lift, point-to-plane ICP with projective instead of brute-force NN
association (refine/projective.py). Poses agree to millimeters, not
bit-exactly (documented deviation: association rule differs).
"""

import functools
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402

from object_detector_6d_tpu.api.pipeline import PoseDetector
from object_detector_6d_tpu.core.config import DetectParams, ICPParams


def _bgr(gray):
    return np.repeat(gray[..., None], 3, axis=2)


def _make_detector():
    return PoseDetector(
        params=DetectParams(
            match_threshold=70.0,
            max_hypotheses=4,
            icp=ICPParams(iterations=60, num_levels=3),
        )
    )


@functools.lru_cache(maxsize=1)
def _trained():
    """ONE trained detector shared by every test in this module: the
    compiled fused-program variants live in detector._kernel_cache, and
    recompiling them per test dominated the fast-suite wall clock. Tests
    only call detect methods (no detector mutation), so sharing is safe."""
    det = _make_detector()
    K = scenes.K_DEFAULT
    dep, gray, mask = scenes.snowman_scene()
    tid = det.add_view("obj", dep, K, mask.astype(np.uint8) * 255, rgb=_bgr(gray))
    assert tid == 0
    return det, K, dep, gray, mask


def test_fused_matches_host_pipeline():
    det, K, dep, gray, mask = _trained()
    t_true = np.array([0.055, -0.022, -0.04])
    dep2, _, gray2 = scenes.render_translated(dep, mask, K, t_true)

    host = det.detect(dep2, K, rgb=_bgr(gray2))
    fused = det.detect_fused(dep2, K, rgb=_bgr(gray2))
    assert host and fused
    hp, fp = host[0], fused[0]
    assert fp.class_id == hp.class_id == "obj"
    # same ground truth within the host test's own tolerance
    t = fp.pose[:3, 3]
    assert np.all(np.abs(t - t_true) < 0.01), t
    ang = np.degrees(
        np.arccos(np.clip((np.trace(fp.pose[:3, :3]) - 1) / 2, -1, 1))
    )
    assert ang < 5.0
    # and close to the host path's refined pose (different association)
    assert np.all(np.abs(fp.pose[:3, 3] - hp.pose[:3, 3]) < 0.01)
    assert fp.residual < 5e-3


def test_fused_empty_scene():
    det, K, dep, gray, mask = _trained()
    flat_dep = np.full((480, 640), 1500, np.uint16)
    flat_rgb = np.full((480, 640, 3), 128, np.uint8)
    assert det.detect_fused(flat_dep, K, rgb=flat_rgb) == []


def test_fused_batch_two_frames():
    """Batched fused detect: per-frame results match single-frame calls."""
    det, K, dep, gray, mask = _trained()
    t1 = np.array([0.055, -0.022, -0.04])
    t2 = np.array([-0.03, 0.04, 0.02])
    d1, _, g1 = scenes.render_translated(dep, mask, K, t1)
    d2, _, g2 = scenes.render_translated(dep, mask, K, t2)
    depths = np.stack([d1, d2])
    rgbs = np.stack([_bgr(g1), _bgr(g2)])
    out = det.detect_fused_batch(depths, K, rgbs)
    assert len(out) == 2
    for poses, t_true in zip(out, (t1, t2)):
        assert poses, "no detections in batched frame"
        t = poses[0].pose[:3, 3]
        assert np.all(np.abs(t - t_true) < 0.01), (t, t_true)


def test_fused_dispatch_multi_equals_batches():
    """ONE scanned execution over G frame batches == per-batch calls.

    detect_fused_dispatch_multi dispatches once per G*B frames; results
    must be identical to G separate detect_fused_batch calls."""
    det, K, dep, gray, mask = _trained()
    ts = [np.array([0.055, -0.022, -0.04]), np.array([-0.03, 0.04, 0.02]),
          np.array([0.01, 0.05, -0.02]), np.array([-0.05, -0.03, 0.03])]
    frames = [scenes.render_translated(dep, mask, K, t) for t in ts]
    depths = np.stack([f[0] for f in frames]).reshape(2, 2, 480, 640)
    rgbs = np.stack([_bgr(f[2]) for f in frames]).reshape(2, 2, 480, 640, 3)

    ref = [det.detect_fused_batch(depths[g], K, rgbs[g]) for g in range(2)]
    multi = det.detect_fused_finalize_multi(
        det.detect_fused_dispatch_multi(depths, K, rgbs))
    assert len(multi) == 2
    for g in range(2):
        for b in range(2):
            assert len(multi[g][b]) == len(ref[g][b]) > 0
            for p, q in zip(multi[g][b], ref[g][b]):
                assert p.class_id == q.class_id
                np.testing.assert_allclose(p.pose, q.pose, atol=1e-6)


def test_solves_per_assoc_two_matches_one():
    """ICPParams.solves_per_assoc=2 (associate once, two GN solves on the
    fixed pairs — halves the scene-gather traffic, the projective ICP
    stage's entire device cost) must land on the same detections with
    sub-mm pose agreement vs the solves=1 schedule."""
    import dataclasses as dc

    det, K, dep, gray, mask = _trained()
    t_true = np.array([0.04, -0.015, -0.03])
    dep2, _, gray2 = scenes.render_translated(dep, mask, K, t_true)

    outs = {}
    for s in (1, 2):
        pd = PoseDetector(
            detector=det.detector,
            params=dc.replace(det.params,
                              icp=dc.replace(det.params.icp,
                                             solves_per_assoc=s)),
            model_points=det.model_points,
        )
        pd.views = det.views
        outs[s] = pd.detect_fused(dep2, K, rgb=_bgr(gray2))
    assert outs[1] and outs[2]
    assert len(outs[1]) == len(outs[2])
    for p1, p2 in zip(outs[1], outs[2]):
        assert p1.class_id == p2.class_id
        dt = np.abs(np.asarray(p1.pose)[:3, 3] - np.asarray(p2.pose)[:3, 3])
        assert dt.max() < 1e-3, dt
        # both recover the ground truth
        assert np.all(np.abs(np.asarray(p2.pose)[:3, 3] - t_true) < 0.01)


def test_associate_window_exact_gather():
    """_associate_window (two one-hot MXU contractions over a scene
    window crop) must return BIT-EXACT the same correspondences as the
    full-scene row gather (_associate) for every in-window point, and
    weight 0 for points projecting outside the window."""
    import jax.numpy as jnp

    from object_detector_6d_tpu.refine.projective import (
        _associate, _associate_window)

    rng = np.random.RandomState(3)
    H, W, C = 64, 96, 7
    fx = fy = 80.0
    cx, cy = W / 2.0, H / 2.0
    # random but valid packed scene: points ~1 m deep, unit-ish normals
    scene_img = rng.uniform(-1, 1, (H, W, C)).astype(np.float32)
    scene_img[..., 2] = rng.uniform(0.8, 1.2, (H, W))
    scene_img[..., 6] = (rng.uniform(size=(H, W)) > 0.2)
    scene7 = jnp.asarray(scene_img.reshape(-1, C))
    # model points that project across the whole frame (some outside
    # the window), at depths near the scene so the distance cap passes
    n = 160
    mdl = np.zeros((n, 6), np.float32)
    u = rng.uniform(-4, W + 4, n)
    v = rng.uniform(-4, H + 4, n)
    z = rng.uniform(0.8, 1.2, n)
    mdl[:, 0] = (u - cx) / fx * z
    mdl[:, 1] = (v - cy) / fy * z
    mdl[:, 2] = z
    mdl[:, 3:] = rng.normal(size=(n, 3))
    mdl[:, 3:] /= np.linalg.norm(mdl[:, 3:], axis=1, keepdims=True)
    pose = jnp.eye(4, dtype=jnp.float32)
    mask = jnp.ones(n, bool)
    cap, ncos = jnp.float32(1e9), jnp.float32(-2.0)  # gates off

    qp_f, qn_f, w_f = _associate(pose, jnp.asarray(mdl), mask, scene7,
                                 fx, fy, cx, cy, H, W, cap, ncos)
    win = 48
    y0, x0 = 8, 24
    win_img = jnp.asarray(scene_img[y0:y0 + win, x0:x0 + win])
    qp_w, qn_w, w_w = _associate_window(
        pose, jnp.asarray(mdl), mask, win_img,
        jnp.int32(y0), jnp.int32(x0), fx, fy, cx, cy, cap, ncos)

    ui = np.round(fx * mdl[:, 0] / mdl[:, 2] + cx).astype(int)
    vi = np.round(fy * mdl[:, 1] / mdl[:, 2] + cy).astype(int)
    in_win = ((ui >= x0) & (ui < x0 + win) & (vi >= y0) & (vi < y0 + win))
    assert in_win.sum() >= 20 and (~in_win).sum() >= 20
    np.testing.assert_array_equal(np.asarray(qp_w)[in_win],
                                  np.asarray(qp_f)[in_win])
    np.testing.assert_array_equal(np.asarray(qn_w)[in_win],
                                  np.asarray(qn_f)[in_win])
    np.testing.assert_array_equal(np.asarray(w_w)[in_win],
                                  np.asarray(w_f)[in_win])
    assert (np.asarray(w_w)[~in_win] == 0).all()


def test_finest_assoc_polish_budget_matches_full():
    """ICPParams.finest_assoc=2 (cap the full-model finest level at two
    associations — it holds ~half the stage's gather rows) must land on
    the same detections with sub-mm pose agreement vs the uncapped
    schedule: the stride-2 level has already converged the pose, so the
    finest level's correspondence field is static from its first
    association (config.py docstring)."""
    import dataclasses as dc

    det, K, dep, gray, mask = _trained()
    t_true = np.array([-0.03, 0.02, 0.035])
    dep2, _, gray2 = scenes.render_translated(dep, mask, K, t_true)

    outs = {}
    for fa in (0, 2):
        pd = PoseDetector(
            detector=det.detector,
            params=dc.replace(det.params,
                              icp=dc.replace(det.params.icp,
                                             finest_assoc=fa)),
            model_points=det.model_points,
        )
        pd.views = det.views
        outs[fa] = pd.detect_fused(dep2, K, rgb=_bgr(gray2))
    assert outs[0] and outs[2]
    assert len(outs[0]) == len(outs[2])
    for p1, p2 in zip(outs[0], outs[2]):
        assert p1.class_id == p2.class_id
        dt = np.abs(np.asarray(p1.pose)[:3, 3] - np.asarray(p2.pose)[:3, 3])
        assert dt.max() < 1e-3, dt
        assert np.all(np.abs(np.asarray(p2.pose)[:3, 3] - t_true) < 0.01)


def test_fine_compact_equals_full_when_survivors_fit():
    """Survivor compaction (DetectParams.fine_compact, config-4 regime):
    when the number of coarse-phase survivors fits the compacted lane
    budget, the compacted program returns exactly the same detections
    as the uncompacted one — compaction is pure capacity semantics, like
    max_candidates (PARITY.md deviation 2)."""
    import dataclasses as dc

    det, K, dep, gray, mask = _trained()
    t_true = np.array([0.04, -0.015, -0.03])
    dep2, _, gray2 = scenes.render_translated(dep, mask, K, t_true)

    det_c = PoseDetector(
        detector=det.detector,
        params=dc.replace(det.params, max_hypotheses=8, fine_compact=4),
        model_points=det.model_points,
    )
    det_c.views = det.views
    det_f = PoseDetector(
        detector=det.detector,
        params=dc.replace(det.params, max_hypotheses=8),
        model_points=det.model_points,
    )
    det_f.views = det.views

    full = det_f.detect_fused(dep2, K, rgb=_bgr(gray2))
    comp = det_c.detect_fused(dep2, K, rgb=_bgr(gray2))
    assert full and comp
    assert len(full) == len(comp)
    for pf, pc in zip(full, comp):
        assert pf.class_id == pc.class_id
        np.testing.assert_allclose(pc.pose, pf.pose, atol=1e-6)
        np.testing.assert_allclose(pc.residual, pf.residual, atol=1e-8)
