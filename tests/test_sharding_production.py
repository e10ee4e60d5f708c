"""Sharded == unsharded at PRODUCTION shape.

The round-2 equality proof ran the mesh program at 120x160 toy shapes;
this test runs the REAL deployment shape — 640x480 frames, a 32-template
two-class bank where every template carries a registered training view
(so hypothesis lift, view-pose composition, and multi-class NMS all
execute on the sharded path) — through PoseDetector.detect_fused_batch
with and without the (data, model) mesh, and demands identical
detections. Slow: two full-resolution fused-program compiles on the
1-core CPU host.
"""

import pathlib
import sys

import numpy as np
import pytest

import jax

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
import scenes  # noqa: E402

from object_detector_6d_tpu.api.pipeline import PoseDetector
from object_detector_6d_tpu.core.config import DetectParams, ICPParams
from object_detector_6d_tpu.parallel.sharding import make_mesh

pytestmark = pytest.mark.slow


def _bgr(gray):
    return np.repeat(gray[..., None], 3, axis=2)


def _train(pd, K):
    """Two classes x 16 rigidly shifted views = 32 templates, all with
    registered view poses (production-realistic bank shape)."""
    n_views = 0
    for cid, scale in (("objA", 1.0), ("objB", 0.78)):
        dep, gray, mask = scenes.snowman_scene(scale=scale)
        for k in range(16):
            off = np.array([(k % 4 - 1.5) * 0.012, (k // 4 - 1.5) * 0.010,
                            (k % 3 - 1) * 0.008])
            d2, m2, g2 = scenes.render_translated(dep, mask, K, off)
            P = np.eye(4, dtype=np.float32)
            P[:3, 3] = off
            tid = pd.add_view(cid, d2, K, m2.astype(np.uint8) * 255,
                              rgb=_bgr(g2), view_pose=P)
            assert tid == k, (cid, k, tid)
            n_views += 1
    return n_views


def test_production_shape_sharded_equals_unsharded():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    mesh = make_mesh(8)
    K = scenes.K_DEFAULT

    params = DetectParams(match_threshold=75.0, max_hypotheses=8,
                          icp=ICPParams(iterations=16, num_levels=4))
    pd_plain = PoseDetector(params=params, model_points=256)
    assert _train(pd_plain, K) == 32
    pd_mesh = PoseDetector(detector=pd_plain.detector, params=params,
                           model_points=256, mesh=mesh)
    pd_mesh.views = pd_plain.views

    # two-object scene batch (B=2 divides the data axis)
    depA, grayA, maskA = scenes.snowman_scene()
    depB, grayB, maskB = scenes.snowman_scene(scale=0.78)
    frames_d, frames_g = [], []
    rng = np.random.RandomState(3)
    for b in range(2):
        rA = scenes.render_translated(
            depA, maskA, K, np.array([0.05, -0.02, 0.01]) * (b + 1))
        rB = scenes.render_translated(
            depB, maskB, K, np.array([-0.27, 0.11, 0.03]))
        d, _, g = scenes.merge_scenes([rA, rB])
        frames_d.append(d)
        frames_g.append(_bgr(g))
    depths = np.stack(frames_d)
    rgbs = np.stack(frames_g)

    out_plain = pd_plain.detect_fused_batch(depths, K, rgbs)
    out_mesh = pd_mesh.detect_fused_batch(depths, K, rgbs)

    assert sum(len(p) for p in out_plain) > 0, "scene produced no detections"
    for b in range(2):
        assert len(out_plain[b]) == len(out_mesh[b]), (
            f"frame {b}: {len(out_plain[b])} vs {len(out_mesh[b])}")
        for p, q in zip(out_plain[b], out_mesh[b]):
            assert p.class_id == q.class_id
            assert p.template_id == q.template_id
            np.testing.assert_allclose(p.pose, q.pose, atol=1e-4)
            np.testing.assert_allclose(p.residual, q.residual, atol=1e-5)
