"""End-to-end ADD parity regression vs the checked-in oracle goldens.

tools/parity_add.py produced the north-star numbers for all four
BASELINE config analogs (PARITY.md end-to-end table, 2026-08-19: ours
meets or beats the oracle on base/occl/two/views); its oracle sides are
checked in as tests/golden/parity_{add,occl,two,views}_oracle.npz.
These tests re-run the production ``detect_fused`` path on a
deterministic subset of each config's scenes and assert ADD against the
goldens, so the parity table cannot regress unnoticed between full
parity runs. Subsets
deliberately include the scenes where ours beats the oracle (occl scene
8, two scene 9 objB) — those are load-bearing claims in PARITY.md.
"""

import pathlib
import sys

import numpy as np
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))

SCENE_SUBSET = [0, 7, 13]  # rotation-heavy picks from the base scene set
# (pins address scenes by index; the round-5 64-scene sets keep the
# round-4 scenes as a bit-identical prefix, so indices stay valid)

import functools


def _make_detector(parity_add):
    from object_detector_6d_tpu.api.pipeline import PoseDetector
    from object_detector_6d_tpu.core.config import DetectParams, ICPParams

    return PoseDetector(
        params=DetectParams(
            match_threshold=parity_add.MATCH_THRESHOLD, max_hypotheses=8,
            icp=ICPParams(iterations=32, num_levels=4),
        ),
        model_points=parity_add.MODEL_POINTS,
        scene_window=parity_add.LIFT_WINDOW,
    )


@functools.lru_cache(maxsize=1)
def _single_view_detector():
    """Shared trained detector for the base + occl tests (identical bank
    and params -> identical compiled programs; recompiling them per test
    dominated the fast suite)."""
    import parity_add

    K, dep, gray, mask, _ = parity_add.scene_set()
    bgr = np.repeat(gray[..., None], 3, axis=2)
    pd = _make_detector(parity_add)
    assert pd.add_view("obj", dep, K, mask.astype(np.uint8) * 255,
                       rgb=bgr) == 0
    return pd


def test_detect_fused_add_vs_oracle_golden(golden):
    import parity_add

    g = golden("parity_add_oracle")
    model_pts = g["model"][:, :3]
    diam = float(g["diameter"])
    thr_01d = 0.1 * diam

    K, dep, gray, mask, scene_list = parity_add.scene_set()
    pd = _single_view_detector()

    for i in SCENE_SUBSET:
        gt, d2, g2, m2 = scene_list[i]
        poses = pd.detect_fused(d2, K, rgb=np.repeat(g2[..., None], 3, axis=2))
        assert poses, f"scene {i}: no detection"
        ours_add = parity_add.add_metric(np.asarray(poses[0].pose), gt, model_pts)
        # north-star gate: ADD-0.1d success on every subset scene
        assert ours_add < thr_01d, f"scene {i}: ADD {ours_add*1e3:.2f} mm"
        # regression gate: the full-set mean was 0.39 mm (oracle 0.44 mm);
        # 2 mm leaves headroom for schedule tweaks while still catching
        # any real accuracy break an order of magnitude before 0.1d
        assert ours_add < 2e-3, f"scene {i}: ADD {ours_add*1e3:.2f} mm > 2 mm"
        if g["est_found"][i]:
            orc_add = parity_add.add_metric(g["est_poses"][i], gt, model_pts)
            assert ours_add < max(2.0 * orc_add, 1.5e-3), (
                f"scene {i}: ours {ours_add*1e3:.2f} mm vs oracle "
                f"{orc_add*1e3:.2f} mm"
            )


def test_detect_fused_occl_vs_oracle_golden(golden):
    """Occlusion config (config 3 analog): subset incl. scene 8, the
    scene the oracle's NN ICP loses under the slab and ours recovers
    (PARITY.md table row 2)."""
    import parity_add

    g = golden("parity_occl_oracle")
    model_pts = g["model"][:, :3]
    thr_01d = 0.1 * float(g["diameter"])

    K, dep, gray, mask, scene_list = parity_add.scene_set(occlude=True)
    pd = _single_view_detector()

    for i in (8, 15):
        gt, d2, g2, m2 = scene_list[i]
        poses = pd.detect_fused(
            d2, K, rgb=np.repeat(g2[..., None], 3, axis=2),
            match_threshold=parity_add.OCCL_THRESHOLD)
        assert poses, f"occl scene {i}: no detection"
        ours_add = parity_add.add_metric(np.asarray(poses[0].pose), gt,
                                         model_pts)
        assert ours_add < thr_01d, f"occl scene {i}: ADD {ours_add*1e3:.2f} mm"
        # full-set ours mean was 0.56 mm; 3 mm catches a real break
        assert ours_add < 3e-3, f"occl scene {i}: ADD {ours_add*1e3:.2f} mm"
    # scene 8 is the oracle's honest miss — the beat must hold
    assert not g["est_found"][8]


@pytest.mark.slow
def test_detect_fused_two_class_vs_oracle_golden(golden):
    """Two-class config (config 4 analog): both classes per scene.
    Scene 9 objB is where the oracle latches a wrong fit (44 mm ADD)
    and ours stays sub-mm (PARITY.md table row 3)."""
    import parity_add

    g = golden("parity_two_oracle")
    models = {"objA": g["modelA"][:, :3], "objB": g["modelB"][:, :3]}
    thr = {"objA": 0.1 * float(g["diameterA"]),
           "objB": 0.1 * float(g["diameterB"])}

    K, train, scene_list = parity_add.scene_set_two()
    pd = _make_detector(parity_add)
    for cid in ("objA", "objB"):
        dep, gray, mask = train[cid]
        assert pd.add_view(cid, dep, K, mask.astype(np.uint8) * 255,
                           rgb=np.repeat(gray[..., None], 3, axis=2)) == 0

    for i in (0, 9):
        (gtA, gtB), d2, g2, m2 = scene_list[i]
        poses = pd.detect_fused(d2, K, rgb=np.repeat(g2[..., None], 3, axis=2))
        for cid, gt in (("objA", gtA), ("objB", gtB)):
            best = next((p for p in poses if p.class_id == cid), None)
            assert best is not None, f"two scene {i} {cid}: no detection"
            ours_add = parity_add.add_metric(np.asarray(best.pose), gt,
                                             models[cid])
            assert ours_add < thr[cid], (
                f"two scene {i} {cid}: ADD {ours_add*1e3:.2f} mm")
            # full-set ours mean was 0.93 mm; 4 mm catches a real break
            assert ours_add < 4e-3, (
                f"two scene {i} {cid}: ADD {ours_add*1e3:.2f} mm")


@pytest.mark.slow
def test_detect_fused_views_vs_oracle_golden(golden):
    """Multi-view-bank config (configs 2/4 rotation regime): 5-view
    training arc, detection at unseen yaws with view-pose composition
    (PARITY.md table row 4)."""
    import parity_add

    g = golden("parity_views_oracle")
    model_pts = g["model"][:, :3]
    thr_01d = 0.1 * float(g["diameter"])

    K, dep, gray, mask, train, scene_list = parity_add.scene_set_views()
    pd = _make_detector(parity_add)
    for k, (P, d2, g2, m2) in enumerate(train):
        assert pd.add_view("obj", d2, K, m2.astype(np.uint8) * 255,
                           rgb=np.repeat(g2[..., None], 3, axis=2),
                           view_pose=P) == k

    for i in (0, 7):  # yaws -17 and +17: the arc edges
        gt, d2, g2, m2 = scene_list[i]
        poses = pd.detect_fused(d2, K, rgb=np.repeat(g2[..., None], 3, axis=2))
        assert poses, f"views yaw {parity_add.TEST_DEGS[i]}: no detection"
        ours_add = parity_add.add_metric(np.asarray(poses[0].pose), gt,
                                         model_pts)
        assert ours_add < thr_01d, (
            f"views yaw {parity_add.TEST_DEGS[i]}: ADD {ours_add*1e3:.2f} mm")
        # full-set ours mean was 0.40 mm; 2 mm catches a real break
        assert ours_add < 2e-3, (
            f"views yaw {parity_add.TEST_DEGS[i]}: ADD {ours_add*1e3:.2f} mm")
