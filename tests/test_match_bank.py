"""Multi-template-bank match parity at low thresholds (stresses the coarse
raw-threshold rule, refinement windows, sort and dedup)."""

import numpy as np
import pytest

from object_detector_6d_tpu.api.detector import Detector
from object_detector_6d_tpu.quant.features import Feature, Template

CLASSES = ["sphA", "sphB"]


def _build(g) -> Detector:
    det = Detector()
    for cid in CLASSES:
        n = int(g[cid + "_ntempl"][0])
        for tid in range(n):
            tp = []
            for i in range(4):
                feats = g[f"{cid}_t{tid}_feat{i}"]
                w, h, lvl = g[f"{cid}_t{tid}_meta{i}"]
                tp.append(
                    Template(
                        int(w), int(h), int(lvl),
                        [Feature(int(x), int(y), int(l)) for x, y, l in feats],
                    )
                )
            det.add_synthetic_template(tp, cid)
    return det


@pytest.mark.parametrize(
    "scene,key,thresh",
    [
        ("sceneA", "bank_sceneA_t60", 60.0),
        ("sceneA", "bank_sceneA_t80", 80.0),
        ("sceneS", "bank_sceneS_t70", 70.0),
        ("scene2", "bank_scene2_t55", 55.0),
    ],
)
def test_bank_parity(golden, scene, key, thresh):
    g = golden("match_bank")
    det = _build(g)
    matches = det.match([g[f"{scene}_bgr"], g[f"{scene}_dep"]], thresh)
    got = np.array(
        [(m.x, m.y, m.similarity, CLASSES.index(m.class_id), m.template_id) for m in matches],
        np.float64,
    ).reshape(-1, 5)
    expected = g[key]
    assert got.shape == expected.shape, f"{got}\nvs\n{expected}"
    np.testing.assert_array_equal(got[:, [0, 1, 3, 4]], expected[:, [0, 1, 3, 4]])
    np.testing.assert_allclose(got[:, 2], expected[:, 2], atol=1e-3)


def test_fused_overflow_widens_capacity():
    """Coarse-candidate overflow stays on the fused path: the capacity
    ladder re-runs a wider program and the
    result equals the host-orchestrated reference exactly."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
    import scenes

    from object_detector_6d_tpu.api.detector import Detector

    det = Detector()
    K = scenes.K_DEFAULT
    dep, gray, mask = scenes.snowman_scene()
    bgr = np.repeat(gray[..., None], 3, axis=2)
    # several templates so a low threshold floods the coarse stage
    for off in (0, -20, 25):
        d2, m2, g2 = scenes.render_translated(
            dep, mask, K, np.array([off * 1e-3, 0.0, off * 1e-3]))
        tid, _ = det.add_template(
            [np.repeat(g2[..., None], 3, axis=2), d2], "obj",
            m2.astype(np.uint8) * 255)
        assert tid >= 0
    t = np.array([0.03, -0.01, -0.02])
    d2, _, g2 = scenes.render_translated(dep, mask, K, t)
    b2 = np.repeat(g2[..., None], 3, axis=2)

    # find a threshold whose COARSE candidate count overflows K=8 (the
    # overflow criterion is coarse candidates, not final matches)
    for thr in (60.0, 55.0, 50.0, 45.0):
        probe = det._match_fused([b2, d2], thr, None, 8)
        if isinstance(probe, int):
            break
    assert isinstance(probe, int) and probe > 8, (
        f"no coarse overflow even at {thr} ({probe})")
    ref = det._match_reference([b2, d2], thr)
    fused = det.match([b2, d2], thr, max_candidates=8)
    assert [
        (m.x, m.y, round(m.similarity, 3), m.class_id, m.template_id)
        for m in fused
    ] == [
        (m.x, m.y, round(m.similarity, 3), m.class_id, m.template_id)
        for m in ref
    ]
