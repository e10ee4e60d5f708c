"""Histogram-CDF lift quantiles (_hist_quantiles) vs exact nanquantile.

The fused detect program's hypothesis lift estimates window depth
quantiles to seed ICP translations; seeds only need to land within
~15 mm of the surface (seed_min_gap dedup granularity, detect_program
lift). The default "hist" estimator replaces the window sort with a
128-bin histogram CDF — these tests pin its error envelope on
production-shaped windows and its NaN semantics, and that the fused
program produces the same detections either way (lift_impl="sort" vs
"hist").
"""

import numpy as np
import pytest

import jax.numpy as jnp

from object_detector_6d_tpu.api.detect_program import _hist_quantiles

QL = jnp.asarray([0.25, 0.5, 0.75])


def _err_mm(w):
    exact = np.nanquantile(w, [0.25, 0.5, 0.75])
    est = np.asarray(_hist_quantiles(jnp.asarray(w), QL))
    return np.abs(est - exact).max() * 1e3


def test_surface_window_error_under_seed_tolerance():
    """Depth-surface-like windows (dense, mm-quantized): error << 15 mm."""
    rng = np.random.RandomState(0)
    for _ in range(20):
        # background plane + a bulging object patch, mm-quantized like
        # real sensor depth, bbox-masked to >= 30x30 samples
        w = np.full((80, 80), 1.5, np.float32)
        yy, xx = np.mgrid[:80, :80]
        r2 = (yy - 40.0) ** 2 + (xx - 40.0) ** 2
        obj = r2 < rng.uniform(15, 35) ** 2
        w[obj] = 1.1 + 0.2 * (r2[obj] / r2[obj].max())
        w += rng.normal(0, 0.002, w.shape)
        w = np.round(w * 1000) / 1000  # mm quantization
        side = rng.randint(30, 80)
        m = np.zeros((80, 80), bool)
        m[:side, :side] = True
        w[~m] = np.nan
        assert _err_mm(w.astype(np.float32)) < 8.0


def test_nan_semantics_match_nanquantile():
    allnan = np.full((40, 40), np.nan, np.float32)
    assert np.isnan(np.asarray(_hist_quantiles(jnp.asarray(allnan), QL))).all()
    one = allnan.copy()
    one[3, 4] = 1.1
    np.testing.assert_allclose(
        np.asarray(_hist_quantiles(jnp.asarray(one), QL)), 1.1, atol=1e-5
    )
    const = np.full((40, 40), 1.25, np.float32)
    np.testing.assert_allclose(
        np.asarray(_hist_quantiles(jnp.asarray(const), QL)), 1.25, atol=1e-5
    )


def test_deep_background_span_capped():
    """A far wall inside the bbox margin must not widen the bins.

    Pre-cap, a 2.6 m window span meant ~20 mm bins — beyond the 15 mm
    seed tolerance. With the 1 m span cap the object-side
    quantiles stay bin-width-tight; far-background quantiles collapse to
    ~zmin+1 m (a mid-air seed the coarse-ICP inlier gate drops, like the
    true background seed would be)."""
    rng = np.random.RandomState(2)
    w = np.full((80, 80), 3.5, np.float32)  # far wall at 3.5 m
    yy, xx = np.mgrid[:80, :80]
    obj = ((yy - 40.0) ** 2 + (xx - 40.0) ** 2) < 30.0 ** 2
    w[obj] = (0.9 + 0.1 * rng.rand(int(obj.sum()))).astype(np.float32)
    est = np.asarray(_hist_quantiles(jnp.asarray(w), QL))
    exact = np.nanquantile(w, [0.25, 0.5, 0.75])
    # ~44% of samples are object: q25 lies ON the object -> tight
    assert abs(est[0] - exact[0]) * 1e3 < 8.0
    # capped quantiles stay inside [zmin, zmin + 1 m]
    assert (est >= 0.9 - 1e-6).all() and (est <= 1.9 + 1e-6).all()


def test_random_window_error_bounded_by_sample_gap():
    """Even adversarial sparse windows stay within a few sample gaps."""
    rng = np.random.RandomState(1)
    for _ in range(50):
        lo, hi = 0.9, 0.9 + rng.uniform(0.05, 0.7)
        w = rng.uniform(lo, hi, (80, 80)).astype(np.float32)
        m = np.zeros((80, 80), bool)
        y0, x0 = rng.randint(0, 50, 2)
        m[y0 : y0 + rng.randint(10, 30), x0 : x0 + rng.randint(10, 30)] = True
        w[~m] = np.nan
        n = int(np.isfinite(w).sum())
        gap = (hi - lo) / max(n, 1)
        tol = max(4.0 * gap * 1e3, (hi - lo) / 128 * 2e3)
        assert _err_mm(w) < tol


@pytest.mark.slow
def test_detect_program_hist_vs_sort_equivalent():
    """End-to-end: same detections, sub-mm pose agreement either way."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))
    import scenes

    from object_detector_6d_tpu.api.pipeline import PoseDetector
    from object_detector_6d_tpu.core.config import DetectParams, ICPParams

    K = scenes.K_DEFAULT
    dep, gray, mask = scenes.snowman_scene()
    dep2, _, gray2 = scenes.render_translated(
        dep, mask, K, np.array([0.055, -0.022, -0.04])
    )
    poses = {}
    for impl in ("hist", "sort"):
        pd = PoseDetector(
            params=DetectParams(match_threshold=70.0, max_hypotheses=4,
                                icp=ICPParams(iterations=60, num_levels=3)),
            lift_impl=impl,
        )
        assert pd.add_view("obj", dep, K, mask.astype(np.uint8) * 255,
                           rgb=np.repeat(gray[..., None], 3, 2)) == 0
        out = pd.detect_fused(dep2, K, rgb=np.repeat(gray2[..., None], 3, 2))
        assert out, impl
        poses[impl] = np.asarray(out[0].pose)
    dt = np.abs(poses["hist"][:3, 3] - poses["sort"][:3, 3]).max()
    assert dt < 1e-3, dt
