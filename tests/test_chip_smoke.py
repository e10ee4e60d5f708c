"""chip_smoke.py's checks at tiny sizes on the CPU, its refusal of a
host without a GPU, and the compile-cache location rule."""

import os
import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest

import jax

ROOT = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

from object_detector_6d_tpu.utils import compile_cache, device  # noqa: E402


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit):
        device.require_gpu(jax)


def test_script_exits_nonzero_without_gpu():
    """Run as the driver does, but on the CPU: non-zero, no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.fixture(scope="module")
def tiny_bank():
    from object_detector_6d_tpu.data.synthetic import synthetic_bank
    from object_detector_6d_tpu.match import program as mp

    det = synthetic_bank(n_classes=2, per_class=2, bbox_px=40, seed=0)
    bank = mp.pack_bank(det.class_templates, 2, 2, t0=det.t_at_level[0],
                        t1=det.t_at_level[1])
    return det, bank


def test_stage_coarse_tiny(tiny_bank):
    det, bank = tiny_bank
    assert chip_smoke.stage_coarse(bank, (120, 160), det.t_at_level[1]) == (0, 0)


def test_stage_refine_tiny(tiny_bank):
    det, bank = tiny_bank
    max_dr = ((bank.max_dr // 16) + 1) * 16
    bad, worst = chip_smoke.stage_refine(bank, (120, 160), det.t_at_level[0],
                                         max_dr, n_cand=4)
    assert (bad, worst) == (0, 0)


def test_stage_quantizers_bit_exact():
    bad, total = chip_smoke.stage_quantizers()
    assert bad == 0 and total > 0


def test_stage_geometry_within_bounds():
    cloud_err, p99, mean = chip_smoke.stage_geometry()
    assert cloud_err <= 1e-5 and p99 < 2.0 and mean < 0.5


def _pose(cid, x, t, deg=0.0, res=0.0005):
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    P = np.eye(4)
    P[:2, :2] = [[c, -s], [s, c]]
    P[:3, 3] = t
    return types.SimpleNamespace(class_id=cid, template_id=0, match_x=x,
                                 match_y=5, pose=P, residual=res)


def test_compare_detections():
    a = [[_pose("A", 1, [0, 0, 1.0]), _pose("B", 2, [0.1, 0, 1.0])], []]
    b = [[_pose("B", 2, [0.1, 0.0005, 1.0]), _pose("A", 1, [0, 0, 1.0], 0.2)], []]
    n, dt, dr, loose = chip_smoke.compare_detections(a, b, "t", 0.002)
    assert (n, loose) == (2, 0) and abs(dt - 0.5) < 1e-6 and abs(dr - 0.2) < 1e-6
    with pytest.raises(chip_smoke.SmokeFailure):  # a confident one missing
        chip_smoke.compare_detections(a, [b[0][:1], []], "t", 0.002)
    with pytest.raises(chip_smoke.SmokeFailure):  # 5 mm apart
        chip_smoke.compare_detections(
            a, [[_pose("A", 1, [0, 0, 1.005]), a[0][1]], []], "t", 0.002)
    # a marginal fit (residual near the gate) on one side only, or far
    # apart on both, is counted and not compared
    m = [[_pose("C", 3, [0.3, 0, 1.0], res=0.0035)], []]
    m2 = [[_pose("C", 3, [0.5, 0, 1.0], res=0.0038)], []]
    assert chip_smoke.compare_detections(
        [a[0] + m[0], []], b, "t", 0.002)[3] == 1
    assert chip_smoke.compare_detections(
        [a[0] + m[0], []], [b[0] + m2[0], []], "t", 0.002)[:2] == (2, dt)


def test_compile_cache_env_unset(monkeypatch, tmp_path):
    monkeypatch.delenv(compile_cache.ENV, raising=False)
    assert compile_cache.cache_dir(str(tmp_path)) == str(tmp_path / ".jax_cache")
    assert compile_cache.cache_dir() == str(ROOT / ".jax_cache")


def test_compile_cache_env_set(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path / "elsewhere"))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable(str(tmp_path)) == str(tmp_path / "elsewhere")
    # nothing set in code: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / ".jax_cache").exists()


def test_phase_match_golden():
    chip_smoke.phase_match()


def test_phase_add_first_scenes():
    """The ADD parity phase on the first two scenes of each of its sets
    (the full 64-scene sets run on the GPU)."""
    rs = chip_smoke.phase_add(n_scenes=2)
    assert sorted(rs) == ["base", "occl"]
    for r in rs.values():
        assert r["n"] == 2 and r["ours_hits"] >= r["oracle_hits"]
