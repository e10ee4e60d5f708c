"""Sharded template-bank TP x frame DP on the simulated 8-device mesh.

All tests drive the PRODUCTION sharded entry points — the mesh paths of
match/program.py (coarse match) and api/detect_program.py (full detect)
— and assert mesh == single-device numbers (SURVEY.md section 4: CPU
mesh via xla_force_host_platform_device_count). The round-1 demo
shard_map programs were deleted in round 4: one
sharded implementation, the one that ships.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from object_detector_6d_tpu.parallel.sharding import make_mesh


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return make_mesh(8)


def test_mesh_shape(mesh):
    assert mesh.devices.size == 8
    assert set(mesh.axis_names) == {"data", "model"}


def _bank_and_frames(mesh, rng):
    """Shared fixture math: tiny synthetic bank + noise frames."""
    from object_detector_6d_tpu.data.synthetic import synthetic_bank
    from object_detector_6d_tpu.match import program as mp

    dp, tp = mesh.devices.shape
    det = synthetic_bank(n_classes=2, per_class=2 * tp, bbox_px=40, seed=0)
    bank = mp.pack_bank(det.class_templates, 2, 2,
                        t0=det.t_at_level[0], t1=det.t_at_level[1], pad_to=tp)
    B, H, W = dp * 2, 120, 160
    bgrs = jnp.asarray(
        rng.randint(0, 256, (B, H, W, 3), dtype=np.int64).astype(np.uint8))
    deps = jnp.asarray(
        (1000 + rng.randint(0, 400, (B, H, W))).astype(np.uint16))
    return det, bank, (B, H, W), bgrs, deps


def test_sharded_match_program_equals_unsharded(mesh):
    """The production fused MATCH program under the mesh == single-device.

    Templates shard over ``model`` (TP), frames over ``data`` (DP);
    candidates merge with one all_gather + re-top-k
    (match/program.py:_sharded_run + merge_shard_candidates)."""
    from object_detector_6d_tpu.match import program as mp

    dp, tp = mesh.devices.shape
    rng = np.random.RandomState(0)
    det, bank, (B, H, W), bgrs, deps = _bank_and_frames(mesh, rng)
    max_dr = ((bank.max_dr // 16) + 1) * 16
    common = dict(max_candidates=2 * tp, max_dr=max_dr, batch=B)
    fn_1dev = mp.make_match_program(
        det.modality_names, det.t_at_level, (H, W),
        det.dn_params, det.cg_params, **common)
    fn_mesh = mp.make_match_program(
        det.modality_names, det.t_at_level, (H, W),
        det.dn_params, det.cg_params, mesh=mesh, **common)
    args = (
        (bgrs, deps),
        bank.kernels_low,
        (bank.feat_plane, bank.feat_dr, bank.feat_dc, bank.feat_n),
        jnp.asarray(bank.nfeat[0]), jnp.asarray(bank.nfeat[1]),
        jnp.asarray(bank.sizes[0]), jnp.asarray(bank.sizes[1]),
        jnp.float32(60.0),
    )
    out1 = np.asarray(fn_1dev(*args))
    out2 = np.asarray(fn_mesh(*args))
    # rows: x / y / similarity / tid / keep (program.py post_stage);
    # discrete rows exact, similarity to f32 reassociation
    for row in (0, 1, 3, 4):
        np.testing.assert_array_equal(out1[:, row], out2[:, row])
    np.testing.assert_allclose(out1[:, 2], out2[:, 2], atol=1e-4)


@pytest.mark.slow
def test_sharded_detect_program_equals_unsharded(mesh):
    """The PRODUCTION fused detect program under the mesh == single-device.

    Frames DP x template-bank TP in the match stage, hypothesis lanes
    over the model axis in the ICP stage (shard
    the real program, not a toy)."""
    from object_detector_6d_tpu.api import detect_program as dp_mod
    from object_detector_6d_tpu.core.config import ICPParams
    from object_detector_6d_tpu.match import program as mp

    dp, tp = mesh.devices.shape
    rng = np.random.RandomState(0)
    det, bank, (B, H, W), bgrs, deps = _bank_and_frames(mesh, rng)
    nT = bank.num_templates
    max_dr = ((bank.max_dr // 16) + 1) * 16
    K_mat = np.array([[140.0, 0, W / 2], [0, 140.0, H / 2], [0, 0, 1.0]])

    N_pts = 64
    model_bank = rng.uniform(-0.05, 0.05, (nT, N_pts, 6)).astype(np.float32)
    model_bank[..., 2] += 1.0
    model_bank[..., 3:] /= np.linalg.norm(model_bank[..., 3:], axis=-1,
                                          keepdims=True)
    views = dp_mod.PackedViews(
        jnp.asarray(model_bank),
        jnp.asarray(np.tile([0.0, 0.0, 1.0], (nT, 1)).astype(np.float32)),
        jnp.asarray(np.full((nT, 2), 24, np.int32)),
        jnp.asarray(np.tile(np.eye(4, dtype=np.float32), (nT, 1, 1))),
        jnp.asarray(np.ones(nT, bool)),
    )
    common = dict(
        max_candidates=2 * tp, max_dr=max_dr,
        icp=ICPParams(iterations=9, num_levels=3), lift_window=48, batch=B,
    )
    prog_1dev = dp_mod.make_detect_program(
        det.modality_names, det.t_at_level, (H, W),
        det.dn_params, det.cg_params, K_mat, **common)
    prog_mesh = dp_mod.make_detect_program(
        det.modality_names, det.t_at_level, (H, W),
        det.dn_params, det.cg_params, K_mat, mesh=mesh, **common)

    args = (
        (bgrs, deps),
        bank.kernels_low,
        (bank.feat_plane, bank.feat_dr, bank.feat_dc, bank.feat_n),
        jnp.asarray(bank.nfeat[0]), jnp.asarray(bank.nfeat[1]),
        jnp.asarray(bank.sizes[0]), jnp.asarray(bank.sizes[1]),
        views, jnp.float32(60.0),
    )
    p1, poses1, res1, keep1 = [np.asarray(x) for x in prog_1dev(*args)]
    p2, poses2, res2, keep2 = [np.asarray(x) for x in prog_mesh(*args)]
    np.testing.assert_allclose(p1, p2, atol=1e-4)
    np.testing.assert_array_equal(keep1, keep2)
    np.testing.assert_allclose(
        np.where(np.isfinite(res1), res1, 0),
        np.where(np.isfinite(res2), res2, 0), atol=1e-5)
    # Poses: the sharded and unsharded programs fuse the f32 geometry /
    # ICP math differently (shard_map local batch 2 vs one batch-8 vmap),
    # and the gated iterative refinement amplifies ulp-level reassociation
    # into ~1e-3 pose drift along the (residual-flat) scene surface on
    # these noise frames — residuals above agree to 1e-5. Discrete
    # outputs (keep, match arrays) stay exact; poses get a drift bound.
    np.testing.assert_allclose(poses1, poses2, atol=2e-3)

    # same program with on-device scoring + cluster NMS (the production
    # pipeline path and what dryrun_multichip executes): mesh == single
    # on the flattened cluster records too
    prog_1dev_nms = dp_mod.make_detect_program(
        det.modality_names, det.t_at_level, (H, W),
        det.dn_params, det.cg_params, K_mat, device_nms=True, **common)
    prog_mesh_nms = dp_mod.make_detect_program(
        det.modality_names, det.t_at_level, (H, W),
        det.dn_params, det.cg_params, K_mat, mesh=mesh, device_nms=True,
        **common)
    index = {}
    cls_of_tid = jnp.asarray(
        np.array([index.setdefault(c, len(index)) for c in bank.class_ids],
                 np.int32))
    nms_args = args + (cls_of_tid, jnp.asarray([0.05, 0.02], jnp.float32))
    flat1 = np.asarray(prog_1dev_nms(*nms_args))
    flat2 = np.asarray(prog_mesh_nms(*nms_args))
    K_cap = common["max_candidates"]
    s1, raw1, pass1 = dp_mod.unflatten_cluster_outputs(flat1, K_cap)
    s2, raw2, pass2 = dp_mod.unflatten_cluster_outputs(flat2, K_cap)
    np.testing.assert_array_equal(raw1, raw2)
    np.testing.assert_array_equal(pass1, pass2)
    # discrete slot fields exact (valid, votes, rep tid/x/y, members);
    # continuous ones (sim, residual mean, mean pose) at the ICP drift
    # bound documented above
    for col in (0, 1, 3, 4, 5, 7):
        np.testing.assert_array_equal(s1[..., col], s2[..., col])
    np.testing.assert_allclose(s1[..., 2], s2[..., 2], atol=1e-4)
    np.testing.assert_allclose(s1[..., 6], s2[..., 6], atol=1e-5)
    np.testing.assert_allclose(s1[..., 8:], s2[..., 8:], atol=2e-3)
