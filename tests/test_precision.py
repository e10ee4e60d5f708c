"""f32 contractions on the detect path run at full f32 precision.

A GPU may run a default-precision f32 matmul in TF32 (~3 decimal
digits). The pinned products must agree with float64 to f32 round-off
on every device; the ``gpu`` cases run on the card from chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from object_detector_6d_tpu.api import detect_program as dp

DEVICES = ["cpu", pytest.param("gpu", marks=pytest.mark.gpu)]


@pytest.fixture
def device(request):
    if request.param == "gpu":
        return request.getfixturevalue("gpu")
    return jax.devices("cpu")[0]


def _rand_poses(rng, n):
    from scipy.spatial.transform import Rotation

    P = np.tile(np.eye(4), (n, 1, 1))
    P[:, :3, :3] = Rotation.random(n, random_state=rng).as_matrix()
    P[:, :3, 3] = rng.uniform(-0.5, 0.5, (n, 3)) + [0, 0, 1.0]
    return P.astype(np.float32)


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_view_pose_composition_full_f32(device):
    rng = np.random.RandomState(0)
    a, b = _rand_poses(rng, 64), _rand_poses(rng, 64)
    got = np.asarray(jax.jit(dp.compose_view_poses)(
        jax.device_put(a, device), jax.device_put(b, device)))
    want = np.einsum("kij,kjl->kil", a.astype(np.float64), b.astype(np.float64))
    # f32 round-off is ~1e-7 of the 1 m translation; TF32 would be ~1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("device", DEVICES, indirect=True)
def test_nms_quaternion_threshold_full_f32(device):
    """The device NMS merges two poses 14.9 deg apart (threshold 15) and
    keeps 15.1 deg apart — a TF32 quaternion product cannot resolve
    that margin."""
    from scipy.spatial.transform import Rotation

    K = 4
    poses = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    poses[:, :3, 3] = [0.0, 0.0, 1.0]
    axis = np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8])
    base = Rotation.from_rotvec(axis * 0.7)
    for k, deg in ((1, 14.9), (2, 15.1)):
        rot = Rotation.from_rotvec(axis * np.radians(deg)) * base
        poses[k, :3, :3] = rot.as_matrix()
    poses[0, :3, :3] = base.as_matrix()
    packed = np.zeros((5, K + 1), np.float32)
    packed[2, :K] = [0.9, 0.8, 0.7, 0.0]  # similarities -> vote order
    res = np.array([0.001, 0.001, 0.001, np.inf], np.float32)
    keep = np.array([True, True, True, False])
    stage = dp.make_cluster_stage(K)
    args = [jax.device_put(x, device) for x in (
        packed, poses, res, keep, np.zeros(8, np.int32),
        np.array([0.01, 0.05], np.float32))]
    flat = np.asarray(jax.jit(stage)(*args))
    slots, _, _ = dp.unflatten_cluster_outputs(flat, K)
    members = slots[slots[:, 0] > 0, 7]
    assert sorted(members.tolist()) == [1.0, 2.0], slots[:, :8]
