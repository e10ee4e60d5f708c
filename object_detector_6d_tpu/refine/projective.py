"""Projective-association point-to-plane ICP (KinectFusion style).

The brute-force matmul nearest-neighbor ICP (refine/icp.py) is exact but
materializes an [N, M] distance matrix per hypothesis per iteration —
the right tool for unordered scene clouds, too expensive to fuse into
the per-frame detect() program. This module is the organized-scene
variant the canonical stack uses in its real-time paths
(FastICPOdometry, depth.hpp:1028 region; KinectFusion data
association): project each model point through the current pose into
the scene's pixel grid and take the scene point/normal stored at that
pixel as the correspondence — O(1) gathers instead of an O(M) search,
which is exactly the organized-frame structure the device keeps resident
anyway.

Correspondence rejection follows FastICPOdometry, not the MAD rule of
refine/icp.py: a per-level absolute distance cap plus a normal
compatibility gate (transformed model normal . scene normal > cos 60
deg). The gate needs no per-iteration median sorts and is
the canonical choice for projective association, where gross outliers
are already excluded by the projection (out-of-frame / invalid pixels).

The solve is the same centroid-conjugated point-to-plane linearization
(Kok-Lim Low, icp.hpp:77-78) as refine/icp.py, via Cholesky (the
normal matrix is SPD after Levenberg damping). Coarse-to-fine model subsampling with
convergence-masked fixed iteration budgets mirrors icp.hpp:90-98.

Scene layout: ``scene7`` rows are [x, y, z, nx, ny, nz, valid] so one
gather fetches the correspondence AND its validity.

Used by the fused detect() program (api/detect_program.py), which runs
the coarse levels over every (candidate, depth-seed) hypothesis, picks
each candidate's best seed, and spends the expensive fine levels on the
survivors only.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

from object_detector_6d_tpu.core.se3 import SE3


def pack_scene7(scene6_img: jnp.ndarray) -> jnp.ndarray:
    """Organized [H, W, 6] cloud+normals -> flat [H*W, 7] with validity."""
    flat = scene6_img.reshape(-1, 6)
    valid = jnp.isfinite(flat).all(-1, keepdims=True).astype(flat.dtype)
    return jnp.concatenate([jnp.nan_to_num(flat), valid], -1)


def _chol_solve6(A, b):
    """Damped SPD 6x6 solve via explicitly unrolled Cholesky.

    jnp.linalg.cholesky + cho_solve on a 6x6 lower to a loop of small
    ops per lane; the unrolled form is pure elementwise math that
    vectorizes across the vmapped lane batch. Same damping and
    factorization order, so results agree to f32 round-off.
    """
    lam = 1e-6 * jnp.trace(A) + 1e-12
    a = [[A[i, j] + jnp.where(i == j, lam, 0.0) for j in range(6)]
         for i in range(6)]
    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        s = a[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = jnp.sqrt(jnp.maximum(s, 1e-20))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, 6):
            s = a[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    y = [None] * 6
    for i in range(6):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, -1)


def _associate(
    pose,
    model_pc,  # [n, 6] xyz+normal (finite; masked rows via ``mask``)
    mask,  # [n] bool valid model rows
    scene7,  # [H*W, 7] packed organized scene (pack_scene7)
    fx, fy, cx, cy, H, W,
    max_corr_dist,
    min_normal_cos,
):
    """Projective data association: (scene point, normal, weight) per row.

    The gather from the [H*W, 7] scene is the main cost of projective
    ICP — everything downstream of it is elementwise math and tiny
    matmuls. Callers
    amortize it by running more than one Gauss-Newton solve per
    association (see _proj_step's ``solves``)."""
    mp = SE3.apply(pose, model_pc[:, :3])
    mn = SE3.rotate(pose, model_pc[:, 3:6])
    z = mp[:, 2]
    zs = jnp.where(z > 1e-6, z, 1.0)
    ui = jnp.round(fx * mp[:, 0] / zs + cx).astype(jnp.int32)
    vi = jnp.round(fy * mp[:, 1] / zs + cy).astype(jnp.int32)
    inb = (z > 1e-6) & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    idx = jnp.clip(vi, 0, H - 1) * W + jnp.clip(ui, 0, W - 1)
    q = jnp.take(scene7, idx, axis=0)  # [n, 7]
    qp = q[:, :3]
    qn = q[:, 3:6]

    d2 = jnp.sum((mp - qp) ** 2, axis=-1)
    ncos = jnp.sum(mn * qn, axis=-1)
    w = (
        mask & inb & (q[:, 6] > 0)
        & (d2 <= max_corr_dist * max_corr_dist)
        & (ncos >= min_normal_cos)
    ).astype(jnp.float32)
    return qp, qn, w


def _associate_window(
    pose,
    model_pc,  # [n, 6] xyz+normal (finite; masked rows via ``mask``)
    mask,  # [n] bool valid model rows
    win_img,  # [wh, ww, C] f32 window crop of the packed scene (C >= 7)
    y0, x0,  # window origin in full-frame pixels (i32 scalars)
    fx, fy, cx, cy,
    max_corr_dist,
    min_normal_cos,
):
    """Windowed projective association as TWO dense contractions.

    The full-scene row gather (_associate) is a latency-bound XLA gather
    from the [H*W, 7] table. But every fine-phase correspondence lies
    inside a small window around the match center (the pose is already
    seeded within ~15 mm ≈ 10 px), so the gather target can be a small
    window crop, and a gather from a window factorizes into dense math:
    one-hot row selection ``[n, wh] @ [wh, ww*C]`` followed by a one-hot
    column contraction (elementwise multiply + reduce). Both one-hot operands
    are exact 0/1 f32 and the matmul runs at HIGHEST precision, so the
    result is the EXACT gathered row (each output element is one
    product 1.0 * v — the bf16x6 decomposition reconstructs v
    bit-exactly).

    Points projecting outside the window get an all-zero one-hot row,
    hence a zero scene row, hence weight 0 — the only semantic
    difference vs _associate, and a principled one: a correspondence
    further than the window margin from the seed is precisely the kind
    the distance cap is there to reject.
    """
    wh, ww, C = win_img.shape
    mp = SE3.apply(pose, model_pc[:, :3])
    mn = SE3.rotate(pose, model_pc[:, 3:6])
    z = mp[:, 2]
    zs = jnp.where(z > 1e-6, z, 1.0)
    ui = jnp.round(fx * mp[:, 0] / zs + cx).astype(jnp.int32) - x0
    vi = jnp.round(fy * mp[:, 1] / zs + cy).astype(jnp.int32) - y0
    inb = (z > 1e-6) & (ui >= 0) & (ui < ww) & (vi >= 0) & (vi < wh)
    oh_r = ((vi[:, None] == jnp.arange(wh)[None, :]) & inb[:, None]
            ).astype(jnp.float32)  # [n, wh]
    rows = jnp.matmul(
        oh_r, win_img.reshape(wh, ww * C),
        precision=jax.lax.Precision.HIGHEST,
    ).reshape(-1, ww, C)  # [n, ww, C]
    oh_c = (ui[:, None] == jnp.arange(ww)[None, :]).astype(jnp.float32)
    q = jnp.sum(rows * oh_c[:, :, None], axis=1)  # [n, C] exact gather
    qp = q[:, :3]
    qn = q[:, 3:6]
    d2 = jnp.sum((mp - qp) ** 2, axis=-1)
    ncos = jnp.sum(mn * qn, axis=-1)
    w = (
        mask & inb & (q[:, 6] > 0)
        & (d2 <= max_corr_dist * max_corr_dist)
        & (ncos >= min_normal_cos)
    ).astype(jnp.float32)
    return qp, qn, w


def _gn_solve(pose, model_pc, qp, qn, w):
    """One point-to-plane Gauss-Newton solve on FIXED correspondences."""
    mp = SE3.apply(pose, model_pc[:, :3])
    r = jnp.sum((mp - qp) * qn, axis=-1)
    wsum = jnp.maximum(jnp.sum(w), 1.0)
    c = jnp.sum(mp * w[:, None], axis=0) / wsum
    J = jnp.concatenate([jnp.cross(mp - c, qn), qn], axis=-1)  # [n, 6]
    Jw = J * w[:, None]
    A = jnp.matmul(Jw.T, J, precision=jax.lax.Precision.HIGHEST)
    b = -jnp.matmul(Jw.T, r[:, None], precision=jax.lax.Precision.HIGHEST)[:, 0]
    x = _chol_solve6(A, b)
    dT = SE3.exp(x)
    shift = SE3.from_rt(jnp.eye(3, dtype=pose.dtype), c)
    unshift = SE3.from_rt(jnp.eye(3, dtype=pose.dtype), -c)
    new_pose = SE3.compose(shift, SE3.compose(dT, SE3.compose(unshift, pose)))
    residual = jnp.sum(jnp.abs(r) * w) / wsum
    return new_pose, jnp.linalg.norm(x), residual


def _proj_step(
    pose,
    model_pc,  # [n, 6] xyz+normal (finite; masked rows via ``mask``)
    mask,  # [n] bool valid model rows
    scene7,  # [H*W, 7] packed organized scene (pack_scene7)
    fx, fy, cx, cy, H, W,
    max_corr_dist,
    min_normal_cos,
    solves: int = 1,
    window=None,  # (win_img [wh, ww, C], y0, x0) -> windowed gather
):
    """One projective point-to-plane iteration: associate once, then run
    ``solves`` Gauss-Newton updates on the fixed correspondence set.

    With fixed pairs the point-to-plane objective is a linearized least
    squares, so the first solve lands at (the linearization of) its
    optimum; a second solve re-linearizes the twist around the new pose
    and recovers most of what a fresh association would — while the
    association gather is the stage's entire cost (see _associate).
    ``solves=2`` halves gather traffic per effective iteration; the
    residual/update returned are those of the LAST solve."""
    if window is not None:
        win_img, wy0, wx0 = window
        qp, qn, w = _associate_window(
            pose, model_pc, mask, win_img, wy0, wx0, fx, fy, cx, cy,
            max_corr_dist, min_normal_cos,
        )
    else:
        qp, qn, w = _associate(
            pose, model_pc, mask, scene7, fx, fy, cx, cy, H, W,
            max_corr_dist, min_normal_cos,
        )
    new_pose, upd, residual = _gn_solve(pose, model_pc, qp, qn, w)
    for _ in range(solves - 1):
        new_pose, upd2, residual = _gn_solve(new_pose, model_pc, qp, qn, w)
        upd = upd + upd2
    return new_pose, upd, residual, jnp.sum(w)


def icp_levels(
    model_pc,  # [N, 6] (NaN rows = padding)
    pose0,  # [4, 4]
    scene7,  # [H*W, 7] packed scene
    fx, fy, cx, cy,
    H: int,
    W: int,
    levels: Sequence[int],  # e.g. (5, 4, 3, 2) coarse->fine strides 2^l
    iters_per_level,  # int, or a per-level sequence matching ``levels``
    tolerance: float = 1e-4,
    corr_dist_base: float = 0.015,
    min_normal_cos: float = 0.5,
    solves: int = 1,
    window=None,  # (win_img [wh, ww, C], y0, x0): use the windowed
    #               association (_associate_window) instead of the
    #               full-scene gather; scene7 is then only a signature
    #               placeholder
):
    """Run the given pyramid levels; returns (residual, pose, n_inliers).

    ``levels`` are model-subsample exponents (stride = 2^level), run in
    the order given. ``tolerance`` is the twist-update-norm early-exit;
    it is intentionally tighter than the NN ICP's 0.005: projective
    association takes smaller steps per iteration (the correspondence
    field only changes when points cross pixel boundaries), so the
    oracle's tolerance stops it ~25 mm early on lateral axes [measured
    on the snowman scene: tol=5e-3 -> 26 mm x-error, tol=1e-4 ->
    1.3 mm]. ``solves``: Gauss-Newton updates per association
    (ICPParams.solves_per_assoc) — ``iters_per_level`` then counts
    associations, so 2 solves halves the gather traffic at an equal
    update budget when callers also halve iters_per_level, or deepens
    convergence at equal gather cost when they don't.
    ``iters_per_level`` may also be a per-level sequence (one
    association budget per entry of ``levels``) — the hook for
    ICPParams.finest_assoc, which caps the full-model finest level at
    a polish budget.
    """
    N = model_pc.shape[0]
    tolerance = jnp.float32(tolerance)
    pose = pose0
    residual = jnp.float32(jnp.inf)
    n_in = jnp.float32(0.0)
    if isinstance(iters_per_level, int):
        iters_per_level = [iters_per_level] * len(levels)
    for level, lvl_iters in zip(levels, iters_per_level):
        stride = 1 << level
        n_lvl = max(1, N // stride)
        sample = model_pc[::stride][:n_lvl]
        mask = jnp.isfinite(sample[:, :3]).all(-1)
        sample = jnp.nan_to_num(sample)
        cap = jnp.float32(corr_dist_base) * (1 << level)

        def body(carry):
            i, pose, _res, _upd, _nin = carry
            new_pose, upd, res, nin = _proj_step(
                pose, sample, mask, scene7,
                fx, fy, cx, cy, H, W, cap, jnp.float32(min_normal_cos),
                solves=solves, window=window,
            )
            return i + 1, new_pose, res, upd, nin

        def cond(carry, _n=lvl_iters):
            i, _pose, _res, upd, _nin = carry
            return (i < _n) & (upd >= tolerance)

        _, pose, residual, _, n_in = jax.lax.while_loop(
            cond, body, (0, pose, residual, jnp.float32(1e9), n_in)
        )
    return residual, pose, n_in


def projective_icp(
    model_pc,
    pose0,
    scene_flat,  # [H*W, 6] NaNs zeroed (legacy layout) or [H*W, 7] packed
    s_valid,  # [H*W] bool (ignored when scene_flat already has 7 cols)
    fx, fy, cx, cy,
    H: int,
    W: int,
    iterations: int = 100,
    tolerance: float = 1e-4,
    rejection_scale: float = 2.5,  # kept for signature parity; unused
    num_levels: int = 6,
    corr_dist_base: float = 0.015,
    solves: int = 1,
):
    """Full coarse-to-fine refinement of one pose; vmap for batches.

    Returns (residual, pose, n_inliers). ``residual`` is the mean
    absolute point-to-plane distance of inlier correspondences at the
    finest level (same convention as refine/icp.py).
    """
    if scene_flat.shape[-1] == 6:
        scene7 = jnp.concatenate(
            [scene_flat, s_valid[:, None].astype(scene_flat.dtype)], -1
        )
    else:
        scene7 = scene_flat
    return icp_levels(
        model_pc, pose0, scene7, fx, fy, cx, cy, H, W,
        levels=tuple(range(num_levels - 1, -1, -1)),
        iters_per_level=max(1, iterations // num_levels // max(1, solves)),
        tolerance=tolerance,
        corr_dist_base=corr_dist_base,
        solves=solves,
    )
