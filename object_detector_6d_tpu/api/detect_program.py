"""Single-device-call detect(): match -> lift -> projective ICP -> poses.

The host-orchestrated PoseDetector.detect() (api/pipeline.py) issues
three device programs per frame (fused match, window quantiles, batched
ICP) plus host glue between them. This module fuses the
*entire* reference pipeline (SURVEY.md section 3.1: match -> hypothesis
lift -> multi-hypothesis ICP -> scoring) into ONE jitted program per
frame (or per frame-batch), so only fixed-size [K] result arrays leave
the device:

    sources -> fused LINEMOD match (match/program.py, top-K candidates)
            -> depth_to_3d + FALS normals (organized scene, stays on-chip)
            -> hypothesis lift: per candidate, NaN-aware depth quantiles
               (q25/q50/q75) of the match window seed up to S translation
               hypotheses (multi-depth lift, occlusion robustness)
            -> K*S-hypothesis projective point-to-plane ICP
               (refine/projective.py) against the organized scene
            -> best-seed selection per candidate by ICP residual
            -> packed poses/residuals/scores [K]

With ``device_nms=True`` (the production pipeline path) hypothesis
scoring + pose-cluster NMS also run on device (make_cluster_stage, the
exact refine/pose.py cluster_poses semantics) and host post-processing
is only unpacking the few final cluster records into Pose objects.

The template bank side inputs (model clouds, anchors, bboxes, view
poses) are packed once per bank by ``pack_views`` in the same global
template order as match/program.py's PackedBank.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from object_detector_6d_tpu.core.config import ICPParams
from object_detector_6d_tpu.match import program as mp
from object_detector_6d_tpu.refine.projective import icp_levels, pack_scene7


class PackedViews(NamedTuple):
    """Per-template training-view tensors, bank order (device-resident).

    A NamedTuple so the whole pack is a jit-traversable pytree."""

    model_bank: jnp.ndarray  # [nT, N, 6] f32, NaN-padded
    anchors: jnp.ndarray  # [nT, 3] f32 bbox-center anchor points
    bbox_wh: jnp.ndarray  # [nT, 2] i32 level-0 (w, h)
    view_poses: jnp.ndarray  # [nT, 4, 4] f32 (identity when unknown)
    views_ok: jnp.ndarray  # [nT] bool — template has a registered view


def pack_views(bank: "mp.PackedBank", views: Dict, model_points: int) -> PackedViews:
    """Stack PoseDetector.views records into bank-ordered tensors.

    ``views`` maps (class_id, local_tid) -> record with attributes
    model_cloud [N, 6], bbox (x, y, w, h), anchor_point [3], view_pose
    (4x4 or None) — the _ViewRecord layout of api/pipeline.py.
    """
    nT = bank.num_templates
    models = np.full((nT, model_points, 6), np.nan, np.float32)
    anchors = np.zeros((nT, 3), np.float32)
    bbox_wh = np.zeros((nT, 2), np.int32)
    poses = np.tile(np.eye(4, dtype=np.float32), (nT, 1, 1))
    ok = np.zeros(nT, bool)
    for g in range(nT):
        rec = views.get((bank.class_ids[g], int(bank.local_tids[g])))
        if rec is None:
            continue
        m = np.asarray(rec.model_cloud, np.float32)
        n = min(model_points, m.shape[0])
        models[g, :n] = m[:n]
        anchors[g] = rec.anchor_point
        bbox_wh[g] = (rec.bbox[2], rec.bbox[3])
        if rec.view_pose is not None:
            poses[g] = rec.view_pose
        ok[g] = True
    return PackedViews(
        jnp.asarray(models),
        jnp.asarray(anchors),
        jnp.asarray(bbox_wh),
        jnp.asarray(poses),
        jnp.asarray(ok),
    )


def compose_view_poses(poses: jnp.ndarray, view_poses: jnp.ndarray) -> jnp.ndarray:
    """[K, 4, 4] refined poses x [K, 4, 4] training-view poses, in full
    f32: a reduced-precision (TF32) product keeps ~3 digits, which is
    millimetres of translation at 1 m."""
    return jnp.einsum("kij,kjl->kil", poses, view_poses,
                      precision=jax.lax.Precision.HIGHEST)


def flatten_outputs(packed, poses, res, keep, K_cap: int):
    """(packed [.., 5, K+1], poses [.., K, 4, 4], res [.., K], keep
    [.., K]) -> one f32 array [.., 5*(K+1) + 16K + 2K]."""
    lead = packed.shape[:-2]
    return jnp.concatenate(
        [
            packed.reshape(lead + (5 * (K_cap + 1),)),
            poses.reshape(lead + (16 * K_cap,)),
            res.reshape(lead + (K_cap,)),
            keep.astype(jnp.float32).reshape(lead + (K_cap,)),
        ],
        axis=-1,
    )


def unflatten_outputs(flat: np.ndarray, K_cap: int):
    """Inverse of flatten_outputs (host side, numpy)."""
    lead = flat.shape[:-1]
    o = 5 * (K_cap + 1)
    packed = flat[..., :o].reshape(lead + (5, K_cap + 1))
    poses = flat[..., o:o + 16 * K_cap].reshape(lead + (K_cap, 4, 4))
    o += 16 * K_cap
    res = flat[..., o:o + K_cap]
    keep = flat[..., o + K_cap:o + 2 * K_cap] > 0
    return packed, poses, res, keep


CLUSTER_SLOT = 24  # per-cluster f32 record width (see make_cluster_stage)


def make_cluster_stage(K_cap: int, rot_thr_rad: float = float(np.deg2rad(15.0))):
    """Device-side hypothesis scoring + greedy pose-cluster NMS.

    Reproduces the host path's semantics exactly (refine/pose.py
    cluster_poses + PoseCluster.mean_pose — ppf_match_3d clusterPoses):
    filter (keep & finite & residual <= max_residual), sort by
    (-votes, residual), greedily merge each pose into the FIRST existing
    cluster whose representative is within both thresholds (same class),
    then average each cluster (hemisphere-aligned quaternion mean +
    translation mean) and sort clusters by total votes.

    Running this on device leaves only ~2 tiny cluster records per frame
    for the host to unpack: a per-frame Python Pose/NMS loop on the host
    would cost more than the device program.

    Returns ``cluster(packed, poses, res, keep, cls_of_tid, nms_scalars)
    -> flat [K_cap*CLUSTER_SLOT + 2]`` for ONE frame; vmap for batches.
    ``cls_of_tid`` maps global template id -> class index;
    ``nms_scalars = [max_residual, translation_threshold]`` (f32 [2]).
    Slot layout: [valid, votes_total, sim_max, rep_tid, rep_x, rep_y,
    residual_mean, n_members, pose 4x4 row-major]; trailer
    [n_raw_candidates, n_poses_pre_nms].
    """
    from object_detector_6d_tpu.core.se3 import SE3

    K = K_cap
    cos_half = np.float32(np.cos(rot_thr_rad / 2.0))
    ar = jnp.arange(K)

    def cluster(packed, poses, res, keep, cls_of_tid, nms_scalars):
        max_residual, trans_thr = nms_scalars[0], nms_scalars[1]
        sim = jnp.nan_to_num(packed[2, :-1])
        votes = jnp.round(sim * 100.0).astype(jnp.int32)
        tids = packed[3, :-1].astype(jnp.int32)
        xs = packed[0, :-1]
        ys = packed[1, :-1]
        cls = cls_of_tid[tids]
        valid = keep & jnp.isfinite(res) & (res <= max_residual)

        # stable sort by (-votes, residual): residual ranks (stable ties
        # by lane index) packed under the vote key
        rank_res = jnp.argsort(jnp.argsort(jnp.where(valid, res, jnp.inf)))
        key = jnp.where(valid, votes * K + (K - 1 - rank_res), -1)
        order = jnp.argsort(-key)  # stable: equal keys keep lane order

        valid_s = valid[order]
        q_all = SE3.to_quat(poses)
        q_s = jnp.where(valid_s[:, None], jnp.nan_to_num(q_all[order]), 0.0)
        t_s = jnp.where(valid_s[:, None], jnp.nan_to_num(poses[order, :3, 3]), 0.0)
        res_s = jnp.where(valid_s, jnp.nan_to_num(res[order]), 0.0)
        sim_s = jnp.where(valid_s, sim[order], 0.0)
        votes_s = jnp.where(valid_s, votes[order], 0)
        cls_s = cls[order]
        tid_s = tids[order]
        x_s = xs[order]
        y_s = ys[order]

        # pairwise compatibility (rotation via quaternion dot:
        # angle <= thr  <=>  |q_i . q_j| >= cos(thr/2)); full f32 — a
        # reduced-precision (TF32) product can flip membership at the
        # threshold
        qq = jnp.matmul(q_s, q_s.T, precision=jax.lax.Precision.HIGHEST)
        qd = jnp.abs(qq) >= cos_half
        td = jnp.linalg.norm(t_s[:, None] - t_s[None, :], axis=-1) <= trans_thr
        compat0 = (qd & td & (cls_s[:, None] == cls_s[None, :])
                   & valid_s[:, None] & valid_s[None, :])

        # greedy first-fit (unrolled: K is small and static)
        is_rep = jnp.zeros(K, bool)
        cluster_of = jnp.full(K, -1, jnp.int32)
        for i in range(K):
            compat = compat0[i] & (ar < i) & is_rep
            has = compat.any()
            j0 = jnp.argmax(compat)  # first True (argmax returns first max)
            vi = valid_s[i]
            is_rep = is_rep.at[i].set(vi & ~has)
            cluster_of = cluster_of.at[i].set(
                jnp.where(vi, jnp.where(has, j0, i), -1))

        # per-cluster aggregation ([rep j, member i] membership matrix)
        M = (cluster_of[None, :] == ar[:, None]) & valid_s[None, :]
        Mf = M.astype(res_s.dtype)
        cnt = Mf.sum(-1)
        denom = jnp.maximum(cnt, 1.0)
        votes_tot = (M * votes_s[None, :]).sum(-1)
        res_mean = (Mf * res_s[None, :]).sum(-1) / denom
        sim_max = jnp.max(jnp.where(M, sim_s[None, :], -jnp.inf), -1)
        sign = jnp.sign(qq)
        sign = jnp.where(sign == 0, 1.0, sign)  # hemisphere-align to rep
        q_mean = ((Mf * sign)[..., None] * q_s[None, :, :]).sum(1)
        q_mean = q_mean / jnp.maximum(
            jnp.linalg.norm(q_mean, axis=-1, keepdims=True), 1e-32)
        t_mean = (Mf[..., None] * t_s[None, :, :]).sum(1) / denom[:, None]
        pose_mean = SE3.from_quat(q_mean, t_mean)

        # clusters sorted by total votes (stable: creation order ties)
        key2 = jnp.where(is_rep, votes_tot * K + (K - 1 - ar), -1)
        ord2 = jnp.argsort(-key2)
        slots = jnp.concatenate(
            [
                is_rep[ord2, None].astype(jnp.float32),
                votes_tot[ord2, None].astype(jnp.float32),
                jnp.where(is_rep, sim_max, 0.0)[ord2, None],
                tid_s[ord2, None].astype(jnp.float32),
                x_s[ord2, None],
                y_s[ord2, None],
                res_mean[ord2, None],
                cnt[ord2, None],
                pose_mean[ord2].reshape(K, 16),
            ],
            axis=-1,
        )  # [K, CLUSTER_SLOT]
        trailer = jnp.stack(
            [packed[0, -1], valid.sum().astype(jnp.float32)])
        return jnp.concatenate([slots.reshape(-1), trailer])

    return cluster


def unflatten_cluster_outputs(flat: np.ndarray, K_cap: int):
    """Host inverse of make_cluster_stage's flat record.

    Returns (slots [.., K, CLUSTER_SLOT], n_raw [..], n_pass [..])."""
    lead = flat.shape[:-1]
    slots = flat[..., : K_cap * CLUSTER_SLOT].reshape(
        lead + (K_cap, CLUSTER_SLOT))
    return slots, flat[..., -2], flat[..., -1]


LIFT_HIST_BINS = 128
LIFT_HIST_SPAN_CAP = 1.0  # metres — bounds bin width (see _hist_quantiles)


def _hist_quantiles(w: jnp.ndarray, qlevels: jnp.ndarray) -> jnp.ndarray:
    """NaN-aware depth quantiles via a fixed-bin histogram CDF.

    Drop-in for ``jnp.nanquantile(w, qlevels)`` in the hypothesis lift:
    the exact quantile sorts the whole window subsample, but ICP seeds
    only need to land within ~15 mm of the surface
    (seed_min_gap dedup granularity). A 128-bin histogram bounds the
    error by one bin width — with zero sorts: one compare+reduce for the
    counts, a cumsum, and a rank lookup per level, all elementwise.
    Linear interpolation inside the selected bin matches nanquantile's
    convention (order position q*(n-1)) assuming uniform in-bin spread.
    All-NaN windows return NaN (the caller's ``finite`` mask drops those
    seeds), matching nanquantile.

    Error bound: the bins cover [zmin, zmin + min(span, SPAN_CAP=1 m)]
    of the window's finite depths, so bin width — and the worst-case
    quantile error for in-range values — is <= 1000/128 = 7.9 mm, under
    the 15 mm seed tolerance REGARDLESS of how deep the background
    behind the object is. Values beyond the cap (a far wall inside the
    bbox margin) pile into the last bin: a quantile landing there
    returns ~zmin+1 m instead of the true background depth — a mid-air
    seed that the coarse-ICP inlier gate drops, the same fate the true
    background seed meets. Sparse windows additionally deviate from
    nanquantile by inter-sample gaps (not bin width); test_lift_hist
    pins both envelopes.
    """
    flat = w.reshape(-1)
    fin = jnp.isfinite(flat)
    vals = jnp.where(fin, flat, 0.0)
    finf = fin.astype(jnp.float32)
    n = jnp.sum(finf)
    big = jnp.float32(3.4e38)
    zmin = jnp.min(jnp.where(fin, flat, big))
    zmax = jnp.max(jnp.where(fin, flat, -big))
    zmax = jnp.minimum(zmax, zmin + jnp.float32(LIFT_HIST_SPAN_CAP))
    width = jnp.maximum(zmax - zmin, 1e-9) / LIFT_HIST_BINS
    idx = jnp.clip(
        ((vals - zmin) / width).astype(jnp.int32), 0, LIFT_HIST_BINS - 1
    )
    bins = jnp.arange(LIFT_HIST_BINS, dtype=jnp.int32)
    counts = jnp.sum(
        jnp.where(idx[:, None] == bins[None, :], finf[:, None], 0.0), axis=0
    )  # [NB]
    cdf = jnp.cumsum(counts)
    pos = qlevels * jnp.maximum(n - 1.0, 0.0)  # [S] fractional order index
    # first bin whose inclusive cdf exceeds pos = the bin holding it
    b = jnp.sum((cdf[None, :] <= pos[:, None]).astype(jnp.int32), axis=1)
    b = jnp.clip(b, 0, LIFT_HIST_BINS - 1)
    c_b = jnp.maximum(counts[b], 1.0)
    below = cdf[b] - counts[b]
    v = zmin + (b.astype(jnp.float32) + (pos - below + 0.5) / c_b) * width
    v = jnp.clip(v, zmin, zmax)
    return jnp.where(n > 0, v, jnp.nan)


def make_detect_program(
    modality_names: Sequence[str],
    t_at_level: Sequence[int],
    frame_shape: Tuple[int, int],
    dn_params,
    cg_params,
    K_mat: np.ndarray,
    max_candidates: int = 16,
    max_dr: int = 64,
    icp: Optional[ICPParams] = None,
    lift_window: int = 160,
    num_seeds: int = 3,
    seed_min_gap: float = 0.015,
    min_inlier_frac: float = 0.25,
    batch: Optional[int] = None,
    mesh=None,
    flat_output: bool = False,
    device_nms: bool = False,
    fine_compact: int = 0,
    lift_impl: str = "hist",
    icp_window: int = 0,
):
    """Build the fused detect program for one (frame shape, K) pair.

    Returns a jitted function

        run(sources, kernels_low, feat_arrays, nfeat_l0,
            nfeat_l1, sizes_l0, sizes_l1, views: PackedViews, threshold)
        -> (packed [5, K+1] match arrays, poses [K, 4, 4] f32,
            residuals [K] f32, keep [K] bool)

    (leading batch axis on every output when ``batch`` is set). ``poses``
    already compose the template's training-view pose, i.e. they map
    model -> scene camera when view poses were registered.

    ``flat_output=True`` concatenates the four outputs into ONE f32
    array per frame (see ``flatten_outputs``/``unflatten_outputs``): one
    device-to-host transfer per call, not four.

    ``device_nms=True`` additionally runs hypothesis scoring + pose-
    cluster NMS ON DEVICE (make_cluster_stage) and returns its compact
    flat record instead; the run function then takes two extra trailing
    arguments ``(cls_of_tid [nT] i32, nms_scalars [2] f32)`` — see
    make_cluster_stage. This is the production pipeline path: the host
    only unpacks the few final cluster records per frame.

    ``lift_impl`` selects the hypothesis-lift depth-quantile estimator:
    ``"hist"`` (default, histogram CDF — _hist_quantiles) or ``"sort"``
    (exact jnp.nanquantile).

    ``icp_window`` > 0 runs the FINE ICP phase with the windowed
    association (refine/projective.py _associate_window): per surviving
    candidate one static [icp_window, icp_window] crop of the packed
    scene around the match center replaces the full-scene row gather —
    the ICP stage's latency-bound device cost — with two dense one-hot
    contractions (exact gather). Size it to the bank's largest template
    bbox plus a pose-drift margin (pipeline.py auto-sizes it); 0 keeps
    the full-scene gather everywhere. The coarse (seed) phase always
    uses the full-scene gather — its correspondence caps exceed any
    reasonable window margin at coarse pyramid levels.

    With ``mesh`` (a 2D (data, model) jax Mesh, parallel/sharding.py
    make_mesh) the SAME program shards: frames over ``data``, the
    template bank over ``model`` in the match stage, and the hypothesis
    lanes over ``model`` in the ICP stage — requires ``batch`` divisible
    by the data axis, the bank size and ``max_candidates`` divisible by
    the model axis. Results are identical to the unsharded program.
    """
    from object_detector_6d_tpu.geom.backproject import depth_to_3d
    from object_detector_6d_tpu.geom.normals import FalsNormals

    icp = icp or ICPParams(iterations=100)
    H, W = frame_shape
    K_cap = max_candidates
    S = num_seeds
    K_mat = np.asarray(K_mat, np.float64)
    est = FalsNormals(H, W, K_mat)
    fx, fy = np.float32(K_mat[0, 0]), np.float32(K_mat[1, 1])
    cx, cy = np.float32(K_mat[0, 2]), np.float32(K_mat[1, 2])
    Kj = jnp.asarray(K_mat)
    qlevels = jnp.asarray([0.25, 0.5, 0.75][:S])
    win = lift_window

    match_prog = mp.make_match_program(
        modality_names,
        t_at_level,
        frame_shape,
        dn_params,
        cg_params,
        max_candidates,
        max_dr,
        batch=batch,
        mesh=mesh,
    )

    depth_idx = next(
        i for i, n in enumerate(modality_names) if n != "ColorGradient"
    )

    def geometry_b(depths):
        """[B, H, W] u16 -> (z_img [B, H, W], scene [B, H*W, 7]), hoisted
        out of the per-frame lift/ICP vmap."""
        def one(d):
            cloud = depth_to_3d(d, Kj)
            s7 = pack_scene7(jnp.concatenate([cloud, est(cloud)], -1))
            return cloud[..., 2], s7
        return jax.vmap(one)(depths)

    all_levels = list(range((icp.num_levels) - 1, -1, -1))
    # Phase split: the COARSEST level alone runs on every (candidate,
    # seed) lane; every remaining level runs on the K surviving lanes.
    # Round 2 put two levels in the K*S phase — but one coarsest-level
    # pass (8 masked iterations on a 2^(L-1)-stride model subsample)
    # already separates object seeds from background/occluder seeds via
    # the residual + inlier-fraction gate, and the per-frame ICP lane
    # count drives the fused-detect device time, so the S-fold lanes
    # should run as little as discrimination needs.
    if icp.num_levels >= 2:
        coarse_levels, fine_levels = all_levels[:1], all_levels[1:]
    else:
        coarse_levels, fine_levels = all_levels, []
    # survivor compaction (core/config.py DetectParams.fine_compact):
    # M < K_cap -> only the M best candidates by coarse residual run the
    # fine levels; the rest drop (capacity semantics)
    M_fine = fine_compact if (0 < fine_compact < K_cap) else K_cap
    # ``solves_per_assoc`` > 1 trades scene-gather passes (the ICP
    # stage's device cost) for extra fixed-pair GN solves (~free):
    # iters_per_level counts ASSOCIATIONS, so the total GN-update budget
    # iterations/num_levels is preserved while gathers divide by solves.
    n_solves = max(1, icp.solves_per_assoc)
    iters = max(1, icp.iterations // icp.num_levels // n_solves)
    # ICPParams.finest_assoc: polish-budget cap on the finest (full
    # model cloud) level — it holds ~half the stage's gather rows, but
    # by the time it runs the stride-2 level has converged the pose to
    # sub-pixel projection error, so its correspondence field is static
    # from the first association (config.py docstring).
    fine_iters = [
        min(iters, icp.finest_assoc) if (lvl == 0 and icp.finest_assoc > 0)
        else iters
        for lvl in fine_levels
    ]
    # NOTE the update-norm early-exit is NOT icp.tolerance (the NN
    # rule's semantics don't transfer — refine/projective.py docstring).
    # With the normal-compatibility gate, accuracy is insensitive to
    # this knob (measured ~1.5 mm from 1e-4 through 3e-3); 3e-4 exits
    # the convergence tail several iterations earlier per level.
    proj_tol = 3e-4

    def lift(z_img, scene7, packed, views: PackedViews):
        """Single frame: [5, K+1] match arrays -> ICP-ready hypotheses.

        ``z_img`` / ``scene7`` come from the batch-hoisted geometry
        stage (``geometry_b``)."""
        xs = packed[0, :-1].astype(jnp.int32)
        ys = packed[1, :-1].astype(jnp.int32)
        tids = packed[3, :-1].astype(jnp.int32)
        keep = packed[4, :-1] > 0

        # --- multi-depth lift: window depth quantiles per candidate ---
        bw = views.bbox_wh[tids, 0]
        bh = views.bbox_wh[tids, 1]
        cx_i = xs + bw // 2
        cy_i = ys + bh // 2

        def window_q(cxi, cyi, bwi, bhi):
            x0 = jnp.clip(cxi - win // 2, 0, W - win)
            y0 = jnp.clip(cyi - win // 2, 0, H - win)
            w = jax.lax.dynamic_slice(z_img, (y0, x0), (win, win))[::2, ::2]
            # stride-2 subsample (the exact "sort" path sorts the
            # window; the default "hist" path replaces the sort with a
            # histogram CDF — _hist_quantiles); restrict the
            # quantiles to the matched template's bbox — for objects
            # much smaller than the window every quantile is background
            # depth otherwise, and all seeds lift onto the background
            xs_g = x0 + jnp.arange(0, win, 2)
            ys_g = y0 + jnp.arange(0, win, 2)
            inx = (xs_g >= cxi - bwi // 2 - 1) & (xs_g <= cxi + bwi // 2 + 1)
            iny = (ys_g >= cyi - bhi // 2 - 1) & (ys_g <= cyi + bhi // 2 + 1)
            w = jnp.where(iny[:, None] & inx[None, :], w, jnp.nan)
            if lift_impl == "sort":
                return jnp.nanquantile(w, qlevels)
            return _hist_quantiles(w, qlevels)

        zq = jax.vmap(window_q)(cx_i, cy_i, bw, bh)  # [K, S]
        finite = jnp.isfinite(zq)
        # first-occurrence dedup: seed j invalid if a valid earlier seed
        # sits within seed_min_gap (host path semantics, pipeline.py)
        close = jnp.abs(zq[:, :, None] - zq[:, None, :]) < seed_min_gap
        seed_ok = jnp.ones_like(finite)
        for j in range(1, S):
            earlier = jnp.stack(
                [finite[:, i] & seed_ok[:, i] & close[:, j, i] for i in range(j)],
                -1,
            ).any(-1)
            seed_ok = seed_ok.at[:, j].set(~earlier)
        seed_ok = seed_ok & finite & keep[:, None] & views.views_ok[tids][:, None]

        # translation seed: reproject match-bbox center at window depth,
        # shifted by the training view's anchor point
        cxf = xs.astype(jnp.float32) + bw.astype(jnp.float32) / 2.0
        cyf = ys.astype(jnp.float32) + bh.astype(jnp.float32) / 2.0
        zq_s = jnp.nan_to_num(zq, nan=1.0)
        tx = zq_s * ((cxf - cx) / fx)[:, None]
        ty = zq_s * ((cyf - cy) / fy)[:, None]
        target = jnp.stack([tx, ty, zq_s], -1)  # [K, S, 3]
        t0 = target - views.anchors[tids][:, None, :]
        pose0 = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (K_cap, S, 4, 4))
        pose0 = pose0.at[:, :, :3, 3].set(t0)

        models = views.model_bank[tids]  # [K, N, 6]
        n_model_valid = jnp.maximum(
            jnp.isfinite(models[..., 0]).sum(-1).astype(jnp.float32), 1.0
        )  # [K]
        # fine-phase window origins (icp_window > 0): one static-size
        # crop around each match center replaces the full-scene gather
        wy0 = jnp.clip(cy_i - icp_window // 2, 0, max(H - icp_window, 0))
        wx0 = jnp.clip(cx_i - icp_window // 2, 0, max(W - icp_window, 0))
        return tids, keep, seed_ok, pose0, models, n_model_valid, wy0, wx0

    def icp_coarse(scene7, flat_models, flat_poses):
        """Phase 1: coarse levels over any number of hypothesis lanes."""
        return jax.vmap(
            lambda m, p: icp_levels(
                m, p, scene7, fx, fy, cx, cy, H, W,
                levels=coarse_levels, iters_per_level=iters,
                tolerance=proj_tol, solves=n_solves,
            )
        )(flat_models, flat_poses)

    def select_seed(res1, nin1, poses1, seed_ok, n_model_valid):
        """Best seed per candidate ([K, S] lanes -> [K]).

        A seed is only eligible if its last coarse ICP step kept a
        sizable inlier fraction (of that level's model subsample):
        frozen hypotheses (every correspondence rejected -> pose
        unchanged, residual 0/1 = 0) and plane-locked hypotheses (a few
        points latched onto the background) otherwise beat the true pose
        on raw residual [measured: a q75 background seed with residual
        exactly 0.0 won over the correct q50 seed].
        """
        last_coarse = coarse_levels[-1] if coarse_levels else 0
        n_coarse = n_model_valid / (1 << last_coarse)
        enough1 = nin1 >= min_inlier_frac * n_coarse[:, None]
        res_sel = jnp.where(seed_ok & enough1, res1, jnp.inf)
        best = jnp.argmin(res_sel, axis=1)
        best_res = jnp.take_along_axis(res_sel, best[:, None], 1)[:, 0]
        best_pose = jnp.take_along_axis(
            poses1, best[:, None, None, None], 1
        )[:, 0]
        return best_res, best_pose

    def icp_fine(scene7, models, poses, wins=None):
        """Phase 2: the remaining (fine) levels; ``wins`` switches the
        association to the windowed path (icp_window > 0)."""
        if wins is None:
            return jax.vmap(
                lambda m, p: icp_levels(
                    m, p, scene7, fx, fy, cx, cy, H, W,
                    levels=fine_levels, iters_per_level=fine_iters,
                    tolerance=proj_tol, solves=n_solves,
                )
            )(models, poses)
        win_imgs, wys, wxs = wins
        return jax.vmap(
            lambda m, p, wi, wy, wx: icp_levels(
                m, p, scene7, fx, fy, cx, cy, H, W,
                levels=fine_levels, iters_per_level=fine_iters,
                tolerance=proj_tol, solves=n_solves,
                window=(wi, wy, wx),
            )
        )(models, poses, win_imgs, wys, wxs)

    def crop_windows(scene7, wy0, wx0):
        """[M] origins -> ([M, iw, iw, C], wy0, wx0) window crops."""
        C = scene7.shape[-1]
        scene_img = scene7.reshape(H, W, C)
        crops = jax.vmap(
            lambda y0, x0: jax.lax.dynamic_slice(
                scene_img, (y0, x0, 0), (icp_window, icp_window, C))
        )(wy0, wx0)
        return crops, wy0, wx0

    def lift_and_refine(z_img, scene7, packed, views: PackedViews):
        """Single frame: [5, K+1] match arrays -> refined poses [K].

        Two-phase ICP with a one-level seed phase: the COARSEST pyramid
        level refines every (candidate, depth-seed) lane on a cheap
        model subsample; each candidate's best seed is then selected
        and only K lanes pay for every remaining level (the finest
        level sweeps the full model cloud, ~75% of the
        point-iterations)."""
        tids, keep, seed_ok, pose0, models, n_model_valid, wy0, wx0 = lift(
            z_img, scene7, packed, views
        )
        flat_models = jnp.broadcast_to(
            models[:, None], (K_cap, S) + models.shape[1:]
        ).reshape(K_cap * S, -1, 6)
        flat_poses = pose0.reshape(K_cap * S, 4, 4)
        res1, poses1, nin1 = icp_coarse(scene7, flat_models, flat_poses)
        best_res, best_pose = select_seed(
            res1.reshape(K_cap, S), nin1.reshape(K_cap, S),
            poses1.reshape(K_cap, S, 4, 4), seed_ok, n_model_valid,
        )
        if fine_levels and M_fine < K_cap:
            # survivor compaction: rank by coarse residual (coarse
            # failures rank inf; argsort is stable so lane order breaks
            # ties), refine only the top M_fine lanes, scatter back;
            # non-selected lanes drop exactly like coarse failures
            rank = jnp.where(jnp.isfinite(best_res), best_res, jnp.inf)
            sel = jnp.argsort(rank)[:M_fine]
            wins = (crop_windows(scene7, wy0[sel], wx0[sel])
                    if icp_window > 0 else None)
            res2, poses2, nin2 = icp_fine(scene7, models[sel],
                                          best_pose[sel], wins)
            enough2 = nin2 >= min_inlier_frac * n_model_valid[sel]
            res_f = jnp.where(
                jnp.isfinite(best_res[sel]) & enough2, res2, jnp.inf)
            best_res = jnp.full_like(best_res, jnp.inf).at[sel].set(res_f)
            best_pose = best_pose.at[sel].set(poses2)
        elif fine_levels:
            wins = (crop_windows(scene7, wy0, wx0)
                    if icp_window > 0 else None)
            res2, poses2, nin2 = icp_fine(scene7, models, best_pose, wins)
            enough2 = nin2 >= min_inlier_frac * n_model_valid
            best_res = jnp.where(
                jnp.isfinite(best_res) & enough2, res2, jnp.inf
            )
            best_pose = poses2
        final = compose_view_poses(best_pose, views.view_poses[tids])
        keep_out = keep & jnp.isfinite(best_res)
        # debug-mode watch (trace-time no-op otherwise): NaN in a KEPT
        # pose is a bug — NaN is legal only as the masked-invalid value
        # inside the programs (utils/debug.py)
        from object_detector_6d_tpu.utils.debug import nan_watch

        final = nan_watch(final, "detect.poses",
                          mask=keep_out[:, None, None])
        return final, best_res, keep_out

    def lift_and_refine_sharded(z_img, scene7, packed, views: PackedViews):
        """Per-device variant: this device refines only its slice of the
        hypothesis lanes (the SP-analog axis of SURVEY.md section 2.3 —
        hypotheses shard over ``model``); two small all_gathers merge the
        per-seed and final results. Runs on each (data, model) device for
        its local frames; the lift itself is recomputed per device
        (cheaper than communicating an [H*W, 7] scene)."""
        tp = mesh.shape["model"]
        mi = jax.lax.axis_index("model")
        tids, keep, seed_ok, pose0, models, n_model_valid, wy0, wx0 = lift(
            z_img, scene7, packed, views
        )
        lanes1 = (K_cap * S) // tp
        flat_models = jnp.broadcast_to(
            models[:, None], (K_cap, S) + models.shape[1:]
        ).reshape(K_cap * S, -1, 6)
        flat_poses = pose0.reshape(K_cap * S, 4, 4)
        m_l = jax.lax.dynamic_slice_in_dim(flat_models, mi * lanes1, lanes1)
        p_l = jax.lax.dynamic_slice_in_dim(flat_poses, mi * lanes1, lanes1)
        res1, poses1, nin1 = icp_coarse(scene7, m_l, p_l)
        res1 = jax.lax.all_gather(res1, "model", axis=0, tiled=True)
        poses1 = jax.lax.all_gather(poses1, "model", axis=0, tiled=True)
        nin1 = jax.lax.all_gather(nin1, "model", axis=0, tiled=True)
        best_res, best_pose = select_seed(
            res1.reshape(K_cap, S), nin1.reshape(K_cap, S),
            poses1.reshape(K_cap, S, 4, 4), seed_ok, n_model_valid,
        )
        if fine_levels and M_fine < K_cap:
            # survivor compaction, sharded: the selection is computed
            # identically on every device (best_res is replicated after
            # the coarse all_gather), each device refines its slice of
            # the M_fine compacted lanes
            rank = jnp.where(jnp.isfinite(best_res), best_res, jnp.inf)
            sel = jnp.argsort(rank)[:M_fine]
            lanes2 = M_fine // tp
            sel_l = jax.lax.dynamic_slice_in_dim(sel, mi * lanes2, lanes2)
            wins = (crop_windows(scene7, wy0[sel_l], wx0[sel_l])
                    if icp_window > 0 else None)
            res2, poses2, nin2 = icp_fine(scene7, models[sel_l],
                                          best_pose[sel_l], wins)
            res2 = jax.lax.all_gather(res2, "model", axis=0, tiled=True)
            poses2 = jax.lax.all_gather(poses2, "model", axis=0, tiled=True)
            nin2 = jax.lax.all_gather(nin2, "model", axis=0, tiled=True)
            enough2 = nin2 >= min_inlier_frac * n_model_valid[sel]
            res_f = jnp.where(
                jnp.isfinite(best_res[sel]) & enough2, res2, jnp.inf)
            best_res = jnp.full_like(best_res, jnp.inf).at[sel].set(res_f)
            best_pose = best_pose.at[sel].set(poses2)
        elif fine_levels:
            lanes2 = K_cap // tp
            m_l = jax.lax.dynamic_slice_in_dim(models, mi * lanes2, lanes2)
            p_l = jax.lax.dynamic_slice_in_dim(best_pose, mi * lanes2, lanes2)
            wins = None
            if icp_window > 0:
                wy_l = jax.lax.dynamic_slice_in_dim(wy0, mi * lanes2, lanes2)
                wx_l = jax.lax.dynamic_slice_in_dim(wx0, mi * lanes2, lanes2)
                wins = crop_windows(scene7, wy_l, wx_l)
            res2, poses2, nin2 = icp_fine(scene7, m_l, p_l, wins)
            res2 = jax.lax.all_gather(res2, "model", axis=0, tiled=True)
            poses2 = jax.lax.all_gather(poses2, "model", axis=0, tiled=True)
            nin2 = jax.lax.all_gather(nin2, "model", axis=0, tiled=True)
            enough2 = nin2 >= min_inlier_frac * n_model_valid
            best_res = jnp.where(
                jnp.isfinite(best_res) & enough2, res2, jnp.inf
            )
            best_pose = poses2
        final = compose_view_poses(best_pose, views.view_poses[tids])
        keep_out = keep & jnp.isfinite(best_res)
        return final, best_res, keep_out

    cluster_stage = make_cluster_stage(K_cap) if device_nms else None

    def _nms_out(packed, poses, res, keep, cls_of_tid, nms_scalars):
        """Apply the device NMS stage ([B]-batched or single-frame)."""
        if batch is None:
            return cluster_stage(packed, poses, res, keep, cls_of_tid,
                                 nms_scalars)
        return jax.vmap(
            lambda p, po, r, k: cluster_stage(p, po, r, k, cls_of_tid,
                                              nms_scalars)
        )(packed, poses, res, keep)

    if mesh is not None:
        from jax.sharding import PartitionSpec as P
        from jax import shard_map

        tp = mesh.shape["model"]
        if (K_cap * S) % tp or K_cap % tp:
            raise ValueError(
                f"max_candidates ({K_cap}) and max_candidates*num_seeds "
                f"({K_cap * S}) must divide the model axis ({tp})"
            )
        if M_fine < K_cap and M_fine % tp:
            raise ValueError(
                f"fine_compact ({M_fine}) must divide the model axis ({tp})"
            )

        refine_sharded = shard_map(
            lambda depths, packed, views: (
                lambda zs: jax.vmap(
                    lambda z, s7, p: lift_and_refine_sharded(z, s7, p, views)
                )(zs[0], zs[1], packed)
            )(geometry_b(depths)),
            mesh=mesh,
            in_specs=(P("data"), P("data"), P()),
            out_specs=(P("data"), P("data"), P("data")),
            check_vma=False,
        )

        @jax.jit
        def run_sharded(
            sources, kernels_low, feat_arrays,
            nfeat_l0, nfeat_l1, sizes_l0, sizes_l1,
            views: PackedViews, threshold, *nms_args,
        ):
            packed = match_prog(
                sources, kernels_low, feat_arrays,
                nfeat_l0, nfeat_l1, sizes_l0, sizes_l1, threshold,
            )
            poses, res, keep = refine_sharded(
                sources[depth_idx], packed, views
            )
            if device_nms:
                return _nms_out(packed, poses, res, keep, *nms_args)
            if flat_output:
                return flatten_outputs(packed, poses, res, keep, K_cap)
            return packed, poses, res, keep

        return run_sharded

    @jax.jit
    def run(
        sources,
        kernels_low,
        feat_arrays,
        nfeat_l0,
        nfeat_l1,
        sizes_l0,
        sizes_l1,
        views: PackedViews,
        threshold,
        *nms_args,
    ):
        packed = match_prog(
            sources, kernels_low, feat_arrays,
            nfeat_l0, nfeat_l1, sizes_l0, sizes_l1, threshold,
        )
        depth = sources[depth_idx]
        if batch is None:
            z_img_b, scene_b = geometry_b(depth[None])
            poses, res, keep = lift_and_refine(
                z_img_b[0], scene_b[0], packed, views)
        else:
            z_img_b, scene_b = geometry_b(depth)
            poses, res, keep = jax.vmap(
                lambda z, s7, p: lift_and_refine(z, s7, p, views)
            )(z_img_b, scene_b, packed)
        if device_nms:
            return _nms_out(packed, poses, res, keep, *nms_args)
        if flat_output:
            return flatten_outputs(packed, poses, res, keep, K_cap)
        return packed, poses, res, keep

    return run
