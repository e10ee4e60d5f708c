"""ADD-0.1d parity: the canonical cv2 pipeline vs this framework.

The north-star accuracy target (BASELINE.json) is "ADD-0.1d matching CPU
reference within 0.5%". This tool composes the reference pipeline from
the canonical components (cv2.linemod match -> hypothesis lift ->
cv2.ppf_match_3d ICP, exactly the SURVEY.md section 3.1 call stack) and
runs BOTH pipelines over the same deterministic synthetic scene sets:

  # 1. oracle side (OpenCV 4.6 contrib python):
  /usr/bin/python3 tools/parity_add.py oracle <config>
      -> writes tests/golden/parity_<config>_oracle.npz
  # 2. our side (venv python; runs detect_fused, loads the oracle npz):
  python3 tools/parity_add.py ours <config>
      -> prints the per-scene and summary ADD / ADD-0.1d table
  (ODC_PROMOTED=1 runs the shipping ICP schedule; chip_smoke.py runs
  the ``base`` set at that schedule on the GPU)

Configs (BASELINE.json `configs` analogs). Set sizes were grown 20/10/12
-> 64/32/64 in round 5: at >= 64 object
instances per config one scene is 1.6% of the rate, so the 0.5%
north-star criterion resolves arithmetically at the one-scene
granularity (any success-count difference is visible). The FIRST
20/10/12 scenes of every set are bit-identical to the round-4 sets (the
rng stream is consumed per scene, in order), so the historical numbers
and the test_parity_regression scene pins stay valid.

  base   64 scenes, one object, rotations +/-12 deg about random axes
         through the centroid + translations +/-40 mm (config 1).
         Golden keeps its historical name parity_add_oracle.npz.
  occl   the same 64 posed scenes with a foreground slab occluding part
         of the object (config 3, Occlusion-LINEMOD analog).
  two    32 scenes containing TWO object classes (the snowman and a
         0.78-scale variant), z-min composed; both classes must be
         detected and refined per scene (config 4 analog; 64 object
         instances).
  views  a 5-view training arc (+/-20 deg yaw about the object
         centroid); detection at 64 unseen orientations up to the arc
         edge — exercises multi-view template banks and view-pose
         composition on both sides (configs 2/4 rotation regime).

ADD = mean_q ||T_est q - T_gt q|| over the sampled model cloud;
ADD-0.1d success = ADD < 0.1 * object diameter.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import scenes

GOLDEN_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "golden",
)
MODEL_POINTS = 512
MATCH_THRESHOLD = 70.0
OCCL_THRESHOLD = 55.0  # occlusion depresses similarity (test_occlusion)
LIFT_WINDOW = 160
SEED_MIN_GAP = 0.015
OCCL_RECT = (200, 320, 270, 345)  # (y0, y1, x0, x1), test_occlusion recipe


def golden_path(config):
    name = "parity_add_oracle" if config == "base" else f"parity_{config}_oracle"
    return os.path.join(GOLDEN_DIR, name + ".npz")


def sample_model(cloud, normals, mask):
    ok = mask & np.isfinite(cloud).all(-1) & np.isfinite(normals).all(-1)
    ys, xs = np.nonzero(ok)
    sel = np.linspace(0, len(ys) - 1, min(MODEL_POINTS, len(ys))).astype(int)
    pts = cloud[ys[sel], xs[sel]]
    nrm = normals[ys[sel], xs[sel]]
    return np.concatenate([pts, nrm], -1).astype(np.float32)


def add_metric(T_est, T_gt, model_pts):
    a = model_pts @ T_est[:3, :3].T + T_est[:3, 3]
    b = model_pts @ T_gt[:3, :3].T + T_gt[:3, 3]
    return float(np.linalg.norm(a - b, axis=-1).mean())


def diameter(model_pts):
    lo, hi = model_pts.min(0), model_pts.max(0)
    return float(np.linalg.norm(hi - lo))


def _occlude(d, g):
    y0, y1, x0, x1 = OCCL_RECT
    d = d.copy()
    g = g.copy()
    d[y0:y1, x0:x1] = 900  # 0.9 m slab, in front of everything
    g[y0:y1, x0:x1] = 200
    return d, g


# ----------------------------------------------------------------------
# scene sets (deterministic; numpy only, shared verbatim by both sides)
# ----------------------------------------------------------------------


N_BASE = 64  # base/occl scene count (first 20 == the round-4 set)
N_TWO = 32  # two-class scene count (first 10 == the round-4 set)


def scene_set(occlude=False):
    """base/occl: GT poses (pose_4x4, depth, gray, mask) per scene."""
    K = scenes.K_DEFAULT
    dep, gray, mask = scenes.snowman_scene()
    c = scenes.masked_centroid(dep, mask, K)
    rng = np.random.RandomState(0)
    out = []
    for i in range(N_BASE):
        axis = rng.normal(size=3)
        deg = rng.uniform(-12, 12)
        t = rng.uniform(-0.04, 0.04, size=3) * np.array([1.0, 0.8, 1.0])
        pose = scenes.rot_about(axis, deg, c)
        pose[:3, 3] += t
        d2, m2, g2 = scenes.render_posed(dep, mask, K, pose)
        if occlude:
            d2, g2 = _occlude(d2, g2)
        out.append((pose, d2, g2, m2))
    return K, dep, gray, mask, out


def scene_set_two():
    """two: each scene holds objA (posed) and objB (translated)."""
    K = scenes.K_DEFAULT
    depA, grayA, maskA = scenes.snowman_scene()
    depB, grayB, maskB = scenes.snowman_scene(scale=0.78)
    cA = scenes.masked_centroid(depA, maskA, K)
    rng = np.random.RandomState(1)
    out = []
    for i in range(N_TWO):
        axis = rng.normal(size=3)
        deg = rng.uniform(-10, 10)
        tA = rng.uniform(-0.03, 0.03, size=3) * np.array([1.0, 0.8, 1.0])
        poseA = scenes.rot_about(axis, deg, cA)
        poseA[:3, 3] += tA + np.array([0.06, -0.02, 0.0])
        tB = np.array([-0.27, 0.11, 0.03]) + rng.uniform(-0.02, 0.02, size=3)
        poseB = np.eye(4)
        poseB[:3, 3] = tB
        rA = scenes.render_posed(depA, maskA, K, poseA)
        rB = scenes.render_translated(depB, maskB, K, tB)
        d, m, g = scenes.merge_scenes([rA, rB])
        out.append(((poseA, poseB), d, g, m))
    train = {"objA": (depA, grayA, maskA), "objB": (depB, grayB, maskB)}
    return K, train, out


VIEW_DEGS = (-20.0, -10.0, 0.0, 10.0, 20.0)  # training yaw arc
# first 12 == the round-4 set (regression pins address them by index);
# 52 more unseen yaws appended inside the arc for the 64-scene set
TEST_DEGS = (-17.0, -13.0, -7.0, -3.0, 3.0, 7.0, 13.0, 17.0, -15.0, 5.0,
             15.0, -5.0) + tuple(
    float(d) for d in np.round(np.linspace(-19.5, 19.5, 52), 1))


def scene_set_views():
    """views: 5 training views (yaw about the centroid) + 12 test scenes
    at unseen yaws composed with small translations.

    The base training view's camera frame IS the model frame; training
    view k has view_pose P_k (model -> camera k), and a test scene at
    pose P carries GT model -> camera transform P."""
    K = scenes.K_DEFAULT
    dep, gray, mask = scenes.snowman_scene()
    c = scenes.masked_centroid(dep, mask, K)
    train = []
    for deg in VIEW_DEGS:
        P = scenes.rot_about(np.array([0.0, 1.0, 0.0]), deg, c)
        d2, m2, g2 = scenes.render_posed(dep, mask, K, P)
        train.append((P, d2, g2, m2))
    rng = np.random.RandomState(2)
    out = []
    for deg in TEST_DEGS:
        P = scenes.rot_about(np.array([0.0, 1.0, 0.0]), deg, c)
        P[:3, 3] += rng.uniform(-0.03, 0.03, size=3) * np.array([1, 0.8, 1])
        d2, m2, g2 = scenes.render_posed(dep, mask, K, P)
        out.append((P, d2, g2, m2))
    return K, dep, gray, mask, train, out


# ----------------------------------------------------------------------
# oracle side: /usr/bin/python3 (cv2 4.6 contrib)
# ----------------------------------------------------------------------


class _OracleStack:
    """The canonical components wired exactly as SURVEY.md section 3.1."""

    def __init__(self, K):
        import cv2

        self.cv2 = cv2
        self.K = K
        self.det = cv2.linemod.getDefaultLINEMOD()
        self.est = cv2.rgbd.RgbdNormals_create(
            480, 640, cv2.CV_32F, K, 5,
            cv2.rgbd.RgbdNormals_RGBD_NORMALS_METHOD_FALS,
        )
        self.icp = cv2.ppf_match_3d_ICP(100, 0.005, 2.5, 6)
        self.views = {}  # (class_id, template_id) -> (model, anchor, bbox, P)

    def add_view(self, class_id, dep, gray, mask, view_pose=None):
        cv2 = self.cv2
        bgr = cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)
        tid, bbox = self.det.addTemplate([bgr, dep], class_id,
                                         mask.astype(np.uint8) * 255)
        assert tid >= 0, f"oracle template extraction failed ({class_id})"
        cloud = cv2.rgbd.depthTo3d(dep, self.K)
        normals = self.est.apply(cloud)
        model = sample_model(cloud, normals, mask)
        zm = float(np.nanmedian(model[:, 2]))
        fx, fy, cx, cy = self.K[0, 0], self.K[1, 1], self.K[0, 2], self.K[1, 2]
        bx, by, bw, bh = bbox
        anchor = np.array(
            [zm * (bx + bw / 2.0 - cx) / fx, zm * (by + bh / 2.0 - cy) / fy, zm]
        )
        self.views[(class_id, tid)] = (model, anchor, bbox, view_pose)
        return tid, model

    def detect(self, dep, gray, class_id=None, threshold=MATCH_THRESHOLD,
               max_hyp=4):
        """Top matches (optionally of one class) -> refined best pose.

        The reference pipeline is match -> multi-hypothesis ICP ->
        hypothesis SCORING (north_star: "hypothesis scoring ... depth
        consistency"): refine up to ``max_hyp`` top matches x 3 depth
        seeds, score each refined pose by projecting the transformed
        model into the scene depth (inlier = |z_model - z_scene| <
        10 mm), and keep the first hypothesis in similarity order whose
        inlier fraction clears 0.7 (else the best fraction). Taking the
        single best match naively latches onto a similar OTHER object
        in multi-class scenes (measured: an objB template matching on
        objA's appearance at similarity > 70), and cv2's reported ICP
        ``residual`` does not discriminate (measured: the correct pose
        scored 0.036 vs 0.014 for the wrong-object fit). Returns
        (pose 4x4, found) with the matched view's pose composed
        (model -> scene camera), or (nan, False)."""
        cv2 = self.cv2
        bgr2 = cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)
        matches, _ = self.det.match([bgr2, dep], threshold)
        cand = [mm for mm in matches
                if class_id is None or mm.class_id == class_id][:max_hyp]
        if not cand:
            return np.full((4, 4), np.nan), False
        cloud2 = cv2.rgbd.depthTo3d(dep, self.K)
        normals2 = self.est.apply(cloud2)
        scene6 = np.concatenate([cloud2, normals2], -1)[::2, ::2].reshape(-1, 6)
        scene6 = scene6[np.isfinite(scene6).all(-1)].astype(np.float32)
        fx, fy, cx, cy = self.K[0, 0], self.K[1, 1], self.K[0, 2], self.K[1, 2]
        z_img = cloud2[..., 2]

        def depth_consistency(pose, model, tol=0.010):
            """Depth-consistency statistics of a refined pose.

            err = z_model - z_scene per projected model point; err >>
            tol = the point is occluded by a nearer surface (config 3's
            slab), err << -tol = free-space violation (the model floats
            in front of the observed surface). Returns (plain, accept):
            plain = inliers / projected points ranks competing
            hypotheses (measured: 0.77 for a true fit vs 0.43 for a
            wrong-object fit that nests behind the bigger object's
            surface); accept additionally admits heavily-occluded true
            fits (inliers-of-visible >= 0.9 with violations <= 0.05 —
            measured 0.96/0.03 under the config-3 slab, vs 0.86/0.07
            for the best wrong-object fit)."""
            q = model[:, :3] @ pose[:3, :3].T + pose[:3, 3]
            u = np.round(q[:, 0] / q[:, 2] * fx + cx).astype(int)
            v = np.round(q[:, 1] / q[:, 2] * fy + cy).astype(int)
            ok = (u >= 0) & (u < 640) & (v >= 0) & (v < 480) & (q[:, 2] > 0)
            n = int(ok.sum())
            if n < 0.2 * len(q):
                return 0.0, False
            zs = z_img[v[ok], u[ok]]
            err = q[ok, 2] - zs
            fin = np.isfinite(err)
            inlier = int((fin & (np.abs(err) < tol)).sum())
            occluded = int((fin & (err >= tol)).sum())
            viol = int((fin & (err <= -tol)).sum())
            plain = inlier / n
            vis_aware = inlier / max(n - occluded, 1)
            accept = plain >= 0.5 or (vis_aware >= 0.9 and viol / n <= 0.05)
            return plain, accept

        hyps = []  # (match order i, plain score, accept, pose, view_pose)
        for mi, m in enumerate(cand):
            model, anchor, bbox, view_pose = self.views[
                (m.class_id, m.template_id)]
            bw, bh = bbox[2], bbox[3]
            # multi-depth lift: window quantile seeds, dedup (pipeline.py)
            cxi = int(np.clip(m.x + bw // 2 - LIFT_WINDOW // 2, 0,
                              640 - LIFT_WINDOW))
            cyi = int(np.clip(m.y + bh // 2 - LIFT_WINDOW // 2, 0,
                              480 - LIFT_WINDOW))
            w = z_img[cyi:cyi + LIFT_WINDOW, cxi:cxi + LIFT_WINDOW]
            zq = np.nanquantile(w, [0.25, 0.5, 0.75])
            zs = []
            for z in zq[np.isfinite(zq)]:
                if all(abs(z - z2) > SEED_MIN_GAP for z2 in zs):
                    zs.append(float(z))
            for z in zs:
                target = np.array(
                    [z * (m.x + bw / 2.0 - cx) / fx,
                     z * (m.y + bh / 2.0 - cy) / fy, z]
                )
                p0 = cv2.ppf_match_3d_Pose3D()
                T0 = np.eye(4)
                T0[:3, 3] = target - anchor
                p0.updatePose(T0)
                retval, out_poses = self.icp.registerModelToScene(
                    model, scene6, [p0])
                for p in out_poses:
                    plain, acc = depth_consistency(p.pose, model)
                    hyps.append((mi, plain, acc, p.pose, view_pose))
        good = [h for h in hyps if h[2]]
        if not good:
            # nothing fits the scene depth: an honest miss (measured:
            # the NN ICP can diverge off a correct seed when a second
            # object nearby captures correspondences — reporting the
            # best-scoring wrong fit would fake a detection)
            return np.full((4, 4), np.nan), False
        # first match in similarity order among accepted fits, best
        # consistency among that match's seeds
        mi0 = min(h[0] for h in good)
        _, _, _, pose, view_pose = max(
            (h for h in good if h[0] == mi0), key=lambda h: h[1])
        if view_pose is not None:
            pose = pose @ view_pose
        return pose, True


def run_oracle(config):
    if config in ("base", "occl"):
        K, dep, gray, mask, scene_list = scene_set(occlude=(config == "occl"))
        st = _OracleStack(K)
        tid, model = st.add_view("obj", dep, gray, mask)
        est_poses = np.full((len(scene_list), 4, 4), np.nan)
        est_found = np.zeros(len(scene_list), bool)
        thr = OCCL_THRESHOLD if config == "occl" else MATCH_THRESHOLD
        for i, (gt, d2, g2, m2) in enumerate(scene_list):
            est_poses[i], est_found[i] = st.detect(d2, g2, threshold=thr)
            print(f"scene {i:2d}: found={est_found[i]}", flush=True)
        gts = np.stack([s[0] for s in scene_list])
        np.savez_compressed(
            golden_path(config),
            gt_poses=gts, est_poses=est_poses, est_found=est_found,
            model=model, diameter=diameter(model[:, :3]),
        )
    elif config == "two":
        K, train, scene_list = scene_set_two()
        st = _OracleStack(K)
        models = {}
        for cid in ("objA", "objB"):
            dep, gray, mask = train[cid]
            tid, models[cid] = st.add_view(cid, dep, gray, mask)
        n = len(scene_list)
        est_poses = np.full((n, 2, 4, 4), np.nan)
        est_found = np.zeros((n, 2), bool)
        for i, ((gtA, gtB), d2, g2, m2) in enumerate(scene_list):
            for j, cid in enumerate(("objA", "objB")):
                est_poses[i, j], est_found[i, j] = st.detect(d2, g2, cid)
            print(f"scene {i:2d}: found={est_found[i]}", flush=True)
        np.savez_compressed(
            golden_path(config),
            gt_poses=np.stack([np.stack(s[0]) for s in scene_list]),
            est_poses=est_poses, est_found=est_found,
            modelA=models["objA"], modelB=models["objB"],
            diameterA=diameter(models["objA"][:, :3]),
            diameterB=diameter(models["objB"][:, :3]),
        )
    elif config == "views":
        K, dep, gray, mask, train, scene_list = scene_set_views()
        st = _OracleStack(K)
        # model frame = base training view camera frame: each view's ICP
        # model lives in ITS camera frame; composing its P_k maps back
        base_model = None
        for (P, d2, g2, m2) in train:
            tid, model = st.add_view("obj", d2, g2, m2, view_pose=P)
            if np.allclose(P[:3, :3], np.eye(3)) and base_model is None:
                base_model = model
        assert base_model is not None
        est_poses = np.full((len(scene_list), 4, 4), np.nan)
        est_found = np.zeros(len(scene_list), bool)
        for i, (gt, d2, g2, m2) in enumerate(scene_list):
            est_poses[i], est_found[i] = st.detect(d2, g2)
            print(f"scene {i:2d}: found={est_found[i]}", flush=True)
        np.savez_compressed(
            golden_path(config),
            gt_poses=np.stack([s[0] for s in scene_list]),
            est_poses=est_poses, est_found=est_found,
            model=base_model, diameter=diameter(base_model[:, :3]),
        )
    else:
        raise SystemExit(f"unknown config {config}")
    print(f"oracle golden -> {golden_path(config)}")


# ----------------------------------------------------------------------
# our side: venv python (JAX)
# ----------------------------------------------------------------------


def _our_detector(promoted=None, **kw):
    from object_detector_6d_tpu.api.pipeline import PoseDetector
    from object_detector_6d_tpu.core.config import DetectParams, ICPParams

    # promoted (ODC_PROMOTED=1 when not given): the shipping economy
    # schedule (solves_per_assoc=2, finest_assoc=2, num_seeds=2,
    # fine_compact=8 — the last is a no-op here since max_hypotheses=8
    # already bounds the fine lanes, but it keeps the flag set
    # identical to the headline bench config). The parity table must be
    # re-run at whatever schedule ships.
    if promoted is None:
        promoted = os.environ.get("ODC_PROMOTED", "") not in ("", "0")
    if promoted:
        params = DetectParams(
            match_threshold=MATCH_THRESHOLD, max_hypotheses=8,
            icp=ICPParams(iterations=32, num_levels=4, solves_per_assoc=2,
                          finest_assoc=2),
            num_seeds=2, fine_compact=8)
    else:
        params = DetectParams(match_threshold=MATCH_THRESHOLD,
                              max_hypotheses=8,
                              icp=ICPParams(iterations=32, num_levels=4))
    return PoseDetector(
        params=params,
        model_points=MODEL_POINTS,
        scene_window=LIFT_WINDOW,
        **kw,
    )


def _report(config, rows, thr, per_scene=True):
    """rows: (label, ours_add, oracle_add). Prints the table + summary;
    returns {"n", "ours_hits", "oracle_hits", "ours_mean_add_mm",
    "oracle_mean_add_mm"}."""
    n = len(rows)
    ours_hits = sum(1 for _, a, _o in rows if np.isfinite(a) and a < thr)
    orc_hits = sum(1 for _, _a, o in rows if np.isfinite(o) and o < thr)
    for label, a, o in rows if per_scene else ():
        print(f"{label}: ours ADD {a*1e3:7.2f} mm | oracle ADD {o*1e3:7.2f} mm",
              flush=True)
    ours_adds = [a for _, a, _ in rows if np.isfinite(a)]
    orc_adds = [o for _, _, o in rows if np.isfinite(o)]
    print(f"\n[{config}] ADD-0.1d threshold {thr*1e3:.1f} mm")
    print(f"[{config}] ours:   {len(ours_adds)}/{n} detected, mean ADD "
          f"{np.mean(ours_adds)*1e3:.2f} mm, ADD-0.1d {100.0*ours_hits/n:.1f}%")
    print(f"[{config}] oracle: {len(orc_adds)}/{n} detected, mean ADD "
          f"{np.mean(orc_adds)*1e3:.2f} mm, ADD-0.1d {100.0*orc_hits/n:.1f}%")
    print(f"[{config}] ADD-0.1d gap: {abs(ours_hits - orc_hits) * 100.0 / n:.1f}% "
          f"(north star: <= 0.5%)")
    return {"n": n, "ours_hits": ours_hits, "oracle_hits": orc_hits,
            "ours_mean_add_mm": float(np.mean(ours_adds) * 1e3),
            "oracle_mean_add_mm": float(np.mean(orc_adds) * 1e3)}


def run_ours(config, use_host=False, promoted=None, n_scenes=None,
             per_scene=True):
    """Our side of one config; returns _report's summary. ``n_scenes``
    runs only the first scenes of a base/occl set."""
    g = np.load(golden_path(config))

    if config in ("base", "occl"):
        model_pts = g["model"][:, :3]
        thr = 0.1 * float(g["diameter"])
        K, dep, gray, mask, scene_list = scene_set(occlude=(config == "occl"))
        scene_list = scene_list[:n_scenes]
        pd = _our_detector(promoted)
        bgr = np.repeat(gray[..., None], 3, axis=2)
        assert pd.add_view("obj", dep, K, mask.astype(np.uint8) * 255,
                           rgb=bgr) == 0
        mthr = OCCL_THRESHOLD if config == "occl" else MATCH_THRESHOLD
        rows = []
        for i, (gt, d2, g2, m2) in enumerate(scene_list):
            detect = pd.detect if use_host else pd.detect_fused
            poses = detect(d2, K, rgb=np.repeat(g2[..., None], 3, axis=2),
                           match_threshold=mthr)
            ours = (add_metric(np.asarray(poses[0].pose), gt, model_pts)
                    if poses else np.nan)
            orc = (add_metric(g["est_poses"][i], gt, model_pts)
                   if g["est_found"][i] else np.nan)
            rows.append((f"scene {i:2d}", ours, orc))
        return _report(config, rows, thr, per_scene)

    elif config == "two":
        K, train, scene_list = scene_set_two()
        pd = _our_detector(promoted)
        for cid in ("objA", "objB"):
            dep, gray, mask = train[cid]
            assert pd.add_view(cid, dep, K, mask.astype(np.uint8) * 255,
                               rgb=np.repeat(gray[..., None], 3, axis=2)) == 0
        models = {"objA": g["modelA"][:, :3], "objB": g["modelB"][:, :3]}
        thr = {"objA": 0.1 * float(g["diameterA"]),
               "objB": 0.1 * float(g["diameterB"])}
        rows = []
        for i, ((gtA, gtB), d2, g2, m2) in enumerate(scene_list):
            detect = pd.detect if use_host else pd.detect_fused
            poses = detect(d2, K, rgb=np.repeat(g2[..., None], 3, axis=2))
            for j, (cid, gt) in enumerate((("objA", gtA), ("objB", gtB))):
                best = next((p for p in poses if p.class_id == cid), None)
                ours = (add_metric(np.asarray(best.pose), gt, models[cid])
                        if best is not None else np.nan)
                orc = (add_metric(g["est_poses"][i, j], gt, models[cid])
                       if g["est_found"][i, j] else np.nan)
                rows.append((f"scene {i:2d} {cid}", ours, orc))
        # per-class thresholds differ by <2 mm; report with the tighter
        return _report(config, rows, min(thr.values()), per_scene)

    elif config == "views":
        model_pts = g["model"][:, :3]
        thr = 0.1 * float(g["diameter"])
        K, dep, gray, mask, train, scene_list = scene_set_views()
        pd = _our_detector(promoted)
        for k, (P, d2, g2, m2) in enumerate(train):
            assert pd.add_view("obj", d2, K, m2.astype(np.uint8) * 255,
                               rgb=np.repeat(g2[..., None], 3, axis=2),
                               view_pose=P) == k
        rows = []
        for i, (gt, d2, g2, m2) in enumerate(scene_list):
            detect = pd.detect if use_host else pd.detect_fused
            poses = detect(d2, K, rgb=np.repeat(g2[..., None], 3, axis=2))
            ours = (add_metric(np.asarray(poses[0].pose), gt, model_pts)
                    if poses else np.nan)
            orc = (add_metric(g["est_poses"][i], gt, model_pts)
                   if g["est_found"][i] else np.nan)
            rows.append((f"yaw {TEST_DEGS[i]:+5.1f}", ours, orc))
        return _report(config, rows, thr, per_scene)
    else:
        raise SystemExit(f"unknown config {config}")


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "ours"
    config = sys.argv[2] if len(sys.argv) > 2 else "base"
    configs = ("base", "occl", "two", "views") if config == "all" else (config,)
    for cfg in configs:
        if mode == "oracle":
            run_oracle(cfg)
        elif mode == "ours":
            run_ours(cfg)
        elif mode == "ours-host":
            run_ours(cfg, use_host=True)
        else:
            raise SystemExit(f"unknown mode {mode}")
