"""End-to-end 6D detection pipeline (reference L6 glue).

``PoseDetector`` composes the full reference pipeline (BASELINE.json
north_star; SURVEY.md section 3.1):

    detect(depth, K[, rgb]) ->
      rescale -> backproject -> FALS normals          (geom, jit)
      -> LINEMOD match over the template bank         (fused program)
      -> hypothesis lift (template view pose + match x,y + scene depth
         -> initial SE(3))
      -> batched point-to-plane ICP over all hypotheses (one vmapped jit)
      -> scoring + pose clustering NMS
      -> [Pose]

Training (``add_view``) registers a view: LINEMOD templates via
Detector.add_template plus the view's masked object cloud (sampled to a
fixed size) as the ICP model, and optionally the ground-truth view pose
(model -> training camera). With view poses the returned detections are
model -> scene-camera transforms; without, they map the training-view
camera frame onto the scene.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from object_detector_6d_tpu.api.detector import Detector, Match
from object_detector_6d_tpu.core.config import DetectParams, ICPParams
from object_detector_6d_tpu.core.intrinsics import Intrinsics
from object_detector_6d_tpu.core.se3 import SE3
from object_detector_6d_tpu.geom.backproject import depth_to_3d
from object_detector_6d_tpu.geom.normals import normals_fals
from object_detector_6d_tpu.refine.icp import ICP
from object_detector_6d_tpu.refine.pose import Pose, cluster_poses


@dataclasses.dataclass
class _ViewRecord:
    """Per-template training-view metadata for hypothesis lifting."""

    model_cloud: np.ndarray  # [N, 6] xyz+normal, training camera frame
    bbox: Tuple[int, int, int, int]  # (x, y, w, h) at level 0
    anchor_point: np.ndarray  # 3D point of the bbox center at model depth
    view_pose: Optional[np.ndarray]  # model -> training camera, or None


import functools


@functools.lru_cache(maxsize=4)
def _geometry_single(k_bytes: bytes, shape):
    """Jitted cloud+normals program for one frame (device-resident out)."""
    from object_detector_6d_tpu.geom.normals import FalsNormals

    K = np.frombuffer(k_bytes, np.float64).reshape(3, 3)
    est = FalsNormals(shape[0], shape[1], K)
    Kj = jnp.asarray(K)

    import jax

    @jax.jit
    def run(depth):
        cloud = depth_to_3d(depth, Kj)
        return jnp.concatenate([cloud, est(cloud)], -1)

    return run


@functools.lru_cache(maxsize=4)
def _window_quantiles_fn(win: int, shape):
    """NaN-aware depth quantiles (q25/q50/q75) of fixed windows around
    given centers, restricted to the match bbox (device). Multiple depth
    seeds make the hypothesis lift robust to occluders inside the match
    window (config 3); the bbox restriction keeps the quantiles on the
    object for objects much smaller than the window (otherwise every
    seed lifts onto background depth)."""
    import jax

    H, W = shape
    qs = jnp.asarray([0.25, 0.5, 0.75])

    @jax.jit
    def run(z_img, centers, bboxes_wh):
        def one(c, wh):
            x0 = jnp.clip(c[0] - win // 2, 0, W - win)
            y0 = jnp.clip(c[1] - win // 2, 0, H - win)
            w = jax.lax.dynamic_slice(z_img, (y0, x0), (win, win))
            xs_g = x0 + jnp.arange(win)
            ys_g = y0 + jnp.arange(win)
            inx = (xs_g >= c[0] - wh[0] // 2 - 1) & (xs_g <= c[0] + wh[0] // 2 + 1)
            iny = (ys_g >= c[1] - wh[1] // 2 - 1) & (ys_g <= c[1] + wh[1] // 2 + 1)
            w = jnp.where(iny[:, None] & inx[None, :], w, jnp.nan)
            return jnp.nanquantile(w, qs)

        return jax.vmap(one)(centers, bboxes_wh)

    return run


class PoseDetector:
    """Template-based 6D object detector (mirrors the reference API)."""

    def __init__(
        self,
        detector: Optional[Detector] = None,
        params: Optional[DetectParams] = None,
        model_points: int = 1024,
        scene_window: int = 160,
        scene_points_stride: int = 2,
        mesh=None,
        lift_impl: str = "hist",
    ):
        """``mesh``: optional 2D (data, model) jax Mesh
        (parallel/sharding.make_mesh). When set, detect_fused_batch
        shards the WHOLE fused program across it — frames over ``data``,
        template bank + ICP hypothesis lanes over ``model`` — for frame
        batches divisible by the data axis (other calls fall back to
        single-device)."""
        self.detector = detector or Detector()
        self.params = params or DetectParams()
        self.model_points = model_points
        self.scene_window = scene_window
        self.scene_stride = scene_points_stride
        self.mesh = mesh
        self.lift_impl = lift_impl
        self.views: Dict[Tuple[str, int], _ViewRecord] = {}
        from object_detector_6d_tpu.utils.metrics import PipelineCounters

        self.counters = PipelineCounters()

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def add_view(
        self,
        class_id: str,
        depth_u16: np.ndarray,
        K: np.ndarray,
        object_mask: np.ndarray,
        rgb: Optional[np.ndarray] = None,
        view_pose: Optional[np.ndarray] = None,
    ) -> int:
        """Register one training view; returns template id or -1."""
        sources = self._sources(rgb, depth_u16)
        tid, bbox = self.detector.add_template(sources, class_id, object_mask)
        if tid < 0:
            return -1
        cloud = np.asarray(depth_to_3d(depth_u16, K))
        normals = np.asarray(normals_fals(cloud, K))
        mask = (np.asarray(object_mask) > 0) & np.isfinite(cloud).all(-1) & np.isfinite(normals).all(-1)
        ys, xs = np.nonzero(mask)
        if len(ys) == 0:
            return -1
        sel = np.linspace(0, len(ys) - 1, min(self.model_points, len(ys))).astype(int)
        pts = cloud[ys[sel], xs[sel]]
        nrm = normals[ys[sel], xs[sel]]
        model = np.concatenate([pts, nrm], -1).astype(np.float32)
        # pad to fixed size with NaN (excluded by the ICP sample mask —
        # finite padding would let duplicate rows bias the normal equations)
        if len(model) < self.model_points:
            pad = np.full((self.model_points - len(model), 6), np.nan, np.float32)
            model = np.concatenate([model, pad], 0)
        bx, by, bw, bh = bbox
        z = float(np.nanmedian(pts[:, 2]))
        intr = Intrinsics.from_matrix(np.asarray(K))
        anchor = np.asarray(intr.reproject(bx + bw / 2.0, by + bh / 2.0, z))
        self.views[(class_id, tid)] = _ViewRecord(
            model, bbox, anchor.astype(np.float32),
            None if view_pose is None else np.asarray(view_pose, np.float32),
        )
        return tid

    def _sources(self, rgb, depth):
        sources = []
        for name in self.detector.modality_names:
            if name == "ColorGradient":
                if rgb is None:
                    raise ValueError("detector has a ColorGradient modality; rgb required")
                sources.append(rgb)
            else:
                sources.append(depth)
        return sources

    # ------------------------------------------------------------------
    # detection
    # ------------------------------------------------------------------

    def detect_fused(
        self,
        depth_u16: np.ndarray,
        K: np.ndarray,
        rgb: Optional[np.ndarray] = None,
        class_ids: Optional[Sequence[str]] = None,
        match_threshold: Optional[float] = None,
    ) -> List[Pose]:
        """Single-device-call detect(): one fused program runs match ->
        lift -> projective ICP (api/detect_program.py); only [K]-sized
        result arrays cross the host boundary. Falls back to the
        host-orchestrated ``detect`` on coarse-candidate overflow."""
        out = self.detect_fused_batch(
            np.asarray(depth_u16)[None], K,
            None if rgb is None else np.asarray(rgb)[None],
            class_ids, match_threshold,
        )
        return out[0]

    def detect_fused_batch(
        self,
        depths: np.ndarray,  # [B, H, W] u16
        K: np.ndarray,
        rgbs: Optional[np.ndarray] = None,  # [B, H, W, 3] u8
        class_ids: Optional[Sequence[str]] = None,
        match_threshold: Optional[float] = None,
    ) -> List[List[Pose]]:
        """Batched fused detect over B frames sharing one camera: a single
        device call matches and refines every frame's hypotheses."""
        return self.detect_fused_finalize(
            self.detect_fused_dispatch(depths, K, rgbs, class_ids,
                                       match_threshold)
        )

    def detect_fused_dispatch(
        self,
        depths: np.ndarray,  # [B, H, W] u16
        K: np.ndarray,
        rgbs: Optional[np.ndarray] = None,  # [B, H, W, 3] u8
        class_ids: Optional[Sequence[str]] = None,
        match_threshold: Optional[float] = None,
    ):
        """Dispatch the fused device program WITHOUT blocking on results.

        Returns an opaque handle for :meth:`detect_fused_finalize`. JAX
        dispatch is asynchronous, so a caller that dispatches batch
        ``i+1`` before finalizing batch ``i`` overlaps device execution
        and the result transfer with the previous batch's host work — the
        streaming deployment shape (api/streaming.py) and the bench's
        pipelined throughput mode."""
        from object_detector_6d_tpu.api import detect_program as dp
        from object_detector_6d_tpu.utils.metrics import validate_frame

        # keep device arrays device-resident: np.asarray on a jnp input
        # would download AND re-upload the whole batch every call
        if isinstance(depths, np.ndarray) or not hasattr(depths, "devices"):
            depths = np.asarray(depths)
            validate_frame(depths[0], K, None if rgbs is None else np.asarray(rgbs)[0])
        B = depths.shape[0]
        p = self.params
        threshold = p.match_threshold if match_threshold is None else match_threshold
        # mesh path: shard when the batch divides the data axis
        mesh = self.mesh
        if mesh is not None and (B == 1 or B % mesh.shape["data"]):
            mesh = None
        tp = mesh.shape["model"] if mesh is not None else 1
        bank = self.detector.get_bank(class_ids, pad_to=tp)
        if bank is None:
            return ("empty", B)
        cache = self.detector._kernel_cache
        vkey = ("views", self.detector.bank_version, len(self.views),
                self.model_points, tp)
        views = cache.get(vkey)
        if views is None:
            views = dp.pack_views(bank, self.views, self.model_points)
            cache[vkey] = views
        H, W = depths.shape[1:3]
        kb = np.ascontiguousarray(np.asarray(K, np.float64)).tobytes()
        max_dr = ((bank.max_dr // 16) + 1) * 16
        K_cap = max(8, p.max_hypotheses)
        K_cap = -(-K_cap // max(tp, 1)) * max(tp, 1)  # divisible by tp
        fc = p.fine_compact
        if fc and tp > 1:
            fc = -(-fc // tp) * tp  # divisible by the model axis
        iw = p.icp_window
        if iw < 0:  # auto: largest template bbox + 64 px drift margin
            mb = int(np.max(bank.sizes[0])) if len(bank.sizes[0]) else 0
            iw = min(256, max(96, -(-(mb + 64) // 8) * 8))
            iw = min(iw, H, W)
        icp_key = (p.icp.iterations, p.icp.num_levels,
                   p.icp.solves_per_assoc, p.icp.finest_assoc, iw,
                   p.num_seeds)
        pkey = ("detect_prog", (H, W), kb, K_cap, max_dr, B, mesh is not None,
                fc, self.lift_impl, icp_key)
        prog = cache.get(pkey)
        if prog is None:
            prog = dp.make_detect_program(
                self.detector.modality_names,
                self.detector.t_at_level,
                (H, W),
                self.detector.dn_params,
                self.detector.cg_params,
                np.asarray(K, np.float64),
                max_candidates=K_cap,
                max_dr=max_dr,
                icp=p.icp,
                lift_window=self.scene_window,
                batch=None if B == 1 else B,
                mesh=mesh,
                device_nms=True,
                fine_compact=fc,
                lift_impl=self.lift_impl,
                icp_window=iw,
                num_seeds=p.num_seeds,
            )
            cache[pkey] = prog
        sources_b = []
        for name in self.detector.modality_names:
            if name == "ColorGradient":
                if rgbs is None:
                    raise ValueError("ColorGradient modality requires rgb frames")
                sources_b.append(jnp.asarray(rgbs))
            else:
                sources_b.append(jnp.asarray(depths))
        if B == 1:
            sources_b = [s[0] for s in sources_b]
        # device-resident bank args, converted once per bank
        akey = ("bank_args", self.detector.bank_version, id(bank))
        bank_args = cache.get(akey)
        if bank_args is None:
            bank_args = (
                bank.kernels_low,
                (bank.feat_plane, bank.feat_dr, bank.feat_dc, bank.feat_n),
                jnp.asarray(bank.nfeat[0]),
                jnp.asarray(bank.nfeat[1]),
                jnp.asarray(bank.sizes[0]),
                jnp.asarray(bank.sizes[1]),
            )
            cache[akey] = bank_args
        # cached device scalar for the threshold (one host-to-device
        # copy per threshold instead of one per call)
        tkey = ("thr", float(threshold))
        thr_dev = cache.get(tkey)
        if thr_dev is None:
            thr_dev = jnp.float32(threshold)
            cache[tkey] = thr_dev
        nms_args = self._nms_device_args(bank, K)
        flat_dev = prog(sources_b, *bank_args, views, thr_dev, *nms_args)
        return (flat_dev, B, K_cap, bank, depths, rgbs, K, class_ids,
                match_threshold)

    def _nms_device_args(self, bank, K):
        """Cached device args for the on-device NMS stage: the template
        -> class-index table and the [max_residual, translation_thr]
        scalar pair (uploaded once, not per call)."""
        cache = self.detector._kernel_cache
        ckey = ("cls_of_tid", self.detector.bank_version, id(bank))
        cls_dev = cache.get(ckey)
        if cls_dev is None:
            index: Dict[str, int] = {}
            cls = np.empty(len(bank.class_ids), np.int32)
            for g, cid in enumerate(bank.class_ids):
                cls[g] = index.setdefault(cid, len(index))
            cls_dev = jnp.asarray(cls)
            cache[ckey] = cls_dev
        p = self.params
        fx = float(np.asarray(K)[0, 0])
        trans_thr = p.nms_radius_px / fx
        skey = ("nms_scalars", p.max_residual, trans_thr)
        sc_dev = cache.get(skey)
        if sc_dev is None:
            sc_dev = jnp.asarray([p.max_residual, trans_thr], jnp.float32)
            cache[skey] = sc_dev
        return cls_dev, sc_dev

    def detect_fused_dispatch_multi(
        self,
        depths_g,  # [G, B, H, W] u16
        K: np.ndarray,
        rgbs_g=None,  # [G, B, H, W, 3] u8
        class_ids: Optional[Sequence[str]] = None,
        match_threshold: Optional[float] = None,
    ):
        """Dispatch G frame batches as ONE device execution.

        A ``lax.scan`` over the G axis runs the fused detect program G
        times inside a single execution: one dispatch and one result
        transfer per G*B frames instead of per B. Batching latency grows
        accordingly: a throughput deployment shape, not a low-latency
        one. Finalize with :meth:`detect_fused_finalize_multi`."""
        from object_detector_6d_tpu.api import detect_program as dp

        G, B = depths_g.shape[:2]
        p = self.params
        threshold = (p.match_threshold if match_threshold is None
                     else match_threshold)
        bank = self.detector.get_bank(class_ids)
        if bank is None:
            return ("empty", G, B)
        cache = self.detector._kernel_cache
        vkey = ("views", self.detector.bank_version, len(self.views),
                self.model_points, 1)
        views = cache.get(vkey)
        if views is None:
            views = dp.pack_views(bank, self.views, self.model_points)
            cache[vkey] = views
        H, W = depths_g.shape[2:4]
        kb = np.ascontiguousarray(np.asarray(K, np.float64)).tobytes()
        max_dr = ((bank.max_dr // 16) + 1) * 16
        K_cap = max(8, p.max_hypotheses)
        iw = p.icp_window
        if iw < 0:  # auto: largest template bbox + 64 px drift margin
            mb = int(np.max(bank.sizes[0])) if len(bank.sizes[0]) else 0
            iw = min(256, max(96, -(-(mb + 64) // 8) * 8))
            iw = min(iw, H, W)
        icp_key = (p.icp.iterations, p.icp.num_levels,
                   p.icp.solves_per_assoc, p.icp.finest_assoc, iw,
                   p.num_seeds)
        pkey = ("detect_prog", (H, W), kb, K_cap, max_dr, B, False,
                p.fine_compact, self.lift_impl, icp_key)
        prog = cache.get(pkey)
        if prog is None:
            prog = dp.make_detect_program(
                self.detector.modality_names, self.detector.t_at_level,
                (H, W), self.detector.dn_params, self.detector.cg_params,
                np.asarray(K, np.float64), max_candidates=K_cap,
                max_dr=max_dr, icp=p.icp,
                lift_window=self.scene_window, batch=B, device_nms=True,
                fine_compact=p.fine_compact, lift_impl=self.lift_impl,
                icp_window=iw, num_seeds=p.num_seeds,
            )
            cache[pkey] = prog
        mkey = ("detect_prog_multi", pkey, G)
        mprog = cache.get(mkey)
        if mprog is None:
            import jax

            @jax.jit
            def mprog(sources_g, *rest):
                def body(_, src):
                    return None, prog(src, *rest)
                _, flats = jax.lax.scan(body, None, sources_g)
                return flats

            cache[mkey] = mprog
        sources_g = []
        for name in self.detector.modality_names:
            if name == "ColorGradient":
                if rgbs_g is None:
                    raise ValueError("ColorGradient modality requires rgb")
                sources_g.append(jnp.asarray(rgbs_g))
            else:
                sources_g.append(jnp.asarray(depths_g))
        akey = ("bank_args", self.detector.bank_version, id(bank))
        bank_args = cache.get(akey)
        if bank_args is None:
            bank_args = (
                bank.kernels_low,
                (bank.feat_plane, bank.feat_dr, bank.feat_dc, bank.feat_n),
                jnp.asarray(bank.nfeat[0]), jnp.asarray(bank.nfeat[1]),
                jnp.asarray(bank.sizes[0]), jnp.asarray(bank.sizes[1]),
            )
            cache[akey] = bank_args
        tkey = ("thr", float(threshold))
        thr_dev = cache.get(tkey)
        if thr_dev is None:
            thr_dev = jnp.float32(threshold)
            cache[tkey] = thr_dev
        nms_args = self._nms_device_args(bank, K)
        flats = mprog(sources_g, *bank_args, views, thr_dev,
                      *nms_args)  # [G, B, F]
        return ("multi", flats, G, B, K_cap, bank, depths_g, rgbs_g, K,
                class_ids, match_threshold)

    def detect_fused_finalize_multi(self, handle) -> List[List[List[Pose]]]:
        """One transfer + host post-processing for a multi-dispatch."""
        if handle[0] == "empty":
            return [[[] for _ in range(handle[2])] for _ in range(handle[1])]
        (_tag, flats, G, B, K_cap, bank, depths_g, rgbs_g, K, class_ids,
         match_threshold) = handle
        big = np.asarray(flats)
        out = []
        for g in range(G):
            sub = (None, B, K_cap, bank,
                   None if depths_g is None else depths_g[g],
                   None if rgbs_g is None else rgbs_g[g],
                   K, class_ids, match_threshold)
            out.append(self._finalize_host(big[g], sub))
        return out

    def detect_fused_finalize(self, handle) -> List[List[Pose]]:
        """Block on a :meth:`detect_fused_dispatch` handle and run the
        host-side post-processing (unpack, scoring, cluster NMS)."""
        if isinstance(handle[0], str):  # "empty": no templates registered
            return [[] for _ in range(handle[1])]
        return self._finalize_host(np.asarray(handle[0]), handle)

    def detect_fused_finalize_many(self, handles) -> List[List[List[Pose]]]:
        """Finalize several same-shape dispatch handles with ONE device
        transfer (a throughput consumer that retrieves results in groups
        pays one transfer per group instead of one per batch). Returns
        one result list per handle, in order."""
        import jax.numpy as _jnp

        real = [(i, h) for i, h in enumerate(handles)
                if not isinstance(h[0], str)]
        out: List = [None] * len(handles)
        for i, h in enumerate(handles):
            if isinstance(h[0], str):
                out[i] = [[] for _ in range(h[1])]
        if real:
            stacked = np.asarray(_jnp.stack([h[0] for _, h in real]))
            for (i, h), flat in zip(real, stacked):
                out[i] = self._finalize_host(flat, h)
        return out

    def _finalize_host(self, flat: np.ndarray, handle) -> List[List[Pose]]:
        """Unpack one transferred device-NMS result block.

        Scoring + cluster NMS already ran ON DEVICE (detect_program.py
        make_cluster_stage, same semantics as refine/pose.cluster_poses
        + mean_pose); the host only builds Pose objects for the few
        valid cluster slots — the per-frame Python NMS loop this
        replaces was the pipelined fused path's throughput bottleneck
        on a 1-core host."""
        from object_detector_6d_tpu.api import detect_program as dp

        (_flat_dev, B, K_cap, bank, depths, rgbs, K, class_ids,
         match_threshold) = handle
        slots, n_raw, n_pass = dp.unflatten_cluster_outputs(
            flat.reshape(B, -1), K_cap
        )
        results: List[List[Pose]] = []
        for b in range(B):
            if int(n_raw[b]) > K_cap:
                # coarse-candidate overflow: host path preserves parity
                self.counters.inc("overflow_fallback")
                results.append(
                    self.detect(
                        depths[b], K, None if rgbs is None else rgbs[b],
                        class_ids, match_threshold,
                    )
                )
                continue
            self.counters.inc("frames")
            self.counters.inc("matches", int(n_pass[b]))
            out: List[Pose] = []
            for k in range(K_cap):
                s = slots[b, k]
                if s[0] <= 0:
                    break  # valid clusters sort first (vote-key order)
                tid = int(s[3])
                out.append(
                    Pose(
                        pose=np.asarray(s[8:24], np.float64).reshape(4, 4),
                        residual=float(s[6]),
                        num_votes=int(round(s[1])),
                        class_id=bank.class_ids[tid],
                        template_id=int(bank.local_tids[tid]),
                        match_x=int(s[4]),
                        match_y=int(s[5]),
                        match_similarity=float(s[2]),
                    )
                )
                self.counters.observe("icp_residual", float(s[6]))
            self.counters.inc("detections", len(out))
            results.append(out)
        return results

    def detect(
        self,
        depth_u16: np.ndarray,
        K: np.ndarray,
        rgb: Optional[np.ndarray] = None,
        class_ids: Optional[Sequence[str]] = None,
        match_threshold: Optional[float] = None,
    ) -> List[Pose]:
        """Full pipeline: match -> lift -> batched ICP -> score -> NMS."""
        from object_detector_6d_tpu.utils.metrics import validate_frame

        validate_frame(depth_u16, K, rgb)
        p = self.params
        threshold = p.match_threshold if match_threshold is None else match_threshold
        sources = self._sources(rgb, depth_u16)
        matches = self.detector.match(sources, threshold, class_ids)
        self.counters.inc("frames")
        self.counters.inc("matches", len(matches))
        matches = matches[: p.max_hypotheses]
        for m in matches:
            self.counters.observe("match_similarity", m.similarity)
        if not matches:
            return []

        # device-resident geometry: only tiny scalars go to the host
        kb = np.ascontiguousarray(np.asarray(K, np.float64)).tobytes()
        H, W = np.asarray(depth_u16).shape
        scene6 = _geometry_single(kb, (H, W))(jnp.asarray(depth_u16))
        intr = Intrinsics.from_matrix(np.asarray(K))

        # --- lift hypotheses (window depth medians computed on device) ---
        pre = []
        centers = []
        whs = []
        for m in matches:
            rec = self.views.get((m.class_id, m.template_id))
            if rec is None:
                continue
            bw, bh = rec.bbox[2], rec.bbox[3]
            pre.append((m, rec))
            centers.append((int(m.x + bw // 2), int(m.y + bh // 2)))
            whs.append((bw, bh))
        if not pre:
            return []
        q_fn = _window_quantiles_fn(self.scene_window, (H, W))
        zqs = np.asarray(
            q_fn(scene6[..., 2], jnp.asarray(np.asarray(centers, np.int32)),
                 jnp.asarray(np.asarray(whs, np.int32)))
        )
        # multi-depth lift: one hypothesis per distinct depth quantile
        # (occluders in the window skew any single statistic — config 3)
        hyps: List[Tuple[Match, _ViewRecord, np.ndarray, int]] = []
        for mi, ((m, rec), zq) in enumerate(zip(pre, zqs)):
            zs = [float(z) for z in zq if np.isfinite(z)]
            zs_u = []
            for z in zs:
                if all(abs(z - z2) > 0.015 for z2 in zs_u):
                    zs_u.append(z)
            bw, bh = rec.bbox[2], rec.bbox[3]
            for z in zs_u:
                target = np.asarray(
                    intr.reproject(m.x + bw / 2.0, m.y + bh / 2.0, z)
                )
                pose0 = np.eye(4, dtype=np.float32)
                pose0[:3, 3] = target - rec.anchor_point
                hyps.append((m, rec, pose0, mi))
        if not hyps:
            return []

        # --- batched ICP (model clouds stacked; scene stays on device) ---
        models = np.stack([h[1].model_cloud for h in hyps])
        poses0 = np.stack([h[2] for h in hyps])
        scene_sub = scene6[:: self.scene_stride, :: self.scene_stride].reshape(-1, 6)
        icp = ICP.from_params(p.icp)
        residuals, poses = _batched_icp(icp, models, scene_sub, poses0)

        # keep the best-residual hypothesis per match
        best_by_match: Dict[int, int] = {}
        for i, h in enumerate(hyps):
            mi = h[3]
            if mi not in best_by_match or residuals[i] < residuals[best_by_match[mi]]:
                best_by_match[mi] = i
        keep_idx = sorted(best_by_match.values())
        hyps = [hyps[i] for i in keep_idx]
        residuals = residuals[keep_idx]
        poses = poses[keep_idx]

        # --- score + NMS ---
        out: List[Pose] = []
        for i, (m, rec, _p0, _mi) in enumerate(hyps):
            pose = poses[i]
            if rec.view_pose is not None:
                pose = pose @ rec.view_pose
            out.append(
                Pose(
                    pose=np.asarray(pose, np.float64),
                    residual=float(residuals[i]),
                    num_votes=int(round(m.similarity * 100)),
                    class_id=m.class_id,
                    template_id=m.template_id,
                    match_x=m.x,
                    match_y=m.y,
                    match_similarity=m.similarity,
                )
            )
        for r in residuals:
            self.counters.observe("icp_residual", float(r))
        # post-ICP hypothesis scoring (see DetectParams.max_residual)
        out = [q for q in out if q.residual <= p.max_residual]
        clusters = cluster_poses(
            out,
            translation_threshold=p.nms_radius_px / float(intr.fx) * 1.0,
        )
        self.counters.inc("detections", len(clusters))
        return [c.mean_pose() for c in clusters]


def _batched_icp(icp: ICP, models: np.ndarray, scene: np.ndarray, poses0: np.ndarray):
    """Run ICP per hypothesis with its own model cloud (vmapped inside)."""
    # models share a fixed size; run each hypothesis against its model by
    # treating (model, pose) pairs as the batch.
    import jax

    from object_detector_6d_tpu.refine.icp import _icp_run

    residuals = []
    out_poses = []
    # group identical models to share NN structures where possible
    B = models.shape[0]
    res, ps = _icp_run_multi(
        jnp.asarray(models), jnp.asarray(scene), jnp.asarray(poses0),
        icp.iterations, jnp.float32(icp.tolerance),
        jnp.float32(icp.rejection_scale), icp.num_levels,
    )
    return np.asarray(res), np.asarray(ps)


import functools

import jax


@functools.partial(jax.jit, static_argnames=("iterations", "num_levels"))
def _icp_run_multi(models, scene_pc, poses, iterations, tolerance, rejection_scale, num_levels):
    """ICP where each hypothesis has its own model cloud [B, N, 6]."""
    from object_detector_6d_tpu.refine.icp import _p2pl_step

    scene_pts = scene_pc[:, :3]
    scene_nrm = scene_pc[:, 3:6]
    scene_valid = jnp.isfinite(scene_pts).all(-1) & jnp.isfinite(scene_nrm).all(-1)
    scene_pts = jnp.nan_to_num(scene_pts)
    scene_nrm = jnp.nan_to_num(scene_nrm)
    N = models.shape[1]

    def refine_one(model_pc, pose0):
        pose = pose0
        residual = jnp.float32(0.0)
        for level in range(num_levels - 1, -1, -1):
            stride = 1 << level
            n_lvl = max(1, N // stride)
            sample = model_pc[::stride][:n_lvl]
            mask = jnp.isfinite(sample[:, :3]).all(-1)
            sample = jnp.nan_to_num(sample)
            iters = max(1, iterations // num_levels)

            cap = jnp.float32(0.015) * (1 << level)

            def body(carry):
                i, pose, _res, _upd = carry
                new_pose, upd, res = _p2pl_step(
                    pose, sample, scene_pts, scene_nrm, scene_valid, mask,
                    rejection_scale, max_corr_dist=cap,
                )
                return i + 1, new_pose, res, upd

            def cond(carry):
                i, _pose, _res, upd = carry
                return (i < iters) & (upd >= tolerance)

            _, pose, residual, _ = jax.lax.while_loop(
                cond, body, (0, pose, residual, jnp.float32(1e9))
            )
        return residual, pose

    return jax.vmap(refine_one)(models, poses)
