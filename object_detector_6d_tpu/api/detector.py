"""LINEMOD Detector: the reference's public matching API, on device.

Mirrors linemod::Detector (linemod.hpp:294-413): ``add_template`` /
``add_synthetic_template`` build per-class template pyramids (host-side,
training time); ``match`` runs the per-frame hot path — quantize ->
spread -> response maps -> batched conv sweep at the coarsest pyramid
level -> local 16x16 refinement at finer levels -> threshold, sort, dedup
(match semantics follow linemod.cpp matchClass: anchor offset
T/2 + (T%2-1), candidate x2+1 upsampling with an 8T border clamp,
score = 100 * raw / (4 * num_features), strict > threshold at the coarse
level, >= threshold after refinement).

Templates are stored interleaved per level ([mod0 L0, mod1 L0, mod0 L1,
mod1 L1]), the oracle's TemplatePyramid layout (linemod.hpp:374-375).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from object_detector_6d_tpu.core.config import (
    ColorGradientParams,
    DepthNormalParams,
    DetectorParams,
)
from object_detector_6d_tpu.match.response import response_maps, spread
from object_detector_6d_tpu.match.sweep import (
    conv_sweep,
    local_scores,
    pack_kernels,
    span_mask,
)
from object_detector_6d_tpu.quant.features import Template, crop_templates
from object_detector_6d_tpu.quant.pyramid import (
    ColorGradientPyramid,
    DepthNormalPyramid,
)


@dataclasses.dataclass
class Match:
    """One detection (linemod.hpp:259-287)."""

    x: int
    y: int
    similarity: float
    class_id: str
    template_id: int

    def sort_key(self):
        # similarity desc, then template_id asc (Match::operator<)
        return (-self.similarity, self.template_id)


def _offset(t: int) -> int:
    return t // 2 + (t % 2 - 1)


class Detector:
    """LINEMOD detector (getDefaultLINEMOD-compatible defaults)."""

    def __init__(
        self,
        modalities: Sequence[str] = ("ColorGradient", "DepthNormal"),
        t_at_level: Sequence[int] = (5, 8),
        color_gradient_params: Optional[ColorGradientParams] = None,
        depth_normal_params: Optional[DepthNormalParams] = None,
    ):
        self.modality_names = tuple(modalities)
        self.t_at_level = tuple(t_at_level)
        self.cg_params = color_gradient_params or ColorGradientParams()
        self.dn_params = depth_normal_params or DepthNormalParams()
        # class_id -> list of template pyramids (interleaved level-major)
        self.class_templates: Dict[str, List[List[Template]]] = {}
        self._kernel_cache: Dict[Tuple[str, int, int], tuple] = {}
        self.bank_version = 0  # bumped by _store; cache-key salt

    # ------------------------------------------------------------------
    # training side
    # ------------------------------------------------------------------

    @property
    def pyramid_levels(self) -> int:
        return len(self.t_at_level)

    def num_templates(self, class_id: Optional[str] = None) -> int:
        if class_id is not None:
            return len(self.class_templates.get(class_id, []))
        return sum(len(v) for v in self.class_templates.values())

    def class_ids(self) -> List[str]:
        return list(self.class_templates.keys())

    def num_classes(self) -> int:
        """linemod.hpp:387 numClasses."""
        return len(self.class_templates)

    def get_templates(self, class_id: str, template_id: int) -> List[Template]:
        """The stored template pyramid, interleaved level-major exactly
        like the oracle's getTemplates (linemod.hpp:389:
        (Mod0 L0, Mod1 L0, Mod0 L1, Mod1 L1) for two modalities)."""
        return self.class_templates[class_id][template_id]

    def _build_pyramids(self, sources, mask=None):
        pyrs = []
        for name, src in zip(self.modality_names, sources):
            if name == "ColorGradient":
                pyrs.append(
                    ColorGradientPyramid(
                        src, self.cg_params, self.pyramid_levels, mask
                    )
                )
            elif name == "DepthNormal":
                pyrs.append(
                    DepthNormalPyramid(
                        src, self.dn_params, self.pyramid_levels, mask
                    )
                )
            else:
                raise ValueError(f"unknown modality {name}")
        return pyrs

    def add_template(
        self, sources: Sequence[np.ndarray], class_id: str, object_mask: np.ndarray
    ) -> Tuple[int, Optional[Tuple[int, int, int, int]]]:
        """Returns (template_id, bbox) or (-1, None) on failure."""
        pyrs = self._build_pyramids(sources, object_mask)
        tp: List[Template] = []
        for lvl in range(self.pyramid_levels):
            for p in pyrs:
                t = p.extract_template(lvl)
                if t is None:
                    return -1, None
                tp.append(t)
        bbox = crop_templates(tp)
        tid = self._store(tp, class_id)
        return tid, bbox

    def add_synthetic_template(
        self, templates: Sequence[Template], class_id: str
    ) -> int:
        """Register externally built (e.g. CAD-rendered) templates
        (linemod.hpp:351). Features must already be bbox-relative."""
        return self._store(list(templates), class_id)

    def _store(self, tp: List[Template], class_id: str) -> int:
        lst = self.class_templates.setdefault(class_id, [])
        lst.append(tp)
        self.bank_version += 1
        self._kernel_cache = {
            k: v
            for k, v in self._kernel_cache.items()
            if k[0] not in (class_id, "bank")
        }
        return len(lst) - 1

    # ------------------------------------------------------------------
    # persistence (linemod.hpp:391-393; oracle-compatible yml.gz)
    # ------------------------------------------------------------------

    def write_classes(self, path_format: str = "templates_%s.yml.gz",
                      class_ids: Optional[Sequence[str]] = None) -> None:
        from object_detector_6d_tpu.io import yaml_store

        for cid in class_ids or self.class_ids():
            yaml_store.write_class(
                path_format % cid,
                cid,
                self.modality_names,
                self.pyramid_levels,
                self.class_templates.get(cid, []),
            )

    def read_classes(self, class_ids: Sequence[str],
                     path_format: str = "templates_%s.yml.gz") -> None:
        from object_detector_6d_tpu.io import yaml_store

        for cid in class_ids:
            path = path_format % cid
            if path.endswith(".npz"):
                result = yaml_store.load_npz(path)
            else:
                from object_detector_6d_tpu.io import native

                result = native.read_class_native(path)
                if result is None:  # no toolchain: pure-Python fallback
                    result = yaml_store.read_class(path)
            read_cid, mods, levels, tps = result
            if list(mods) != list(self.modality_names) or levels != self.pyramid_levels:
                raise ValueError(
                    f"store {path} was built for modalities={mods}, "
                    f"levels={levels}; detector has {self.modality_names}, "
                    f"{self.pyramid_levels}"
                )
            for tp in tps:
                self._store(tp, read_cid)

    def write(self, path: str) -> None:
        """Detector parameter document (oracle Detector::write format)."""
        from object_detector_6d_tpu.io import yaml_store

        with open(path, "w") as f:
            f.write(yaml_store.emit_yaml(yaml_store.detector_doc(self)))

    @classmethod
    def read(cls, path: str) -> "Detector":
        from object_detector_6d_tpu.io import yaml_store

        with open(path) as f:
            doc = yaml_store.parse_yaml(f.read())
        names, t_at_level, cg, dn = yaml_store.parse_detector_doc(doc)
        return cls(names, t_at_level, cg, dn)

    # ------------------------------------------------------------------
    # matching side
    # ------------------------------------------------------------------

    def _kernels(self, class_id: str, level: int, modality: int):
        """Packed conv kernels for (class, level, modality), cached."""
        key = (class_id, level, modality)
        if key not in self._kernel_cache:
            tps = self.class_templates[class_id]
            num_mod = len(self.modality_names)
            tmpls = [tp[level * num_mod + modality] for tp in tps]
            # feature coords can reach width/height inclusive (crop bbox
            # is max-min, so the extreme feature sits at x == width)
            kh = max((t.height for t in tmpls), default=0) + 1
            kw = max((t.width for t in tmpls), default=0) + 1
            K, sizes = pack_kernels(tmpls, kh, kw)
            nfeat = np.array([len(t.features) for t in tmpls], np.int32)
            self._kernel_cache[key] = (jnp.asarray(K), sizes, nfeat)
        return self._kernel_cache[key]

    # largest fused candidate capacity before falling back to the host
    # path (far beyond any realistic threshold)
    MAX_FUSED_CANDIDATES = 1024

    def match(
        self,
        sources: Sequence[np.ndarray],
        threshold: float,
        class_ids: Optional[Sequence[str]] = None,
        fused: bool = True,
        max_candidates: int = 64,
    ) -> List[Match]:
        """Match all templates against the frame (linemod.hpp:330).

        ``fused=True`` (default) runs the whole hot path as one jitted
        XLA program (match/program.py) — same results, one device
        round-trip. When the coarse candidate count overflows
        ``max_candidates`` (low thresholds, config-4 style frames) the
        call re-runs a wider program from a power-of-two capacity
        ladder (compiled once per bucket, cached); only counts beyond
        MAX_FUSED_CANDIDATES fall back to the host-orchestrated path.
        """
        if fused and self.pyramid_levels == 2:
            K = max_candidates
            while K <= self.MAX_FUSED_CANDIDATES:
                result = self._match_fused(sources, threshold, class_ids, K)
                if isinstance(result, int):  # overflow: n_above returned
                    K = max(2 * K, 1 << (result - 1).bit_length())
                    continue
                return result
        return self._match_reference(sources, threshold, class_ids)

    def get_bank(self, class_ids: Optional[Sequence[str]] = None,
                 pad_to: int = 1):
        """Packed global template bank for the fused programs (cached;
        invalidated by add_template). None when no class has templates.
        ``pad_to``: round the bank up to a multiple (template-axis
        sharding)."""
        from object_detector_6d_tpu.match import program as mp

        key = tuple(sorted(class_ids)) if class_ids else None
        bank_key = ("bank", key, pad_to)
        bank = self._kernel_cache.get(bank_key)
        if bank is None:
            selected = {
                cid: tps
                for cid, tps in self.class_templates.items()
                if (key is None or cid in class_ids) and tps
            }
            if not selected:
                return None
            bank = mp.pack_bank(
                selected, len(self.modality_names), 2,
                t0=self.t_at_level[0], t1=self.t_at_level[1], pad_to=pad_to,
            )
            self._kernel_cache[bank_key] = bank
        return bank

    def _match_fused(self, sources, threshold, class_ids, max_candidates):
        from object_detector_6d_tpu.match import program as mp

        bank = self.get_bank(class_ids)
        if bank is None:
            return []
        shape = np.asarray(sources[0]).shape[:2]
        # quantize max_dr so program shapes don't churn as banks grow
        max_dr = ((bank.max_dr // 16) + 1) * 16
        prog_key = ("prog", shape, max_candidates, max_dr)
        prog = self._kernel_cache.get(prog_key)
        if prog is None:
            prog = mp.make_match_program(
                self.modality_names,
                self.t_at_level,
                shape,
                self.dn_params,
                self.cg_params,
                max_candidates,
                max_dr,
            )
            self._kernel_cache[prog_key] = prog
        srcs = [jnp.asarray(s) for s in sources]
        # device-resident bank args, converted once per bank
        akey = ("bank_args", self.bank_version, id(bank))
        bank_args = self._kernel_cache.get(akey)
        if bank_args is None:
            bank_args = (
                bank.kernels_low,
                (bank.feat_plane, bank.feat_dr, bank.feat_dc, bank.feat_n),
                jnp.asarray(bank.nfeat[0]),
                jnp.asarray(bank.nfeat[1]),
                jnp.asarray(bank.sizes[0]),
                jnp.asarray(bank.sizes[1]),
            )
            self._kernel_cache[akey] = bank_args
        packed = np.asarray(
            prog(srcs, *bank_args, jnp.float32(threshold))
        )
        n_above = int(packed[0, -1])
        if n_above > max_candidates:
            return n_above  # overflow: caller retries a wider bucket
        xs = packed[0, :-1].astype(np.int32)
        ys = packed[1, :-1].astype(np.int32)
        score = packed[2, :-1]
        tids = packed[3, :-1].astype(np.int32)
        keep = packed[4, :-1] > 0
        matches = [
            Match(
                int(xs[i]),
                int(ys[i]),
                float(score[i]),
                bank.class_ids[tids[i]],
                int(bank.local_tids[tids[i]]),
            )
            for i in range(len(keep))
            if keep[i]
        ]
        return self._sort_dedup(matches)

    def _match_reference(
        self,
        sources: Sequence[np.ndarray],
        threshold: float,
        class_ids: Optional[Sequence[str]] = None,
    ) -> List[Match]:
        pyrs = self._build_pyramids(sources)
        num_mod = len(self.modality_names)
        levels = self.pyramid_levels

        # Per level/modality: spread + response maps (device-resident).
        responses = []  # [level][modality] -> [8, H, W]
        sizes = []  # [level] -> (H, W)
        for lvl in range(levels):
            t = self.t_at_level[lvl]
            per_mod = []
            for p in pyrs:
                q = jnp.asarray(p.quantize(lvl))
                per_mod.append(response_maps(spread(q, t)))
            responses.append(per_mod)
            sizes.append(p.quantize(lvl).shape)

        matches: List[Match] = []
        ids = list(class_ids) if class_ids else self.class_ids()
        for cid in ids:
            if cid in self.class_templates and self.class_templates[cid]:
                matches.extend(
                    self._match_class(cid, responses, sizes, threshold)
                )

        return self._sort_dedup(matches)

    @staticmethod
    def _sort_dedup(matches: List[Match]) -> List[Match]:
        matches.sort(key=Match.sort_key)
        # unique over (x, y, similarity, class): set-based, keeping the
        # first occurrence. (The oracle sorts then drops adjacent
        # duplicates; with similarity ties across classes its unstable
        # sort groups equivalents — a set matches that behavior robustly.)
        out: List[Match] = []
        seen = set()
        for m in matches:
            key = (m.x, m.y, m.similarity, m.class_id)
            if key in seen:
                continue
            seen.add(key)
            out.append(m)
        return out

    def _match_class(self, class_id, responses, sizes, threshold) -> List[Match]:
        num_mod = len(self.modality_names)
        levels = self.pyramid_levels
        lowest = levels - 1
        t_low = self.t_at_level[lowest]
        H, W = sizes[lowest]
        gh, gw = H // t_low, W // t_low

        # --- coarse sweep over all templates at the lowest level ---
        total = None
        nfeat_total = None
        mask_all = None
        for mod in range(num_mod):
            K, tsize, nfeat = self._kernels(class_id, lowest, mod)
            scores = np.asarray(
                conv_sweep(responses[lowest][mod], K, t_low, gh, gw)
            )
            m = span_mask(tsize, t_low, H, W, gh, gw)
            total = scores if total is None else total + scores
            nfeat_total = nfeat if nfeat_total is None else nfeat_total + nfeat
            mask_all = m if mask_all is None else (mask_all & m)

        # Coarse candidate criterion (linemod.cpp matchClass): raw score
        # strictly above int(2nf + (threshold/100)*2nf + 0.5) — i.e. an
        # effective (50 + threshold/2)% cutoff at this level, NOT threshold%.
        nf2 = (2 * nfeat_total).astype(np.float32)
        raw_thr = (
            nf2 + np.float32(threshold) / np.float32(100.0) * nf2 + np.float32(0.5)
        ).astype(np.int32)
        raw = np.where(mask_all, total, 0)
        tid_idx, rr, cc = np.nonzero(raw > raw_thr[:, None, None])
        off = _offset(t_low)
        candidates = [
            Match(
                int(c) * t_low + off,
                int(r) * t_low + off,
                float(
                    np.float32(raw[t, r, c])
                    * np.float32(100.0)
                    / np.float32(4 * nfeat_total[t])
                ),
                class_id,
                int(t),
            )
            for t, r, c in zip(tid_idx, rr, cc)
        ]

        # --- local refinement up the pyramid ---
        for lvl in range(levels - 2, -1, -1):
            if not candidates:
                break
            t = self.t_at_level[lvl]
            H, W = sizes[lvl]
            border = 8 * t
            off = _offset(t)
            tps = self.class_templates[class_id]
            start = lvl * num_mod

            packed = [self._kernels(class_id, lvl, mod) for mod in range(num_mod)]
            anchors = np.zeros((len(candidates), 2), np.int32)
            xs = np.zeros(len(candidates), np.int32)
            ys = np.zeros(len(candidates), np.int32)
            for i, mch in enumerate(candidates):
                x = mch.x * 2 + 1
                y = mch.y * 2 + 1
                tw = tps[mch.template_id][start].width
                th = tps[mch.template_id][start].height
                x = max(x, border)
                y = max(y, border)
                x = min(x, W - tw - border)
                y = min(y, H - th - border)
                xs[i], ys[i] = x, y
                anchors[i] = ((x // t - 8) * t, (y // t - 8) * t)

            tid_arr = np.array([m.template_id for m in candidates], np.int32)
            # Pad the candidate batch to a power of two so the jitted
            # local sweep compiles once per bucket, not per frame.
            n = len(candidates)
            n_pad = max(8, 1 << (n - 1).bit_length())
            tid_pad = np.pad(tid_arr, (0, n_pad - n))
            anchors_pad = np.pad(anchors, ((0, n_pad - n), (0, 0)))
            total16 = None
            nfeat_lvl = None
            for mod in range(num_mod):
                K, tsize, nfeat = packed[mod]
                cand_K = jnp.asarray(K)[jnp.asarray(tid_pad)]
                s16 = np.asarray(
                    local_scores(
                        responses[lvl][mod], cand_K, jnp.asarray(anchors_pad), t
                    )
                )[:n]
                total16 = s16 if total16 is None else total16 + s16
                nf = nfeat[tid_arr]
                nfeat_lvl = nf if nfeat_lvl is None else nfeat_lvl + nf

            refined: List[Match] = []
            for i, mch in enumerate(candidates):
                grid = total16[i]
                pct = (grid * 100.0).astype(np.float32) / (4.0 * nfeat_lvl[i])
                # first strict max in row-major order
                best_flat = int(np.argmax(pct))
                best_r, best_c = divmod(best_flat, pct.shape[1])
                best = float(pct[best_r, best_c])
                nx = (xs[i] // t - 8 + best_c) * t + off
                ny = (ys[i] // t - 8 + best_r) * t + off
                if best >= threshold:
                    refined.append(Match(nx, ny, best, class_id, mch.template_id))
            candidates = refined

        return candidates
