"""Fused per-frame match program: one jitted XLA program per frame.

The host-orchestrated path in api/detector.py makes ~20 small device
calls per frame. This module fuses the entire hot path into a single jit:

    raw frames -> quantize (both modalities, both levels) -> spread ->
    response maps -> coarse conv sweep over the global template bank
    -> device-side top-K candidate selection -> vmapped 16x16 local
    refinement -> fixed-size candidate arrays

Only the final [K]-sized arrays leave the device. Semantics are
identical to api/detector.py (same oracle-parity rules); the only
difference is the static candidate capacity ``max_candidates`` — the
program also returns the total number of above-threshold coarse
candidates so callers can detect overflow (parity guaranteed when
count <= K, which holds for realistic thresholds).

The template bank is packed once (all classes concatenated) and lives on
device; adding templates invalidates the pack.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from object_detector_6d_tpu.quant.color_gradient import quantized_orientations
from object_detector_6d_tpu.quant.depth_normal import quantized_normals
from object_detector_6d_tpu.quant.pyramid import pyr_down_u8
from object_detector_6d_tpu.match.response import response_maps, spread


@dataclasses.dataclass
class PackedBank:
    """Global template bank packed for the fused program (2 levels)."""

    class_ids: List[str]  # per global template id
    local_tids: np.ndarray  # [nT] local id within class
    # coarse level (lowest): per modality kernels over the T1-decimated
    # response planes, [nT, 8*t1^2, kd, kd] — the stride-T1 sweep becomes
    # a stride-1 conv (coarse_sweep); responses are 0..4 and kernel
    # cells are small feature counts, so the integer sums are exact
    kernels_low: List[jnp.ndarray]
    # refinement level 0: per modality sparse per-feature arrays over the
    # decimated T0 grid, plane/dr/dc [nT, F]
    feat_plane: List[jnp.ndarray]
    feat_dr: List[jnp.ndarray]
    feat_dc: List[jnp.ndarray]
    feat_n: List[jnp.ndarray]  # [nT] feature counts per modality
    max_dr: int  # max feature cell offset at level 0
    nfeat: List[np.ndarray]  # per level: [nT] total features (all mods)
    sizes: List[np.ndarray]  # per level: [nT, 2] (w, h)

    @property
    def num_templates(self) -> int:
        return len(self.class_ids)


def pack_bank(
    class_templates: Dict[str, list], num_mod: int, levels: int, t0: int = 5,
    t1: int = 8, pad_to: int = 1,
) -> PackedBank:
    """Concatenate every class's template pyramids into one bank.

    ``pad_to``: round the bank size up to a multiple (for template-axis
    sharding over a mesh). Padding templates have zero features, so
    their raw coarse score is 0 and the strict > threshold rule
    (raw_thr >= 0) means they can never become candidates.
    """
    from object_detector_6d_tpu.quant.features import Template

    class_ids: List[str] = []
    local_tids: List[int] = []
    all_tps = []
    for cid, tps in class_templates.items():
        for i, tp in enumerate(tps):
            class_ids.append(cid)
            local_tids.append(i)
            all_tps.append(tp)
    while pad_to > 1 and len(all_tps) % pad_to:
        class_ids.append("")
        local_tids.append(-1)
        all_tps.append(
            [Template(0, 0, lvl, []) for lvl in range(levels) for _ in range(num_mod)]
        )
    nT = len(all_tps)
    nfeat: List[np.ndarray] = []
    sizes: List[np.ndarray] = []
    for lvl in range(levels):
        nf = np.zeros(nT, np.int32)
        sz = np.zeros((nT, 2), np.int32)
        for mod in range(num_mod):
            for i, t in enumerate((tp[lvl * num_mod + mod] for tp in all_tps)):
                sz[i] = (t.width, t.height)
                nf[i] += len(t.features)
        nfeat.append(nf)
        sizes.append(sz)

    # coarse (lowest level) one-hot conv kernels over the t1-decimated
    # plane layout: channel = label*t1^2 + (fy%t1)*t1 + fx%t1, spatial
    # offset (fy//t1, fx//t1) — see coarse_stage
    lowest = levels - 1
    kernels_low: List[jnp.ndarray] = []
    for mod in range(num_mod):
        tmpls = [tp[lowest * num_mod + mod] for tp in all_tps]
        kh = max((t.height for t in tmpls), default=0) + 1
        kw = max((t.width for t in tmpls), default=0) + 1
        kd = (max(kh, kw) - 1) // t1 + 1
        K = np.zeros((nT, 8 * t1 * t1, kd, kd), np.float32)
        for i, t in enumerate(tmpls):
            for f in t.features:
                plane = f.label * t1 * t1 + (f.y % t1) * t1 + (f.x % t1)
                K[i, plane, f.y // t1, f.x // t1] += 1.0
        kernels_low.append(jnp.asarray(K, dtype=jnp.bfloat16))

    # level-0 features over the decimated T0 grid: plane =
    # label*T0^2 + (fy%T0)*T0 + fx%T0, cell offset (fy//T0, fx//T0)
    max_dr = 0
    for mod in range(num_mod):
        for tp in all_tps:
            for f in tp[mod].features:
                max_dr = max(max_dr, f.y // t0, f.x // t0)

    feat_plane, feat_dr, feat_dc, feat_n = [], [], [], []
    for mod in range(num_mod):
        tmpls = [tp[mod] for tp in all_tps]
        F = max((len(t.features) for t in tmpls), default=1)
        pla = np.zeros((nT, F), np.int32)
        dra = np.zeros((nT, F), np.int32)
        dca = np.zeros((nT, F), np.int32)
        na = np.zeros((nT,), np.int32)
        for i, t in enumerate(tmpls):
            na[i] = len(t.features)
            for j, f in enumerate(t.features):
                pla[i, j] = f.label * t0 * t0 + (f.y % t0) * t0 + (f.x % t0)
                dra[i, j] = f.y // t0
                dca[i, j] = f.x // t0
        feat_plane.append(jnp.asarray(pla))
        feat_dr.append(jnp.asarray(dra))
        feat_dc.append(jnp.asarray(dca))
        feat_n.append(jnp.asarray(na))

    return PackedBank(
        class_ids,
        np.array(local_tids, np.int32),
        kernels_low,
        feat_plane,
        feat_dr,
        feat_dc,
        feat_n,
        max_dr,
        nfeat,
        sizes,
    )


def _quantize_pyramids(sources, modality_names, levels, dn_params, cg_params):
    """Quantized images [level][modality], all inside the trace."""
    qs = [[] for _ in range(levels)]
    for name, src in zip(modality_names, sources):
        if name == "ColorGradient":
            img = src
            for lvl in range(levels):
                q, _ = quantized_orientations(img, weak_threshold=cg_params.weak_threshold)
                qs[lvl].append(q)
                if lvl + 1 < levels:
                    img = pyr_down_u8(img)
        elif name == "DepthNormal":
            q = quantized_normals(
                src,
                distance_threshold=dn_params.distance_threshold,
                difference_threshold=dn_params.difference_threshold,
            )
            for lvl in range(levels):
                qs[lvl].append(q)
                if lvl + 1 < levels:
                    q = q[::2, ::2]
        else:
            raise ValueError(name)
    return qs


def exact_topk(x: jnp.ndarray, k: int) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact top-k with lax.top_k's ordering via k iterative argmax passes.

    jax.lax.top_k lowers to a sort of the full array — for the coarse
    stage's flat [nT*gh*gw] score vector (~146k entries at 122
    templates) that is a serial O(N log N) cost per frame, while k
    reduce+mask passes stay memory-bound (2k linear passes over the
    vector). Ordering is identical: descending value, ties broken by
    lower index (argmax returns the FIRST maximum; the selected element
    is then sunk below every real score so later passes pick the next).
    Only valid when every real entry is > the sink value; the coarse
    stage's scores are -1 (masked) or >= 0 (raw similarity sums), and
    the sink is -2.
    """
    sink = jnp.asarray(-2, x.dtype)
    vals, idxs = [], []
    for _ in range(k):
        i = jnp.argmax(x)
        vals.append(x[i])
        idxs.append(i)
        x = x.at[i].set(sink)
    return jnp.stack(vals), jnp.stack(idxs)


def refine_planes_shape(frame_shape, t0: int, max_dr: int):
    """(P, Hp, Wp) of the decimated level-0 refine planes: 8*t0^2 planes
    over the ceil(H/t0) x ceil(W/t0) cell grid, zero-padded by 16 +
    max_dr + 1 cells so every 16x16 tile of an in-frame candidate stays
    in bounds."""
    Hd, Wd = -(-frame_shape[0] // t0), -(-frame_shape[1] // t0)
    pad_cells = 16 + max_dr + 1
    return 8 * t0 * t0, Hd + pad_cells, Wd + pad_cells


def refine_tiles(D, plane, r0, c0, nfeat):
    """Level-0 refine: gather each feature's 16x16 tile and sum.

    D [P, Hp, Wp] int8; plane/r0/c0 [K, F] int32; nfeat [K] int32 ->
    [K, 16, 16] int32, out[k] = sum_{f < nfeat[k]}
    D[plane[k, f], r0[k, f]:+16, c0[k, f]:+16] (tile starts clamp into
    the planes, as ``dynamic_slice`` does)."""
    def tile(p, r, c):
        return jax.lax.dynamic_slice(D, (p, r, c), (1, 16, 16))[0]

    tiles = jax.vmap(jax.vmap(tile))(plane, r0, c0)  # [K, F, 16, 16]
    live = jnp.arange(plane.shape[1])[None, :] < nfeat[:, None]
    return jnp.sum(
        jnp.where(live[:, :, None, None], tiles.astype(jnp.int32), 0), axis=1)


def coarse_sweep(D: jnp.ndarray, kernels: jnp.ndarray) -> jnp.ndarray:
    """Raw coarse similarity of every template at every anchor.

    D [P, Hn, Wn] decimated level-1 responses (values 0..4); kernels
    [nT, P, kd, kd] one-hot feature counts -> [nT, Hn-kd+1, Wn-kd+1]
    int32, out[t, r, c] = sum_{p,i,j} D[p, r+i, c+j] * kernels[t, p, i, j].

    bf16 operands with f32 accumulation: exact, since 0..4 and the small
    counts are exact in bf16 and every partial sum stays far below 2^24.
    (XLA:GPU refuses the s8 x s8 -> s32 form: cuDNN's integer
    convolutions produce s8 or f32 only.)
    """
    return jax.lax.conv_general_dilated(
        D[None].astype(jnp.bfloat16),
        kernels.astype(jnp.bfloat16),
        window_strides=(1, 1),
        padding="VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=jnp.float32,
    )[0].astype(jnp.int32)


def make_match_program(
    modality_names: Sequence[str],
    t_at_level: Sequence[int],
    frame_shape: Tuple[int, int],
    dn_params,
    cg_params,
    max_candidates: int = 64,
    max_dr: int = 64,
    batch: int | None = None,
    mesh=None,
    topk_impl: str = "argmax",
):
    """Build the fused per-frame matcher.

    Returns a jitted function
        run(sources, kernels_low, feat_arrays, nfeat_l0,
            nfeat_l1, sizes_l0, sizes_l1, threshold) -> [5, K+1] f32
    (or [B, 5, K+1] when ``batch`` is set: the per-frame program is
    vmapped over the frame axis).

    ``max_dr`` bounds the bank's largest level-0 feature cell offset
    (it sizes the zero padding of the decimated refine planes).
    ``topk_impl``: 'argmax' (k iterative argmax passes — exact, avoids
    sorting the flat coarse grid) or 'sort' (jax.lax.top_k); identical
    outputs (test_match.py::test_exact_topk_equals_lax).
    """
    levels = len(t_at_level)
    assert levels == 2, "fused program currently supports 2-level pyramids"
    num_mod = len(modality_names)
    H0, W0 = frame_shape
    H1, W1 = H0 // 2, W0 // 2
    t0, t1 = t_at_level
    gh, gw = H1 // t1, W1 // t1
    off0 = t0 // 2 + (t0 % 2 - 1)
    off1 = t1 // 2 + (t1 % 2 - 1)
    K_cap = max_candidates
    # decimated level-0 grid
    Hd, Wd = -(-H0 // t0), -(-W0 // t0)
    _, Hp, Wp = refine_planes_shape(frame_shape, t0, max_dr)

    # level-1 decimated grid (for the coarse sweep): ceil so the partial
    # last cell row/col keeps its real response values
    Hd1, Wd1 = -(-H1 // t1), -(-W1 // t1)

    def decimate_l1(R):
        """[8, H1, W1] -> [8*t1^2, Hd1, Wd1] (zero-padded partial cells)."""
        R = jnp.pad(R, ((0, 0), (0, Hd1 * t1 - H1), (0, Wd1 * t1 - W1)))
        return (
            R.reshape(8, Hd1, t1, Wd1, t1)
            .transpose(0, 2, 4, 1, 3)
            .reshape(8 * t1 * t1, Hd1, Wd1)
        )

    def compute_responses(sources):
        """Quantize + spread + response maps for both levels of one frame.
        Returns (R0, R1): per modality [8, H, W] u8."""
        qs = _quantize_pyramids(sources, modality_names, levels, dn_params,
                                cg_params)
        R0 = [response_maps(spread(qs[0][m], t0)) for m in range(num_mod)]
        R1 = [response_maps(spread(qs[1][m], t1)) for m in range(num_mod)]
        return R0, R1

    def coarse_stage(R0, R1, kernels_low, nfeat_l1, sizes_l1, threshold):
        """Single frame: precomputed responses -> coarse sweep -> top-K."""
        raw = None
        for mod in range(num_mod):
            k = kernels_low[mod]  # [nT, 8*t1^2, kd, kd]
            kd = k.shape[3]
            # stride-T1 sweep == stride-1 conv over the decimated planes:
            # score[t,r,c] = sum_f R1[l, r*t1+fy, c*t1+fx]
            #              = sum_f D[l*t1^2+(fy%t1)*t1+fx%t1, r+fy//t1, c+fx//t1]
            D = decimate_l1(R1[mod])
            need_h = gh + kd - 1
            need_w = gw + kd - 1
            D = jnp.pad(
                D,
                ((0, 0), (0, max(0, need_h - Hd1)), (0, max(0, need_w - Wd1))),
            )
            s = coarse_sweep(D, k)[:, :gh, :gw]
            raw = s if raw is None else raw + s

        nT = raw.shape[0]
        # per-template valid span at level 1 (oracle similarity() bounds)
        wf = (sizes_l1[:, 0] - 1) // t1 + 1
        hf = (sizes_l1[:, 1] - 1) // t1 + 1
        span_x = (W1 // t1) - wf  # inclusive
        span_y = (H1 // t1) - hf
        rgrid = jax.lax.broadcasted_iota(jnp.int32, (nT, gh, gw), 1)
        cgrid = jax.lax.broadcasted_iota(jnp.int32, (nT, gh, gw), 2)
        in_span = (rgrid <= span_y[:, None, None]) & (cgrid <= span_x[:, None, None])
        raw = jnp.where(in_span, raw, 0)
        # raw threshold: int(2nf + thr/100*2nf + 0.5), f32 exact
        nf2 = (2 * nfeat_l1).astype(jnp.float32)
        raw_thr = (
            nf2
            + threshold.astype(jnp.float32) / jnp.float32(100.0) * nf2
            + jnp.float32(0.5)
        ).astype(jnp.int32)

        above = raw > raw_thr[:, None, None]
        n_above = jnp.sum(above.astype(jnp.int32))
        flat_score = jnp.where(above, raw, -1).reshape(-1)
        if topk_impl == "argmax":
            top_vals, top_idx = exact_topk(flat_score, K_cap)
        else:
            top_vals, top_idx = jax.lax.top_k(flat_score, K_cap)
        valid = top_vals > -1
        tids = top_idx // (gh * gw)
        rc = top_idx % (gh * gw)
        xs = (rc % gw) * t1 + off1
        ys = (rc // gw) * t1 + off1
        return tids, valid, n_above, xs, ys, top_vals

    def anchors_stage(tids, xs, ys, sizes_l0):
        border = 8 * t0
        tw = sizes_l0[tids, 0]
        th = sizes_l0[tids, 1]
        x2 = jnp.minimum(jnp.maximum(xs * 2 + 1, border), W0 - tw - border)
        y2 = jnp.minimum(jnp.maximum(ys * 2 + 1, border), H0 - th - border)
        return x2, y2, x2 // t0 - 8, y2 // t0 - 8

    def build_D(R):
        """Response map [8, H0, W0] -> decimated planes [8*t0^2, Hp, Wp]."""
        R = R.astype(jnp.int8)
        R = jnp.pad(R, ((0, 0), (0, Hd * t0 - H0), (0, Wd * t0 - W0)))
        D = (
            R.reshape(8, Hd, t0, Wd, t0)
            .transpose(0, 2, 4, 1, 3)
            .reshape(8 * t0 * t0, Hd, Wd)
        )
        return jnp.pad(D, ((0, 0), (0, Hp - Hd), (0, Wp - Wd)))

    def refine_stage(R0, feat_arrays, tids, valid, base_r, base_c):
        """Sum each candidate's feature tiles: [K, 16, 16] f32."""
        feat_plane, feat_dr, feat_dc, feat_n = feat_arrays
        total16 = jnp.zeros((K_cap, 16, 16), jnp.int32)
        for mod in range(num_mod):
            D = build_D(R0[mod])
            plane = feat_plane[mod][tids]
            r0 = base_r[:, None] + feat_dr[mod][tids]
            c0 = base_c[:, None] + feat_dc[mod][tids]
            # invalid top-K slots sweep zero features
            nfe = jnp.where(valid, feat_n[mod][tids], 0)
            total16 = total16 + refine_tiles(D, plane, r0, c0, nfe)
        return total16.astype(jnp.float32)

    def post_stage(total16, tids, valid, n_above, x2, y2, nfeat_l0, threshold,
                   raw_vals, tid_offset):
        """Pack results. Row 5 carries the raw coarse score so a sharded
        caller can re-merge local top-Ks by the same criterion the
        single-device top_k used; unsharded callers drop it."""
        nf0 = nfeat_l0[tids].astype(jnp.float32)
        pct16 = total16 * jnp.float32(100.0) / (jnp.float32(4.0) * nf0[:, None, None])
        best_flat = jnp.argmax(pct16.reshape(K_cap, -1), axis=1)
        best_r = best_flat // 16
        best_c = best_flat % 16
        best = jnp.take_along_axis(
            pct16.reshape(K_cap, -1), best_flat[:, None], axis=1
        )[:, 0]
        nx = (x2 // t0 - 8 + best_c) * t0 + off0
        ny = (y2 // t0 - 8 + best_r) * t0 + off0
        keep = valid & (best >= threshold.astype(jnp.float32))
        packed = jnp.stack(
            [
                nx.astype(jnp.float32),
                ny.astype(jnp.float32),
                best,
                (tids + tid_offset).astype(jnp.float32),
                keep.astype(jnp.float32),
                raw_vals.astype(jnp.float32),
            ],
            axis=0,
        )  # [6, K]
        n_col = jnp.full((6, 1), n_above.astype(jnp.float32))
        return jnp.concatenate([packed, n_col], axis=1)  # [6, K+1]

    def core(
        sources,
        kernels_low,
        feat_arrays,
        nfeat_l0,
        nfeat_l1,
        sizes_l0,
        sizes_l1,
        threshold,
        tid_offset=0,
    ):
        """Single frame, full pipeline -> [6, K+1] (row 5 = raw score).

        All bank inputs may be a template-axis SHARD; ``tid_offset``
        relabels output template ids to global ids."""
        R0, R1 = compute_responses(sources)
        tids, valid, n_above, xs, ys, raw_vals = coarse_stage(
            R0, R1, kernels_low, nfeat_l1, sizes_l1, threshold
        )
        x2, y2, base_c, base_r = anchors_stage(tids, xs, ys, sizes_l0)
        total16 = refine_stage(R0, feat_arrays, tids, valid, base_r, base_c)
        return post_stage(total16, tids, valid, n_above, x2, y2, nfeat_l0,
                          threshold, raw_vals, tid_offset)

    def core_batched(sources, *args, **kw):
        """``core`` vmapped over the leading frame axis."""
        return jax.vmap(lambda s: core(s, *args, **kw))(sources)

    if mesh is not None:
        return _sharded_run(mesh, core_batched, K_cap, batch)

    if batch is None:
        @jax.jit
        def run(*args):
            return core(*args)[:5]
        return run

    @jax.jit
    def run_batched(sources, *args):
        return core_batched(sources, *args)[:, :5]

    return run_batched


def merge_shard_candidates(packed_all: jnp.ndarray, K_cap: int) -> jnp.ndarray:
    """Merge model-axis candidate shards: [tp, 6, K+1] -> [6, K+1].

    Selects the global top-K by raw coarse score (row 5) — the same
    criterion the single-device program's flat top_k used, and in the
    same tie order (shards are concatenated in global-template order, so
    the stable top_k prefers lower template ids on ties exactly like the
    flat single-device scan). ``n_above`` (the overflow count in the
    last column) sums across shards.
    """
    tp = packed_all.shape[0]
    cands = packed_all[:, :, :-1].transpose(1, 0, 2).reshape(6, tp * K_cap)
    # rank by raw score (row 5, -1 for empty slots) — NOT by the keep
    # flag: slots that were valid coarse candidates but failed
    # refinement must still occupy top-K slots exactly as on a single
    # device
    _, sel = jax.lax.top_k(cands[5], K_cap)
    merged = jnp.take_along_axis(cands, sel[None, :].repeat(6, 0), axis=1)
    n_above = jnp.sum(packed_all[:, 0, -1])
    return jnp.concatenate([merged, jnp.full((6, 1), n_above)], axis=1)


def _sharded_run(mesh, core_batched, K_cap, batch):
    """shard_map the fused program: frames over ``data``, templates over
    ``model``; each device runs the full local pipeline on its (frame
    shard x template shard), then candidates merge across the model axis
    (one all_gather — the only coarse-path collective)."""
    from jax.sharding import PartitionSpec as P
    from jax import shard_map

    dp = mesh.shape["data"]
    tp = mesh.shape["model"]
    if batch is None or batch % dp:
        raise ValueError(f"sharded program needs batch divisible by data axis "
                         f"({batch} vs {dp})")

    def local(sources, kernels_low, feat_arrays,
              nfeat_l0, nfeat_l1, sizes_l0, sizes_l1, threshold):
        shard = jax.lax.axis_index("model")
        n_local = nfeat_l0.shape[0]
        packed_l = core_batched(
            sources, kernels_low, feat_arrays,
            nfeat_l0, nfeat_l1, sizes_l0, sizes_l1, threshold,
            tid_offset=shard * n_local,
        )  # [Bl, 6, K+1]
        packed_all = jax.lax.all_gather(packed_l, "model")  # [tp, Bl, 6, K+1]
        return jax.vmap(
            lambda pa: merge_shard_candidates(pa, K_cap),
            in_axes=1,
        )(packed_all)  # [Bl, 6, K+1]

    sharded = shard_map(
        local,
        mesh=mesh,
        in_specs=(
            P("data"),  # sources (pytree leaves share the frame axis)
            P("model"), P("model"),
            P("model"), P("model"), P("model"), P("model"), P(),
        ),
        out_specs=P("data"),
        check_vma=False,
    )

    @jax.jit
    def run(sources, *args):
        return sharded(sources, *args)[:, :5]

    return run
