"""Histogram tree growing on packed bin codes, and tree prediction.

Counterpart of the binned grower in ``h2o3_tpu/models/tree.py``. Trees
are complete binary arrays of static depth: node k's children are 2k+1
and 2k+2, rows carry an int32 node id, and each level runs one fused
route + histogram kernel (``ops/hist_adaptive.binned_level``) followed by
the split search here. Split search is Newton gain over [nodes,
features, bins, NA direction], with NA in a dedicated lane whose
direction is learned. The level loop is a Python loop; everything in it
stays on the codes' device.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List

import numpy as np
import torch

from h2o3_tpu_torch.ops.hist_adaptive import (binned_level,
                                              binned_route_only, make_tables,
                                              pick_W)

NEG_INF = -1e30
BIGV = 1e30

# packed routing word: feat[0:14) | bin[14:28) | na_left[28] | split[29]
FEAT_BITS = 14
FEAT_MASK = (1 << FEAT_BITS) - 1
BIN_SHIFT = FEAT_BITS
BIN_MASK = (1 << 14) - 1
NA_SHIFT = 28
SPLIT_SHIFT = 29


@dataclass(frozen=True)
class TreeConfig:
    max_depth: int
    n_bins: int            # real bins B; NA bin index = B
    n_features: int
    min_rows: float = 10.0
    min_split_improvement: float = 1e-5
    reg_lambda: float = 0.0
    reg_alpha: float = 0.0
    # 'float32' adds (g, h, w) unrounded, 'bfloat16' rounds each to bf16
    # before the float32 add; 'auto' = float32 below 2^18 rows
    histogram_precision: str = "auto"

    @property
    def n_nodes(self) -> int:
        return 2 ** (self.max_depth + 1) - 1

    def __post_init__(self):
        if self.n_features > FEAT_MASK:
            raise ValueError(f"{self.n_features} features exceed the "
                             f"14-bit routing field")
        if self.n_bins >= BIN_MASK:
            raise ValueError(f"{self.n_bins} bins exceed the 14-bit "
                             f"routing field")


def _soft(g, cfg: TreeConfig):
    if cfg.reg_alpha:
        return torch.sign(g) * torch.clamp(g.abs() - cfg.reg_alpha, min=0.0)
    return g


def _leaf_score2(g, h, cfg: TreeConfig):
    """Squared score T(g)^2/(h+lambda) with the L1 soft-threshold T."""
    return _soft(g, cfg) ** 2 / (h + cfg.reg_lambda + 1e-12)


def _leaf_value(g, h, cfg: TreeConfig):
    return -_soft(g, cfg) / (h + cfg.reg_lambda + 1e-12)


def _find_splits(trip, cfg: TreeConfig, col_mask, max_bin=None):
    """Best split per node from a (g, h, w) histogram triple, each
    [N, F', B'] with F' >= n_features and B' >= n_bins+1 (lane n_bins is
    NA). ``col_mask`` is [F] or [N, F]. ``max_bin`` limits candidates to
    t in 1..max_bin-1 when the lane width exceeds the real bin count.

    Returns (gain, feat, bin, na_left, g_tot, h_tot, w_tot, vl, vr, wl,
    wr) per node; vl/vr/wl/wr belong to the selected split."""
    B = cfg.n_bins
    F = cfg.n_features
    g = trip[0][:, :F, :]
    h = trip[1][:, :F, :]
    w = trip[2][:, :F, :]
    g_na, h_na, w_na = g[..., B], h[..., B], w[..., B]
    cg = torch.cumsum(g[..., :B], dim=-1)
    ch = torch.cumsum(h[..., :B], dim=-1)
    cw = torch.cumsum(w[..., :B], dim=-1)
    g_tot = cg[..., -1] + g_na
    h_tot = ch[..., -1] + h_na
    w_tot = cw[..., -1] + w_na
    # candidate split t in 1..B-1: left = bins < t (+ NA if na_left)
    gl0, hl0, wl0 = cg[..., :-1], ch[..., :-1], cw[..., :-1]
    parent = _leaf_score2(g_tot, h_tot, cfg)[..., None]

    def gains(gl, hl, wl):
        gr = g_tot[..., None] - gl
        hr = h_tot[..., None] - hl
        wr = w_tot[..., None] - wl
        gain = _leaf_score2(gl, hl, cfg) + _leaf_score2(gr, hr, cfg) - parent
        ok = (wl >= cfg.min_rows) & (wr >= cfg.min_rows)
        return torch.where(ok, gain, NEG_INF)

    gains_nr = gains(gl0, hl0, wl0)                                  # NA right
    gains_nl = gains(gl0 + g_na[..., None], hl0 + h_na[..., None],
                     wl0 + w_na[..., None])                          # NA left
    all_gains = torch.stack([gains_nr, gains_nl], dim=-1)            # [N,F,B-1,2]
    cm = col_mask if col_mask.dim() == 2 else col_mask[None, :]
    all_gains = torch.where(cm[:, :, None, None], all_gains, NEG_INF)
    if max_bin is not None and max_bin - 1 < B - 1:
        tmask = torch.arange(B - 1, device=g.device) < (max_bin - 1)
        all_gains = torch.where(tmask[None, None, :, None], all_gains,
                                NEG_INF)
    N = all_gains.shape[0]
    flat = all_gains.reshape(N, -1)
    best = torch.argmax(flat, dim=1)            # first maximum wins
    best_gain = flat.gather(1, best[:, None])[:, 0]
    per_f = (B - 1) * 2
    feat = best // per_f
    rem = best % per_f
    bin_idx = rem // 2 + 1
    na_left = (rem % 2) == 1
    nidx = torch.arange(N, device=g.device)
    t_sel = bin_idx - 1
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    gl_s = gl0[nidx, feat, t_sel] + torch.where(na_left, g_na[nidx, feat],
                                                zero)
    hl_s = hl0[nidx, feat, t_sel] + torch.where(na_left, h_na[nidx, feat],
                                                zero)
    wl_s = wl0[nidx, feat, t_sel] + torch.where(na_left, w_na[nidx, feat],
                                                zero)
    gt_s = g_tot[:, 0]
    ht_s = h_tot[:, 0]
    vl_sel = _leaf_value(gl_s, hl_s, cfg)
    vr_sel = _leaf_value(gt_s - gl_s, ht_s - hl_s, cfg)
    wr_sel = w_tot[:, 0] - wl_s
    return (best_gain, feat.to(torch.int32), bin_idx.to(torch.int32),
            na_left, g_tot[:, 0], h_tot[:, 0], w_tot[:, 0], vl_sel, vr_sel,
            wl_s, wr_sel)


def _binned_split_level(trip, find_cfg: TreeConfig, level_mask,
                        cfg: TreeConfig):
    """One level's split selection and the next level's routing table.
    Returns (the _find_splits tuple, can, tables)."""
    sel = _find_splits(trip, find_cfg, level_mask, max_bin=cfg.n_bins)
    bg, bf, bb, bnl, wt = sel[0], sel[1], sel[2], sel[3], sel[6]
    can = (bg > max(cfg.min_split_improvement, 0.0)) & (wt > 0)
    tables = make_tables(bf.clamp(min=0), bb, bnl, can).contiguous()
    return sel, can, tables


def _hist_bf16(cfg: TreeConfig, rows: int) -> bool:
    """Whether the level histogram rounds (g, h, w) to bfloat16:
    ``histogram_precision`` forces either; 'auto' rounds from 2^18 rows
    on, as the JAX package does."""
    if cfg.histogram_precision in ("float32", "f32"):
        return False
    if cfg.histogram_precision in ("bfloat16", "bf16"):
        return True
    return rows >= (1 << 18)


def _segment_totals(lid, valid, g, h, w, n_seg: int):
    """Per-node (g, h, w) sums over rows, in one weighted bincount."""
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    vals = torch.stack([torch.where(valid, g, zero),
                        torch.where(valid, h, zero),
                        torch.where(valid, w, zero)], dim=1)
    idx = lid.long()[:, None] * 3 + torch.arange(3, device=g.device)
    tot = torch.bincount(idx.reshape(-1), weights=vals.reshape(-1),
                         minlength=3 * n_seg).reshape(n_seg, 3)
    return tot[:, 0], tot[:, 1], tot[:, 2]


def grow_tree_binned(codes, g, h, w, cfg: TreeConfig, col_mask=None):
    """Build one tree on packed codes ``[rows, F]`` (int8/int16, NA = the
    reserved lane W-1, W = pick_W(cfg.n_bins)). Split thresholds stay bin
    indices (``split_bin``); finalize unbins them to raw thresholds.

    Returns (tree dict of [M] tensors: feat, split_bin, na_left,
    is_split, value, gain, node_w; and every row's leaf node id)."""
    D = cfg.max_depth
    M = cfg.n_nodes
    rows, F = codes.shape
    dev = codes.device
    W = pick_W(cfg.n_bins)
    bf16 = _hist_bf16(cfg, rows)
    find_cfg = replace(cfg, n_bins=W - 1)          # NA lane at W-1
    if col_mask is None:
        col_mask = torch.ones(F, dtype=torch.bool, device=dev)

    feat = torch.full((M,), -1, dtype=torch.int32, device=dev)
    split_bin = torch.zeros(M, dtype=torch.int32, device=dev)
    na_left = torch.zeros(M, dtype=torch.bool, device=dev)
    is_split = torch.zeros(M, dtype=torch.bool, device=dev)
    value = torch.zeros(M, dtype=torch.float32, device=dev)
    gain_arr = torch.zeros(M, dtype=torch.float32, device=dev)
    node_w = torch.zeros(M, dtype=torch.float32, device=dev)

    ghw = torch.stack([g, h, w]).to(torch.float32).contiguous()
    nid = torch.zeros(rows, dtype=torch.int32, device=dev)
    tables = torch.zeros((4, 1), dtype=torch.int32, device=dev)

    def tree():
        return {"feat": feat, "split_bin": split_bin, "na_left": na_left,
                "is_split": is_split, "value": value, "gain": gain_arr,
                "node_w": node_w}

    if D == 0:
        live = (w > 0).to(g.dtype)
        value[0] = _leaf_value((g * live).sum(), (h * live).sum(), cfg)
        node_w[0] = w.sum()
        return tree(), nid

    for d in range(D):
        N = 2 ** d
        base = N - 1
        nid, hist = binned_level(codes, nid, ghw, tables, N // 2 if d else 0,
                                 N, base, W, bf16)
        sel, can, tables = _binned_split_level(
            (hist[0], hist[1], hist[2]), find_cfg, col_mask, cfg)
        bg, bf, bb, bnl, gt, ht, wt = sel[:7]
        idx = slice(base, base + N)
        feat[idx] = torch.where(can, bf, -1)
        split_bin[idx] = bb
        na_left[idx] = bnl
        is_split[idx] = can
        value[idx] = torch.clamp(_leaf_value(gt, ht, cfg), -BIGV, BIGV)
        gain_arr[idx] = torch.where(can, bg, 0.0)
        node_w[idx] = wt

    # deepest level: route, then exact per-leaf (g, h, w) totals
    ND = 2 ** D
    baseD = ND - 1
    nid = binned_route_only(codes, nid, tables, ND // 2, baseD, W)
    localD = nid - baseD
    inD = (localD >= 0) & (localD < ND)
    lidD = localD.clamp(0, ND - 1)
    gD, hD, wD = _segment_totals(lidD, inD, g, h, w, ND)
    value[baseD:] = torch.clamp(_leaf_value(gD, hD, cfg), -BIGV, BIGV)
    node_w[baseD:] = wD
    return tree(), nid


def predict_binned(codes, tree, max_depth: int, na_bin: int):
    """Leaf values and leaf ids of one tree walked over a packed code
    matrix: one packed-word gather per level."""
    rows = codes.shape[0]
    word = (tree["feat"].clamp(min=0)
            | (tree["split_bin"] << BIN_SHIFT)
            | (tree["na_left"].to(torch.int32) << NA_SHIFT)
            | (tree["is_split"].to(torch.int32) << SPLIT_SHIFT))
    nid = torch.zeros(rows, dtype=torch.int64, device=codes.device)
    for _ in range(max_depth):
        rw = word[nid]
        f = (rw & FEAT_MASK).long()
        b = (rw >> BIN_SHIFT) & BIN_MASK
        nl = ((rw >> NA_SHIFT) & 1).to(torch.bool)
        s = ((rw >> SPLIT_SHIFT) & 1).to(torch.bool)
        c = codes.gather(1, f[:, None])[:, 0].to(torch.int32)
        right = torch.where(c == na_bin, ~nl, c >= b)
        nid = torch.where(s, 2 * nid + 1 + right.long(), nid)
    return tree["value"][nid], nid.to(torch.int32)


def predict_raw_stacked(X, feat, thr, na_left, is_split, value,
                        max_depth: int):
    """Per-tree contributions ``[rows, T]`` of a stack of T trees
    (``feat``/``thr``/... are [T, M]) walked over raw features (float32,
    NaN = NA)."""
    rows = X.shape[0]
    out = []
    for t in range(feat.shape[0]):
        nid = torch.zeros(rows, dtype=torch.int64, device=X.device)
        for _ in range(max_depth):
            f = feat[t][nid]
            s = is_split[t][nid]
            th = thr[t][nid]
            nl = na_left[t][nid]
            x = X.gather(1, f.clamp(min=0).long()[:, None])[:, 0]
            right = torch.where(torch.isnan(x), ~nl, x >= th)
            nid = torch.where(s, 2 * nid + 1 + right.long(), nid)
        out.append(value[t][nid])
    if not out:
        return torch.zeros((rows, 0), dtype=torch.float32, device=X.device)
    return torch.stack(out, dim=1)


def bins_to_thresholds_stacked(split_bin: np.ndarray, feat: np.ndarray,
                               edges: List[np.ndarray]) -> np.ndarray:
    """Bin-to-raw-threshold conversion for a [T, M] tree stack (copied
    from the JAX package): left <=> raw < edges[feat][bin-1]; non-split
    nodes get 0, split bins past a feature's edge list +inf (all non-NA
    left)."""
    if not edges:
        return np.zeros_like(split_bin, dtype=np.float32)
    emax = max((len(e) for e in edges), default=0)
    emat = np.full((len(edges), max(emax, 1)), np.inf, dtype=np.float32)
    elen = np.zeros(len(edges), dtype=np.int64)
    for f, e in enumerate(edges):
        emat[f, : len(e)] = e
        elen[f] = len(e)
    fidx = np.maximum(feat, 0)
    t = split_bin.astype(np.int64)
    over = (t - 1) >= elen[fidx]
    thr = emat[fidx, np.clip(t - 1, 0, max(emax - 1, 0))]
    thr = np.where(over, np.float32(np.inf), thr)
    return np.where(feat < 0, np.float32(0.0), thr).astype(np.float32)
