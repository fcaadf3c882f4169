"""Histogram tree growing, and tree prediction.

Counterpart of ``h2o3_tpu/models/tree.py``'s two in-memory growers of
the port: ``grow_tree_binned`` on packed bin codes (the global quantile
sketch, binned once per train) and ``grow_tree_adaptive`` on raw
features with per-node adaptive uniform bins (H2O's default
``UniformAdaptive``), plus the rule that picks between them. Trees are
complete binary arrays of static depth: node k's children are 2k+1 and
2k+2, rows carry an int32 node id, and each level runs one fused route +
histogram kernel (``ops/hist_adaptive``) followed by the split search
here. Split search is Newton gain over [nodes, features, bins, NA
direction], with NA in a dedicated lane whose direction is learned. The
level loop is a Python loop; everything in it stays on the features'
device.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List

import numpy as np
import torch

from h2o3_tpu_torch.ops.hist_adaptive import (adaptive_level,
                                              adaptive_route_only,
                                              binned_level,
                                              binned_route_only,
                                              make_adaptive_tables,
                                              make_tables, pick_W,
                                              rows_features)

NEG_INF = -1e30
BIGV = 1e30
# raw threshold of a split on a zero-span feature (NA vs finite): every
# finite value routes left; finite, so a table lookup never makes inf*0
BIG_THR = 3.0e38

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


# ---------------------------------------------------------------- path rule
#
# Which grower a GBM takes, copied with its constants from the JAX
# package so that both packages take the same path on the same
# parameters. The sizes are that package's TPU VMEM gate; they are no
# limit of the card (the CUDA level kernels tile past any such size), and
# stay here as the JAX package's path rule.

# histogram_type values the adaptive grower serves (GBM also routes
# 'random' there, which needs a per-tree grid phase)
ADAPTIVE_HIST_TYPES = ("uniform_adaptive", "uniform", "auto", "round_robin")


def packed_codes_requested(params) -> bool:
    """The ``packed_codes`` parameter: 'auto' (the default) and True pack
    on every device; False takes the adaptive grower."""
    v = params.get("packed_codes", "auto")
    if isinstance(v, str):
        v = v.lower()
    if v in ("auto", None):
        return True
    return v in (True, "true", "1")


def packed_bins_upper_bound(spec, params) -> int:
    """Upper bound on the global sketch's effective bin count from the
    categorical domains alone (numeric features never exceed nbins),
    so that the rule can refuse packing before the sketch."""
    nbins = int(params["nbins"])
    nc = int(params.get("nbins_cats", 1024))
    cards = [len(spec.cat_domains.get(n, ())) for n, c in
             zip(spec.names, spec.is_cat) if c]
    mc = max(cards, default=0)
    return max(nbins, min(mc, nc + 1), 2)


def binned_feasible(n_bins: int, n_features: int, max_depth: int) -> bool:
    """The JAX package's rule for the packed path: at most 254 bins, and
    the deepest level's [3·2^(D-1), F·W] float32 histogram twice within
    96 MiB."""
    if n_bins > 254:
        return False
    W = pick_W(n_bins)
    n_deep = 2 ** max(max_depth - 1, 0)
    return 2 * 3 * n_deep * n_features * W * 4 <= 96 * 2 ** 20


def _adaptive_n_bins_eff(spec, params) -> int:
    """Effective bin count sizing the adaptive lane width W: enums want
    identity bins (card-1), capped by nbins_cats and the 254-lane max."""
    nbins = int(params["nbins"])
    cards = [len(spec.cat_domains.get(n, ())) for n, c in
             zip(spec.names, spec.is_cat) if c]
    max_card = max(cards, default=0)
    return max(nbins, min(max(max_card - 1, 0),
                          int(params.get("nbins_cats", 1024)), 254), 2)


def adaptive_feasible(spec, params, max_depth: int) -> bool:
    """The JAX package's rule for the adaptive path: nbins at most 254,
    and the deepest level's histogram twice within 96 MiB."""
    if int(params["nbins"]) > 254:
        return False
    W = pick_W(_adaptive_n_bins_eff(spec, params))
    n_deep = 2 ** max(max_depth - 1, 0)
    level_bytes = 2 * 3 * n_deep * spec.n_features * W * 4
    return level_bytes <= 96 * 2 ** 20


def tree_config(params, max_depth: int, n_bins: int,
                n_features: int) -> TreeConfig:
    """The TreeConfig of a GBM's parameters."""
    p = params
    return TreeConfig(max_depth=max_depth, n_bins=n_bins,
                      n_features=n_features, min_rows=float(p["min_rows"]),
                      min_split_improvement=float(p["min_split_improvement"]),
                      reg_lambda=float(p.get("reg_lambda", 0.0)),
                      reg_alpha=float(p.get("reg_alpha", 0.0)),
                      histogram_precision=str(
                          p.get("histogram_precision", "auto")).lower())


def _nan_extreme(X, largest: bool):
    """Per-column min (or max) of the finite values of X [rows, F]; 0
    where a column has none."""
    fin = torch.isfinite(X)
    fill = float("-inf") if largest else float("inf")
    v = torch.where(fin, X, fill)
    v = v.amax(dim=0) if largest else v.amin(dim=0)
    return torch.where(fin.any(dim=0), v, 0.0).to(torch.float32)


def adaptive_setup(spec, params, max_depth: int):
    """TreeConfig, per-feature finite root ranges and per-feature bin
    counts for the adaptive grower. Enums get identity bins: n_bins is
    card-1 (capped by nbins_cats and the 254-lane max) and nb_f their
    root span (capped by nbins_cats); numeric features get nbins. ±inf is
    masked before the min/max so one infinite cell cannot widen a range.
    Returns (cfg, root_lo, root_hi, nb_f)."""
    nbins = int(params["nbins"])
    nbins_cats = int(params.get("nbins_cats", 1024))
    cfg = tree_config(params, max_depth, _adaptive_n_bins_eff(spec, params),
                      spec.n_features)
    root_lo = _nan_extreme(spec.X, largest=False)
    root_hi = _nan_extreme(spec.X, largest=True)
    cat = torch.as_tensor(spec.is_cat, dtype=torch.bool,
                          device=spec.X.device)
    span = torch.clamp(root_hi - root_lo, min=1.0)
    nb_f = torch.where(cat, torch.clamp(span, max=float(nbins_cats)),
                       float(nbins)).to(torch.float32)
    return cfg, root_lo, root_hi, nb_f


def _fused_mul_add(a, b, c):
    """``a * b + c`` with one rounding to float32, as the JAX package's
    compiled grower computes the range updates (XLA contracts them into
    fused multiply-adds). The float64 product of these float32 operands
    is exact; the sum is rounded to float64 and then to float32, which
    differs from one rounding only when the first lands on a float32
    tie."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _next_ranges(hist_w, lo_d, hi_d, inv_d, thr, bf, can, W: int):
    """The next level's [2N, F] ranges: each node's range narrowed to its
    occupied bins (within one bin width), then cut at the split point on
    the split feature. ``hist_w`` is the level's w histogram
    [N, F, W]."""
    N, F = lo_d.shape
    occ = hist_w[..., :W - 1] > 0                     # real bins only
    occ8 = occ.to(torch.uint8)      # argmax takes no bool; first max wins
    first = torch.argmax(occ8, dim=-1)
    last = (W - 2) - torch.argmax(occ8.flip(-1), dim=-1)
    width = torch.where(inv_d > 0, 1.0 / torch.clamp(inv_d, min=1e-30),
                        0.0)
    lo_n = _fused_mul_add(first, width, lo_d)
    hi_n = torch.minimum(_fused_mul_add(last + 1, width, lo_d), hi_d)
    any_occ = occ.any(dim=-1)
    lo_n = torch.where(any_occ, lo_n, lo_d)
    hi_n = torch.where(any_occ, hi_n, hi_d)
    fsel = ((torch.arange(F, device=lo_d.device)[None, :] == bf[:, None])
            & can[:, None])
    t = thr[:, None]
    hi_left = torch.where(fsel, torch.minimum(t, hi_n), hi_n)
    lo_right = torch.where(fsel, torch.maximum(t, lo_n), lo_n)
    lo_next = torch.stack([lo_n, lo_right], dim=1).reshape(2 * N, F)
    hi_next = torch.stack([hi_left, hi_n], dim=1).reshape(2 * N, F)
    return lo_next, hi_next


def grow_tree_adaptive(x, g, h, w, cfg: TreeConfig, root_lo, root_hi,
                       nb_f=None, col_mask=None, phase=None,
                       layout: str = "rows_f"):
    """Build one tree with per-node adaptive uniform bins on raw float32
    features ``x`` (NaN = NA, enum codes as floats) in ``layout``
    (``"rows_f"`` [rows, F] or ``"f_rows"`` [F, rows]). ``root_lo`` /
    ``root_hi`` are the [F] finite root ranges, ``nb_f`` optional [F]
    per-feature bin counts (capped at W-2), ``phase`` an optional [F]
    grid offset in [0, 1) bin widths (``histogram_type="random"``).

    Per level: per-(node, feature) ranges ``lo``/``inv``, one fused route
    + re-bin + histogram kernel, the split search over every lane (no
    ``max_bin`` limit), raw thresholds ``lo + bin/inv`` (``BIG_THR`` on a
    zero span), and the next level's ranges (``_next_ranges``). The
    deepest level only routes: leaf values are the last split level's
    selected child stats.

    Returns (tree dict of [M] tensors: feat, thr, na_left, is_split,
    value, gain, node_w; and every row's leaf node id)."""
    D = cfg.max_depth
    M = cfg.n_nodes
    rows, F = rows_features(x, layout)
    dev = x.device
    W = pick_W(cfg.n_bins)
    bf16 = _hist_bf16(cfg, rows)
    if nb_f is None:
        nb_f = torch.full((F,), float(min(cfg.n_bins, W - 2)),
                          dtype=torch.float32, device=dev)
    else:
        nb_f = torch.clamp(nb_f.to(torch.float32), max=float(W - 2))
    find_cfg = replace(cfg, n_bins=W - 1)          # NA lane at W-1
    if col_mask is None:
        col_mask = torch.ones(F, dtype=torch.bool, device=dev)

    feat = torch.full((M,), -1, dtype=torch.int32, device=dev)
    thr_arr = torch.zeros(M, dtype=torch.float32, device=dev)
    na_left = torch.zeros(M, dtype=torch.bool, device=dev)
    is_split = torch.zeros(M, dtype=torch.bool, device=dev)
    value = torch.zeros(M, dtype=torch.float32, device=dev)
    gain_arr = torch.zeros(M, dtype=torch.float32, device=dev)
    node_w = torch.zeros(M, dtype=torch.float32, device=dev)

    ghw = torch.stack([g, h, w]).to(torch.float32).contiguous()
    nid = torch.zeros(rows, dtype=torch.int32, device=dev)
    lo_d = root_lo.to(torch.float32).reshape(1, F)
    hi_d = root_hi.to(torch.float32).reshape(1, F)
    tables = torch.zeros((4, 1), dtype=torch.float32, device=dev)

    def tree():
        return {"feat": feat, "thr": thr_arr, "na_left": na_left,
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
        if phase is not None:
            width0 = (torch.clamp(hi_d - lo_d, min=0.0)
                      / torch.clamp(nb_f[None, :], min=1.0))
            lo_d = _fused_mul_add(-phase[None, :], width0, lo_d)
        span = torch.clamp(hi_d - lo_d, min=0.0)
        inv_d = torch.where(span > 0,
                            nb_f[None, :] / torch.where(span > 0, span, 1.0),
                            0.0).contiguous()
        lo_d = lo_d.contiguous()
        nid, hist = adaptive_level(x, nid, ghw, tables, lo_d, inv_d,
                                   N // 2 if d else 0, N, base, W, bf16,
                                   layout)
        (bg, bf, bb, bnl, gt, ht, wt, vl_s, vr_s, wl_s,
         wr_s) = _find_splits((hist[0], hist[1], hist[2]), find_cfg,
                              col_mask)
        can = (bg > max(cfg.min_split_improvement, 0.0)) & (wt > 0)
        nidx = torch.arange(N, device=dev)
        lo_sel = lo_d[nidx, bf.long()]
        inv_sel = inv_d[nidx, bf.long()]
        thr = torch.where(
            can, torch.where(inv_sel > 0,
                             lo_sel + bb.to(torch.float32)
                             / torch.clamp(inv_sel, min=1e-30),
                             BIG_THR), 0.0)
        idx = slice(base, base + N)
        feat[idx] = torch.where(can, bf, -1)
        thr_arr[idx] = thr
        na_left[idx] = bnl
        is_split[idx] = can
        value[idx] = torch.clamp(_leaf_value(gt, ht, cfg), -BIGV, BIGV)
        gain_arr[idx] = torch.where(can, bg, 0.0)
        node_w[idx] = wt
        tables = make_adaptive_tables(bf.clamp(min=0), thr, bnl,
                                      can).contiguous()
        lo_d, hi_d = _next_ranges(hist[2], lo_d, hi_d, inv_d, thr, bf, can,
                                  W)

    # deepest level: route only; the leaves are the last split level's
    # selected children
    ND = 2 ** D
    baseD = ND - 1
    nid = adaptive_route_only(x, nid, tables, ND // 2, baseD, layout)
    value[baseD:] = torch.clamp(
        torch.stack([vl_s, vr_s], dim=1).reshape(ND), -BIGV, BIGV)
    node_w[baseD:] = torch.stack([wl_s, wr_s], dim=1).reshape(ND)
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
