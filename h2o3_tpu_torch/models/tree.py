"""Histogram tree growing, and tree prediction.

Counterpart of ``h2o3_tpu/models/tree.py``'s three in-memory growers of
the port: ``grow_tree_binned`` on packed bin codes (the global quantile
sketch, binned once per train), ``grow_tree_adaptive`` on raw features
with per-node adaptive uniform bins (H2O's default ``UniformAdaptive``)
and ``grow_tree`` on unpacked global-sketch codes (more than 254 bins, or
``quantiles_global`` without packing), plus the rule that picks between
them. Trees are complete binary arrays of static depth: node k's
children are 2k+1 and 2k+2, rows carry an int32 node id, and each level
runs one fused route + histogram kernel (``ops/hist_adaptive``; the
global-sketch grower a histogram kernel, ``ops/histogram``, and a route
in torch) followed by the split search here. Split search is Newton
gain over [nodes, features, bins, NA direction], with NA in a dedicated
lane whose direction is learned. The level loop is a Python loop;
everything in it stays on the features' device.

On a mesh (ROADMAP item 14, ``parallel/``) the growers take lists of
per-data-shard row blocks (codes or features, g, h, w), one a local
shard in shard order, each on its shard's device. Each level launches
its kernel once a shard on the shard's rows and reduces the partial
histograms over the data axis (``collectives.psum``) where the JAX
growers ``psum``; the deepest level's leaf totals the same. The split
search runs once, on the lead shard's device, on the reduced
histogram, whatever the mesh's model axis: the model shards of one
process would search their feature blocks one after another on the same
device, and the first maximum over contiguous blocks is the whole
search's pick. Only ``grow_tree_spmd`` cuts features over the model
axis.
A single tensor is the one-shard case: no reduce, no copy, the
single-device grower's operations.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import List

import numpy as np
import torch

from h2o3_tpu_torch.ops.hist_adaptive import (I8_MAX_ROWS, adaptive_level,
                                              adaptive_route_only,
                                              binned_level,
                                              binned_route_only,
                                              make_adaptive_tables,
                                              make_tables, pick_W,
                                              quantize_ghw_i8,
                                              rows_features)
from h2o3_tpu_torch.ops.common import segment_totals
from h2o3_tpu_torch.ops.histogram import build_histograms_sharded
from h2o3_tpu_torch.ops.random import (fold_in, level_subset,
                                       sample_weights, uniform,
                                       uniform_below)
from h2o3_tpu_torch.parallel import shardstats
from h2o3_tpu_torch.parallel.collectives import all_gather, psum
from h2o3_tpu_torch.parallel.mesh import (MODEL_AXIS, n_model_shards,
                                          on_device)

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
    # > 0: a random column subset of this size per node per level (DRF's
    # mtries), drawn from the tree's key
    mtries: int = 0
    # col_sample_rate_change_per_level: level d's subset size is
    # (mtries or F) * col_rate_change^d, clamped to [1, F]
    col_rate_change: float = 1.0
    # histogram_type="random": a per-tree grid phase on the adaptive bins
    random_grid: bool = False
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


def _cumsum_bins(x):
    """Cumulative sums over the last axis, in one fixed order on every
    device. Torch scans each row of a CUDA tensor with more than one row
    in a fixed order, but a tensor that is one row long (one node, one
    feature) goes to CUB's device-wide scan, whose float sums follow the
    schedule; such a row is scanned beside a row of zeros."""
    if x.numel() == x.shape[-1]:
        two = torch.stack([x.reshape(-1), torch.zeros_like(x.reshape(-1))])
        return torch.cumsum(two, dim=-1)[0].reshape(x.shape)
    return torch.cumsum(x, dim=-1)


def _find_splits(trip, cfg: TreeConfig, col_mask, max_bin=None, mono=None):
    """Best split per node from a (g, h, w) histogram triple, each
    [N, F', B'] with F' >= n_features and B' >= n_bins+1 (lane n_bins is
    NA). ``col_mask`` is [F] or [N, F]. ``max_bin`` limits candidates to
    t in 1..max_bin-1 when the lane width exceeds the real bin count.
    ``mono`` ([F] int32, -1/0/+1) is the monotone constraints: a
    candidate on feature f with mono[f] = c is valid only where
    c·(left child value) <= c·(right child value).

    Returns (gain, feat, bin, na_left, g_tot, h_tot, w_tot, vl, vr, wl,
    wr) per node; vl/vr/wl/wr belong to the selected split (vl and vr
    unclipped: the monotone bounds of the children come from them)."""
    B = cfg.n_bins
    F = cfg.n_features
    g = trip[0][:, :F, :]
    h = trip[1][:, :F, :]
    w = trip[2][:, :F, :]
    g_na, h_na, w_na = g[..., B], h[..., B], w[..., B]
    cg = _cumsum_bins(g[..., :B])
    ch = _cumsum_bins(h[..., :B])
    cw = _cumsum_bins(w[..., :B])
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
        if mono is not None:
            c = mono.to(torch.float32)[None, :, None]
            vl = _leaf_value(gl, hl, cfg)
            vr = _leaf_value(gr, hr, cfg)
            ok = ok & ((c == 0) | (c * (vr - vl) >= 0))
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


def _level_mtries(cfg: TreeConfig, d: int, F: int) -> int:
    """Level ``d``'s column-subset size: mtries scaled by
    col_sample_rate_change_per_level^d, clamped to [1, F]; 0 = the full
    column set, no draw (the JAX package's rule)."""
    mt_d = cfg.mtries
    if cfg.col_rate_change != 1.0:
        base_m = cfg.mtries if cfg.mtries > 0 else F
        mt_d = int(min(max(1, round(base_m * cfg.col_rate_change ** d)), F))
        if mt_d >= F and cfg.mtries <= 0:
            mt_d = 0
    return mt_d


def _level_mask(cfg: TreeConfig, d: int, N: int, col_mask, key):
    """The column mask of level ``d``'s split search: the tree's
    ``col_mask`` [F], or, where the level draws a subset
    (``_level_mtries``) and the tree has a key, the per-node [N, F]
    subsets of ``random.level_subset``."""
    m = _level_mtries(cfg, d, col_mask.shape[0])
    if m > 0 and key is not None:
        return level_subset(key, d, N, col_mask, m)
    return col_mask


def _child_bounds(lo_b, hi_b, vl, vr, mono_dir, can):
    """Monotone bound propagation (the JAX package's ``_child_bounds``):
    a split on a constrained feature bounds both subtrees at the midpoint
    of its clipped child values; other nodes pass their bounds on.
    Returns the children's [2N] (lo, hi), interleaved."""
    vl_c = torch.clamp(vl, lo_b, hi_b)
    vr_c = torch.clamp(vr, lo_b, hi_b)
    mid = 0.5 * (vl_c + vr_c)
    up = can & (mono_dir > 0)      # left <= right
    dn = can & (mono_dir < 0)
    lo_left = torch.where(dn, mid, lo_b)
    hi_left = torch.where(up, mid, hi_b)
    lo_right = torch.where(up, mid, lo_b)
    hi_right = torch.where(dn, mid, hi_b)
    return (torch.stack([lo_left, lo_right], dim=1).reshape(-1),
            torch.stack([hi_left, hi_right], dim=1).reshape(-1))


def _next_allowed(allowed, sets, bf, can):
    """Interaction-constraint propagation (the JAX package's
    ``_next_allowed``): below a split on feature f, the features that
    share an interaction set with f, within the node's own allowance.
    ``allowed`` [N, F] bool, ``sets`` [S, F] bool; returns [2N, F]."""
    contains = sets[:, bf.long()].t()                 # [N, S]
    union = (contains[:, :, None] & sets[None, :, :]).any(dim=1)
    child = torch.where(can[:, None], allowed & union, allowed)
    return child.repeat_interleave(2, dim=0)


class _Constraints:
    """A tree's monotone bounds (``mono`` [F] int32) and interaction
    allowance (``sets`` [S, F] bool) through its level loop; either may
    be None. Without monotone constraints every value is clipped to
    [-BIGV, BIGV] as before; without sets the level mask passes
    through."""

    def __init__(self, mono, sets, F: int, dev):
        self.mono = mono
        self.sets = sets
        if mono is not None:
            self.lo = torch.full((1,), -BIGV, dtype=torch.float32, device=dev)
            self.hi = torch.full((1,), BIGV, dtype=torch.float32, device=dev)
        self.allowed = (torch.ones((1, F), dtype=torch.bool, device=dev)
                        if sets is not None else None)

    def mask(self, level_mask):
        """The level's column mask ANDed with the allowance."""
        if self.allowed is None:
            return level_mask
        lm2 = level_mask if level_mask.dim() == 2 else level_mask[None, :]
        return lm2 & self.allowed

    def clip(self, v):
        if self.mono is None:
            return torch.clamp(v, -BIGV, BIGV)
        return torch.clamp(v, self.lo, self.hi)

    def advance(self, vl, vr, bf, can):
        """The next level's bounds and allowance from this level's
        selected splits."""
        if self.mono is not None:
            self.lo, self.hi = _child_bounds(self.lo, self.hi, vl, vr,
                                             self.mono[bf.long()], can)
        if self.allowed is not None:
            self.allowed = _next_allowed(self.allowed, self.sets, bf, can)


def _binned_split_level(trip, find_cfg: TreeConfig, level_mask,
                        cfg: TreeConfig, mono=None):
    """One level's split selection and the next level's routing table.
    Returns (the _find_splits tuple, can, tables)."""
    sel = _find_splits(trip, find_cfg, level_mask, max_bin=cfg.n_bins,
                       mono=mono)
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


def _hist_i8(ghw, bf16: bool, rows: int):
    """The int8 fixed-point opt-in, read as the JAX growers read it:
    ``H2O3_HIST_I8`` = the number of terms (1 or 2; unset or 0 = off).
    Where it is on, the level histogram is bf16 and the frame has at
    most ``I8_MAX_ROWS`` rows, the tree's (g, h, w) are quantised once
    and the level dispatchers take the int8 form where ``takes_i8``
    holds. Unlike the JAX package, which reads it only on the TPU (or
    in interpret mode), the port applies it on every device. Returns
    ``qs`` = (q, scales) or None."""
    terms = int(os.environ.get("H2O3_HIST_I8", "0") or 0)
    if terms and bf16 and rows <= I8_MAX_ROWS:
        return quantize_ghw_i8(ghw, terms)
    return None


def _shards(x):
    """(list of per-shard tensors, whether ``x`` came as a list)."""
    if isinstance(x, (list, tuple)):
        return list(x), True
    return [x], False


def _everywhere(t, devices):
    """``t`` on each shard's device (the tensor itself where it is)."""
    return [t.to(d) for d in devices]


def _segment_totals(nid, ghw, n_seg: int, base: int):
    """Per-node (g, h, w) sums of the rows whose ``nid`` lies in ``[base,
    base + n_seg)`` (``ghw`` [3, rows] float32): on the card the
    leaf-totals kernel, whose sums come in a fixed order
    (``ops/common.segment_totals``)."""
    tot = segment_totals(nid, ghw, n_seg, base)
    return tot[0], tot[1], tot[2]


def grow_tree_binned(codes, g, h, w, cfg: TreeConfig, col_mask=None,
                     key=None, mono=None, sets=None, mesh=None):
    """Build one tree on packed codes ``[rows, F]`` (int8/int16, NA = the
    reserved lane W-1, W = pick_W(cfg.n_bins)). Split thresholds stay bin
    indices (``split_bin``); finalize unbins them to raw thresholds.
    ``H2O3_HIST_I8`` switches levels to int8 fixed-point masses
    (``_hist_i8``). ``col_mask`` [F] limits the split search to the
    tree's columns, and with ``key`` (the tree's key) levels draw per-node
    column subsets (``_level_mask``). ``mono`` [F] int32 and ``sets``
    [S, F] bool are the monotone and interaction constraints
    (``_Constraints``): splits that break them are masked, node values
    clipped into the monotone bounds.

    On a mesh ``codes``, ``g``, ``h`` and ``w`` are lists of per-shard
    blocks (module docstring) and ``mesh`` the mesh: each level's
    histogram and the leaf totals are reduced over the data shards, each
    shard deciding its bf16 rounding and int8 scale from its own rows as
    the JAX growers do under ``shard_map``.

    Returns (tree dict of [M] tensors: feat, split_bin, na_left,
    is_split, value, gain, node_w, on the lead shard's device; and every
    row's leaf node id, a list of per-shard ids on a mesh)."""
    cs, sharded = _shards(codes)
    gs, hs, ws = _shards(g)[0], _shards(h)[0], _shards(w)[0]
    devs = [c.device for c in cs]
    D = cfg.max_depth
    M = cfg.n_nodes
    rows, F = cs[0].shape
    dev = devs[0]
    W = pick_W(cfg.n_bins)
    cons = _Constraints(mono, sets, F, dev)
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

    ghws = [torch.stack([gj, hj, wj]).to(torch.float32).contiguous()
            for gj, hj, wj in zip(gs, hs, ws)]
    qss = [_hist_i8(ghw, bf16, c.shape[0]) for ghw, c in zip(ghws, cs)]
    nids = [torch.zeros(c.shape[0], dtype=torch.int32, device=c.device)
            for c in cs]
    tables_s = _everywhere(torch.zeros((4, 1), dtype=torch.int32,
                                       device=dev), devs)

    def tree():
        return {"feat": feat, "split_bin": split_bin, "na_left": na_left,
                "is_split": is_split, "value": value, "gain": gain_arr,
                "node_w": node_w}

    def out_nid():
        return nids if sharded else nids[0]

    if D == 0:
        parts = [torch.stack([(gj * (wj > 0).to(gj.dtype)).sum(),
                              (hj * (wj > 0).to(gj.dtype)).sum(), wj.sum()])
                 for gj, hj, wj in zip(gs, hs, ws)]
        tot = psum(parts, mesh, lead_only=True)[0]
        value[0] = _leaf_value(tot[0], tot[1], cfg)
        node_w[0] = tot[2]
        return tree(), out_nid()

    for d in range(D):
        N = 2 ** d
        base = N - 1
        marks = shardstats.step_begin(dev)
        hists = []
        for j, c in enumerate(cs):
            with on_device(devs[j]):
                nids[j], hj = binned_level(c, nids[j], ghws[j], tables_s[j],
                                           N // 2 if d else 0, N, base, W,
                                           bf16, qss[j])
            hists.append(hj)
            if marks is not None:
                marks.shard_done(devs[j])
        hist = psum(hists, mesh, lead_only=True)[0]
        sel, can, tables = _binned_split_level(
            (hist[0], hist[1], hist[2]), find_cfg,
            cons.mask(_level_mask(cfg, d, N, col_mask, key)), cfg, mono)
        tables_s = _everywhere(tables, devs)
        bg, bf, bb, bnl, gt, ht, wt, vl_s, vr_s = sel[:9]
        idx = slice(base, base + N)
        feat[idx] = torch.where(can, bf, -1)
        split_bin[idx] = bb
        na_left[idx] = bnl
        is_split[idx] = can
        value[idx] = cons.clip(_leaf_value(gt, ht, cfg))
        gain_arr[idx] = torch.where(can, bg, 0.0)
        node_w[idx] = wt
        cons.advance(vl_s, vr_s, bf, can)

    # deepest level: route, then exact per-leaf (g, h, w) totals
    ND = 2 ** D
    baseD = ND - 1
    tots = []
    for j, c in enumerate(cs):
        with on_device(devs[j]):
            nids[j] = binned_route_only(c, nids[j], tables_s[j], ND // 2,
                                        baseD, W)
            tots.append(segment_totals(nids[j], ghws[j], ND, baseD))
    tot = psum(tots, mesh, lead_only=True)[0]
    gD, hD, wD = tot[0], tot[1], tot[2]
    value[baseD:] = cons.clip(_leaf_value(gD, hD, cfg))
    node_w[baseD:] = wD
    return tree(), out_nid()


def grow_tree(codes, g, h, w, cfg: TreeConfig, col_mask=None, key=None,
              mono=None, sets=None, mesh=None):
    """Build one tree on global-sketch codes ``[rows, F]`` (uint8 or
    int32, NA = bin ``cfg.n_bins``), the JAX package's ``grow_tree``.
    Per level: one histogram build (``ops/histogram``, reduced over the
    data shards on a mesh: ``build_histograms_sharded``), at levels >= 1
    of the left children only, the right ones being parent - left
    (sibling subtraction); the split search over every bin (no
    ``max_bin``); routing by one packed-word gather per row. The deepest
    level's leaf values come from per-leaf totals after the last route.
    ``col_mask``, ``key``, ``mono``, ``sets`` and ``mesh`` (with lists
    of per-shard blocks) as in ``grow_tree_binned``.

    Returns (tree dict of [M] tensors: feat, split_bin, na_left,
    is_split, value, gain, node_w; and every row's leaf node id, a list
    on a mesh)."""
    cs, sharded = _shards(codes)
    gs, hs, ws = _shards(g)[0], _shards(h)[0], _shards(w)[0]
    devs = [c.device for c in cs]
    D = cfg.max_depth
    M = cfg.n_nodes
    B1 = cfg.n_bins + 1
    rows, F = cs[0].shape
    dev = devs[0]
    bf16 = _hist_bf16(cfg, rows)
    if col_mask is None:
        col_mask = torch.ones(F, dtype=torch.bool, device=dev)
    cons = _Constraints(mono, sets, F, dev)

    feat = torch.full((M,), -1, dtype=torch.int32, device=dev)
    split_bin = torch.zeros(M, dtype=torch.int32, device=dev)
    na_left = torch.zeros(M, dtype=torch.bool, device=dev)
    is_split = torch.zeros(M, dtype=torch.bool, device=dev)
    value = torch.zeros(M, dtype=torch.float32, device=dev)
    gain_arr = torch.zeros(M, dtype=torch.float32, device=dev)
    node_w = torch.zeros(M, dtype=torch.float32, device=dev)

    # stacked once; rows off the level are excluded by an out-of-range seg
    ghws = [torch.stack([gj, hj, wj]).to(torch.float32).contiguous()
            for gj, hj, wj in zip(gs, hs, ws)]
    nids = [torch.zeros(c.shape[0], dtype=torch.int32, device=c.device)
            for c in cs]
    prev_hist = None
    for d in range(D):
        base = 2 ** d - 1
        N = 2 ** d
        locs = [nid - base for nid in nids]
        in_lvls = [(loc >= 0) & (loc < N) for loc in locs]
        marks = shardstats.step_begin(dev)
        if prev_hist is None:
            segs = [torch.where(il, loc, -1) for il, loc in zip(in_lvls, locs)]
            hist = build_histograms_sharded(cs, segs, ghws, N, B1, mesh,
                                            bf16, marks)
        else:
            # children of a non-split parent get phantom mass here, but
            # no row routes to them, so nothing reads it
            segs = [torch.where(il & (loc % 2 == 0), loc // 2, -1)
                    for il, loc in zip(in_lvls, locs)]
            hist_l = build_histograms_sharded(cs, segs, ghws, N // 2, B1,
                                              mesh, bf16, marks)
            hist = tuple(torch.stack([hl, hp - hl], dim=1).reshape(N, F, B1)
                         for hl, hp in zip(hist_l, prev_hist))
        prev_hist = hist
        bg, bf, bb, bnl, gt, ht, wt, vl_s, vr_s = _find_splits(
            hist, cfg, cons.mask(_level_mask(cfg, d, N, col_mask, key)),
            mono=mono)[:9]
        can = (bg > max(cfg.min_split_improvement, 0.0)) & (wt > 0)
        idx = slice(base, base + N)
        feat[idx] = torch.where(can, bf, -1)
        split_bin[idx] = bb
        na_left[idx] = bnl
        is_split[idx] = can
        value[idx] = cons.clip(_leaf_value(gt, ht, cfg))
        gain_arr[idx] = torch.where(can, bg, 0.0)
        node_w[idx] = wt
        cons.advance(vl_s, vr_s, bf, can)
        # route the level's rows whose node splits: one gather of the
        # node's packed word per row
        word = (bf | (bb << BIN_SHIFT) | (bnl.to(torch.int32) << NA_SHIFT)
                | (can.to(torch.int32) << SPLIT_SHIFT))
        for j, (c, word_j) in enumerate(zip(cs, _everywhere(word, devs))):
            rw = word_j[locs[j].clamp(0, N - 1).long()]
            node_feat = (rw & FEAT_MASK).long()
            node_bin = (rw >> BIN_SHIFT) & BIN_MASK
            node_nal = ((rw >> NA_SHIFT) & 1).to(torch.bool)
            node_can = ((rw >> SPLIT_SHIFT) & 1).to(torch.bool)
            cj = c.gather(1, node_feat[:, None])[:, 0].to(torch.int32)
            right = torch.where(cj == cfg.n_bins, ~node_nal, cj >= node_bin)
            child = 2 * nids[j] + 1 + right.to(torch.int32)
            nids[j] = torch.where(in_lvls[j] & node_can, child, nids[j])

    # deepest level: leaf values from per-leaf totals
    ND = 2 ** D
    baseD = ND - 1
    tots = []
    for j in range(len(cs)):
        with on_device(devs[j]):
            tots.append(segment_totals(nids[j], ghws[j], ND, baseD))
    tot = psum(tots, mesh, lead_only=True)[0]
    gD, hD, wD = tot[0], tot[1], tot[2]
    value[baseD:] = cons.clip(_leaf_value(gD, hD, cfg))
    node_w[baseD:] = wD
    return {"feat": feat, "split_bin": split_bin, "na_left": na_left,
            "is_split": is_split, "value": value, "gain": gain_arr,
            "node_w": node_w}, (nids if sharded else nids[0])


def grow_tree_spmd(codes, g, h, w, cfg: TreeConfig, col_mask, mesh):
    """The fully sharded tree build (the JAX package's ``grow_tree_spmd``):
    rows over the mesh's data axis AND features over its model axis.
    ``codes`` [rows, F] (global-sketch codes, NA = bin n_bins), ``g``,
    ``h``, ``w`` [rows] and ``col_mask`` [F] are global tensors, rows
    padded to a multiple of the data axis; this process keeps its own
    data shards, each cut into ``n_model`` contiguous feature blocks (F
    padded with masked features to a multiple). Per level:

      1. each (row block, feature block) builds its histogram (K11 on
         the card, no sibling subtraction);
      2. the data-axis psum completes each feature block's histogram;
      3. each block's ``_find_splits``, then the candidates gathered
         over the model axis and the first maximum taken (the lowest
         shard on a tie);
      4. each row is routed by the model shard owning its node's split
         feature (the JAX psum over ``model`` of the owner's children).

    The leaf values come from the data-reduced per-leaf totals of (g, h)
    after the last route (``segment_totals``). Returns (tree dict of [M]
    tensors: feat, split_bin, na_left, is_split, value, on the lead
    device; and the global node ids [rows] of this process's shards, in
    row order, on the lead device)."""
    from h2o3_tpu_torch.parallel.mesh import partitioner
    part = partitioner(mesh)
    n_model = n_model_shards(mesh)
    D = cfg.max_depth
    M = cfg.n_nodes
    B1 = cfg.n_bins + 1
    F = codes.shape[1]
    F_loc = -(-F // n_model)
    Fp = F_loc * n_model
    if Fp > F:
        codes = torch.cat([codes, torch.zeros(
            (codes.shape[0], Fp - F), dtype=codes.dtype,
            device=codes.device)], dim=1)
        col_mask = torch.cat([col_mask, torch.zeros(
            Fp - F, dtype=torch.bool, device=col_mask.device)])
    cs = part.shard_rows(codes)                 # [rows_s, Fp] a data shard
    devs = [c.device for c in cs]
    dev = devs[0]
    blocks = [[c[:, m * F_loc:(m + 1) * F_loc].contiguous()
               for m in range(n_model)] for c in cs]
    ghws = [torch.stack([gj, hj, wj]).to(torch.float32).contiguous()
            for gj, hj, wj in zip(part.shard_rows(g), part.shard_rows(h),
                                  part.shard_rows(w))]
    cm = col_mask.to(dev)
    cfg_l = replace(cfg, n_features=F_loc)
    bf16 = _hist_bf16(cfg, cs[0].shape[0])

    feat = torch.full((M,), -1, dtype=torch.int32, device=dev)
    split_bin = torch.zeros(M, dtype=torch.int32, device=dev)
    na_left = torch.zeros(M, dtype=torch.bool, device=dev)
    is_split = torch.zeros(M, dtype=torch.bool, device=dev)
    value = torch.zeros(M, dtype=torch.float32, device=dev)
    nids = [torch.zeros(c.shape[0], dtype=torch.int32, device=c.device)
            for c in cs]
    for d in range(D):
        base = 2 ** d - 1
        N = 2 ** d
        locs = [nid - base for nid in nids]
        in_lvls = [(loc >= 0) & (loc < N) for loc in locs]
        segs = [torch.where(il, loc, -1) for il, loc in zip(in_lvls, locs)]
        cands, tot0 = [], None
        for m in range(n_model):
            hist = build_histograms_sharded(
                [b[m] for b in blocks], segs, ghws, N, B1, mesh, bf16)
            sel = _find_splits(hist, cfg_l, cm[m * F_loc:(m + 1) * F_loc])
            if m == 0:
                tot0 = sel[4:7]
            cands.append(torch.stack(
                [sel[0], (sel[1] + m * F_loc).to(torch.float32),
                 sel[2].to(torch.float32), sel[3].to(torch.float32)], dim=1))
        allc = torch.stack(all_gather(cands, axis=MODEL_AXIS))  # [m, N, 4]
        winner = torch.argmax(allc[:, :, 0], dim=0)
        pick = allc[winner, torch.arange(N, device=dev)]
        gbg, gbf = pick[:, 0], pick[:, 1].to(torch.int32)
        gbb, gbnl = pick[:, 2].to(torch.int32), pick[:, 3] > 0.5
        gt, ht, wt = tot0
        can = (gbg > max(cfg.min_split_improvement, 0.0)) & (wt > 0)
        idx = slice(base, base + N)
        feat[idx] = torch.where(can, gbf, -1)
        split_bin[idx] = gbb
        na_left[idx] = gbnl
        is_split[idx] = can
        value[idx] = _leaf_value(gt, ht, cfg)
        node = torch.stack([gbf, gbb, gbnl.to(torch.int32),
                            can.to(torch.int32)])
        for j, node_j in enumerate(_everywhere(node, devs)):
            rw = node_j[:, locs[j].clamp(0, N - 1).long()]
            owner = rw[0] // F_loc
            node_can = rw[3] == 1
            routed = torch.zeros_like(nids[j])
            for m in range(n_model):
                c = blocks[j][m].gather(
                    1, (rw[0] % F_loc).long()[:, None])[:, 0].to(torch.int32)
                right = torch.where(c == cfg.n_bins, rw[2] == 0, c >= rw[1])
                child = 2 * nids[j] + 1 + right.to(torch.int32)
                routed = routed + torch.where(
                    (owner == m) & in_lvls[j] & node_can, child, 0)
            nids[j] = torch.where(in_lvls[j] & node_can, routed, nids[j])

    ND = 2 ** D
    baseD = ND - 1
    tots = []
    for j in range(len(cs)):
        with on_device(devs[j]):
            tots.append(segment_totals(nids[j], ghws[j], ND, baseD))
    tot = psum(tots, mesh, lead_only=True)[0]
    value[baseD:] = _leaf_value(tot[0], tot[1], cfg)
    tree = {"feat": feat, "split_bin": split_bin, "na_left": na_left,
            "is_split": is_split, "value": value}
    return tree, torch.cat([n.to(dev) for n in nids])


def tree_sample(key_r, key_c, w, y, rate: float, rates, col_rate: float,
                F: int, shards=None):
    """A tree's row weights and column mask (sampling, ROADMAP item A4),
    drawn as the JAX package's loops draw them: on each data shard ``s``
    the row key folded with ``s`` (``shards``, the global indices of the
    blocks of a list ``w``; shard 0 for a tensor) and the rows kept where
    ``uniform(key_r_s, rows_s) < rate`` over the shard's own rows (or
    ``< rates[y]`` with sample_rate_per_class: ``rates`` float32 [K],
    ``y`` int32 codes, blocks as ``w``), the columns where
    ``uniform(key_c, F) < col_rate``. ``rate`` and ``col_rate`` are
    float32 values. A rate of 1 keeps every row (or column) with no
    draw, as the JAX draw does by ``u < 1``. Returns (wt = w times the
    sample, a list where ``w`` is one; col_mask [F] bool on the first
    block's device, or None for every column)."""
    ws, sharded = _shards(w)
    ys = _shards(y)[0] if y is not None else [None] * len(ws)
    ids = list(shards) if shards is not None else list(range(len(ws)))
    if rates is not None or rate < 1.0:
        ws = [sample_weights(fold_in(key_r, s), wj, rate, yj,
                             None if rates is None else rates.to(wj.device))
              for s, wj, yj in zip(ids, ws, ys)]
    col_mask = None
    if col_rate < 1.0:
        col_mask = uniform_below(key_c, F, col_rate, ws[0].device)
    return (ws if sharded else ws[0]), col_mask


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


def tree_config(params, max_depth: int, n_bins: int, n_features: int,
                mtries: int = 0) -> TreeConfig:
    """The TreeConfig of a GBM's or a DRF's parameters; ``mtries`` is the
    DRF's per-node subset size (0 for the GBM, which does not read it)."""
    p = params
    return TreeConfig(max_depth=max_depth, n_bins=n_bins,
                      n_features=n_features, min_rows=float(p["min_rows"]),
                      min_split_improvement=float(p["min_split_improvement"]),
                      reg_lambda=float(p.get("reg_lambda", 0.0)),
                      reg_alpha=float(p.get("reg_alpha", 0.0)),
                      mtries=mtries,
                      col_rate_change=float(
                          p.get("col_sample_rate_change_per_level", 1.0)
                          or 1.0),
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


def adaptive_setup(spec, params, max_depth: int, mtries: int = 0):
    """TreeConfig, per-feature finite root ranges and per-feature bin
    counts for the adaptive grower (``mtries`` as in ``tree_config``;
    ``histogram_type="random"`` sets the config's random grid). Enums
    get identity bins: n_bins is card-1 (capped by nbins_cats and the
    254-lane max) and nb_f their root span (capped by nbins_cats);
    numeric features get nbins. ±inf is masked before the min/max so one
    infinite cell cannot widen a range. Returns (cfg, root_lo, root_hi,
    nb_f)."""
    nbins = int(params["nbins"])
    nbins_cats = int(params.get("nbins_cats", 1024))
    cfg = replace(
        tree_config(params, max_depth, _adaptive_n_bins_eff(spec, params),
                    spec.n_features, mtries),
        random_grid=str(params.get("histogram_type", "")).lower()
        == "random")
    if spec.X is None:
        # a streamed train: the ranges of the host matrix
        dev = spec.device
        fin = np.isfinite(spec.X_host)
        lo = np.where(fin, spec.X_host, np.inf).min(axis=0, initial=np.inf)
        hi = np.where(fin, spec.X_host, -np.inf).max(axis=0,
                                                     initial=-np.inf)
        any_fin = fin.any(axis=0)
        root_lo = torch.as_tensor(np.where(any_fin, lo, 0.0)
                                  .astype(np.float32), device=dev)
        root_hi = torch.as_tensor(np.where(any_fin, hi, 0.0)
                                  .astype(np.float32), device=dev)
    else:
        dev = spec.X.device
        root_lo = _nan_extreme(spec.X, largest=False)
        root_hi = _nan_extreme(spec.X, largest=True)
    cat = torch.as_tensor(spec.is_cat, dtype=torch.bool, device=dev)
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


def _next_ranges(hist_w, lo_d, hi_d, inv_d, thr, bf, can, W: int,
                 fused: bool = True):
    """The next level's [2N, F] ranges: each node's range narrowed to its
    occupied bins (within one bin width), then cut at the split point on
    the split feature. ``hist_w`` is the level's w histogram
    [N, F, W]. ``fused`` computes ``lo + bin · width`` with one rounding,
    as the JAX package's compiled dense grower does; its streamed grower
    runs eagerly, op by op, and rounds twice (``fused=False``)."""
    N, F = lo_d.shape
    occ = hist_w[..., :W - 1] > 0                     # real bins only
    occ8 = occ.to(torch.uint8)      # argmax takes no bool; first max wins
    first = torch.argmax(occ8, dim=-1)
    last = (W - 2) - torch.argmax(occ8.flip(-1), dim=-1)
    width = torch.where(inv_d > 0, 1.0 / torch.clamp(inv_d, min=1e-30),
                        0.0)
    if fused:
        lo_n = _fused_mul_add(first, width, lo_d)
        hi_n = torch.minimum(_fused_mul_add(last + 1, width, lo_d), hi_d)
    else:
        lo_n = lo_d + first.to(torch.float32) * width
        hi_n = torch.minimum(lo_d + (last + 1).to(torch.float32) * width,
                             hi_d)
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
                       layout: str = "rows_f", key=None, mono=None,
                       sets=None, mesh=None):
    """Build one tree with per-node adaptive uniform bins on raw float32
    features ``x`` (NaN = NA, enum codes as floats) in ``layout``
    (``"rows_f"`` [rows, F] or ``"f_rows"`` [F, rows]). ``root_lo`` /
    ``root_hi`` are the [F] finite root ranges, ``nb_f`` optional [F]
    per-feature bin counts (capped at W-2), ``phase`` an optional [F]
    grid offset in [0, 1) bin widths; with ``key`` (the tree's key) and
    ``cfg.random_grid`` (``histogram_type="random"``) the phase is drawn
    as ``uniform(fold_in(key, 7919), (F,))``, and levels draw per-node
    column subsets as in ``grow_tree_binned``. ``mono``, ``sets`` and
    ``mesh`` (with lists of per-shard blocks) as there.

    Per level: per-(node, feature) ranges ``lo``/``inv``, one fused route
    + re-bin + histogram kernel a shard, the split search over every
    lane (no ``max_bin`` limit) on the data-reduced histogram, raw
    thresholds ``lo + bin/inv`` (``BIG_THR`` on a zero span), and the
    next level's ranges (``_next_ranges``, from the reduced w
    histogram). The deepest level only routes: leaf values are the last
    split level's selected child stats. ``H2O3_HIST_I8`` switches levels
    to int8 fixed-point masses (``_hist_i8``), each shard with its own
    scale.

    Returns (tree dict of [M] tensors: feat, thr, na_left, is_split,
    value, gain, node_w; and every row's leaf node id, a list on a
    mesh)."""
    xs, sharded = _shards(x)
    gs, hs, ws = _shards(g)[0], _shards(h)[0], _shards(w)[0]
    devs = [xj.device for xj in xs]
    D = cfg.max_depth
    M = cfg.n_nodes
    rows, F = rows_features(xs[0], layout)
    dev = devs[0]
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
    if phase is None and cfg.random_grid and key is not None:
        phase = uniform(fold_in(key, 7919), (F,), dev)
    cons = _Constraints(mono, sets, F, dev)

    feat = torch.full((M,), -1, dtype=torch.int32, device=dev)
    thr_arr = torch.zeros(M, dtype=torch.float32, device=dev)
    na_left = torch.zeros(M, dtype=torch.bool, device=dev)
    is_split = torch.zeros(M, dtype=torch.bool, device=dev)
    value = torch.zeros(M, dtype=torch.float32, device=dev)
    gain_arr = torch.zeros(M, dtype=torch.float32, device=dev)
    node_w = torch.zeros(M, dtype=torch.float32, device=dev)

    ghws = [torch.stack([gj, hj, wj]).to(torch.float32).contiguous()
            for gj, hj, wj in zip(gs, hs, ws)]
    qss = [_hist_i8(ghw, bf16, rows_features(xj, layout)[0])
           for ghw, xj in zip(ghws, xs)]
    nids = [torch.zeros(rows_features(xj, layout)[0], dtype=torch.int32,
                        device=xj.device) for xj in xs]
    lo_d = root_lo.to(torch.float32).reshape(1, F)
    hi_d = root_hi.to(torch.float32).reshape(1, F)
    tables_s = _everywhere(torch.zeros((4, 1), dtype=torch.float32,
                                       device=dev), devs)

    def tree():
        return {"feat": feat, "thr": thr_arr, "na_left": na_left,
                "is_split": is_split, "value": value, "gain": gain_arr,
                "node_w": node_w}

    def out_nid():
        return nids if sharded else nids[0]

    if D == 0:
        parts = [torch.stack([(gj * (wj > 0).to(gj.dtype)).sum(),
                              (hj * (wj > 0).to(gj.dtype)).sum(), wj.sum()])
                 for gj, hj, wj in zip(gs, hs, ws)]
        tot = psum(parts, mesh, lead_only=True)[0]
        value[0] = _leaf_value(tot[0], tot[1], cfg)
        node_w[0] = tot[2]
        return tree(), out_nid()

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
        marks = shardstats.step_begin(dev)
        hists = []
        for j, (xj, lo_j, inv_j) in enumerate(zip(
                xs, _everywhere(lo_d, devs), _everywhere(inv_d, devs))):
            with on_device(devs[j]):
                nids[j], hj = adaptive_level(xj, nids[j], ghws[j],
                                             tables_s[j], lo_j, inv_j,
                                             N // 2 if d else 0, N, base, W,
                                             bf16, layout, qss[j])
            hists.append(hj)
            if marks is not None:
                marks.shard_done(devs[j])
        hist = psum(hists, mesh, lead_only=True)[0]
        (bg, bf, bb, bnl, gt, ht, wt, vl_s, vr_s, wl_s,
         wr_s) = _find_splits((hist[0], hist[1], hist[2]), find_cfg,
                              cons.mask(_level_mask(cfg, d, N, col_mask,
                                                    key)), mono=mono)
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
        value[idx] = cons.clip(_leaf_value(gt, ht, cfg))
        gain_arr[idx] = torch.where(can, bg, 0.0)
        node_w[idx] = wt
        cons.advance(vl_s, vr_s, bf, can)
        tables_s = _everywhere(make_adaptive_tables(bf.clamp(min=0), thr, bnl,
                                                    can).contiguous(), devs)
        lo_d, hi_d = _next_ranges(hist[2], lo_d, hi_d, inv_d, thr, bf, can,
                                  W)

    # deepest level: route only; the leaves are the last split level's
    # selected children
    ND = 2 ** D
    baseD = ND - 1
    for j, xj in enumerate(xs):
        with on_device(devs[j]):
            nids[j] = adaptive_route_only(xj, nids[j], tables_s[j], ND // 2,
                                          baseD, layout)
    value[baseD:] = cons.clip(torch.stack([vl_s, vr_s], dim=1).reshape(ND))
    node_w[baseD:] = torch.stack([wl_s, wr_s], dim=1).reshape(ND)
    return tree(), out_nid()


# ------------------------------------------------------- streamed growers
#
# The out-of-core GBM (ROADMAP.md item 13): trees grown over the row
# chunks of ``models/streaming.StreamedChunks``, as the JAX package's
# streamed growers grow them. A level's histogram is the sum of the
# chunks' histograms, added in chunk order; the deepest level's leaf
# totals the same. The kernels are the in-memory growers', launched per
# chunk.

# The auto rule's cap on the levels a window covers. A window batches
# the host's fetch of the split records (one copy at its end); no
# histogram outlives its level, so no cache or memory size bounds L on
# the card. The JAX package bounds its window by its TPU kernel's VMEM
# instead. Trees do not depend on L.
MAX_LEVELS_PER_PASS = 4


def levels_per_pass(max_depth: int, n_features: int, W: int) -> int:
    """How many consecutive levels one window of the streamed packed
    grower covers (``H2O3_LEVELS_PER_PASS``): an integer is clamped to
    [1, max_depth], 1 being one level a window; unset or ``auto``,
    ``min(MAX_LEVELS_PER_PASS, max_depth)``. ``n_features`` and ``W``
    keep the JAX package's signature."""
    D = max(1, int(max_depth))
    raw = os.environ.get("H2O3_LEVELS_PER_PASS", "").strip().lower()
    if raw and raw != "auto":
        return max(1, min(int(raw), D))
    return min(MAX_LEVELS_PER_PASS, D)


_RECORD_KEYS = ("feat", "bin", "nal", "can", "val", "gain", "w")


def _level_record(sel, can, cfg: TreeConfig) -> torch.Tensor:
    """A level's split record as one float64 [7, N] tensor (feat -1
    where the node does not split, bin, na_left, can, value, gain, w),
    so that a window's records come home in one copy; every field is
    exact in float64."""
    bg, bf, bb, bnl = sel[0], sel[1], sel[2], sel[3]
    gt, ht, wt = sel[4], sel[5], sel[6]
    return torch.stack([torch.where(can, bf, -1).double(), bb.double(),
                        bnl.double(), can.double(),
                        _leaf_value(gt, ht, cfg).double(),
                        torch.where(can, bg, 0.0).double(), wt.double()])


def _store_records(recs, d0: int, arrays) -> None:
    """One host copy of a window's records (levels d0, d0+1, ...) into
    the tree's host arrays (``_host_tree``)."""
    host = torch.cat(recs, dim=1).cpu().numpy()
    at = 0
    for j in range(len(recs)):
        N = 1 << (d0 + j)
        idx = slice(N - 1, 2 * N - 1)
        for key, row in zip(_RECORD_KEYS, host[:, at:at + N]):
            arrays[key][idx] = row
        at += N


def _streamed_stump(chunks, dist, lr: float, cfg: TreeConfig):
    """A depth-0 streamed tree: the (g, h, w) totals over the chunks (one
    host copy a chunk, added in float64 in chunk order), one root leaf,
    applied with no feature read."""
    gs = hs = ws = 0.0
    for ch in chunks.level_pass(need_x=False):
        ghw = ch.ghw(dist)
        s3 = ghw.sum(dim=1).cpu().tolist()
        gs += s3[0]
        hs += s3[1]
        ws += s3[2]
    v0 = float(_leaf_value(torch.tensor(gs, dtype=torch.float32),
                           torch.tensor(hs, dtype=torch.float32), cfg))
    tree = {"feat": np.full(1, -1, np.int32), "thr": np.zeros(1, np.float32),
            "na_left": np.zeros(1, bool), "is_split": np.zeros(1, bool),
            "value": np.array([v0], np.float32),
            "gain": np.zeros(1, np.float32),
            "node_w": np.array([ws], np.float32)}
    v0_dev = torch.tensor([v0], dtype=torch.float32, device=chunks.dev)
    for ch in chunks.level_pass(need_x=False):
        ch.apply_leaf(lr, v0_dev, torch.zeros(ch.e - ch.s, dtype=torch.int32,
                                              device=chunks.dev))
    return tree


def _host_tree(M: int, bin_dtype) -> dict:
    """A streamed tree's host arrays, by ``_RECORD_KEYS``; "bin" holds
    split bins (int32) or raw thresholds (float32)."""
    return {"feat": np.full(M, -1, np.int32), "bin": np.zeros(M, bin_dtype),
            "nal": np.zeros(M, bool), "can": np.zeros(M, bool),
            "val": np.zeros(M, np.float32), "gain": np.zeros(M, np.float32),
            "w": np.zeros(M, np.float32)}


def _tree_dict(a, thr) -> dict:
    return {"feat": a["feat"], "thr": thr, "na_left": a["nal"],
            "is_split": a["can"], "value": a["val"], "gain": a["gain"],
            "node_w": a["w"]}


def grow_tree_binned_streamed(chunks, dist, lr: float, cfg: TreeConfig,
                              edges, key=None, sample_rate: float = 1.0,
                              col_mask=None):
    """The streamed counterpart of ``grow_tree_binned`` (the JAX
    package's ``grow_tree_binned_streamed``): packed codes in
    ``chunks``, ``levels_per_pass`` levels a window: each level adds the
    chunks' histograms in chunk order, and the window's records come
    home in one copy at its end. A pending interrupt clamps a window to
    one level. The deepest level routes every chunk, sums its exact
    per-leaf (g, h, w) (``segment_totals``) and adds them in chunk
    order; a last pass applies ``lr`` times the leaf values to the
    margins. ``H2O3_HIST_I8`` quantises each chunk's masses on its own.

    Returns the tree as host arrays with raw thresholds (unbinned from
    ``edges`` here) and the split bins (``split_bin``)."""
    F = chunks.F
    D = cfg.max_depth
    M = cfg.n_nodes
    W = pick_W(cfg.n_bins)
    if chunks.packed_W != W:
        raise ValueError(f"chunks hold codes of W = {chunks.packed_W}, "
                         f"the tree needs W = {W}")
    dev = chunks.dev
    find_cfg = replace(cfg, n_bins=W - 1)
    if col_mask is None:
        col_mask = torch.ones(F, dtype=torch.bool, device=dev)
    bf16 = _hist_bf16(cfg, chunks.padded_rows)

    chunks.begin_tree(key, sample_rate)
    if D == 0:
        return _streamed_stump(chunks, dist, lr, cfg)

    a = _host_tree(M, np.int32)
    tables = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    L = levels_per_pass(D, F, W)
    d = 0
    while d < D:
        Lw = min(L, D - d)
        if Lw > 1 and chunks.interrupt_pending():
            # the cooperative yield lands at the next level boundary
            Lw = 1
        recs = []
        for j in range(Lw):
            N = 1 << (d + j)
            hist = None
            for ch in chunks.level_pass():
                ghw = ch.ghw(dist)
                nid2, h_c = binned_level(
                    ch.X, ch.nid, ghw, tables, N // 2 if N > 1 else 0,
                    N, N - 1, W, bf16,
                    _hist_i8(ghw, bf16, chunks.padded_rows))
                ch.put_nid(nid2)
                hist = h_c if hist is None else hist + h_c
            sel, can, tables = _binned_split_level(
                (hist[0], hist[1], hist[2]), find_cfg, col_mask, cfg)
            recs.append(_level_record(sel, can, cfg))
        _store_records(recs, d, a)
        d += Lw

    # deepest level: route each chunk and add its exact leaf totals, in
    # chunk order; then apply the leaves, reading the stored node ids
    ND = 2 ** D
    baseD = ND - 1
    tot = None
    for ch in chunks.level_pass():
        nid2 = binned_route_only(ch.X, ch.nid, tables, ND // 2, baseD, W)
        ch.put_nid(nid2)
        t3 = segment_totals(nid2, ch.ghw(dist), ND, baseD)
        tot = t3 if tot is None else tot + t3
    leaf = torch.stack([_leaf_value(tot[0], tot[1], cfg), tot[2]]).cpu()
    a["val"][baseD:] = leaf[0].numpy()
    a["w"][baseD:] = leaf[1].numpy()
    value_dev = torch.as_tensor(a["val"], device=dev)
    for ch in chunks.level_pass(need_x=False):
        ch.apply_leaf(lr, value_dev, ch.nid)
    tree = _tree_dict(a, bins_to_thresholds_stacked(
        a["bin"][None, :], a["feat"][None, :], edges)[0])
    tree["split_bin"] = a["bin"]
    return tree


def grow_tree_adaptive_streamed(chunks, dist, lr: float, cfg: TreeConfig,
                                root_lo, root_hi, nb_f=None, key=None,
                                sample_rate: float = 1.0, col_mask=None):
    """The streamed counterpart of ``grow_tree_adaptive`` (the JAX
    package's ``grow_tree_adaptive_streamed``): float32 features in
    ``chunks``, per-node adaptive bins, one level a pass, each level's
    histogram the chunks' added in chunk order and its records fetched
    in one copy. The next level's ranges round as that eager grower
    rounds (``_next_ranges(fused=False)``); a random grid is not drawn,
    as there. The deepest level routes every chunk (``adaptive_route_only``)
    and applies the last split level's selected child values.

    Returns the tree as host arrays with raw thresholds."""
    F = chunks.F
    D = cfg.max_depth
    M = cfg.n_nodes
    W = pick_W(cfg.n_bins)
    dev = chunks.dev
    if nb_f is None:
        nb_f = torch.full((F,), float(min(cfg.n_bins, W - 2)),
                          dtype=torch.float32, device=dev)
    else:
        nb_f = torch.clamp(nb_f.to(torch.float32), max=float(W - 2))
    find_cfg = replace(cfg, n_bins=W - 1)
    if col_mask is None:
        col_mask = torch.ones(F, dtype=torch.bool, device=dev)
    bf16 = _hist_bf16(cfg, chunks.padded_rows)

    chunks.begin_tree(key, sample_rate)
    if D == 0:
        return _streamed_stump(chunks, dist, lr, cfg)

    a = _host_tree(M, np.float32)
    lo_d = root_lo.to(torch.float32).reshape(1, F)
    hi_d = root_hi.to(torch.float32).reshape(1, F)
    tables = torch.zeros((4, 1), dtype=torch.float32, device=dev)
    for d in range(D):
        N = 2 ** d
        span = torch.clamp(hi_d - lo_d, min=0.0)
        inv_d = torch.where(span > 0,
                            nb_f[None, :] / torch.where(span > 0, span, 1.0),
                            0.0).contiguous()
        lo_d = lo_d.contiguous()
        hist = None
        for ch in chunks.level_pass():
            ghw = ch.ghw(dist)
            nid2, h_c = adaptive_level(ch.X, ch.nid, ghw, tables, lo_d,
                                       inv_d, N // 2 if d else 0, N, N - 1,
                                       W, bf16, "rows_f",
                                       _hist_i8(ghw, bf16,
                                                chunks.padded_rows))
            ch.put_nid(nid2)
            hist = h_c if hist is None else hist + h_c
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
        rec = _level_record((bg, bf, bb, bnl, gt, ht, wt), can, cfg)
        rec[1] = thr.double()
        _store_records([rec], d, a)
        tables = make_adaptive_tables(bf.clamp(min=0), thr, bnl,
                                      can).contiguous()
        lo_d, hi_d = _next_ranges(hist[2], lo_d, hi_d, inv_d, thr, bf, can,
                                  W, fused=False)

    # deepest level: route each chunk; the leaves are the last split
    # level's selected children
    ND = 2 ** D
    baseD = ND - 1
    leaf = torch.stack([torch.stack([vl_s, vr_s], dim=1).reshape(ND),
                        torch.stack([wl_s, wr_s], dim=1).reshape(ND)]).cpu()
    a["val"][baseD:] = leaf[0].numpy()
    a["w"][baseD:] = leaf[1].numpy()
    value_dev = torch.as_tensor(a["val"], device=dev)
    for ch in chunks.level_pass():
        nid2 = adaptive_route_only(ch.X, ch.nid, tables, ND // 2, baseD,
                                   "rows_f")
        ch.apply_leaf(lr, value_dev, nid2)
    return _tree_dict(a, a["bin"])


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


def _walk_raw(X, feat, thr, na_left, is_split, max_depth: int):
    """Leaf ids (int64) of one tree's [M] arrays walked over raw
    features (float32, NaN = NA): one gather per level. ``feat`` is
    clamped only where ``is_split`` masks the result."""
    nid = torch.zeros(X.shape[0], dtype=torch.int64, device=X.device)
    for _ in range(max_depth):
        f = feat[nid]
        s = is_split[nid]
        th = thr[nid]
        nl = na_left[nid]
        x = X.gather(1, f.clamp(min=0).long()[:, None])[:, 0]
        right = torch.where(torch.isnan(x), ~nl, x >= th)
        nid = torch.where(s, 2 * nid + 1 + right.long(), nid)
    return nid


def predict_raw_tree(X, tree, max_depth: int):
    """Leaf values and leaf ids of one tree (a dict of [M] tensors with
    raw thresholds ``thr``) walked over raw features (float32, NaN =
    NA)."""
    nid = _walk_raw(X, tree["feat"], tree["thr"], tree["na_left"],
                    tree["is_split"], max_depth)
    return tree["value"][nid], nid.to(torch.int32)


def predict_raw_margin(X, f0, feat, thr, na_left, is_split, value,
                       max_depth: int, offset=None):
    """``f0`` plus the leaf values of a stack of trees (``feat``/``thr``/
    ... are [T, M]) walked over raw features, added one tree at a time in
    tree order: each row's sum is the same sequence of float32 adds
    whatever the number of rows, so a one-row batch and a whole frame
    give a row the same bits. ``f0`` is a tensor on X's device: 0-d for
    one margin a row ([rows], plus ``offset`` [rows] where given), or
    [K] for K classes, whose stack is in (tree, class) order ([T·K, M]),
    each tree added into column ``t % K`` of the [rows, K] margin."""
    # clone, never contiguous(): a one-row expand is already contiguous,
    # and the adds below would then write into f0 itself
    if f0.dim() == 0:
        margin = f0.expand(X.shape[0]).clone()
        for t in range(feat.shape[0]):
            nid = _walk_raw(X, feat[t], thr[t], na_left[t], is_split[t],
                            max_depth)
            margin += value[t][nid]
        return margin if offset is None else margin + offset
    K = f0.shape[0]
    margin = f0.expand(X.shape[0], K).clone()
    for t in range(feat.shape[0]):
        nid = _walk_raw(X, feat[t], thr[t], na_left[t], is_split[t],
                        max_depth)
        margin[:, t % K] += value[t][nid]
    return margin


def predict_raw_mean(X, zero, feat, thr, na_left, is_split, value,
                     max_depth: int):
    """A forest's mean over a stack of T trees walked over raw features:
    the leaf values added one tree at a time in tree order onto ``zero``
    (``predict_raw_margin``'s f0: a 0-d zero for one value a row, [K]
    zeros for K classes with the stack in (tree, class) order), divided
    by the number of trees a column. The sum's order is fixed, so a
    one-row batch and a whole frame give a row the same bits (the JAX
    package takes the mean in XLA's reduction order)."""
    total = predict_raw_margin(X, zero, feat, thr, na_left, is_split, value,
                               max_depth)
    per_col = feat.shape[0] // (zero.shape[0] if zero.dim() else 1)
    return total / float(max(per_col, 1))


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
