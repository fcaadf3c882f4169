"""Tree level functions — plain PyTorch versions and their dispatchers.

Counterpart of ``h2o3_tpu/ops/hist_adaptive.py``. Two families share
one routing and histogram contract:

**Packed codes** (``binned_level``, ``binned_route_only``). Codes are
``[rows, F]`` int8 (W <= 128) or int16 (W == 256) with values in
``[0, W-2]`` and NA in the reserved last lane ``W-1``. Split tables are
one int32 ``[4, max(n_prev, 1)]`` tensor holding, per node of the
previous level, the split feature, the split bin, na_left and can-split.
A row whose node can split reads ``code = codes[row, feat]``; NA goes
right unless na_left, any other code goes right when
``code >= split_bin``.

**Adaptive bins** (``adaptive_level``, ``adaptive_route_only``), H2O's
``UniformAdaptive``: raw float32 features (NaN = NA) in one of two
layouts, ``"rows_f"`` ``[rows, F]`` or ``"f_rows"`` ``[F, rows]``. Split
tables are one float32 ``[4, max(n_prev, 1)]`` tensor (feat, raw
threshold, na_left, can as floats, the JAX package's spelling). A row
whose node can split (``can > 0.5``) reads ``x = x[row, feat]``; NaN
goes right unless ``na_left > 0.5``, any other value goes right when
``x >= thr``. The level then bins every feature per (node, feature)
range: ``bin = floor(clip((x - lo) * inv, 0, W-2))`` with NaN in lane
``W-1``. On a zero-span node (``inv = 0``) an infinite x gives
``(±inf - lo) * 0 = NaN``: that row takes bin 0, as the JAX package's
CPU reference does (its ``astype(int32)`` of NaN).

In both, the child is ``2*nid + 1 + right``, and the histogram adds each
row's (g, h, w) into the (node, feature, bin) cell of every feature for
the rows whose new node lies in ``[level_base, level_base + n_nodes)``.
With ``bf16=True`` each of g, h and w is rounded to bfloat16 (round to
nearest even) before the float32 add, which reproduces the TPU kernel's
exact bf16 one-hot product.

**int8 fixed-point masses** (``H2O3_HIST_I8``, the reference's opt-in):
``quantize_ghw_i8`` encodes a tree's (g, h, w) once as int8 ``q``
[3·terms, rows] with float32 scales [3]; ``binned_level`` and
``adaptive_level`` given ``qs = (q, scales)`` send every level with
``3·terms·n_nodes <= 128`` (at bf16) to an int8 level, which routes and
bins as the float level does, sums ``q`` exactly in integers and
flushes to float32 (``common.flush_i8``). Integer sums leave no room
for order: kernel, plain version and the TPU kernel give the same bits.

**Leaf totals** (``leaf_totals``): route one adaptive level and sum
float32 (g, h, w) per node of the window. As in the JAX package, no
grower calls it with a route; its instance without one
(``common.segment_totals``) sums the packed and global-sketch growers'
deepest level.

The dispatchers send CPU tensors to the plain versions and CUDA tensors
to the hand-written kernels (``ops/kernels.py``); anything else raises.
"""
from __future__ import annotations

import torch

from h2o3_tpu_torch.ops import kernels
from h2o3_tpu_torch.ops.common import (dispatch, level_hist_i8_plain,
                                       level_hist_plain)

LAYOUTS = ("rows_f", "f_rows")
# the int8 levels' row cap: int32 sums of |q| <= 127 cannot overflow
I8_MAX_ROWS = 16_000_000


def pick_W(nbins: int) -> int:
    """Smallest supported lane width for ``nbins`` real bins plus the NA
    lane."""
    for w in (16, 32, 64, 128, 256):
        if nbins <= w - 2:
            return w
    raise ValueError(f"nbins {nbins} exceeds the packed kernel's 254-bin "
                     f"cap")


def code_dtype(W: int) -> torch.dtype:
    """Smallest integer dtype for codes in ``[0, W-1]``: int8 holds
    W <= 128, int16 the 256-lane case."""
    return torch.int8 if W <= 128 else torch.int16


def make_tables(feat, split_bin, na_left, can) -> torch.Tensor:
    """Stack one level's split record into the int32 [4, n] routing
    table the packed level functions take."""
    return torch.stack([torch.as_tensor(t).to(torch.int32)
                        for t in (feat, split_bin, na_left, can)])


def make_adaptive_tables(feat, thr, na_left, can) -> torch.Tensor:
    """Stack one level's split record into the float32 [4, n] routing
    table the adaptive level functions take."""
    return torch.stack([torch.as_tensor(t).to(torch.float32)
                        for t in (feat, thr, na_left, can)])


def rows_features(x: torch.Tensor, layout: str):
    """(rows, F) of a feature matrix in ``layout``."""
    if layout == "rows_f":
        return x.shape[0], x.shape[1]
    if layout == "f_rows":
        return x.shape[1], x.shape[0]
    raise ValueError(f"unknown layout {layout!r}; expected one of "
                     f"{LAYOUTS}")


def _as_rows_f(x: torch.Tensor, layout: str) -> torch.Tensor:
    rows_features(x, layout)
    return x if layout == "rows_f" else x.t()


def _route_plain(codes, nid, tables, n_prev: int, level_base: int, W: int):
    F = codes.shape[1]
    prev_base = level_base - n_prev
    lid_p = (nid - prev_base).clamp(0, n_prev - 1).long()
    in_prev = (nid >= prev_base) & (nid < prev_base + n_prev)
    feat = tables[0][lid_p].clamp(0, F - 1).long()
    csel = codes.gather(1, feat[:, None])[:, 0].to(torch.int32)
    right = torch.where(csel == W - 1, tables[2][lid_p] == 0,
                        csel >= tables[1][lid_p])
    child = 2 * nid + 1 + right.to(torch.int32)
    return torch.where(in_prev & (tables[3][lid_p] != 0), child, nid)


def _adaptive_route_plain(x, nid, tables, n_prev: int, level_base: int):
    """Raw-threshold route of ``x`` [rows, F] (any strides)."""
    F = x.shape[1]
    prev_base = level_base - n_prev
    lid_p = (nid - prev_base).clamp(0, n_prev - 1).long()
    in_prev = (nid >= prev_base) & (nid < prev_base + n_prev)
    feat = tables[0][lid_p].to(torch.int32).clamp(0, F - 1).long()
    xsel = x.gather(1, feat[:, None])[:, 0]
    right = torch.where(torch.isnan(xsel), tables[2][lid_p] < 0.5,
                        xsel >= tables[1][lid_p])
    child = 2 * nid + 1 + right.to(torch.int32)
    return torch.where(in_prev & (tables[3][lid_p] > 0.5), child, nid)


def quantize_ghw_i8(ghw, terms: int = 1):
    """Per-tree int8 fixed-point encoding of (g, h, w) rows, the JAX
    package's ``quantize_ghw_i8`` in the same float32 operations:
    ``amax = max(max|v|, 1e-30)`` per component; one term: ``s = amax /
    127``, ``q = clip(round(v / s), ±127)``; two (any other ``terms``, as
    there): ``s = amax / 32639``, ``q16 = clip(round(v / s), ±32639)``,
    ``a = floor((q16 + 128) / 256)``, ``b = q16 - 256·a`` (b stays in
    [-128, 127]), rows ``[a_g, b_g, a_h, b_h, a_w, b_w]``. ``round`` is
    half to even. Returns (q [3·terms, rows] int8, scales [3]
    float32)."""
    ghw = ghw.to(torch.float32)
    amax = torch.clamp(ghw.abs().amax(dim=1), min=1e-30)
    if terms == 1:
        s = amax / 127.0
        q = torch.clamp(torch.round(ghw / s[:, None]), -127, 127)
        return q.to(torch.int8), s
    s = amax / 32639.0
    q16 = torch.clamp(torch.round(ghw / s[:, None]), -32639, 32639)
    a = torch.floor((q16 + 128.0) / 256.0)
    b = q16 - 256.0 * a
    q = torch.stack([a[0], b[0], a[1], b[1], a[2], b[2]])
    return q.to(torch.int8), s


def binned_level_plain(codes, nid, ghw, tables, n_prev: int, n_nodes: int,
                       level_base: int, W: int, bf16: bool = False):
    """Plain version of the packed level kernel: scatter-add histogram in
    row order. Returns (nid' [rows] int32, hist [3, n_nodes, F, W] in
    ghw's dtype)."""
    if n_prev > 0:
        nid = _route_plain(codes, nid, tables, n_prev, level_base, W)
    return nid, level_hist_plain(nid, codes.long(), ghw, n_nodes,
                                 level_base, W, bf16)


def binned_level_i8_plain(codes, nid, q, scales, tables, n_prev: int,
                          n_nodes: int, level_base: int, W: int):
    """Plain version of the packed int8 level kernel (K4): the packed
    route, then ``q`` [3·terms, rows] int8 summed exactly per (node,
    feature, code) and flushed with ``scales`` [3]. Returns (nid' [rows]
    int32, hist [3, n_nodes, F, W] float32)."""
    if n_prev > 0:
        nid = _route_plain(codes, nid, tables, n_prev, level_base, W)
    return nid, level_hist_i8_plain(nid, codes.long(), q, scales, n_nodes,
                                    level_base, W)


def binned_route_only_plain(codes, nid, tables, n_prev: int, level_base: int,
                            W: int):
    """Plain version of the packed deepest-level route kernel."""
    return _route_plain(codes, nid, tables, n_prev, level_base, W)


def adaptive_bins_plain(x, nid, lo, inv, n_nodes: int, level_base: int,
                        W: int):
    """Per-(node, feature) uniform bins of ``x`` [rows, F]: NaN -> W-1,
    else ``floor(clip((x - lo) * inv, 0, W-2))`` under the row's node
    range; a NaN product (an infinite x on a zero-span node) -> bin 0.
    Rows outside the level's window read node 0's range (their mass is
    masked off by the histogram). int64 [rows, F]."""
    lid = nid - level_base
    lidc = torch.where((lid >= 0) & (lid < n_nodes), lid, 0).long()
    v = (x - lo[lidc]) * inv[lidc]
    # torch turns NaN into INT_MIN on the int cast; the JAX CPU
    # reference and the kernel give 0 — say so explicitly
    v = torch.where(torch.isnan(v), 0.0, v)
    b = torch.floor(torch.clamp(v, 0.0, float(W - 2))).long()
    return torch.where(torch.isnan(x), W - 1, b)


def adaptive_level_plain(x, nid, ghw, tables, lo, inv, n_prev: int,
                         n_nodes: int, level_base: int, W: int,
                         bf16: bool = False, layout: str = "rows_f"):
    """Plain version of the adaptive level kernel (K5 in the ``"f_rows"``
    layout, K8 in ``"rows_f"``): raw-threshold route, per-node re-bin,
    scatter-add histogram in row order. ``lo``/``inv`` are [n_nodes, F]
    float32. Returns (nid' [rows] int32, hist [3, n_nodes, F, W] in
    ghw's dtype)."""
    xr = _as_rows_f(x, layout)
    if n_prev > 0:
        nid = _adaptive_route_plain(xr, nid, tables, n_prev, level_base)
    bins = adaptive_bins_plain(xr, nid, lo, inv, n_nodes, level_base, W)
    return nid, level_hist_plain(nid, bins, ghw, n_nodes, level_base, W,
                                 bf16)


def adaptive_level_i8_plain(x, nid, q, scales, tables, lo, inv, n_prev: int,
                            n_nodes: int, level_base: int, W: int,
                            layout: str = "rows_f"):
    """Plain version of the adaptive int8 level kernel (K7, in either
    layout): the adaptive route and re-bin, then ``q`` summed exactly and
    flushed as in ``binned_level_i8_plain``."""
    xr = _as_rows_f(x, layout)
    if n_prev > 0:
        nid = _adaptive_route_plain(xr, nid, tables, n_prev, level_base)
    bins = adaptive_bins_plain(xr, nid, lo, inv, n_nodes, level_base, W)
    return nid, level_hist_i8_plain(nid, bins, q, scales, n_nodes,
                                    level_base, W)


def leaf_totals_plain(x, nid, ghw, tables, n_prev: int, n_nodes: int,
                      level_base: int):
    """Plain version of the leaf-totals kernel (K10): route one level of
    ``x`` [rows, F] by raw threshold (none when ``n_prev`` is 0), then
    sum each row's (g, h, w) into its node of the window, in row order
    and in ghw's dtype. Returns (nid' [rows] int32, totals [3,
    n_nodes])."""
    if n_prev > 0:
        nid = _adaptive_route_plain(x, nid, tables, n_prev, level_base)
    lid = nid - level_base
    in_lvl = (lid >= 0) & (lid < n_nodes)
    lidc = torch.where(in_lvl, lid, 0).long()
    vals = ghw.t() * in_lvl.to(ghw.dtype)[:, None]
    tot = torch.zeros(n_nodes, 3, dtype=ghw.dtype, device=x.device)
    tot.index_add_(0, lidc, vals)
    return nid, tot.t().contiguous()


def adaptive_route_only_plain(x, nid, tables, n_prev: int, level_base: int,
                              layout: str = "rows_f"):
    """Plain version of the adaptive deepest-level route kernel (K6 in
    ``"f_rows"``, K9 in ``"rows_f"``)."""
    return _adaptive_route_plain(_as_rows_f(x, layout), nid, tables,
                                 n_prev, level_base)


def takes_i8(qs, n_nodes: int, bf16: bool) -> bool:
    """Whether a level with ``qs`` takes the int8 form: the reference's
    gate, ``3·terms·n_nodes <= 128`` at bf16 histograms."""
    return qs is not None and bf16 and qs[0].shape[0] * n_nodes <= 128


def binned_level(codes, nid, ghw, tables, n_prev: int, n_nodes: int,
                 level_base: int, W: int, bf16: bool = False, qs=None):
    """One packed-code tree level: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors (float masses: rows grouped by parent,
    sums in a fixed order, on the tensor cores below W = 64 and as the
    wide body's scatter at W = 64, 128, 256). ``qs`` (q, scales) from
    ``quantize_ghw_i8`` sends the level to the int8 form where
    ``takes_i8`` holds."""
    if takes_i8(qs, n_nodes, bf16):
        return dispatch("binned_level_i8", codes, binned_level_i8_plain,
                        kernels.binned_level_i8, codes, nid, qs[0], qs[1],
                        tables, n_prev, n_nodes, level_base, W)
    return dispatch("binned_level", codes, binned_level_plain,
                    kernels.binned_level, codes, nid, ghw, tables, n_prev,
                    n_nodes, level_base, W, bf16)


def binned_route_only(codes, nid, tables, n_prev: int, level_base: int,
                      W: int):
    """The packed deepest level's route: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    return dispatch("binned_route_only", codes, binned_route_only_plain,
                    kernels.binned_route_only, codes, nid, tables, n_prev,
                    level_base, W)


def adaptive_level(x, nid, ghw, tables, lo, inv, n_prev: int, n_nodes: int,
                   level_base: int, W: int, bf16: bool = False,
                   layout: str = "rows_f", qs=None):
    """One adaptive-bin tree level: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors; ``qs`` as in ``binned_level``, in
    either layout."""
    if takes_i8(qs, n_nodes, bf16):
        return dispatch("adaptive_level_i8", x, adaptive_level_i8_plain,
                        kernels.adaptive_level_i8, x, nid, qs[0], qs[1],
                        tables, lo, inv, n_prev, n_nodes, level_base, W,
                        layout)
    return dispatch("adaptive_level", x, adaptive_level_plain,
                    kernels.adaptive_level, x, nid, ghw, tables, lo, inv,
                    n_prev, n_nodes, level_base, W, bf16, layout)


def adaptive_route_only(x, nid, tables, n_prev: int, level_base: int,
                        layout: str = "rows_f"):
    """The adaptive deepest level's route: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    return dispatch("adaptive_route_only", x, adaptive_route_only_plain,
                    kernels.adaptive_route_only, x, nid, tables, n_prev,
                    level_base, layout)


def leaf_totals(x, nid, ghw, tables, n_prev: int, n_nodes: int,
                level_base: int):
    """Route one adaptive level and sum (g, h, w) per node: the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors."""
    return dispatch("leaf_totals", x, leaf_totals_plain, kernels.leaf_totals,
                    x, nid, ghw, tables, n_prev, n_nodes, level_base)
