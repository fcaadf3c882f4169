"""What the dispatching modules (``ops/hist_adaptive.py``,
``ops/histogram.py``) share: the device dispatch, the scatter-add
histogram that every plain version of a histogram kernel ends in, in
its float and its int8 fixed-point form, the plain versions of two
pieces of the node-grouped kernels (the row grouping and the exact
three-term bf16 split of float32 masses), and the per-node segment
totals of a tree's deepest level with their dispatcher."""
from __future__ import annotations

import torch

from h2o3_tpu_torch.ops import kernels


def level_hist_plain(nid, bins, ghw, n_nodes: int, level_base: int, W: int,
                     bf16: bool):
    """Scatter-add each row's (g, h, w) into the (node, feature, bin)
    cells of the rows in the level's window, in row order. ``bins`` is
    [rows, F] int64 in [0, W). Returns hist [3, n_nodes, F, W] in ghw's
    dtype."""
    rows, F = bins.shape
    lid = nid - level_base
    in_lvl = (lid >= 0) & (lid < n_nodes)
    lidc = torch.where(in_lvl, lid, 0).long()
    fidx = torch.arange(F, device=bins.device)
    flat = (lidc[:, None] * F + fidx[None, :]) * W + bins
    vals = ghw.t()
    if bf16:
        vals = vals.to(torch.bfloat16).to(ghw.dtype)
    vals = vals * in_lvl.to(ghw.dtype)[:, None]
    # the histogram accumulates in ghw's dtype: float32 on the training
    # path; a float64 ghw gives the exact yardstick the kernel checks use
    out = torch.zeros(n_nodes * F * W, 3, dtype=ghw.dtype,
                      device=bins.device)
    out.index_add_(0, flat.reshape(-1),
                   vals[:, None, :].expand(rows, F, 3).reshape(-1, 3))
    return out.reshape(n_nodes, F, W, 3).permute(3, 0, 1, 2).contiguous()


def level_hist_i8_plain(nid, bins, q, scales, n_nodes: int, level_base: int,
                        W: int):
    """``level_hist_plain`` on int8 fixed-point masses: each row's
    ``q`` [3·terms, rows] is added exactly in int64 into the (term, node,
    feature, bin) cells of the rows in the level's window, then flushed
    to float32 by ``flush_i8``. Returns hist [3, n_nodes, F, W]
    float32."""
    rows, F = bins.shape
    lid = nid - level_base
    in_lvl = (lid >= 0) & (lid < n_nodes)
    lidc = torch.where(in_lvl, lid, 0).long()
    fidx = torch.arange(F, device=bins.device)
    flat = ((lidc[:, None] * F + fidx[None, :]) * W + bins).reshape(-1)
    vals = q.long() * in_lvl.long()[None, :]
    # one 1-D scatter per plane: on the CPU a few times faster than one
    # scatter of [rows·F, planes] rows
    acc = torch.stack([
        torch.zeros(n_nodes * F * W, dtype=torch.int64,
                    device=bins.device).index_add_(
            0, flat, v[:, None].expand(rows, F).reshape(-1))
        for v in vals])
    return flush_i8(acc.reshape(-1, n_nodes, F, W), scales)


def flush_i8(acc, scales):
    """The int8 level kernels' flush (the TPU kernels' ``_flush``): an
    integer sum [3·terms, ...] to float32 [3, ...]. One term:
    ``s_c · f32(Σq_c)``; two: ``s_c · (256 · f32(Σa_c) + f32(Σb_c))``,
    the high and low sums converted apart, as the reference does (at
    10M rows |Σa| passes 2^24 and rounds)."""
    accf = acc.to(torch.float32)
    s = scales.reshape(3, *([1] * (acc.dim() - 1)))
    if acc.shape[0] == 3:
        return (s * accf).contiguous()
    return (s * (256.0 * accf[0::2] + accf[1::2])).contiguous()


def dispatch(name: str, t, plain, kernel, *args):
    """``plain(*args)`` when ``t`` lies on the CPU, ``kernel(*args)`` when
    it lies on a CUDA device; any other device raises."""
    if t.device.type == "cpu":
        return plain(*args)
    if t.device.type == "cuda":
        return kernel(*args)
    raise ValueError(f"{name}: unsupported device {t.device}")


def group_rows_plain(keys, n_groups: int):
    """Plain version of the kernels' row grouping (``kernels.group_rows``,
    ``csrc/level_common.cuh``): a stable sort of the rows by ``keys``
    (int32 [rows]; a key outside [0, n_groups) leaves its row out).
    Returns (offsets int32 [n_groups + 1], idx int32 [rows]): the kept
    rows' ids, key 0's first, each key's in ascending order, then -1."""
    rows = keys.shape[0]
    kept = (keys >= 0) & (keys < n_groups)
    order = torch.argsort(torch.where(kept, keys, n_groups).long(),
                          stable=True)
    counts = torch.bincount(keys[kept].long(), minlength=n_groups)
    offsets = torch.zeros(n_groups + 1, dtype=torch.int64,
                          device=keys.device)
    offsets[1:] = torch.cumsum(counts, 0)
    idx = torch.where(torch.arange(rows, device=keys.device) < offsets[-1],
                      order, -1)
    return offsets.to(torch.int32), idx.to(torch.int32)


def split3_bf16(t):
    """The exact three-term bf16 split of float32 ``t`` (the JAX package's
    ``_split3_bf16``, the node-grouped adaptive level's float32 masses):
    ``hi`` = t rounded to bf16, ``mid`` = the residual scaled by 2^8 and
    rounded, ``lo`` = the rest scaled by 2^8, so that t == hi + (mid / 2^8
    + lo / 2^16) for every finite t whose bf16 rounding is finite, each
    term bf16-valued. Returns the [3, ...] float32 stack (hi, mid, lo)."""
    t = t.to(torch.float32)
    hi = t.to(torch.bfloat16).to(torch.float32)
    r1 = (t - hi) * 256.0
    mid = r1.to(torch.bfloat16).to(torch.float32)
    lo = (r1 - mid) * 256.0
    return torch.stack([hi, mid, lo])


def segment_totals_plain(nid, ghw, n_nodes: int, level_base: int):
    """Plain version of the segment-totals kernel (``kernels.segment_totals``,
    the leaf-totals kernel without a route): the (g, h, w) sums of the
    rows whose ``nid`` lies in ``[level_base, level_base + n_nodes)``, per
    node, in one weighted bincount in ghw's dtype. ``ghw`` is [3, rows].
    Returns totals [3, n_nodes]."""
    local = nid - level_base
    valid = (local >= 0) & (local < n_nodes)
    lid = local.clamp(0, n_nodes - 1).long()
    vals = torch.where(valid[None, :], ghw, 0.0).t()
    idx = lid[:, None] * 3 + torch.arange(3, device=ghw.device)
    tot = torch.bincount(idx.reshape(-1), weights=vals.reshape(-1),
                         minlength=3 * n_nodes).reshape(n_nodes, 3)
    return tot.t().to(ghw.dtype).contiguous()


def segment_totals(nid, ghw, n_nodes: int, level_base: int):
    """Per-node (g, h, w) sums of a level's rows: the plain version for
    CPU tensors, the CUDA kernel (sums in a fixed order) for CUDA
    tensors."""
    return dispatch("segment_totals", nid, segment_totals_plain,
                    kernels.segment_totals, nid, ghw, n_nodes, level_base)
