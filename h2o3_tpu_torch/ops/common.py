"""What the dispatching modules (``ops/hist_adaptive.py``,
``ops/histogram.py``) share: the device dispatch, and the scatter-add
histogram that every plain version of a histogram kernel ends in, in
its float and its int8 fixed-point form."""
from __future__ import annotations

import torch


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
