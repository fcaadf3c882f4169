"""The packed-code tree level: route + histogram, and the deepest-level
route — plain PyTorch versions and their dispatchers.

Counterpart of the binned half of ``h2o3_tpu/ops/hist_adaptive.py``.
Codes are ``[rows, F]`` int8 (W <= 128) or int16 (W == 256) with values
in ``[0, W-2]`` and NA in the reserved last lane ``W-1``. Split tables
are one int32 ``[4, max(n_prev, 1)]`` tensor holding, per node of the
previous level, the split feature, the split bin, na_left and can-split.

Routing: a row in the previous level's window whose node can split reads
``code = codes[row, feat]``; NA goes right unless na_left, any other code
goes right when ``code >= split_bin``; the child is ``2*nid + 1 + right``.
The histogram adds each row's (g, h, w) into the (node, feature, code)
bin of every feature for the rows whose new node lies in
``[level_base, level_base + n_nodes)``. With ``bf16=True`` each of g, h
and w is rounded to bfloat16 (round to nearest even) before the float32
add, which reproduces the TPU kernel's exact bf16 one-hot product.

The dispatchers send CPU tensors to the plain versions and CUDA tensors
to the hand-written kernels (``ops/kernels.py``); anything else raises.
"""
from __future__ import annotations

import torch

from h2o3_tpu_torch.ops import kernels


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
    table the level functions take."""
    return torch.stack([torch.as_tensor(t).to(torch.int32)
                        for t in (feat, split_bin, na_left, can)])


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


def binned_level_plain(codes, nid, ghw, tables, n_prev: int, n_nodes: int,
                       level_base: int, W: int, bf16: bool = False):
    """Plain version of the level kernel: scatter-add histogram in row
    order. Returns (nid' [rows] int32, hist [3, n_nodes, F, W] in ghw's
    dtype)."""
    rows, F = codes.shape
    if n_prev > 0:
        nid = _route_plain(codes, nid, tables, n_prev, level_base, W)
    lid = nid - level_base
    in_lvl = (lid >= 0) & (lid < n_nodes)
    lidc = torch.where(in_lvl, lid, 0).long()
    fidx = torch.arange(F, device=codes.device)
    flat = (lidc[:, None] * F + fidx[None, :]) * W + codes.long()
    vals = ghw.t()
    if bf16:
        vals = vals.to(torch.bfloat16).to(ghw.dtype)
    vals = vals * in_lvl.to(ghw.dtype)[:, None]
    # the histogram accumulates in ghw's dtype: float32 on the training
    # path; a float64 ghw gives the exact yardstick the kernel checks use
    out = torch.zeros(n_nodes * F * W, 3, dtype=ghw.dtype,
                      device=codes.device)
    out.index_add_(0, flat.reshape(-1),
                   vals[:, None, :].expand(rows, F, 3).reshape(-1, 3))
    return nid, out.reshape(n_nodes, F, W, 3).permute(3, 0, 1, 2).contiguous()


def binned_route_only_plain(codes, nid, tables, n_prev: int, level_base: int,
                            W: int):
    """Plain version of the deepest-level route kernel."""
    return _route_plain(codes, nid, tables, n_prev, level_base, W)


def binned_level(codes, nid, ghw, tables, n_prev: int, n_nodes: int,
                 level_base: int, W: int, bf16: bool = False):
    """One packed-code tree level: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    if codes.device.type == "cpu":
        return binned_level_plain(codes, nid, ghw, tables, n_prev, n_nodes,
                                  level_base, W, bf16)
    if codes.device.type == "cuda":
        return kernels.binned_level(codes, nid, ghw, tables, n_prev,
                                    n_nodes, level_base, W, bf16)
    raise ValueError(f"binned_level: unsupported device {codes.device}")


def binned_route_only(codes, nid, tables, n_prev: int, level_base: int,
                      W: int):
    """The deepest level's route: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    if codes.device.type == "cpu":
        return binned_route_only_plain(codes, nid, tables, n_prev,
                                       level_base, W)
    if codes.device.type == "cuda":
        return kernels.binned_route_only(codes, nid, tables, n_prev,
                                         level_base, W)
    raise ValueError(f"binned_route_only: unsupported device "
                     f"{codes.device}")
