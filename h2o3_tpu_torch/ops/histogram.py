"""Per-(node, feature, bin) gradient histograms of the global-sketch
grower.

Counterpart of ``h2o3_tpu/ops/histogram.py``. Contract:
``build_histograms(codes, seg, ghw, n_nodes, n_bins1, bf16)`` returns the
``(g, h, w)`` triple, each ``[n_nodes, F, n_bins1]`` float32, from codes
``[rows, F]`` (uint8 or int32 with values in ``[0, n_bins1)``, NA in the
last bin, as ``ops/binning.digitize_with_edges`` gives them), per-row
node ids ``seg`` int32 ``[rows]`` and ``ghw`` float32 ``[3, rows]``. A row
whose seg lies outside ``[0, n_nodes)`` is excluded. With ``bf16`` each
of g, h and w is rounded to bfloat16 before the float32 add, as the TPU
kernel rounds its left operand (its one-hots are exact).

The dispatcher sends CPU tensors to the plain version and CUDA tensors to
the hand-written kernel (``ops/kernels.global_hist``); anything else
raises. Neither needs the TPU kernel's transposed, padded codes.
"""
from __future__ import annotations

from h2o3_tpu_torch.ops import kernels
from h2o3_tpu_torch.ops.common import dispatch, level_hist_plain


def build_histograms_plain(codes, seg, ghw, n_nodes: int, n_bins1: int,
                           bf16: bool = False):
    """Plain version of the global-sketch histogram (the counterpart of
    the JAX package's ``_hist_scatter3``): scatter-add in row order.
    Returns hist [3, n_nodes, F, n_bins1] in ghw's dtype."""
    return level_hist_plain(seg, codes.long(), ghw, n_nodes, 0, n_bins1,
                            bf16)


def build_histograms(codes, seg, ghw, n_nodes: int, n_bins1: int,
                     bf16: bool = False):
    """The (g, h, w) histogram triple, each [n_nodes, F, n_bins1]: the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    hist = dispatch("build_histograms", codes, build_histograms_plain,
                    kernels.global_hist, codes, seg, ghw, n_nodes, n_bins1,
                    bf16)
    return hist[0], hist[1], hist[2]
