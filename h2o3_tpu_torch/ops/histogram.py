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


def _build3(codes, seg, ghw, n_nodes: int, n_bins1: int, bf16: bool):
    return dispatch("build_histograms", codes, build_histograms_plain,
                    kernels.global_hist, codes, seg, ghw, n_nodes, n_bins1,
                    bf16)


def build_histograms(codes, seg, ghw, n_nodes: int, n_bins1: int,
                     bf16: bool = False):
    """The (g, h, w) histogram triple, each [n_nodes, F, n_bins1]: the
    plain version for CPU tensors, the CUDA kernel for CUDA tensors."""
    hist = _build3(codes, seg, ghw, n_nodes, n_bins1, bf16)
    return hist[0], hist[1], hist[2]


def build_histograms_sharded(codes, seg, ghw, n_nodes: int, n_bins1: int,
                             mesh=None, bf16: bool = False, marks=None):
    """The histogram of rows sharded over the mesh's data axis (the JAX
    package's ``build_histograms_sharded``): ``codes``, ``seg`` and
    ``ghw`` are lists of per-shard blocks, one a local data shard, each
    on its shard's device; one build a shard (the K11 kernel on the
    card), then the data-axis ``psum`` (``parallel/collectives``: in
    shard order on the lead shard's device, then across processes).
    ``marks`` (``shardstats.StepMarks``) records each shard's
    completion. Returns the (g, h, w) triple on the lead shard's
    device; one shard is ``build_histograms``."""
    from h2o3_tpu_torch.parallel.collectives import psum
    from h2o3_tpu_torch.parallel.mesh import on_device
    parts = []
    for c, s, gh in zip(codes, seg, ghw):
        with on_device(c.device):
            parts.append(_build3(c, s, gh, n_nodes, n_bins1, bf16))
        if marks is not None:
            marks.shard_done(c.device)
    hist = psum(parts, mesh, lead_only=True)[0]
    return hist[0], hist[1], hist[2]
