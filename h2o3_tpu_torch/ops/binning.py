"""Global quantile binning: feature values to small integer bin codes.

Counterpart of ``h2o3_tpu/ops/binning.py`` (the device sketch and the
packed-code layout). One pass sorts each feature on the device and
fetches only O(F) statistics and the quantile neighbour values; the
float64 interpolation and the unique/truncate bookkeeping run on the
host, so edges are bit-exact to ``np.quantile`` and to the JAX package.
A second pass digitises every value into a code.

Layout: codes ``[rows, F]`` with values in ``[0, n_bins)``; NA is the
shared last index ``n_bins``. Split "bin t" means left <=> code < t <=>
raw < edges[t-1]. The packed form used by the tree level moves NA to the
reserved lane ``W-1`` and narrows the codes to int8 (W <= 128) or int16.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.ops.hist_adaptive import code_dtype, pick_W


@dataclass
class BinnedMatrix:
    codes: torch.Tensor        # [rows, F], NA bin = n_bins
    n_bins: int                # bins per feature excluding the NA bin
    edges: List[np.ndarray]    # per-feature raw split edges (<= n_bins-1)
    names: List[str]
    is_categorical: List[bool]


class PackedCodes(NamedTuple):
    """Codes in the level kernels' layout: ``rm`` [rows, F] int8/int16
    with NA in the reserved last lane ``W-1``."""
    rm: torch.Tensor
    W: int

    @property
    def itemsize(self) -> int:
        return self.rm.element_size()


def _sketch_stats(X: torch.Tensor):
    """Device half of the sketch: a finite-masked sort per feature (±inf
    become NaN, which sorts last on CPU and CUDA alike) plus the finite
    count, min and max per feature."""
    Xf = torch.where(torch.isfinite(X), X.to(torch.float32), torch.nan)
    Xs = torch.sort(Xf, dim=0).values
    nfin = (~torch.isnan(Xf)).sum(dim=0).to(torch.int64)
    fmax = Xs.gather(0, (nfin - 1).clamp(min=0)[None, :])[0]
    return Xs, nfin, Xs[0], fmax


def _gather_rank_pairs(Xs: torch.Tensor, lo_idx: torch.Tensor,
                       hi_idx: torch.Tensor):
    """The quantile neighbour values; the lerp happens on the host."""
    return Xs.gather(0, lo_idx), Xs.gather(0, hi_idx)


def _np_quantile_lerp(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """numpy's _lerp on float32 neighbours with float64 t, so edges match
    ``np.quantile(vals, qs)`` bit for bit (copied from the JAX package)."""
    diff = np.subtract(b, a)                 # float32, like numpy's _lerp
    out = np.add(a, diff * t)                # promotes to float64
    hi = t >= 0.5
    if hi.any():
        out[hi] = (b - diff * (1.0 - t))[hi]
    return out


def bin_matrix_device(X: torch.Tensor, names: Sequence[str],
                      is_cat: Sequence[bool], nbins: int = 255,
                      nbins_cats: int = 1024,
                      histogram_type: str = "quantiles_global"
                      ) -> BinnedMatrix:
    """Edges and codes for a float32 [rows, F] matrix (NaN = NA) on its
    own device. ``histogram_type`` is ``quantiles_global`` (quantile
    edges) or ``uniform_adaptive``/``uniform`` (equal-width edges between
    the finite min and max). Categorical columns of cardinality <=
    ``nbins_cats`` get one bin per category."""
    F = X.shape[1]
    Xs, nfin_d, fmin_d, fmax_d = _sketch_stats(X)
    nfin, fmin, fmax = (v.cpu().numpy() for v in (nfin_d, fmin_d, fmax_d))
    uniform = histogram_type in ("uniform_adaptive", "uniform")
    qgrids: List[Optional[np.ndarray]] = [None] * F
    for f in range(F):
        n = int(nfin[f])
        if n == 0:
            continue
        if is_cat[f]:
            if int(fmax[f]) + 1 <= nbins_cats:
                continue                     # identity bins
            qs = np.linspace(0.0, 1.0, nbins_cats + 1)[1:-1]
        elif uniform:
            continue                         # min/max only
        else:
            qs = np.linspace(0.0, 1.0, nbins + 1)[1:-1]
        qgrids[f] = qs * (n - 1)             # float64 virtual indexes
    qmax = max((len(v) for v in qgrids if v is not None), default=0)
    quant_vals: List[Optional[np.ndarray]] = [None] * F
    if qmax:
        lo_idx = np.zeros((qmax, F), np.int64)
        hi_idx = np.zeros((qmax, F), np.int64)
        for f, virt in enumerate(qgrids):
            if virt is not None:
                lo_idx[: len(virt), f] = np.floor(virt)
                hi_idx[: len(virt), f] = np.ceil(virt)
        a, b = (v.cpu().numpy() for v in _gather_rank_pairs(
            Xs, torch.as_tensor(lo_idx, device=X.device),
            torch.as_tensor(hi_idx, device=X.device)))
        for f, virt in enumerate(qgrids):
            if virt is not None:
                quant_vals[f] = _np_quantile_lerp(
                    a[: len(virt), f], b[: len(virt), f],
                    virt - np.floor(virt))
    del Xs
    edges: List[np.ndarray] = []
    for f in range(F):
        n = int(nfin[f])
        if is_cat[f]:
            card = int(fmax[f]) + 1 if n > 0 else 1
            if card <= nbins_cats:
                e = np.arange(1, card, dtype=np.float32) - 0.5
            else:
                e = np.unique(quant_vals[f].astype(np.float32))
        elif n == 0:
            e = np.empty(0, dtype=np.float32)
        elif uniform:
            lo, hi = float(fmin[f]), float(fmax[f])
            e = (np.empty(0, dtype=np.float32) if lo == hi
                 else np.linspace(lo, hi, nbins + 1)[1:-1].astype(np.float32))
            e = e[: nbins - 1]
        else:
            e = np.unique(quant_vals[f].astype(np.float32))[: nbins - 1]
        edges.append(e)
    n_bins_eff = max(nbins, max((len(e) + 1 for e in edges), default=2))
    if n_bins_eff > 16382:
        raise ValueError(
            f"effective bin count {n_bins_eff} exceeds the 14-bit routing "
            f"limit; lower nbins_cats (reference default is 1024)")
    return BinnedMatrix(codes=digitize_with_edges(X, edges, n_bins_eff),
                        n_bins=n_bins_eff, edges=edges, names=list(names),
                        is_categorical=list(is_cat))


def _edge_matrix(edges: List[np.ndarray]) -> np.ndarray:
    """Edges padded with +inf to one [F, max_e] matrix: +inf values land
    in the shared lane max_e on every feature."""
    max_e = max((len(e) for e in edges), default=0)
    emat = np.full((len(edges), max(max_e, 1)), np.inf, dtype=np.float32)
    for f, e in enumerate(edges):
        emat[f, : len(e)] = e
    return emat


def digitize_with_edges(X: torch.Tensor, edges: List[np.ndarray],
                        nbins: int) -> torch.Tensor:
    """Codes of a float32 [rows, F] matrix under given edges:
    searchsorted(side="right") per feature, NaN -> ``nbins``. uint8 when
    ``nbins < 256``, else int32 (the JAX package's types)."""
    emat = torch.as_tensor(_edge_matrix(edges), device=X.device)
    dtype = torch.uint8 if nbins < 256 else torch.int32
    codes = torch.empty(X.shape, dtype=dtype, device=X.device)
    for f in range(len(edges)):
        col = X[:, f].to(torch.float32).contiguous()
        c = torch.searchsorted(emat[f], col, right=True)
        codes[:, f] = torch.where(torch.isnan(col), nbins, c).to(dtype)
    return codes


def _repack_codes(c: torch.Tensor, na: int, W: int) -> torch.Tensor:
    """NA code ``na`` -> reserved lane ``W-1``, narrowed to the kernel
    dtype."""
    ci = c.to(torch.int32)
    return torch.where(ci == na, W - 1, ci).to(code_dtype(W))


def pack_codes(bm: BinnedMatrix) -> PackedCodes:
    """Pack a BinnedMatrix's codes for the level kernels."""
    W = pick_W(bm.n_bins)
    return PackedCodes(rm=_repack_codes(bm.codes, bm.n_bins, W), W=W)


def pack_codes_for(X: torch.Tensor, bm: BinnedMatrix,
                   W: Optional[int] = None) -> torch.Tensor:
    """Digitise a new matrix with the training sketch's edges and pack it
    to the kernel convention."""
    W = W or pick_W(bm.n_bins)
    return _repack_codes(digitize_with_edges(X, bm.edges, bm.n_bins),
                         bm.n_bins, W)


def packed_codes_record(pc: Optional[PackedCodes],
                        n_bins: Optional[int] = None) -> dict:
    """``model.output['packed_codes']``, spelled as the JAX package
    spells it; an adaptive train (no packed codes) records
    ``{"enabled": False}``."""
    if pc is None:
        return {"enabled": False}
    return {"enabled": True, "dtype": str(pc.rm.dtype).replace("torch.", ""),
            "W": int(pc.W), "bytes_per_value": int(pc.itemsize),
            "n_bins": int(n_bins), "kernel": "binned_level"}
