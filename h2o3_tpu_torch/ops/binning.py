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

The streamed (memory-pressure) train bins on the host instead, in numpy
(``_edges_host``, ``digitize_codes_host``, the JAX package's own edge
rules): its design matrix never reaches the device whole.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
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


# ------------------------------------------------------------ host binning


def _per_column(fn, F: int) -> list:
    """``[fn(0), ..., fn(F-1)]``, the columns on a few threads (numpy's
    partition and searchsorted release the interpreter lock); each
    column's result is what one thread would give."""
    workers = max(1, min(8, os.cpu_count() or 1, F))
    if workers == 1:
        return [fn(f) for f in range(F)]
    with cf.ThreadPoolExecutor(workers) as ex:
        return list(ex.map(fn, range(F)))


def quantile_edges(col: np.ndarray, nbins: int) -> np.ndarray:
    """The distinct float32 quantile cut points of one feature's finite
    values (``np.quantile`` at the ``nbins - 1`` inner grid points)."""
    vals = col[np.isfinite(col)]
    if vals.size == 0:
        return np.empty(0, dtype=np.float32)
    qs = np.quantile(vals, np.linspace(0.0, 1.0, nbins + 1)[1:-1])
    return np.unique(qs.astype(np.float32))


def uniform_edges(col: np.ndarray, nbins: int) -> np.ndarray:
    """Equal-width cut points between one feature's finite min and max;
    none where they are equal."""
    vals = col[np.isfinite(col)]
    if vals.size == 0:
        return np.empty(0, dtype=np.float32)
    lo, hi = float(vals.min()), float(vals.max())
    if lo == hi:
        return np.empty(0, dtype=np.float32)
    return np.linspace(lo, hi, nbins + 1)[1:-1].astype(np.float32)


def _edges_host(X_host: np.ndarray, nrow: int, is_cat: Sequence[bool],
                nbins: int, nbins_cats: int, histogram_type: str):
    """The JAX package's host edge rules over ``X_host[:nrow]``: a
    categorical column of cardinality <= ``nbins_cats`` gets one bin a
    level, a wider one quantile groups of its codes; a numeric column
    equal-width edges (``uniform_adaptive``, ``uniform``) or quantile
    edges, at most ``nbins - 1``. Returns (edges, n_bins_eff), the bin
    count the widest feature needs, at least ``nbins``."""
    edge_fn = (uniform_edges
               if histogram_type in ("uniform_adaptive", "uniform")
               else quantile_edges)

    def edges_of(f: int) -> np.ndarray:
        col = np.ascontiguousarray(X_host[:nrow, f])
        if is_cat[f]:
            card = int(np.nanmax(col)) + 1 if np.isfinite(col).any() else 1
            if card <= nbins_cats:
                return np.arange(1, card, dtype=np.float32) - 0.5
            return quantile_edges(col, nbins_cats)
        return edge_fn(col, nbins)[: nbins - 1]

    edges = _per_column(edges_of, X_host.shape[1])
    n_bins_eff = max(nbins, max((len(e) + 1 for e in edges), default=2))
    if n_bins_eff > 16382:
        raise ValueError(
            f"effective bin count {n_bins_eff} exceeds the 14-bit routing "
            f"limit; lower nbins_cats (reference default is 1024)")
    return edges, n_bins_eff


# up to this many edges a feature digitises by counting (exact, as
# searchsorted: the padded edges are sorted, finite or +inf)
_COUNT_EDGES = 64


def digitize_codes_host(X_host: np.ndarray, edges: List[np.ndarray],
                        n_bins_eff: int):
    """Packed codes of a host matrix under ``edges``, in numpy: the
    inf-padded edge matrix of ``digitize_with_edges`` searched per
    feature (side "right"), NA in the reserved lane ``W-1``, narrowed to
    the kernel dtype, so that they equal the device path's packed codes
    bit for bit. Returns (codes [rows, F], W)."""
    X_host = np.asarray(X_host, dtype=np.float32)
    W = pick_W(n_bins_eff)
    np_dt = np.int8 if code_dtype(W) == torch.int8 else np.int16
    emat = _edge_matrix(edges)
    # a feature's codes are one contiguous row of the transpose; the
    # [rows, F] layout is one copy at the end
    codes_t = np.empty(X_host.shape[::-1], np_dt)

    def digitize(f: int) -> None:
        col = np.ascontiguousarray(X_host[:, f])
        if emat.shape[1] <= _COUNT_EDGES:
            # searchsorted(side="right") is the count of edges <= x: one
            # pass an edge beats a binary search a value at a few edges
            c = np.zeros(col.shape, np_dt)
            for e in emat[f]:
                c += col >= e
        else:
            c = np.searchsorted(emat[f], col, side="right")
        codes_t[f] = np.where(np.isnan(col), W - 1, c).astype(np_dt)

    _per_column(digitize, X_host.shape[1])
    return np.ascontiguousarray(codes_t.T), W
