"""Frame — named columns on one device.

Counterpart of ``h2o3_tpu/frame/frame.py``: construction from numpy and
from parsed typed columns (one host-to-device copy per dtype group),
the shape and type accessors, column and row selection, ``split_frame``
with the reference's draw, and the float32 matrix the model builders
take.
"""
from __future__ import annotations

import concurrent.futures as cf
import os
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from h2o3_tpu_torch import _device
from h2o3_tpu_torch.frame.vec import (T_ENUM, T_STR, T_TIME, TIME_NA, Vec,
                                      _numeric_host_copy)


class Frame:
    def __init__(self, names: Sequence[str], vecs: Sequence[Vec],
                 key: Optional[str] = None):
        if len(names) != len(vecs):
            raise ValueError("one name per column")
        if len({v.nrow for v in vecs}) > 1:
            raise ValueError("column lengths differ")
        if len({v.device for v in vecs}) > 1:
            raise ValueError("columns live on different devices")
        self._names: List[str] = list(names)
        self._vecs: List[Vec] = list(vecs)
        self.key = key

    # ------------------------------------------------------------ construction

    @staticmethod
    def from_numpy(data: Union[np.ndarray, Dict[str, np.ndarray]],
                   names: Optional[Sequence[str]] = None,
                   device=None) -> "Frame":
        """Upload a 2-D array or a {name: column} dict. ``device`` defaults
        to the ``h2o3_tpu_torch.init`` device, else ``cuda``."""
        dev = _device.resolve(device)
        if isinstance(data, dict):
            names = list(data.keys())
            cols = [np.asarray(c) for c in data.values()]
        else:
            data = np.asarray(data)
            if data.ndim == 1:
                data = data[:, None]
            cols = [data[:, i] for i in range(data.shape[1])]
            if names is None:
                names = [f"C{i + 1}" for i in range(len(cols))]
        return Frame(list(names), [Vec.from_numpy(c, dev) for c in cols])

    @staticmethod
    def from_typed_columns(names: Sequence[str], cols, device=None,
                           key: Optional[str] = None,
                           preset: Optional[Dict[int, Vec]] = None
                           ) -> "Frame":
        """A frame from typed columns (``.vtype``, ``.data``, ``.domain``;
        ``ingest/chunk.py`` ``EncodedColumn``): numeric and time columns
        go to the device as one float32 matrix, enum codes as one int32
        matrix, each packed column by column into pinned host memory and
        copied in one transfer; string columns stay on the host.
        ``preset`` holds columns already built on the device (a streamed
        parse's) by position; their entries of ``cols`` are None."""
        dev = _device.resolve(device)
        cols = list(cols)
        vecs: List[Optional[Vec]] = [None] * len(cols)
        for i, v in (preset or {}).items():
            vecs[i] = v
        f32, f32_meta, i32, i32_meta = [], [], [], []
        for i, c in enumerate(cols):
            if c is None:
                continue
            if c.vtype == T_STR:
                vecs[i] = Vec(None, T_STR,
                              host_data=np.asarray(c.data, dtype=object),
                              device=dev)
            elif c.vtype == T_ENUM:
                i32.append(c.data)
                i32_meta.append((i, list(c.domain or ())))
            elif c.vtype == T_TIME:
                ms = np.asarray(c.data, dtype=np.int64)
                f32.append(np.where(ms == TIME_NA, np.nan, ms / 1000.0))
                f32_meta.append((i, T_TIME, ms))
            else:
                host = (c.data if c.data.dtype == np.int64   # exact wide int
                        else _numeric_host_copy(c.data, c.vtype))
                f32.append(c.data)
                f32_meta.append((i, c.vtype, host))
        for (i, vt, host), d in zip(f32_meta, _group_to_device(
                f32, torch.float32, dev)):
            vecs[i] = Vec(d, vt, host_data=host)
        for (i, dom), d in zip(i32_meta, _group_to_device(
                i32, torch.int32, dev)):
            vecs[i] = Vec(d, T_ENUM, domain=dom)
        return Frame(list(names), vecs, key=key)

    # ------------------------------------------------------------ shape, access

    @property
    def nrow(self) -> int:
        return self._vecs[0].nrow if self._vecs else 0

    @property
    def ncol(self) -> int:
        return len(self._vecs)

    @property
    def names(self) -> List[str]:
        return list(self._names)

    @property
    def vecs(self) -> List[Vec]:
        return list(self._vecs)

    @property
    def types(self) -> Dict[str, str]:
        return {n: v.type for n, v in zip(self._names, self._vecs)}

    @property
    def device(self) -> torch.device:
        return self._vecs[0].device

    def vec(self, name_or_idx: Union[str, int]) -> Vec:
        if isinstance(name_or_idx, int):
            return self._vecs[name_or_idx]
        return self._vecs[self._names.index(name_or_idx)]

    def __contains__(self, name: str) -> bool:
        return name in self._names

    def __getitem__(self, sel) -> "Frame":
        if isinstance(sel, str):
            return Frame([sel], [self.vec(sel)])
        if isinstance(sel, (list, tuple)) and all(isinstance(s, str)
                                                  for s in sel):
            return Frame(list(sel), [self.vec(s) for s in sel])
        if isinstance(sel, (slice, np.ndarray)):
            return self.rows(sel)
        raise TypeError(f"unsupported selector {sel!r}")

    def drop(self, names: Union[str, Iterable[str]]) -> "Frame":
        drop = {names} if isinstance(names, str) else set(names)
        keep = [(n, v) for n, v in zip(self._names, self._vecs)
                if n not in drop]
        return Frame([n for n, _ in keep], [v for _, v in keep])

    def rename(self, mapping: Dict[str, str]) -> "Frame":
        """The same columns, those in ``mapping`` under their new names."""
        return Frame([mapping.get(n, n) for n in self._names], self._vecs)

    def cbind(self, other: "Frame") -> "Frame":
        return Frame(self._names + other._names, self._vecs + other._vecs)

    # ------------------------------------------------------------ row selection

    def _row_index(self, sel) -> np.ndarray:
        idx = (np.arange(self.nrow)[sel] if isinstance(sel, slice)
               else np.asarray(sel))
        return np.nonzero(idx)[0] if idx.dtype == bool else idx

    def rows(self, sel) -> "Frame":
        """Row subset by slice, boolean mask or index array. A column
        held on the device alone is gathered there (a cross-validation
        fold's frames then never cross to the host); a column with a host
        copy (strings, time, exact wide values) is gathered on the host
        and placed again, its host copy made again for the subset, as in
        ``rows_host``, whose frame this one equals bit for bit."""
        idx = self._row_index(sel)
        index = None
        vecs = []
        for v in self._vecs:
            if v.host_data is not None or v.data is None:
                vecs.append(_host_rows(v, idx, self.device))
                continue
            if index is None:
                index = torch.as_tensor(idx, dtype=torch.int64,
                                        device=v.data.device)
            vecs.append(Vec(v.data[index], v.type, v.domain))
        return Frame(self.names, vecs)

    def rows_host(self, sel) -> "Frame":
        """``rows`` with every column gathered on the host and placed
        again on the frame's device (the JAX package's gather)."""
        idx = self._row_index(sel)
        return Frame(self.names, [_host_rows(v, idx, self.device)
                                  for v in self._vecs])

    def head(self, n: int = 10) -> "Frame":
        return self.rows(slice(0, min(n, self.nrow)))

    def split_frame(self, ratios: Sequence[float],
                    seed: int = -1) -> List["Frame"]:
        """Random split: a uniform draw per row against the cumulative
        ratios, the same draw as the reference for the same seed."""
        rng = np.random.default_rng(None if seed in (-1, None) else seed)
        u = rng.random(self.nrow)
        cuts = np.cumsum(list(ratios))
        if len(cuts) == 0 or cuts[-1] < 1.0 - 1e-9:
            cuts = np.append(cuts, 1.0)
        assign = np.searchsorted(cuts, u, side="right")
        return [self.rows(assign == i) for i in range(len(cuts))]

    # ------------------------------------------------------------ materialisation

    def to_numpy(self) -> np.ndarray:
        """Host float64 matrix (enum codes, NA and string columns as NaN)."""
        cols = []
        for v in self._vecs:
            if v.type == T_STR:
                cols.append(np.full(self.nrow, np.nan))
                continue
            raw = v.to_numpy().astype(np.float64)
            cols.append(np.where(raw < 0, np.nan, raw)
                        if v.type == T_ENUM else raw)
        return (np.stack(cols, axis=1) if cols
                else np.empty((self.nrow, 0)))

    def to_dict(self) -> Dict[str, np.ndarray]:
        """{name: ``Vec.to_numpy()``} in column order."""
        return {n: v.to_numpy() for n, v in zip(self._names, self._vecs)}

    def summary(self) -> Dict[str, dict]:
        """{name: the column's rollups}."""
        return {n: v.rollups() for n, v in zip(self._names, self._vecs)}

    def as_matrix(self, names: Optional[Sequence[str]] = None):
        """float32 [nrow, ncol] matrix on the frame's device (enum codes as
        floats; NA, and every cell of a string column, as NaN) — the
        hand-off into model builders."""
        names = names or self._names
        cols = [torch.full((self.nrow,), torch.nan, dtype=torch.float32,
                           device=self.device)
                if self.vec(n).type == T_STR else self.vec(n).as_float()
                for n in names]
        return torch.stack(cols, dim=1)

    def __repr__(self):
        return f"<Frame {self.nrow}x{self.ncol} on {self.device}>"


def _host_rows(v: Vec, idx: np.ndarray, device) -> Vec:
    return Vec.from_numpy(v.to_numpy()[idx], device, vtype=v.type,
                          domain=v.domain)


def _group_to_device(columns, dtype, device: torch.device):
    """One dtype group of host columns as contiguous device columns: packed
    into one [ncol, nrow] host matrix (pinned for a CUDA device; the
    assignment converts each column's dtype in the same pass) and copied
    to the device in one transfer."""
    if not columns:
        return []
    nrow = len(columns[0])
    mat = torch.empty((len(columns), nrow), dtype=dtype,
                      pin_memory=device.type == "cuda")
    host = mat.numpy()

    def pack(j):
        host[j] = columns[j]

    if nrow * len(columns) >= (1 << 22):
        with cf.ThreadPoolExecutor(
                max_workers=min(len(columns), os.cpu_count() or 4, 8)) as ex:
            list(ex.map(pack, range(len(columns))))
    else:
        for j in range(len(columns)):
            pack(j)
    return list(mat.to(device, non_blocking=True).unbind(0))

