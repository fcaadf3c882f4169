"""Frame — named columns on one device.

Counterpart of ``h2o3_tpu/frame/frame.py`` reduced to what the GBM slice
needs: ``from_numpy``, the shape accessors, ``vec`` and ``as_matrix``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from h2o3_tpu_torch import _device
from h2o3_tpu_torch.frame.vec import Vec


class Frame:
    def __init__(self, names: Sequence[str], vecs: Sequence[Vec]):
        if len(names) != len(vecs):
            raise ValueError("one name per column")
        if len({v.nrow for v in vecs}) > 1:
            raise ValueError("column lengths differ")
        if len({v.device for v in vecs}) > 1:
            raise ValueError("columns live on different devices")
        self._names: List[str] = list(names)
        self._vecs: List[Vec] = list(vecs)

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
    def device(self) -> torch.device:
        return self._vecs[0].device

    def vec(self, name_or_idx: Union[str, int]) -> Vec:
        if isinstance(name_or_idx, int):
            return self._vecs[name_or_idx]
        return self._vecs[self._names.index(name_or_idx)]

    def __contains__(self, name: str) -> bool:
        return name in self._names

    def as_matrix(self, names: Optional[Sequence[str]] = None):
        """float32 [nrow, ncol] matrix on the frame's device (enum codes as
        floats, NA as NaN) — the hand-off into model builders."""
        names = names or self._names
        return torch.stack([self.vec(n).as_float() for n in names], dim=1)

    def __repr__(self):
        return f"<Frame {self.nrow}x{self.ncol} on {self.device}>"
