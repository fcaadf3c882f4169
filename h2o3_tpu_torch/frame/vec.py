"""Vec — one column as one torch tensor.

Counterpart of ``h2o3_tpu/frame/vec.py``, reduced to what the GBM slice
needs. Numeric columns (``T_REAL``; the port does not tell integer
columns apart) are float32 with NaN as NA; categorical columns
are int32 codes with -1 as NA plus a host-side domain. Tensors hold
exactly ``nrow`` rows: the port pads nothing.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

T_REAL = "real"
T_ENUM = "enum"

ENUM_NA = -1


class Vec:
    def __init__(self, data: torch.Tensor, vtype: str = T_REAL,
                 domain: Optional[Sequence[str]] = None):
        if data.dim() != 1:
            raise ValueError(f"a Vec holds one column, got shape "
                             f"{tuple(data.shape)}")
        self.data = data
        self.type = vtype
        self.domain = tuple(domain) if domain is not None else None

    @staticmethod
    def from_numpy(arr, device: torch.device, vtype: Optional[str] = None,
                   domain: Optional[Sequence[str]] = None) -> "Vec":
        arr = np.asarray(arr)
        if arr.dtype.kind in "OUS":
            raise TypeError("string columns are not supported by the port "
                            "yet; pass numeric arrays")
        if vtype == T_ENUM:
            return Vec(torch.as_tensor(np.asarray(arr, np.int32),
                                       device=device), T_ENUM, domain)
        f32 = np.ascontiguousarray(arr, dtype=np.float32)
        return Vec(torch.as_tensor(f32, device=device), T_REAL)

    @property
    def nrow(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def cardinality(self) -> int:
        return len(self.domain) if self.domain is not None else -1

    def as_float(self) -> torch.Tensor:
        """float32 view with NA as NaN (enums become their codes)."""
        if self.type == T_ENUM:
            return torch.where(self.data >= 0, self.data.to(torch.float32),
                               torch.nan)
        return self.data

    def asfactor(self) -> "Vec":
        """Numeric to categorical: the distinct finite values become the
        sorted domain, NA stays NA (``h2o3_tpu`` ``Vec.asfactor``)."""
        if self.type == T_ENUM:
            return self
        raw = self.to_numpy().astype(np.float64)
        finite = np.isfinite(raw)
        vals = np.unique(raw[finite])
        domain = tuple(str(int(v)) if float(v).is_integer() else str(v)
                       for v in vals)
        codes = np.searchsorted(vals, raw).astype(np.int32)
        codes[~finite] = ENUM_NA
        return Vec.from_numpy(codes, self.device, vtype=T_ENUM,
                              domain=domain)

    def to_numpy(self) -> np.ndarray:
        """Host copy: float32 (NaN = NA) or int32 enum codes (-1 = NA)."""
        return self.data.cpu().numpy()
