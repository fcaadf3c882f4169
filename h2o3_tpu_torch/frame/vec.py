"""Vec — one column as one torch tensor.

Counterpart of ``h2o3_tpu/frame/vec.py``. The column types are those of
H2O's ``Vec.T_*``: ``real``, ``int``, ``enum``, ``time`` and ``string``.
Numeric and time columns are float32 on the device with NaN as NA (time
as epoch seconds, its exact int64 milliseconds kept on the host, NA =
``TIME_NA``); enum columns are int32 codes with -1 as NA against a
host-side domain; string columns live on the host only. A numeric column
whose integral values pass float32's 24-bit mantissa keeps an exact
float64 host copy, and an int64 column past 2^53 keeps the exact int64
array (H2O's ``C8Chunk``). Tensors hold exactly ``nrow`` rows: the port
pads nothing.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch import memman

T_REAL = "real"
T_INT = "int"
T_ENUM = "enum"
T_TIME = "time"
T_STR = "string"

ENUM_NA = -1
TIME_NA = np.iinfo(np.int64).min      # host NA of a time column

# H2O's default percentiles (water/fvec/Vec.java PERCENTILES)
PERCENTILES = (0.001, 0.01, 0.1, 0.25, 1.0 / 3.0, 0.5, 2.0 / 3.0, 0.75,
               0.9, 0.99, 0.999)


class Vec:
    def __init__(self, data: Optional[torch.Tensor], vtype: str = T_REAL,
                 domain: Optional[Sequence[str]] = None, host_data=None,
                 device: Optional[torch.device] = None):
        """``data`` is the device column (None for a string column, whose
        values are ``host_data`` and whose frame lives on ``device``)."""
        if data is not None and data.dim() != 1:
            raise ValueError(f"a Vec holds one column, got shape "
                             f"{tuple(data.shape)}")
        if data is None and vtype != T_STR:
            raise ValueError("only a string column has no device data")
        self.data = data
        self.type = vtype
        self.domain = tuple(domain) if domain is not None else None
        self.host_data = host_data
        self._device = data.device if data is not None else _indexed(
            torch.device(device or "cpu"))
        self._rollups = None
        # the payload counts against the device budget while the Vec
        # lives (memman.py)
        self._memblock = (memman.manager().register(
            data.numel() * data.element_size()) if data is not None
            else None)

    # ---------------------------------------------------------- construction

    @staticmethod
    def from_numpy(arr, device: torch.device, vtype: Optional[str] = None,
                   domain: Optional[Sequence[str]] = None) -> "Vec":
        """A host array as a column on ``device``; the type follows the
        array (strings become an enum, integers ``int``, else ``real``)
        unless ``vtype`` is given."""
        arr = np.asarray(arr)
        explicit = vtype is not None
        if vtype is None:
            if arr.dtype.kind in "OUS":
                return Vec._from_strings(arr, device)
            vtype = T_INT if arr.dtype.kind in "iub" else T_REAL
        if vtype == T_STR:
            return Vec(None, T_STR, host_data=np.asarray(arr, dtype=object),
                       device=device)
        if vtype == T_ENUM:
            return Vec(torch.as_tensor(np.asarray(arr, np.int32),
                                       device=device), T_ENUM, domain)
        if vtype == T_TIME:
            host = np.asarray(arr, dtype=np.int64)
            sec = np.where(host == TIME_NA, np.nan,
                           host / 1000.0).astype(np.float32)
            return Vec(torch.as_tensor(sec, device=device), T_TIME,
                       host_data=host)
        if (vtype == T_INT and arr.dtype.kind in "iu" and arr.size
                and np.abs(arr, dtype=np.float64).max() >= float(1 << 53)
                and (arr.dtype.kind == "i"
                     or arr.max() <= np.uint64(np.iinfo(np.int64).max))):
            # past float64's exact 2^53: the int64 array is the host copy
            exact = np.asarray(arr, dtype=np.int64)
            return Vec(torch.as_tensor(exact.astype(np.float32),
                                       device=device), T_INT,
                       host_data=exact.copy())
        src = arr if arr.dtype == np.float32 else np.asarray(arr, np.float64)
        if not explicit and vtype == T_INT and not _is_integral(src):
            vtype = T_REAL
        f32 = np.ascontiguousarray(src, dtype=np.float32)
        return Vec(torch.as_tensor(f32, device=device), vtype,
                   host_data=_numeric_host_copy(src, vtype))

    @staticmethod
    def _from_strings(arr: np.ndarray, device) -> "Vec":
        """Strings to an enum: the sorted distinct labels are the domain;
        None, NaN and "" are NA."""
        arr = np.asarray(arr, dtype=object)
        isna = np.array([x is None or (isinstance(x, float) and np.isnan(x))
                         or x == "" for x in arr], dtype=bool)
        vals = np.array(["" if m else str(v) for v, m in zip(arr, isna)])
        domain = (np.unique(vals[~isna]) if (~isna).any()
                  else np.array([], dtype=str))
        codes = np.searchsorted(domain, vals).astype(np.int32)
        codes[isna] = ENUM_NA
        return Vec(torch.as_tensor(codes, device=device), T_ENUM,
                   domain=[str(d) for d in domain])

    # ------------------------------------------------------------ properties

    @property
    def nrow(self) -> int:
        if self.data is None:
            return len(self.host_data)
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def is_numeric(self) -> bool:
        return self.type in (T_REAL, T_INT)

    @property
    def cardinality(self) -> int:
        return len(self.domain) if self.domain is not None else -1

    def as_float(self) -> torch.Tensor:
        """float32 view with NA as NaN (enums become their codes)."""
        if self.data is None:
            raise ValueError("a string Vec has no device representation; "
                             "drop or re-type string columns first")
        if self.type == T_ENUM:
            return torch.where(self.data >= 0, self.data.to(torch.float32),
                               torch.nan)
        return self.data

    def asfactor(self) -> "Vec":
        """Numeric to categorical: the distinct finite values become the
        sorted domain, NA stays NA (``h2o3_tpu`` ``Vec.asfactor``)."""
        if self.type == T_ENUM:
            return self
        if self.type == T_STR:
            return Vec._from_strings(self.host_data, self.device)
        raw = self.to_numpy()
        finite = np.isfinite(raw)
        vals = np.unique(raw[finite])
        domain = tuple(str(int(v)) if float(v).is_integer() else str(v)
                       for v in vals)
        codes = np.searchsorted(vals, raw).astype(np.int32)
        codes[~finite] = ENUM_NA
        return Vec.from_numpy(codes, self.device, vtype=T_ENUM,
                              domain=domain)

    # --------------------------------------------------------------- rollups

    def rollups(self) -> dict:
        """Per-column statistics, computed at first ask and cached."""
        if self._rollups is None:
            from h2o3_tpu_torch.frame.rollups import compute_rollups
            self._rollups = compute_rollups(self)
        return self._rollups

    def mean(self):
        return self.rollups()["mean"]

    def sigma(self):
        return self.rollups()["sigma"]

    def min(self):
        return self.rollups()["min"]

    def max(self):
        return self.rollups()["max"]

    def na_count(self):
        return self.rollups()["na_count"]

    def percentiles(self, probs=PERCENTILES) -> np.ndarray:
        from h2o3_tpu_torch.frame.rollups import compute_percentiles
        return compute_percentiles(self, probs)

    # -------------------------------------------------------- materialisation

    def to_numpy(self) -> np.ndarray:
        """Host copy: the host data where a column keeps it (strings as
        objects, time as int64 ms, the exact float64 or int64 copy of a
        numeric column), else the device values: float32 (NaN = NA) or
        int32 enum codes (-1 = NA)."""
        if self.host_data is not None:
            return self.host_data.copy()
        return self.data.cpu().numpy()

    def to_strings(self) -> np.ndarray:
        """An object array of labels: an enum's codes decoded (None for
        NA), a string column's values, else the values."""
        if self.type == T_STR:
            return self.host_data.copy()
        raw = self.to_numpy()
        if self.type == T_ENUM:
            dom = np.array(list(self.domain) + [None], dtype=object)
            return dom[np.where(raw < 0, len(self.domain), raw)]
        return raw.astype(object)


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the current card's index, as a tensor there reports
    it (a string column has no tensor to ask)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _is_integral(f: np.ndarray) -> bool:
    finite = f[np.isfinite(f)]
    return bool(finite.size == 0 or np.all(finite == np.round(finite)))


def _numeric_host_copy(f: np.ndarray, vtype: str) -> Optional[np.ndarray]:
    """The exact float64 host copy of a numeric column whose integral
    values pass float32's 24-bit mantissa, else None (the cheap max check
    gates the integrality scan)."""
    if not f.size:
        return None
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        # an all-NaN column warns through the warnings module
        warnings.simplefilter("ignore", RuntimeWarning)
        m = float(np.nanmax(np.abs(f)))
    if np.isnan(m):
        return None
    if np.isinf(m):
        finite = f[np.isfinite(f)]
        if not (finite.size and np.abs(finite).max() > (1 << 24)):
            return None
    elif m <= (1 << 24):
        return None
    if vtype == T_INT or _is_integral(f):
        return np.asarray(f, dtype=np.float64)
    return None
