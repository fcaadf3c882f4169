"""Rollup statistics and percentiles of one column, in torch on the
column's device.

Counterpart of ``h2o3_tpu/frame/rollups.py`` (H2O's RollupStats): row
count, NA count, mean, sigma (two passes, n - 1), min, max, non-zero
count and the infinities, all in float32 as the reference computes
them; percentiles by a sort and linear interpolation between the ranks
either side (``nanquantile``'s default, with its weights: an infinite
end value gives NaN where the reference gives it).
"""
from __future__ import annotations

import numpy as np
import torch

from h2o3_tpu_torch.frame.vec import T_ENUM, T_STR


def compute_rollups(vec) -> dict:
    if vec.type == T_STR:
        isna = np.array([v is None or v == "" for v in vec.host_data],
                        dtype=bool)
        return {"na_count": int(isna.sum()), "rows": vec.nrow,
                "mean": np.nan, "sigma": np.nan, "min": np.nan,
                "max": np.nan, "nz_count": int((~isna).sum()), "pinfs": 0,
                "ninfs": 0, "is_const": False}
    data = vec.as_float()
    valid = ~torch.isnan(data)
    cnt_t = valid.sum()
    fcnt = torch.clamp(cnt_t, min=1).to(torch.float32)
    s = torch.where(valid, data, 0.0).sum()
    mean = s / fcnt
    var = (torch.where(valid, (data - mean) ** 2, 0.0).sum()
           / torch.clamp(fcnt - 1.0, min=1.0))
    inf = torch.tensor(float("inf"), device=data.device)
    mn = torch.where(valid, data, inf).min() if data.numel() else inf
    mx = torch.where(valid, data, -inf).max() if data.numel() else -inf
    stats = torch.stack([
        cnt_t.to(torch.float64), mean.to(torch.float64),
        torch.sqrt(var).to(torch.float64), mn.to(torch.float64),
        mx.to(torch.float64), (valid & (data != 0.0)).sum().to(torch.float64),
        (valid & torch.isposinf(data)).sum().to(torch.float64),
        (valid & torch.isneginf(data)).sum().to(torch.float64)]).cpu()
    cnt, mean, sigma, mn, mx, nz, pinf, ninf = stats.tolist()
    cnt = int(cnt)
    out = {"rows": vec.nrow, "na_count": vec.nrow - cnt,
           "mean": mean if cnt else np.nan,
           "sigma": sigma if cnt > 1 else 0.0 if cnt else np.nan,
           "min": mn if cnt else np.nan, "max": mx if cnt else np.nan,
           "nz_count": int(nz), "pinfs": int(pinf), "ninfs": int(ninf)}
    out["is_const"] = cnt > 0 and out["min"] == out["max"]
    if vec.type == T_ENUM:
        out["cardinality"] = vec.cardinality
    return out


def compute_percentiles(vec, probs) -> np.ndarray:
    """Exact quantiles of the non-NA values (float32), by a device sort;
    NaN where the column has no value."""
    data = vec.as_float()
    d, _ = torch.sort(data[~torch.isnan(data)])
    p = torch.as_tensor(np.asarray(probs, np.float32), device=data.device)
    n = d.numel()
    if n == 0:
        return np.full(len(p), np.nan, dtype=np.float32)
    pos = p * float(n - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    out = (d[lo.to(torch.int64)] * (1.0 - w_hi)
           + d[hi.to(torch.int64)] * w_hi)
    return out.cpu().numpy()
