"""The EasyPredict row API of the port.

Counterpart of the EasyPredict half of ``h2o3_tpu/genmodel.py``
(hex/genmodel/easy/EasyPredictModelWrapper.java's RowData contract):
row dicts whose values are numbers or category labels become a float
matrix in training column order, with unknown levels and missing
columns as NA, and ``EasyPredictModelWrapper`` scores one row through
the model's batch predict. The MOJO and POJO writers and readers of the
JAX module wait for ROADMAP.md queue 1, item 18 (``mojo.py``);
contributions and leaf assignments for item 16 (``treeshap``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch


def build_domain_luts(columns: Sequence[str],
                      cat_domains: Dict[str, Sequence[str]]
                      ) -> Dict[str, Dict[str, int]]:
    """Per-column label→code lookup tables for the categorical columns.
    Built once per model (deploy/wrapper construction) so batch encoding
    is O(1) per label instead of the O(|domain|) list.index scan."""
    return {c: {str(lab): i for i, lab in enumerate(cat_domains[c])}
            for c in columns if cat_domains.get(c)}


def rows_to_matrix(rows: Sequence[Dict[str, Any]], columns: Sequence[str],
                   cat_domains: Dict[str, Sequence[str]], *,
                   convert_unknown_categorical_levels_to_na: bool = True,
                   convert_invalid_numbers_to_na: bool = False,
                   unknown_seen: Optional[Dict[str, int]] = None,
                   luts: Optional[Dict[str, Dict[str, int]]] = None,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
    """Vectorized RowData encoding: a batch of {column: value} dicts →
    [n, F] float matrix in training column order — the
    EasyPredictModelWrapper dict→array contract applied to whole
    batches (the serve codec's hot path). Per column: enum labels map
    through the training-domain LUT, unknown levels → NA (or raise,
    per the convert_unknown flag), missing columns / None → NA.

    Int-coded enum levels honor the SAME unknown-level policy as
    string labels: a numeric code outside [0, cardinality) — or a
    non-integral one — is an unknown level, not a silent pass-through.

    ``out`` may be a caller-provided (padded) buffer with >= n rows;
    rows past len(rows) are left untouched."""
    n = len(rows)
    F = len(columns)
    if out is None:
        out = np.full((n, F), np.nan, np.float64)
    else:
        out[:n, :] = np.nan
    if luts is None:
        luts = build_domain_luts(columns, cat_domains)
    for j, c in enumerate(columns):
        lut = luts.get(c)
        if lut is None:
            # numeric column: one-shot asarray fast path, element-wise
            # fallback only when a value refuses to parse
            vals = [r.get(c) for r in rows]
            try:
                col = np.asarray(
                    [np.nan if v is None else v for v in vals],
                    dtype=np.float64)
            except (TypeError, ValueError):
                if not convert_invalid_numbers_to_na:
                    raise
                col = np.full(n, np.nan, np.float64)
                for i, v in enumerate(vals):
                    if v is None:
                        continue
                    try:
                        col[i] = float(v)
                    except (TypeError, ValueError):
                        pass
            out[:n, j] = col
            continue
        ncat = len(lut)
        unknown = 0
        for i, r in enumerate(rows):
            v = r.get(c)
            if v is None:
                continue
            if isinstance(v, str):
                code = lut.get(v, -1)
            else:
                try:
                    fv = float(v)
                except (TypeError, ValueError):
                    code = -1
                else:
                    if np.isnan(fv):
                        continue            # numeric NA → NA level
                    code = int(fv) if (np.isfinite(fv) and fv == int(fv)
                                       and 0 <= fv < ncat) else -1
            if code < 0:
                # unseen level: NA when configured (default), else a
                # PredictUnknownCategoricalLevelException analog
                if not convert_unknown_categorical_levels_to_na:
                    raise ValueError(
                        f"unknown categorical level {v!r} for column "
                        f"'{c}' (set convert_unknown_categorical_levels"
                        f"_to_na=True to map to NA)")
                unknown += 1
                continue
            out[i, j] = code
        if unknown and unknown_seen is not None:
            unknown_seen[c] = unknown_seen.get(c, 0) + unknown
    return out


class EasyPredictModelWrapper:
    """Row-dict scoring over a model of the port —
    hex/genmodel/easy/EasyPredictModelWrapper.java's RowData contract:
    values may be numbers or category LABELS; unknown categoricals map
    to NA; missing columns are NA."""

    def __init__(self, model, convert_unknown_categorical_levels_to_na:
                 bool = True, convert_invalid_numbers_to_na: bool = False,
                 enable_contributions: bool = False,
                 enable_leaf_assignment: bool = False):
        """Config mirrors EasyPredictModelWrapper.Config: unknown-level
        and invalid-number handling. Contributions need the model's
        TreeSHAP (none in the port yet); leaf assignments wait for
        ROADMAP.md queue 1, item 16."""
        if enable_contributions and not hasattr(model,
                                                "predict_contributions"):
            raise ValueError("enable_contributions: this model has no "
                             "TreeSHAP support (GBM/DRF/XGBoost only)")
        if enable_leaf_assignment:
            raise NotImplementedError(
                "enable_leaf_assignment is not ported yet (ROADMAP.md "
                "queue 1, item 16, treeshap)")
        self.model = model
        self.columns = list(model.feature_names)
        self.cat_domains = dict(model.cat_domains or {})
        self.response_domain = list(model.response_domain or [])
        self.convert_unknown_categorical_levels_to_na = bool(
            convert_unknown_categorical_levels_to_na)
        self.convert_invalid_numbers_to_na = bool(
            convert_invalid_numbers_to_na)
        self.unknown_categorical_levels_seen: Dict[str, int] = {}
        self._luts = build_domain_luts(self.columns, self.cat_domains)

    def _row_to_array(self, row: Dict[str, Any]) -> np.ndarray:
        return rows_to_matrix(
            [row], self.columns, self.cat_domains,
            convert_unknown_categorical_levels_to_na=self
            .convert_unknown_categorical_levels_to_na,
            convert_invalid_numbers_to_na=self.convert_invalid_numbers_to_na,
            unknown_seen=self.unknown_categorical_levels_seen,
            luts=self._luts)[0]

    def predict_row(self, row: Dict[str, Any]) -> Dict[str, Any]:
        arr = self._row_to_array(row)
        m = self.model
        # float32, as the JAX package scores it (x64 off): a float64
        # compare would route a row differently at a threshold tie
        X = torch.as_tensor(arr[None, :], dtype=torch.float32,
                            device=m.device)
        out = m._predict_matrix(X)
        if m.nclasses >= 2:
            probs = out.cpu().numpy()[0]
            dom = self.response_domain or [str(k)
                                           for k in range(m.nclasses)]
            return {"label": dom[int(np.argmax(probs))],
                    "classProbabilities": {dom[k]: float(p)
                                           for k, p in enumerate(probs)}}
        return {"value": float(out.cpu().numpy().reshape(-1)[0])}
