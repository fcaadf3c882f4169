"""Row codec: dict rows ⇄ padded batches for the scoring service.

Counterpart of ``h2o3_tpu/serve/codec.py``. Encode is the vectorized
form of EasyPredictModelWrapper's RowData contract
(genmodel.rows_to_matrix does the per-column work: enum-label LUTs,
unknown-level→NA policy, missing→NA), writing straight into a
bucket-padded float32 buffer so the batcher hands the scorer one of its
bucket shapes. Decode mirrors
Model.predict's output schema per row: regression → {"value"},
classification → {"label", "classProbabilities"} over the training
response domain, with the same balance_classes probability
un-correction the frame path applies — micro-batched predictions must be
bit-identical to model.predict on the same rows.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.genmodel import build_domain_luts, rows_to_matrix


class RowCodec:
    def __init__(self, model, convert_unknown_categorical_levels_to_na:
                 bool = True):
        self.columns = list(model.feature_names)
        self.cat_domains = {k: tuple(v) for k, v in
                            (model.cat_domains or {}).items()}
        self.response_domain = list(model.response_domain or [])
        self.nclasses = int(getattr(model, "nclasses", 1) or 1)
        self.convert_unknown = bool(convert_unknown_categorical_levels_to_na)
        self._luts = build_domain_luts(self.columns, self.cat_domains)
        self.unknown_categorical_levels_seen: Dict[str, int] = {}
        self._model = model

    @property
    def n_features(self) -> int:
        return len(self.columns)

    # -- encode ---------------------------------------------------------

    def encode(self, rows: Sequence[Dict[str, Any]],
               pad_to: Optional[int] = None) -> np.ndarray:
        """[n rows] dicts → [pad_to or n, F] float32, NaN=NA. Pad rows
        (beyond n) stay NaN — the scorer masks them by n_active and
        copies the whole padded matrix, pad included, into its slot."""
        n = len(rows)
        pad = int(pad_to or n)
        if pad < n:
            raise ValueError(f"pad_to={pad} < {n} rows")
        out = np.full((pad, self.n_features), np.nan, np.float32)
        rows_to_matrix(
            rows, self.columns, self.cat_domains,
            convert_unknown_categorical_levels_to_na=self.convert_unknown,
            unknown_seen=self.unknown_categorical_levels_seen,
            luts=self._luts, out=out)
        return out

    # -- decode ---------------------------------------------------------

    def decode_batch(self, scores: np.ndarray, n: int) -> "DecodedBatch":
        """ONE vectorized pass over the batch's host output: slice off
        the pad tail, un-correct probabilities (balance_classes) and
        argmax labels for the WHOLE batch — per-request row dicts or
        column arrays are then cheap views (``DecodedBatch.rows`` /
        ``.columns``)."""
        scores = np.asarray(scores)[:n]
        if self.nclasses <= 1:
            return DecodedBatch(self, values=scores.reshape(-1)[:n])
        # identical post-processing to Model.predict: probability
        # un-correction for balance_classes, then argmax labels
        probs = self._model._correct_probabilities(
            torch.from_numpy(scores)).numpy()
        return DecodedBatch(self, probs=probs,
                            labels=np.argmax(probs, axis=1))


class DecodedBatch:
    """Vectorized decode result shared by every request in one batch:
    row-shaped and columnar views over the same arrays, so mixed-format
    requests coalesced into one tick pay ONE probability pass."""
    __slots__ = ("codec", "values", "probs", "labels", "_dom")

    def __init__(self, codec: RowCodec, values: Optional[np.ndarray] = None,
                 probs: Optional[np.ndarray] = None,
                 labels: Optional[np.ndarray] = None):
        self.codec = codec
        self.values = values
        self.probs = probs
        self.labels = labels
        self._dom = [str(d) for d in
                     (codec.response_domain
                      or [str(k) for k in range(codec.nclasses)])]

    def rows(self, off: int, k: int) -> List[Dict[str, Any]]:
        """Per-row prediction dicts for rows [off, off+k)."""
        if self.values is not None:
            return [{"value": float(v)} for v in self.values[off:off + k]]
        dom = self._dom
        K = len(dom)
        probs = self.probs
        labels = self.labels
        return [{
            "label": dom[int(labels[i])],
            "classProbabilities": {dom[c]: float(probs[i, c])
                                   for c in range(K)},
        } for i in range(off, off + k)]

    def columns(self, off: int, k: int) -> Dict[str, List]:
        """Columnar view for rows [off, off+k): ``predict`` plus one
        ``p<label>`` column per class (the H2O predictions-frame column
        convention) — built from array slices, no per-row dicts."""
        if self.values is not None:
            return {"predict": [float(v)
                                for v in self.values[off:off + k]]}
        dom = self._dom
        lab = self.labels[off:off + k]
        cols: Dict[str, List] = {
            "predict": [dom[int(i)] for i in lab]}
        pr = self.probs[off:off + k]
        for c, d in enumerate(dom):
            cols[f"p{d}"] = pr[:, c].astype(float).tolist()
        return cols
