"""Model / ModelBuilder — the spine every algorithm of the port shares.

Counterpart of ``h2o3_tpu/models/model_base.py`` without jobs, the
keyed store, telemetry, recovery, streaming or cross-validation. A
builder resolves a ``TrainingSpec`` from the training frame on the
frame's device, trains there, and returns a ``Model`` whose ``predict``
scores a frame on that frame's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.vec import T_ENUM, Vec
from h2o3_tpu_torch.models import metrics as metrics_mod


@dataclass
class TrainingSpec:
    """Resolved training inputs on the training frame's device."""
    X: torch.Tensor              # [nrow, F] float32, NaN = NA
    y: torch.Tensor              # [nrow] float32 (reg) / int32 codes
    w: torch.Tensor              # [nrow] float32; 0 on NA-response rows
    names: List[str]
    is_cat: List[bool]
    cat_domains: Dict[str, tuple]
    nrow: int
    response: str
    response_domain: Optional[tuple]
    nclasses: int                # 1 = regression

    @property
    def n_features(self) -> int:
        return len(self.names)

    @property
    def device(self) -> torch.device:
        return self.X.device


def build_training_spec(frame: Frame, y: str,
                        x: Optional[Sequence[str]] = None,
                        ignored_columns: Optional[Sequence[str]] = None,
                        weights_column: Optional[str] = None,
                        classification: Optional[bool] = None
                        ) -> TrainingSpec:
    if y not in frame:
        raise ValueError(f"response column '{y}' not in frame {frame.names}")
    excluded = {y} | set(ignored_columns or ())
    if weights_column:
        excluded.add(weights_column)
    names = list(x) if x else [n for n in frame.names if n not in excluded]
    names = [n for n in names if n != y]
    rvec = frame.vec(y)
    if classification is None:
        classification = rvec.type == T_ENUM
    if classification and rvec.type != T_ENUM:
        rvec = rvec.asfactor()
    X = frame.as_matrix(names)
    is_cat = [frame.vec(n).type == T_ENUM for n in names]
    cat_domains = {n: frame.vec(n).domain for n in names
                   if frame.vec(n).type == T_ENUM}
    if classification:
        yd = rvec.data.to(torch.int32)
        resp_ok = yd >= 0
        y_dev = torch.clamp(yd, min=0)
        nclasses = rvec.cardinality
        response_domain = rvec.domain
    else:
        yf = rvec.as_float()
        resp_ok = ~torch.isnan(yf)
        y_dev = torch.where(resp_ok, yf, 0.0)
        nclasses = 1
        response_domain = None
    w = resp_ok.to(torch.float32)
    if weights_column:
        wv = frame.vec(weights_column).as_float()
        w = w * torch.where(torch.isnan(wv), 0.0, wv)
    return TrainingSpec(X=X, y=y_dev, w=w, names=names, is_cat=is_cat,
                        cat_domains=cat_domains, nrow=frame.nrow,
                        response=y, response_domain=response_domain,
                        nclasses=nclasses)


def adapt_test_matrix(model: "Model", frame: Frame) -> torch.Tensor:
    """Columns in training order; enum codes remapped through the
    training domain (unseen -> NA); missing columns all-NA."""
    cols = []
    for n, is_cat in zip(model.feature_names, model.feature_is_cat):
        if n not in frame:
            cols.append(None)
            continue
        v = frame.vec(n)
        train_dom = model.cat_domains.get(n)
        if is_cat and v.type == T_ENUM and train_dom and v.domain != train_dom:
            lut = {lab: i for i, lab in enumerate(train_dom)}
            remap = np.array([lut.get(lab, -1) for lab in v.domain] + [-1],
                             dtype=np.int32)
            codes = v.to_numpy()
            codes = remap[np.where(codes < 0, len(v.domain), codes)]
            v = Vec.from_numpy(codes, v.device, vtype=T_ENUM,
                               domain=train_dom)
        cols.append(v.as_float())
    if all(c is None for c in cols):
        raise ValueError("test frame shares no columns with the model")
    cols = [torch.full((frame.nrow,), torch.nan, dtype=torch.float32,
                       device=frame.device) if c is None else c
            for c in cols]
    return torch.stack(cols, dim=1)


def compute_metrics(scores, y, w, nclasses, deviance=None):
    """Regression or binomial metrics over the rows with weight > 0."""
    live = w > 0
    if not bool(live.all()):
        scores, y, w = scores[live], y[live], w[live]
    if nclasses <= 1:
        return metrics_mod.make_regression_metrics(scores, y, w,
                                                   deviance=deviance)
    if nclasses == 2:
        return metrics_mod.make_binomial_metrics(scores[:, 1], y, w)
    raise NotImplementedError(
        "multinomial metrics are not ported yet (ROADMAP.md, queue 1)")


class Model:
    """A trained artifact; subclasses implement ``_predict_matrix``."""

    algo = "base"

    def __init__(self, key: str, params: Dict, names: Sequence[str],
                 nclasses: int, response: Optional[str] = None,
                 response_domain: Optional[tuple] = None,
                 is_cat: Optional[Sequence[bool]] = None,
                 cat_domains: Optional[Dict[str, tuple]] = None):
        self.key = key
        self.params = dict(params)
        self.feature_names = list(names)
        self.feature_is_cat = (list(is_cat) if is_cat is not None
                               else [False] * len(self.feature_names))
        self.cat_domains = dict(cat_domains or {})
        self.response = response
        self.response_domain = (tuple(response_domain)
                                if response_domain is not None else None)
        self.nclasses = nclasses
        self.output: Dict[str, Any] = {}
        self.training_metrics = None

    def _predict_matrix(self, X: torch.Tensor) -> torch.Tensor:
        """[rows] predictions (regression) or [rows, K] class
        probabilities."""
        raise NotImplementedError

    def predict(self, frame: Frame) -> Frame:
        """Score a frame on its device: regression -> 'predict';
        classification -> 'predict' plus one probability column per
        class."""
        out = self._predict_matrix(adapt_test_matrix(self, frame))
        if self.nclasses <= 1:
            return Frame(["predict"], [Vec(out.to(torch.float32))])
        lbl = torch.argmax(out, dim=1).to(torch.int32)
        names = ["predict"] + [f"p{d}" for d in self.response_domain]
        vecs = [Vec(lbl, T_ENUM, self.response_domain)]
        vecs += [Vec(out[:, k].contiguous()) for k in range(self.nclasses)]
        return Frame(names, vecs)

    def __repr__(self):
        return f"<{type(self).__name__} {self.key}>"


# builder-level parameters every algorithm of the port understands
BUILDER_PARAMS = frozenset({"model_id", "ignored_columns", "weights_column",
                            "response_column", "training_frame"})


class ModelBuilder:
    """Base trainer: ``train(x, y, training_frame)`` builds the spec and
    calls ``_train_impl``."""

    algo = "base"

    def __init__(self, **params):
        self.params = dict(params)
        self.model: Optional[Model] = None

    def _model_key(self) -> str:
        mid = self.params.get("model_id")
        return str(mid) if mid else f"{self.algo}_{id(self) & 0xffffff:x}"

    def _train_impl(self, spec: TrainingSpec) -> Model:
        raise NotImplementedError

    def _classification(self) -> Optional[bool]:
        return None

    def train(self, x: Optional[Sequence[str]] = None,
              y: Optional[str] = None,
              training_frame: Optional[Frame] = None,
              validation_frame: Optional[Frame] = None) -> "ModelBuilder":
        y = y or self.params.get("response_column")
        training_frame = (training_frame if training_frame is not None
                          else self.params.get("training_frame"))
        if training_frame is None or y is None:
            raise ValueError("train() needs training_frame and y")
        if validation_frame is not None:
            raise NotImplementedError(
                "validation_frame is not ported yet (ROADMAP.md, queue 1, "
                "item 5: scoring during training)")
        spec = build_training_spec(
            training_frame, y, x,
            ignored_columns=self.params.get("ignored_columns"),
            weights_column=self.params.get("weights_column"),
            classification=self._classification())
        self.model = self._train_impl(spec)
        return self
