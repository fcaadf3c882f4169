"""Model / ModelBuilder — the spine every algorithm of the port shares.

Counterpart of ``h2o3_tpu/models/model_base.py`` without jobs, the
keyed store, telemetry, recovery, streaming or cross-validation. A
builder resolves a ``TrainingSpec`` from the training frame on the
frame's device (and one from a validation frame, adapted to it), trains
there, and returns a ``Model`` whose ``predict`` scores a frame on that
frame's device. ``ScoreKeeper`` keeps the scoring history and decides
early stopping.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.vec import T_ENUM, Vec
from h2o3_tpu_torch.log import warn
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
    offset: Optional[torch.Tensor] = None   # [nrow] float32, NaN -> 0

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
                        offset_column: Optional[str] = None,
                        classification: Optional[bool] = None
                        ) -> TrainingSpec:
    if y not in frame:
        raise ValueError(f"response column '{y}' not in frame {frame.names}")
    excluded = {y} | set(ignored_columns or ())
    if weights_column:
        excluded.add(weights_column)
    if offset_column:
        excluded.add(offset_column)
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
    offset = _offset(frame, offset_column) if offset_column else None
    return TrainingSpec(X=X, y=y_dev, w=w, names=names, is_cat=is_cat,
                        cat_domains=cat_domains, nrow=frame.nrow,
                        response=y, response_domain=response_domain,
                        nclasses=nclasses, offset=offset)


def _offset(frame: Frame, offset_column: str) -> torch.Tensor:
    """An offset column as float32 on the frame's device, NA -> 0."""
    ov = frame.vec(offset_column).as_float()
    return torch.where(torch.isnan(ov), 0.0, ov)


def adapt_test_matrix(model: "Model", frame: Frame) -> torch.Tensor:
    """Columns in training order; enum codes remapped through the
    training domain (unseen -> NA); missing columns all-NA."""
    return _adapt_matrix(frame, model.feature_names, model.feature_is_cat,
                         model.cat_domains)


def _adapt_matrix(frame: Frame, names, is_cat, cat_domains) -> torch.Tensor:
    cols = []
    for n, cat in zip(names, is_cat):
        if n not in frame:
            cols.append(None)
            continue
        v = frame.vec(n)
        train_dom = cat_domains.get(n)
        if cat and v.type == T_ENUM and train_dom and v.domain != train_dom:
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


def response_codes_in_domain(frame: Frame, response: str, domain):
    """A test frame's response codes mapped through a training response
    domain, on the frame's device: (codes, w), where a label unseen in
    training and NA take weight 0 (and code 0). A numeric response is
    read as labels as ``Vec.asfactor`` spells them."""
    v = frame.vec(response)
    if v.type != T_ENUM:
        v = v.asfactor()
    lut = {lab: i for i, lab in enumerate(domain)}
    # the trailing -1 is the NA code's entry: NA indexes it through an
    # explicit mask, never through a negative index
    remap = torch.tensor([lut.get(lab, -1) for lab in v.domain] + [-1],
                         dtype=torch.int32, device=v.data.device)
    codes = v.data.long()
    mapped = remap[torch.where(codes < 0, len(v.domain), codes)]
    ok = mapped >= 0
    return torch.where(ok, mapped, 0), ok.to(torch.float32)


def build_validation_spec(frame: Frame, train_spec: TrainingSpec,
                          weights_column: Optional[str] = None,
                          offset_column: Optional[str] = None
                          ) -> TrainingSpec:
    """A validation frame's spec adapted to a training spec: columns in
    training order, enum codes remapped through the training domains
    (unseen and NA -> NA), response codes mapped through the training
    response domain (unseen and NA -> weight 0). A spec from the
    validation frame's own domains would misroute enum splits and class
    indices. A model trained with an offset needs it here too: a frame
    without the offset column raises."""
    if frame.device != train_spec.device:
        raise ValueError(f"validation frame lives on {frame.device}, the "
                         f"training frame on {train_spec.device}")
    if train_spec.response not in frame:
        raise ValueError(f"validation frame lacks the response column "
                         f"'{train_spec.response}'")
    X = _adapt_matrix(frame, train_spec.names, train_spec.is_cat,
                      train_spec.cat_domains)
    if train_spec.nclasses > 1:
        y_dev, w = response_codes_in_domain(frame, train_spec.response,
                                            train_spec.response_domain)
        y_dev = y_dev.to(torch.int32)
    else:
        yf = frame.vec(train_spec.response).as_float()
        resp_ok = torch.isfinite(yf)
        y_dev = torch.where(resp_ok, yf, 0.0)
        w = resp_ok.to(torch.float32)
    if weights_column:
        if weights_column not in frame:
            raise ValueError(f"validation frame lacks weights_column "
                             f"'{weights_column}'")
        wv = frame.vec(weights_column).as_float()
        w = w * torch.where(torch.isnan(wv), 0.0, wv)
    offset = None
    if offset_column:
        if offset_column not in frame:
            raise ValueError(
                f"validation frame lacks offset_column '{offset_column}'")
        offset = _offset(frame, offset_column)
    return TrainingSpec(X=X, y=y_dev, w=w, names=train_spec.names,
                        is_cat=train_spec.is_cat,
                        cat_domains=train_spec.cat_domains, nrow=frame.nrow,
                        response=train_spec.response,
                        response_domain=train_spec.response_domain,
                        nclasses=train_spec.nclasses, offset=offset)


class ScoreKeeper:
    """Scoring history and early stopping, copied from the JAX package
    (H2O's ScoreKeeper semantics): stop when the mean of the last
    ``stopping_rounds`` scores is no better than the mean of the
    ``stopping_rounds`` before them by the relative tolerance. A metric
    the entries do not carry falls back to the deviance."""

    LESS_IS_BETTER = {"logloss", "mse", "rmse", "mae", "deviance",
                      "mean_per_class_error", "rmsle", "anomaly_score"}

    def __init__(self, stopping_rounds=0, stopping_metric="auto",
                 stopping_tolerance=1e-3, task="regression"):
        self.rounds = int(stopping_rounds or 0)
        metric = (stopping_metric or "auto").lower()
        if metric == "auto":
            metric = ("logloss" if task in ("binomial", "multinomial")
                      else "deviance")
        self.metric = metric
        self.tol = stopping_tolerance
        self.history: List[Dict] = []

    def record(self, entry: Dict):
        self.history.append(entry)

    def should_stop(self) -> bool:
        if self.rounds <= 0:
            return False
        k = self.rounds
        metric = self.metric
        if self.history and all(e.get(metric) is None for e in self.history):
            metric = "deviance"  # requested metric unavailable for this family
        scores = [e.get(metric) for e in self.history
                  if e.get(metric) is not None]
        if metric == "deviance" and self.metric != "deviance":
            return self._stop_on(scores, k, less_is_better=True)
        return self._stop_on(scores, k,
                             less_is_better=metric in self.LESS_IS_BETTER)

    def _stop_on(self, scores, k, less_is_better):
        if len(scores) < 2 * k:
            return False
        recent = np.mean(scores[-k:])
        prev = np.mean(scores[-2 * k:-k])
        # relative improvement scaled by |prev|, so that a metric crossing
        # zero keeps its band
        margin = self.tol * abs(prev)
        if less_is_better:
            return recent >= prev - margin
        return recent <= prev + margin


def compute_metrics(scores, y, w, nclasses, deviance=None):
    """Regression, binomial or multinomial metrics over the rows with
    weight > 0."""
    live = w > 0
    if not bool(live.all()):
        scores, y, w = scores[live], y[live], w[live]
    if nclasses <= 1:
        return metrics_mod.make_regression_metrics(scores, y, w,
                                                   deviance=deviance)
    if nclasses == 2:
        return metrics_mod.make_binomial_metrics(scores[:, 1], y, w)
    return metrics_mod.make_multinomial_metrics(scores, y, w)


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
        self.validation_metrics = None
        self.scoring_history: List[Dict] = []

    def _predict_matrix(self, X: torch.Tensor,
                        offset: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """[rows] predictions (regression) or [rows, K] class
        probabilities; ``offset`` [rows] is added to the margin."""
        raise NotImplementedError

    def _frame_offset(self, frame: Frame) -> Optional[torch.Tensor]:
        """The scoring frame's offset, for a model trained with
        offset_column (None otherwise); a frame without the column
        raises, since dropping it would shift every prediction."""
        oc = self.params.get("offset_column")
        if not oc:
            return None
        if oc not in frame:
            raise ValueError(
                f"model was trained with offset_column='{oc}' but the "
                f"scoring frame does not contain it")
        return _offset(frame, oc)

    def _correct_probabilities(self, probs: torch.Tensor) -> torch.Tensor:
        """balance_classes probability un-correction (hex/Model
        correctProbabilities), copied from the JAX package: p_k ∝ p̂_k ·
        prior_k / model_dist_k, so that a model trained on a rebalanced
        distribution reports probabilities calibrated to the original
        class priors. The identity until a train records both
        distributions (ROADMAP.md queue 1, item A7)."""
        prior_d = self.output.get("prior_class_dist")
        model_d = self.output.get("model_class_dist")
        if not prior_d or not model_d or probs.dim() != 2 \
                or probs.shape[1] != len(prior_d):
            return probs
        ratio = (torch.tensor(prior_d, dtype=torch.float64)
                 / torch.tensor(model_d, dtype=torch.float64).clamp(
                     min=1e-12)).to(probs.device)
        p = probs.to(torch.float64) * ratio[None, :]
        return (p / p.sum(dim=1, keepdim=True).clamp(min=1e-12)).to(
            probs.dtype)

    def predict(self, frame: Frame) -> Frame:
        """Score a frame on its device: regression -> 'predict';
        classification -> 'predict' plus one probability column per
        class."""
        out = self._predict_matrix(adapt_test_matrix(self, frame),
                                   offset=self._frame_offset(frame))
        if self.nclasses <= 1:
            return Frame(["predict"], [Vec(out.to(torch.float32))])
        out = self._correct_probabilities(out)
        lbl = torch.argmax(out, dim=1).to(torch.int32)
        names = ["predict"] + [f"p{d}" for d in self.response_domain]
        vecs = [Vec(lbl, T_ENUM, self.response_domain)]
        vecs += [Vec(out[:, k].contiguous()) for k in range(self.nclasses)]
        return Frame(names, vecs)

    def deploy(self, **serve_config):
        """Deploy this model for row serving (``h2o3_tpu_torch.serve``):
        the row codec's lookup tables, one CUDA graph of the predict a
        batch bucket on the card, and a micro-batcher. Returns the
        Deployment."""
        from h2o3_tpu_torch import serve
        return serve.deploy(self.key, model=self, **serve_config)

    def predict_rows(self, rows, timeout_ms=None):
        """Score a list of {column: value} dicts through the deployed
        micro-batcher, deploying with the defaults on first use; an
        existing deployment under this key is reused as it is."""
        from h2o3_tpu_torch import serve
        dep = serve.deployment(self.key) or self.deploy()
        return dep.predict_rows(rows, timeout_ms=timeout_ms)

    def __repr__(self):
        return f"<{type(self).__name__} {self.key}>"


# builder-level parameters every algorithm of the port understands
BUILDER_PARAMS = frozenset({"model_id", "ignored_columns", "weights_column",
                            "offset_column", "response_column",
                            "training_frame"})


class ModelBuilder:
    """Base trainer: ``train(x, y, training_frame)`` builds the spec and
    calls ``_train_impl``."""

    algo = "base"
    # parameters accepted for the reference API and not acted on, with
    # their defaults: train() warns for each one set away from it
    compat_params: Dict = {}

    def __init__(self, **params):
        self.params = dict(params)
        self.model: Optional[Model] = None

    def _warn_compat_params(self) -> None:
        for k, dflt in self.compat_params.items():
            if self.params.get(k) != dflt:
                warn(f"{self.algo}: parameter '{k}' is accepted for "
                     f"reference API compatibility but NOT implemented — "
                     f"value {self.params[k]!r} has no effect")

    def validate_sample_rate_per_class(self, spec: TrainingSpec):
        """The GBM's and the DRF's sample_rate_per_class, checked as the
        JAX package checks it (H2O's SharedTree): one rate per response
        class of a classification response. Returns the rates as a tuple
        of floats, or None."""
        srpc = self.params.get("sample_rate_per_class")
        if srpc is None or not len(srpc):
            return None
        if spec.nclasses < 2:
            raise ValueError("sample_rate_per_class requires a "
                             "classification response")
        if len(srpc) != spec.nclasses:
            raise ValueError(
                f"sample_rate_per_class must have {spec.nclasses} "
                f"values (one per class), got {len(srpc)}")
        return tuple(float(v) for v in srpc)

    def _model_key(self) -> str:
        mid = self.params.get("model_id")
        return str(mid) if mid else f"{self.algo}_{id(self) & 0xffffff:x}"

    def _train_impl(self, spec: TrainingSpec,
                    valid: Optional[TrainingSpec] = None) -> Model:
        raise NotImplementedError

    def _classification(self) -> Optional[bool]:
        return None

    def train(self, x: Optional[Sequence[str]] = None,
              y: Optional[str] = None,
              training_frame: Optional[Frame] = None,
              validation_frame: Optional[Frame] = None) -> "ModelBuilder":
        self._warn_compat_params()
        y = y or self.params.get("response_column")
        training_frame = (training_frame if training_frame is not None
                          else self.params.get("training_frame"))
        if training_frame is None or y is None:
            raise ValueError("train() needs training_frame and y")
        spec = build_training_spec(
            training_frame, y, x,
            ignored_columns=self.params.get("ignored_columns"),
            weights_column=self.params.get("weights_column"),
            offset_column=self.params.get("offset_column"),
            classification=self._classification())
        valid = None
        if validation_frame is not None:
            valid = build_validation_spec(
                validation_frame, spec,
                weights_column=self.params.get("weights_column"),
                offset_column=self.params.get("offset_column"))
        self.model = self._train_impl(spec, valid)
        return self
