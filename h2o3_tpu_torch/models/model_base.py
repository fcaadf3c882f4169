"""Model / ModelBuilder — the spine every algorithm of the port shares.

Counterpart of ``h2o3_tpu/models/model_base.py`` without jobs, the
keyed store, telemetry or recovery. A builder resolves a
``TrainingSpec`` from the training frame on the frame's device (and one
from a validation frame, adapted to it), applies class balancing to its
weights, trains there, fits the calibration and runs the
cross-validation folds, and returns a ``Model`` whose ``predict`` scores
a frame on that frame's device, and whose ``model_performance`` and
h2o-py accessors (``auc``, ``logloss``, ``rmse``, ``mse``, ``mae``,
``r2``) read its metrics. ``ScoreKeeper`` keeps the scoring history and
decides early stopping. The persistence hooks (``_save_arrays``,
``_save_extra_meta``, ``_restore``) serve ``h2o3_tpu_torch.persist`` and
the in-training checkpoints.

On a mesh (ROADMAP item 14) a spec stays where its frame is, unpadded;
the trainers split its rows over the data shards with ``RowShards``:
padded to ``mesh.padded_len`` with the JAX package's pad rows (weight 0,
response 0, NA features, offset 0) and cut into one block a data shard
on the shard's device, as the JAX package's ``Vec`` pads at upload.

The memory gate (``build_training_spec``): a design matrix that would
pass the device budget on top of the column payloads already there
(``memman``) stays on the host as ``TrainingSpec.X_host``, with
``stream`` set; a builder whose ``supports_streaming`` is set (the GBM
and the XGBoost estimator) then trains on row chunks
(``models/streaming.py``), any other raises.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from h2o3_tpu_torch import memman
from h2o3_tpu_torch.frame.frame import Frame
from h2o3_tpu_torch.frame.vec import T_ENUM, T_STR, Vec
from h2o3_tpu_torch.log import warn
from h2o3_tpu_torch.models import metrics as metrics_mod

# the class-balancing and calibration parameters with the JAX package's
# defaults (its ModelBuilder merges them for the GBM and the DRF)
BALANCE_DEFAULTS: Dict = dict(balance_classes=False,
                              class_sampling_factors=None,
                              max_after_balance_size=5.0)
CALIBRATION_DEFAULTS: Dict = dict(calibrate_model=False,
                                  calibration_frame=None,
                                  calibration_method="auto")
# the cross-validation parameters the JAX builder reads; none has a
# default there
CV_PARAMS = frozenset({"nfolds", "fold_column", "fold_assignment",
                       "parallelism"})

# the refusal of a keyed-store reference where the port takes an object
# or a path
DKV_REFUSED = ("is not ported yet: the keyed store comes with ROADMAP.md "
               "queue 1, item 18 (dkv.py)")


@dataclass
class TrainingSpec:
    """Resolved training inputs on the training frame's device."""
    X: Optional[torch.Tensor]    # [nrow, F] float32, NaN = NA; None if stream
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
    # memory-pressure mode (memman.fits_device said no): the design
    # matrix stays on the host as float32 numpy [nrow, F] and X is None;
    # y, w and the offset stay on the device
    X_host: Optional[np.ndarray] = None
    stream: bool = False

    @property
    def n_features(self) -> int:
        return len(self.names)

    @property
    def device(self) -> torch.device:
        return self.y.device


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
    # the memory gate: the design matrix is a fresh copy on top of the
    # column payloads already on the device (the frame's own count)
    mm = memman.manager()
    est_bytes = (frame.nrow + 256) * max(len(names), 1) * 4
    stream = not mm.fits_device(est_bytes
                                + mm.stats()["device_resident_bytes"])
    if stream:
        X, X_host = None, _host_matrix(frame, names)
    else:
        mm.request(est_bytes)
        X, X_host = frame.as_matrix(names), None
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
                        nclasses=nclasses, offset=offset, X_host=X_host,
                        stream=stream)


class RowShards:
    """A train's rows over the mesh's data axis: this process's blocks
    of a [nrow, ...] tensor, padded to ``padded_len(nrow, mesh)`` and
    cut into one contiguous block a local data shard (``ids``, their
    global indices), each on its shard's device. With one data shard
    nothing is padded, copied or cut: the one block is the tensor
    itself, and the train is the single-device train (over a process
    group of one, its reductions still pass through the group). A spec
    on another kind of device than the mesh's (a CPU frame under the
    default mesh of the cards) trains where it is, without the mesh."""

    def __init__(self, mesh, nrow: int, device: torch.device):
        from h2o3_tpu_torch.parallel.mesh import (n_data_shards, padded_len,
                                                  partitioner)
        if mesh is not None and mesh.lead_device.type != device.type:
            mesh = None
        self.mesh = mesh
        self.nrow = int(nrow)
        self.device = device
        self.single = mesh is None or n_data_shards(mesh) == 1
        if self.single:
            self.padded = self.nrow
            self.ids = [0]
            self.devices = [device]
        else:
            self.padded = padded_len(self.nrow, mesh)
            self.part = partitioner(mesh)
            self.ids = list(mesh.local_shards)
            self.devices = [mesh.device(s) for s in self.ids]

    def split(self, t: torch.Tensor, fill) -> List[torch.Tensor]:
        """This process's blocks of ``t`` ([nrow, ...]), the pad rows
        set to ``fill`` (a number, or a tensor broadcast over a row)."""
        if self.single:
            return [t]
        n = self.part.n_data
        if t.shape[0] != self.nrow and t.shape[0] % n:
            # the JAX package's refusal of a frame padded for another mesh
            raise ValueError(
                f"padded row count {t.shape[0]} is not divisible by the "
                f"{n}-shard data axis — the training frame was built "
                f"under a different mesh; rebuild it after "
                f"h2o3_tpu_torch.init()")
        if t.shape[0] != self.nrow:
            raise ValueError(f"{t.shape[0]} rows where the train has "
                             f"{self.nrow}")
        pad = self.padded - self.nrow
        if pad:
            tail = torch.empty((pad,) + tuple(t.shape[1:]), dtype=t.dtype,
                               device=t.device)
            tail[:] = fill
            t = torch.cat([t, tail])
        return self.part.shard_rows(t)

    def gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The [nrow, ...] tensor of every shard's block (the other
        processes' too, by ``all_gather``), on the spec's device."""
        if self.single:
            return parts[0]
        from h2o3_tpu_torch.parallel.collectives import all_gather
        blocks = all_gather(parts, self.mesh)
        return torch.cat(blocks)[:self.nrow].to(self.device)


_HOST_BLOCK = 1 << 20


def _host_matrix(frame: Frame, names) -> np.ndarray:
    """The design matrix on the host, float32 [nrow, F] (``as_matrix``'s
    values: enum codes as floats, NA -> NaN, a string column all NaN),
    for the streamed train. It stays pageable: the stream copies each
    chunk through pinned staging buffers of its own, so no call pins a
    frame-sized matrix."""
    out = np.empty((frame.nrow, len(names)), np.float32)
    cols = [None if frame.vec(n).type == T_STR else frame.vec(n).as_float()
            for n in names]
    # a block of rows at a time: the device holds one [block, F] matrix,
    # the host takes it in one contiguous copy
    for s in range(0, frame.nrow, _HOST_BLOCK):
        e = min(s + _HOST_BLOCK, frame.nrow)
        nan = torch.full((e - s,), torch.nan, dtype=torch.float32,
                         device=frame.device)
        out[s:e] = torch.stack([nan if c is None else c[s:e] for c in cols],
                               dim=1).cpu().numpy()
    return out


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
        self.cross_validation_metrics = None
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
        class priors. The identity where a train recorded no
        distributions (``balance_classes`` off)."""
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

    def model_performance(self, frame: Optional[Frame] = None):
        """The training metrics, or a frame's: its response remapped
        through the training response domain (an unseen label and NA
        take weight 0), the frame's offset applied, as the JAX package
        scores it (the rows' weights column is not read there either)."""
        if frame is None:
            return self.training_metrics
        out = self._predict_matrix(adapt_test_matrix(self, frame),
                                   offset=self._frame_offset(frame))
        if self.nclasses > 1:
            y, w = response_codes_in_domain(frame, self.response,
                                            self.response_domain)
            return compute_metrics(self._correct_probabilities(out), y, w,
                                   self.nclasses)
        spec_like = build_training_spec(frame, self.response,
                                        classification=False)
        return compute_metrics(out, spec_like.y, spec_like.w, 1)

    # -- h2o-py accessors ----------------------------------------------

    def _metric(self, name: str, valid: bool = False):
        m = self.validation_metrics if valid else self.training_metrics
        return getattr(m, name, None)

    def auc(self, valid: bool = False):
        return self._metric("auc", valid)

    def logloss(self, valid: bool = False):
        return self._metric("logloss", valid)

    def rmse(self, valid: bool = False):
        return self._metric("rmse", valid)

    def mse(self, valid: bool = False):
        return self._metric("mse", valid)

    def mae(self, valid: bool = False):
        return self._metric("mae", valid)

    def r2(self, valid: bool = False):
        return self._metric("r2", valid)

    def predict(self, frame: Frame) -> Frame:
        """Score a frame on its device: regression -> 'predict';
        classification -> 'predict' plus one probability column per
        class; a calibrated binomial model adds ``cal_p<label>`` for
        both classes (the JAX package's CalibrationHelper columns)."""
        out = self._predict_matrix(adapt_test_matrix(self, frame),
                                   offset=self._frame_offset(frame))
        if self.nclasses <= 1:
            return Frame(["predict"], [Vec(out.to(torch.float32))])
        out = self._correct_probabilities(out)
        lbl = torch.argmax(out, dim=1).to(torch.int32)
        names = ["predict"] + [f"p{d}" for d in self.response_domain]
        vecs = [Vec(lbl, T_ENUM, self.response_domain)]
        vecs += [Vec(out[:, k].contiguous()) for k in range(self.nclasses)]
        cal = self.output.get("calibration")
        if cal and self.nclasses == 2:
            q1 = calibrated_p1(cal, out[:, 1])
            names += [f"cal_p{self.response_domain[0]}",
                      f"cal_p{self.response_domain[1]}"]
            vecs += [Vec((1.0 - q1).to(torch.float32)),
                     Vec(q1.to(torch.float32))]
        return Frame(names, vecs)

    # -- persistence hooks (persist.save_model / load_model) ------------

    def _save_arrays(self) -> Dict[str, np.ndarray]:
        """The algorithm's arrays to persist."""
        return {}

    def _save_extra_meta(self) -> Dict[str, Any]:
        """The algorithm's JSON metadata to persist."""
        return {}

    def _restore_base(self, meta: Dict) -> "Model":
        """Set the base state from an artifact's metadata (the JAX
        package's ``_restore_base``; ``_restore`` builds the algorithm's
        part first)."""
        self.key = meta["key"]
        self.params = dict(meta["params"] or {})
        self.feature_names = list(meta["feature_names"])
        self.feature_is_cat = list(meta["feature_is_cat"])
        self.cat_domains = {k: tuple(v) for k, v in
                            (meta.get("cat_domains") or {}).items()}
        self.response = meta["response"]
        rd = meta.get("response_domain")
        self.response_domain = tuple(rd) if rd else None
        self.nclasses = meta["nclasses"]
        self.output = dict(meta.get("output") or {})
        return self

    @classmethod
    def _restore(cls, meta: Dict, arrays: Dict, device=None) -> "Model":
        raise NotImplementedError(f"{cls.__name__} does not support load")

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


def calibrated_p1(cal: Dict, p1: torch.Tensor) -> torch.Tensor:
    """The calibrated positive-class probability (float64) of the
    probabilities ``p1``, on their device: Platt's 1/(1 + exp(-(a·logit
    p + b))) or the isotonic knots interpolated as ``np.interp`` does
    (clipped at both ends), p clipped into [1e-12, 1 - 1e-12] first."""
    p = torch.clamp(p1.to(torch.float64), 1e-12, 1 - 1e-12)
    if cal["method"] == "platt":
        return 1.0 / (1.0 + torch.exp(-(cal["a"] * torch.log(p / (1 - p))
                                        + cal["b"])))
    tx = torch.tensor(cal["tx"], dtype=torch.float64, device=p.device)
    ty = torch.tensor(cal["ty"], dtype=torch.float64, device=p.device)
    if tx.numel() == 1:
        return ty[0].expand(p.shape).clone()
    j = torch.clamp(torch.searchsorted(tx, p, right=True) - 1, 0,
                    tx.numel() - 2)
    x0, x1, y0, y1 = tx[j], tx[j + 1], ty[j], ty[j + 1]
    q = (y1 - y0) / (x1 - x0) * (p - x0) + y0
    q = torch.where(p <= tx[0], ty[0], q)
    return torch.where(p >= tx[-1], ty[-1], q)


def pav(x, wy, w):
    """Weighted pool-adjacent-violators on knots already collapsed per
    distinct x (the port's copy of the JAX package's ``isotonic._pav``):
    blocks merge while their means do not increase; returns the knots
    (tx, ty), each block's two end points at its mean."""
    n = len(x)
    bx0 = np.empty(n)
    bx1 = np.empty(n)
    bwy = np.empty(n)
    bw = np.empty(n)
    top = 0
    for i in range(n):
        bx0[top] = x[i]
        bx1[top] = x[i]
        bwy[top] = wy[i]
        bw[top] = w[i]
        top += 1
        while top > 1 and (bwy[top - 2] * bw[top - 1]
                           >= bwy[top - 1] * bw[top - 2]):
            bwy[top - 2] += bwy[top - 1]
            bw[top - 2] += bw[top - 1]
            bx1[top - 2] = bx1[top - 1]
            top -= 1
    vals = bwy[:top] / bw[:top]
    tx, ty = [], []
    for i in range(top):
        tx.append(bx0[i])
        ty.append(vals[i])
        if bx1[i] != bx0[i]:
            tx.append(bx1[i])
            ty.append(vals[i])
    return np.asarray(tx), np.asarray(ty)


def platt(p1: np.ndarray, y: np.ndarray, w: np.ndarray):
    """Platt scaling's (a, b) by the JAX package's Newton loop: the
    weighted 1-D logistic fit of y on logit(p1), float64, at most 50
    steps."""
    z = np.log(p1 / (1.0 - p1))
    a, b = 1.0, 0.0
    for _ in range(50):
        mu = 1.0 / (1.0 + np.exp(-(a * z + b)))
        s = np.maximum(mu * (1 - mu), 1e-12) * w
        g = np.array([(w * (y - mu) * z).sum(), (w * (y - mu)).sum()])
        H = np.array([[(s * z * z).sum(), (s * z).sum()],
                      [(s * z).sum(), s.sum()]])
        d = np.linalg.solve(H + 1e-9 * np.eye(2), g)
        a += d[0]
        b += d[1]
        if np.abs(d).max() < 1e-10:
            break
    return float(a), float(b)


def persist_in_training_ckpt(model: "Model", algo: str,
                             ckpt_dir) -> Optional[str]:
    """Write an in-training checkpoint, ``<ckpt_dir>/<key>_t<n>.zip``
    for ``n`` committed trees (the JAX package's artifact; its keyed
    store entry waits for ROADMAP.md item 18). The caller attaches the
    resume state first. A failed write is logged and returns None: it
    never ends the train it protects."""
    from h2o3_tpu_torch.persist import save_model
    try:
        os.makedirs(ckpt_dir, exist_ok=True)
        return save_model(model, ckpt_dir, force=True,
                          filename=f"{model.key}_t{model.ntrees_built}.zip")
    except Exception as e:  # noqa: BLE001 — advisory only
        warn("%s: in-training checkpoint write failed: %s", algo, e)
        return None


# builder-level parameters every algorithm of the port understands
BUILDER_PARAMS = frozenset({"model_id", "ignored_columns", "weights_column",
                            "offset_column", "response_column",
                            "training_frame"}) | CV_PARAMS


class ModelBuilder:
    """Base trainer: ``train(x, y, training_frame)`` builds the spec and
    calls ``_train_impl``."""

    algo = "base"
    # parameters accepted for the reference API and not acted on, with
    # their defaults: train() warns for each one set away from it
    compat_params: Dict = {}
    # builders with a streamed (memory-pressure) path for spec.stream;
    # the others refuse a frame past the device budget
    supports_streaming = False

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

    def _validate_calibration(self, spec: TrainingSpec) -> None:
        """calibrate_model's checks before the train (the JAX package's):
        a calibration frame, a binomial response, a known method."""
        if self.params.get("calibration_frame") is None:
            raise ValueError("calibrate_model requires a calibration_frame")
        if spec.nclasses != 2:
            raise ValueError("model calibration is only supported for "
                             "binomial classification")
        _calibration_method(self.params)

    def _fit_calibration(self, model: Model) -> None:
        """calibrate_model, calibration_frame, calibration_method (the
        JAX package's CalibrationHelper): Platt scaling or isotonic
        regression (PAV) of the calibration frame's labels on the
        model's positive-class probability there; ``predict`` then adds
        the ``cal_p*`` columns. The probabilities come from the card;
        the fit runs on the host in float64, as in the JAX package."""
        cf = self.params.get("calibration_frame")
        if cf is None:
            raise ValueError("calibrate_model requires a calibration_frame")
        if isinstance(cf, str):
            raise NotImplementedError(
                f"calibration_frame={cf!r}: a frame key {DKV_REFUSED}")
        if model.nclasses != 2:
            raise ValueError("model calibration is only supported for "
                             "binomial classification")
        method = _calibration_method(self.params)
        out = model._predict_matrix(adapt_test_matrix(model, cf),
                                    offset=model._frame_offset(cf))
        probs = model._correct_probabilities(out)
        p1 = np.clip(probs[:, 1].to(torch.float64).cpu().numpy(), 1e-12,
                     1 - 1e-12)
        yc, w = response_codes_in_domain(cf, model.response,
                                         model.response_domain)
        yv = yc.cpu().numpy().astype(np.float64)
        wv = w.cpu().numpy().astype(np.float64)
        if method == "platt":
            a, b = platt(p1, yv, wv)
            model.output["calibration"] = {"method": "platt", "a": a, "b": b}
        else:
            ux, inv = np.unique(p1, return_inverse=True)
            tx, ty = pav(ux, np.bincount(inv, weights=wv * yv),
                         np.bincount(inv, weights=wv))
            model.output["calibration"] = {
                "method": "isotonic", "tx": [float(v) for v in tx],
                "ty": [float(v) for v in ty]}

    def _apply_balance_classes(self, spec: TrainingSpec) -> TrainingSpec:
        """balance_classes, class_sampling_factors,
        max_after_balance_size (the JAX package's: the class factors
        multiply the row weights, no rows move): factors from
        ``class_sampling_factors`` or, by default, total / (K · n_k),
        scaled down so that the weighted total stays within
        ``max_after_balance_size`` times the original. The prior and the
        balanced class distributions are kept for
        ``_correct_probabilities``. The class sums are one fixed-order
        sum a class; the codes index the factors clamped into [0, K)
        (an NA response has code 0 and weight 0)."""
        self._class_dists = None
        if not self.params.get("balance_classes") or spec.nclasses < 2:
            return spec
        if spec.stream:
            raise NotImplementedError(
                "balance_classes is not supported in streaming "
                "(memory-pressure) mode")
        K = spec.nclasses
        yc = torch.clamp(spec.y.long(), 0, K - 1)
        counts = torch.stack([(spec.w * (yc == k)).sum() for k in range(K)])
        ch = counts.cpu().numpy().astype(np.float64)
        total = float(ch.sum())
        if total <= 0:
            return spec
        csf = self.params.get("class_sampling_factors")
        if csf is not None and len(csf):
            fac = np.asarray(csf, np.float64)
            if fac.shape[0] != K:
                raise ValueError(
                    f"class_sampling_factors needs {K} values (one per "
                    f"response class), got {fac.shape[0]}")
        else:
            fac = total / (K * np.maximum(ch, 1.0))
        mabs = float(self.params.get("max_after_balance_size", 5.0) or 5.0)
        new_total = float((ch * fac).sum())
        if new_total > mabs * total:
            fac *= mabs * total / new_total
            new_total = mabs * total
        fac_d = torch.tensor(fac, dtype=torch.float32, device=spec.device)
        self._class_dists = ((ch / total).tolist(),
                             ((ch * fac) / max(new_total, 1e-12)).tolist())
        return replace(spec, w=spec.w * fac_d[yc])

    def train(self, x: Optional[Sequence[str]] = None,
              y: Optional[str] = None,
              training_frame: Optional[Frame] = None,
              validation_frame: Optional[Frame] = None) -> "ModelBuilder":
        """Build the spec, balance its classes, train, attach the class
        distributions, fit the calibration and, with ``nfolds`` > 1 or a
        ``fold_column``, run the cross-validation folds after the main
        model (the JAX package's order)."""
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
        spec = self._apply_balance_classes(spec)
        if self.params.get("calibrate_model"):
            self._validate_calibration(spec)
        if spec.stream and not self.supports_streaming:
            raise NotImplementedError(
                f"{self.algo}: the training frame exceeds the device memory "
                f"budget and this algorithm has no streaming "
                f"(memory-pressure) path — raise H2O3_DEVICE_BUDGET_BYTES, "
                f"reduce the frame, or use GBM/XGBoost/GLM which stream")
        valid = None
        if validation_frame is not None:
            valid = build_validation_spec(
                validation_frame, spec,
                weights_column=self.params.get("weights_column"),
                offset_column=self.params.get("offset_column"))
        model = self._train_impl(spec, valid)
        if getattr(self, "_class_dists", None):
            model.output["prior_class_dist"] = self._class_dists[0]
            model.output["model_class_dist"] = self._class_dists[1]
        if self.params.get("calibrate_model"):
            self._fit_calibration(model)
        nfolds = int(self.params.get("nfolds", 0) or 0)
        fold_column = self.params.get("fold_column")
        if nfolds > 1 or fold_column:
            self._attach_cv(model, training_frame, y, x,
                            *self._cv_fold_pass(training_frame, y, x, spec,
                                                nfolds, fold_column))
        self.model = model
        return self

    def _cv_fold_pass(self, frame: Frame, y: str, x, spec: TrainingSpec,
                      nfolds: int, fold_column: Optional[str]):
        """The JAX package's fold pass: fold ids from ``fold_column``, or
        ``fold_assignment="modulo"`` (row i in fold i % nfolds), or any
        other value numpy's ``default_rng(seed).integers(0, nfolds,
        nrow)``; then a model a fold on the other rows (the builder's
        parameters without nfolds, fold_column and parallelism; the
        folds run one after another on the frame's device, whatever
        ``parallelism`` says) and its raw predictions on the fold's rows.
        Returns (holdout, fold_models, fold, K, profile)."""
        nrow = frame.nrow
        if fold_column:
            fold = frame.vec(fold_column).to_numpy().astype(int)
            fold_ids = np.unique(fold)
        else:
            assignment = (self.params.get("fold_assignment")
                          or "auto").lower()
            seed = int(self.params.get("seed", -1) or -1)
            rng = np.random.default_rng(None if seed == -1 else seed)
            if assignment == "modulo":
                fold = np.arange(nrow) % nfolds
            else:
                fold = rng.integers(0, nfolds, size=nrow)
            fold_ids = np.arange(nfolds)
        K = spec.nclasses if spec.nclasses > 1 else 1
        holdout = np.full((nrow, K) if K > 1 else (nrow,), np.nan,
                          dtype=np.float32)
        sub_params = {k: v for k, v in self.params.items()
                      if k not in ("nfolds", "fold_column", "parallelism")}
        fold_models, profile = [], []
        for fid in fold_ids:
            mask = fold == fid
            t0 = time.monotonic()
            tr = frame.rows(~mask)
            te = frame.rows(mask)
            t1 = time.monotonic()
            sub = type(self)(**sub_params)
            sub.train(x=x, y=y, training_frame=tr)
            fm = sub.model
            t2 = time.monotonic()
            out = fm._predict_matrix(adapt_test_matrix(fm, te),
                                     offset=fm._frame_offset(te))
            holdout[mask] = out.cpu().numpy()
            fold_models.append(fm)
            profile.append({"fold": int(fid), "rows_s": t1 - t0,
                            "train_s": t2 - t1,
                            "predict_s": time.monotonic() - t2})
        return holdout, fold_models, fold, K, profile

    def _attach_cv(self, model: Model, frame: Frame, y: str, x, holdout,
                   fold_models, fold, K, profile) -> None:
        """The pooled holdout's metrics on the main model, over the rows
        with a response (weights of the response alone, as in the JAX
        package), and the holdout predictions, fold models and fold
        assignment in its output."""
        cv_spec = build_training_spec(frame, y, x,
                                      classification=model.nclasses > 1)
        ok = (cv_spec.w > 0).cpu().numpy()
        dev = cv_spec.device
        yh = cv_spec.y[torch.as_tensor(ok, device=dev)]
        wh = cv_spec.w[torch.as_tensor(ok, device=dev)]
        ho = torch.as_tensor(holdout[ok], device=dev)
        if K > 1:
            model.cross_validation_metrics = (
                metrics_mod.make_binomial_metrics(ho[:, 1], yh, wh)
                if K == 2 else
                metrics_mod.make_multinomial_metrics(ho, yh, wh))
        else:
            model.cross_validation_metrics = \
                metrics_mod.make_regression_metrics(ho, yh, wh)
        model.output["cross_validation_holdout_predictions"] = holdout
        model.output["cross_validation_models"] = fold_models
        model.output["cv_fold_assignment"] = fold
        model.output["cross_validation_profile"] = profile


def _calibration_method(params: Dict) -> str:
    """calibration_method spelled as the JAX package reads it: 'platt'
    (AUTO, PlattScaling) or 'isotonic' (IsotonicRegression); else
    ValueError."""
    method = str(params.get("calibration_method") or "auto").lower()
    method = method.replace("_scaling", "").replace("scaling", "") \
                   .replace("_regression", "").replace("regression", "")
    if method in ("auto", ""):
        return "platt"
    if method not in ("platt", "isotonic"):
        raise ValueError(
            f"unknown calibration_method "
            f"'{params.get('calibration_method')}' (one of AUTO, "
            f"PlattScaling, IsotonicRegression)")
    return method
