"""GBM — gradient boosting on packed bin codes or adaptive bins.

Counterpart of ``h2o3_tpu/models/gbm.py``: the in-memory trainer
(``_train_dense``) and the per-tree body of its boosting chunk (K = 1),
as a Python loop. The trainer takes the JAX package's path for the same
parameters (``models/tree.py`` holds the rule): packed codes, binned once
per train by the global quantile sketch (``packed_codes`` 'auto' or True
on every device), or per-node adaptive bins on the raw features
(``packed_codes=False``, and the fallback where packing cannot hold the
bins). Per tree: (g, h) from the distribution at the current margin, one
tree grown, and the tree's leaf values folded back into the margin
through the leaf ids the grower already routed. Trees are fetched to the
host once, at the end.

Parameters the port does not support yet raise ``NotImplementedError``
naming the ROADMAP.md item that brings them; none is silently ignored.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from h2o3_tpu_torch import _device
from h2o3_tpu_torch.models.distributions import get_distribution, sigmoid
from h2o3_tpu_torch.models.model_base import (BUILDER_PARAMS, Model,
                                              ModelBuilder, TrainingSpec,
                                              compute_metrics)
from h2o3_tpu_torch.models.tree import (ADAPTIVE_HIST_TYPES,
                                        adaptive_feasible, adaptive_setup,
                                        binned_feasible,
                                        bins_to_thresholds_stacked,
                                        grow_tree_adaptive,
                                        grow_tree_binned,
                                        packed_bins_upper_bound,
                                        packed_codes_requested,
                                        predict_raw_stacked, tree_config)
from h2o3_tpu_torch.ops.binning import (bin_matrix_device, pack_codes,
                                        packed_codes_record)

# feature layout of the adaptive level kernels on the training path:
# "rows_f" ([rows, F], the training matrix as it is) or "f_rows"
# ([F, rows], one more copy of the features)
ADAPTIVE_LAYOUT = "rows_f"

# the JAX package's GBM_DEFAULTS without its TPU kernel switch
GBM_DEFAULTS: Dict = dict(
    ntrees=50, max_depth=5, min_rows=10.0, learn_rate=0.1,
    learn_rate_annealing=1.0, sample_rate=1.0, sample_rate_per_class=None,
    col_sample_rate=1.0, col_sample_rate_per_tree=1.0,
    col_sample_rate_change_per_level=1.0, nbins=20, nbins_cats=1024,
    distribution="auto", tweedie_power=1.5, quantile_alpha=0.5,
    huber_alpha=0.9, min_split_improvement=1e-5,
    seed=-1, stopping_rounds=0, stopping_metric="auto",
    stopping_tolerance=1e-3, score_tree_interval=0, reg_lambda=0.0,
    checkpoint=None, in_training_checkpoints_dir=None,
    in_training_checkpoints_tree_interval=1,
    max_abs_leafnode_pred=1e30, histogram_type="uniform_adaptive",
    monotone_constraints=None, interaction_constraints=None,
    histogram_precision="auto", packed_codes="auto",
    # read by the JAX trainer through params.get (xgboost-style L1)
    reg_alpha=0.0,
)

# parameters of the JAX GBM the port refuses until the named ROADMAP.md
# item (queue 1) lands: (name, predicate on its value, item)
_UNSUPPORTED = (
    ("histogram_type", lambda v: str(v or "").lower() == "random",
     "item A4, sampling: the per-tree generator of the grid phase"),
    ("distribution", lambda v: str(v or "auto").lower() == "multinomial",
     "item A1, multinomial GBM"),
    ("distribution", lambda v: str(v or "auto").lower() not in (
        "auto", "bernoulli", "binomial", "gaussian", "multinomial"),
     "item A6, the other distributions and offsets"),
    ("offset_column", bool, "item A6, the other distributions and offsets"),
    ("stopping_rounds", lambda v: int(v or 0) > 0,
     "item A2, scoring during training"),
    ("score_tree_interval", lambda v: int(v or 0) > 0,
     "item A2, scoring during training"),
    ("checkpoint", lambda v: v is not None, "item A3, checkpoints"),
    ("in_training_checkpoints_dir", bool, "item A3, checkpoints"),
    ("sample_rate", lambda v: float(v) != 1.0, "item A4, sampling"),
    ("sample_rate_per_class", lambda v: v is not None, "item A4, sampling"),
    ("col_sample_rate", lambda v: float(v) != 1.0, "item A4, sampling"),
    ("col_sample_rate_per_tree", lambda v: float(v) != 1.0,
     "item A4, sampling"),
    ("col_sample_rate_change_per_level", lambda v: float(v or 1.0) != 1.0,
     "item A4, sampling"),
    ("mtries", lambda v: v not in (None, 0, -1), "item A4, sampling"),
    ("monotone_constraints", bool, "item A5, constraints"),
    ("interaction_constraints", bool, "item A5, constraints"),
    ("nfolds", lambda v: int(v or 0) > 1,
     "item A7, cross-validation, class balancing and calibration"),
    ("fold_column", bool,
     "item A7, cross-validation, class balancing and calibration"),
    ("balance_classes", bool,
     "item A7, cross-validation, class balancing and calibration"),
    ("calibrate_model", bool,
     "item A7, cross-validation, class balancing and calibration"),
)
_REFUSED_ONLY = {"offset_column", "mtries", "nfolds", "fold_column",
                 "balance_classes", "calibrate_model"}


def check_params(params: Dict) -> None:
    """Raise on a parameter the port does not know or does not support
    yet."""
    known = set(GBM_DEFAULTS) | BUILDER_PARAMS | _REFUSED_ONLY
    unknown = sorted(set(params) - known)
    if unknown:
        raise ValueError(f"gbm: unknown parameter(s) {unknown}")
    for name, refused, item in _UNSUPPORTED:
        if name in params and refused(params[name]):
            raise NotImplementedError(
                f"gbm: {name}={params[name]!r} is not ported yet "
                f"(ROADMAP.md queue 1, {item})")


class GBMModel(Model):
    algo = "gbm"

    def __init__(self, key, params, names, nclasses, dist_name, f0,
                 trees_host, edges, n_bins, max_depth, ntrees_built,
                 device, response=None, response_domain=None):
        super().__init__(key, params, names, nclasses, response=response,
                         response_domain=response_domain)
        self.dist_name = dist_name
        self.f0 = np.array(f0, np.float32)
        self.edges = edges
        self.n_bins = n_bins
        self.max_depth = max_depth
        self.ntrees_built = ntrees_built
        self.device = device
        self.trees = trees_host               # host arrays [T, M]
        self._feat = torch.tensor(trees_host["feat"], device=device).long()
        self._thr = torch.tensor(trees_host["thr"], device=device)
        self._na_left = torch.tensor(trees_host["na_left"],
                                     device=device).bool()
        self._is_split = torch.tensor(trees_host["is_split"],
                                      device=device).bool()
        self._value = torch.tensor(trees_host["value"], device=device)

    @classmethod
    def from_jax_arrays(cls, arrays: Dict[str, np.ndarray], meta: Dict,
                        device=None) -> "GBMModel":
        """A model from the JAX package's ``GBMModel._save_arrays()``
        dict (feat, thr, na_left, is_split, value, node_w, f0, edge_i)
        and ``meta`` (dist_name, n_bins, max_depth, ntrees_built,
        nclasses, names, response_domain)."""
        if int(meta["nclasses"]) > 2:
            raise NotImplementedError(
                "multinomial GBM is not ported yet (ROADMAP.md queue 1, "
                "item A1, multinomial GBM)")
        n_edges = sum(1 for k in arrays if k.startswith("edge_"))
        trees = {k: np.asarray(arrays[k]) for k in
                 ("feat", "thr", "na_left", "is_split", "value")}
        if "node_w" in arrays:
            trees["node_w"] = np.asarray(arrays["node_w"])
        return cls(f"gbm_{id(arrays) & 0xffffff:x}", {}, meta["names"],
                   int(meta["nclasses"]), meta["dist_name"],
                   np.asarray(arrays["f0"], np.float32), trees,
                   [np.asarray(arrays[f"edge_{i}"]) for i in range(n_edges)],
                   int(meta["n_bins"]), int(meta["max_depth"]),
                   int(meta["ntrees_built"]), _device.resolve(device),
                   response_domain=meta.get("response_domain"))

    def _margin_matrix(self, X: torch.Tensor) -> torch.Tensor:
        contribs = predict_raw_stacked(X, self._feat, self._thr,
                                       self._na_left, self._is_split,
                                       self._value, self.max_depth)
        return torch.as_tensor(self.f0, device=X.device) + contribs.sum(1)

    def _predict_matrix(self, X: torch.Tensor) -> torch.Tensor:
        margin = self._margin_matrix(X.to(self.device))
        if self.nclasses <= 1:
            return get_distribution(self.dist_name).predict(margin)
        p1 = sigmoid(margin)
        return torch.stack([1.0 - p1, p1], dim=1)


class H2OGradientBoostingEstimator(ModelBuilder):
    algo = "gbm"

    def __init__(self, **params):
        check_params(params)
        merged = dict(GBM_DEFAULTS)
        merged.update(params)
        super().__init__(**merged)

    def _distribution(self, spec: TrainingSpec) -> str:
        d = (self.params.get("distribution") or "auto").lower()
        if d in ("auto", ""):
            if spec.nclasses > 2:
                d = "multinomial"
            else:
                d = "bernoulli" if spec.nclasses == 2 else "gaussian"
        if d == "multinomial" or spec.nclasses > 2:
            raise NotImplementedError(
                "multinomial GBM is not ported yet (ROADMAP.md queue 1, "
                "item A1, multinomial GBM)")
        return d

    def _classification(self):
        d = (self.params.get("distribution") or "").lower()
        if d in ("bernoulli", "binomial", "multinomial"):
            return True
        if d and d != "auto":
            return False
        return None

    def _train_impl(self, spec: TrainingSpec) -> GBMModel:
        p = self.params
        dist_name = self._distribution(spec)
        dev = spec.device
        t_bin0 = time.monotonic()
        cfg, grow, bm, pc = self._grower(spec)
        t_bin = time.monotonic() - t_bin0

        dist = get_distribution(dist_name)
        yf = spec.y.to(torch.float32)
        w = spec.w
        f0 = dist.init_f0(yf, w).to(torch.float32)
        margin = f0.expand(spec.nrow).contiguous()
        ntrees = int(p["ntrees"])
        if ntrees < 1:
            raise ValueError(f"gbm: ntrees must be >= 1, got {ntrees}")
        lr = np.float32(p["learn_rate"])
        anneal = np.float32(p["learn_rate_annealing"])
        trees: List[dict] = []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_loop0 = time.monotonic()
        for _ in range(ntrees):
            g, h = dist.grad_hess(margin, yf)
            tree, nid = grow(g * w, h * w, w)
            margin = margin + float(lr) * tree["value"][nid.long()]
            trees.append(tree)
            lr = np.float32(lr * anneal)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_loop = time.monotonic() - t_loop0

        t_fin0 = time.monotonic()
        model = self._finalize(spec, dist_name, f0, trees, bm, cfg, dev)
        model.training_metrics = self._metrics_from_margin(margin, spec,
                                                           dist)
        t_fin = time.monotonic() - t_fin0
        model.output["training_loop_seconds"] = t_loop
        model.output["train_profile"] = {"bin_s": t_bin, "loop_s": t_loop,
                                         "finalize_s": t_fin}
        model.output["packed_codes"] = packed_codes_record(
            pc, bm.n_bins if pc is not None else None)
        return model

    def _grower(self, spec: TrainingSpec):
        """The JAX package's path rule (its ``_train_dense``) and the
        chosen path's set-up. Returns (cfg, grow(g, h, w) -> (tree, nid),
        bm, pc), with bm and pc None on the adaptive path; raises where
        the JAX package would take the global-sketch grower."""
        p = self.params
        hist_type = (p.get("histogram_type") or "uniform_adaptive").lower()
        depth = int(p["max_depth"])

        def adaptive():
            cfg, root_lo, root_hi, nb_f = adaptive_setup(spec, p, depth)
            x = (spec.X if ADAPTIVE_LAYOUT == "rows_f"
                 else spec.X.t().contiguous())

            def grow(g, h, w):
                return grow_tree_adaptive(x, g, h, w, cfg, root_lo, root_hi,
                                          nb_f=nb_f, layout=ADAPTIVE_LAYOUT)
            return cfg, grow, None, None

        packed_req = packed_codes_requested(p) and hist_type != "random"
        feasible = adaptive_feasible(spec, p, depth)
        can_adapt = hist_type in ADAPTIVE_HIST_TYPES and feasible
        if packed_req and can_adapt and not binned_feasible(
                packed_bins_upper_bound(spec, p), spec.n_features, depth):
            # packing cannot hold the categorical domains' bins: adaptive
            # bins, without paying for the sketch
            packed_req = False
        if not packed_req and (can_adapt or hist_type == "random"
                               and feasible):
            return adaptive()
        if packed_req:
            bm = bin_matrix_device(spec.X, spec.names, spec.is_cat,
                                   nbins=max(int(p["nbins"]), 2),
                                   nbins_cats=int(p["nbins_cats"]),
                                   histogram_type=hist_type)
            if binned_feasible(bm.n_bins, spec.n_features, depth):
                pc = pack_codes(bm)
                bm.codes = None            # the packed codes replace them
                cfg = tree_config(p, depth, bm.n_bins, spec.n_features)
                return (cfg, lambda g, h, w: grow_tree_binned(pc.rm, g, h, w,
                                                              cfg), bm, pc)
            if can_adapt:
                # the sketch's bin count is past the packed lanes
                return adaptive()
        raise NotImplementedError(
            f"gbm: histogram_type={hist_type!r}, nbins={p['nbins']}, "
            f"packed_codes={p.get('packed_codes', 'auto')!r} takes the "
            f"global-sketch grower, which is not ported yet (ROADMAP.md "
            f"queue 1, item 12)")

    def _finalize(self, spec, dist_name, f0, trees, bm, cfg, dev):
        """One fetch of the stacked trees, raw thresholds (unbinned from
        the packed path's split bins; the adaptive grower's as they are),
        leaf values scaled by each tree's learning rate, variable
        importances."""
        keys = ("feat", "na_left", "is_split", "value", "gain", "node_w",
                "thr" if bm is None else "split_bin")
        th = {k: torch.stack([t[k] for t in trees]).cpu().numpy()
              for k in keys}
        T = len(trees)
        lr0 = float(self.params["learn_rate"])
        anneal = float(self.params["learn_rate_annealing"])
        lrs = lr0 * anneal ** np.arange(T)
        trees_host = {
            "feat": th["feat"], "na_left": th["na_left"],
            "is_split": th["is_split"],
            "value": (th["value"].astype(np.float64)
                      * lrs[:, None]).astype(np.float32),
            "node_w": th["node_w"]}
        if bm is None:
            edges = []
            trees_host["thr"] = th["thr"]
        else:
            edges = bm.edges
            trees_host["split_bin"] = th["split_bin"]
            trees_host["thr"] = bins_to_thresholds_stacked(
                th["split_bin"], th["feat"], edges)
        model = GBMModel(self._model_key(), self.params, spec.names,
                         spec.nclasses, dist_name, f0.cpu().numpy(),
                         trees_host, edges, cfg.n_bins, cfg.max_depth, T,
                         dev, response=spec.response,
                         response_domain=spec.response_domain)
        vi = np.zeros(len(spec.names))
        live = th["feat"] >= 0
        np.add.at(vi, th["feat"][live], th["gain"][live])
        order = np.argsort(-vi)
        rel = vi / vi.max() if vi.max() > 0 else vi
        model.output["variable_importances"] = {
            "variable": [spec.names[i] for i in order],
            "relative_importance": vi[order].tolist(),
            "scaled_importance": rel[order].tolist(),
            "percentage": (vi[order] / vi.sum() if vi.sum() > 0
                           else vi[order]).tolist()}
        return model

    def _metrics_from_margin(self, margin, spec, dist):
        if spec.nclasses == 2:
            p1 = sigmoid(margin)
            probs = torch.stack([1.0 - p1, p1], dim=1)
            return compute_metrics(probs, spec.y, spec.w, 2)
        mu = dist.predict(margin)
        dev = float(dist.deviance(spec.w, spec.y.to(torch.float32), mu))
        return compute_metrics(mu, spec.y, spec.w, 1, deviance=dev)
