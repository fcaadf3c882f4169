"""H2OXGBoostEstimator — the XGBoost parameter surface over the port's
GBM trainer.

Counterpart of ``h2o3_tpu/models/xgboost.py``: the same map of XGBoost's
parameter names onto the GBM's, in a plain function of the parameters
(``xgboost_gbm_params``), then the GBM's own checks on the result, so
that a value the port does not support yet raises the GBM's labelled
``NotImplementedError``. ``subsample`` and ``colsample_*`` train through
the GBM's row and column sampling.

  eta                   -> learn_rate          (default 0.3, XGBoost's)
  subsample             -> sample_rate
  colsample_bytree      -> col_sample_rate_per_tree
  colsample_bylevel     -> col_sample_rate
  max_bins              -> nbins (62 at most with tree_method auto/exact,
                           1022 at most with hist)
  gamma                 -> min_split_improvement
  reg_lambda (1.0)      -> L2 on leaf values
  reg_alpha             -> L1 soft-threshold on leaf values
  min_child_weight      -> min_rows
  tree_method auto/exact -> uniform_adaptive histograms; hist (or any
                           other) -> quantiles_global
  booster               -> gbtree only (dart and gblinear raise)

A parameter under either spelling wins over the XGBoost default. Keys
the map does not know and the GBM has no default for are dropped, as the
JAX estimator drops them (``weights_column`` and ``model_id`` among
them: ROADMAP.md queue 3). The model is the port's ``GBMModel``.
"""
from __future__ import annotations

from typing import Dict

from h2o3_tpu_torch.models.gbm import (GBM_DEFAULTS,
                                       H2OGradientBoostingEstimator)

XGB_DEFAULTS: Dict = dict(
    ntrees=50, max_depth=6, eta=0.3, subsample=1.0, colsample_bytree=1.0,
    colsample_bylevel=1.0, max_bins=256, min_child_weight=1.0,
    gamma=0.0, reg_lambda=1.0, reg_alpha=0.0, tree_method="auto",
    booster="gbtree", distribution="auto", seed=-1, stopping_rounds=0,
    stopping_metric="auto", stopping_tolerance=1e-3, score_tree_interval=0,
)

_ALIAS = {
    "learn_rate": "eta",
    "sample_rate": "subsample",
    "col_sample_rate_per_tree": "colsample_bytree",
    "col_sample_rate": "colsample_bylevel",
}

# the JAX package's GBM default that the port's GBM_DEFAULTS leaves out
# (its TPU kernel switch): the JAX map passes it through, and the port's
# GBM then refuses it as unknown
_JAX_ONLY_GBM_KEYS = frozenset({"hist_kernel"})


def xgboost_gbm_params(params: Dict) -> Dict:
    """The GBM parameters of XGBoost ``params``, mapped as the JAX
    estimator maps them; raises on a booster other than gbtree."""
    booster = (params.get("booster",
                          XGB_DEFAULTS["booster"]) or "gbtree").lower()
    if booster not in ("gbtree",):
        raise NotImplementedError(
            f"booster='{booster}' is not implemented (gbtree only; "
            f"the reference's dart/gblinear come from libxgboost)")
    tm = (params.get("tree_method",
                     XGB_DEFAULTS["tree_method"]) or "auto").lower()
    hist = ("uniform_adaptive" if tm in ("auto", "exact")
            else "quantiles_global")

    def pick(*names, default):
        # a value given under either spelling wins; the XGBoost default
        # applies only when neither was given
        for nm in names:
            if nm in params:
                return params[nm]
        return default

    max_bins = int(pick("max_bins", "nbins", default=256))
    gbm = dict(GBM_DEFAULTS)
    gbm.update(dict(
        ntrees=int(pick("ntrees", "n_estimators", default=50)),
        max_depth=int(pick("max_depth", default=6)),
        learn_rate=float(pick("eta", "learn_rate", default=0.3)),
        sample_rate=float(pick("subsample", "sample_rate", default=1.0)),
        col_sample_rate_per_tree=float(
            pick("colsample_bytree", "col_sample_rate_per_tree",
                 default=1.0)),
        col_sample_rate=float(
            pick("colsample_bylevel", "col_sample_rate", default=1.0)),
        # adaptive histograms recover resolution with depth, so auto
        # takes 62 bins (W = 64); hist keeps the global sketch's budget
        nbins=(min(max_bins - 2, 62) if hist == "uniform_adaptive"
               else min(max_bins - 2, 1022)),
        min_rows=float(pick("min_child_weight", "min_rows", default=1.0)),
        min_split_improvement=float(
            pick("gamma", "min_split_improvement", default=0.0)),
        reg_lambda=float(pick("reg_lambda", default=1.0)),
        reg_alpha=float(pick("reg_alpha", default=0.0)),
        histogram_type=hist,
        distribution=params.get("distribution", "auto"),
        seed=params.get("seed", -1),
        stopping_rounds=params.get("stopping_rounds", 0),
        stopping_metric=params.get("stopping_metric", "auto"),
        stopping_tolerance=params.get("stopping_tolerance", 1e-3),
        score_tree_interval=params.get("score_tree_interval", 0),
    ))
    handled = (set(_ALIAS) | set(_ALIAS.values()) | set(XGB_DEFAULTS)
               | {"n_estimators", "nbins", "min_rows",
                  "min_split_improvement"})
    for k, v in params.items():
        if (k in gbm or k in _JAX_ONLY_GBM_KEYS) and k not in handled:
            gbm[k] = v
    return gbm


class H2OXGBoostEstimator(H2OGradientBoostingEstimator):
    algo = "xgboost"

    def __init__(self, **params):
        super().__init__(**xgboost_gbm_params(params))
