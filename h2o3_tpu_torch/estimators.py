"""Estimator namespace mirroring ``h2o3_tpu.estimators`` for what the
port supports: the GBM and the XGBoost estimator over it."""
from h2o3_tpu_torch.models.gbm import H2OGradientBoostingEstimator
from h2o3_tpu_torch.models.xgboost import H2OXGBoostEstimator

__all__ = ["H2OGradientBoostingEstimator", "H2OXGBoostEstimator"]
