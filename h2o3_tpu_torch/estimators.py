"""Estimator namespace mirroring ``h2o3_tpu.estimators`` for what the
port supports: the GBM."""
from h2o3_tpu_torch.models.gbm import H2OGradientBoostingEstimator

__all__ = ["H2OGradientBoostingEstimator"]
