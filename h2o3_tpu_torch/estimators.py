"""Estimator namespace mirroring ``h2o3_tpu.estimators`` for what the
port supports: the GBM, the XGBoost estimator over it, the random forest
and the GLM."""
from h2o3_tpu_torch.models.drf import H2ORandomForestEstimator
from h2o3_tpu_torch.models.gbm import H2OGradientBoostingEstimator
from h2o3_tpu_torch.models.glm import H2OGeneralizedLinearEstimator
from h2o3_tpu_torch.models.xgboost import H2OXGBoostEstimator

__all__ = ["H2OGeneralizedLinearEstimator", "H2OGradientBoostingEstimator",
           "H2ORandomForestEstimator", "H2OXGBoostEstimator"]
