"""Parity of the port's metrics (h2o3_tpu_torch.models.metrics) with the
JAX package: the exact sweep, the 2^17-bucket curve above 200k rows,
auc_device and the regression kernel."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.models import metrics as jm
from h2o3_tpu_torch.models import metrics as tm


def _scores(n, seed):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.4).astype(np.float32)
    p = np.clip(0.5 + 0.25 * (y - 0.4) + 0.2 * rng.normal(size=n), 0, 1)
    p = np.round(p.astype(np.float32), 3)        # ties, as real scores have
    w = np.ones(n, np.float32)
    w[rng.random(n) < 0.05] = 2.0
    return p, y, w


@pytest.mark.parametrize("n", [5_000, 250_000])
def test_binomial_metrics_match_jax(n):
    p, y, w = _scores(n, seed=n)
    got = tm.make_binomial_metrics(torch.as_tensor(p), torch.as_tensor(y),
                                   torch.as_tensor(w))
    want = jm.make_binomial_metrics(jnp.asarray(p), jnp.asarray(y),
                                    jnp.asarray(w))
    for k in ("auc", "aucpr", "logloss", "mse", "r2", "max_f1",
              "f1_threshold", "mean_per_class_error", "accuracy"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), rel=1e-6,
                                                abs=1e-7), k
    np.testing.assert_allclose(got.confusion_matrix, want.confusion_matrix,
                               rtol=1e-6)
    assert got.nobs == want.nobs == n
    gl_t = got.thresholds_and_metric_scores["gains_lift"]
    gl_j = want.thresholds_and_metric_scores["gains_lift"]
    np.testing.assert_allclose(gl_t["cumulative_lift"],
                               gl_j["cumulative_lift"], rtol=1e-6)


def test_auc_device_matches_jax():
    p, y, w = _scores(20_000, seed=1)
    got = float(tm.auc_device(torch.as_tensor(p), torch.as_tensor(y),
                              torch.as_tensor(w)))
    want = float(jm.auc_device(jnp.asarray(p), jnp.asarray(y),
                               jnp.asarray(w)))
    assert got == pytest.approx(want, rel=1e-6)


def test_regression_metrics_match_jax():
    rng = np.random.default_rng(2)
    a = rng.normal(size=3000).astype(np.float32)
    pred = (a + 0.3 * rng.normal(size=3000)).astype(np.float32)
    got = tm.make_regression_metrics(torch.as_tensor(pred),
                                     torch.as_tensor(a))
    want = jm.make_regression_metrics(jnp.asarray(pred), jnp.asarray(a))
    for k in ("mse", "rmse", "mae", "r2"):
        assert getattr(got, k) == pytest.approx(getattr(want, k), rel=1e-5), k
    assert np.isnan(got.rmsle) and np.isnan(want.rmsle)
