"""Sampling (ROADMAP item A4) in the port's GBM and XGBoost against the
JAX package: each sampling parameter trains in both packages on the
packed, adaptive and global-sketch paths (3000 rows x 6 features with 3%
NA cells, depth 3, 3 trees, float32 histograms) and gives equal trees
(feat, thr, na_left and is_split exactly, value within rtol = atol =
1e-5, as in test_torch_gbm.py) that differ from the unsampled train's;
the multinomial GBM with column sampling; sample_rate_per_class,
binomial and multinomial, with NA response rows; histogram_type
"random"; XGBoost's subsample, colsample_bytree and colsample_bylevel;
rates of 1 make no draw; the per-class rates' checks and warning.

The JAX trains run on a one-device mesh: both JAX loops fold the row
key with the data shard's index, and on the suite's eight virtual
devices each shard draws its own rows."""
import logging

import jax
import numpy as np
import pytest

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as JaxGBM
from h2o3_tpu.models.xgboost import H2OXGBoostEstimator as JaxXGB
from h2o3_tpu.parallel.mesh import current_mesh, make_mesh, set_mesh
from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                       H2OXGBoostEstimator)
from h2o3_tpu_torch.ops import random as trandom
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

ROWS, F = 3000, 6
BASE = dict(ntrees=3, max_depth=3, learn_rate=0.1, seed=7,
            histogram_precision="float32")
# the three growers: (the port's parameters, the JAX package's extra)
PATHS = {
    "packed": (dict(nbins=14, histogram_type="quantiles_global",
                    min_rows=1.0), dict(packed_codes=True)),
    "adaptive": (dict(nbins=20, packed_codes=False, min_rows=10.0), {}),
    "global": (dict(nbins=20, histogram_type="quantiles_global",
                    packed_codes=False, min_rows=1.0), {}),
}
SAMPLING = {
    "sample_rate": dict(sample_rate=0.7),
    "col_sample_rate": dict(col_sample_rate=0.45),
    "col_sample_rate_per_tree": dict(col_sample_rate_per_tree=0.5),
    "col_sample_rate_change_per_level": dict(
        col_sample_rate_change_per_level=0.7),
    "all": dict(sample_rate=0.8, col_sample_rate=0.8,
                col_sample_rate_change_per_level=0.9),
}
LABELS = np.array(["ash", "birch", "cedar", "dogwood"], dtype=object)


@pytest.fixture(autouse=True, scope="module")
def _one_jax_device():
    old = current_mesh()
    set_mesh(make_mesh(n_data=1, devices=jax.devices()[:1]))
    yield
    set_mesh(old)


def _cols(k=2, seed=0, na_response=0):
    """Six normal features with 3% NA cells; a k-class label from a
    softmax of linear scores: 0/1 floats for k = 2, strings beyond; the
    first ``na_response`` rows' labels NA."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(ROWS, F)).astype(np.float32)
    coef = np.random.default_rng(99).normal(size=(F, k)) * 1.2
    s = X @ coef + 0.4 * np.sin(2 * X[:, :1])
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    y = np.minimum((rng.random((ROWS, 1)) > np.cumsum(p, axis=1)).sum(1),
                   k - 1)
    X[rng.random(X.shape) < 0.03] = np.nan
    cols = {f"f{i}": X[:, i] for i in range(F)}
    if k == 2:
        lab = y.astype(np.float32)
        lab[:na_response] = np.nan
    else:
        lab = LABELS[y].copy()
        lab[:na_response] = None
    cols["label"] = lab
    return cols


def _train(cols, jax_est, torch_est, kw, jax_kw=None):
    jfr = jh2o.Frame.from_numpy(cols)
    tfr = th2o.Frame.from_numpy(cols, device="cpu")
    jm = jax_est(**(jax_kw or {}), **kw).train(
        y="label", training_frame=jfr).model
    tm = torch_est(**kw).train(y="label", training_frame=tfr).model
    return jm, tm


def _same_trees(jm, tm):
    assert tm.ntrees_built == jm.ntrees_built
    assert bool(tm.trees["is_split"].any())
    for key in ("feat", "thr", "na_left", "is_split"):
        np.testing.assert_array_equal(tm.trees[key],
                                      np.asarray(getattr(jm, "_" + key)),
                                      err_msg=key)
    np.testing.assert_allclose(tm.trees["value"], np.asarray(jm._value),
                               rtol=1e-5, atol=1e-5)


_UNSAMPLED = {}


def _unsampled(path, k=2):
    """The port's train of ``path`` without sampling (module cache)."""
    if (path, k) not in _UNSAMPLED:
        tp, _jp = PATHS[path]
        kw = dict(BASE, **tp)
        if k == 2:
            kw["distribution"] = "bernoulli"
        tfr = th2o.Frame.from_numpy(_cols(k), device="cpu")
        _UNSAMPLED[(path, k)] = H2OGradientBoostingEstimator(**kw).train(
            y="label", training_frame=tfr).model
    return _UNSAMPLED[(path, k)]


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("which", list(SAMPLING))
def test_sampled_gbm_trees_match_jax(path, which):
    tp, jp = PATHS[path]
    kw = dict(BASE, distribution="bernoulli", **tp, **SAMPLING[which])
    jm, tm = _train(_cols(), JaxGBM, H2OGradientBoostingEstimator, kw, jp)
    _same_trees(jm, tm)
    assert tm.output["packed_codes"] == jm.output["packed_codes"]
    assert abs(tm.training_metrics.auc - jm.training_metrics.auc) <= 1e-6
    assert not np.array_equal(tm.trees["feat"],
                              _unsampled(path).trees["feat"]) or \
        not np.array_equal(tm.trees["thr"], _unsampled(path).trees["thr"])


@pytest.mark.parametrize("path", ["packed", "adaptive"])
def test_multinomial_column_sampling_matches_jax(path):
    """One column mask and one key an iteration, shared by its K
    trees."""
    tp, jp = PATHS[path]
    kw = dict(BASE, **tp, col_sample_rate=0.5, sample_rate=0.8)
    jm, tm = _train(_cols(k=4), JaxGBM, H2OGradientBoostingEstimator, kw,
                    jp)
    assert tm.trees["feat"].shape[0] == 3 * 4
    _same_trees(jm, tm)
    assert abs(tm.training_metrics.logloss
               - jm.training_metrics.logloss) <= 1e-6
    assert not np.array_equal(tm.trees["feat"],
                              _unsampled(path, 4).trees["feat"])


@pytest.mark.parametrize("k,rates", [(2, [0.4, 0.9]),
                                     (4, [0.9, 0.3, 0.6, 1.0])])
def test_sample_rate_per_class_with_na_responses_matches_jax(k, rates):
    """Per-class rates by response code; the NA rows (weight 0, code
    clamped into range) stay out of every tree."""
    tp, jp = PATHS["packed"]
    kw = dict(BASE, **tp, sample_rate_per_class=rates)
    if k == 2:
        kw["distribution"] = "bernoulli"
    jm, tm = _train(_cols(k=k, na_response=5), JaxGBM,
                    H2OGradientBoostingEstimator, kw, jp)
    _same_trees(jm, tm)
    assert tm.training_metrics.nobs == jm.training_metrics.nobs == ROWS - 5


def test_histogram_type_random_matches_jax():
    """The per-tree grid phase uniform(fold_in(key, 7919), (F,)) on the
    adaptive grower, with row sampling and per-level column subsets."""
    kw = dict(BASE, distribution="bernoulli", nbins=20, min_rows=10.0,
              histogram_type="random", sample_rate=0.8,
              col_sample_rate_change_per_level=0.8)
    jm, tm = _train(_cols(), JaxGBM, H2OGradientBoostingEstimator, kw)
    assert tm.output["packed_codes"] == {"enabled": False}
    _same_trees(jm, tm)
    assert not np.array_equal(tm.trees["thr"],
                              _unsampled("adaptive").trees["thr"])


@pytest.mark.parametrize("params", [
    dict(subsample=0.8), dict(colsample_bytree=0.5),
    dict(colsample_bylevel=0.7),
    dict(subsample=0.7, colsample_bytree=0.8, tree_method="hist")],
    ids=lambda p: ",".join(sorted(p)))
def test_xgboost_sampling_matches_jax(params):
    kw = dict(ntrees=3, max_depth=4, seed=7, distribution="bernoulli",
              histogram_precision="float32", **params)
    jm, tm = _train(_cols(), JaxXGB, H2OXGBoostEstimator, kw,
                    dict(packed_codes=True))
    _same_trees(jm, tm)


def test_default_rates_make_no_draw(monkeypatch):
    """sample_rate, the column rates and their change per level at 1, no
    per-class rates, histogram_type uniform_adaptive: no draw at all (the
    JAX package's u < 1 keeps every row and column), on every path."""
    from h2o3_tpu_torch.models import tree
    calls = []
    for name in ("uniform", "sample_weights", "uniform_below",
                 "level_subset"):
        orig = getattr(tree, name)
        monkeypatch.setattr(tree, name, lambda *a, _o=orig, _n=name, **k:
                            calls.append(_n) or _o(*a, **k))
    for path in PATHS:
        tp, _jp = PATHS[path]
        fr = th2o.Frame.from_numpy(_cols(), device="cpu")
        H2OGradientBoostingEstimator(
            **dict(BASE, distribution="bernoulli", **tp)).train(
            y="label", training_frame=fr)
    assert calls == []
    H2OGradientBoostingEstimator(
        **dict(BASE, distribution="bernoulli", sample_rate=0.5)).train(
        y="label", training_frame=fr)
    assert calls == ["sample_weights"] * BASE["ntrees"]


def test_gbm_accepts_mtries_and_ignores_it():
    """The JAX GBM accepts DRF's mtries and never reads it: the trees are
    the unsampled ones."""
    tp, jp = PATHS["packed"]
    kw = dict(BASE, distribution="bernoulli", mtries=2, **tp)
    jm, tm = _train(_cols(), JaxGBM, H2OGradientBoostingEstimator, kw, jp)
    _same_trees(jm, tm)
    np.testing.assert_array_equal(tm.trees["feat"],
                                  _unsampled("packed").trees["feat"])


def test_sample_rate_per_class_checks_and_warning(caplog):
    fr = th2o.Frame.from_numpy(_cols(), device="cpu")
    with pytest.raises(ValueError, match="one per class"):
        H2OGradientBoostingEstimator(
            ntrees=1, distribution="bernoulli",
            sample_rate_per_class=[0.5]).train(y="label", training_frame=fr)
    with pytest.raises(ValueError, match="classification response"):
        H2OGradientBoostingEstimator(
            ntrees=1, distribution="gaussian",
            sample_rate_per_class=[0.5, 0.5]).train(
            y="label", training_frame=fr)
    with caplog.at_level(logging.WARNING):
        H2OGradientBoostingEstimator(
            ntrees=1, max_depth=2, distribution="bernoulli", sample_rate=0.5,
            sample_rate_per_class=[0.5, 0.5]).train(
            y="label", training_frame=fr)
    assert "sample_rate is ignored" in caplog.text


def test_sampled_trains_repeat_and_seeds_differ():
    """The same seed draws the same trees; another seed other ones."""
    fr = th2o.Frame.from_numpy(_cols(), device="cpu")
    kw = dict(BASE, distribution="bernoulli", sample_rate=0.6,
              col_sample_rate=0.7)
    a, b, c = (H2OGradientBoostingEstimator(**dict(kw, seed=s)).train(
        y="label", training_frame=fr).model for s in (3, 3, 4))
    for key in ("feat", "thr", "value"):
        np.testing.assert_array_equal(a.trees[key], b.trees[key])
    assert not np.array_equal(a.trees["thr"], c.trees["thr"])
    assert trandom.train_key(3) != trandom.train_key(4)
