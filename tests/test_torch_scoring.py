"""Scoring during training against the JAX package: ScoreKeeper's
stopping rule, the fixed-order auc_device (its card test is in
test_torch_auc_cuda.py), validation specs adapted to
the training domains, and GBM and XGBoost trains with a validation
frame, score_tree_interval and early stopping (stopping_metric auto =
logloss, AUC, and deviance on a gaussian GBM): the same number of trees,
the same scoring history, the same trees and validation metrics."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu.models import metrics as jmetrics
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as JaxGBM
from h2o3_tpu.models.model_base import ScoreKeeper as JaxKeeper
from h2o3_tpu.models.model_base import \
    build_training_spec as jax_training_spec
from h2o3_tpu.models.model_base import \
    build_validation_spec as jax_validation_spec
from h2o3_tpu.models.xgboost import H2OXGBoostEstimator as JaxXGB
from h2o3_tpu.parallel.mesh import current_mesh, make_mesh, set_mesh
from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                       H2OXGBoostEstimator)
from h2o3_tpu_torch.models import metrics as tmetrics
from h2o3_tpu_torch.models.model_base import ScoreKeeper
from h2o3_tpu_torch.models.model_base import \
    build_training_spec as torch_training_spec
from h2o3_tpu_torch.models.model_base import \
    build_validation_spec as torch_validation_spec
from test_torch_auc_cuda import auc_inputs
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

F = 8


@pytest.fixture(autouse=True, scope="module")
def _one_jax_device():
    """The JAX trains of this module on a one-device mesh: under the
    suite's eight virtual devices the JAX histograms add their shards in
    another order, and on the global sketch's sibling subtraction that
    leaves last-bit residues in NA bins that no row fills, which then
    decide the NA side of such splits either way. On one device the two
    packages add in one order and every split compares exactly."""
    old = current_mesh()
    set_mesh(make_mesh(n_data=1, devices=jax.devices()[:1]))
    yield
    set_mesh(old)


def _cols(rows, seed, gaussian=False):
    """HIGGS-like columns with 3% NA cells; a logistic label, or a noisy
    linear one."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, F)).astype(np.float32)
    logit = (X[:, 0] * 1.5 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
             + 0.3 * np.sin(3 * X[:, 4]))
    if gaussian:
        y = (logit + rng.normal(size=rows)).astype(np.float32)
    else:
        y = (rng.random(rows) < 1.0 / (1.0 + np.exp(-logit))).astype(
            np.float32)
    X[rng.random(X.shape) < 0.03] = np.nan
    cols = {f"f{i}": X[:, i] for i in range(F)}
    cols["label"] = y
    return cols


# ----------------------------------------------------------- ScoreKeeper

def _seq(start, steps, n=12):
    out = [start]
    for i in range(n - 1):
        out.append(out[-1] + steps[i % len(steps)])
    return out


@pytest.mark.parametrize("rounds,metric,tol,task,key,scores", [
    (2, "auto", 1e-3, "binomial", "logloss",
     _seq(0.6, [-0.02, -0.01, -0.001, -0.0001])),
    (3, "AUC", 1e-3, "binomial", "auc", _seq(0.70, [0.02, 0.01, 0.0002])),
    (1, "auc", 0.0, "binomial", "auc", _seq(0.80, [0.001, -0.002])),
    (2, "auto", 1e-3, "regression", "deviance",
     _seq(1.0, [-0.1, -0.05, 0.0])),
    (2, "MSE", 1e-2, "regression", "mse", _seq(2.0, [-0.3, -0.01])),
    (2, "rmse", 1e-3, "regression", "rmse", _seq(2.0, [0.01, -0.5])),
    # a metric the entries do not carry falls back to the deviance
    (2, "misclassification", 1e-3, "binomial", "deviance",
     _seq(1.2, [-0.05, -0.0001])),
    # scores crossing zero keep their band (|prev| scaling)
    (2, "deviance", 1e-1, "regression", "deviance",
     _seq(0.3, [-0.1, -0.15, -0.001])),
    (0, "auto", 1e-3, "binomial", "logloss", _seq(0.6, [0.0])),
])
def test_score_keeper_matches_jax(rounds, metric, tol, task, key, scores):
    """The stopping decision after every entry equals the JAX class's."""
    ours = ScoreKeeper(rounds, metric, tol, task)
    theirs = JaxKeeper(rounds, metric, tol, task)
    assert ours.metric == theirs.metric
    decisions = []
    for i, s in enumerate(scores):
        entry = {"ntrees": 5 * (i + 1), key: float(s)}
        if key != "deviance":
            entry["deviance"] = 2.0 * float(s)
        ours.record(dict(entry))
        theirs.record(dict(entry))
        decisions.append(ours.should_stop())
        assert decisions[-1] == theirs.should_stop(), i
    assert ours.history == theirs.history
    if rounds:
        assert not decisions[0]


# ------------------------------------------------------------ auc_device

@pytest.mark.parametrize("n,seed,ties,weights", [
    (500, 0, False, "ones"), (2000, 1, True, "ones"),
    (3000, 2, True, "int"), (3000, 3, False, "int"),
    (4000, 4, True, "dyadic"), (1000, 5, False, "dyadic")])
def test_auc_device_matches_jax(n, seed, ties, weights):
    """At these sizes every sum of the JAX float32 pass is exact, so the
    two orders of adds agree; within 1e-7."""
    p, y, w = auc_inputs(n, seed, ties, weights)
    got = tmetrics.auc_device(torch.as_tensor(p), torch.as_tensor(y),
                              torch.as_tensor(w))
    want = jmetrics.auc_device(jnp.asarray(p), jnp.asarray(y),
                               jnp.asarray(w))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-7
    assert 0.5 < float(got) < 1.0


# ------------------------------------------------------- validation specs

def _enum_frames(pkg, device=None):
    """A training frame with an enum feature of levels a, b, c and a
    validation frame whose feature has an unseen level d and NA cells,
    and whose response has NA cells."""
    kw = {} if device is None else {"device": device}

    def cols(rows, seed, levels, na_resp):
        c = _cols(rows, seed)
        r = np.random.default_rng(seed + 100)
        lab = r.choice(np.array(levels, dtype=object), rows)
        lab[r.random(rows) < 0.05] = None
        c["cat"] = lab
        # the level moves the label's odds: part of the signal
        flip = (lab == "a") & (r.random(rows) < 0.4)
        c["label"] = np.where(flip, 1.0, c["label"]).astype(np.float32)
        if na_resp:
            c["label"][r.random(rows) < 0.04] = np.nan
        return c
    train = pkg.Frame.from_numpy(cols(3000, 20, ["a", "b", "c"], False),
                                 **kw)
    valid = pkg.Frame.from_numpy(cols(6000, 21, ["a", "b", "d"], True), **kw)
    return train, valid


def test_validation_spec_matches_jax():
    """Columns in training order, the unseen level and NA as NaN, the
    response mapped through the training domain with NA at weight 0."""
    jtr, jva = _enum_frames(jh2o)
    ttr, tva = _enum_frames(th2o, "cpu")
    js = jax_training_spec(jtr, "label", classification=True)
    ts = torch_training_spec(ttr, "label", classification=True)
    jv = jax_validation_spec(jva, js)
    tv = torch_validation_spec(tva, ts)
    n = tva.nrow
    assert tv.names == list(jv.names) and tv.nrow == jv.nrow == n
    assert tv.response_domain == tuple(jv.response_domain) == ("0", "1")
    np.testing.assert_array_equal(tv.X.numpy(), np.asarray(jv.X)[:n])
    np.testing.assert_array_equal(tv.y.numpy(), np.asarray(jv.y)[:n])
    np.testing.assert_array_equal(tv.w.numpy(), np.asarray(jv.w)[:n])
    cat = tv.X[:, tv.names.index("cat")].numpy()
    d_rows = np.asarray(tva.vec("cat").to_numpy()) == \
        tva.vec("cat").domain.index("d")
    assert np.isnan(cat[d_rows]).all() and d_rows.sum() > 1000
    assert (tv.w.numpy() == 0).sum() > 100


def test_validation_frame_with_unseen_level_and_na_response():
    """GBM with validation scoring on those frames: history, validation
    metrics and trees as the JAX package's."""
    jtr, jva = _enum_frames(jh2o)
    ttr, tva = _enum_frames(th2o, "cpu")
    kw = dict(ntrees=9, max_depth=3, learn_rate=0.2, min_rows=5.0,
              nbins=14, histogram_type="quantiles_global",
              distribution="bernoulli", histogram_precision="float32",
              seed=7, score_tree_interval=4)
    jm = JaxGBM(packed_codes=True, **kw).train(
        y="label", training_frame=jtr, validation_frame=jva).model
    tm = H2OGradientBoostingEstimator(**kw).train(
        y="label", training_frame=ttr, validation_frame=tva).model
    _same_trees(jm, tm)
    _same_history(jm.scoring_history, tm.scoring_history)
    assert [e["ntrees"] for e in tm.scoring_history] == [4, 8, 9]
    _same_metrics(jm.validation_metrics, tm.validation_metrics, 2)
    assert tm.validation_metrics.nobs == jm.validation_metrics.nobs


# ------------------------------------------------------------- the trains

def _same_trees(jm, tm):
    assert tm.ntrees_built == jm.ntrees_built
    for k in ("feat", "thr", "na_left", "is_split"):
        np.testing.assert_array_equal(tm.trees[k],
                                      np.asarray(getattr(jm, "_" + k)),
                                      err_msg=k)
    np.testing.assert_allclose(tm.trees["value"], np.asarray(jm._value),
                               rtol=1e-5, atol=1e-5)


def _same_history(jh, th):
    assert len(th) == len(jh) > 0
    for a, b in zip(jh, th):
        assert set(a) == set(b) and a["ntrees"] == b["ntrees"]
        for k in set(a) - {"ntrees", "auc"}:
            assert b[k] == pytest.approx(a[k], rel=1e-5), k
        if "auc" in a:
            assert abs(b["auc"] - a["auc"]) <= 1e-6


def _same_metrics(jmm, tmm, nclasses):
    if nclasses == 2:
        assert abs(tmm.auc - jmm.auc) <= 1e-6
        assert tmm.logloss == pytest.approx(jmm.logloss, rel=1e-5)
    else:
        assert tmm.mse == pytest.approx(jmm.mse, rel=1e-5)
        assert tmm.mean_residual_deviance == pytest.approx(
            jmm.mean_residual_deviance, rel=1e-5)


def _stop_margins(history, rounds, metric, tol):
    """At each entry where the rule can decide, how far the relative
    improvement of the last ``rounds`` scores over the ``rounds`` before
    lies from the tolerance (the rule stops on the near side)."""
    scores = [e[metric] for e in history]
    lower = metric != "auc"
    out = []
    for i in range(2 * rounds, len(scores) + 1):
        recent = np.mean(scores[i - rounds:i])
        prev = np.mean(scores[i - 2 * rounds:i - rounds])
        gain = (prev - recent if lower else recent - prev) / abs(prev)
        out.append(abs(gain - tol))
    return out


BASE = dict(max_depth=4, seed=7, histogram_precision="float32")
CASES = {
    # GBM on packed codes, stopping on logloss (stopping_metric auto)
    "gbm-packed-logloss": ("gbm", dict(
        BASE, ntrees=60, learn_rate=0.3, min_rows=5.0, nbins=14,
        histogram_type="quantiles_global", distribution="bernoulli",
        stopping_rounds=2, score_tree_interval=3), True, True),
    # GBM on adaptive bins, stopping on the AUC
    "gbm-adaptive-auc": ("gbm", dict(
        BASE, ntrees=60, learn_rate=0.3, min_rows=10.0, nbins=20,
        packed_codes=False, distribution="bernoulli", stopping_rounds=2,
        score_tree_interval=3, stopping_metric="AUC"), False, True),
    # GBM on the unpacked global sketch (quantile bins without packing;
    # at nbins 300 of equal width, a node's empty bins give two cuts of
    # one partition, which the packages' cumulative sums pick either way:
    # ROADMAP.md queue 3)
    "gbm-global-logloss": ("gbm", dict(
        BASE, ntrees=60, learn_rate=0.3, min_rows=10.0, nbins=20,
        histogram_type="quantiles_global", packed_codes=False,
        distribution="bernoulli", stopping_rounds=2,
        score_tree_interval=3), None, True),
    # gaussian GBM, stopping on the deviance
    "gbm-gaussian-deviance": ("gbm", dict(
        BASE, ntrees=60, learn_rate=0.3, min_rows=10.0, nbins=14,
        histogram_type="quantiles_global", stopping_rounds=2,
        score_tree_interval=3, stopping_metric="deviance"), True, True),
    # an interval with no stopping: an entry every 4 trees and at the end
    "gbm-interval-only": ("gbm", dict(
        BASE, ntrees=10, learn_rate=0.3, min_rows=5.0, nbins=14,
        histogram_type="quantiles_global", distribution="bernoulli",
        score_tree_interval=4), True, True),
    # XGBoost's two tree methods, stopping on the AUC and on logloss
    "xgb-auto-auc": ("xgboost", dict(
        BASE, ntrees=60, tree_method="auto", min_child_weight=5.0,
        distribution="bernoulli", stopping_rounds=2, score_tree_interval=3,
        stopping_metric="AUC"), True, True),
    "xgb-hist-logloss": ("xgboost", dict(
        BASE, ntrees=60, tree_method="hist", min_child_weight=5.0,
        distribution="bernoulli", stopping_rounds=3,
        score_tree_interval=2), True, True),
    # no validation frame: the training rows are scored
    "xgb-auto-train-scored": ("xgboost", dict(
        BASE, ntrees=30, tree_method="auto", min_child_weight=5.0,
        distribution="bernoulli", stopping_rounds=1, score_tree_interval=5,
        stopping_metric="AUC", stopping_tolerance=0.02), True, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scoring_and_early_stopping_match_jax(case):
    algo, params, packed, with_valid = CASES[case]
    gaussian = "gaussian" in case
    tr, va = _cols(3000, 30, gaussian), _cols(20_000, 31, gaussian)
    jtr, jva = jh2o.Frame.from_numpy(tr), jh2o.Frame.from_numpy(va)
    ttr = th2o.Frame.from_numpy(tr, device="cpu")
    tva = th2o.Frame.from_numpy(va, device="cpu")
    jest, test_ = ((JaxGBM, H2OGradientBoostingEstimator) if algo == "gbm"
                   else (JaxXGB, H2OXGBoostEstimator))
    jkw = dict(params) if packed is None else dict(params,
                                                   packed_codes=packed)
    jm = jest(**jkw).train(y="label", training_frame=jtr,
                           validation_frame=jva if with_valid else None
                           ).model
    tm = test_(**params).train(y="label", training_frame=ttr,
                               validation_frame=tva if with_valid else None
                               ).model
    _same_trees(jm, tm)
    _same_history(jm.scoring_history, tm.scoring_history)
    hist = tm.scoring_history
    interval = params["score_tree_interval"]
    built = tm.ntrees_built
    assert [e["ntrees"] for e in hist] == (
        list(range(interval, built + 1, interval))
        + ([built] if built % interval else []))
    assert tm.trees["feat"].shape[0] == built
    nclasses = 1 if gaussian else 2
    _same_metrics(jm.training_metrics, tm.training_metrics, nclasses)
    if with_valid:
        _same_metrics(jm.validation_metrics, tm.validation_metrics, nclasses)
    else:
        assert tm.validation_metrics is None
    rounds = int(params.get("stopping_rounds", 0))
    if rounds:
        keeper = ScoreKeeper(rounds, params.get("stopping_metric"),
                             params.get("stopping_tolerance", 1e-3),
                             "regression" if gaussian else "binomial")
        assert built < params["ntrees"]      # it stopped
        # no decision lies within 1e-4 of the tolerance, so both
        # packages' decisions are robust to their last bits
        assert min(_stop_margins(hist, rounds, keeper.metric,
                                 keeper.tol)) > 1e-4
        for i in range(len(hist)):
            keeper.history = hist[:i + 1]
            assert keeper.should_stop() == (i == len(hist) - 1), i
    else:
        assert built == params["ntrees"]
