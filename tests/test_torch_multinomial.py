"""The multinomial GBM against the JAX package: 4 classes on the packed,
adaptive and global-sketch paths (3000 rows x 6 features with 3% NA
cells, depth 3, 3 iterations, float32 histograms) give equal trees
(feat, thr, na_left and is_split exactly, value within rtol = atol =
1e-5, f0 within one ulp), equal metrics (logloss and error within 1e-6,
the macro OVR AUC within 2e-6 between the models and bit-equal on the
same probabilities; the confusion matrix and the hit ratios exactly) and
equal predictions (labels, probabilities within atol 1e-6); a JAX model
carried across through from_jax_arrays predicts like JAX; a validation
frame with early stopping on logloss stops at JAX's iteration with the
same history; XGBoost with 3 classes trains the same trees; and on the
CPU a deployed multinomial model serves rows bit-equal to predict.

The JAX trains run on a one-device mesh (as in test_torch_scoring.py):
on the suite's eight virtual devices the JAX histograms add their
shards in another order."""
import threading

import jax
import numpy as np
import pytest
import torch

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as JaxGBM
from h2o3_tpu.models.metrics import \
    make_multinomial_metrics as jax_multinomial_metrics
from h2o3_tpu.models.metrics import \
    multinomial_auc_table as jax_auc_table
from h2o3_tpu.models.xgboost import H2OXGBoostEstimator as JaxXGB
from h2o3_tpu.parallel.mesh import current_mesh, make_mesh, set_mesh
from h2o3_tpu_torch import serve
from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                       H2OXGBoostEstimator)
from h2o3_tpu_torch.models.gbm import GBMModel
from h2o3_tpu_torch.models.metrics import (make_multinomial_metrics,
                                           multinomial_auc_table)
from h2o3_tpu_torch.models.model_base import ScoreKeeper
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

ROWS, F, K = 3000, 6, 4
LABELS = np.array(["ash", "birch", "cedar", "dogwood"], dtype=object)
BASE = dict(ntrees=3, max_depth=3, learn_rate=0.1,
            histogram_precision="float32", seed=7)
# the three growers: (the port's parameters, the JAX package's extra)
PATHS = {
    "packed": (dict(nbins=14, histogram_type="quantiles_global",
                    min_rows=1.0), dict(packed_codes=True)),
    "adaptive": (dict(nbins=20, packed_codes=False, min_rows=10.0), {}),
    "global": (dict(nbins=20, histogram_type="quantiles_global",
                    packed_codes=False, min_rows=1.0), {}),
}


@pytest.fixture(autouse=True, scope="module")
def _one_jax_device():
    old = current_mesh()
    set_mesh(make_mesh(n_data=1, devices=jax.devices()[:1]))
    yield
    set_mesh(old)
    serve.shutdown_all()


def _cols(rows=ROWS, seed=0, k=K, labels=True):
    """Six normal features with 3% NA cells and a k-class label drawn
    from a softmax of linear scores (string labels, or float codes)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, F)).astype(np.float32)
    coef = np.random.default_rng(99).normal(size=(F, k)) * 1.2
    s = X @ coef + 0.4 * np.sin(2 * X[:, :1])
    p = np.exp(s - s.max(axis=1, keepdims=True))
    p /= p.sum(axis=1, keepdims=True)
    y = (rng.random((rows, 1)) > np.cumsum(p, axis=1)).sum(axis=1)
    y = np.minimum(y, k - 1)
    X[rng.random(X.shape) < 0.03] = np.nan
    cols = {f"f{i}": X[:, i] for i in range(F)}
    cols["label"] = LABELS[y] if labels else y.astype(np.float32)
    return cols


def _frames(cols):
    return (jh2o.Frame.from_numpy(cols),
            th2o.Frame.from_numpy(cols, device="cpu"))


def _same_trees(jm, tm, k=K):
    assert tm.ntrees_built == jm.ntrees_built
    assert tm.trees["feat"].shape[0] == tm.ntrees_built * k
    assert bool(tm.trees["is_split"].any())
    for key in ("feat", "thr", "na_left", "is_split"):
        np.testing.assert_array_equal(tm.trees[key],
                                      np.asarray(getattr(jm, "_" + key)),
                                      err_msg=key)
    np.testing.assert_allclose(tm.trees["value"], np.asarray(jm._value),
                               rtol=1e-5, atol=1e-5)
    # the log of the class priors: XLA's log and torch's differ in the
    # last bit (1 ulp is 1.2e-7 at these magnitudes)
    np.testing.assert_array_max_ulp(tm.f0, np.asarray(jm.f0), maxulp=1)


def _same_metrics(jmm, tmm, auc_atol=1e-6):
    """Logloss and error within 1e-6, the confusion matrix and the hit
    ratios exactly, the macro OVR AUC within ``auc_atol``."""
    for key in ("logloss", "error"):
        assert abs(getattr(tmm, key) - getattr(jmm, key)) <= 1e-6, key
    assert abs(tmm.auc - jmm.auc) <= auc_atol
    np.testing.assert_array_equal(tmm.confusion_matrix,
                                  np.asarray(jmm.confusion_matrix))
    np.testing.assert_array_equal(tmm.hit_ratios, jmm.hit_ratios)
    assert tmm.mean_per_class_error == pytest.approx(
        jmm.mean_per_class_error, abs=1e-6)
    assert tmm.mse == pytest.approx(jmm.mse, abs=1e-6)
    assert tmm.nobs == jmm.nobs
    assert tmm.auc_table.keys() == jmm.auc_table.keys()


def _same_auc_table(jt, tt):
    """The OVR AUCs bit-equal; the PR AUCs within 1e-6 (the JAX package
    sums the PR curve in float32, the port in float64)."""
    for key in ("per_class_auc", "macro_auc", "weighted_auc"):
        assert tt[key] == jt[key], key
    for key in ("per_class_aucpr", "macro_aucpr", "weighted_aucpr"):
        np.testing.assert_allclose(tt[key], jt[key], rtol=0, atol=1e-6)


# The OVR AUC of two trained models: their probabilities differ by a few
# 1e-7 (the trees' values within 1e-5), and the AUC's curve buckets rows
# by the top 17 bits of the float32 score, so a row that lies within that
# of a bucket edge moves to the next bucket and the class's AUC by one
# pair's share (about 5e-6 at 3000 rows and 4 classes; the packed case
# here moves the macro AUC by 1.3e-6). On the same probabilities the two
# packages' AUCs are equal (test_metrics_match_jax_on_the_same_probs).
MODEL_AUC_ATOL = 2e-6


def _same_predict(jm, jfr, tm, tfr):
    jp, tp = jm.predict(jfr), tm.predict(tfr)
    assert tp.names == jp.names == ["predict"] + [f"p{d}" for d in LABELS]
    assert list(tp.vec("predict").to_strings()) == list(
        jp.vec("predict").to_strings())
    for d in LABELS:
        np.testing.assert_allclose(tp.vec(f"p{d}").to_numpy(),
                                   jp.vec(f"p{d}").to_numpy(), rtol=0,
                                   atol=1e-6)
    probs = np.stack([tp.vec(f"p{d}").to_numpy() for d in LABELS], 1)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-6)


@pytest.fixture(scope="module", params=list(PATHS))
def trained(request):
    tkw, jkw = PATHS[request.param]
    jfr, tfr = _frames(_cols())
    jm = JaxGBM(**BASE, **tkw, **jkw).train(y="label",
                                             training_frame=jfr).model
    tm = H2OGradientBoostingEstimator(**BASE, **tkw).train(
        y="label", training_frame=tfr).model
    return request.param, jm, jfr, tm, tfr


def test_trees_match_jax(trained):
    path, jm, _jfr, tm, _tfr = trained
    assert tm.dist_name == jm.dist_name == "multinomial"
    assert tm.output["packed_codes"]["enabled"] == (path == "packed")
    _same_trees(jm, tm)


def test_metrics_match_jax(trained):
    _path, jm, _jfr, tm, _tfr = trained
    _same_metrics(jm.training_metrics, tm.training_metrics,
                  auc_atol=MODEL_AUC_ATOL)


def test_metrics_match_jax_on_the_same_probs(trained):
    """Both packages' metrics of the port's predicted probabilities: the
    per-class OVR AUCs equal bit for bit."""
    _path, _jm, _jfr, tm, tfr = trained
    pred = tm.predict(tfr)
    probs = np.stack([pred.vec(f"p{d}").to_numpy() for d in LABELS], 1)
    y = tfr.vec("label").to_numpy().astype(np.int32)
    w = np.ones(ROWS, np.float32)
    jmm = jax_multinomial_metrics(probs, y, w)
    tmm = make_multinomial_metrics(torch.from_numpy(probs),
                                   torch.from_numpy(y), torch.from_numpy(w))
    _same_metrics(jmm, tmm, auc_atol=0.0)
    _same_auc_table(jmm.auc_table, tmm.auc_table)


def test_predict_matches_jax(trained):
    _path, jm, jfr, tm, tfr = trained
    _same_predict(jm, jfr, tm, tfr)


def test_variable_importances_sum_over_every_tree(trained):
    _path, jm, _jfr, tm, _tfr = trained
    tv, jv = (m.output["variable_importances"] for m in (tm, jm))
    assert tv["variable"] == jv["variable"]
    np.testing.assert_allclose(tv["relative_importance"],
                               jv["relative_importance"], rtol=1e-5)


def test_numeric_response_and_explicit_distribution():
    """A numeric 0..3 response with distribution='multinomial' (read as
    classes), against JAX on the packed path."""
    cols = _cols(seed=5, labels=False)
    jfr, tfr = _frames(cols)
    kw = dict(BASE, distribution="multinomial", **PATHS["packed"][0])
    jm = JaxGBM(packed_codes=True, **kw).train(y="label",
                                               training_frame=jfr).model
    tm = H2OGradientBoostingEstimator(**kw).train(
        y="label", training_frame=tfr).model
    assert tm.nclasses == jm.nclasses == K
    _same_trees(jm, tm)
    assert abs(tm.training_metrics.logloss
               - jm.training_metrics.logloss) <= 1e-6


def test_metrics_kernel_matches_jax_with_weights():
    """``make_multinomial_metrics`` alone on the same probabilities,
    labels and dyadic weights (0, 0.5, 1, 2: every sum exact)."""
    rng = np.random.default_rng(11)
    n, k = 5000, 5
    s = rng.normal(size=(n, k)).astype(np.float32) * 2
    p = np.exp(s) / np.exp(s).sum(axis=1, keepdims=True)
    p = p.astype(np.float32)
    y = rng.integers(0, k, size=n).astype(np.int32)
    w = rng.choice(np.array([0.0, 0.5, 1.0, 2.0], np.float32), size=n)
    tm = make_multinomial_metrics(torch.from_numpy(p), torch.from_numpy(y),
                                  torch.from_numpy(w))
    jm = jax_multinomial_metrics(p, y, w)
    _same_metrics(jm, tm, auc_atol=0.0)
    _same_auc_table(jm.auc_table, tm.auc_table)
    args = (torch.from_numpy(p), torch.from_numpy(y), torch.from_numpy(w))
    assert multinomial_auc_table(*args) == tm.auc_table
    assert multinomial_auc_table(*args, max_classes=k - 1) is None
    assert jax_auc_table(p, y, w, max_classes=k - 1) is None


def test_confusion_matrix_with_many_classes_matches_jax():
    """64 classes (past the AUC table's 20): the confusion matrix and the
    hit ratios equal JAX's exactly, summed per key in a fixed order in
    O(rows) memory; dyadic weights keep every sum exact."""
    rng = np.random.default_rng(12)
    n, k = 6000, 64
    s = rng.normal(size=(n, k)).astype(np.float32) * 3
    p = (np.exp(s) / np.exp(s).sum(axis=1, keepdims=True)).astype(np.float32)
    y = rng.integers(0, k, size=n).astype(np.int32)
    w = rng.choice(np.array([0.0, 0.5, 1.0, 2.0], np.float32), size=n)
    tm = make_multinomial_metrics(torch.from_numpy(p), torch.from_numpy(y),
                                  torch.from_numpy(w))
    jm = jax_multinomial_metrics(p, y, w)
    assert tm.confusion_matrix.shape == (k, k)
    np.testing.assert_array_equal(tm.confusion_matrix,
                                  np.asarray(jm.confusion_matrix))
    np.testing.assert_array_equal(tm.hit_ratios, jm.hit_ratios)
    for key in ("logloss", "error", "mean_per_class_error", "mse"):
        assert abs(getattr(tm, key) - getattr(jm, key)) <= 1e-6, key
    assert tm.auc_table is None and jm.auc_table is None


def test_from_jax_arrays_predicts_like_jax(trained):
    _path, jm, jfr, _tm, tfr = trained
    meta = {"dist_name": jm.dist_name, "n_bins": jm.n_bins,
            "max_depth": jm.max_depth, "ntrees_built": jm.ntrees_built,
            "nclasses": jm.nclasses, "names": jm.feature_names,
            "response_domain": jm.response_domain}
    carried = GBMModel.from_jax_arrays(jm._save_arrays(), meta,
                                       device="cpu")
    assert carried.f0.shape == (K,)
    _same_predict(jm, jfr, carried, tfr)


def _stop_margins(history, rounds, tol):
    scores = [e["logloss"] for e in history]
    out = []
    for i in range(2 * rounds, len(scores) + 1):
        recent = np.mean(scores[i - rounds:i])
        prev = np.mean(scores[i - 2 * rounds:i - rounds])
        out.append(abs((prev - recent) / abs(prev) - tol))
    return out


def test_early_stopping_on_logloss_stops_at_jax_iteration():
    """A validation frame, stopping on logloss (the multinomial auto
    metric) every 2 iterations: both packages stop after the same
    iteration, with the same history ({ntrees, logloss, deviance}) and
    the same trees and validation metrics."""
    params = dict(BASE, ntrees=60, learn_rate=0.5, nbins=14,
                  histogram_type="quantiles_global", min_rows=5.0,
                  stopping_rounds=2, score_tree_interval=2,
                  stopping_tolerance=0.01)
    jtr, ttr = _frames(_cols(seed=1))
    jva, tva = _frames(_cols(rows=6000, seed=2))
    jm = JaxGBM(packed_codes=True, **params).train(
        y="label", training_frame=jtr, validation_frame=jva).model
    tm = H2OGradientBoostingEstimator(**params).train(
        y="label", training_frame=ttr, validation_frame=tva).model
    assert tm.ntrees_built < params["ntrees"]          # it stopped
    _same_trees(jm, tm)
    hist, jhist = tm.scoring_history, jm.scoring_history
    assert [e["ntrees"] for e in hist] == [e["ntrees"] for e in jhist] \
        == list(range(2, tm.ntrees_built + 1, 2))
    for a, b in zip(jhist, hist):
        assert set(a) == set(b) == {"ntrees", "logloss", "deviance"}
        assert b["logloss"] == pytest.approx(a["logloss"], rel=1e-5)
        assert b["deviance"] == b["logloss"]
    # no decision lies within 1e-4 of the tolerance
    assert min(_stop_margins(hist, 2, 0.01)) > 1e-4
    assert ScoreKeeper(2, "auto", 0.01, "multinomial").metric == "logloss"
    _same_metrics(jm.validation_metrics, tm.validation_metrics,
                  auc_atol=MODEL_AUC_ATOL)


@pytest.mark.parametrize("tree_method", ["hist", "auto"])
def test_xgboost_three_classes_matches_jax(tree_method):
    """XGBoost's map passes the distribution through: a 3-class enum
    response trains multinomial in both packages, with the same trees
    and metrics."""
    cols = _cols(seed=3, k=3)
    jfr, tfr = _frames(cols)
    kw = dict(ntrees=3, max_depth=3, tree_method=tree_method,
              min_child_weight=5.0, histogram_precision="float32", seed=7)
    jm = JaxXGB(packed_codes=True, **kw).train(y="label",
                                               training_frame=jfr).model
    tm = H2OXGBoostEstimator(**kw).train(y="label",
                                         training_frame=tfr).model
    assert tm.nclasses == jm.nclasses == 3
    _same_trees(jm, tm, k=3)
    _same_metrics(jm.training_metrics, tm.training_metrics,
                  auc_atol=MODEL_AUC_ATOL)


def test_served_rows_bit_match_predict_on_cpu():
    """A multinomial model deployed at buckets 1/8/64: row requests from
    several threads come back with the labels and all K probabilities of
    ``predict`` on the same rows, bit for bit."""
    cols = _cols(seed=4)
    _jfr, tfr = _frames(cols)
    m = H2OGradientBoostingEstimator(**BASE, **PATHS["packed"][0]).train(
        y="label", training_frame=tfr).model
    m.key = "serve_multinomial"
    dep = serve.deploy(m.key, model=m, buckets=(1, 8, 64), max_batch=64,
                       max_delay_ms=1.0)
    try:
        idx = np.arange(300)
        rows = [{f"f{i}": (None if np.isnan(cols[f"f{i}"][r])
                           else float(cols[f"f{i}"][r])) for i in range(F)}
                for r in idx]
        ref = m.predict(tfr.rows(idx))
        ref_p = {d: ref.vec(f"p{d}").to_numpy() for d in LABELS}
        ref_lbl = list(ref.vec("predict").to_strings())
        outs, errs = {}, []
        per = 30

        def client(ci):
            try:
                outs[ci] = dep.predict_rows(rows[ci * per:(ci + 1) * per])
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=client, args=(ci,))
                   for ci in range(len(rows) // per)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not errs, errs
        preds = [p for ci in range(len(threads)) for p in outs[ci]]
        assert len(preds) == len(idx)
        for i, p in enumerate(preds):
            assert p["label"] == ref_lbl[i]
            for d in LABELS:
                assert p["classProbabilities"][d] == float(ref_p[d][i]), \
                    (i, d)
        cols_out = dep.predict_columnar(rows[:50])
        assert cols_out["predict"] == ref_lbl[:50]
        assert dep.scorer.out_k == K
    finally:
        serve.undeploy(m.key)
