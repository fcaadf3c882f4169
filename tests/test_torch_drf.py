"""The port's random forest against the JAX package's DRF (cases after
tests/test_drf.py and test_tree_sampling.py): binomial on the packed,
adaptive and global-sketch paths, regression and multinomial (3000 rows
x 6 features with 3% NA cells, depth 4, 4 trees, float32 histograms).

- Trees: feat, thr, na_left and is_split exactly, value within rtol =
  atol = 1e-6 (a leaf's weighted mean, the same adds in both packages
  but for the order of a few).
- Predictions within atol 1e-6 (regression: and rtol 1e-5, a few ulps
  of responses near 2): the JAX package takes the forest's mean over
  trees in XLA's reduction order, the port adds the trees in tree order
  (ROADMAP.md queue 3).
- OOB metrics: AUC, logloss and MSE within 1e-6, the same rows counted
  (nobs); the in-bag fallback at sample_rate=1 (``oob_metrics`` False
  in both).
- The mtries defaults (floor(sqrt F) classification, F // 3
  regression), variable importances, the JAX package's refusals
  (max_depth past 16, offset_column, staged_predict_proba), a checkpoint
  by a keyed-store name (item 18) and contributions (item 16).
- On the CPU a deployed forest serves rows bit-equal to predict.
- The reference's compatibility-only DRF parameters: each trains the
  trees of a train without it and warns in the JAX package's words; the
  model API (``model_performance``, the accessors) as the JAX package's
  (metrics within 1e-5).

The JAX trains run on a one-device mesh, as in test_torch_sampling.py."""
import logging
import threading

import jax
import numpy as np
import pytest

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu.models.drf import H2ORandomForestEstimator as JaxDRF
from h2o3_tpu.parallel.mesh import current_mesh, make_mesh, set_mesh
from h2o3_tpu_torch import serve
from h2o3_tpu_torch.estimators import H2ORandomForestEstimator
from h2o3_tpu_torch.models.drf import (DRF_COMPAT_PARAMS, DRF_DEFAULTS,
                                       default_mtries)
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

ROWS, F = 3000, 6
BASE = dict(ntrees=4, max_depth=4, seed=7, histogram_precision="float32")
PATHS = {
    "packed": (dict(nbins=14, histogram_type="quantiles_global"),
               dict(packed_codes=True)),
    "adaptive": (dict(nbins=20, packed_codes=False), {}),
    "global": (dict(nbins=20, histogram_type="quantiles_global",
                    packed_codes=False), {}),
}
LABELS = np.array(["ash", "birch", "cedar"], dtype=object)


@pytest.fixture(autouse=True, scope="module")
def _one_jax_device():
    old = current_mesh()
    set_mesh(make_mesh(n_data=1, devices=jax.devices()[:1]))
    yield
    set_mesh(old)
    serve.shutdown_all()


def _cols(task="binomial", seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(ROWS, F)).astype(np.float32)
    s = X[:, 0] * 1.5 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    if task == "regression":
        lab = (s + 0.3 * rng.normal(size=ROWS)).astype(np.float32)
    elif task == "binomial":
        lab = np.array(["no", "yes"], dtype=object)[
            (rng.random(ROWS) < 1.0 / (1.0 + np.exp(-s))).astype(int)]
    else:
        z = np.stack([s, X[:, 4] * 2.0, -s + X[:, 5]], axis=1)
        lab = LABELS[np.argmax(z + rng.normal(size=z.shape), axis=1)]
    X[rng.random(X.shape) < 0.03] = np.nan
    cols = {f"f{i}": X[:, i] for i in range(F)}
    cols["label"] = lab
    return cols


_MODELS = {}


def _models(task, path="adaptive", **extra):
    """Both packages' forests on one frame (module cache)."""
    key = (task, path, repr(sorted(extra.items())))
    if key not in _MODELS:
        cols = _cols(task)
        jfr = jh2o.Frame.from_numpy(cols)
        tfr = th2o.Frame.from_numpy(cols, device="cpu")
        tp, jp = PATHS[path]
        kw = dict(BASE, **tp)
        kw.update(extra)
        jm = JaxDRF(**jp, **kw).train(y="label", training_frame=jfr).model
        tm = H2ORandomForestEstimator(**kw).train(
            y="label", training_frame=tfr).model
        _MODELS[key] = (jm, jfr, tm, tfr)
    return _MODELS[key]


def _same_trees(jm, tm, K=1):
    assert tm.ntrees_built == jm.ntrees_built == BASE["ntrees"]
    assert tm.trees["feat"].shape[0] == BASE["ntrees"] * K
    assert bool(tm.trees["is_split"].any())
    for key in ("feat", "thr", "na_left", "is_split"):
        np.testing.assert_array_equal(tm.trees[key],
                                      np.asarray(getattr(jm, "_" + key)),
                                      err_msg=key)
    np.testing.assert_allclose(tm.trees["value"], np.asarray(jm._value),
                               rtol=1e-6, atol=1e-6)


def _probs(pred, names):
    return np.stack([pred.vec(n).to_numpy() for n in names], axis=1)


@pytest.mark.parametrize("path", list(PATHS))
def test_binomial_trees_oob_and_predict_match_jax(path):
    jm, jfr, tm, tfr = _models("binomial", path)
    _same_trees(jm, tm)
    assert tm.output["packed_codes"] == jm.output["packed_codes"]
    assert tm.output["oob_metrics"] is jm.output["oob_metrics"] is True
    jt, tt = jm.training_metrics, tm.training_metrics
    assert tt.nobs == jt.nobs < ROWS
    for key in ("auc", "logloss", "mse"):
        assert abs(getattr(tt, key) - getattr(jt, key)) <= 1e-6, key
    assert tt.auc > 0.7
    names = ["pno", "pyes"]
    np.testing.assert_allclose(_probs(tm.predict(tfr), names),
                               _probs(jm.predict(jfr), names),
                               rtol=0, atol=1e-6)


def test_regression_trees_oob_and_predict_match_jax():
    jm, jfr, tm, tfr = _models("regression")
    _same_trees(jm, tm)
    assert tm.output["mtries"] == default_mtries(-1, F, 1) == F // 3
    jt, tt = jm.training_metrics, tm.training_metrics
    assert tt.nobs == jt.nobs
    assert tt.mse == pytest.approx(jt.mse, rel=1e-6)
    np.testing.assert_allclose(tm.predict(tfr).vec("predict").to_numpy(),
                               jm.predict(jfr).vec("predict").to_numpy(),
                               rtol=1e-5, atol=1e-6)


def test_multinomial_trees_oob_and_predict_match_jax():
    """K trees a forest tree, each grown with fold_in(key_m, k)."""
    jm, jfr, tm, tfr = _models("multinomial", "packed")
    _same_trees(jm, tm, K=3)
    assert tm.output["mtries"] == int(np.sqrt(F))
    jt, tt = jm.training_metrics, tm.training_metrics
    assert tt.nobs == jt.nobs
    for key in ("logloss", "error", "mean_per_class_error"):
        assert abs(getattr(tt, key) - getattr(jt, key)) <= 1e-6, key
    np.testing.assert_array_equal(tt.confusion_matrix,
                                  np.asarray(jt.confusion_matrix))
    names = [f"p{d}" for d in LABELS]
    tp, jp = tm.predict(tfr), jm.predict(jfr)
    np.testing.assert_allclose(_probs(tp, names), _probs(jp, names),
                               rtol=0, atol=1e-6)
    assert list(tp.vec("predict").to_strings()) == \
        list(jp.vec("predict").to_strings())


def test_in_bag_fallback_at_sample_rate_one():
    """sample_rate=1: no row is out of bag, and the training metrics are
    the in-bag predictions' in both packages."""
    jm, _jfr, tm, _tfr = _models("binomial", sample_rate=1.0)
    _same_trees(jm, tm)
    assert tm.output["oob_metrics"] is jm.output["oob_metrics"] is False
    assert tm.training_metrics.nobs == jm.training_metrics.nobs == ROWS
    assert abs(tm.training_metrics.auc - jm.training_metrics.auc) <= 1e-6


@pytest.mark.parametrize("extra", [
    dict(mtries=2, col_sample_rate_per_tree=0.7),
    dict(sample_rate_per_class=[0.5, 0.9],
         col_sample_rate_change_per_level=0.8),
    dict(histogram_type="random")],
    ids=lambda p: ",".join(sorted(p)))
def test_sampling_parameters_match_jax(extra):
    """Per-tree column rates, per-class rates and the random histogram
    (which the JAX DRF sends to the global sketch)."""
    jm, _jfr, tm, _tfr = _models("binomial", **extra)
    _same_trees(jm, tm)
    assert tm.output["packed_codes"] == jm.output["packed_codes"]
    assert abs(tm.training_metrics.auc - jm.training_metrics.auc) <= 1e-6


def test_varimp_matches_jax():
    jm, _jfr, tm, _tfr = _models("binomial")
    jv, tv = jm.varimp(), tm.varimp()
    assert tv["variable"] == jv["variable"]
    np.testing.assert_allclose(tv["relative_importance"],
                               jv["relative_importance"], rtol=1e-5)


def test_mtries_defaults():
    assert default_mtries(-1, 28, 2) == 5 and default_mtries(-1, 54, 7) == 7
    assert default_mtries(-1, 28, 1) == 9 and default_mtries(-1, 2, 1) == 1
    assert default_mtries(50, 28, 2) == 28 and default_mtries(3, 28, 1) == 3
    assert DRF_DEFAULTS["sample_rate"] == 0.632
    assert DRF_DEFAULTS["max_depth"] == 10


def test_refusals():
    cols = _cols()
    cols["off"] = np.zeros(ROWS, np.float32)
    fr = th2o.Frame.from_numpy(cols, device="cpu")
    with pytest.raises(ValueError, match="exceeds the static-tree cap 16"):
        H2ORandomForestEstimator(ntrees=1, max_depth=17).train(
            y="label", training_frame=fr)
    with pytest.raises(NotImplementedError, match="offset_column"):
        H2ORandomForestEstimator(ntrees=1, offset_column="off").train(
            y="label", training_frame=fr)
    with pytest.raises(NotImplementedError, match="item 18"):
        H2ORandomForestEstimator(ntrees=2, checkpoint="drf_1").train(
            y="label", training_frame=fr)
    with pytest.raises(ValueError, match="unknown parameter"):
        H2ORandomForestEstimator(learn_rate=0.1)
    m = H2ORandomForestEstimator(ntrees=1, max_depth=2).train(
        y="label", training_frame=fr).model
    with pytest.raises(ValueError, match="staged_predict_proba"):
        m.staged_predict_proba(fr)
    with pytest.raises(NotImplementedError, match="item 16"):
        m.predict_contributions(fr)


def test_validation_metrics_are_the_forest_on_the_frame():
    cols = _cols(seed=1)
    fr = th2o.Frame.from_numpy(cols, device="cpu")
    m = H2ORandomForestEstimator(**BASE).train(
        y="label", training_frame=fr, validation_frame=fr).model
    probs = m.predict(fr).vec("pyes").to_numpy()
    assert m.validation_metrics.nobs == ROWS
    assert m.validation_metrics.auc > m.training_metrics.auc - 0.1
    assert np.all((probs >= 0) & (probs <= 1))


def test_served_rows_bit_match_predict_on_cpu():
    """A forest deployed at buckets 1/8/64: row requests from several
    threads come back with predict's labels and probabilities, bit for
    bit (the mean adds the trees in one order whatever the batch)."""
    _jm, _jfr, m, tfr = _models("multinomial", "packed")
    cols = _cols("multinomial")
    m.key = "serve_drf"
    dep = serve.deploy(m.key, model=m, buckets=(1, 8, 64), max_batch=64,
                       max_delay_ms=1.0)
    try:
        idx = np.arange(120)
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
                assert p["classProbabilities"][d] == float(ref_p[d][i])
    finally:
        serve.undeploy(m.key)


DRF_COMPAT_AWAY = {"max_confusion_matrix_size": 10, "nbins_top_level": 256,
                   "r2_stopping": 0.5, "build_tree_one_node": True,
                   "binomial_double_trees": True,
                   "categorical_encoding": "one_hot_explicit",
                   "distribution": "bernoulli",
                   "check_constant_response": False}


def test_compat_table_is_the_jax_one():
    from h2o3_tpu.models.compat_params import COMPAT_PARAMS
    assert DRF_COMPAT_PARAMS == COMPAT_PARAMS["drf"]
    assert set(DRF_COMPAT_AWAY) == set(DRF_COMPAT_PARAMS)
    with pytest.raises(ValueError, match="unknown parameter"):
        H2ORandomForestEstimator(hist_kernel="pallas")


@pytest.mark.parametrize("key", list(DRF_COMPAT_AWAY))
def test_compat_parameter_trains_the_same_trees_and_warns(caplog, key):
    """Each compatibility-only DRF parameter, set away from its default,
    is taken by both packages; the port trains the trees of the train
    without it (the JAX forest's), and both warn in the same words on
    their own loggers."""
    value = DRF_COMPAT_AWAY[key]
    jm, _jfr, tm0, _tfr = _models("binomial")
    jlog = logging.getLogger("h2o3_tpu")
    jlog.addHandler(caplog.handler)     # that logger does not propagate
    try:
        with caplog.at_level(logging.WARNING, logger="h2o3_tpu_torch"), \
                caplog.at_level(logging.WARNING, logger="h2o3_tpu"):
            JaxDRF(**{key: value})._warn_compat_params()
            tp, _jp = PATHS["adaptive"]
            tm = H2ORandomForestEstimator(**BASE, **tp, **{key: value}).train(
                y="label",
                training_frame=th2o.Frame.from_numpy(_cols("binomial"),
                                                     device="cpu")).model
    finally:
        jlog.removeHandler(caplog.handler)
    said = {r.name: r.getMessage() for r in caplog.records
            if f"parameter '{key}'" in r.getMessage()}
    assert set(said) == {"h2o3_tpu", "h2o3_tpu_torch"}
    assert said["h2o3_tpu"] == said["h2o3_tpu_torch"]
    assert tm.params[key] == value
    _same_trees(jm, tm)
    for k in ("feat", "thr", "value"):
        np.testing.assert_array_equal(tm.trees[k], tm0.trees[k])


@pytest.mark.parametrize("task", ["binomial", "regression"])
def test_model_api_matches_jax(task):
    """A8 on the forest: ``model_performance`` of another frame and the
    h2o-py accessors, within 1e-5 of the JAX package's."""
    jm, _jfr, tm, _tfr = _models(task)
    te = _cols(task, seed=2)
    jperf = jm.model_performance(jh2o.Frame.from_numpy(te))
    tperf = tm.model_performance(th2o.Frame.from_numpy(te, device="cpu"))
    assert tm.model_performance() is tm.training_metrics
    assert tperf.nobs == jperf.nobs
    for name in ("auc", "logloss", "rmse", "mse", "mae", "r2"):
        j, t = getattr(jperf, name, None), getattr(tperf, name, None)
        assert (j is None) == (t is None), name
        if t is not None:
            assert abs(t - j) <= 1e-5, (name, t, j)
        j, t = jm._metric(name), getattr(tm, name)()
        assert (j is None) == (t is None), name
        if t is not None:
            assert abs(t - j) <= 1e-5, (name, t, j)
