"""Cross-validation, class balancing and calibration (ROADMAP item A7)
in the port against the JAX package.

- Cross-validation (``nfolds`` 3 with ``fold_assignment`` modulo and
  random, and a ``fold_column``): the fold assignment equal, each fold
  model's trees equal (splits exact, values rtol = atol = 1e-5), the
  pooled holdout predictions within 1e-6, the CV AUC and logloss within
  1e-6; the holdout of each fold equals its fold model's ``predict`` on
  its rows. The folds' frames come from ``Frame.rows``, whose gather on
  the frame's device is held bit for bit against the host gather.
- ``balance_classes`` with the automatic factors, with
  ``class_sampling_factors`` and with ``max_after_balance_size`` binding,
  on responses with NA: the balanced weights and both class
  distributions equal the JAX package's; a balanced GBM trains to the
  JAX package's trees and corrected probabilities (within 1e-6), and
  its served rows bit-match ``predict``.
- Calibration: Platt's (a, b) within 1e-9 relative and the isotonic
  knots equal on the same probabilities; the ``cal_p*`` columns of
  trained models within 1e-6; the JAX package's refusals, a frame key
  (ROADMAP.md item 18); served rows carry no ``cal_p*`` (as in the JAX
  package, queue 3).

1200 rows x 4 features with 3% NA cells, depth 3, 3 trees, float32
histograms; the JAX trains run on a one-device mesh, as in
test_torch_sampling.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as JaxGBM
from h2o3_tpu.parallel.mesh import current_mesh, make_mesh, set_mesh
from h2o3_tpu_torch import serve
from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                       H2ORandomForestEstimator)
from h2o3_tpu_torch.models.model_base import build_training_spec
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

ROWS, F = 1200, 4
GBM = dict(ntrees=3, max_depth=3, nbins=14, histogram_type="quantiles_global",
           histogram_precision="float32", min_rows=1.0, seed=7,
           distribution="bernoulli")
LABELS = np.array(["ash", "birch", "cedar"], dtype=object)


@pytest.fixture(autouse=True, scope="module")
def _one_jax_device():
    old = current_mesh()
    set_mesh(make_mesh(n_data=1, devices=jax.devices()[:1]))
    yield
    set_mesh(old)
    serve.shutdown_all()


def _cols(seed=0, k=2, shares=None, na_response=0):
    """Four normal features with 3% NA cells and a k-class label (0/1
    floats for k = 2, strings beyond), drawn at ``shares`` where given;
    the first ``na_response`` labels NA."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(ROWS, F)).astype(np.float32)
    s = X[:, 0] * 1.5 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    if shares is None:
        y = (rng.random(ROWS) < 1.0 / (1.0 + np.exp(-s))).astype(int)
    else:
        y = np.searchsorted(np.cumsum(shares), rng.random(ROWS))
        y = np.minimum(y, len(shares) - 1)
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


def _same_trees(tm, jm):
    assert tm.ntrees_built == jm.ntrees_built
    for key in ("feat", "thr", "na_left", "is_split"):
        np.testing.assert_array_equal(tm.trees[key],
                                      np.asarray(getattr(jm, "_" + key)),
                                      err_msg=key)
    np.testing.assert_allclose(tm.trees["value"], np.asarray(jm._value),
                               rtol=1e-5, atol=1e-5)


def _fold_cols():
    cols = _cols()
    cols["fold"] = ((np.arange(ROWS) * 7) % 3).astype(np.float32)
    return cols


@pytest.mark.parametrize("cv", [
    dict(nfolds=3, fold_assignment="modulo"),
    dict(nfolds=3, fold_assignment="random"),
    dict(fold_column="fold"),
], ids=["modulo", "random", "fold_column"])
def test_cross_validation_matches_jax(cv):
    cols = _fold_cols()
    jfr = jh2o.Frame.from_numpy(cols)
    tfr = th2o.Frame.from_numpy(cols, device="cpu")
    jm = JaxGBM(packed_codes=True, **GBM, **cv).train(
        y="label", training_frame=jfr).model
    tm = H2OGradientBoostingEstimator(**GBM, **cv).train(
        y="label", training_frame=tfr).model
    _same_trees(tm, jm)
    np.testing.assert_array_equal(tm.output["cv_fold_assignment"],
                                  jm.output["cv_fold_assignment"])
    fms = tm.output["cross_validation_models"]
    assert len(fms) == len(jm.output["cross_validation_models"]) == 3
    for fm, jfm in zip(fms, jm.output["cross_validation_models"]):
        _same_trees(fm, jfm)
    ho = tm.output["cross_validation_holdout_predictions"]
    np.testing.assert_allclose(
        ho, jm.output["cross_validation_holdout_predictions"], rtol=0,
        atol=1e-6)
    cvm, jcvm = tm.cross_validation_metrics, jm.cross_validation_metrics
    assert abs(cvm.auc - jcvm.auc) <= 1e-6
    assert abs(cvm.logloss - jcvm.logloss) <= 1e-6
    assert cvm.nobs == jcvm.nobs == ROWS
    # the holdout of each fold is its fold model's predict on its rows
    fold = tm.output["cv_fold_assignment"]
    for fid, fm in zip(np.unique(fold), fms):
        rows = np.nonzero(fold == fid)[0]
        p1 = fm.predict(tfr.rows(rows)).vec("p1").to_numpy()
        np.testing.assert_array_equal(p1, ho[rows, 1])
    assert len(tm.output["cross_validation_profile"]) == 3


def test_forest_cross_validates():
    """The forest's folds come from the same builder: the holdout equals
    the fold models' predictions and the CV metrics cover every row."""
    cols = _cols(k=3, shares=(0.5, 0.3, 0.2))
    tfr = th2o.Frame.from_numpy(cols, device="cpu")
    m = H2ORandomForestEstimator(ntrees=3, max_depth=3, seed=7, nfolds=2,
                                 fold_assignment="modulo").train(
        y="label", training_frame=tfr).model
    assert m.cross_validation_metrics.nobs == ROWS
    ho = m.output["cross_validation_holdout_predictions"]
    assert ho.shape == (ROWS, 3) and not np.isnan(ho).any()
    fm = m.output["cross_validation_models"][1]
    rows = np.nonzero(np.arange(ROWS) % 2 == 1)[0]
    pred = fm.predict(tfr.rows(rows))
    np.testing.assert_array_equal(pred.vec("pcedar").to_numpy(),
                                  ho[rows, 2])


@pytest.mark.parametrize("sel", ["mask", "index", "slice"])
def test_rows_gather_on_the_device_equals_the_host_gather(sel):
    cols = _cols(k=3)
    cols["big"] = np.arange(ROWS, dtype=np.int64) * (1 << 30)
    cols["when"] = np.arange(ROWS, dtype=np.int64)
    cols["note"] = np.array([f"n{i % 7}" for i in range(ROWS)], dtype=object)
    fr = th2o.Frame.from_numpy(cols, device="cpu")
    rng = np.random.default_rng(1)
    pick = {"mask": rng.random(ROWS) < 0.4,
            "index": rng.permutation(ROWS)[:500],
            "slice": slice(10, 900, 3)}[sel]
    got = fr.rows(pick)
    want = fr.rows_host(pick)
    assert got.names == want.names
    for a, b in zip((got.vec(n) for n in got.names),
                    (want.vec(n) for n in want.names)):
        assert (a.type, a.domain) == (b.type, b.domain)
        if a.data is None:
            assert list(a.host_data) == list(b.host_data)
            continue
        assert a.data.dtype == b.data.dtype
        assert torch.equal(a.data.view(torch.int32),
                           b.data.view(torch.int32))
        if a.host_data is not None or b.host_data is not None:
            np.testing.assert_array_equal(a.host_data, b.host_data)


@pytest.mark.parametrize("k,params", [
    (3, dict()),
    (3, dict(class_sampling_factors=[1.0, 2.0, 4.0])),
    (2, dict(class_sampling_factors=[1.0, 8.0], max_after_balance_size=1.5)),
], ids=["auto", "factors", "max_after"])
def test_balanced_weights_match_jax(k, params):
    shares = (0.7, 0.2, 0.1) if k == 3 else (0.85, 0.15)
    cols = _cols(k=k, shares=shares, na_response=5)
    kw = dict(balance_classes=True, **params)
    dist = "multinomial" if k == 3 else "bernoulli"
    jest = JaxGBM(distribution=dist, **kw)
    jspec = jest._apply_balance_classes(
        jest._make_spec(jh2o.Frame.from_numpy(cols), "label", None))
    test = H2OGradientBoostingEstimator(distribution=dist, **kw)
    tspec = test._apply_balance_classes(build_training_spec(
        th2o.Frame.from_numpy(cols, device="cpu"), "label",
        classification=True))
    np.testing.assert_array_equal(tspec.w.numpy(),
                                  np.asarray(jspec.w)[:ROWS])
    assert test._class_dists == jest._class_dists
    assert tspec.w[:5].sum() == 0


def test_balanced_gbm_matches_jax_and_serves_corrected():
    cols = _cols(shares=(0.85, 0.15), na_response=5)
    kw = dict(GBM, balance_classes=True, class_sampling_factors=[1.0, 4.0])
    jfr = jh2o.Frame.from_numpy(cols)
    tfr = th2o.Frame.from_numpy(cols, device="cpu")
    jm = JaxGBM(packed_codes=True, **kw).train(y="label",
                                               training_frame=jfr).model
    tm = H2OGradientBoostingEstimator(**kw).train(
        y="label", training_frame=tfr).model
    _same_trees(tm, jm)
    for k in ("prior_class_dist", "model_class_dist"):
        assert tm.output[k] == jm.output[k]
    tp = tm.predict(tfr).vec("p1").to_numpy()
    np.testing.assert_allclose(tp, jm.predict(jfr).vec("p1").to_numpy(),
                               rtol=0, atol=1e-6)
    dep = tm.deploy(buckets=(1, 8, 64), max_batch=64)
    rows = [{f"f{i}": (None if np.isnan(cols[f"f{i}"][r])
                       else float(cols[f"f{i}"][r])) for i in range(F)}
            for r in range(40)]
    served = dep.predict_rows(rows)
    got = np.array([s["classProbabilities"]["1"] for s in served],
                   np.float32)
    np.testing.assert_array_equal(got, tp[:40])
    serve.undeploy(tm.key)


@pytest.mark.parametrize("method", ["PlattScaling", "IsotonicRegression"])
def test_calibration_fit_matches_jax(method):
    """Both packages' fits on the same probabilities (each model's
    ``_predict_matrix`` returns them)."""
    cols = _cols(seed=3, na_response=4)
    jfr = jh2o.Frame.from_numpy(cols)
    tfr = th2o.Frame.from_numpy(cols, device="cpu")
    rng = np.random.default_rng(5)
    y = np.nan_to_num(cols["label"])
    p1 = np.round(np.clip(0.3 + 0.4 * y + 0.25 * rng.normal(size=ROWS),
                          0.0, 1.0), 3).astype(np.float32)
    probs = np.stack([1 - p1, p1], axis=1)
    jm = JaxGBM(packed_codes=True, **dict(GBM, ntrees=1)).train(
        y="label", training_frame=jfr).model
    tm = H2OGradientBoostingEstimator(**dict(GBM, ntrees=1)).train(
        y="label", training_frame=tfr).model
    jm._predict_matrix = lambda X, offset=None: jnp.asarray(
        np.pad(probs, ((0, X.shape[0] - ROWS), (0, 0))))
    tm._predict_matrix = lambda X, offset=None: torch.as_tensor(probs)
    kw = dict(calibrate_model=True, calibration_method=method)
    JaxGBM(calibration_frame=jfr, **kw)._fit_calibration(jm)
    H2OGradientBoostingEstimator(calibration_frame=tfr,
                                 **kw)._fit_calibration(tm)
    jc, tc = jm.output["calibration"], tm.output["calibration"]
    assert tc["method"] == jc["method"]
    if tc["method"] == "platt":
        for k in ("a", "b"):
            assert abs(tc[k] - jc[k]) <= 1e-9 * abs(jc[k]), (k, tc, jc)
    else:
        assert tc["tx"] == jc["tx"] and tc["ty"] == jc["ty"]
        assert len(tc["tx"]) > 10


@pytest.mark.parametrize("method", ["auto", "isotonic"])
def test_calibrated_columns_match_jax(method):
    cols = _cols()
    cal = _cols(seed=9)
    kw = dict(GBM, calibrate_model=True, calibration_method=method)
    jm = JaxGBM(packed_codes=True, calibration_frame=jh2o.Frame.from_numpy(
        cal), **kw).train(y="label",
                          training_frame=jh2o.Frame.from_numpy(cols)).model
    tm = H2OGradientBoostingEstimator(
        calibration_frame=th2o.Frame.from_numpy(cal, device="cpu"),
        **kw).train(y="label",
                    training_frame=th2o.Frame.from_numpy(cols,
                                                         device="cpu")).model
    assert tm.output["calibration"]["method"] == \
        jm.output["calibration"]["method"]
    tp = tm.predict(th2o.Frame.from_numpy(cal, device="cpu"))
    jp = jm.predict(jh2o.Frame.from_numpy(cal))
    assert tp.names == jp.names
    assert tp.names[-2:] == ["cal_p0", "cal_p1"]
    for name in ("cal_p0", "cal_p1"):
        np.testing.assert_allclose(tp.vec(name).to_numpy(),
                                   jp.vec(name).to_numpy()[:ROWS], rtol=0,
                                   atol=1e-6)
    # the serve path appends no calibrated columns (as the JAX one)
    dep = tm.deploy(buckets=(1, 8), max_batch=8)
    out = dep.predict_rows([{"f0": 0.5, "f1": -1.0}])[0]
    assert set(out) == {"label", "classProbabilities"}
    serve.undeploy(tm.key)


def test_calibration_refusals():
    cols = _cols()
    fr = th2o.Frame.from_numpy(cols, device="cpu")
    three = th2o.Frame.from_numpy(_cols(k=3, shares=(0.4, 0.3, 0.3)),
                                  device="cpu")
    with pytest.raises(ValueError, match="requires a calibration_frame"):
        H2OGradientBoostingEstimator(ntrees=1, calibrate_model=True,
                                     distribution="bernoulli").train(
            y="label", training_frame=fr)
    with pytest.raises(ValueError, match="only supported for binomial"):
        H2OGradientBoostingEstimator(ntrees=1, calibrate_model=True,
                                     calibration_frame=three).train(
            y="label", training_frame=three)
    with pytest.raises(ValueError, match="unknown calibration_method"):
        H2OGradientBoostingEstimator(ntrees=1, calibrate_model=True,
                                     distribution="bernoulli",
                                     calibration_frame=fr,
                                     calibration_method="beta").train(
            y="label", training_frame=fr)
    with pytest.raises(NotImplementedError, match="item 18"):
        H2OGradientBoostingEstimator(ntrees=1, calibrate_model=True,
                                     distribution="bernoulli",
                                     calibration_frame="cal_key").train(
            y="label", training_frame=fr)
