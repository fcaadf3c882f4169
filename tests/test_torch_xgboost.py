"""The port's XGBoost estimator against the JAX package's: the parameter
map (one parametrised test over the cases of test_kmeans_pca_xgb.py, the
tree methods, the bin budgets and the stopping keys), the refusals, and
trees, training AUC and predict for tree_method "hist" (packed quantile
codes, nbins 254, W = 256) and "auto" (packed uniform edges, nbins 62,
W = 64) at float32 histograms; a JAX XGBoost model carried across
through from_jax_arrays predicts as in JAX."""
import numpy as np
import pytest

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu.models.xgboost import H2OXGBoostEstimator as JaxXGB
from h2o3_tpu_torch.estimators import H2OXGBoostEstimator as TorchXGB
from h2o3_tpu_torch.models.gbm import GBMModel
from h2o3_tpu_torch.models.xgboost import XGB_DEFAULTS, xgboost_gbm_params
from h2o3_tpu_torch.ops.hist_adaptive import pick_W
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

ROWS, F = 3000, 8


def xgb_data(rows=ROWS, seed=0):
    """HIGGS-like columns (the chip smoke's generator at 8 features) with
    3% NA cells."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, F)).astype(np.float32)
    logit = (X[:, 0] * 1.5 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
             + 0.3 * np.sin(3 * X[:, 4]))
    y = (rng.random(rows) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    X[rng.random(X.shape) < 0.03] = np.nan
    cols = {f"f{i}": X[:, i] for i in range(F)}
    cols["label"] = y
    return cols


@pytest.mark.parametrize("params", [
    # test_kmeans_pca_xgb.py::test_xgboost_estimator_param_mapping
    dict(ntrees=7, max_depth=4, eta=0.2, subsample=0.8,
         colsample_bytree=0.7, reg_lambda=2.0, reg_alpha=0.1,
         min_child_weight=3.0, gamma=0.01, seed=5),
    # ::test_xgboost_trains_binomial
    dict(ntrees=30, max_depth=4, eta=0.3, seed=1),
    # ::test_xgboost_gbm_spelled_params_win
    dict(learn_rate=0.05, sample_rate=0.6),
    dict(),
    dict(tree_method="hist"),
    dict(tree_method="hist", max_bins=64),
    dict(tree_method="exact", max_bins=32),
    dict(tree_method="approx", max_bins=2000),
    dict(n_estimators=9, nbins=100, min_rows=4.0),
    dict(colsample_bylevel=0.5, col_sample_rate_per_tree=0.9),
    dict(stopping_rounds=3, stopping_metric="AUC", score_tree_interval=5,
         stopping_tolerance=1e-4),
    dict(packed_codes=True, histogram_precision="float32",
         distribution="bernoulli", learn_rate_annealing=0.99),
    # keys the JAX map drops
    dict(weights_column="w", model_id="m", ignored_columns=["f0"]),
    # checkpoints (A3) and constraints (A5) pass, as GBM defaults
    dict(checkpoint="x_t5.zip", in_training_checkpoints_dir="ck",
         in_training_checkpoints_tree_interval=5),
    dict(monotone_constraints={"f0": 1},
         interaction_constraints=[["f0", "f1"]]),
    # cross-validation and class balancing (A7) are dropped
    dict(nfolds=3, fold_column="fold", fold_assignment="modulo",
         balance_classes=True, class_sampling_factors=[1.0, 2.0]),
], ids=lambda p: ",".join(sorted(p)) or "defaults")
def test_param_map_matches_jax(params):
    """Every GBM parameter the port's map gives equals the JAX
    estimator's, and the keys the JAX map drops are dropped too."""
    want = JaxXGB(**params).params
    got = xgboost_gbm_params(params)
    for k, v in got.items():
        assert k in want and want[k] == v, (k, v, want.get(k))
    dropped = [k for k in params
               if k not in got and k not in XGB_DEFAULTS
               and k != "n_estimators"]
    for k in dropped:
        assert k not in want or want[k] is None, k
    if "weights_column" in params:
        assert dropped == ["weights_column", "model_id", "ignored_columns"]


def test_calibration_parameters_are_dropped_as_in_jax():
    """The JAX map drops calibrate_model and calibration_frame (its
    estimator keeps the builder's default, False), so its XGBoost never
    calibrates; the port's map drops them too (ROADMAP.md queue 3)."""
    cal = dict(calibrate_model=True, calibration_method="isotonic",
               calibration_frame=None)
    got = xgboost_gbm_params(cal)
    assert not set(cal) & set(got)
    assert JaxXGB(**cal).params["calibrate_model"] is False
    assert TorchXGB(**cal).params["calibrate_model"] is False


def test_booster_other_than_gbtree_raises():
    for est in (JaxXGB, TorchXGB):
        with pytest.raises(NotImplementedError, match="gbtree only"):
            est(booster="dart")
    with pytest.raises(NotImplementedError, match="gbtree only"):
        xgboost_gbm_params({"booster": "gblinear"})


@pytest.mark.parametrize("params", [
    {"subsample": 0.8}, {"colsample_bytree": 0.5},
    {"colsample_bylevel": 0.7}])
def test_sampling_raises_the_a4_refusal(params):
    """Named for the refusal it held until sampling (ROADMAP item A4)
    was ported: the map holds the value as the JAX estimator's does, and
    the port's XGBoost now trains with it, to the JAX package's trees
    (its train on a one-device mesh, where its row draw is the
    port's)."""
    import jax
    from h2o3_tpu.parallel.mesh import current_mesh, make_mesh, set_mesh
    want = JaxXGB(**params).params
    got = TorchXGB(**params).params
    for k in ("sample_rate", "col_sample_rate", "col_sample_rate_per_tree"):
        assert got[k] == want[k]
    cols = xgb_data(seed=2)
    kw = dict(XGB, tree_method="hist", ntrees=3, **params)
    old = current_mesh()
    set_mesh(make_mesh(n_data=1, devices=jax.devices()[:1]))
    try:
        jm = JaxXGB(packed_codes=True, **kw).train(
            y="label", training_frame=jh2o.Frame.from_numpy(cols)).model
    finally:
        set_mesh(old)
    tm = TorchXGB(**kw).train(
        y="label",
        training_frame=th2o.Frame.from_numpy(cols, device="cpu")).model
    for key in ("feat", "thr", "na_left", "is_split"):
        np.testing.assert_array_equal(tm.trees[key],
                                      np.asarray(getattr(jm, "_" + key)),
                                      err_msg=key)
    np.testing.assert_allclose(tm.trees["value"], np.asarray(jm._value),
                               rtol=1e-5, atol=1e-5)


def test_unknown_parameter_raises():
    """A JAX GBM key the port does not know passes the map, as in JAX,
    and the port's GBM refuses it."""
    assert xgboost_gbm_params({"hist_kernel": "pallas"})["hist_kernel"] \
        == "pallas"
    with pytest.raises(ValueError, match="unknown parameter"):
        TorchXGB(hist_kernel="pallas")


XGB = dict(ntrees=5, max_depth=4, seed=7, distribution="bernoulli",
           histogram_precision="float32")
_MODELS = {}


def _models(tree_method):
    """Both packages' XGBoost on one frame (module cache): the JAX side
    packs on the CPU only when asked (packed_codes=True), the port packs
    at 'auto' on every device. Seed 2: seed 0 has a node whose six NA
    rows can be cut off by two mirrored splits of equal gain (ROADMAP.md
    queue 3, a tie, not a fault)."""
    if tree_method not in _MODELS:
        cols = xgb_data(seed=2)
        jfr = jh2o.Frame.from_numpy(cols)
        tfr = th2o.Frame.from_numpy(cols, device="cpu")
        kw = dict(XGB, tree_method=tree_method)
        jm = JaxXGB(packed_codes=True, **kw).train(
            y="label", training_frame=jfr).model
        tm = TorchXGB(**kw).train(y="label", training_frame=tfr).model
        _MODELS[tree_method] = (jm, jfr, tm, tfr)
    return _MODELS[tree_method]


@pytest.mark.parametrize("tree_method,n_bins,W", [
    ("hist", 254, 256), ("auto", 62, 64)])
def test_trees_auc_and_predict_match_jax(tree_method, n_bins, W):
    jm, jfr, tm, tfr = _models(tree_method)
    assert tm.n_bins == jm.n_bins == n_bins and pick_W(n_bins) == W
    assert tm.output["packed_codes"] == jm.output["packed_codes"]
    assert tm.output["packed_codes"]["W"] == W
    assert tm.ntrees_built == jm.ntrees_built == XGB["ntrees"]
    assert bool(tm.trees["is_split"].any())
    for k, j in (("feat", jm._feat), ("thr", jm._thr),
                 ("na_left", jm._na_left), ("is_split", jm._is_split)):
        np.testing.assert_array_equal(tm.trees[k], np.asarray(j), err_msg=k)
    np.testing.assert_allclose(tm.trees["value"], np.asarray(jm._value),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tm.f0, np.asarray(jm.f0))
    assert abs(tm.training_metrics.auc - jm.training_metrics.auc) <= 1e-6
    jp = jm.predict(jfr).vec("p1").to_numpy()
    tp = tm.predict(tfr).vec("p1").to_numpy()
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    assert tm.params["reg_lambda"] == 1.0 and tm.params["learn_rate"] == 0.3


def test_from_jax_arrays_predicts_like_jax():
    """A JAX XGBoost model's arrays carried into the port's GBMModel."""
    jm, jfr, _tm, tfr = _models("hist")
    meta = {"dist_name": jm.dist_name, "n_bins": jm.n_bins,
            "max_depth": jm.max_depth, "ntrees_built": jm.ntrees_built,
            "nclasses": jm.nclasses, "names": jm.feature_names,
            "response_domain": jm.response_domain}
    carried = GBMModel.from_jax_arrays(jm._save_arrays(), meta,
                                       device="cpu")
    got = carried.predict(tfr).vec("p1").to_numpy()
    want = jm.predict(jfr).vec("p1").to_numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("tree_method", ["hist", "auto"])
def test_model_api_matches_jax(tree_method):
    """A8 on the XGBoost model: ``model_performance`` of another frame,
    the h2o-py accessors and ``varimp``, as the JAX package's (metrics
    within 1e-5; varimp's order exact, its gains within rtol 1e-5)."""
    jm, _jfr, tm, _tfr = _models(tree_method)
    te = xgb_data(seed=3)
    jperf = jm.model_performance(jh2o.Frame.from_numpy(te))
    tperf = tm.model_performance(th2o.Frame.from_numpy(te, device="cpu"))
    assert tm.model_performance() is tm.training_metrics
    assert tperf.nobs == jperf.nobs
    for name in ("auc", "logloss", "rmse", "mse", "mae", "r2"):
        for j, t in ((getattr(jperf, name, None), getattr(tperf, name, None)),
                     (jm._metric(name), getattr(tm, name)())):
            assert (j is None) == (t is None), name
            if t is not None:
                assert abs(t - j) <= 1e-5, (name, t, j)
    jv, tv = jm.varimp(), tm.varimp()
    assert tv["variable"] == jv["variable"]
    np.testing.assert_allclose(tv["relative_importance"],
                               jv["relative_importance"], rtol=1e-5)
