"""The slice as a whole: a JAX GBM and the port's GBM trained on the same
frame (bernoulli, float32 histograms) agree on every tree, on the
training AUC and on predict, on packed codes, on adaptive bins (asked
for, and where packing cannot hold the bins) and on the unpacked global
sketch; and the port scores a JAX model carried across through
from_jax_arrays."""
import numpy as np
import pytest
import torch

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as JaxGBM
from h2o3_tpu_torch.models.gbm import GBMModel
from h2o3_tpu_torch.models.gbm import H2OGradientBoostingEstimator as TorchGBM

ROWS, F = 3000, 6
PARAMS = dict(ntrees=3, max_depth=3, nbins=14, learn_rate=0.1,
              distribution="bernoulli", histogram_type="quantiles_global",
              histogram_precision="float32", min_rows=1.0, seed=7)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(ROWS, F)).astype(np.float32)
    logit = X[:, 0] * 1.5 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    y = (rng.random(ROWS) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    X[rng.random(X.shape) < 0.03] = np.nan
    cols = {f"f{i}": X[:, i] for i in range(F)}
    cols["label"] = y
    return cols


@pytest.fixture(scope="module")
def models():
    cols = _data()
    jfr = jh2o.Frame.from_numpy(cols)
    jm = JaxGBM(packed_codes=True, **PARAMS).train(
        y="label", training_frame=jfr).model
    tfr = th2o.Frame.from_numpy(cols, device="cpu")
    tm = TorchGBM(**PARAMS).train(y="label", training_frame=tfr).model
    return jm, jfr, tm, tfr


def test_trees_match(models):
    jm, _jfr, tm, _tfr = models
    assert tm.ntrees_built == jm.ntrees_built == PARAMS["ntrees"]
    np.testing.assert_array_equal(tm.trees["feat"], np.asarray(jm._feat))
    np.testing.assert_array_equal(tm.trees["thr"], np.asarray(jm._thr))
    np.testing.assert_array_equal(tm.trees["na_left"],
                                  np.asarray(jm._na_left))
    np.testing.assert_array_equal(tm.trees["is_split"],
                                  np.asarray(jm._is_split))
    # values allclose 1e-5: an interior node's value is -G/H of a gradient
    # sum that cancels to ~0 at the root, and the JAX run sums it over the
    # suite's 8 virtual devices in another order (observed |d| <= 2e-6)
    np.testing.assert_allclose(tm.trees["value"], np.asarray(jm._value),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tm.f0, np.asarray(jm.f0))
    assert tm.output["packed_codes"] == jm.output["packed_codes"]


def test_auc_and_predict_match(models):
    jm, jfr, tm, tfr = models
    assert abs(tm.training_metrics.auc - jm.training_metrics.auc) <= 1e-6
    assert abs(tm.training_metrics.logloss
               - jm.training_metrics.logloss) <= 1e-6
    jp = jm.predict(jfr).vec("p1").to_numpy()
    tp = tm.predict(tfr)
    assert tp.names == ["predict", "p0", "p1"]
    np.testing.assert_allclose(tp.vec("p1").to_numpy(), jp, rtol=1e-5,
                               atol=1e-7)


def test_from_jax_arrays_predicts_like_jax(models):
    jm, jfr, _tm, tfr = models
    meta = {"dist_name": jm.dist_name, "n_bins": jm.n_bins,
            "max_depth": jm.max_depth, "ntrees_built": jm.ntrees_built,
            "nclasses": jm.nclasses, "names": jm.feature_names,
            "response_domain": jm.response_domain}
    carried = GBMModel.from_jax_arrays(jm._save_arrays(), meta,
                                       device="cpu")
    got = carried.predict(tfr).vec("p1").to_numpy()
    want = jm.predict(jfr).vec("p1").to_numpy()
    X = np.stack([tfr.vec(n).to_numpy() for n in jm.feature_names], 1)
    assert np.isnan(X).any(axis=1).sum() > 100    # rows with NaN scored
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_gaussian_regression_trains_on_cpu():
    cols = _data(seed=3)
    cols["label"] = cols["f0"] * 2.0 + np.nan_to_num(cols["f1"])
    cols["label"] = np.nan_to_num(cols["label"]).astype(np.float32)
    fr = th2o.Frame.from_numpy(cols, device="cpu")
    m = TorchGBM(ntrees=5, max_depth=3, nbins=14, min_rows=1.0,
                 histogram_type="quantiles_global").train(
        y="label", training_frame=fr).model
    assert m.dist_name == "gaussian"
    assert m.training_metrics.r2 > 0.5
    assert m.predict(fr).names == ["predict"]


@pytest.mark.parametrize("param", [
    {"histogram_type": "random"},
    {"distribution": "multinomial"}, {"distribution": "poisson"},
    {"stopping_rounds": 3}, {"checkpoint": "gbm_1"},
    {"sample_rate": 0.8}, {"col_sample_rate": 0.5}, {"mtries": 3},
    {"monotone_constraints": {"f0": 1}},
    {"interaction_constraints": [["f0", "f1"]]},
])
def test_unsupported_parameters_raise(param):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TorchGBM(**param)


def test_unknown_parameter_and_validation_frame_raise():
    with pytest.raises(ValueError, match="unknown parameter"):
        TorchGBM(hist_kernel="pallas")
    fr = th2o.Frame.from_numpy(_data(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TorchGBM(ntrees=1).train(y="label", training_frame=fr,
                                 validation_frame=fr)


# ------------------------------------------------------------ adaptive path

# min_rows 10: leaves of a few rows tie exactly between features that cut
# out the same rows, and their -G/H amplifies the summation order of the
# JAX run's 8 virtual devices past 1e-5
ADAPTIVE = dict(ntrees=3, max_depth=3, learn_rate=0.1,
                distribution="bernoulli", histogram_precision="float32",
                min_rows=10.0, seed=7)


def _with_enum(cols, card, seed=1):
    """``cols`` plus an enum column of ``card`` levels that carries part
    of the signal, in both packages' frames."""
    rng = np.random.default_rng(seed)
    cat = rng.permutation(np.arange(ROWS) % card).astype(np.float32)
    cols = dict(cols)
    lab = cols.pop("label")
    low = cat < card // 3                 # the low levels lean positive
    cols["cat"] = cat
    cols["label"] = np.where(low, rng.random(ROWS) < 0.85,
                             lab).astype(np.float32)
    jfr = jh2o.Frame.from_numpy(cols)
    jfr["cat"] = jfr.vec("cat").asfactor()
    tfr = th2o.Frame.from_numpy(cols, device="cpu")
    tfr = th2o.Frame(tfr.names, [tfr.vec(n).asfactor() if n == "cat"
                                 else tfr.vec(n) for n in tfr.names])
    return jfr, tfr


def _train_both(jfr, tfr, **params):
    jm = JaxGBM(**params).train(y="label", training_frame=jfr).model
    tm = TorchGBM(**params).train(y="label", training_frame=tfr).model
    return jm, tm


@pytest.fixture(scope="module")
def adaptive_models():
    """packed_codes=False and the default histogram type
    (uniform_adaptive, nbins 20 -> W=32) in both packages."""
    cols = _data(seed=4)
    jfr = jh2o.Frame.from_numpy(cols)
    tfr = th2o.Frame.from_numpy(cols, device="cpu")
    jm, tm = _train_both(jfr, tfr, packed_codes=False, **ADAPTIVE)
    return jm, jfr, tm, tfr


def _assert_same_model(jm, tm):
    assert tm.ntrees_built == jm.ntrees_built
    for k, j in (("feat", jm._feat), ("thr", jm._thr),
                 ("na_left", jm._na_left), ("is_split", jm._is_split)):
        np.testing.assert_array_equal(tm.trees[k], np.asarray(j), err_msg=k)
    np.testing.assert_allclose(tm.trees["value"], np.asarray(jm._value),
                               rtol=1e-5, atol=1e-5)
    assert tm.output["packed_codes"] == jm.output["packed_codes"] \
        == {"enabled": False}
    assert tm.edges == [] and jm.edges == []
    assert abs(tm.training_metrics.auc - jm.training_metrics.auc) <= 1e-6
    assert abs(tm.training_metrics.logloss
               - jm.training_metrics.logloss) <= 1e-6


def test_adaptive_trees_auc_and_predict_match(adaptive_models):
    jm, jfr, tm, tfr = adaptive_models
    assert tm.n_bins == 20
    assert bool(tm.trees["is_split"].any())
    _assert_same_model(jm, tm)
    jp = jm.predict(jfr).vec("p1").to_numpy()
    tp = tm.predict(tfr).vec("p1").to_numpy()
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-7)


def test_adaptive_from_jax_arrays_predicts_like_jax(adaptive_models):
    jm, jfr, _tm, tfr = adaptive_models
    meta = {"dist_name": jm.dist_name, "n_bins": jm.n_bins,
            "max_depth": jm.max_depth, "ntrees_built": jm.ntrees_built,
            "nclasses": jm.nclasses, "names": jm.feature_names,
            "response_domain": jm.response_domain}
    arrays = jm._save_arrays()
    assert not any(k.startswith("edge_") for k in arrays)
    carried = GBMModel.from_jax_arrays(arrays, meta, device="cpu")
    got = carried.predict(tfr).vec("p1").to_numpy()
    want = jm.predict(jfr).vec("p1").to_numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_packing_fallback_takes_the_adaptive_path_in_both():
    """packed_codes=True, but an enum of 300 levels puts the sketch's bin
    count past the 254 packed lanes: both packages fall back to adaptive
    bins, here at W=256."""
    jfr, tfr = _with_enum(_data(seed=6), 300)
    jm, tm = _train_both(jfr, tfr, packed_codes=True, nbins=20, **ADAPTIVE)
    assert tm.n_bins == 254
    assert (tm.trees["feat"] == tm.feature_names.index("cat")).any()
    _assert_same_model(jm, tm)


def test_adaptive_with_small_enum_matches_jax():
    jfr, tfr = _with_enum(_data(seed=8), 12)
    jm, tm = _train_both(jfr, tfr, packed_codes=False, nbins=14, **ADAPTIVE)
    _assert_same_model(jm, tm)


# ------------------------------------------------------ global-sketch path

GLOBAL = dict(ntrees=3, max_depth=3, learn_rate=0.1,
              distribution="bernoulli", histogram_precision="float32",
              min_rows=1.0, seed=7)


@pytest.mark.parametrize("params", [
    {"packed_codes": False, "histogram_type": "quantiles_global"},
    {"nbins": 300}])
def test_global_sketch_path_matches_jax(params):
    """The global-sketch grower (unpacked codes), which the port refused
    before it had one: asked for (quantiles_global without packing), and
    where neither packing nor adaptive bins hold the bins (nbins 300,
    uniform_adaptive: equal-width sketch edges). It trains, and its trees,
    AUC and predict match the JAX GBM's."""
    cols = _data(seed=9)
    jfr = jh2o.Frame.from_numpy(cols)
    tfr = th2o.Frame.from_numpy(cols, device="cpu")
    jm, tm = _train_both(jfr, tfr, **GLOBAL, **params)
    assert tm.n_bins == jm.n_bins == params.get("nbins", 20)
    assert bool(tm.trees["is_split"].any())
    assert tm.ntrees_built == jm.ntrees_built
    for k, j in (("feat", jm._feat), ("thr", jm._thr),
                 ("na_left", jm._na_left), ("is_split", jm._is_split)):
        np.testing.assert_array_equal(tm.trees[k], np.asarray(j), err_msg=k)
    np.testing.assert_allclose(tm.trees["value"], np.asarray(jm._value),
                               rtol=1e-5, atol=1e-5)
    assert tm.output["packed_codes"] == jm.output["packed_codes"] \
        == {"enabled": False}
    assert abs(tm.training_metrics.auc - jm.training_metrics.auc) <= 1e-6
    assert abs(tm.training_metrics.logloss
               - jm.training_metrics.logloss) <= 1e-6
    jp = jm.predict(jfr).vec("p1").to_numpy()
    tp = tm.predict(tfr).vec("p1").to_numpy()
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-7)


def test_packed_and_global_give_the_same_splits():
    """At float32 histograms the packed grower (int8 codes, NA in lane
    W-1, max_bin) and the global-sketch grower (uint8 codes, NA = bin
    n_bins, sibling subtraction) pick the same splits on the same sketch,
    and the deepest leaves, summed from the same rows, are bit-equal."""
    tfr = th2o.Frame.from_numpy(_data(seed=10), device="cpu")
    kw = dict(GLOBAL, ntrees=5, max_depth=4, nbins=14,
              histogram_type="quantiles_global")
    packed = TorchGBM(packed_codes=True, **kw).train(
        y="label", training_frame=tfr).model
    glob = TorchGBM(packed_codes=False, **kw).train(
        y="label", training_frame=tfr).model
    assert packed.output["packed_codes"]["enabled"]
    assert not glob.output["packed_codes"]["enabled"]
    for k in ("feat", "split_bin", "thr", "na_left", "is_split"):
        np.testing.assert_array_equal(packed.trees[k], glob.trees[k],
                                      err_msg=k)
    baseD = 2 ** kw["max_depth"] - 1
    np.testing.assert_array_equal(packed.trees["value"][:, baseD:],
                                  glob.trees["value"][:, baseD:])
