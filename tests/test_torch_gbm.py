"""The slice as a whole: a JAX GBM and the port's GBM trained on the same
frame (bernoulli, float32 histograms) agree on every tree, on the
training AUC and on predict, on packed codes, on adaptive bins (asked
for, and where packing cannot hold the bins) and on the unpacked global
sketch; and the port scores a JAX model carried across through
from_jax_arrays."""
import numpy as np
import pytest

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as JaxGBM
from h2o3_tpu_torch.models.gbm import GBMModel
from h2o3_tpu_torch.models.gbm import H2OGradientBoostingEstimator as TorchGBM
from h2o3_tpu_torch.ops.hist_adaptive import pick_W as tha_pick_W
import torch
from torch_threads import DEFAULT_THREADS
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

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


def test_default_thread_pool_trains_the_jax_trees(models):
    """The port's packed train at torch's default thread pool, not the
    test worker's share (``torch_threads``): the JAX package's trees and
    AUC, as in ``test_trees_match`` and ``test_auc_and_predict_match``."""
    jm, _jfr, _tm, tfr = models
    old = torch.get_num_threads()
    torch.set_num_threads(DEFAULT_THREADS)
    try:
        tm = TorchGBM(**PARAMS).train(y="label", training_frame=tfr).model
    finally:
        torch.set_num_threads(old)
    for k in ("feat", "thr", "na_left", "is_split"):
        np.testing.assert_array_equal(tm.trees[k],
                                      np.asarray(getattr(jm, "_" + k)),
                                      err_msg=k)
    np.testing.assert_allclose(tm.trees["value"], np.asarray(jm._value),
                               rtol=1e-5, atol=1e-5)
    assert abs(tm.training_metrics.auc - jm.training_metrics.auc) <= 1e-6


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


def _paths(feat, is_split):
    """Each tree's root-to-leaf sets of split features."""
    out = []
    for t in range(feat.shape[0]):
        def walk(node, used):
            if node >= feat.shape[1] or not is_split[t, node]:
                if used:
                    out.append(frozenset(used))
                return
            walk(2 * node + 1, used | {int(feat[t, node])})
            walk(2 * node + 2, used | {int(feat[t, node])})
        walk(0, set())
    return out


@pytest.mark.parametrize("param", [
    {"balance_classes": True}, {"checkpoint": "gbm_1"},
    {"monotone_constraints": {"f0": 1}},
    {"interaction_constraints": [["f0", "f1"]]},
])
def test_unsupported_parameters_raise(param):
    """Named for the refusals these parameters met until items A3, A5
    and A7 were ported. A keyed-store name as ``checkpoint`` is still
    refused, naming ROADMAP.md item 18; the others train, and what they
    do shows: the class distributions recorded, predictions that never
    fall along f0, no path that mixes f0 or f1 with another feature."""
    fr = th2o.Frame.from_numpy(_data(), device="cpu")
    est = TorchGBM(ntrees=3, max_depth=3, distribution="bernoulli",
                   min_rows=1.0, seed=7, **param)
    if "checkpoint" in param:
        with pytest.raises(NotImplementedError, match="item 18"):
            est.train(y="label", training_frame=fr)
        return
    m = est.train(y="label", training_frame=fr).model
    if "balance_classes" in param:
        assert np.isclose(sum(m.output["prior_class_dist"]), 1.0)
        np.testing.assert_allclose(m.output["model_class_dist"], [0.5, 0.5])
    elif "monotone_constraints" in param:
        sweep = np.zeros((201, F), np.float32)
        sweep[:, 0] = np.linspace(-3, 3, 201)
        p1 = m.predict(th2o.Frame.from_numpy(
            {f"f{i}": sweep[:, i] for i in range(F)},
            device="cpu")).vec("p1").to_numpy()
        assert (np.diff(p1) >= -1e-6).all()
    else:
        for used in _paths(m.trees["feat"], m.trees["is_split"]):
            assert used <= {0, 1} or len(used) == 1, sorted(used)


@pytest.mark.parametrize("param", [
    {"histogram_type": "random", "nbins": 20},
    {"sample_rate_per_class": [1.0, 0.5]},
    {"col_sample_rate_per_tree": 0.5},
    {"sample_rate": 0.8}, {"col_sample_rate": 0.5}, {"mtries": 3},
])
def test_sampling_parameters_train_and_match_jax(param):
    """The sampling parameters the port refused until item A4 train now,
    to the JAX package's trees (its train on a one-device mesh, where
    its row draw is the port's; mtries the JAX GBM accepts and never
    reads)."""
    import jax
    from h2o3_tpu.parallel.mesh import current_mesh, make_mesh, set_mesh
    cols = _data()
    kw = dict(PARAMS)
    kw.update(param)
    old = current_mesh()
    set_mesh(make_mesh(n_data=1, devices=jax.devices()[:1]))
    try:
        jm = JaxGBM(packed_codes=True, **kw).train(
            y="label", training_frame=jh2o.Frame.from_numpy(cols)).model
    finally:
        set_mesh(old)
    tm = TorchGBM(**kw).train(
        y="label",
        training_frame=th2o.Frame.from_numpy(cols, device="cpu")).model
    for key in ("feat", "thr", "na_left", "is_split"):
        np.testing.assert_array_equal(tm.trees[key],
                                      np.asarray(getattr(jm, "_" + key)),
                                      err_msg=key)
    np.testing.assert_allclose(tm.trees["value"], np.asarray(jm._value),
                               rtol=1e-5, atol=1e-5)


def test_unknown_parameter_and_validation_frame_raise():
    """An unknown parameter raises ValueError; a validation frame trains
    now, and what is still refused around it (a checkpoint by the model's
    key, ROADMAP.md item 18) raises; the live model continues."""
    with pytest.raises(ValueError, match="unknown parameter"):
        TorchGBM(hist_kernel="pallas")
    fr = th2o.Frame.from_numpy(_data(), device="cpu")
    m = TorchGBM(ntrees=1, max_depth=2, distribution="bernoulli").train(
        y="label", training_frame=fr, validation_frame=fr).model
    assert m.validation_metrics.auc == m.training_metrics.auc
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TorchGBM(ntrees=2, max_depth=2, checkpoint=m.key).train(
            y="label", training_frame=fr)
    m2 = TorchGBM(ntrees=2, max_depth=2, distribution="bernoulli",
                  checkpoint=m).train(y="label", training_frame=fr,
                                      validation_frame=fr).model
    assert m2.ntrees_built == 2
    np.testing.assert_array_equal(m2.trees["feat"][:1], m.trees["feat"])


@pytest.mark.parametrize("key,away", [
    ("categorical_encoding", "one_hot_explicit"),
    ("nbins_top_level", 256), ("build_tree_one_node", True)])
@pytest.mark.parametrize("at_default", [True, False])
def test_compat_parameters_train_and_warn_away_from_default(
        caplog, key, away, at_default):
    """The reference's compatibility-only GBM parameters: both packages
    take them and train the same trees; each warns, in the same words on
    its own logger, only where the value is away from its default."""
    import logging

    from h2o3_tpu_torch.models.gbm import GBM_COMPAT_PARAMS
    from h2o3_tpu.models.compat_params import COMPAT_PARAMS
    assert GBM_COMPAT_PARAMS == COMPAT_PARAMS["gbm"]
    value = GBM_COMPAT_PARAMS[key] if at_default else away
    params = dict(PARAMS, ntrees=1, **{key: value})
    cols = _data()
    jlog = logging.getLogger("h2o3_tpu")
    jlog.addHandler(caplog.handler)     # that logger does not propagate
    try:
        with caplog.at_level(logging.WARNING, logger="h2o3_tpu_torch"), \
                caplog.at_level(logging.WARNING, logger="h2o3_tpu"):
            jm = JaxGBM(**params).train(
                y="label", training_frame=jh2o.Frame.from_numpy(cols)).model
            tm = TorchGBM(**params).train(
                y="label",
                training_frame=th2o.Frame.from_numpy(cols, device="cpu")
            ).model
    finally:
        jlog.removeHandler(caplog.handler)
    said = {r.name: r.getMessage() for r in caplog.records
            if f"parameter '{key}'" in r.getMessage()}
    if at_default:
        assert said == {}
    else:
        assert set(said) == {"h2o3_tpu", "h2o3_tpu_torch"}
        assert said["h2o3_tpu"] == said["h2o3_tpu_torch"]
        assert "NOT implemented" in said["h2o3_tpu_torch"]
    assert tm.params[key] == value
    ja = jm._save_arrays()
    for k in ("feat", "is_split", "na_left"):
        np.testing.assert_array_equal(np.asarray(ja[k]), tm.trees[k])
    assert tm.training_metrics.auc == pytest.approx(
        jm.training_metrics.auc, abs=1e-6)


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


# ------------------------------------------------------- wide-bin shapes


@pytest.mark.parametrize("params", [
    # XGBoost's tree_method="hist" at max_bins=256: packed int16 codes,
    # W = 256
    dict(nbins=254, histogram_type="quantiles_global", packed_codes=True),
    # nbins 62 packed (W = 64, int8 codes)
    dict(nbins=62, histogram_type="quantiles_global", packed_codes=True),
    # XGBoost's tree_method="auto": uniform-adaptive bins at W = 64
    dict(nbins=62, packed_codes=False)],
    ids=["packed_254", "packed_62", "adaptive_62"])
def test_wide_bin_shapes_match_jax(params):
    """The wide lane widths (W = 64 and 256) that the packed and adaptive
    levels take at nbins 62 and 254: trees, AUC and predict equal the JAX
    GBM's at float32 histograms."""
    cols = _data(seed=13)
    jfr = jh2o.Frame.from_numpy(cols)
    tfr = th2o.Frame.from_numpy(cols, device="cpu")
    kw = dict(GLOBAL, **params)
    jm, tm = _train_both(jfr, tfr, **kw)
    W = 256 if params["nbins"] == 254 else 64
    assert tha_pick_W(tm.n_bins) == W
    assert bool(tm.trees["is_split"].any())
    assert tm.ntrees_built == jm.ntrees_built == kw["ntrees"]
    for k, j in (("feat", jm._feat), ("thr", jm._thr),
                 ("na_left", jm._na_left), ("is_split", jm._is_split)):
        np.testing.assert_array_equal(tm.trees[k], np.asarray(j), err_msg=k)
    np.testing.assert_allclose(tm.trees["value"], np.asarray(jm._value),
                               rtol=1e-5, atol=1e-5)
    assert tm.output["packed_codes"] == jm.output["packed_codes"]
    assert tm.output["packed_codes"]["enabled"] == params["packed_codes"]
    assert abs(tm.training_metrics.auc - jm.training_metrics.auc) <= 1e-6
    jp = jm.predict(jfr).vec("p1").to_numpy()
    tp = tm.predict(tfr).vec("p1").to_numpy()
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)


def test_refusals_name_their_roadmap_labels(tmp_path):
    """What the port still refuses names its ROADMAP.md item: a
    checkpoint by a keyed-store name (item 18, dkv.py). Checkpoints
    (A3), constraints (A5) and cross-validation (A7) construct and train
    now, and the JAX package's own refusals hold: a monotone constraint
    on an enum column, an unknown constraint column."""
    cols = _data()
    cols["colour"] = np.array(["red", "blue"], dtype=object)[
        np.arange(ROWS) % 2]
    fr = th2o.Frame.from_numpy(cols, device="cpu")
    with pytest.raises(NotImplementedError, match="item 18"):
        TorchGBM(ntrees=1, checkpoint="gbm_1").train(y="label",
                                                      training_frame=fr)
    m = TorchGBM(ntrees=2, max_depth=2, model_id="ck",
                 in_training_checkpoints_dir=str(tmp_path)).train(
        y="label", training_frame=fr).model
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck_t1.zip",
                                                          "ck_t2.zip"]
    assert [c["trees"] for c in m.output["checkpoints"]] == [1, 2]
    assert TorchGBM(ntrees=1, sample_rate=0.8).params["sample_rate"] == 0.8
    with pytest.raises(ValueError, match="categorical column 'colour'"):
        TorchGBM(ntrees=1, monotone_constraints={"colour": 1}).train(
            y="label", training_frame=fr)
    with pytest.raises(ValueError, match="column 'nope'"):
        TorchGBM(ntrees=1, interaction_constraints=[["f0", "nope"]]).train(
            y="label", training_frame=fr)
    assert TorchGBM(ntrees=1, nfolds=3).params["nfolds"] == 3


# ------------------------------------------------------ the model API (A8)

API_TASKS = {
    "binomial": dict(distribution="bernoulli"),
    "multinomial": dict(distribution="multinomial"),
    "regression": dict(distribution="gaussian"),
    "regression_offset": dict(distribution="gaussian", offset_column="off"),
}
API_METRICS = ("auc", "logloss", "rmse", "mse", "mae", "r2")


def _api_cols(task, seed):
    cols = _data(seed)
    rng = np.random.default_rng(seed + 100)
    s = np.nan_to_num(cols["f0"]) - np.nan_to_num(cols["f1"])
    if task == "multinomial":
        cols["label"] = np.array(["a", "b", "c"], dtype=object)[
            np.digitize(s + rng.normal(size=ROWS), [-0.7, 0.7])]
    elif task.startswith("regression"):
        cols["label"] = (s + 0.3 * rng.normal(size=ROWS)).astype(np.float32)
        cols["off"] = (0.5 * rng.normal(size=ROWS)).astype(np.float32)
    return cols


@pytest.mark.parametrize("task", list(API_TASKS))
def test_model_api_matches_jax(task):
    """A8 on the GBM: ``model_performance`` (None: the training metrics
    themselves; a frame: its response remapped through the training
    domain, its offset applied), the h2o-py accessors and ``varimp``, as
    the JAX package returns them on the same models (one-device mesh).
    Metrics within 1e-5 (abs; the AUC of K classes within 2e-6 of
    1: bucket crossings, ROADMAP.md queue 3); varimp's order exact, its
    gains within rtol 1e-5."""
    import jax
    from h2o3_tpu.parallel.mesh import current_mesh, make_mesh, set_mesh
    kw = dict(PARAMS, ntrees=2, **API_TASKS[task])
    tr, te = _api_cols(task, 0), _api_cols(task, 1)
    old = current_mesh()
    set_mesh(make_mesh(n_data=1, devices=jax.devices()[:1]))
    try:
        jm = JaxGBM(packed_codes=True, **kw).train(
            y="label", training_frame=jh2o.Frame.from_numpy(tr)).model
        jperf = jm.model_performance(jh2o.Frame.from_numpy(te))
    finally:
        set_mesh(old)
    tm = TorchGBM(**kw).train(
        y="label", training_frame=th2o.Frame.from_numpy(tr, device="cpu")
    ).model
    tperf = tm.model_performance(th2o.Frame.from_numpy(te, device="cpu"))
    assert tm.model_performance() is tm.training_metrics
    assert type(tperf).__name__ == type(jperf).__name__
    for name in API_METRICS:
        for valid in (False, True):
            j, t = (jm._metric(name, valid), tm._metric(name, valid))
            assert getattr(tm, name)(valid=valid) == t
            assert (j is None) == (t is None), (name, valid)
            if t is not None:
                assert abs(t - j) <= 1e-5, (name, t, j)
        j, t = getattr(jperf, name, None), getattr(tperf, name, None)
        assert (j is None) == (t is None), name
        if t is not None:
            assert abs(t - j) <= (2e-6 if name == "auc" else 1e-5), (
                name, t, j)
    assert tperf.nobs == jperf.nobs
    jv, tv = jm.varimp(), tm.varimp()
    assert tv["variable"] == jv["variable"]
    np.testing.assert_allclose(tv["relative_importance"],
                               jv["relative_importance"], rtol=1e-5)
