"""Checkpoints (ROADMAP item A3) against the JAX package: model artifacts
(``persist.save_model`` / ``load_model``: one zip of ``meta.json`` and
``arrays.npz``) load across both packages and predict the same (atol
1e-6), for the GBM and the random forest; a JAX in-training checkpoint
(``<key>_t<n>.zip`` with its float32 margin or out-of-bag sums) resumed
by both packages grows equal trees (splits exact, values rtol = atol =
1e-5), for the GBM, a sampled GBM (tree i keyed by its index in the
whole model) and the forest with its out-of-bag metrics; a continued
live model (no resume state: the margin is summed again from the trees)
matches the JAX package's continuation; the port's own resume from
``_t<n>`` equals its uninterrupted train bit for bit; every
compatibility refusal of ``_resolve_checkpoint``, and a checkpoint by a
keyed-store name (ROADMAP.md item 18).

1999 rows (the JAX frame pads them to 2000) x 5 features with 3% NA
cells, depth 3, at most 5 trees, float32 histograms; the JAX trains run
on a one-device mesh, as in test_torch_sampling.py."""
import logging
import os

import jax
import numpy as np
import pytest

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu import persist as jpersist
from h2o3_tpu.models.drf import H2ORandomForestEstimator as JaxDRF
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as JaxGBM
from h2o3_tpu.parallel.mesh import current_mesh, make_mesh, set_mesh
from h2o3_tpu_torch import persist
from h2o3_tpu_torch.estimators import (H2OGradientBoostingEstimator,
                                       H2ORandomForestEstimator)
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

ROWS, F = 1999, 5
GBM = dict(max_depth=3, nbins=14, histogram_type="quantiles_global",
           histogram_precision="float32", min_rows=1.0, seed=7,
           learn_rate=0.2, learn_rate_annealing=0.95,
           distribution="bernoulli")
CASES = {
    "gbm": (H2OGradientBoostingEstimator, JaxGBM, GBM,
            dict(packed_codes=True)),
    "gbm_sampled": (H2OGradientBoostingEstimator, JaxGBM,
                    dict(GBM, sample_rate=0.8, col_sample_rate=0.8),
                    dict(packed_codes=True)),
    "drf": (H2ORandomForestEstimator, JaxDRF,
            dict(max_depth=3, seed=7, nbins=14,
                 histogram_type="quantiles_global",
                 histogram_precision="float32"), dict(packed_codes=True)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_jax_device():
    old = current_mesh()
    set_mesh(make_mesh(n_data=1, devices=jax.devices()[:1]))
    yield
    set_mesh(old)


def _cols(seed=0, enum_label=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(ROWS, F)).astype(np.float32)
    s = X[:, 0] * 1.5 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    y = (rng.random(ROWS) < 1.0 / (1.0 + np.exp(-s))).astype(np.int64)
    X[rng.random(X.shape) < 0.03] = np.nan
    cols = {f"f{i}": X[:, i] for i in range(F)}
    cols["label"] = (np.array(["no", "yes"], dtype=object)[y]
                     if enum_label else y.astype(np.float32))
    return cols


def _frames(case):
    cols = _cols(enum_label=case == "drf")
    return (jh2o.Frame.from_numpy(cols),
            th2o.Frame.from_numpy(cols, device="cpu"))


def _same_trees(tm, jm, exact=False):
    assert tm.ntrees_built == jm.ntrees_built
    for key in ("feat", "thr", "na_left", "is_split"):
        np.testing.assert_array_equal(tm.trees[key],
                                      np.asarray(getattr(jm, "_" + key)),
                                      err_msg=key)
    if exact:
        np.testing.assert_array_equal(tm.trees["value"],
                                      np.asarray(jm._value))
    else:
        np.testing.assert_allclose(tm.trees["value"], np.asarray(jm._value),
                                   rtol=1e-5, atol=1e-5)


def _probs(pred):
    return pred.vec(pred.names[-1]).to_numpy()[:ROWS]


@pytest.mark.parametrize("case", ["gbm", "drf"])
def test_jax_artifact_loads_in_port(case, tmp_path):
    _te, je, kw, jx = CASES[case]
    jfr, tfr = _frames(case)
    jm = je(ntrees=3, **kw, **jx).train(y="label", training_frame=jfr).model
    path = jpersist.save_model(jm, str(tmp_path), filename="j.zip")
    tm = persist.load_model(path, device="cpu")
    assert type(tm).__name__ == type(jm).__name__
    assert (tm.key, tm.ntrees_built, tm.feature_names) == (
        jm.key, jm.ntrees_built, jm.feature_names)
    assert tm.training_metrics.auc == jm.training_metrics.auc
    np.testing.assert_allclose(_probs(tm.predict(tfr)),
                               _probs(jm.predict(jfr)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["gbm", "drf"])
def test_port_artifact_loads_in_jax(case, tmp_path):
    te, _je, kw, _jx = CASES[case]
    jfr, tfr = _frames(case)
    tm = te(ntrees=3, **kw).train(y="label", training_frame=tfr).model
    path = persist.save_model(tm, str(tmp_path), filename="t.zip")
    jm = jpersist.load_model(path)
    assert (jm.key, jm.ntrees_built) == (tm.key, tm.ntrees_built)
    assert jm.training_metrics.auc == tm.training_metrics.auc
    assert jm.output["variable_importances"] == \
        tm.output["variable_importances"]
    np.testing.assert_allclose(_probs(jm.predict(jfr)),
                               _probs(tm.predict(tfr)), rtol=0, atol=1e-6)
    with pytest.raises(FileExistsError):
        persist.save_model(tm, str(tmp_path), filename="t.zip")


@pytest.mark.parametrize("case", list(CASES))
def test_jax_in_training_checkpoint_resumed_by_both(case, tmp_path):
    """JAX writes ``j_t2.zip`` of a 4-tree train; the JAX package and the
    port each resume from it to 4 trees."""
    te, je, kw, jx = CASES[case]
    jfr, tfr = _frames(case)
    je(ntrees=4, model_id="j", in_training_checkpoints_dir=str(tmp_path),
       in_training_checkpoints_tree_interval=2, **kw, **jx).train(
        y="label", training_frame=jfr)
    path = str(tmp_path / "j_t2.zip")
    assert os.path.exists(path)
    jres = je(ntrees=4, checkpoint=path, **kw, **jx).train(
        y="label", training_frame=jfr).model
    tres = te(ntrees=4, checkpoint=path, **kw).train(
        y="label", training_frame=tfr).model
    _same_trees(tres, jres)
    assert abs(tres.training_metrics.auc - jres.training_metrics.auc) \
        <= 1e-6
    if case == "drf":
        assert tres.output["oob_metrics"] and jres.output["oob_metrics"]
        assert tres.training_metrics.nobs == jres.training_metrics.nobs
        assert abs(tres.training_metrics.logloss
                   - jres.training_metrics.logloss) <= 1e-6


@pytest.mark.parametrize("case", list(CASES))
def test_port_resume_is_bit_equal(case, tmp_path):
    """The port's resume from its own ``_t2`` (of a 5-tree train, every
    second tree) equals its uninterrupted train in every bit: trees,
    training metrics, importances; the checkpointing train itself is the
    uninterrupted one."""
    te, _je, kw, _jx = CASES[case]
    _jfr, tfr = _frames(case)
    full = te(ntrees=5, **kw).train(y="label", training_frame=tfr).model
    ck = te(ntrees=5, model_id="t", in_training_checkpoints_dir=str(tmp_path),
            in_training_checkpoints_tree_interval=2, **kw).train(
        y="label", training_frame=tfr).model
    names = sorted(os.listdir(tmp_path))
    assert names == ["t_t2.zip", "t_t4.zip", "t_t5.zip"], names
    assert [c["trees"] for c in ck.output["checkpoints"]] == [2, 4, 5]
    res = te(ntrees=5, checkpoint=str(tmp_path / "t_t2.zip"), **kw).train(
        y="label", training_frame=tfr).model
    for m in (ck, res):
        assert m.ntrees_built == 5
        for key in ("feat", "thr", "na_left", "is_split", "value",
                    "node_w"):
            np.testing.assert_array_equal(m.trees[key], full.trees[key],
                                          err_msg=key)
        assert m.training_metrics.auc == full.training_metrics.auc
        assert m.training_metrics.logloss == full.training_metrics.logloss
    assert res.output["variable_importances"]["variable"] == \
        full.output["variable_importances"]["variable"]


def test_live_model_continues_like_jax():
    """A finished model has no resume state: both packages sum its trees
    again for the margin; the continuations agree as trains do."""
    _te, _je, kw, jx = CASES["gbm"]
    jfr, tfr = _frames("gbm")
    jm = JaxGBM(ntrees=2, **kw, **jx).train(y="label",
                                            training_frame=jfr).model
    tm = H2OGradientBoostingEstimator(ntrees=2, **kw).train(
        y="label", training_frame=tfr).model
    jc = JaxGBM(ntrees=4, checkpoint=jm, **kw, **jx).train(
        y="label", training_frame=jfr).model
    tc = H2OGradientBoostingEstimator(ntrees=4, checkpoint=tm, **kw).train(
        y="label", training_frame=tfr).model
    _same_trees(tc, jc)
    assert abs(tc.training_metrics.auc - jc.training_metrics.auc) <= 1e-6


@pytest.fixture(scope="module")
def prior(tmp_path_factory):
    """A one-tree port GBM on a frame with an enum feature and its
    artifact."""
    cols = _cols()
    cols["colour"] = np.array(["red", "blue"], dtype=object)[
        np.arange(ROWS) % 2]
    fr = th2o.Frame.from_numpy(cols, device="cpu")
    m = H2OGradientBoostingEstimator(ntrees=1, **GBM).train(
        y="label", training_frame=fr).model
    path = persist.save_model(m, str(tmp_path_factory.mktemp("prior")),
                              filename="p.zip")
    return cols, m, path


def _refused(cols, m, path, change):
    """The prior's train with one change: (params, cols, checkpoint)."""
    cols = dict(cols)
    params = dict(GBM, ntrees=3, checkpoint=path)
    if change == "distribution":
        params["distribution"] = "gaussian"
    elif change == "max_depth":
        params["max_depth"] = 4
    elif change == "ntrees":
        params["ntrees"] = 1
    elif change == "features":
        del cols["f4"]
    elif change == "nclasses":
        cols["label"] = np.arange(ROWS) % 3
        params["distribution"] = "bernoulli"
    elif change == "response_domain":
        cols["label"] = np.where(cols["label"] > 0, 2.0, 0.0)
    elif change == "cat_domains":
        cols["colour"] = np.array(["red", "green"], dtype=object)[
            np.arange(ROWS) % 2]
    elif change == "type":
        params["checkpoint"] = 3
    elif change == "kind":
        drf = H2ORandomForestEstimator(ntrees=1, max_depth=3).train(
            y="label", training_frame=th2o.Frame.from_numpy(
                dict(cols, label=np.array(["a", "b"], dtype=object)[
                    (cols["label"] > 0).astype(int)]), device="cpu")).model
        params["checkpoint"] = persist.save_model(
            drf, os.path.dirname(path), force=True, filename="drf.zip")
    elif change == "live":
        params["checkpoint"] = m
        params["max_depth"] = 2
    return params, cols


@pytest.mark.parametrize("change,exc,match", [
    ("distribution", ValueError, "checkpoint distribution 'bernoulli'"),
    ("max_depth", ValueError, "max_depth differs"),
    ("ntrees", ValueError, "must exceed the checkpoint's ntrees_built"),
    ("features", ValueError, "feature set"),
    ("nclasses", ValueError, "response classes"),
    ("response_domain", ValueError, "response domain"),
    ("cat_domains", ValueError, "categorical domains differ"),
    ("type", ValueError, "must be a GBM model or an artifact path"),
    ("kind", ValueError, "can only continue from its own kind"),
    ("live", ValueError, "max_depth differs"),
])
def test_checkpoint_refusals(prior, change, exc, match):
    cols, m, path = prior
    params, cols = _refused(cols, m, path, change)
    fr = th2o.Frame.from_numpy(cols, device="cpu")
    with pytest.raises(exc, match=match):
        H2OGradientBoostingEstimator(**params).train(y="label",
                                                     training_frame=fr)


def test_keyed_store_checkpoint_and_unknown_algo_refused(prior, tmp_path):
    """A string that names no file would be a keyed-store key: refused,
    naming ROADMAP.md item 18; an artifact of an algorithm the port
    does not have raises ValueError, as in the JAX package."""
    cols, m, _path = prior
    fr = th2o.Frame.from_numpy(cols, device="cpu")
    for est in (H2OGradientBoostingEstimator(ntrees=3, checkpoint=m.key,
                                             **{k: v for k, v in GBM.items()
                                                if k != "seed"}),
                H2ORandomForestEstimator(ntrees=3, checkpoint="drf_0")):
        with pytest.raises(NotImplementedError, match="item 18"):
            est.train(y="label", training_frame=fr)
    path = persist.save_model(m, str(tmp_path), filename="k.zip")
    import json
    import zipfile
    with zipfile.ZipFile(path) as z:
        meta = json.loads(z.read("meta.json"))
        arrays = z.read("arrays.npz")
    meta["algo"] = "kmeans"
    with zipfile.ZipFile(path, "w") as z:
        z.writestr("meta.json", json.dumps(meta))
        z.writestr("arrays.npz", arrays)
    with pytest.raises(ValueError, match="no registered model class"):
        persist.load_model(path, device="cpu")


def test_failed_commit_is_logged_and_train_goes_on(tmp_path, caplog):
    """A checkpoint directory that cannot be made: the write is logged,
    the train finishes; a resume margin of other data is not applied
    (the JAX package's warning) and the margin is summed again."""
    _jfr, tfr = _frames("gbm")
    blocker = tmp_path / "file"
    blocker.write_text("x")
    with caplog.at_level(logging.WARNING, logger="h2o3_tpu_torch"):
        m = H2OGradientBoostingEstimator(
            ntrees=2, in_training_checkpoints_dir=str(blocker / "sub"),
            **GBM).train(y="label", training_frame=tfr).model
    assert m.ntrees_built == 2
    assert "in-training checkpoint write failed" in caplog.text
    ck_dir = tmp_path / "ck"
    H2OGradientBoostingEstimator(
        ntrees=2, model_id="c", in_training_checkpoints_dir=str(ck_dir),
        **GBM).train(y="label", training_frame=tfr)
    other = _cols(seed=1)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="h2o3_tpu_torch"):
        c = H2OGradientBoostingEstimator(
            ntrees=3, checkpoint=str(ck_dir / "c_t1.zip"), **GBM).train(
            y="label",
            training_frame=th2o.Frame.from_numpy(other, device="cpu")).model
    assert "belongs to different training data" in caplog.text
    assert c.ntrees_built == 3
