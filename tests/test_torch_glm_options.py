"""The port's GLM options, trainers and model surface against the JAX
package, on the CPU.

- Missing values (Skip, PlugValues from a one-row Frame and from a
  dict, each against the JAX package's PlugValues train) and the
  options (beta_constraints, startval, non_negative,
  non_negative_columns, prior, offset_column with weights_column,
  compute_p_values for a gaussian and a binomial): coefficients within
  atol 2e-4 + rtol 2e-4, deviances within rtol 1e-5; the scoring state
  (impute means, NA plug levels) equal; predict on a frame with NA
  within 1e-4; standard errors, z and p within rtol 1e-3 (a pinv of a
  Gram summed in another order).
- The multinomial trainer (Cholesky and coordinate descent) and the
  ordinal one (ologit): class probabilities within 1e-4.
- What the JAX package refuses, the port refuses with the same
  exception type and words (the JAX job reports it inside a
  RuntimeError); the port's own refusals name ROADMAP item 15b.
- Persistence: a GLM saved by the JAX package loads in the port and
  predicts the same, and the other way round; ``from_jax_arrays`` of
  the JAX model's arrays predicts what the JAX model predicts.
- Serving: ``deploy`` and ``predict_rows``, and EasyPredict rows,
  bit-equal to ``predict``.
- The builder: a compatibility parameter warns in the JAX package's
  words; ``nfolds=3`` with ``modulo`` gives the JAX package's
  cross-validation metrics (within 1e-4).

2000 rows of the draw in test_torch_glm.py; the JAX trains on a
one-device mesh."""
import logging

import jax
import numpy as np
import pytest
import torch

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu import persist as jpersist
from h2o3_tpu.models.glm import H2OGeneralizedLinearEstimator as JaxGLM
from h2o3_tpu.parallel.mesh import current_mesh, make_mesh, set_mesh
from h2o3_tpu_torch import memman, serve
from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator
from h2o3_tpu_torch.genmodel import EasyPredictModelWrapper
from h2o3_tpu_torch.models.glm import GLM_COMPAT_PARAMS, GLMModel
from test_torch_glm import (COEF_TOL, draw, frames, response, same_coef,
                            same_metrics, train_both)
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

ROWS = 2000


@pytest.fixture(autouse=True, scope="module")
def _one_jax_device():
    old = current_mesh()
    set_mesh(make_mesh(n_data=1, devices=jax.devices()[:1]))
    yield
    set_mesh(old)
    serve.shutdown_all()


def _cols(family="gaussian", seed=11, rows=ROWS):
    cols, eta, rng = draw(rows=rows, seed=seed)
    cols["y"] = response(family, eta, rng)
    cols["wt"] = rng.uniform(0.5, 2.0, rows).astype(np.float32)
    cols["off"] = (0.2 * rng.normal(size=rows)).astype(np.float32)
    return cols


@pytest.fixture(scope="module")
def gauss():
    return _cols()


def _plug_frame():
    return jh2o.Frame.from_numpy({"x0": np.array([0.25], np.float32),
                                  "c1": np.array(["c"], dtype=object)})


def _plug_frame_port():
    return th2o.Frame.from_numpy({"x0": np.array([0.25], np.float32),
                                  "c1": np.array(["c"], dtype=object)},
                                 device="cpu")


@pytest.fixture(scope="module")
def plugged_jax(gauss):
    """The JAX package's PlugValues train (its frame and its dict forms
    give one model), shared by the port's two forms."""
    jfr, _ = frames(gauss)
    return JaxGLM(family="gaussian", ignored_columns=["wt", "off"],
                  missing_values_handling="PlugValues",
                  plug_values=_plug_frame()).train(
                      y="y", training_frame=jfr).model


@pytest.mark.parametrize("name", ["skip", "plug-frame", "plug-dict"])
def test_missing_values_handling_matches_jax(gauss, plugged_jax, name):
    params = dict(family="gaussian", ignored_columns=["wt", "off"])
    jfr, tfr = frames(gauss)
    if name == "skip":
        params["missing_values_handling"] = "Skip"
        jm = JaxGLM(**params).train(y="y", training_frame=jfr).model
    else:
        params["missing_values_handling"] = "PlugValues"
        params["plug_values"] = (_plug_frame_port() if name == "plug-frame"
                                 else {"x0": 0.25, "c1": "c"})
        jm = plugged_jax
    tm = H2OGeneralizedLinearEstimator(**params).train(
        y="y", training_frame=tfr).model
    same_coef(jm, tm)
    assert tm.residual_deviance == pytest.approx(jm.residual_deviance,
                                                 rel=1e-5)
    assert tm.nobs == jm.nobs
    assert getattr(jm, "cat_plugs", None) == tm.cat_plugs
    assert set(tm.impute_means) == set(jm.impute_means)
    for k, v in jm.impute_means.items():
        assert tm.impute_means[k] == pytest.approx(v, abs=1e-6)
    np.testing.assert_allclose(tm.predict(tfr).vec("predict").to_numpy(),
                               jm.predict(jfr).vec("predict").to_numpy(),
                               rtol=0, atol=1e-4)


OPTIONS = {
    "beta-constraints": ("gaussian", dict(
        beta_constraints={"x0": (-0.1, 0.2), "c1.b": (0.0, 0.1),
                          "x1": (-0.05, 1.0)})),
    "startval": ("poisson", dict(
        family="poisson", startval=[0.1] * 9 + [0.2], max_iterations=3)),
    "non-negative": ("gaussian", dict(non_negative=True)),
    "non-negative-columns": ("gaussian", dict(
        non_negative_columns=["x1", "c2.w"], alpha=0.5, Lambda=1e-3)),
    "prior": ("binomial", dict(family="binomial", prior=0.2)),
    "offset-weights": ("poisson", dict(
        family="poisson", offset_column="off", weights_column="wt")),
    "p-values-gaussian": ("gaussian", dict(compute_p_values=True,
                                           Lambda=0.0)),
    "p-values-binomial": ("binomial", dict(
        family="binomial", compute_p_values=True, Lambda=0.0,
        weights_column="wt")),
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_matches_jax(name):
    fam, params = OPTIONS[name]
    cols = _cols(fam, seed=12)
    params = dict(params)
    ignored = [c for c in ("wt", "off")
               if c not in (params.get("weights_column"),
                            params.get("offset_column"))]
    params["ignored_columns"] = ignored
    jm, tm, jfr, tfr = train_both(cols, params)
    same_coef(jm, tm)
    assert tm.null_deviance == pytest.approx(jm.null_deviance, rel=1e-5)
    assert tm.residual_deviance == pytest.approx(jm.residual_deviance,
                                                 rel=1e-5)
    same_metrics(jm.training_metrics, tm.training_metrics)
    tc = tm.coef()
    if name == "beta-constraints":
        assert -0.1 - 1e-6 <= tc["x0"] <= 0.2 + 1e-6
        assert 0.0 - 1e-6 <= tc["c1.b"] <= 0.1 + 1e-6
    if name == "non-negative":
        assert all(v >= 0 for k, v in tc.items() if k != "Intercept")
    if name == "non-negative-columns":
        assert tc["x1"] >= 0 and tc["c2.w"] >= 0
    if name.startswith("p-values"):
        jp, tp = jm.coef_with_p_values(), tm.coef_with_p_values()
        for k in ("std_errs", "z_values", "p_values"):
            assert list(tp[k]) == list(jp[k])
            np.testing.assert_allclose(list(tp[k].values()),
                                       list(jp[k].values()), rtol=1e-3,
                                       atol=1e-6)
        assert tm.output["dispersion"] == pytest.approx(
            jm.output["dispersion"], rel=1e-4)


def _classes(k, seed):
    cols, eta, rng = draw(rows=ROWS, seed=seed)
    cut = np.quantile(eta + 0.5 * rng.normal(size=ROWS),
                      np.linspace(0, 1, k + 1)[1:-1])
    cols["y"] = np.array([str(v + 1) for v in range(k)], dtype=object)[
        np.searchsorted(cut, eta + 0.5 * rng.normal(size=ROWS))]
    return cols


TRAINERS = {
    "multinomial-cholesky": (3, dict(family="multinomial",
                                     max_iterations=8)),
    "multinomial-cd": (3, dict(family="multinomial", alpha=0.5,
                               Lambda=1e-3, max_iterations=8)),
    "ordinal-logit": (4, dict(family="ordinal", max_iterations=10)),
}


@pytest.mark.parametrize("name", list(TRAINERS))
def test_multinomial_and_ordinal_match_jax(name):
    k, params = TRAINERS[name]
    cols = _classes(k, seed=13)
    jm, tm, jfr, tfr = train_both(cols, params)
    assert tm.family == jm.family and tm.nclasses == jm.nclasses == k
    names = ["predict"] + [f"p{i + 1}" for i in range(k)]
    jp, tp = jm.predict(jfr), tm.predict(tfr)
    for n in names[1:]:
        np.testing.assert_allclose(tp.vec(n).to_numpy(),
                                   jp.vec(n).to_numpy(), rtol=0, atol=1e-4)
    assert tm.residual_deviance == pytest.approx(jm.residual_deviance,
                                                 rel=1e-4)
    same_metrics(jm.training_metrics, tm.training_metrics)


def _raises_like_jax(cols, params, y="y", exc=ValueError, words=()):
    jfr, tfr = frames(cols)
    with pytest.raises(RuntimeError) as je:
        JaxGLM(**params).train(y=y, training_frame=jfr)
    with pytest.raises(exc) as te:
        H2OGeneralizedLinearEstimator(**params).train(y=y,
                                                      training_frame=tfr)
    assert f"{exc.__name__}: {te.value}" in str(je.value)
    for w in words:
        assert w in str(te.value)


REFUSALS = {
    "l1-lbfgs": ("binomial", dict(solver="L_BFGS", alpha=0.5, Lambda=0.1),
                 ValueError, ("L1 penalty", "L_BFGS")),
    "p-values-l1": ("gaussian", dict(compute_p_values=True, alpha=0.5,
                                     Lambda=0.1),
                    ValueError, ("p-values", "L1")),
    "negative-tweedie": ("gaussian", dict(family="tweedie",
                                          tweedie_variance_power=1.5),
                         ValueError, ("non-negative response",)),
    "prior-off-binomial": ("gaussian", dict(prior=0.2), ValueError,
                           ("prior", "binomial")),
    "multinomial-lambda-search": (3, dict(family="multinomial",
                                          lambda_search=True),
                                  NotImplementedError, ("lambda_search",)),
    "multinomial-offset": (3, dict(family="multinomial",
                                   offset_column="off"),
                           NotImplementedError, ("offset_column",)),
    "multinomial-beta-constraints": (3, dict(
        family="multinomial", beta_constraints={"x0": (0.0, 1.0)}),
        NotImplementedError, ("beta_constraints",)),
    "multinomial-startval": (3, dict(family="multinomial", startval=[0.0]),
                             NotImplementedError, ("startval",)),
    "ordinal-startval": (4, dict(family="ordinal", startval=[0.0]),
                         NotImplementedError, ("startval",)),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_match_jax(name):
    data, params, exc, words = REFUSALS[name]
    if isinstance(data, int):
        cols = _classes(data, seed=14)
        cols["off"] = np.zeros(ROWS, np.float32)
    else:
        cols = _cols(data, seed=14)
        if "tweedie" in name:
            cols["y"] = cols["y"] - 10.0
    params = dict(params)
    if "off" in cols and params.get("offset_column") != "off":
        params["ignored_columns"] = ["off"] + (
            ["wt"] if "wt" in cols else [])
    _raises_like_jax(cols, params, exc=exc, words=words)


def test_port_refusals_name_item_15b():
    cols = _cols(seed=15, rows=300)
    tfr = th2o.Frame.from_numpy(cols, device="cpu")
    with pytest.raises(NotImplementedError, match="item 15b"):
        H2OGeneralizedLinearEstimator(HGLM=True).train(y="y",
                                                       training_frame=tfr)
    memman.reset(budget=20_000)
    try:
        big = th2o.Frame.from_numpy(cols, device="cpu")
        with pytest.raises(NotImplementedError, match="item 15b"):
            H2OGeneralizedLinearEstimator().train(y="y", training_frame=big)
    finally:
        memman.reset()
    with pytest.raises(ValueError, match="unknown parameter"):
        H2OGeneralizedLinearEstimator(no_such_parameter=1)


@pytest.fixture(scope="module")
def binomial_models():
    cols = _cols("binomial", seed=16)
    params = dict(family="binomial", ignored_columns=["wt", "off"],
                  missing_values_handling="PlugValues",
                  plug_values={"c2": "v"}, interactions=["x0", "c1"])
    jm, tm, jfr, tfr = train_both(cols, params)
    return cols, jm, tm, jfr, tfr


def _p1(model, fr):
    return model.predict(fr).vec("pY").to_numpy()


def test_artifacts_load_across_packages(binomial_models, tmp_path):
    cols, jm, tm, jfr, tfr = binomial_models
    jpath = jpersist.save_model(jm, str(tmp_path / "jax"))
    loaded = th2o.load_model(jpath, device="cpu")
    assert isinstance(loaded, GLMModel)
    assert loaded.cat_plugs == jm.cat_plugs == {"c2": 1}
    np.testing.assert_allclose(_p1(loaded, tfr), _p1(jm, jfr), rtol=0,
                               atol=1e-6)
    tpath = th2o.save_model(tm, str(tmp_path / "port"))
    back = jpersist.load_model(tpath)
    np.testing.assert_allclose(_p1(back, jfr), _p1(tm, tfr), rtol=0,
                               atol=1e-6)
    again = th2o.load_model(tpath, device="cpu")
    np.testing.assert_array_equal(_p1(again, tfr), _p1(tm, tfr))
    assert again.coef() == tm.coef()


def test_from_jax_arrays_predicts_like_jax(binomial_models):
    cols, jm, tm, jfr, tfr = binomial_models
    meta = dict(jm._save_extra_meta(), names=jm.feature_names,
                is_cat=jm.feature_is_cat, cat_domains=jm.cat_domains,
                response_domain=jm.response_domain, nclasses=jm.nclasses,
                params={k: jm.params.get(k) for k in (
                    "link", "interactions", "interaction_pairs")})
    m = GLMModel.from_jax_arrays(jm._save_arrays(), meta, device="cpu")
    np.testing.assert_allclose(_p1(m, tfr), _p1(jm, jfr), rtol=0, atol=1e-6)


def _rows(cols, idx):
    out = []
    for r in idx:
        row = {}
        for n in ("x0", "x1", "x2", "x3", "c1", "c2"):
            v = cols[n][r]
            if n.startswith("x"):
                row[n] = None if np.isnan(v) else float(v)
            else:
                row[n] = v
        out.append(row)
    return out


def test_served_and_easypredict_rows_equal_predict(binomial_models):
    cols, jm, tm, jfr, tfr = binomial_models
    idx = np.arange(70)
    want = _p1(tm, tfr.rows(idx))
    dep = tm.deploy(buckets=(1, 8, 64), max_batch=64)
    try:
        served = dep.predict_rows(_rows(cols, idx))
    finally:
        serve.undeploy(tm.key)
    got = np.array([s["classProbabilities"]["Y"] for s in served],
                   np.float32)
    np.testing.assert_array_equal(got, want)
    ep = EasyPredictModelWrapper(tm)
    got = np.array([ep.predict_row(r)["classProbabilities"]["Y"]
                    for r in _rows(cols, idx[:10])], np.float32)
    np.testing.assert_array_equal(got, want[:10])


def test_compat_parameter_warns_like_jax(caplog):
    from h2o3_tpu.models.compat_params import COMPAT_PARAMS
    assert GLM_COMPAT_PARAMS == COMPAT_PARAMS["glm"]
    cols = _cols(seed=17, rows=500)
    params = dict(remove_collinear_columns=True,
                  ignored_columns=["wt", "off"])
    jlog = logging.getLogger("h2o3_tpu")
    jlog.addHandler(caplog.handler)     # that logger does not propagate
    try:
        with caplog.at_level(logging.WARNING, logger="h2o3_tpu_torch"), \
                caplog.at_level(logging.WARNING, logger="h2o3_tpu"):
            jm, tm, _, _ = train_both(cols, params)
    finally:
        jlog.removeHandler(caplog.handler)
    said = {r.name: r.getMessage() for r in caplog.records
            if "parameter 'remove_collinear_columns'" in r.getMessage()}
    assert set(said) == {"h2o3_tpu", "h2o3_tpu_torch"}
    assert said["h2o3_tpu"] == said["h2o3_tpu_torch"]
    same_coef(jm, tm)


def test_cross_validation_matches_jax():
    cols = _cols("binomial", seed=18, rows=1200)
    params = dict(family="binomial", nfolds=3, fold_assignment="modulo",
                  ignored_columns=["wt", "off"])
    jm, tm, _, _ = train_both(cols, params)
    same_coef(jm, tm)
    np.testing.assert_array_equal(tm.output["cv_fold_assignment"],
                                  jm.output["cv_fold_assignment"])
    for fm, jfm in zip(tm.output["cross_validation_models"],
                       jm.output["cross_validation_models"]):
        same_coef(jfm, fm, **COEF_TOL)
    np.testing.assert_allclose(
        tm.output["cross_validation_holdout_predictions"],
        jm.output["cross_validation_holdout_predictions"], rtol=0,
        atol=1e-4)
    cvm, jcvm = tm.cross_validation_metrics, jm.cross_validation_metrics
    assert cvm.auc == pytest.approx(jcvm.auc, abs=1e-4)
    assert cvm.logloss == pytest.approx(jcvm.logloss, abs=1e-4)
