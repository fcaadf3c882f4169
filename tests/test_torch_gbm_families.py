"""The GBM's other families against the JAX package: poisson, gamma,
tweedie, laplace, quantile, huber and a custom family, each with and
without an offset column (3000 rows x 6 features with 3% NA cells,
depth 3, 3 trees, float32 histograms, packed codes; poisson with an
offset and huber also on adaptive bins). Trees equal (feat, thr, na_left
and is_split exactly, value within rtol = atol = 1e-5, f0 within 1e-6),
the training deviance within rtol 1e-6, predict within 1e-5. A custom
poisson (a torch copy registered under a name) trains the built-in
poisson's trees bit for bit. What the JAX package refuses, the port
refuses in its words: predict on a frame without the offset column, a
validation frame without it, and multinomial with an offset.

The response weights are 1.0, so the weighted quantiles of laplace,
quantile and huber pick the same row in both packages (every cumulative
weight an exact float32 integer)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu.models import distributions as jd
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as JaxGBM
from h2o3_tpu.parallel.mesh import current_mesh, make_mesh, set_mesh
from h2o3_tpu_torch import serve
from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
from h2o3_tpu_torch.genmodel import EasyPredictModelWrapper
from h2o3_tpu_torch.models import distributions as td
from h2o3_tpu_torch.models.gbm import MULTINOMIAL_OFFSET, GBMModel
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

ROWS, F = 3000, 6
BASE = dict(ntrees=3, max_depth=3, learn_rate=0.1, nbins=14,
            histogram_type="quantiles_global",
            histogram_precision="float32", min_rows=1.0, seed=7)
FAMILIES = ["poisson", "gamma", "tweedie", "laplace", "quantile", "huber",
            "custom:torch_poisson"]
# the family's own parameters where it has one
EXTRA = {"tweedie": dict(tweedie_power=1.5),
         "quantile": dict(quantile_alpha=0.9),
         "huber": dict(huber_alpha=0.9)}


class _JaxPoisson(jd.Distribution):
    """The custom family of the JAX side: the built-in poisson's math."""
    name = "torch_poisson"

    def init_f0(self, y, w):
        return jnp.log(jnp.maximum((w * y).sum() / w.sum(), 1e-9))

    def grad_hess(self, f, y):
        mu = jnp.exp(f)
        return mu - y, jnp.maximum(mu, 1e-9)

    def predict(self, f):
        return jnp.exp(f)

    def deviance(self, w, y, mu):
        return jd.Poisson().deviance(w, y, mu)


class _TorchPoisson(td.Distribution):
    """A user's poisson, written in torch."""
    name = "torch_poisson"

    def init_f0(self, y, w):
        return torch.log(torch.clamp((w * y).sum() / w.sum(), min=1e-9))

    def grad_hess(self, f, y):
        mu = torch.exp(f)
        return mu - y, torch.clamp(mu, min=1e-9)

    def predict(self, f):
        return torch.exp(f)

    def deviance(self, w, y, mu):
        return td.Poisson().deviance(w, y, mu)


@pytest.fixture(autouse=True, scope="module")
def _one_jax_device_and_custom():
    old = current_mesh()
    set_mesh(make_mesh(n_data=1, devices=jax.devices()[:1]))
    jd.register_custom_distribution("torch_poisson", _JaxPoisson())
    td.register_custom_distribution("torch_poisson", _TorchPoisson())
    yield
    set_mesh(old)
    jd._CUSTOM.pop("torch_poisson", None)
    td._CUSTOM.pop("torch_poisson", None)
    serve.shutdown_all()


def _cols(family, rows=ROWS, seed=0):
    """Six features with 3% NA cells, a log exposure in (0, 1] as the
    offset column, and a response in the family's domain."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, F)).astype(np.float32)
    expo = rng.uniform(0.05, 1.0, rows).astype(np.float32)
    eta = 0.6 * X[:, 0] - 0.4 * X[:, 1] + 0.3 * np.sin(2 * X[:, 2])
    if family in ("poisson", "tweedie") or family.startswith("custom"):
        y = rng.poisson(2.0 * expo * np.exp(eta)).astype(np.float32)
        if family == "tweedie":
            y = (y * rng.gamma(2.0, 500.0, rows)).astype(np.float32)
    elif family == "gamma":
        y = rng.gamma(2.0, 800.0 * expo * np.exp(eta) / 2.0).astype(
            np.float32)
    else:
        y = (3.0 * eta + np.log(expo) + rng.standard_t(3, rows)).astype(
            np.float32)
    X[rng.random(X.shape) < 0.03] = np.nan
    cols = {f"f{i}": X[:, i] for i in range(F)}
    cols["log_expo"] = np.log(expo).astype(np.float32)
    cols["y"] = y
    return cols


def _train_both(family, offset, extra=None, cols=None):
    cols = cols if cols is not None else _cols(family)
    kw = dict(BASE, distribution=family, **EXTRA.get(family, {}),
              **(extra or {}))
    if offset:
        kw["offset_column"] = "log_expo"
    else:
        kw["ignored_columns"] = ["log_expo"]
    jkw = dict(kw)
    if kw.get("histogram_type") == "quantiles_global" \
            and kw.get("packed_codes", True):
        jkw["packed_codes"] = True
    jfr = jh2o.Frame.from_numpy(cols)
    tfr = th2o.Frame.from_numpy(cols, device="cpu")
    jm = JaxGBM(**jkw).train(y="y", training_frame=jfr).model
    tm = H2OGradientBoostingEstimator(**kw).train(y="y",
                                                  training_frame=tfr).model
    return jm, jfr, tm, tfr


def _same(jm, jfr, tm, tfr):
    assert tm.ntrees_built == jm.ntrees_built == BASE["ntrees"]
    assert bool(tm.trees["is_split"].any())
    for key in ("feat", "thr", "na_left", "is_split"):
        np.testing.assert_array_equal(tm.trees[key],
                                      np.asarray(getattr(jm, "_" + key)),
                                      err_msg=key)
    np.testing.assert_allclose(tm.trees["value"], np.asarray(jm._value),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.f0, np.asarray(jm.f0), rtol=1e-6,
                               atol=1e-6)
    assert tm.training_metrics.mean_residual_deviance == pytest.approx(
        jm.training_metrics.mean_residual_deviance, rel=1e-6)
    jp = jm.predict(jfr).vec("predict").to_numpy()
    tp = tm.predict(tfr).vec("predict").to_numpy()
    assert np.all(np.isfinite(tp))
    np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("offset", [False, True], ids=["plain", "offset"])
@pytest.mark.parametrize("family", FAMILIES)
def test_family_trains_like_jax(family, offset):
    jm, jfr, tm, tfr = _train_both(family, offset)
    assert tm.dist_name == jm.dist_name == family
    _same(jm, jfr, tm, tfr)
    # three trees already beat the intercept-only model (f0 plus offset)
    y = torch.from_numpy(_cols(family)["y"])
    off = tfr.vec("log_expo").as_float() if offset else 0.0
    est = H2OGradientBoostingEstimator(distribution=family,
                                       **EXTRA.get(family, {}))
    dist = est._dist(family, float(tm.output.get("huber_delta", 1.0)))
    f0 = torch.from_numpy(np.asarray(tm.f0))
    mu0 = dist.predict(f0 + off + torch.zeros_like(y))
    intercept = float(dist.deviance(torch.ones_like(y), y, mu0))
    assert tm.training_metrics.mean_residual_deviance < intercept


@pytest.mark.parametrize("family", ["poisson", "huber", "quantile"])
def test_adaptive_path_trains_like_jax(family):
    """The same families on adaptive bins (uniform_adaptive, nbins 20),
    with the offset."""
    jm, jfr, tm, tfr = _train_both(
        family, True, dict(histogram_type="uniform_adaptive", nbins=20,
                           packed_codes=False, min_rows=10.0))
    assert not tm.output["packed_codes"]["enabled"]
    _same(jm, jfr, tm, tfr)


def test_custom_poisson_equals_builtin_bit_for_bit():
    """A torch copy of poisson, registered under a name, grows the
    built-in poisson's trees bit for bit, with and without the offset;
    an instance given as custom_distribution_func wins over the
    registry."""
    cols = _cols("poisson", seed=3)
    tfr = th2o.Frame.from_numpy(cols, device="cpu")
    for kw in (dict(offset_column="log_expo"),
               dict(ignored_columns=["log_expo"])):
        models = [H2OGradientBoostingEstimator(
            **BASE, distribution=d, **kw).train(
                y="y", training_frame=tfr).model
            for d in ("poisson", "custom:torch_poisson")]
        models.append(H2OGradientBoostingEstimator(
            **BASE, distribution="custom",
            custom_distribution_func=_TorchPoisson(), **kw).train(
                y="y", training_frame=tfr).model)
        ref = models[0]
        for m in models[1:]:
            for key in ("feat", "thr", "na_left", "is_split", "value"):
                np.testing.assert_array_equal(m.trees[key], ref.trees[key])
            np.testing.assert_array_equal(m.f0, ref.f0)


def test_huber_delta_is_the_alpha_quantile_of_the_residuals():
    """The huber transition point: the huber_alpha weighted quantile of
    |r - median(r)|, r the offset-adjusted response, against the JAX
    package's functions on the same inputs."""
    cols = _cols("huber", seed=4)
    y, off = cols["y"], cols["log_expo"]
    w = np.ones(ROWS, np.float32)
    est = H2OGradientBoostingEstimator(huber_alpha=0.8)
    tfr = th2o.Frame.from_numpy(cols, device="cpu")
    from h2o3_tpu_torch.models.model_base import build_training_spec
    spec = build_training_spec(tfr, "y", offset_column="log_expo",
                               classification=False)
    got = est._huber_delta(spec)
    r = jnp.asarray(y - off)
    med = jd.weighted_median(r, jnp.asarray(w))
    want = jnp.maximum(jd.weighted_quantile(jnp.abs(r - med),
                                            jnp.asarray(w), 0.8), 1e-10)
    assert float(got) == float(want)


def test_offset_enters_the_margin_not_the_trees():
    """Predict with the offset equals predict at offset 0 times
    exp(offset) for a log-link family, and the margin's offset is the
    frame's column (NA -> 0)."""
    cols = _cols("poisson", seed=5)
    cols["log_expo"][:7] = np.nan
    tfr = th2o.Frame.from_numpy(cols, device="cpu")
    m = H2OGradientBoostingEstimator(
        **BASE, distribution="poisson", offset_column="log_expo").train(
            y="y", training_frame=tfr).model
    assert "log_expo" not in m.feature_names
    with_off = m.predict(tfr).vec("predict").to_numpy()
    zero = dict(cols, log_expo=np.zeros(ROWS, np.float32))
    at0 = m.predict(th2o.Frame.from_numpy(zero, device="cpu")).vec(
        "predict").to_numpy()
    off = np.nan_to_num(cols["log_expo"])
    np.testing.assert_allclose(with_off, at0 * np.exp(off), rtol=1e-5)
    np.testing.assert_array_equal(with_off[:7], at0[:7])


def test_missing_offset_raises_like_jax():
    """predict on a frame without the offset column, and a validation
    frame without it, raise the JAX package's ValueError; a JAX model
    carried across with its offset_column predicts like JAX."""
    cols = _cols("poisson", seed=6)
    jm, jfr, tm, tfr = _train_both("poisson", True, cols=cols)
    bare = {k: v for k, v in cols.items() if k != "log_expo"}
    jbare = jh2o.Frame.from_numpy(bare)
    tbare = th2o.Frame.from_numpy(bare, device="cpu")
    with pytest.raises(ValueError) as je:
        jm.predict(jbare)
    with pytest.raises(ValueError) as te:
        tm.predict(tbare)
    assert str(te.value) == str(je.value)
    kw = dict(BASE, distribution="poisson", offset_column="log_expo")
    with pytest.raises(ValueError) as je:
        JaxGBM(packed_codes=True, **kw).train(y="y", training_frame=jfr,
                                              validation_frame=jbare)
    with pytest.raises(ValueError) as te:
        H2OGradientBoostingEstimator(**kw).train(
            y="y", training_frame=tfr, validation_frame=tbare)
    assert str(te.value) == str(je.value)
    meta = {"dist_name": jm.dist_name, "n_bins": jm.n_bins,
            "max_depth": jm.max_depth, "ntrees_built": jm.ntrees_built,
            "nclasses": jm.nclasses, "names": jm.feature_names,
            "response_domain": None, "offset_column": "log_expo"}
    carried = GBMModel.from_jax_arrays(jm._save_arrays(), meta,
                                       device="cpu")
    np.testing.assert_allclose(
        carried.predict(tfr).vec("predict").to_numpy(),
        jm.predict(jfr).vec("predict").to_numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="offset_column='log_expo'"):
        carried.predict(tbare)


def test_validation_offset_and_early_stopping_match_jax():
    """A validation frame with its own offset, scored every 2 trees on
    the deviance with early stopping: the same trees and history."""
    cols, vcols = _cols("poisson", seed=7), _cols("poisson", 5000, seed=8)
    kw = dict(BASE, ntrees=40, learn_rate=0.5, distribution="poisson",
              offset_column="log_expo", stopping_rounds=2,
              score_tree_interval=2, stopping_tolerance=0.01)
    jm = JaxGBM(packed_codes=True, **kw).train(
        y="y", training_frame=jh2o.Frame.from_numpy(cols),
        validation_frame=jh2o.Frame.from_numpy(vcols)).model
    tm = H2OGradientBoostingEstimator(**kw).train(
        y="y", training_frame=th2o.Frame.from_numpy(cols, device="cpu"),
        validation_frame=th2o.Frame.from_numpy(vcols, device="cpu")).model
    assert tm.ntrees_built == jm.ntrees_built < kw["ntrees"]
    assert [e["ntrees"] for e in tm.scoring_history] == \
        [e["ntrees"] for e in jm.scoring_history]
    for a, b in zip(jm.scoring_history, tm.scoring_history):
        assert set(a) == set(b)
        assert b["deviance"] == pytest.approx(a["deviance"], rel=1e-5)
    np.testing.assert_array_equal(tm.trees["feat"], np.asarray(jm._feat))
    assert tm.validation_metrics.mean_residual_deviance == pytest.approx(
        jm.validation_metrics.mean_residual_deviance, rel=1e-5)


def test_multinomial_with_offset_raises_like_jax():
    rng = np.random.default_rng(9)
    cols = {"a": rng.normal(size=600).astype(np.float32),
            "off": rng.normal(size=600).astype(np.float32),
            "y": np.array(["u", "v", "w"], dtype=object)[
                rng.integers(0, 3, 600)]}
    # the JAX job reports the train's NotImplementedError in a
    # RuntimeError; the port has no jobs and raises it as it is
    with pytest.raises(RuntimeError) as je:
        JaxGBM(ntrees=2, offset_column="off").train(
            y="y", training_frame=jh2o.Frame.from_numpy(cols))
    with pytest.raises(NotImplementedError) as te:
        H2OGradientBoostingEstimator(ntrees=2, offset_column="off").train(
            y="y", training_frame=th2o.Frame.from_numpy(cols, device="cpu"))
    assert str(te.value) == MULTINOMIAL_OFFSET
    assert f"NotImplementedError: {MULTINOMIAL_OFFSET}" in str(je.value)


def test_offset_model_refused_by_deploy_and_easypredict_ignores_it():
    """An offset-trained model cannot be deployed (rows carry no
    offset), and EasyPredict scores a row as if its offset were 0, as
    the JAX package's does (ROADMAP.md queue 3)."""
    cols = _cols("poisson", seed=10)
    tfr = th2o.Frame.from_numpy(cols, device="cpu")
    m = H2OGradientBoostingEstimator(
        **BASE, distribution="poisson", offset_column="log_expo").train(
            y="y", training_frame=tfr).model
    with pytest.raises(ValueError, match="offset-trained"):
        serve.deploy("offset_poisson", model=m, buckets=(1, 8), max_batch=8)
    row = {f"f{i}": float(np.nan_to_num(cols[f"f{i}"][0])) for i in range(F)}
    got = EasyPredictModelWrapper(m).predict_row(row)["value"]
    X = torch.tensor([[row[f"f{i}"] for i in range(F)]], dtype=torch.float32)
    assert got == float(m._predict_matrix(X)[0])
