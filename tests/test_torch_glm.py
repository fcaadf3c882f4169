"""The dense GLM of the port against the JAX package's
(``h2o3_tpu/models/glm.py``), on the CPU.

- Families, links and solvers: gaussian (identity by Cholesky IRLSM, log
  by coordinate descent), binomial (L-BFGS), quasibinomial,
  fractionalbinomial, poisson, gamma (inverse by Cholesky, log by
  L-BFGS), tweedie (variance power 1.5, link power 0) and
  negativebinomial, each trained by both packages on the same numpy
  draw: coefficients within atol 2e-4 + rtol 2e-4 (the JAX package's own
  tolerance against sklearn, tests/test_glm.py), null and residual
  deviance within rtol 1e-5, the training metrics within 5e-4 (relative,
  absolute near 0: IRLS stops within beta_epsilon = 1e-5 of its fixed
  point, where the two packages' rounding may stop it an iteration
  apart, and the inverse link amplifies that in the fitted means).
- The coordinate descent's plain version against the JAX package's
  ``_cd_elastic_net`` on the same Gram, masks and bounds: within atol
  1e-5 (XLA and torch round the matrix-vector product G·β₀ in another
  order; the sweeps then round alike).
- Lambda search: λ_max and the path's λ within rtol 1e-5, each
  submodel's deviance within rtol 1e-4 and its nonzero count equal (at
  λ_max itself, the boundary, 0 or 1 in either package), the
  best λ by validation deviance equal, ``max_active_predictors`` and
  ``cold_start``.
- ``expand_design`` and ``expand_scoring_matrix``: enums with NA, an
  unseen level at scoring, numerics with NA, ``interactions``,
  ``interaction_pairs`` and ``use_all_levels``: names equal, matrices
  within 1e-6 (the imputation means are float32 sums taken in another
  order).

3000 rows, four numeric columns with 3% NA cells and two enums (4 and 3
levels, 2% NA). The JAX trains run on a one-device mesh: on the suite's
eight virtual devices its Gram is a sum of padded shards."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu.models import glm as jglm
from h2o3_tpu.models.glm import H2OGeneralizedLinearEstimator as JaxGLM
from h2o3_tpu.models.model_base import build_training_spec as jax_spec
from h2o3_tpu.parallel.mesh import current_mesh, make_mesh, set_mesh
from h2o3_tpu_torch.estimators import H2OGeneralizedLinearEstimator
from h2o3_tpu_torch.models import glm as tglm
from h2o3_tpu_torch.models.model_base import build_training_spec
from h2o3_tpu_torch.ops import glm_cd
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

ROWS = 3000
COEF_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_jax_device():
    old = current_mesh()
    set_mesh(make_mesh(n_data=1, devices=jax.devices()[:1]))
    yield
    set_mesh(old)


def draw(rows=ROWS, seed=0):
    """Features and a linear predictor: x0..x3 normal with 3% NA, c1 of
    four levels and c2 of three, 2% NA each."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, 4)).astype(np.float32)
    X[rng.random(X.shape) < 0.03] = np.nan
    c1 = rng.choice(np.array(["a", "b", "c", "d"], dtype=object), rows)
    c2 = rng.choice(np.array(["u", "v", "w"], dtype=object), rows)
    c1[rng.random(rows) < 0.02] = None
    c2[rng.random(rows) < 0.02] = None
    Xz = np.nan_to_num(X)
    eta = (0.5 * Xz[:, 0] - 0.3 * Xz[:, 1] + 0.2 * Xz[:, 2]
           + 0.4 * (c1 == "b") - 0.3 * (c2 == "w"))
    cols = {f"x{i}": X[:, i] for i in range(4)}
    cols["c1"] = c1
    cols["c2"] = c2
    return cols, eta, rng


def response(family, eta, rng):
    n = eta.shape[0]
    if family == "gaussian":
        return (1.0 + eta + 0.5 * rng.normal(size=n)).astype(np.float32)
    if family == "gaussian_log":
        return np.exp(0.5 + 0.3 * eta + 0.1 * rng.normal(size=n)).astype(
            np.float32)
    if family in ("binomial", "quasibinomial"):
        y = (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(np.float32)
        if family == "binomial":
            return np.where(y > 0, "Y", "N").astype(object)
        return y
    if family == "fractionalbinomial":
        p = 1 / (1 + np.exp(-eta))
        return np.clip(p + 0.1 * rng.normal(size=n), 0, 1).astype(np.float32)
    if family in ("poisson", "negativebinomial"):
        return rng.poisson(np.exp(0.3 + 0.5 * eta)).astype(np.float32)
    if family == "gamma":
        return rng.gamma(2.0, np.exp(1.0 + 0.4 * eta) / 2.0).astype(
            np.float32)
    if family == "tweedie":
        return (rng.poisson(np.exp(0.2 + 0.5 * eta))
                * rng.gamma(2.0, 1.5, n)).astype(np.float32)
    raise ValueError(family)


# (case id, response draw, parameters): one solver a case
CASES = [
    ("gaussian-identity-irlsm", "gaussian", dict(family="gaussian")),
    ("gaussian-log-cd", "gaussian_log",
     dict(family="gaussian", link="log", alpha=0.5, Lambda=1e-3)),
    ("binomial-lbfgs", "binomial",
     dict(family="binomial", solver="L_BFGS", alpha=0.0, Lambda=1e-3)),
    ("quasibinomial-irlsm", "quasibinomial", dict(family="quasibinomial")),
    ("fractionalbinomial-cd", "fractionalbinomial",
     dict(family="fractionalbinomial", alpha=0.5, Lambda=1e-3)),
    ("poisson-cd", "poisson",
     dict(family="poisson", solver="COORDINATE_DESCENT", alpha=0.5,
          Lambda=1e-3)),
    ("gamma-inverse-irlsm", "gamma", dict(family="gamma")),
    ("gamma-log-lbfgs", "gamma",
     dict(family="gamma", link="log", solver="L_BFGS", alpha=0.0)),
    ("tweedie-irlsm", "tweedie",
     dict(family="tweedie", tweedie_variance_power=1.5,
          tweedie_link_power=0.0)),
    ("negativebinomial-irlsm", "poisson",
     dict(family="negativebinomial", theta=0.5)),
]


def frames(cols):
    return (jh2o.Frame.from_numpy(cols),
            th2o.Frame.from_numpy(cols, device="cpu"))


def train_both(cols, params, y="y", valid=None):
    jfr, tfr = frames(cols)
    jkw = tkw = {}
    if valid is not None:
        jv, tv = frames(valid)
        jkw, tkw = dict(validation_frame=jv), dict(validation_frame=tv)
    jm = JaxGLM(**params).train(y=y, training_frame=jfr, **jkw).model
    tm = H2OGeneralizedLinearEstimator(**params).train(
        y=y, training_frame=tfr, **tkw).model
    return jm, tm, jfr, tfr


def same_coef(jm, tm, **tol):
    jc, tc = jm.coef(), tm.coef()
    assert list(jc) == list(tc)
    np.testing.assert_allclose([tc[k] for k in tc], [jc[k] for k in jc],
                               **(tol or COEF_TOL))


def same_metrics(jmet, tmet, tol=5e-4):
    for k in ("mse", "rmse", "mae", "mean_residual_deviance", "auc",
              "logloss", "r2"):
        jv = getattr(jmet, k, None)
        if jv is None or not np.isfinite(jv):
            continue
        assert getattr(tmet, k) == pytest.approx(jv, rel=tol, abs=tol), k


@pytest.mark.parametrize("case,resp,params", CASES,
                         ids=[c[0] for c in CASES])
def test_family_link_solver_matches_jax(case, resp, params):
    cols, eta, rng = draw()
    cols["y"] = response(resp, eta, rng)
    jm, tm, _, _ = train_both(cols, params)
    assert tm.family == jm.family
    same_coef(jm, tm)
    assert tm.null_deviance == pytest.approx(jm.null_deviance, rel=1e-5)
    assert tm.residual_deviance == pytest.approx(jm.residual_deviance,
                                                 rel=1e-5)
    assert tm.rank == jm.rank and tm.nobs == jm.nobs
    assert tm.exp_names == jm.exp_names
    same_metrics(jm.training_metrics, tm.training_metrics)


def _gram_inputs(P=12, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(400, P)).astype(np.float32)
    w = rng.uniform(0.2, 1.5, 400).astype(np.float32)
    z = (X @ rng.normal(size=P) + rng.normal(size=400)).astype(np.float32)
    G = (X.T @ (X * w[:, None])).astype(np.float32)
    G = ((G + G.T) / 2).astype(np.float32)
    b = (X.T @ (w * z)).astype(np.float32)
    pen = np.ones(P, np.float32)
    pen[-1] = 0.0
    beta0 = (0.1 * rng.normal(size=P)).astype(np.float32)
    return G, b, beta0, pen


CD_CASES = {
    "elastic-net": dict(lam1=20.0, lam2=5.0),
    "non-negative": dict(lam1=8.0, lam2=1.0, non_negative=True),
    "nn-mask-box": dict(lam1=4.0, lam2=0.5, nn=[0, 3, 5],
                        box={1: (-0.05, 0.05), 2: (0.0, 0.2),
                             7: (-np.inf, -0.01)}),
}


@pytest.mark.parametrize("name", list(CD_CASES))
def test_cd_plain_matches_jax_cd(name):
    c = CD_CASES[name]
    G, b, beta0, pen = _gram_inputs()
    P = G.shape[0]
    nn = lo = hi = None
    if "nn" in c:
        nn = np.zeros(P, np.float32)
        nn[c["nn"]] = 1.0
    if "box" in c:
        lo = np.full(P, -np.inf, np.float32)
        hi = np.full(P, np.inf, np.float32)
        for j, (a, bb) in c["box"].items():
            lo[j], hi[j] = a, bb
    jb = jglm._cd_elastic_net(
        jnp.asarray(G), jnp.asarray(b), jnp.asarray(beta0),
        jnp.float32(c["lam1"]), jnp.float32(c["lam2"]), jnp.asarray(pen),
        n_sweeps=10, non_negative=c.get("non_negative", False),
        nn_mask=None if nn is None else jnp.asarray(nn),
        lo=None if lo is None else jnp.asarray(lo),
        hi=None if hi is None else jnp.asarray(hi))

    def t(a):
        return None if a is None else torch.as_tensor(a)
    args = (t(G), t(b), t(beta0), c["lam1"], c["lam2"], t(pen), 10)
    kw = dict(non_negative=c.get("non_negative", False), nn_mask=t(nn),
              lo=t(lo), hi=t(hi))
    got = glm_cd.cd_elastic_net_plain(*args, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(jb), rtol=0,
                               atol=1e-5)
    # the dispatcher sends a CPU tensor to the plain version
    assert torch.equal(glm_cd.cd_elastic_net(*args, **kw), got)
    if "box" in c:
        g = got.numpy()
        assert np.all(g >= lo - 1e-7) and np.all(g <= hi + 1e-7)
    if nn is not None:
        assert np.all(got.numpy()[nn > 0] >= 0)
    if c.get("non_negative"):
        assert np.all(got.numpy()[pen > 0] >= 0)


@pytest.fixture(scope="module")
def path_data():
    cols, eta, rng = draw(seed=5)
    cols["y"] = response("binomial", eta, rng)
    vcols, veta, vrng = draw(rows=1500, seed=6)
    vcols["y"] = response("binomial", veta, vrng)
    return cols, vcols


LAMBDA_CASES = {
    "validation": dict(),
    "max-active-cold-start": dict(max_active_predictors=4, cold_start=True),
}


@pytest.mark.parametrize("name", list(LAMBDA_CASES))
def test_lambda_search_matches_jax(path_data, name):
    cols, vcols = path_data
    params = dict(family="binomial", alpha=0.5, lambda_search=True,
                  nlambdas=8, lambda_min_ratio=1e-3,
                  **LAMBDA_CASES[name])
    jm, tm, _, _ = train_both(cols, params, valid=vcols)
    jp, tp = jm.output["lambda_path"], tm.output["lambda_path"]
    assert len(tp) == len(jp)
    if name == "max-active-cold-start":
        assert len(tp) < 8 and tp[-1]["nonzero"] > 4
    for i, (a, b) in enumerate(zip(tp, jp)):
        assert a["lambda"] == pytest.approx(b["lambda"], rel=1e-5)
        assert a["deviance"] == pytest.approx(b["deviance"], rel=1e-4)
        assert a["validation_deviance"] == pytest.approx(
            b["validation_deviance"], rel=1e-4)
        if i == 0:
            # λ_max is the boundary where the largest score's coefficient
            # is 0 up to rounding (|β| ~ 1e-8 here): 0 or 1 in either
            assert a["nonzero"] <= 1 and b["nonzero"] <= 1
        else:
            assert a["nonzero"] == b["nonzero"]
    assert tm.lambda_best == pytest.approx(jm.lambda_best, rel=1e-5)
    same_coef(jm, tm)
    same_metrics(jm.validation_metrics, tm.validation_metrics)


DESIGN_CASES = {
    "plain": dict(),
    "all-levels": dict(use_all_levels=True),
    "interactions": dict(interactions=["x0", "c1", "c2"]),
    "pairs": dict(interaction_pairs=[("x1", "x2"), ("c2", "x0")]),
}


@pytest.mark.parametrize("name", list(DESIGN_CASES))
def test_expand_design_matches_jax(name):
    kw = DESIGN_CASES[name]
    cols, eta, rng = draw(rows=500, seed=9)
    cols["y"] = eta.astype(np.float32)
    jfr, tfr = frames(cols)
    js = jax_spec(jfr, "y")
    ts = build_training_spec(tfr, "y")
    jX, jn, jmeans = jglm.expand_design(js, **kw)
    tX, tn, tmeans = tglm.expand_design(ts, **kw)
    assert tn == jn
    assert set(tmeans) == set(jmeans)
    for k in jmeans:
        assert tmeans[k] == pytest.approx(jmeans[k], abs=1e-6)
    np.testing.assert_allclose(tX.numpy(), np.asarray(jX)[:500], rtol=0,
                               atol=1e-6)
    # scoring: an unseen level and NA (both NaN codes after adaptation),
    # codes of every level, an NA plug level for c2
    Xs = np.array([[0.5, np.nan, 1.0, -2.0, np.nan, 1.0],
                   [np.nan, 2.0, np.nan, 0.0, 3.0, np.nan],
                   [1.0, 1.0, 1.0, 1.0, 0.0, 2.0],
                   [-1.0, 0.0, 0.5, np.nan, 2.0, 0.0]], np.float32)
    params = {"interactions": kw.get("interactions"),
              "interaction_pairs": kw.get("interaction_pairs")}
    model = SimpleNamespace(
        feature_names=ts.names, feature_is_cat=ts.is_cat,
        cat_domains=ts.cat_domains, impute_means=dict(jmeans),
        cat_plugs={"c2": 1}, params=params,
        use_all_levels=kw.get("use_all_levels", False))
    want = np.asarray(jglm.expand_scoring_matrix(model, jnp.asarray(Xs)))
    got = tglm.expand_scoring_matrix(model, torch.as_tensor(Xs))
    np.testing.assert_array_equal(got.numpy(), want)
