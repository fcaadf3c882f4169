"""The distribution families of the port against the JAX package's, on
the same inputs made from a seed with numpy: every family's init_f0,
grad_hess, predict and deviance (rtol 1e-6), the weighted quantile with
zero-weight rows, the offset-adjusted initial margin of each family, the
fixed-order row softmax against ``jax.nn.softmax``, and the registry of
custom families with its errors.

The weights are 1.0 (or 0.0): every cumulative weight is then an exact
float32 integer, so both packages' weighted quantiles pick the same
index whatever order their sums take."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.models import distributions as jd
from h2o3_tpu_torch.models import distributions as td
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

ROWS = 3000

FAMILIES = [("gaussian", {}), ("bernoulli", {}), ("poisson", {}),
            ("gamma", {}), ("tweedie", {"tweedie_power": 1.5}),
            ("tweedie", {"tweedie_power": 1.2}), ("laplace", {}),
            ("quantile", {"quantile_alpha": 0.9}),
            ("quantile", {"quantile_alpha": 0.5}),
            ("huber", {"huber_delta": 0.7})]
IDS = [f"{n}-{'-'.join(f'{v}' for v in kw.values())}" if kw else n
       for n, kw in FAMILIES]


def _inputs(name, seed=0):
    """(f, y, w): margins, a response in the family's domain, unit
    weights with 5% zeros."""
    rng = np.random.default_rng(seed)
    f = rng.normal(scale=0.8, size=ROWS).astype(np.float32)
    if name == "bernoulli":
        y = (rng.random(ROWS) < 0.3).astype(np.float32)
    elif name in ("poisson", "tweedie"):
        y = rng.poisson(0.8, size=ROWS).astype(np.float32)
        if name == "tweedie":
            y = (y * rng.gamma(2.0, 1.5, size=ROWS)).astype(np.float32)
    elif name == "gamma":
        y = rng.gamma(2.0, 1.5, size=ROWS).astype(np.float32)
    else:
        y = (rng.standard_t(3, size=ROWS) * 2.0 + 1.0).astype(np.float32)
    w = (rng.random(ROWS) >= 0.05).astype(np.float32)
    return f, y, w


def _both(name, kw):
    return (jd.get_distribution(name, **kw),
            td.get_distribution(name, **kw))


def _close(got, want, rtol=1e-6, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("name,kw", FAMILIES, ids=IDS)
def test_family_matches_jax(name, kw):
    """init_f0, grad_hess, predict and deviance of one family, within
    rtol 1e-6 (the exp, pow and log of the two packages may differ in
    the last bit; the sums add in their own orders)."""
    jdist, tdist = _both(name, kw)
    assert tdist.name == jdist.name == name
    f, y, w = _inputs(name)
    tf, ty, tw = (torch.from_numpy(a) for a in (f, y, w))
    jf, jy, jw = (jnp.asarray(a) for a in (f, y, w))
    _close(tdist.init_f0(ty, tw), jdist.init_f0(jy, jw))
    (tg, th), (jg, jh) = tdist.grad_hess(tf, ty), jdist.grad_hess(jf, jy)
    _close(tg, jg, atol=1e-6)
    _close(th, jh, atol=1e-6)
    _close(tdist.predict(tf), jdist.predict(jf))
    mu = tdist.predict(tf)
    _close(tdist.deviance(tw, ty, mu), jdist.deviance(jw, jy,
                                                      jnp.asarray(mu)))


@pytest.mark.parametrize("name,kw", FAMILIES, ids=IDS)
def test_offset_adjusted_f0_matches_jax(name, kw):
    """The offset-adjusted initial margin: the exact shift of the
    identity-link families, eight Newton steps from 0 for the others."""
    jdist, tdist = _both(name, kw)
    _f, y, w = _inputs(name, seed=1)
    rng = np.random.default_rng(2)
    off = np.log(rng.uniform(0.1, 1.0, ROWS)).astype(np.float32)
    got = td.offset_adjusted_f0(tdist, torch.from_numpy(y),
                                torch.from_numpy(w), torch.from_numpy(off))
    want = jd.offset_adjusted_f0(jdist, jnp.asarray(y), jnp.asarray(w),
                                 jnp.asarray(off))
    assert got.dtype == torch.float32
    _close(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 1.0])
def test_weighted_quantile_ignores_zero_weights(q):
    """The weighted quantile equals the JAX package's, and the rows of
    weight 0 (set to extreme values here) do not move it: it equals the
    quantile of the weighted rows alone. At q = 0 the target weight is
    0, which the first sorted row meets whatever its weight: both
    packages return the smallest y there."""
    rng = np.random.default_rng(3)
    y = rng.normal(size=ROWS).astype(np.float32)
    w = (rng.random(ROWS) >= 0.2).astype(np.float32)
    y[w == 0] = np.where(rng.random(int((w == 0).sum())) < 0.5, -50.0,
                         50.0)
    got = td.weighted_quantile(torch.from_numpy(y), torch.from_numpy(w), q)
    want = jd.weighted_quantile(jnp.asarray(y), jnp.asarray(w), q)
    assert float(got) == float(want)
    if q > 0:
        live = y[w > 0]
        alone = td.weighted_quantile(torch.from_numpy(live),
                                     torch.ones(live.shape[0]), q)
        assert float(got) == float(alone)
    assert float(td.weighted_median(torch.from_numpy(y),
                                    torch.from_numpy(w))) == float(
        jd.weighted_median(jnp.asarray(y), jnp.asarray(w)))


@pytest.mark.parametrize("K", [3, 4, 7])
def test_softmax_matches_jax_and_repeats_at_any_row_count(K):
    """The port's column softmax against ``jax.nn.softmax`` (atol 1e-6),
    and a row's bits the same whether it is scored alone or with the
    others."""
    rng = np.random.default_rng(K)
    f = (rng.normal(size=(257, K)) * 3).astype(np.float32)
    got = td.softmax(torch.from_numpy(f))
    want = np.asarray(jax.nn.softmax(jnp.asarray(f), axis=1))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.sum(dim=1).numpy(), 1.0, atol=1e-6)
    for i in (0, 100, 256):
        one = td.softmax(torch.from_numpy(f[i:i + 1]))
        assert torch.equal(one[0], got[i])


class _TorchPoisson(td.Distribution):
    name = "mypois"

    def init_f0(self, y, w):
        return torch.log(torch.clamp((w * y).sum() / w.sum(), min=1e-9))

    def grad_hess(self, f, y):
        mu = torch.exp(f)
        return mu - y, torch.clamp(mu, min=1e-9)

    def predict(self, f):
        return torch.exp(f)

    def deviance(self, w, y, mu):
        return td.Poisson().deviance(w, y, mu)


def test_custom_registry_and_errors():
    """``custom:<name>`` resolves a registered instance or class; an
    unregistered name and an unknown family raise the JAX package's
    ValueError texts; a Distribution instance or class passes through."""
    inst = _TorchPoisson()
    td.register_custom_distribution("MyPois", inst)
    try:
        assert td.get_distribution("custom:mypois") is inst
        assert td.get_distribution("CUSTOM:MyPois") is inst
        td.register_custom_distribution("cls", _TorchPoisson)
        assert isinstance(td.get_distribution("custom:cls"), _TorchPoisson)
        assert td.get_distribution(inst) is inst
        assert isinstance(td.get_distribution(_TorchPoisson), _TorchPoisson)
        for name in ("custom:nope", "poissonn", "multinomial"):
            with pytest.raises(ValueError) as te:
                td.get_distribution(name)
            with pytest.raises(ValueError) as je:
                jd.get_distribution(name)
            msg_t = str(te.value).split(";")[0]
            msg_j = str(je.value).split(";")[0]
            assert msg_t == msg_j, (msg_t, msg_j)
        with pytest.raises(ValueError, match="unknown distribution"):
            td.get_distribution("multinomial")
    finally:
        td._CUSTOM.pop("mypois", None)
        td._CUSTOM.pop("cls", None)
    assert set(td.SHIFT_INIT) == set(jd.SHIFT_INIT)
