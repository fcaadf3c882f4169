"""Distribution families: the Newton quantities (g = dL/df,
h = d2L/df2), the initial margin and the inverse link.

Counterpart of ``h2o3_tpu/models/distributions.py``: gaussian,
bernoulli, poisson, gamma, tweedie, laplace, quantile, huber and the
registry of custom families, with the same clamps, plus the
offset-adjusted initial margin. The multinomial family has no class
here, as in the JAX package: the GBM's loop computes its softmax
gradients itself. ``softmax`` is the row softmax that loop, the metrics
and predict share.
"""
from __future__ import annotations

import torch

from h2o3_tpu_torch.models.metrics import _run_scan


def sigmoid(f: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-f)), spelled as the JAX package spells it."""
    return 1.0 / (1.0 + torch.exp(-f))


def softmax(f: torch.Tensor) -> torch.Tensor:
    """Row softmax of ``[rows, K]`` margins as ``jax.nn.softmax`` spells
    it (exp of the margin less the row's max, over the sum of the
    exps), written as K column operations in a fixed order: every op is
    elementwise, so a row's bits do not depend on how many rows there
    are (the serve contract) and no reduction kernel picks its order."""
    K = f.shape[1]
    m = f[:, 0]
    for k in range(1, K):
        m = torch.maximum(m, f[:, k])
    e = torch.exp(f - m[:, None])
    s = e[:, 0]
    for k in range(1, K):
        s = s + e[:, k]
    return e / s[:, None]


class Distribution:
    name = "base"

    def init_f0(self, y, w):
        raise NotImplementedError

    def grad_hess(self, f, y):
        """g, h with respect to the margin f."""
        raise NotImplementedError

    def predict(self, f):
        """The inverse link."""
        raise NotImplementedError

    def deviance(self, w, y, mu):
        raise NotImplementedError


class Gaussian(Distribution):
    name = "gaussian"

    def init_f0(self, y, w):
        return (w * y).sum() / w.sum()

    def grad_hess(self, f, y):
        return f - y, torch.ones_like(f)

    def predict(self, f):
        return f

    def deviance(self, w, y, mu):
        return (w * (y - mu) ** 2).sum() / w.sum()


class Bernoulli(Distribution):
    name = "bernoulli"

    def init_f0(self, y, w):
        p = torch.clamp((w * y).sum() / w.sum(), 1e-9, 1 - 1e-9)
        return torch.log(p / (1 - p))

    def grad_hess(self, f, y):
        p = sigmoid(f)
        return p - y, torch.clamp(p * (1 - p), min=1e-9)

    def predict(self, f):
        return sigmoid(f)

    def deviance(self, w, y, mu):
        eps = 1e-7  # f32-safe: 1-1e-15 rounds to 1.0f -> log1p(-1) = -inf
        mu = torch.clamp(mu, eps, 1 - eps)
        return -2.0 * (w * (y * torch.log(mu)
                            + (1 - y) * torch.log1p(-mu))).sum() / w.sum()


def _log_mean(y, w):
    return torch.log(torch.clamp((w * y).sum() / w.sum(), min=1e-9))


class Poisson(Distribution):
    name = "poisson"

    def init_f0(self, y, w):
        return _log_mean(y, w)

    def grad_hess(self, f, y):
        mu = torch.exp(f)
        return mu - y, torch.clamp(mu, min=1e-9)

    def predict(self, f):
        return torch.exp(f)

    def deviance(self, w, y, mu):
        yl = torch.where(y > 0, y * torch.log(y / torch.clamp(mu, min=1e-30)),
                         0.0)
        return 2.0 * (w * (yl - (y - mu))).sum() / w.sum()


class Gamma(Distribution):
    name = "gamma"

    def init_f0(self, y, w):
        return _log_mean(y, w)

    def grad_hess(self, f, y):
        # -L = y/mu + log(mu); d/df with mu = e^f: 1 - y e^-f; h = y e^-f
        return (1.0 - y * torch.exp(-f),
                torch.clamp(y * torch.exp(-f), min=1e-9))

    def predict(self, f):
        return torch.exp(f)

    def deviance(self, w, y, mu):
        r = y / torch.clamp(mu, min=1e-30)
        return 2.0 * (w * (-torch.log(torch.clamp(r, min=1e-30)) + r
                           - 1.0)).sum() / w.sum()


class Tweedie(Distribution):
    name = "tweedie"

    def __init__(self, power=1.5):
        self.p = power

    def init_f0(self, y, w):
        return _log_mean(y, w)

    def grad_hess(self, f, y):
        p = self.p
        g = torch.exp(f * (2 - p)) - y * torch.exp(f * (1 - p))
        h = ((2 - p) * torch.exp(f * (2 - p))
             - (1 - p) * y * torch.exp(f * (1 - p)))
        return g, torch.clamp(h, min=1e-9)

    def predict(self, f):
        return torch.exp(f)

    def deviance(self, w, y, mu):
        p = self.p
        mu = torch.clamp(mu, min=1e-30)
        a = torch.where(y > 0, y ** (2 - p) / ((1 - p) * (2 - p)), 0.0)
        b = y * mu ** (1 - p) / (1 - p)
        c = mu ** (2 - p) / (2 - p)
        return 2.0 * (w * (a - b + c)).sum() / w.sum()


def weighted_quantile(y, w, q):
    """Smallest y with cumulative weight >= q x the total weight.
    Zero-weight rows (NA responses) never move the result: their
    cumulative weight equals their predecessor's. The cumulative weight
    comes in a fixed order (``metrics._run_scan``), so the same inputs
    give the same bits on every device."""
    order = torch.argsort(y, stable=True)
    ys = y[order]
    cw = _run_scan(w[order][:, None])[:, 0]
    idx = torch.searchsorted(cw, (q * cw[-1]).reshape(1))
    return ys[torch.clamp(idx, max=ys.shape[0] - 1)][0]


def weighted_median(y, w):
    """The weighted median (the Laplace family's initial margin)."""
    return weighted_quantile(y, w, 0.5)


class Laplace(Distribution):
    name = "laplace"

    def init_f0(self, y, w):
        return weighted_median(y, w)

    def grad_hess(self, f, y):
        return torch.sign(f - y), torch.ones_like(f)

    def predict(self, f):
        return f

    def deviance(self, w, y, mu):
        return (w * torch.abs(y - mu)).sum() / w.sum()


class Quantile(Distribution):
    """Pinball loss at ``alpha`` (the GBM's quantile_alpha)."""
    name = "quantile"

    def __init__(self, alpha=0.5):
        self.alpha = alpha

    def init_f0(self, y, w):
        return weighted_quantile(y, w, self.alpha)

    def grad_hess(self, f, y):
        # dL/df of alpha (y - f)+ + (1 - alpha) (f - y)+
        g = torch.where(y > f, torch.full_like(f, -self.alpha),
                        torch.full_like(f, 1.0 - self.alpha))
        return g, torch.ones_like(f)

    def predict(self, f):
        return f

    def deviance(self, w, y, mu):
        r = y - mu
        loss = torch.where(r > 0, self.alpha * r, (self.alpha - 1.0) * r)
        return (w * loss).sum() / w.sum()


class Huber(Distribution):
    """Huber loss with a fixed transition point ``delta``, which the GBM
    computes once from the initial residuals (a float or a 0-d tensor on
    the rows' device)."""
    name = "huber"

    def __init__(self, delta=1.0):
        self.delta = delta

    def init_f0(self, y, w):
        return weighted_median(y, w)

    def grad_hess(self, f, y):
        d = self.delta
        return torch.clamp(f - y, -d, d), torch.ones_like(f)

    def predict(self, f):
        return f

    def deviance(self, w, y, mu):
        r = torch.abs(y - mu)
        d = self.delta
        loss = torch.where(r <= d, 0.5 * r ** 2, d * (r - 0.5 * d))
        return (w * loss).sum() / w.sum()


_FAMILIES = {
    "gaussian": Gaussian,
    "bernoulli": Bernoulli,
    "binomial": Bernoulli,
    "poisson": Poisson,
    "gamma": Gamma,
    "laplace": Laplace,
}

# user-defined families: register a Distribution subclass or instance
# under a name, then train with distribution="custom:<name>" (or pass the
# instance as the GBM's custom_distribution_func)
_CUSTOM: dict = {}


def register_custom_distribution(name: str, dist) -> None:
    """Register a user family: ``dist`` implements the Distribution
    contract (init_f0, grad_hess, predict, deviance) in torch."""
    _CUSTOM[name.lower()] = dist


def get_distribution(name, tweedie_power: float = 1.5,
                     quantile_alpha: float = 0.5,
                     huber_delta=1.0) -> Distribution:
    if isinstance(name, Distribution):
        return name
    if isinstance(name, type) and issubclass(name, Distribution):
        return name()
    name = (name or "gaussian").lower()
    if name.startswith("custom"):
        key = name.split(":", 1)[1] if ":" in name else name
        if key in _CUSTOM:
            d = _CUSTOM[key]
            return d() if isinstance(d, type) else d
        raise ValueError(
            f"custom distribution '{key}' is not registered "
            f"(register_custom_distribution); have {sorted(_CUSTOM)}")
    if name == "tweedie":
        return Tweedie(tweedie_power)
    if name == "quantile":
        return Quantile(quantile_alpha)
    if name == "huber":
        return Huber(huber_delta)
    if name in _FAMILIES:
        return _FAMILIES[name]()
    raise ValueError(
        f"unknown distribution '{name}'; have "
        f"{sorted(_FAMILIES) + ['tweedie', 'quantile', 'huber', 'multinomial']}")


# identity-link families, whose offset-adjusted initial margin is exactly
# the family's initial margin of (y - offset); Newton on these moves by at
# most max|g| a step (unit hessian) and cannot converge for large shifts
SHIFT_INIT = {"gaussian", "laplace", "quantile", "huber"}


def offset_adjusted_f0(dist: Distribution, y, w, offset, n_iter: int = 8):
    """The initial margin on the offset-adjusted scale: identity-link
    families shift exactly; the others solve sum w g(offset + f0, y) = 0
    by ``n_iter`` Newton steps from 0 (a fixed count, not a tolerance)."""
    if dist.name in SHIFT_INIT:
        return dist.init_f0(y - offset, w)
    f0 = torch.zeros((), dtype=torch.float32, device=y.device)
    for _ in range(n_iter):
        g, h = dist.grad_hess(offset + f0, y)
        f0 = f0 - (w * g).sum() / torch.clamp((w * h).sum(), min=1e-12)
    return f0
