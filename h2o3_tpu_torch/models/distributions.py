"""Distribution families: the Newton quantities (g = dL/df,
h = d2L/df2), the initial margin and the inverse link.

Counterpart of ``h2o3_tpu/models/distributions.py`` for the two families
of the GBM slice, gaussian and bernoulli; the others are queued in
ROADMAP.md.
"""
from __future__ import annotations

import torch


def sigmoid(f: torch.Tensor) -> torch.Tensor:
    """1 / (1 + exp(-f)), spelled as the JAX package spells it."""
    return 1.0 / (1.0 + torch.exp(-f))


class Distribution:
    name = "base"

    def init_f0(self, y, w):
        raise NotImplementedError

    def grad_hess(self, f, y):
        raise NotImplementedError

    def predict(self, f):
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


_FAMILIES = {"gaussian": Gaussian, "bernoulli": Bernoulli,
             "binomial": Bernoulli}


def get_distribution(name) -> Distribution:
    if isinstance(name, Distribution):
        return name
    name = (name or "gaussian").lower()
    if name in _FAMILIES:
        return _FAMILIES[name]()
    raise NotImplementedError(
        f"distribution '{name}' is not ported yet (ROADMAP.md, queue 1, "
        f"item A6: the other distributions); have {sorted(_FAMILIES)}")
