"""GLM — generalized linear models with elastic-net regularization.

Counterpart of ``h2o3_tpu/models/glm.py``'s dense trainer: every family
and link of the JAX package (gaussian, binomial, quasibinomial,
fractionalbinomial, poisson, gamma, tweedie, negativebinomial), the three
solvers (Cholesky IRLSM, coordinate descent on the Gram, L-BFGS), lambda
search down a geometric path from λ_max, the multinomial (class-cyclic
IRLS) and ordinal (cumulative link, full-batch Adam) trainers, missing
values (mean imputation, skip, plug values), interactions, non-negative
and box constraints, a prior, offsets, weights and p-values.

Each IRLS step forms the weighted Gram G = Xᵀ(w∘X) and b = Xᵀ(w∘z) with
``torch.matmul`` over row blocks, then solves it by Cholesky
(``torch.linalg``) or by coordinate descent: ``ops/glm_cd.py``, whose
CUDA kernel (``csrc/glm_cd.cu``) runs a whole solve in one thread block
on the card. The JAX package leaves the products and the factorization to
XLA and runs the descent as a ``lax.fori_loop`` on the device; eager
torch would spend some eighty thousand launches on one such solve at the
airlines width, hence the kernel. L-BFGS and the ordinal's Adam take
their gradients from ``torch.autograd``.

Memory: the design is one preallocated [rows, Fe (+1 intercept)] float32
tensor, the enum indicator blocks written by one scatter each and the
numeric columns by one indexed copy, standardized in place; the Gram's
weighted rows are a temporary of one row block. Predict expands a block
of rows at a time. Every float32 product runs in full float32 whatever
the caller set for TF32 (``full_fp32``). Predict sums each row's
products in one fixed order (``dot_fixed``), so that a row scores the
same bits alone, in a served batch or in a frame.

On a mesh of several shards the GLM trains on the frame's device: the
JAX package's row-sharded Gram is the same sum, in another order. The
streamed GLM (a frame past the device budget), HGLM and the GLM on a mesh
with its sharded wide L-BFGS are ROADMAP.md queue 1, item 15b: the first
two raise ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from dataclasses import replace
from typing import Dict, List, Optional

import numpy as np
import torch

from h2o3_tpu_torch import _device
from h2o3_tpu_torch.models.model_base import (BALANCE_DEFAULTS,
                                              BUILDER_PARAMS, Model,
                                              ModelBuilder, TrainingSpec,
                                              compute_metrics,
                                              pack_impute_means,
                                              unpack_impute_means)
from h2o3_tpu_torch.ops.glm_cd import cd_elastic_net
from h2o3_tpu_torch.persist import register_model_class


def _max_iter_of(p, default=50) -> int:
    """max_iterations <= 0 means AUTO in the reference clients (h2o-py
    sends -1): the default instead of a zero-length loop."""
    v = int(p.get("max_iterations", default) or default)
    return v if v > 0 else default


GLM_DEFAULTS: Dict = dict(
    family="auto", solver="auto", alpha=None, Lambda=None,
    lambda_search=False, nlambdas=30, lambda_min_ratio=1e-4,
    standardize=True, intercept=True, max_iterations=50,
    beta_epsilon=1e-5, gradient_epsilon=1e-6, link="family_default",
    seed=-1, tweedie_power=1.5, non_negative=False,
    tweedie_variance_power=0.0, tweedie_link_power=1.0,
    missing_values_handling="mean_imputation",
    theta=1e-10, beta_constraints=None, interactions=None,
    interaction_pairs=None, plug_values=None,
    startval=None, cold_start=False, prior=-1.0,
    max_active_predictors=-1,
    compute_p_values=False,
    HGLM=False, random_columns=None, rand_family=None, rand_link=None,
)

# the reference's GLM parameters that the JAX package accepts for API
# compatibility and does not act on (h2o3_tpu/models/compat_params.py):
# merged into every estimator's parameters; train() warns for each one
# set away from its default
GLM_COMPAT_PARAMS: Dict = dict(
    checkpoint=None, score_iteration_interval=-1, early_stopping=True,
    dispersion_parameter_method="pearson", init_dispersion_parameter=1.0,
    remove_collinear_columns=False, objective_epsilon=-1.0,
    calc_like=False, obj_reg=-1.0, stopping_rounds=0,
    stopping_metric="auto", stopping_tolerance=0.001,
    max_confusion_matrix_size=20, generate_scoring_history=False,
    dispersion_epsilon=0.0001, tweedie_epsilon=8e-17,
    max_iterations_dispersion=3000, build_null_model=False,
    fix_dispersion_parameter=False,
    generate_variable_inflation_factors=False,
    fix_tweedie_variance_power=True, dispersion_learning_rate=0.5,
    influence=None,
)

# read by the JAX trainer through params.get, outside its defaults
_EXTRA_PARAMS = {"non_negative_columns"}

ITEM_15B = "ROADMAP.md queue 1, item 15b"

# rows of a block: the Gram's weighted rows and predict's expanded rows
# hold at most this many float32 elements at a time
BLOCK_ELEMS = 1 << 28
PREDICT_BLOCK_ELEMS = 1 << 26


@contextlib.contextmanager
def full_fp32():
    """float32 matrix products in full float32 inside, whatever the
    caller set for TF32 (``allow_tf32``, the matmul precision): TF32
    keeps ten mantissa bits of the Gram's inputs. Restored after, through
    the API the installed torch keeps (``fp32_precision`` where it has
    one, else ``allow_tf32`` and the matmul precision)."""
    mm = torch.backends.cuda.matmul
    if hasattr(mm, "fp32_precision"):
        old = mm.fp32_precision
        mm.fp32_precision = "ieee"
        try:
            yield
        finally:
            mm.fp32_precision = old
        return
    prec = torch.get_float32_matmul_precision()
    tf32 = mm.allow_tf32
    torch.set_float32_matmul_precision("highest")
    mm.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prec)
        mm.allow_tf32 = tf32


def _rows_per_block(ncols: int, elems: int = BLOCK_ELEMS) -> int:
    return max(1, elems // max(ncols, 1))


class _Profile:
    """Wall seconds of a train's stages (``output["train_profile"]``),
    each ended by a synchronize on the card."""

    def __init__(self, device):
        self.device = device
        self.t = time.perf_counter()
        self.laps: Dict[str, float] = {}

    def lap(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.laps[name] = self.laps.get(name, 0.0) + now - self.t
        self.t = now


# ---------------- link functions --------------------------------------

class _IdentityLink:
    name = "identity"

    def link(self, mu):
        return mu

    def linkinv(self, eta):
        return eta

    def mu_eta(self, eta):
        """dμ/dη at eta."""
        return torch.ones_like(eta)


class _LogLink(_IdentityLink):
    name = "log"

    def link(self, mu):
        return torch.log(torch.clamp(mu, min=1e-10))

    def linkinv(self, eta):
        return torch.exp(torch.clamp(eta, -30, 30))

    def mu_eta(self, eta):
        return self.linkinv(eta)


class _LogitLink(_IdentityLink):
    name = "logit"

    def link(self, mu):
        mu = torch.clamp(mu, 1e-7, 1 - 1e-7)
        return torch.log(mu / (1.0 - mu))

    def linkinv(self, eta):
        return 1.0 / (1.0 + torch.exp(-eta))

    def mu_eta(self, eta):
        mu = self.linkinv(eta)
        return torch.clamp(mu * (1 - mu), min=1e-10)


class _InverseLink(_IdentityLink):
    """η = 1/μ (the gamma canonical link)."""
    name = "inverse"

    @staticmethod
    def _safe(x):
        return torch.where(torch.abs(x) < 1e-10,
                           torch.where(x < 0, -1e-10, 1e-10), x)

    def link(self, mu):
        return 1.0 / self._safe(mu)

    def linkinv(self, eta):
        return 1.0 / self._safe(eta)

    def mu_eta(self, eta):
        e = self._safe(eta)
        return -1.0 / (e * e)


class _TweedieLink(_IdentityLink):
    """Power link η = μ^q with q = tweedie_link_power; q = 0 is log."""
    name = "tweedie"

    def __init__(self, link_power: float = 1.0):
        self.q = float(link_power)

    def link(self, mu):
        if self.q == 0.0:
            return torch.log(torch.clamp(mu, min=1e-10))
        return torch.pow(torch.clamp(mu, min=1e-10), self.q)

    def linkinv(self, eta):
        if self.q == 0.0:
            return torch.exp(torch.clamp(eta, -30, 30))
        return torch.pow(torch.clamp(eta, min=1e-10), 1.0 / self.q)

    def mu_eta(self, eta):
        if self.q == 0.0:
            return self.linkinv(eta)
        e = torch.clamp(eta, min=1e-10)
        d = (1.0 / self.q) * torch.pow(e, 1.0 / self.q - 1.0)
        # below the clamp μ is pinned at the floor: dμ/dη = 0 drops those
        # rows from the working least squares
        return torch.where(eta > 1e-10, d, 0.0)


_LINKS = {"identity": _IdentityLink, "log": _LogLink, "logit": _LogitLink,
          "inverse": _InverseLink, "tweedie": _TweedieLink}


def _ordinal_cdf_fns(link: str):
    """Cumulative-link pair (cdf, inverse cdf) of the ordinal family:
    ologit, oprobit or ologlog."""
    link = (link or "family_default").lower()
    if link in ("family_default", "", "ologit"):
        return torch.sigmoid, lambda c: torch.log(c / (1.0 - c))
    if link == "oprobit":
        return torch.special.ndtr, torch.special.ndtri
    if link == "ologlog":
        return (lambda z: 1.0 - torch.exp(-torch.exp(torch.clamp(z, -30, 3))),
                lambda c: torch.log(-torch.log(1.0 - c)))
    raise ValueError(
        "Incompatible link function for selected family. Only ologit, "
        f"oprobit or ologlog links allowed for family=ordinal. Got {link}")


# ---------------- families --------------------------------------------

class _Family:
    name = "gaussian"
    default_link = "identity"
    valid_links = ("identity", "log", "inverse")

    def __init__(self, link=None):
        if link is None or isinstance(link, str):
            link = _LINKS[link or self.default_link]()
        self._link = link

    @property
    def link_name(self):
        return self._link.name

    def link(self, mu):
        return self._link.link(mu)

    def linkinv(self, eta):
        return self._link.linkinv(eta)

    def mu_eta(self, eta):
        return self._link.mu_eta(eta)

    def variance(self, mu):
        return torch.ones_like(mu)

    def clamp_mu(self, mu):
        """μ projected back into the response domain."""
        return mu

    def deviance(self, w, y, mu):
        return (w * (y - mu) ** 2).sum()

    def init_mu(self, y, w):
        return (w * y).sum() / w.sum()


class _PositiveFamily(_Family):
    """μ > 0 response domain (poisson, gamma, negativebinomial, tweedie)."""

    def clamp_mu(self, mu):
        return torch.clamp(mu, min=1e-6)


class _Gaussian(_Family):
    name = "gaussian"


class _Binomial(_Family):
    name = "binomial"
    default_link = "logit"
    valid_links = ("logit",)

    def clamp_mu(self, mu):
        return torch.clamp(mu, 1e-7, 1 - 1e-7)

    def variance(self, mu):
        return torch.clamp(mu * (1 - mu), min=1e-10)

    def deviance(self, w, y, mu):
        mu = torch.clamp(mu, 1e-7, 1 - 1e-7)
        return -2.0 * (w * (y * torch.log(mu)
                            + (1 - y) * torch.log1p(-mu))).sum()

    def init_mu(self, y, w):
        return torch.clamp((w * y).sum() / w.sum(), 1e-4, 1 - 1e-4)


class _Poisson(_PositiveFamily):
    name = "poisson"
    default_link = "log"
    valid_links = ("log", "identity")

    def variance(self, mu):
        return torch.clamp(mu, min=1e-10)

    def deviance(self, w, y, mu):
        mu = torch.clamp(mu, min=1e-10)
        yl = torch.where(y > 0, y * torch.log(y / mu), 0.0)
        return 2.0 * (w * (yl - (y - mu))).sum()

    def init_mu(self, y, w):
        return torch.clamp((w * y).sum() / w.sum(), min=1e-4)


class _Gamma(_PositiveFamily):
    name = "gamma"
    default_link = "inverse"
    valid_links = ("inverse", "log", "identity")

    def variance(self, mu):
        return torch.clamp(mu * mu, min=1e-10)

    def deviance(self, w, y, mu):
        mu = torch.clamp(mu, min=1e-10)
        r = torch.clamp(y, min=1e-10) / mu
        return 2.0 * (w * (-torch.log(r) + r - 1.0)).sum()

    def init_mu(self, y, w):
        return torch.clamp((w * y).sum() / w.sum(), min=1e-4)


class _Quasibinomial(_Binomial):
    """The binomial working model on a numeric response not restricted
    to {0, 1}."""
    name = "quasibinomial"


class _FractionalBinomial(_Binomial):
    """Fractional logit: y in [0, 1] under the binomial likelihood."""
    name = "fractionalbinomial"


class _NegativeBinomial(_PositiveFamily):
    """Var(μ) = μ + θμ², log link."""
    name = "negativebinomial"
    default_link = "log"
    valid_links = ("log", "identity")

    def __init__(self, theta: float = 1.0, link=None):
        super().__init__(link)
        self.theta = max(float(theta), 1e-10)

    def variance(self, mu):
        return torch.clamp(mu + self.theta * mu * mu, min=1e-10)

    def deviance(self, w, y, mu):
        t = self.theta
        mu = torch.clamp(mu, min=1e-10)
        yl = torch.where(y > 0, y * torch.log(torch.clamp(y, min=1e-10) / mu),
                         0.0)
        tail = (y + 1.0 / t) * torch.log((1.0 + t * y) / (1.0 + t * mu))
        return 2.0 * (w * (yl - tail)).sum()

    def init_mu(self, y, w):
        return torch.clamp((w * y).sum() / w.sum(), min=1e-4)


class _Tweedie(_PositiveFamily):
    """Var(μ) = φ·μ^p, p = tweedie_variance_power, with the power link
    (tweedie_link_power); the unit deviance with its p = 0, 1, 2 cases."""
    name = "tweedie"
    default_link = "tweedie"
    valid_links = ("tweedie",)

    def __init__(self, var_power: float = 0.0, link_power: float = 1.0,
                 link=None):
        super().__init__(link if link is not None
                         else _TweedieLink(link_power))
        self.p = float(var_power)

    def variance(self, mu):
        return torch.clamp(torch.pow(torch.clamp(mu, min=1e-10), self.p),
                           min=1e-10)

    def deviance(self, w, y, mu):
        p = self.p
        mu = torch.clamp(mu, min=1e-10)
        if p == 0.0:
            return (w * (y - mu) ** 2).sum()
        if p == 1.0:
            yl = torch.where(y > 0,
                             y * torch.log(torch.clamp(y, min=1e-10) / mu),
                             0.0)
            return 2.0 * (w * (yl - (y - mu))).sum()
        if p == 2.0:
            r = torch.clamp(y, min=1e-10) / mu
            return 2.0 * (w * (-torch.log(r) + r - 1.0)).sum()
        yp = torch.pow(torch.clamp(y, min=0.0), 2.0 - p)
        term = (yp / ((1.0 - p) * (2.0 - p))
                - y * torch.pow(mu, 1.0 - p) / (1.0 - p)
                + torch.pow(mu, 2.0 - p) / (2.0 - p))
        return 2.0 * (w * term).sum()

    def init_mu(self, y, w):
        return torch.clamp((w * y).sum() / w.sum(), min=1e-4)


_FAMILIES = {"gaussian": _Gaussian, "binomial": _Binomial,
             "poisson": _Poisson, "gamma": _Gamma,
             "quasibinomial": _Quasibinomial,
             "fractionalbinomial": _FractionalBinomial,
             "negativebinomial": _NegativeBinomial,
             "tweedie": _Tweedie}

# family -> the link at which plain (unguarded) IRLS is monotone-safe and
# L-BFGS's closed-form objectives are written; other links (and tweedie)
# take the merit-guarded halving and never L-BFGS
_PLAIN_IRLS_LINK = {"gaussian": "identity", "binomial": "logit",
                    "quasibinomial": "logit",
                    "fractionalbinomial": "logit", "poisson": "log",
                    "gamma": "log", "negativebinomial": "log"}


def _make_family(family: str, p: Dict) -> _Family:
    """The family with its validated link from the builder's parameters
    (the reference's family/link matrix)."""
    link = (p.get("link") or "family_default").lower()
    cls = _FAMILIES[family]
    if link not in ("family_default", "") and link not in cls.valid_links:
        raise ValueError(
            f"Incompatible link function for selected family. Only "
            f"{'/'.join(cls.valid_links)} allowed for family={family}. "
            f"Got {link}")
    if family == "tweedie":
        # 0.0 is a meaningful link power (log): no `or` defaulting
        twv = p.get("tweedie_variance_power")
        twl = p.get("tweedie_link_power")
        return _Tweedie(0.0 if twv is None else float(twv),
                        1.0 if twl is None else float(twl))
    if family == "negativebinomial":
        return _NegativeBinomial(
            float(p.get("theta", 1.0) or 1.0),
            link=None if link in ("family_default", "") else link)
    return cls(link=None if link in ("family_default", "") else link)


# ---------------- products and solves -----------------------------------

def gram(Xs: torch.Tensor, w_irls: torch.Tensor, z: torch.Tensor):
    """G = Xᵀ(w∘X) [P, P] and b = Xᵀ(w∘z) [P], summed over row blocks of
    ``BLOCK_ELEMS`` elements: the weighted rows are a temporary of one
    block."""
    n, P = Xs.shape
    step = _rows_per_block(P)
    G = torch.zeros((P, P), dtype=torch.float32, device=Xs.device)
    b = torch.zeros(P, dtype=torch.float32, device=Xs.device)
    for s in range(0, n, step):
        Xb = Xs[s:s + step]
        Xw = Xb * w_irls[s:s + step, None]
        G += Xb.t() @ Xw
        b += Xw.t() @ z[s:s + step]
    return G, b


def cholesky_solve(G, b, lam_l2: float, pen_mask):
    """The ridge (or unpenalized) exact solve. A Gram that does not
    factor (p > n unpenalized, collinear columns) retries with a
    trace-scaled diagonal, as the JAX package does."""
    A = G + torch.diag(lam_l2 * pen_mask + 1e-8)

    def solve(M):
        L, info = torch.linalg.cholesky_ex(M)
        x = torch.cholesky_solve(b[:, None], L)[:, 0]
        return x, bool(((info == 0) & torch.isfinite(x).all()).item())

    x, ok = solve(A)
    if ok:
        return x
    jitter = 1e-6 * torch.trace(G) + 1e-8
    x, ok = solve(A + jitter * torch.eye(G.shape[0], device=G.device))
    return x if ok else torch.full_like(x, float("nan"))


def lbfgs_minimize(f_fn, beta0: torch.Tensor, max_iter: int = 200,
                   tol: float = 1e-7, m: int = 10):
    """L-BFGS (two-loop recursion, Armijo backtracking of at most 24
    halvings, steepest descent where the direction does not descend, a
    ring of ``m`` pairs) on ``f_fn``, a scalar function of the
    coefficients; gradients by ``torch.autograd``. Returns (beta, f,
    iterations)."""
    P = beta0.shape[0]
    dev = beta0.device

    def value_and_grad(bs):
        bs = bs.detach().requires_grad_(True)
        with torch.enable_grad():
            f = f_fn(bs)
            g, = torch.autograd.grad(f, bs)
        return f.detach(), g

    def two_loop(g, S, Y, rho, k):
        q = g
        alphas = [None] * m
        valid = min(k, m)
        for i in range(valid):
            idx = (k - 1 - i) % m
            a = rho[idx] * (S[idx] @ q)
            q = q - a * Y[idx]
            alphas[i] = a
        il = (k - 1) % m
        if k > 0:
            gamma = (S[il] @ Y[il]) / torch.clamp(Y[il] @ Y[il], min=1e-20)
        else:
            gamma = torch.ones((), device=dev)
        r = torch.clamp(gamma, min=1e-8) * q
        for i in range(m):
            j = m - 1 - i
            if j >= valid:
                continue
            idx = (k - 1 - j) % m
            bb = rho[idx] * (Y[idx] @ r)
            r = r + S[idx] * (alphas[j] - bb)
        return r

    def linesearch(beta, f, g, d):
        gtd = g @ d
        t = 1.0
        for _ in range(24):
            fn2 = f_fn(beta + t * d)
            if bool((fn2 <= f + 1e-4 * t * gtd).item()):
                return t
            t *= 0.5
        return 0.0

    beta = beta0
    f, g = value_and_grad(beta)
    S = torch.zeros((m, P), dtype=torch.float32, device=dev)
    Y = torch.zeros((m, P), dtype=torch.float32, device=dev)
    rho = torch.zeros(m, dtype=torch.float32, device=dev)
    k = 0
    it = 0
    while it < max_iter:
        d = -two_loop(g, S, Y, rho, k)
        if not bool((g @ d < 0).item()):
            d = -g
        t = linesearch(beta, f, g, d)
        beta2 = beta + t * d
        f2, g2 = value_and_grad(beta2)
        s = beta2 - beta
        yv = g2 - g
        sy = s @ yv
        if bool((sy > 1e-12).item()):
            idx = k % m
            S[idx] = s
            Y[idx] = yv
            rho[idx] = 1.0 / torch.clamp(sy, min=1e-20)
            k += 1
        it += 1
        beta, f, g = beta2, f2, g2
        if t == 0.0 or bool((torch.max(torch.abs(g2)) < tol).item()):
            break
    return beta, f, it


def dot_fixed(Xe: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Xe @ B ([n, P] by [P] or [P, K]) with each row's sum in one fixed
    order whatever the row count: the products padded with zeros to a
    power of two and halved pairwise, elementwise. A row then scores the
    same bits alone as in any batch (served rows equal predict's)."""
    n, P = Xe.shape
    prod = Xe * B if B.dim() == 1 else Xe[:, :, None] * B[None]
    if P == 0:
        return prod.sum(1)
    P2 = 1 << (P - 1).bit_length()
    if P2 != P:
        pad = torch.zeros((n, P2 - P) + tuple(prod.shape[2:]),
                          dtype=prod.dtype, device=prod.device)
        prod = torch.cat([prod, pad], dim=1)
    while prod.shape[1] > 1:
        h = prod.shape[1] // 2
        prod = prod[:, :h] + prod[:, h:]
    return prod[:, 0]


# ---------------- the expanded design -----------------------------------

class DesignPlan:
    """The expanded design of a feature list (DataInfo): enum columns as
    indicator blocks (every level but the first, unless
    ``use_all_levels``), numerics mean-imputed, then the pairwise
    interaction terms of ``interactions`` (all pairs) or
    ``interaction_pairs``: num×num one product, cat×num a level's
    indicator times the value, cat×cat the indicator products. Column
    order and names (``col.level``, ``a_b``) are the JAX package's.
    ``cat_plugs`` maps an enum to the level code its NA takes."""

    def __init__(self, names, is_cat, cat_domains, means, first: int,
                 cards=None, interactions=None, pairs=None, cat_plugs=None):
        names = list(names)
        self.means = {k: float(v) for k, v in means.items()}
        self.cat_plugs = dict(cat_plugs or {})
        self.first = first
        self.names: List[str] = []
        self.num_idx, self.num_pos, self.enums = [], [], []
        col = 0
        for i, (n, cat) in enumerate(zip(names, is_cat)):
            if cat:
                card = (cards or {}).get(n, len(cat_domains.get(n) or ()))
                dom = cat_domains.get(n) or tuple(str(k)
                                                  for k in range(card))
                nlev = max(card - first, 0)
                self.enums.append((i, col, nlev,
                                   float(self.cat_plugs.get(n, -1))))
                self.names += [f"{n}.{dom[lvl]}"
                               for lvl in range(first, card)]
                col += nlev
            else:
                self.num_idx.append(i)
                self.num_pos.append(col)
                self.names.append(n)
                col += 1
        # interaction columns: (factor a, factor b), a factor being
        # ("cat", feature, level, NA code) or ("num", feature, mean)
        self.inter = []

        def factors(n):
            i = names.index(n)
            if is_cat[i]:
                card = (cards or {}).get(n, len(cat_domains.get(n) or ()))
                dom = cat_domains.get(n) or ()
                na = float(self.cat_plugs.get(n, -1))
                return [(("cat", i, lvl, na), f"{n}.{dom[lvl]}")
                        for lvl in range(first, card)]
            return [(("num", i, self.means.get(n, 0.0)), n)]

        pair_iter = ([tuple(pr) for pr in pairs] if pairs
                     else itertools.combinations(interactions or (), 2))
        for a, b in pair_iter:
            if a not in names or b not in names:
                raise ValueError(
                    f"interactions column '{a if a not in names else b}'"
                    f" is not a training feature")
            for fa, na in factors(a):
                for fb, nb in factors(b):
                    self.inter.append((fa, fb))
                    self.names.append(f"{na}_{nb}")
        self.Fe = len(self.names)
        self._means_host = np.asarray(
            [self.means.get(names[i], 0.0) for i in self.num_idx],
            np.float32)
        self._dev: Dict[torch.device, tuple] = {}

    def _tensors(self, device):
        """The numeric means and positions on ``device``, made once (so
        that a captured predict copies nothing from the host)."""
        t = self._dev.get(device)
        if t is None:
            t = (torch.as_tensor(self._means_host, device=device),
                 torch.as_tensor(self.num_idx, dtype=torch.long,
                                 device=device),
                 torch.as_tensor(self.num_pos, dtype=torch.long,
                                 device=device))
            self._dev[device] = t
        return t

    @staticmethod
    def _codes(x, na: float):
        return torch.where(torch.isnan(x), na, x).to(torch.long)

    def fill(self, X: torch.Tensor, extra: int = 0,
             out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The design of X ([n, F] float32, NaN = NA, enum codes as
        floats) in ``out`` or a new [n, Fe + extra] tensor (the extra
        columns left 0)."""
        n = X.shape[0]
        if out is None:
            out = torch.zeros((n, self.Fe + extra), dtype=torch.float32,
                              device=X.device)
        else:
            out.zero_()
        if self.num_idx:
            means, idx, pos = self._tensors(X.device)
            Xn = X[:, idx]
            out.index_copy_(1, pos, torch.where(torch.isnan(Xn), means, Xn))
        for i, start, nlev, na in self.enums:
            if nlev == 0:
                continue
            c = self._codes(X[:, i], na) - self.first
            ok = (c >= 0) & (c < nlev)
            out[:, start:start + nlev].scatter_(
                1, torch.where(ok, c, 0)[:, None],
                ok.to(torch.float32)[:, None])
        base = self.Fe - len(self.inter)
        for k, (fa, fb) in enumerate(self.inter):
            out[:, base + k] = self._factor(X, fa) * self._factor(X, fb)
        return out

    def _factor(self, X, f):
        x = X[:, f[1]]
        if f[0] == "cat":
            return (self._codes(x, f[3]) == f[2]).to(torch.float32)
        return torch.where(torch.isnan(x), f[2], x)


def _training_means(spec: TrainingSpec) -> Dict[str, float]:
    """Each numeric feature's weighted mean over its non-NA rows, read to
    the host in one copy (float32 values)."""
    num_idx = [i for i, c in enumerate(spec.is_cat) if not c]
    if not num_idx:
        return {}
    Xn = spec.X[:, torch.as_tensor(num_idx, device=spec.X.device)]
    nan = torch.isnan(Xn)
    msum = spec.w @ torch.where(nan, 0.0, Xn)
    mcnt = torch.clamp(spec.w @ (~nan).to(torch.float32), min=1e-12)
    mh = (msum / mcnt).cpu().numpy().astype(np.float32)
    return {spec.names[i]: float(mh[j]) for j, i in enumerate(num_idx)}


def _enum_cards(spec: TrainingSpec) -> Dict[str, int]:
    """Enum features without a domain: the largest code + 1."""
    out = {}
    for i, (n, cat) in enumerate(zip(spec.names, spec.is_cat)):
        if cat and not spec.cat_domains.get(n):
            x = spec.X[:, i]
            out[n] = int(torch.max(torch.where(torch.isnan(x), 0.0, x))) + 1
    return out


def expand_design(spec: TrainingSpec, impute_means=None,
                  use_all_levels: bool = False, interactions=None,
                  interaction_pairs=None, extra_cols: int = 0):
    """DataInfo: the expanded design of a spec (``DesignPlan``), numerics
    imputed with the spec's weighted means unless ``impute_means`` is
    given. Returns (Xe [rows, Fe + extra_cols], names, means)."""
    means = (_training_means(spec) if impute_means is None
             else impute_means)
    plan = DesignPlan(spec.names, spec.is_cat, spec.cat_domains, means,
                      0 if use_all_levels else 1, cards=_enum_cards(spec),
                      interactions=interactions, pairs=interaction_pairs)
    return plan.fill(spec.X, extra=extra_cols), plan.names, means


def expand_scoring_matrix(model, X: torch.Tensor) -> torch.Tensor:
    """A scoring matrix (``adapt_test_matrix``'s) expanded with a model's
    training design: its enum blocks, impute means, NA plug levels and
    interactions. Any model carrying feature_names, feature_is_cat,
    cat_domains and impute_means (optionally cat_plugs, use_all_levels
    and params' interactions)."""
    return scoring_plan(model).fill(X)


def scoring_plan(model) -> DesignPlan:
    """The model's scoring design, cached on the model while its impute
    means, plugs and interactions stay as they are."""
    mp = getattr(model, "params", None) or {}
    cat_plugs = getattr(model, "cat_plugs", None) or {}
    key = (tuple(sorted(model.impute_means.items())),
           tuple(sorted(cat_plugs.items())),
           repr(mp.get("interactions")), repr(mp.get("interaction_pairs")))
    cached = getattr(model, "_plan_cache", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    plan = DesignPlan(model.feature_names, model.feature_is_cat,
                      model.cat_domains, model.impute_means,
                      0 if getattr(model, "use_all_levels", False) else 1,
                      interactions=mp.get("interactions"),
                      pairs=mp.get("interaction_pairs"),
                      cat_plugs=cat_plugs)
    model._plan_cache = (key, plan)
    return plan


def _parse_beta_constraints(bc):
    """The reference's beta_constraints shapes: a Frame with names /
    lower_bounds / upper_bounds columns, a list of such dicts, or a
    {name: (lo, hi)} mapping. Returns [(name, lo, hi), ...]."""
    out = []
    if hasattr(bc, "vec") and hasattr(bc, "names"):       # Frame
        names = bc.vec("names").to_strings()
        lo = (bc.vec("lower_bounds").to_numpy()
              if "lower_bounds" in bc.names else [-np.inf] * len(names))
        hi = (bc.vec("upper_bounds").to_numpy()
              if "upper_bounds" in bc.names else [np.inf] * len(names))
        for n, lv, hv in zip(names, lo, hi):
            out.append((str(n),
                        -np.inf if lv is None or np.isnan(lv) else float(lv),
                        np.inf if hv is None or np.isnan(hv) else float(hv)))
    elif isinstance(bc, dict):
        for n, (lv, hv) in bc.items():
            out.append((str(n), float(lv), float(hv)))
    else:                                                 # list of dicts
        for e in bc:
            out.append((str(e["names"]),
                        float(e.get("lower_bounds", -np.inf)),
                        float(e.get("upper_bounds", np.inf))))
    return out


def _standardize(Xs: torch.Tensor, Fe: int, w: torch.Tensor,
                 mask: Optional[torch.Tensor]):
    """The weighted mean and deviation of the first Fe columns, then, in
    place a row block at a time, (X - mean) · (1/sd) · mask (mask None:
    no row mask). Returns (mean, sd)."""
    wsum = w.sum()
    Xe = Xs[:, :Fe]
    xm = (w @ Xe) / wsum
    step = _rows_per_block(Xs.shape[1])
    xv = torch.zeros(Fe, dtype=torch.float32, device=Xs.device)
    for s in range(0, Xs.shape[0], step):
        d = Xe[s:s + step] - xm
        xv += w[s:s + step] @ (d * d)
    xs = torch.sqrt(torch.clamp(xv / wsum, min=1e-12))
    inv = 1.0 / xs
    for s in range(0, Xs.shape[0], step):
        blk = Xe[s:s + step]
        blk.sub_(xm).mul_(inv)
        if mask is not None:
            blk.mul_(mask[s:s + step, None])
    return xm, xs


# ---------------- model -------------------------------------------------

class GLMModel(Model):
    algo = "glm"

    def __init__(self, key, params, names, nclasses, family, beta,
                 intercept_val, exp_names, impute_means, lambda_best,
                 null_dev, res_dev, nobs, rank, device, response=None,
                 response_domain=None, is_cat=None, cat_domains=None,
                 cat_plugs=None):
        super().__init__(key, params, names, nclasses, response=response,
                         response_domain=response_domain, is_cat=is_cat,
                         cat_domains=cat_domains)
        self.family = family
        self.beta = np.array(beta, np.float32)      # raw scale [Fe] / [Fe, K]
        self.intercept_value = (np.asarray(intercept_val)
                                if np.ndim(intercept_val) else
                                float(intercept_val))
        self.exp_names = list(exp_names)
        self.impute_means = {k: float(v) for k, v in impute_means.items()}
        self.cat_plugs = cat_plugs
        self.lambda_best = lambda_best
        self.null_deviance = null_dev
        self.residual_deviance = res_dev
        self.nobs = nobs
        self.rank = rank
        self.device = device
        # on the device once: predict copies nothing from the host, so
        # that it can be captured in a CUDA graph
        self._beta = torch.as_tensor(self.beta, device=device)
        self._icpt = torch.as_tensor(np.asarray(self.intercept_value,
                                                np.float32), device=device)

    @classmethod
    def from_jax_arrays(cls, arrays: Dict[str, np.ndarray], meta: Dict,
                        device=None) -> "GLMModel":
        """A model from the JAX package's ``GLMModel._save_arrays()``
        (beta [Fe] or [Fe, K], impute_keys, impute_vals) and ``meta``: its
        ``_save_extra_meta()`` (family, intercept, exp_names, cat_plugs,
        lambda_best, the deviances, nobs, rank) with names, is_cat,
        cat_domains, response_domain, nclasses and the parameters predict
        reads, as ``params`` or at the top level (link, the tweedie
        powers, theta, interactions, interaction_pairs, offset_column)."""
        params = dict(meta.get("params") or {})
        for k in ("link", "tweedie_variance_power", "tweedie_link_power",
                  "theta", "interactions", "interaction_pairs",
                  "offset_column"):
            if meta.get(k) is not None:
                params[k] = meta[k]
        icpt = meta["intercept"]
        return cls(f"glm_{id(arrays) & 0xffffff:x}", params, meta["names"],
                   int(meta["nclasses"]), meta["family"],
                   np.asarray(arrays["beta"], np.float32),
                   np.asarray(icpt) if isinstance(icpt, list) else icpt,
                   meta["exp_names"], unpack_impute_means(arrays),
                   meta.get("lambda_best"), meta.get("null_deviance"),
                   meta.get("residual_deviance"), meta.get("nobs"),
                   meta.get("rank"), _device.resolve(device),
                   response_domain=meta.get("response_domain"),
                   is_cat=meta.get("is_cat"),
                   cat_domains=meta.get("cat_domains"),
                   cat_plugs=meta.get("cat_plugs"))

    def coef(self) -> Dict[str, float]:
        if self.family == "multinomial":
            dom = self.response_domain or tuple(
                str(k) for k in range(self.nclasses))
            out: Dict[str, Dict[str, float]] = {}
            for k, lbl in enumerate(dom):
                d = {"Intercept": float(self.intercept_value[k])}
                d.update({n: float(self.beta[j, k])
                          for j, n in enumerate(self.exp_names)})
                out[str(lbl)] = d
            return out
        if self.family == "ordinal":
            d = {f"Intercept_{k}": float(v)
                 for k, v in enumerate(np.atleast_1d(self.intercept_value))}
            d.update({n: float(b) for n, b in zip(self.exp_names, self.beta)})
            return d
        d = {"Intercept": self.intercept_value}
        d.update({n: float(b) for n, b in zip(self.exp_names, self.beta)})
        return d

    def coef_with_p_values(self) -> Dict[str, Dict[str, float]]:
        """Standard errors, z and p per coefficient (a train with
        compute_p_values=True)."""
        pv = self.output.get("p_values")
        if not pv:
            raise ValueError(
                "p-values were not computed — train with "
                "compute_p_values=True (and no L1 penalty)")
        return {"coefficients": self.coef(),
                "std_errs": self.output["std_errs"],
                "z_values": self.output["z_values"],
                "p_values": pv}

    def _predict_matrix(self, X: torch.Tensor,
                        offset: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
        """The JAX package's predict, a block of rows at a time: the
        expanded block, its margins by ``dot_fixed``, then the link (or
        the ordinal's cumulative probabilities, the multinomial's
        softmax). No host read: the serving registry captures it."""
        X = X.to(self.device)
        plan = scoring_plan(self)
        step = _rows_per_block(
            (1 << max(plan.Fe - 1, 0).bit_length())
            * (self._beta.shape[1] if self._beta.dim() == 2 else 1),
            PREDICT_BLOCK_ELEMS)
        parts = []
        for s in range(0, X.shape[0], step):
            off = None if offset is None else offset[s:s + step].to(
                self.device)
            parts.append(self._predict_block(plan, X[s:s + step], off))
        if not parts:
            return self._predict_block(plan, X, offset)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _predict_block(self, plan: DesignPlan, X, offset):
        Xe = plan.fill(X)
        if self.family == "ordinal":
            eta = dot_fixed(Xe, self._beta)
            if offset is not None:
                eta = eta + offset
            th = self._icpt                                  # [K-1] ascending
            ocdf, _ = _ordinal_cdf_fns(self.params.get("link"))
            cdf = ocdf(th[None, :] - eta[:, None])
            probs = torch.cat([cdf[:, :1], cdf[:, 1:] - cdf[:, :-1],
                               1.0 - cdf[:, -1:]], dim=1)
            return torch.clamp(probs, 1e-9, 1.0)
        if self.family == "multinomial":
            eta = dot_fixed(Xe, self._beta) + self._icpt[None, :]
            if offset is not None:
                eta = eta + offset[:, None]
            return torch.softmax(eta, dim=1)
        eta = dot_fixed(Xe, self._beta) + self.intercept_value
        if offset is not None:
            eta = eta + offset
        mu = _make_family(self.family, self.params).linkinv(eta)
        if self.nclasses == 2:
            return torch.stack([1.0 - mu, mu], dim=1)
        return mu

    # -- persistence ----------------------------------------------------

    def _save_arrays(self):
        return {"beta": self.beta, **pack_impute_means(self.impute_means)}

    def _save_extra_meta(self):
        icpt = (self.intercept_value.tolist()
                if isinstance(self.intercept_value, np.ndarray)
                else self.intercept_value)
        return {"family": self.family, "intercept": icpt,
                "cat_plugs": self.cat_plugs,
                "exp_names": self.exp_names, "lambda_best": self.lambda_best,
                "null_deviance": self.null_deviance,
                "residual_deviance": self.residual_deviance,
                "nobs": self.nobs, "rank": self.rank}

    @classmethod
    def _restore(cls, meta, arrays, device=None) -> "GLMModel":
        """A model from an artifact of either package, through
        ``from_jax_arrays``, with the artifact's base state."""
        flat = dict(meta["extra"], names=meta["feature_names"],
                    nclasses=meta["nclasses"],
                    response_domain=meta.get("response_domain"),
                    is_cat=meta["feature_is_cat"],
                    cat_domains=meta.get("cat_domains"),
                    params=meta.get("params"))
        return cls.from_jax_arrays(arrays, flat, device)._restore_base(meta)


# ---------------- builder -----------------------------------------------

def check_params(params: Dict) -> None:
    """Raise ValueError on a parameter the port does not know."""
    unknown = sorted(set(params) - (set(GLM_DEFAULTS) | BUILDER_PARAMS
                                    | set(BALANCE_DEFAULTS)
                                    | set(GLM_COMPAT_PARAMS)
                                    | _EXTRA_PARAMS))
    if unknown:
        raise ValueError(f"glm: unknown parameter(s) {unknown}")


class H2OGeneralizedLinearEstimator(ModelBuilder):
    algo = "glm"
    compat_params = GLM_COMPAT_PARAMS
    # a frame past the device budget reaches _train_impl, which refuses
    # it naming item 15b (the JAX package streams it)
    supports_streaming = True

    def __init__(self, **params):
        merged = dict(GLM_DEFAULTS)
        merged.update(GLM_COMPAT_PARAMS)
        merged.update(BALANCE_DEFAULTS)
        merged.update(params)
        # h2o-py spells it lambda_ in python and "lambda" on the wire
        for alias in ("lambda_", "lambda"):
            if alias in merged:
                merged["Lambda"] = merged.pop(alias)
        check_params(merged)
        super().__init__(**merged)

    def _resolve_family(self, spec) -> str:
        fam = (self.params.get("family") or "auto").lower()
        if fam in ("auto", ""):
            if spec.nclasses == 2:
                return "binomial"
            if spec.nclasses > 2:
                return "multinomial"
            return "gaussian"
        return fam

    def _apply_mvh(self, spec: TrainingSpec) -> TrainingSpec:
        """missing_values_handling: MeanImputation (the default, in the
        design), Skip (rows with an NA feature take weight 0) or
        PlugValues (``plug_values``, a one-row Frame or a {column: value}
        dict, substituted into X; enum plugs are level names and are kept
        for scoring)."""
        p = self.params
        mvh = str(p.get("missing_values_handling")
                  or "mean_imputation").lower().replace("_", "")
        self._plug_num = None
        self._cat_plugs = None
        if mvh in ("meanimputation", ""):
            return spec
        if mvh == "skip":
            nanrow = torch.isnan(spec.X).any(dim=1)
            return replace(spec, w=spec.w * (~nanrow))
        if mvh != "plugvalues":
            raise ValueError(
                f"unknown missing_values_handling '{mvh}' (one of "
                f"MeanImputation, Skip, PlugValues)")
        pv = p.get("plug_values")
        if pv is None:
            raise ValueError(
                "missing_values_handling=PlugValues requires a "
                "plug_values frame")
        if hasattr(pv, "vec") and hasattr(pv, "names"):
            plug = {}
            for n in pv.names:
                v = pv.vec(n)
                if v.type == "enum":
                    plug[n] = v.domain[int(np.asarray(v.to_numpy())[0])]
                elif v.type == "string":
                    plug[n] = v.to_strings()[0]
                else:
                    plug[n] = float(np.asarray(v.to_numpy())[0])
        else:
            plug = dict(pv)
        self._plug_num, self._cat_plugs = {}, {}
        X = spec.X.clone()
        for i, n in enumerate(spec.names):
            if n not in plug:
                continue
            val = plug[n]
            if spec.is_cat[i]:
                dom = spec.cat_domains.get(n) or ()
                sval = str(val)
                if sval not in dom:
                    raise ValueError(
                        f"plug_values level '{sval}' is not in the "
                        f"domain of enum column '{n}'")
                code = dom.index(sval)
                self._cat_plugs[n] = code
                fill = float(code)
            else:
                fill = float(val)
                self._plug_num[n] = fill
            X[:, i] = torch.where(torch.isnan(X[:, i]), fill, X[:, i])
        return replace(spec, X=X)

    def _train_impl(self, spec: TrainingSpec,
                    valid: Optional[TrainingSpec] = None) -> GLMModel:
        if spec.stream:
            raise NotImplementedError(
                "glm: the training frame exceeds the device memory budget; "
                f"the streamed GLM is not ported yet: {ITEM_15B}")
        if self.params.get("HGLM"):
            raise NotImplementedError(
                f"glm: HGLM is not ported yet: {ITEM_15B}")
        spec = self._apply_mvh(spec)
        if valid is not None:
            valid = self._apply_mvh(valid)
        with full_fp32():
            model = self._train_family(spec, valid)
        # plug values follow the model to scoring: enum plugs as NA
        # codes, numeric plugs merged over the computed means
        if self._cat_plugs:
            model.cat_plugs = dict(self._cat_plugs)
        if self._plug_num:
            model.impute_means = {**model.impute_means, **self._plug_num}
        return model

    def _train_family(self, spec, valid) -> GLMModel:
        p = self.params
        family = self._resolve_family(spec)
        prior = float(p.get("prior", -1.0) or -1.0)
        if prior > 0:
            if family != "binomial":
                raise ValueError(
                    "prior is only supported for family=binomial "
                    "(hex/glm GLMParameters validation)")
            if prior >= 1.0:
                raise ValueError(f"prior must be in (0, 1), got {prior}")
        if family in ("ordinal", "multinomial"):
            sv = p.get("startval")
            if sv is not None and len(sv):
                raise NotImplementedError(
                    f"startval is not implemented for family={family} "
                    f"(supported for the single-response families)")
        if family == "ordinal":
            return self._train_ordinal(spec, valid)
        if family == "multinomial":
            return self._train_multinomial(spec, valid)
        if family not in _FAMILIES:
            raise ValueError(f"unsupported family '{family}'; have "
                             f"{sorted(_FAMILIES)}")
        return _DenseFit(self, spec, valid, family).run()

    def _model(self, spec, family, beta, icpt, exp_names, means, lam,
               null_dev, res_dev, nobs, rank) -> GLMModel:
        return GLMModel(self._model_key(), self.params, spec.names,
                        spec.nclasses, family, beta, icpt, exp_names, means,
                        lam, null_dev, res_dev, nobs, rank, spec.device,
                        response=spec.response,
                        response_domain=spec.response_domain,
                        is_cat=spec.is_cat, cat_domains=spec.cat_domains)

    def _train_ordinal(self, spec: TrainingSpec, valid) -> GLMModel:
        """Ordinal (proportional-odds) regression: P(y <= k) =
        cdf(θ_k − η), monotone thresholds by a log-gap parameterization,
        full-batch Adam on the weighted NLL (``max_iterations`` × 20
        steps)."""
        p = self.params
        K = spec.nclasses
        y = spec.y.long()
        w = spec.w
        prof = _Profile(spec.device)
        Xs, exp_names, means = expand_design(
            spec, interactions=p.get("interactions") or None,
            interaction_pairs=p.get("interaction_pairs") or None)
        Fe = Xs.shape[1]
        wsum = torch.clamp(w.sum(), min=1e-12)
        xm = (w @ Xs) / wsum
        d = Xs - xm
        xs = torch.sqrt(torch.clamp((w @ (d * d)) / wsum, min=1e-12))
        del d
        Xs.sub_(xm).div_(xs)
        lam2 = 0.0
        lam_in = p.get("Lambda")
        if lam_in:
            lam2 = float(lam_in[0] if isinstance(lam_in, (list, tuple))
                         else lam_in)
        ocdf, oicdf = _ordinal_cdf_fns(p.get("link"))

        def unpack(pv):
            gaps = torch.exp(torch.clamp(pv[Fe + 1:], -20.0, 10.0))
            th = pv[Fe] + torch.cat([pv.new_zeros(1), torch.cumsum(gaps, 0)])
            return pv[:Fe], th

        cnt = torch.zeros(K, dtype=torch.float32,
                          device=w.device).index_add_(0, y, w)
        cum = torch.clamp(torch.cumsum(cnt, 0)[:-1] / wsum, 1e-4, 1 - 1e-4)
        th_init = oicdf(cum)
        gaps0 = torch.log(torch.clamp(torch.diff(th_init), min=1e-3))
        pv = torch.cat([torch.zeros(Fe, device=w.device), th_init[:1],
                        gaps0]).to(torch.float32)

        def nll(pv):
            beta, th = unpack(pv)
            eta = Xs @ beta
            cdf = ocdf(th[None, :] - eta[:, None])
            probs = torch.cat([cdf[:, :1], cdf[:, 1:] - cdf[:, :-1],
                               1.0 - cdf[:, -1:]], dim=1)
            py = torch.gather(probs, 1, y[:, None])[:, 0]
            return (-(w * torch.log(torch.clamp(py, 1e-12, 1.0))).sum()
                    / wsum + 0.5 * lam2 * (beta ** 2).sum())

        m = torch.zeros_like(pv)
        v = torch.zeros_like(pv)
        lr0 = 0.05
        steps = _max_iter_of(p, 50) * 20
        prof.lap("design_s")
        for i in range(steps):
            x = pv.detach().requires_grad_(True)
            with torch.enable_grad():
                g, = torch.autograd.grad(nll(x), x)
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mh = m / (1 - 0.9 ** (i + 1.0))
            vh = v / (1 - 0.999 ** (i + 1.0))
            pv = pv - lr0 * mh / (torch.sqrt(vh) + 1e-8)
        prof.lap("path_s")
        beta_s, th = unpack(pv)
        beta_raw = beta_s / xs
        shift = (beta_s * xm / xs).sum()
        th_raw = (th + shift).cpu().numpy()
        res = float(nll(pv) * wsum)
        nobs = float(wsum)
        del Xs
        model = self._model(spec, "ordinal", beta_raw.cpu().numpy(), th_raw,
                            exp_names, means, lam2, 0.0, res, nobs,
                            Fe + K - 1)
        model.output["iterations"] = steps
        model.training_metrics = compute_metrics(
            model._predict_matrix(spec.X), spec.y, w, K)
        if valid is not None:
            model.validation_metrics = compute_metrics(
                model._predict_matrix(valid.X, offset=valid.offset),
                valid.y, valid.w, K)
        prof.lap("metrics_s")
        model.output["train_profile"] = prof.laps
        return model

    def _train_multinomial(self, spec: TrainingSpec, valid) -> GLMModel:
        """Multinomial softmax GLM by class-cyclic IRLS: each pass updates
        class k from the weighted Gram Xᵀdiag(w·p_k(1−p_k))X, solved by
        Cholesky, or by coordinate descent under an L1 penalty."""
        p = self.params
        K = spec.nclasses
        if spec.offset is not None:
            raise NotImplementedError(
                "offset_column is not supported for multinomial GLM "
                "(the class-cyclic IRLS path has no offset term yet)")
        if p.get("beta_constraints"):
            raise NotImplementedError(
                "beta_constraints are not supported for multinomial GLM")
        if p.get("lambda_search"):
            raise NotImplementedError(
                "lambda_search is not supported for multinomial GLM — "
                "pass an explicit Lambda")
        fit_intercept = bool(p.get("intercept", True))
        y = spec.y.long()
        w = spec.w
        prof = _Profile(spec.device)
        Xs, exp_names, means = expand_design(
            spec, interactions=p.get("interactions") or None,
            interaction_pairs=p.get("interaction_pairs") or None,
            extra_cols=1 if fit_intercept else 0)
        Fe = len(exp_names)
        nobs = float(w.sum())
        live = (w > 0).to(torch.float32)
        standardize = bool(p.get("standardize", True)) and fit_intercept
        if standardize:
            xm, xs = _standardize(Xs, Fe, w, live)
        else:
            Xs[:, :Fe].mul_(live[:, None])
        dev = Xs.device
        if fit_intercept:
            Xs[:, Fe] = live
            pen_mask = torch.cat([torch.ones(Fe, device=dev),
                                  torch.zeros(1, device=dev)])
        else:
            pen_mask = torch.ones(Fe, device=dev)
        ncoef = Xs.shape[1]
        Y1 = torch.nn.functional.one_hot(y, K).to(torch.float32) \
            * live[:, None]
        alpha = p.get("alpha")
        alpha = 0.5 if alpha is None else (
            alpha[0] if isinstance(alpha, (list, tuple)) else float(alpha))
        lam_param = p.get("Lambda")
        if isinstance(lam_param, (list, tuple)):
            lam = float(lam_param[0]) if lam_param else 0.0
        else:
            lam = float(lam_param) if lam_param is not None else 0.0
        lam1 = float(np.float32(lam * alpha * nobs))
        lam2 = float(np.float32(lam * (1 - alpha) * nobs))
        beta_eps = float(p.get("beta_epsilon", 1e-5))
        use_cd = lam > 0 and alpha > 0

        def class_pass(B):
            B = B.clone()
            for k in range(K):
                eta = Xs @ B
                P = torch.softmax(eta, dim=1)
                pk = P[:, k]
                w_irls = w * pk * (1.0 - pk)
                z = eta[:, k] + (Y1[:, k] - pk) / torch.clamp(
                    pk * (1.0 - pk), min=1e-5)
                G, b = gram(Xs, w_irls, z)
                if use_cd:
                    B[:, k] = cd_elastic_net(G, b, B[:, k].contiguous(),
                                             lam1, lam2, pen_mask, 10)
                else:
                    B[:, k] = cholesky_solve(G, b, lam2, pen_mask)
            return B

        B = torch.zeros((ncoef, K), dtype=torch.float32, device=dev)
        iterations = 0
        prof.lap("design_s")
        for _ in range(_max_iter_of(p, 50)):
            nB = class_pass(B)
            iterations += 1
            delta = float(torch.max(torch.abs(nB - B)))
            B = nB
            if delta < beta_eps:
                break
        prof.lap("path_s")
        eta = Xs @ B
        P = torch.softmax(eta, dim=1)
        py = torch.clamp((P * Y1).sum(1), 1e-12, 1.0)
        res_dev = float(-2.0 * (w * torch.where(w > 0, torch.log(py),
                                                0.0)).sum())
        prior = (Y1 * w[:, None]).sum(0) / torch.clamp(w.sum(), min=1e-30)
        null_dev = float(-2.0 * (w * torch.where(
            w > 0, torch.log(torch.clamp(prior[y], 1e-12, 1.0)),
            0.0)).sum())
        if standardize:
            beta_raw = B[:Fe, :] / xs[:, None]
            icpt = B[Fe, :] - (B[:Fe, :] * (xm / xs)[:, None]).sum(0)
        else:
            beta_raw = B[:Fe, :]
            icpt = B[Fe, :] if fit_intercept else torch.zeros(K, device=dev)
        rank = int((torch.abs(B[:Fe, :]) > 1e-10).sum()) + (
            K if fit_intercept else 0)
        del Xs, eta, P
        model = self._model(spec, "multinomial", beta_raw.cpu().numpy(),
                            icpt.cpu().numpy(), exp_names, means, lam,
                            null_dev, res_dev, nobs, rank)
        model.output["coefficients"] = model.coef()
        model.output["iterations"] = iterations
        model.training_metrics = compute_metrics(
            model._predict_matrix(spec.X), spec.y, w, K)
        if valid is not None:
            model.validation_metrics = compute_metrics(
                model._predict_matrix(valid.X), valid.y, valid.w, K)
        prof.lap("metrics_s")
        model.output["train_profile"] = prof.laps
        return model


class _DenseFit:
    """One single-response train (the JAX package's ``_train_impl`` past
    its dispatch): the design, the λ path of IRLS (or L-BFGS) solves,
    destandardization, p-values and the metrics."""

    def __init__(self, builder: H2OGeneralizedLinearEstimator,
                 spec: TrainingSpec, valid, family: str):
        self.b = builder
        self.p = builder.params
        self.spec = spec
        self.valid = valid
        self.family = family

    def run(self) -> GLMModel:
        p, spec, family = self.p, self.spec, self.family
        fit_intercept = bool(p.get("intercept", True))
        fam = _make_family(family, p)
        self.fam = fam
        if family == "tweedie":
            # the response domain: y < 0 never; y = 0 has no density for
            # p >= 2
            live = spec.w > 0
            if bool((live & (spec.y < 0)).any()):
                raise ValueError(
                    "family=tweedie requires a non-negative response")
            if fam.p >= 2.0 and bool((live & (spec.y == 0)).any()):
                raise ValueError(
                    f"tweedie_variance_power={fam.p} requires a strictly "
                    f"positive response (y=0 rows are only valid for "
                    f"1 < p < 2)")
        y = spec.y.to(torch.float32)
        w = spec.w
        offset = spec.offset
        interactions = p.get("interactions") or None
        ipairs = p.get("interaction_pairs") or None
        prof = _Profile(spec.device)
        Xs, exp_names, means = expand_design(
            spec, interactions=interactions, interaction_pairs=ipairs,
            extra_cols=1 if fit_intercept else 0)
        Fe = len(exp_names)
        dev = Xs.device
        nobs = float(w.sum())
        live = (w > 0).to(torch.float32)
        standardize = bool(p.get("standardize", True)) and fit_intercept
        xm = xs = None
        if standardize:
            xm, xs = _standardize(Xs, Fe, w, live)
        else:
            Xs[:, :Fe].mul_(live[:, None])
        if fit_intercept:
            Xs[:, Fe] = live
            pen_mask = torch.cat([torch.ones(Fe, device=dev),
                                  torch.zeros(1, device=dev)])
        else:
            pen_mask = torch.ones(Fe, device=dev)
        ncoef = Xs.shape[1]
        prof.lap("design_s")

        alpha = p.get("alpha")
        if isinstance(alpha, (list, tuple)):
            alpha = alpha[0] if alpha else None
        alpha = 0.5 if alpha is None else float(alpha)
        lam_param = p.get("Lambda")
        if isinstance(lam_param, (list, tuple)):
            lambdas = [float(v) for v in lam_param] or None
        elif lam_param is not None:
            lambdas = [float(lam_param)]
        else:
            lambdas = None

        def with_offset(eta):
            return eta if offset is None else eta + offset

        # initial state: η₀ = g(μ₀) through the model's link
        mu0 = fam.init_mu(y, w)
        eta = with_offset(torch.full_like(y, float(fam.link(mu0))))
        null_dev = float(fam.deviance(w, y, fam.linkinv(eta)))
        if lambdas is None:
            if p.get("lambda_search"):
                # λ_max: the smallest λ zeroing every penalized coefficient
                mu = fam.linkinv(eta)
                g0 = (Xs.t() @ (w * (y - mu) * fam.mu_eta(eta)
                                / fam.variance(mu)))[:Fe]
                lmax = float(torch.max(torch.abs(g0))) / max(
                    nobs * max(alpha, 1e-3), 1e-12)
                nl = int(p.get("nlambdas", 30) or 30)
                if nl <= 0:
                    nl = 30
                lmr = float(p.get("lambda_min_ratio", 1e-4) or 1e-4)
                if lmr <= 0:
                    lmr = 1e-4
                lambdas = list(np.geomspace(lmax, lmr * lmax, nl))
            else:
                lambdas = [0.0]

        max_iter = _max_iter_of(p, 50)
        beta_eps = float(p.get("beta_epsilon", 1e-5))
        non_neg = bool(p.get("non_negative", False))
        nn_cols = p.get("non_negative_columns") or None
        nn_mask = None
        if nn_cols:
            nn_host = np.zeros(ncoef, np.float32)
            for i, nme in enumerate(exp_names):
                if nme in nn_cols:
                    nn_host[i] = 1.0
            nn_mask = torch.as_tensor(nn_host, device=dev)
            if non_neg:
                nn_mask = torch.maximum(nn_mask, pen_mask)
        solver = str(p.get("solver") or "auto").upper().replace("-", "_")
        use_lbfgs = solver in ("L_BFGS", "LBFGS")
        if use_lbfgs and (family == "tweedie" or fam.link_name
                          != _PLAIN_IRLS_LINK.get(family)):
            use_lbfgs = False
        bc = p.get("beta_constraints")
        if bc and use_lbfgs:
            use_lbfgs = False
        if use_lbfgs and alpha > 0 and any(lv > 0 for lv in lambdas):
            raise ValueError(
                "L1 penalty (alpha > 0 with lambda > 0) is not supported "
                "by solver L_BFGS (hex/glm/GLM.java:979 forces alpha=0 for "
                "L-BFGS); use IRLSM or COORDINATE_DESCENT")
        compute_pv = bool(p.get("compute_p_values", False))
        if compute_pv and (alpha > 0 and any(lv > 0 for lv in lambdas)):
            raise ValueError(
                "p-values cannot be computed with an L1 penalty "
                "(hex/glm/GLM.java compute_p_values restrictions)")

        def nll_mean(bs):
            """L-BFGS's objective: the mean negative log-likelihood on the
            standardized design, at the _PLAIN_IRLS_LINK pairs."""
            eta_i = with_offset(Xs @ bs)
            if family in ("binomial", "quasibinomial",
                          "fractionalbinomial"):
                per = torch.logaddexp(eta_i, torch.zeros_like(eta_i)) \
                    - y * eta_i
            elif family == "poisson":
                per = torch.exp(eta_i) - y * eta_i
            elif family == "gamma":
                per = y * torch.exp(-eta_i) + eta_i
            elif family == "negativebinomial":
                th_nb = fam.theta
                mu_i = torch.exp(torch.clamp(eta_i, -30, 30))
                per = ((y + 1.0 / th_nb) * torch.log1p(th_nb * mu_i)
                       - y * (float(np.log(th_nb)) + eta_i))
            else:
                per = 0.5 * (y - eta_i) ** 2
            return (w * per).sum() / nobs

        bc_lo = bc_hi = None
        if bc:
            lo_h = np.full(ncoef, -np.inf, np.float32)
            hi_h = np.full(ncoef, np.inf, np.float32)
            lut = {n: i for i, n in enumerate(exp_names)}
            for nme, lob, hib in _parse_beta_constraints(bc):
                if nme not in lut:
                    raise ValueError(
                        f"beta_constraints name '{nme}' is not an expanded "
                        f"design column {exp_names}")
                lo_h[lut[nme]] = lob
                hi_h[lut[nme]] = hib
            if standardize:
                xs_h = xs.cpu().numpy()
                lo_h[:Fe] = lo_h[:Fe] * xs_h
                hi_h[:Fe] = hi_h[:Fe] * xs_h
            bc_lo = torch.as_tensor(lo_h, device=dev)
            bc_hi = torch.as_tensor(hi_h, device=dev)

        def irls_step(beta_s, lam1, lam2, use_cd):
            eta_i = with_offset(Xs @ beta_s)
            mu = fam.clamp_mu(fam.linkinv(eta_i))
            dmu = fam.mu_eta(eta_i)
            var = fam.variance(mu)
            w_irls = w * dmu * dmu / var
            z = ((eta_i if offset is None else eta_i - offset)
                 + (y - mu) * dmu / torch.clamp(dmu * dmu, min=1e-12))
            G, b = gram(Xs, w_irls, z)
            if use_cd:
                return cd_elastic_net(G, b, beta_s, lam1, lam2, pen_mask, 10,
                                      non_negative=non_neg, nn_mask=nn_mask,
                                      lo=bc_lo, hi=bc_hi)
            nb = cholesky_solve(G, b, lam2, pen_mask)
            if nn_mask is not None:
                nb = torch.where(nn_mask > 0, torch.clamp(nb, min=0.0), nb)
            elif non_neg:
                nb = torch.where(pen_mask > 0, torch.clamp(nb, min=0.0), nb)
            return nb

        def merit(bvec, l1, l2):
            """deviance/2 + λ₁‖β‖₁ + λ₂/2‖β‖₂² on the penalized
            coordinates, on the host."""
            ef = with_offset(Xs @ bvec)
            devm = fam.deviance(w, y, fam.clamp_mu(fam.linkinv(ef)))
            bp = bvec * pen_mask
            return float(0.5 * devm + l1 * torch.abs(bp).sum()
                         + 0.5 * l2 * (bp * bp).sum())

        vXs = None
        if self.valid is not None:
            vXs, _, _ = expand_design(
                self.valid, impute_means=means, interactions=interactions,
                interaction_pairs=ipairs,
                extra_cols=1 if fit_intercept else 0)
            if standardize:
                vXs[:, :Fe].sub_(xm).mul_(1.0 / xs)
            if fit_intercept:
                vXs[:, Fe] = 1.0
            vy = self.valid.y.to(torch.float32)
            vw = self.valid.w
            voff = self.valid.offset

        beta_s = torch.zeros(ncoef, dtype=torch.float32, device=dev)
        if fit_intercept:
            # start at the null model (for the inverse link η = 0 is
            # outside the usable region)
            beta_s[Fe] = fam.link(mu0)
        sv = p.get("startval")
        if sv is not None and len(sv):
            # raw scale, expanded-column order, intercept last
            sv = np.asarray(sv, np.float32)
            want = Fe + (1 if fit_intercept else 0)
            if sv.shape[0] != want:
                raise ValueError(
                    f"startval needs {want} values (expanded "
                    f"coefficients{' + intercept' if fit_intercept else ''}"
                    f"), got {sv.shape[0]}")
            b0 = torch.as_tensor(sv[:Fe], device=dev)
            if standardize:
                beta_s[:Fe] = b0 * xs
                if fit_intercept:
                    beta_s[Fe] = float(sv[Fe]) + (b0 * xm).sum()
            else:
                beta_s[:Fe] = b0
                if fit_intercept:
                    beta_s[Fe] = float(sv[Fe])
        beta_init0 = beta_s
        cold_start = bool(p.get("cold_start", False))
        guard = (fam.link_name != _PLAIN_IRLS_LINK.get(family)
                 or family == "tweedie")
        best = None
        submodels = []
        iterations = 0
        for li, lam in enumerate(lambdas):
            if cold_start and li > 0:
                beta_s = beta_init0
            if use_lbfgs:
                lam2_unit = float(np.float32(lam * (1 - alpha)))
                beta_s, _f, _its = lbfgs_minimize(
                    lambda bs: nll_mean(bs) + 0.5 * lam2_unit * (
                        (bs * pen_mask) ** 2).sum(),
                    beta_s, max_iter=max(max_iter * 6, 300),
                    tol=float(p.get("gradient_epsilon", 1e-6)))
                iterations += _its
            else:
                use_cd = (alpha > 0 and lam > 0) or bool(bc)
                lam1 = float(np.float32(lam * alpha * nobs))
                lam2 = float(np.float32(lam * (1 - alpha) * nobs))
                prev_mer = merit(beta_s, lam1, lam2) if guard else None
                for _ in range(max_iter):
                    nb = irls_step(beta_s, lam1, lam2, use_cd)
                    iterations += 1
                    if guard:
                        # halving on the penalized objective for links
                        # outside the monotone-safe set
                        mer_t = merit(nb, lam1, lam2)
                        halvings = 0
                        while ((not np.isfinite(mer_t)
                                or mer_t > prev_mer * (1 + 1e-8))
                               and halvings < 8):
                            nb = 0.5 * (nb + beta_s)
                            mer_t = merit(nb, lam1, lam2)
                            halvings += 1
                        if (not np.isfinite(mer_t)
                                or mer_t > prev_mer * (1 + 1e-8)):
                            break
                        prev_mer = mer_t
                    delta = float(torch.max(torch.abs(nb - beta_s)))
                    beta_s = nb
                    if delta < beta_eps:
                        break
                    if (family == "gaussian" and not use_cd
                            and fam.link_name == "identity"):
                        break  # weighted least squares: one solve is exact
            dev_ = float(fam.deviance(w, y, fam.linkinv(
                with_offset(Xs @ beta_s))))
            sel_dev = dev_
            if vXs is not None:
                veta = vXs @ beta_s
                if voff is not None:
                    veta = veta + voff
                sel_dev = float(fam.deviance(vw, vy, fam.linkinv(veta)))
            submodels.append({"lambda": float(lam), "deviance": dev_,
                              "nonzero": int((torch.abs(beta_s[:Fe])
                                              > 1e-10).sum())})
            if vXs is not None:
                submodels[-1]["validation_deviance"] = sel_dev
            if best is None or sel_dev <= best[1]:
                best = (beta_s, sel_dev, float(lam), dev_)
            map_ = int(p.get("max_active_predictors", -1) or -1)
            if (map_ > 0 and p.get("lambda_search")
                    and submodels[-1]["nonzero"] > map_):
                break
        del vXs
        prof.lap("path_s")
        beta_s, _, lam_best, res_dev = best
        if standardize:
            beta_raw = beta_s[:Fe] / xs
            icpt = float(beta_s[Fe] - (beta_s[:Fe] * xm / xs).sum())
        else:
            beta_raw = beta_s[:Fe]
            icpt = float(beta_s[Fe]) if fit_intercept else 0.0
        prior = float(p.get("prior", -1.0) or -1.0)
        if family == "binomial" and 0.0 < prior < 1.0 and fit_intercept:
            # rare-event sampling correction of the intercept
            ybar = float((w * y).sum() / torch.clamp(w.sum(), min=1e-12))
            ybar = min(max(ybar, 1e-12), 1 - 1e-12)
            icpt += float(np.log(prior * (1 - ybar))
                          - np.log(ybar * (1 - prior)))
        rank = (int((torch.abs(beta_s[:Fe]) > 1e-10).sum())
                + (1 if fit_intercept else 0))
        model = self.b._model(spec, family, beta_raw.cpu().numpy(), icpt,
                              exp_names, means, lam_best, null_dev, res_dev,
                              nobs, rank)
        model.output["lambda_path"] = submodels
        model.output["coefficients"] = model.coef()
        # IRLS steps (or L-BFGS iterations) over the whole λ path
        model.output["iterations"] = iterations
        if compute_pv:
            self._p_values(model, Xs, spec, fam, beta_raw, icpt, nobs, rank,
                           res_dev, exp_names, means, interactions, ipairs)
            prof.lap("p_values_s")
        del Xs
        out = model._predict_matrix(spec.X, offset=offset)
        model.training_metrics = compute_metrics(
            out, spec.y, w, spec.nclasses,
            deviance=res_dev / max(nobs, 1.0))
        if self.valid is not None:
            vout = model._predict_matrix(self.valid.X,
                                         offset=self.valid.offset)
            model.validation_metrics = compute_metrics(
                vout, self.valid.y, self.valid.w, spec.nclasses)
        prof.lap("metrics_s")
        model.output["train_profile"] = prof.laps
        return model

    def _p_values(self, model, buf, spec, fam, beta_raw, icpt, nobs, rank,
                  res_dev, exp_names, means, interactions, ipairs):
        """Standard errors, z and p from the unpenalized information on
        the raw design at the fitted coefficients (cov = pinv(XᵀWX)·φ̂),
        the raw design refilled into the train's buffer."""
        from scipy import stats as _st
        family = self.family
        w, y, offset = spec.w, spec.y.to(torch.float32), spec.offset
        Fe = len(exp_names)
        plan = DesignPlan(spec.names, spec.is_cat, spec.cat_domains, means,
                          1, cards=_enum_cards(spec),
                          interactions=interactions, pairs=ipairs)
        if buf.shape[1] == Fe:
            buf = torch.empty((buf.shape[0], Fe + 1), dtype=torch.float32,
                              device=buf.device)
        Xr = plan.fill(spec.X, out=buf)
        Xr[:, Fe] = 1.0
        beta_full = torch.cat([beta_raw, torch.tensor(
            [icpt], dtype=torch.float32, device=beta_raw.device)])
        eta_r = Xr @ beta_full
        if offset is not None:
            eta_r = eta_r + offset
        mu_r = fam.linkinv(eta_r)
        dmu_r = fam.mu_eta(eta_r)
        var_r = fam.variance(mu_r)
        wi = w * dmu_r * dmu_r / torch.clamp(var_r, min=1e-12)
        Gr, _ = gram(Xr, wi, torch.zeros_like(wi))
        df = max(nobs - rank, 1.0)
        if family == "gaussian":
            dispersion = res_dev / df
        elif family in ("gamma", "tweedie"):
            pearson = float((w * (y - mu_r) ** 2
                             / torch.clamp(var_r, min=1e-12)).sum())
            dispersion = pearson / df
        else:
            dispersion = 1.0
        cov = torch.linalg.pinv(
            Gr + 1e-8 * torch.eye(Gr.shape[0], device=Gr.device)
        ).cpu().numpy() * dispersion
        se = np.sqrt(np.maximum(np.diag(cov), 0.0))
        coefs_full = np.concatenate([beta_raw.cpu().numpy(), [icpt]])
        zval = np.where(se > 0, coefs_full / np.maximum(se, 1e-300), 0.0)
        if family == "gaussian":
            pval = 2.0 * _st.t.sf(np.abs(zval), df=max(df, 1.0))
        else:
            pval = 2.0 * _st.norm.sf(np.abs(zval))
        names_pv = list(exp_names) + ["Intercept"]
        model.output["std_errs"] = dict(zip(names_pv, se.tolist()))
        model.output["z_values"] = dict(zip(names_pv, zval.tolist()))
        model.output["p_values"] = dict(zip(names_pv, pval.tolist()))
        model.output["dispersion"] = float(dispersion)


register_model_class("glm", GLMModel)
