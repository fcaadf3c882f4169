"""Parity of the port's adaptive grower (h2o3_tpu_torch.models.tree
grow_tree_adaptive, adaptive_setup and the path rule) with the JAX
package, at float32 histograms: the same g, h, w, root ranges and nb_f
give the same splits, raw thresholds and leaf values. The JAX grower
runs compiled (``jax.jit``), as its trainer runs it: XLA then contracts
the range updates into fused multiply-adds, and the port computes them
so."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.models import tree as jtree
from h2o3_tpu_torch.models import tree as ttree

ROWS = 3000
# the JAX grower as its trainer runs it: compiled, cfg static
_JAX_GROW = jax.jit(jtree.grow_tree_adaptive, static_argnums=(4,))


def _cfgs(**kw):
    return jtree.TreeConfig(**kw), ttree.TreeConfig(**kw)


def _frame(seed=0, n_cat=0, card=12, F=5):
    """Raw features (NaN = NA) with a signal, optionally with enum
    columns of ``card`` levels as float codes, and their (g, h, w)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(ROWS, F)).astype(np.float32)
    X[:, 1] = X[:, 1] * 50.0 + 200.0                 # a wide, offset range
    is_cat = [False] * F
    for j in range(n_cat):
        X[:, F - 1 - j] = rng.integers(0, card, ROWS).astype(np.float32)
        is_cat[F - 1 - j] = True
    X[rng.random(X.shape) < 0.04] = np.nan
    signal = np.nan_to_num(X[:, 0]) - 0.01 * np.nan_to_num(X[:, 1] - 200) \
        + 0.2 * np.nan_to_num(X[:, F - 1]) \
        + rng.normal(size=ROWS).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-0.5 * signal))
    # g and h on a 2^-10 grid: every float32 sum of them is exact in any
    # order, so leaf values -G/H cannot differ by summation order
    q = 2.0 ** -10
    g = (np.round((p - (rng.random(ROWS) < p)) / q) * q).astype(np.float32)
    h = np.maximum(np.round(p * (1 - p) / q) * q, q).astype(np.float32)
    w = np.ones(ROWS, np.float32)
    w[rng.random(ROWS) < 0.1] = 0.0
    return X, is_cat, g * w, h * w, w


def _specs(X, is_cat, card):
    names = [f"f{i}" for i in range(X.shape[1])]
    doms = {n: tuple(str(i) for i in range(card))
            for n, c in zip(names, is_cat) if c}
    common = dict(names=names, is_cat=is_cat, cat_domains=doms,
                  n_features=X.shape[1])
    return (SimpleNamespace(X=jnp.asarray(X), **common),
            SimpleNamespace(X=torch.as_tensor(X), **common))


def _grow_both(X, g, h, w, cfg_kw, root_lo, root_hi, nb_f, key=None,
               phase=None, layout="rows_f"):
    F = X.shape[1]
    jc, tc = _cfgs(**cfg_kw)
    if key is not None:
        jc = jc.__class__(**{**cfg_kw, "random_grid": True})
    jt, jnid = _JAX_GROW(
        jnp.asarray(X), jnp.asarray(g), jnp.asarray(h), jnp.asarray(w), jc,
        jnp.ones(F, bool), jnp.asarray(root_lo), jnp.asarray(root_hi),
        nb_f=jnp.asarray(nb_f), key=key)
    x = torch.as_tensor(X if layout == "rows_f" else X.T.copy())
    tt, tnid = ttree.grow_tree_adaptive(
        x, torch.as_tensor(g), torch.as_tensor(h), torch.as_tensor(w), tc,
        torch.as_tensor(root_lo), torch.as_tensor(root_hi),
        nb_f=torch.as_tensor(nb_f),
        phase=None if phase is None else torch.as_tensor(phase),
        layout=layout)
    return jt, jnid, tt, tnid


def _assert_trees_equal(jt, jnid, tt, tnid):
    for k in ("feat", "thr", "na_left", "is_split"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(tnid.numpy(), np.asarray(jnid))
    for k in ("value", "node_w", "gain"):
        np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def _setup(X, is_cat, card, nbins):
    params = {"nbins": nbins, "nbins_cats": 1024, "min_rows": 1.0,
              "min_split_improvement": 1e-5,
              "histogram_precision": "float32"}
    _js, ts = _specs(X, is_cat, card)
    cfg, lo, hi, nb_f = ttree.adaptive_setup(ts, params, 3)
    return cfg, lo.numpy(), hi.numpy(), nb_f.numpy()


@pytest.mark.parametrize("layout", ["rows_f", "f_rows"])
@pytest.mark.parametrize("depth", [1, 3])
def test_grow_tree_adaptive_numeric_matches_jax(layout, depth):
    X, is_cat, g, h, w = _frame(seed=depth)
    cfg, lo, hi, nb_f = _setup(X, is_cat, 0, 20)
    kw = dict(max_depth=depth, n_bins=cfg.n_bins, n_features=X.shape[1],
              min_rows=1.0, histogram_precision="float32")
    jt, jnid, tt, tnid = _grow_both(X, g, h, w, kw, lo, hi, nb_f,
                                    layout=layout)
    assert bool(tt["is_split"].any())
    _assert_trees_equal(jt, jnid, tt, tnid)


@pytest.mark.parametrize("card", [12, 25])
def test_grow_tree_adaptive_with_enum_matches_jax(card):
    """An enum column gets identity bins through nb_f (its root span)."""
    X, is_cat, g, h, w = _frame(seed=5, n_cat=1, card=card)
    cfg, lo, hi, nb_f = _setup(X, is_cat, card, 14)
    assert cfg.n_bins == max(14, card - 1)
    assert nb_f[-1] == card - 1
    kw = dict(max_depth=3, n_bins=cfg.n_bins, n_features=X.shape[1],
              min_rows=1.0, histogram_precision="float32")
    jt, jnid, tt, tnid = _grow_both(X, g, h, w, kw, lo, hi, nb_f)
    assert (tt["feat"].numpy() == X.shape[1] - 1).any()   # the enum splits
    _assert_trees_equal(jt, jnid, tt, tnid)


@pytest.mark.parametrize("seed", [0, 1])
def test_grow_tree_adaptive_with_phase_matches_jax(seed):
    """histogram_type='random': the port takes the grid phase the JAX
    grower draws from its key."""
    X, is_cat, g, h, w = _frame(seed=10 + seed)
    cfg, lo, hi, nb_f = _setup(X, is_cat, 0, 20)
    F = X.shape[1]
    key = jax.random.PRNGKey(seed)
    phase = np.array(jax.random.uniform(jax.random.fold_in(key, 7919),
                                        (F,)))
    kw = dict(max_depth=3, n_bins=cfg.n_bins, n_features=F, min_rows=1.0,
              histogram_precision="float32")
    jt, jnid, tt, tnid = _grow_both(X, g, h, w, kw, lo, hi, nb_f, key=key,
                                    phase=phase)
    _assert_trees_equal(jt, jnid, tt, tnid)
    _j0, _n0, t0, _tn0 = _grow_both(X, g, h, w, kw, lo, hi, nb_f)
    assert not np.array_equal(t0["thr"].numpy(), tt["thr"].numpy())


def test_grow_tree_adaptive_stump():
    X, is_cat, g, h, w = _frame(seed=4)
    cfg, lo, hi, nb_f = _setup(X, is_cat, 0, 20)
    kw = dict(max_depth=0, n_bins=cfg.n_bins, n_features=X.shape[1],
              min_rows=1.0, histogram_precision="float32")
    jt, jnid, tt, tnid = _grow_both(X, g, h, w, kw, lo, hi, nb_f)
    _assert_trees_equal(jt, jnid, tt, tnid)


def test_adaptive_setup_matches_jax():
    """Root ranges ignore ±inf and NaN (an all-NA column gets 0), enums
    get identity bin counts."""
    X, is_cat, _g, _h, _w = _frame(seed=6, n_cat=1, card=30, F=6)
    X[5, 0] = np.inf
    X[9, 0] = -np.inf
    X[:, 2] = np.nan
    params = {"nbins": 20, "nbins_cats": 1024, "min_rows": 1.0,
              "min_split_improvement": 1e-5, "histogram_precision": "auto"}
    js, ts = _specs(X, is_cat, 30)
    jc, jlo, jhi, jnb = jtree.adaptive_setup(js, params, 4)
    tc, tlo, thi, tnb = ttree.adaptive_setup(ts, params, 4)
    assert tc.n_bins == jc.n_bins == 29
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(tnb.numpy(), np.asarray(jnb))
    assert tlo[2] == thi[2] == 0.0


@pytest.mark.parametrize("card,nbins,depth,F", [
    (0, 20, 6, 28), (300, 20, 3, 6), (2000, 20, 3, 6), (0, 300, 4, 6),
    (0, 20, 14, 28), (100, 254, 8, 20)])
def test_path_rule_matches_jax(card, nbins, depth, F):
    is_cat = [False] * F
    if card:
        is_cat[-1] = True
    X = np.zeros((8, F), np.float32)
    js, ts = _specs(X, is_cat, card)
    params = {"nbins": nbins, "nbins_cats": 1024}
    ub = jtree.packed_bins_upper_bound(js, params)
    assert ttree.packed_bins_upper_bound(ts, params) == ub
    assert ttree.binned_feasible(ub, F, depth) == \
        jtree.binned_feasible(ub, F, depth)
    assert ttree._adaptive_n_bins_eff(ts, params) == \
        jtree._adaptive_n_bins_eff(js, params)
    assert ttree.adaptive_feasible(ts, params, depth) == \
        jtree.adaptive_feasible(js, params, depth)
    assert ttree.ADAPTIVE_HIST_TYPES == jtree.ADAPTIVE_HIST_TYPES
