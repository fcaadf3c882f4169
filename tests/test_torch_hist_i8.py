"""Parity of the port's int8 fixed-point histogram path (H2O3_HIST_I8)
with the JAX package: ``quantize_ghw_i8`` bit for bit, the plain int8
levels (K4 packed, K7 adaptive) against the TPU kernels run in
interpret mode, the plain leaf totals (K10) against ``leaf_totals_xla``
and ``leaf_totals_tpu``, and both growers under the switch against the
JAX growers in interpret mode. Integer sums leave no room for order, so
nid and histograms are compared bit for bit. The CUDA kernels are held
against the plain versions in tests/test_torch_kernels.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th2o
from h2o3_tpu.models import tree as jtree
from h2o3_tpu.ops import hist_adaptive as jha
from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
from h2o3_tpu_torch.models import tree as ttree
from h2o3_tpu_torch.ops import hist_adaptive as tha
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

ROWS = 3072          # a multiple of the interpret-mode tile (1024)


def _ghw(rng, rows):
    g = rng.normal(size=rows).astype(np.float32)
    h = (rng.random(rows) * 0.25).astype(np.float32)
    w = np.ones(rows, np.float32)
    w[rng.random(rows) < 0.1] = 0.0
    return np.stack([g * w, h * w, w])


def _quantize_case(case, terms, seed=0):
    """(g, h, w) rows for one quantisation case."""
    rng = np.random.default_rng(seed)
    ghw = _ghw(rng, 2000)
    if case == "half_ties":
        # amax = 127 (or 32639) makes s exactly 1: every k + 0.5 is a tie
        top = 127 if terms == 1 else 32639
        k = rng.integers(-top, top, size=(3, 2000)).astype(np.float32)
        ghw = k + 0.5
        ghw[:, 0] = top
    elif case == "zero_component":
        ghw[1] = 0.0                           # amax floors at 1e-30
    elif case == "at_amax":
        amax = np.abs(ghw).max(axis=1, keepdims=True)
        ghw[:, :50] = amax
        ghw[:, 50:100] = -amax
    return ghw


@pytest.mark.parametrize("terms", [1, 2])
@pytest.mark.parametrize("case", ["random", "half_ties", "zero_component",
                                  "at_amax"])
def test_quantize_ghw_i8_bit_equal_to_jax(terms, case):
    ghw = _quantize_case(case, terms)
    qt, st = tha.quantize_ghw_i8(torch.as_tensor(ghw), terms)
    qj, sj = jha.quantize_ghw_i8(jnp.asarray(ghw), terms=terms)
    assert qt.dtype == torch.int8 and qt.shape == (3 * terms, ghw.shape[1])
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy().view(np.int32),
                                  np.asarray(sj).view(np.int32))
    if case == "half_ties" and terms == 1:
        # round half to even: 0.5 -> 0, 1.5 -> 2
        q = tha.quantize_ghw_i8(torch.tensor([[127.0, 0.5, 1.5, -2.5]] * 3))[0]
        assert q[0].tolist() == [127, 0, 2, -2]


def _level_inputs(W, N, seed, F=6):
    """Codes (NA = W-1; int8, int16 at W = 256), raw features (NaN) with
    per-node ranges, nid in
    the previous level's window with 5% of the rows outside every window,
    float (g, h, w) and both kinds of split tables."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, W - 1, size=(ROWS, F)).astype(
        np.int16 if W > 128 else np.int8)
    codes[rng.random((ROWS, F)) < 0.07] = W - 1
    x = rng.normal(size=(ROWS, F)).astype(np.float32)
    x[rng.random((ROWS, F)) < 0.06] = np.nan
    n_prev, base = N // 2, N - 1
    m = max(n_prev, 1)
    nid = (base - n_prev + rng.integers(0, m, ROWS)).astype(np.int32)
    nid[rng.random(ROWS) < 0.05] = base + N + 7
    ghw = _ghw(rng, ROWS)
    feat = rng.integers(0, F, m).astype(np.float32)
    nal = (rng.random(m) < 0.5).astype(np.float32)
    can = (rng.random(m) < 0.8).astype(np.float32)
    btab = (feat, rng.integers(1, W - 1, m).astype(np.float32), nal, can)
    atab = (feat, rng.normal(size=m).astype(np.float32), nal, can)
    lo = (rng.normal(size=(N, F)) - 3).astype(np.float32)
    inv = np.full((N, F), (W - 2) / 6.0, np.float32)
    return codes, x, nid, ghw, btab, atab, lo, inv, n_prev, base


@pytest.mark.parametrize("W", [16, 32, 64, 256])
@pytest.mark.parametrize("terms", [1, 2])
@pytest.mark.parametrize("N", [1, 8])
def test_binned_level_i8_plain_matches_pallas_interpret(W, terms, N):
    codes, _x, nid, ghw, btab, _a, _lo, _inv, n_prev, base = _level_inputs(
        W, N, seed=W + 10 * terms + N)
    qj, sj = jha.quantize_ghw_i8(jnp.asarray(ghw), terms=terms)
    nid_p, hist_p = jha.binned_level_tpu_i8(
        jnp.asarray(codes.T.copy()), jnp.asarray(nid), qj, sj,
        tuple(jnp.asarray(t) for t in btab), n_prev, N, base, W, tile=1024,
        interpret=True)
    q, s = tha.quantize_ghw_i8(torch.as_tensor(ghw), terms)
    tables = tha.make_tables(*(torch.as_tensor(t) for t in btab))
    nid_t, hist_t = tha.binned_level_i8_plain(
        torch.as_tensor(codes), torch.as_tensor(nid), q, s, tables, n_prev,
        N, base, W)
    np.testing.assert_array_equal(nid_t.numpy(), np.asarray(nid_p))
    assert hist_t.dtype == torch.float32
    np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_p))
    # the dispatcher takes the same plain version for a CPU tensor
    nid_d, hist_d = tha.binned_level(
        torch.as_tensor(codes), torch.as_tensor(nid),
        torch.as_tensor(ghw), tables, n_prev, N, base, W, True, (q, s))
    assert torch.equal(nid_d, nid_t) and torch.equal(hist_d, hist_t)


@pytest.mark.parametrize("W", [16, 32, 64, 256])
@pytest.mark.parametrize("terms", [1, 2])
@pytest.mark.parametrize("N", [1, 8])
def test_adaptive_level_i8_plain_matches_pallas_interpret(W, terms, N):
    """K7 exists only in [F, rows]; the port's plain version serves both
    layouts and must give the same bits in each."""
    _c, x, nid, ghw, _b, atab, lo, inv, n_prev, base = _level_inputs(
        W, N, seed=100 + W + 10 * terms + N)
    qj, sj = jha.quantize_ghw_i8(jnp.asarray(ghw), terms=terms)
    nid_p, hist_p = jha.adaptive_level_tpu_i8(
        jnp.asarray(x.T.copy()), jnp.asarray(nid), qj, sj,
        tuple(jnp.asarray(t) for t in atab), jnp.asarray(lo),
        jnp.asarray(inv), n_prev, N, base, W, tile=1024, interpret=True)
    q, s = tha.quantize_ghw_i8(torch.as_tensor(ghw), terms)
    tables = tha.make_adaptive_tables(*(torch.as_tensor(t) for t in atab))
    for layout in tha.LAYOUTS:
        xt = torch.as_tensor(x if layout == "rows_f" else x.T.copy())
        nid_t, hist_t = tha.adaptive_level_i8_plain(
            xt, torch.as_tensor(nid), q, s, tables, torch.as_tensor(lo),
            torch.as_tensor(inv), n_prev, N, base, W, layout)
        np.testing.assert_array_equal(nid_t.numpy(), np.asarray(nid_p))
        np.testing.assert_array_equal(hist_t.numpy(), np.asarray(hist_p))


def test_i8_gate_per_level():
    """3·terms·N <= 128 at bf16 takes the int8 level; past it, or at
    float32 histograms, the float level (the JAX dispatchers' rule)."""
    codes, _x, nid, ghw, btab, _a, _lo, _inv, _p, _b = _level_inputs(16, 1, 3)
    tables = tha.make_tables(*(torch.as_tensor(t) for t in btab))
    args = (torch.as_tensor(codes), torch.zeros(ROWS, dtype=torch.int32),
            torch.as_tensor(ghw), tables[:, :1].contiguous(), 0)
    q2 = tha.quantize_ghw_i8(args[2], 2)
    _n, h_i8 = tha.binned_level(*args, 1, 0, 16, True, q2)
    _n, h_bf = tha.binned_level(*args, 1, 0, 16, True)
    _n, h_f32 = tha.binned_level(*args, 1, 0, 16, False, q2)
    assert not torch.equal(h_i8, h_bf)
    assert torch.equal(h_f32, tha.binned_level(*args, 1, 0, 16, False)[1])
    assert tha.takes_i8(q2, 21, True) and not tha.takes_i8(q2, 22, True)
    q1 = tha.quantize_ghw_i8(args[2], 1)
    assert tha.takes_i8(q1, 42, True) and not tha.takes_i8(q1, 43, True)
    assert not tha.takes_i8(q1, 1, False) and not tha.takes_i8(None, 1, True)


@pytest.mark.parametrize("n_prev,N", [(0, 1), (4, 8), (32, 64)])
def test_leaf_totals_plain_matches_jax(n_prev, N):
    _c, x, nid, ghw, _b, atab, _lo, _inv, _p, base = _level_inputs(
        16, N, seed=7 + N)
    # K10 routes the level before the window [base, base + N)
    nid_j = jnp.asarray(nid)
    tab_j = tuple(jnp.asarray(t) for t in atab)
    nid_x, tot_x = jha.leaf_totals_xla(jnp.asarray(x), nid_j,
                                       jnp.asarray(ghw), tab_j, n_prev, N,
                                       base)
    nid_p, tot_p = jha.leaf_totals_tpu(jnp.asarray(x), nid_j,
                                       jnp.asarray(ghw), tab_j, n_prev, N,
                                       base, tile=1024, interpret=True)
    tables = tha.make_adaptive_tables(*(torch.as_tensor(t) for t in atab))
    nid_t, tot_t = tha.leaf_totals(torch.as_tensor(x), torch.as_tensor(nid),
                                   torch.as_tensor(ghw), tables, n_prev, N,
                                   base)
    assert tot_t.shape == (3, N) and tot_t.dtype == torch.float32
    np.testing.assert_array_equal(nid_t.numpy(), np.asarray(nid_x))
    np.testing.assert_array_equal(nid_t.numpy(), np.asarray(nid_p))
    # float32 sums in other orders
    np.testing.assert_allclose(tot_t.numpy(), np.asarray(tot_x), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tot_t.numpy(), np.asarray(tot_p), rtol=1e-6,
                               atol=1e-6)
    assert float(tot_t[2].sum()) > 0


# ------------------------------------------------------------- growers


def _grow_inputs(rows=3000, F=6, W=16, seed=0, w_anchor=False):
    """Codes (int8, int16 at W = 256) and raw features of one frame with a
    signal, and bernoulli
    (g, h, w) with 10% zero weights. g and h lie on a 2^-15 (2^-17) grid
    below 2^-4 (2^-8), but for one row each at 32639 quanta (= 127 x
    257): the int8 scales are then 2^-15 (2^-17) at two terms and 257
    quanta at one, and every histogram sum, int8 or bf16, is exact in any
    order. Candidates that split off the same rows then tie exactly in
    both packages, as the float32 parity tests make them tie. With
    ``w_anchor`` the weights are exact too: row 1 (g = h = 0) weighs 32639
    x 2^-14, so the w scale is 2^-14 at two terms and 257 x 2^-14 at one,
    and the split search's cumulative weight sums (the children's node_w)
    do not depend on their order either (the int8 levels' sums; no bf16
    level may run then, where that row's weight would round)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, F)).astype(np.float32)
    X[rng.random((rows, F)) < 0.05] = np.nan
    edges = np.linspace(-2.5, 2.5, W - 3)
    codes = np.where(np.isnan(X), W - 1,
                     np.digitize(np.nan_to_num(X), edges)).astype(
        np.int16 if W > 128 else np.int8)
    signal = np.nan_to_num(X[:, 0]) - 0.5 * np.nan_to_num(X[:, 1]) \
        + 0.5 * rng.normal(size=rows)
    p = 1.0 / (1.0 + np.exp(-signal))
    g = np.round((p - (rng.random(rows) < p)) * 2.0 ** 11) * 2.0 ** -15
    h = np.maximum(np.round(p * (1 - p) * 2.0 ** 11), 1) * 2.0 ** -17
    g[0], h[0] = 32639 * 2.0 ** -15, 32639 * 2.0 ** -17
    w = np.ones(rows, np.float32)
    w[1:][rng.random(rows - 1) < 0.1] = 0.0
    if w_anchor:
        g[1], h[1], w[1] = 0.0, 0.0, 32639 * 2.0 ** -14
    return (codes, X, (g * w).astype(np.float32), (h * w).astype(np.float32),
            w)


def _assert_same_tree(tt, tnid, jt, jnid, split_key):
    for k in ("feat", split_key, "na_left", "is_split"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(tnid.numpy(), np.asarray(jnid))
    for k in ("value", "node_w"):
        np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def _count(monkeypatch, module, name, arg):
    """Wrap ``module.name`` so that each call records its argument
    ``arg`` (a level's node count); returns the record."""
    calls = []
    fn = getattr(module, name)

    def counted(*a, **k):
        calls.append(a[arg])
        return fn(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.fixture
def interpret(monkeypatch):
    """The JAX growers' TPU path in interpret mode (the switch is read
    when they trace); the stripe probe left out, so that the float level
    at N = 32 of a two-term tree is K1's."""
    monkeypatch.setenv("H2O3_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("H2O3_STRIPE", "0")


@pytest.mark.parametrize("terms", [1, 2])
def test_grow_tree_binned_i8_matches_jax(interpret, monkeypatch, terms):
    """Depth 6: at two terms the N = 32 level (3·2·32 > 128) takes the
    float bf16 level in both packages. The JAX grower runs compiled
    through a fresh function, so that its trace reads this test's
    switch."""
    monkeypatch.setenv("H2O3_HIST_I8", str(terms))
    codes, _X, g, h, w = _grow_inputs(seed=terms)
    F = codes.shape[1]
    kw = dict(max_depth=6, n_bins=14, n_features=F, min_rows=1.0,
              histogram_precision="bfloat16")
    jcalls = _count(monkeypatch, jha, "binned_level_tpu_i8", 6)
    grow = jax.jit(lambda *a: jtree.grow_tree_binned(*a),
                   static_argnums=(4,))
    jt, jnid = grow(
        jnp.asarray(codes), jnp.asarray(g), jnp.asarray(h), jnp.asarray(w),
        jtree.TreeConfig(**kw), jnp.ones(F, bool))
    assert jcalls == ([1, 2, 4, 8, 16, 32] if terms == 1
                      else [1, 2, 4, 8, 16])
    calls = _count(monkeypatch, tha, "binned_level_i8_plain", 6)
    tt, tnid = ttree.grow_tree_binned(
        torch.as_tensor(codes), torch.as_tensor(g), torch.as_tensor(h),
        torch.as_tensor(w), ttree.TreeConfig(**kw))
    assert calls == ([1, 2, 4, 8, 16, 32] if terms == 1
                     else [1, 2, 4, 8, 16])
    _assert_same_tree(tt, tnid, jt, jnid, "split_bin")
    assert bool(tt["is_split"][31:].any())


@pytest.mark.parametrize("terms", [1, 2])
def test_grow_tree_adaptive_i8_matches_jax(interpret, monkeypatch, terms):
    """The JAX grower with hist_method='pallas' takes K7 on [F, rows]; the
    port's grower takes its int8 level in either layout. The JAX grower
    runs compiled, as its trainer runs it (range updates as fused
    multiply-adds), through a fresh function so that the trace reads
    this test's switch."""
    monkeypatch.setenv("H2O3_HIST_I8", str(terms))
    _c, X, g, h, w = _grow_inputs(seed=10 + terms)
    F = X.shape[1]
    kw = dict(max_depth=4, n_bins=20, n_features=F, min_rows=1.0,
              histogram_precision="bfloat16")
    lo = np.nanmin(X, axis=0)
    hi = np.nanmax(X, axis=0)
    nb_f = np.full(F, 20.0, np.float32)
    jcalls = _count(monkeypatch, jha, "adaptive_level_tpu_i8", 8)
    grow = jax.jit(lambda *a, **k: jtree.grow_tree_adaptive(*a, **k),
                   static_argnums=(4,))
    jt, jnid = grow(jnp.asarray(X), jnp.asarray(g), jnp.asarray(h),
                    jnp.asarray(w),
                    jtree.TreeConfig(hist_method="pallas", **kw),
                    jnp.ones(F, bool), jnp.asarray(lo), jnp.asarray(hi),
                    nb_f=jnp.asarray(nb_f))
    calls = _count(monkeypatch, tha, "adaptive_level_i8_plain", 8)
    assert jcalls == [1, 2, 4, 8]
    for layout in tha.LAYOUTS:
        calls.clear()
        x = torch.as_tensor(X if layout == "rows_f" else X.T.copy())
        tt, tnid = ttree.grow_tree_adaptive(
            x, torch.as_tensor(g), torch.as_tensor(h), torch.as_tensor(w),
            ttree.TreeConfig(**kw), torch.as_tensor(lo), torch.as_tensor(hi),
            nb_f=torch.as_tensor(nb_f), layout=layout)
        assert calls == [1, 2, 4, 8]
        _assert_same_tree(tt, tnid, jt, jnid, "thr")


@pytest.mark.parametrize("terms", [1, 2])
def test_grow_tree_binned_i8_wide_matches_jax(interpret, monkeypatch, terms):
    """The packed grower at nbins 254 (W = 256, int16 codes), XGBoost's
    max_bins 256 shape, depth 6, against the JAX grower in interpret mode:
    the same int8 level calls per level and the same tree."""
    monkeypatch.setenv("H2O3_HIST_I8", str(terms))
    codes, _X, g, h, w = _grow_inputs(W=256, seed=30 + terms)
    assert codes.dtype == np.int16
    F = codes.shape[1]
    kw = dict(max_depth=6, n_bins=254, n_features=F, min_rows=1.0,
              histogram_precision="bfloat16")
    levels = [1, 2, 4, 8, 16, 32] if terms == 1 else [1, 2, 4, 8, 16]
    jcalls = _count(monkeypatch, jha, "binned_level_tpu_i8", 6)
    grow = jax.jit(lambda *a: jtree.grow_tree_binned(*a),
                   static_argnums=(4,))
    jt, jnid = grow(
        jnp.asarray(codes), jnp.asarray(g), jnp.asarray(h), jnp.asarray(w),
        jtree.TreeConfig(**kw), jnp.ones(F, bool))
    assert jcalls == levels
    calls = _count(monkeypatch, tha, "binned_level_i8_plain", 6)
    tt, tnid = ttree.grow_tree_binned(
        torch.as_tensor(codes), torch.as_tensor(g), torch.as_tensor(h),
        torch.as_tensor(w), ttree.TreeConfig(**kw))
    assert calls == levels
    _assert_same_tree(tt, tnid, jt, jnid, "split_bin")
    assert bool(tt["is_split"][31:].any())


@pytest.mark.parametrize("terms", [1, 2])
def test_grow_tree_adaptive_i8_wide_matches_jax(interpret, monkeypatch,
                                                terms):
    """The adaptive grower at nbins 62 (W = 64), XGBoost's
    tree_method="auto" shape, against the JAX grower (K7 in interpret
    mode), in both layouts: the same int8 level calls and the same
    tree."""
    monkeypatch.setenv("H2O3_HIST_I8", str(terms))
    # every level (N <= 16) takes the int8 level at both terms
    _c, X, g, h, w = _grow_inputs(seed=40 + terms, w_anchor=True)
    F = X.shape[1]
    kw = dict(max_depth=5, n_bins=62, n_features=F, min_rows=1.0,
              histogram_precision="bfloat16")
    lo = np.nanmin(X, axis=0)
    hi = np.nanmax(X, axis=0)
    nb_f = np.full(F, 62.0, np.float32)
    jcalls = _count(monkeypatch, jha, "adaptive_level_tpu_i8", 8)
    grow = jax.jit(lambda *a, **k: jtree.grow_tree_adaptive(*a, **k),
                   static_argnums=(4,))
    jt, jnid = grow(jnp.asarray(X), jnp.asarray(g), jnp.asarray(h),
                    jnp.asarray(w),
                    jtree.TreeConfig(hist_method="pallas", **kw),
                    jnp.ones(F, bool), jnp.asarray(lo), jnp.asarray(hi),
                    nb_f=jnp.asarray(nb_f))
    assert jcalls == [1, 2, 4, 8, 16]
    calls = _count(monkeypatch, tha, "adaptive_level_i8_plain", 8)
    for layout in tha.LAYOUTS:
        calls.clear()
        x = torch.as_tensor(X if layout == "rows_f" else X.T.copy())
        tt, tnid = ttree.grow_tree_adaptive(
            x, torch.as_tensor(g), torch.as_tensor(h), torch.as_tensor(w),
            ttree.TreeConfig(**kw), torch.as_tensor(lo), torch.as_tensor(hi),
            nb_f=torch.as_tensor(nb_f), layout=layout)
        assert calls == [1, 2, 4, 8, 16]
        _assert_same_tree(tt, tnid, jt, jnid, "thr")
    assert bool(tt["is_split"][15:].any())


def test_growers_ignore_the_switch_at_float32(monkeypatch):
    """The gates: float32 histograms (and more than 16M rows, by the
    same rule) keep the float levels."""
    monkeypatch.setenv("H2O3_HIST_I8", "1")
    codes, _X, g, h, w = _grow_inputs(rows=600)
    assert ttree._hist_i8(torch.as_tensor(np.stack([g, h, w])), False,
                          600) is None
    assert ttree._hist_i8(torch.as_tensor(np.stack([g, h, w])), True,
                          tha.I8_MAX_ROWS + 1) is None
    monkeypatch.setattr(tha, "binned_level_i8_plain", None)
    cfg = ttree.TreeConfig(max_depth=3, n_bins=14, n_features=6,
                           min_rows=1.0, histogram_precision="float32")
    tt, _ = ttree.grow_tree_binned(torch.as_tensor(codes),
                                   torch.as_tensor(g), torch.as_tensor(h),
                                   torch.as_tensor(w), cfg)
    assert bool(tt["is_split"].any())
    monkeypatch.setenv("H2O3_HIST_I8", "0")
    assert ttree._hist_i8(torch.as_tensor(np.stack([g, h, w])), True,
                          600) is None


@pytest.mark.parametrize("params,plain", [
    (dict(nbins=14, histogram_type="quantiles_global"),
     "binned_level_i8_plain"),
    (dict(nbins=20, packed_codes=False), "adaptive_level_i8_plain")])
def test_gbm_takes_the_i8_levels(monkeypatch, params, plain):
    """A port GBM on the CPU with the switch set trains through the int8
    levels (every level at one term, depth 4: 4 a tree) to an AUC within
    0.01 of the same bf16 train without it."""
    _c, X, _g, _h, _w = _grow_inputs(rows=4000, seed=21)
    y = (np.nan_to_num(X[:, 0]) - 0.5 * np.nan_to_num(X[:, 1])
         + np.random.default_rng(1).normal(size=4000) > 0)
    cols = {f"f{i}": X[:, i] for i in range(X.shape[1])}
    cols["label"] = y.astype(np.float32)
    fr = th2o.Frame.from_numpy(cols, device="cpu")

    def fit():
        return H2OGradientBoostingEstimator(
            ntrees=4, max_depth=4, distribution="bernoulli", seed=7,
            histogram_precision="bfloat16", **params).train(
            y="label", training_frame=fr).model

    base = fit()
    calls = _count(monkeypatch, tha, plain, 1)
    monkeypatch.setenv("H2O3_HIST_I8", "1")
    m = fit()
    assert len(calls) == 4 * 4
    auc, auc0 = m.training_metrics.auc, base.training_metrics.auc
    assert np.isfinite(auc) and auc > 0.5
    assert abs(auc - auc0) <= 0.01
