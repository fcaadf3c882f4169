"""Parity of the port's tree machinery (h2o3_tpu_torch.models.tree) with
the JAX package: split search, the binned grower at float32 histograms,
and both tree walks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.models import tree as jtree
from h2o3_tpu_torch.models import tree as ttree
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)


def _cfgs(**kw):
    return jtree.TreeConfig(**kw), ttree.TreeConfig(**kw)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_bin", [None, 12])
def test_find_splits_matches_jax(seed, max_bin):
    rng = np.random.default_rng(seed)
    N, F, W = 4, 5, 16
    g = rng.normal(size=(N, F, W)).astype(np.float32)
    h = rng.uniform(0.1, 1.0, size=(N, F, W)).astype(np.float32)
    w = rng.integers(1, 9, size=(N, F, W)).astype(np.float32)
    # every feature of a node sums to the same totals, like a histogram
    for arr in (g, h, w):
        arr[:, 1:, -1] += arr[:, :1, :].sum(-1) - arr[:, 1:, :].sum(-1)
    w[:, :, -1] = np.abs(w[:, :, -1])
    mask = np.ones(F, bool)
    mask[3] = False
    jc, tc = _cfgs(max_depth=3, n_bins=W - 1, n_features=F, min_rows=2.0,
                   reg_lambda=0.5)
    js = jtree._find_splits(tuple(jnp.asarray(a) for a in (g, h, w)), jc,
                            jnp.asarray(mask), max_bin=max_bin)
    ts = ttree._find_splits(tuple(torch.as_tensor(a) for a in (g, h, w)),
                            tc, torch.as_tensor(mask), max_bin=max_bin)
    for i in (1, 2, 3):          # feat, bin, na_left
        np.testing.assert_array_equal(ts[i].numpy(), np.asarray(js[i]))
    for i in (0, 4, 5, 6, 7, 8, 9, 10):
        np.testing.assert_allclose(ts[i].numpy(), np.asarray(js[i]),
                                   rtol=1e-5, atol=1e-6)


def _grow_inputs(rows=3000, F=6, W=16, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, W - 2, size=(rows, F)).astype(np.int8)
    codes[rng.random((rows, F)) < 0.05] = W - 1
    signal = codes[:, 0].astype(np.float32) - 0.5 * codes[:, 1] \
        + rng.normal(size=rows).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-0.3 * signal))
    g = (p - (rng.random(rows) < p)).astype(np.float32)
    h = np.maximum(p * (1 - p), 1e-9).astype(np.float32)
    w = np.ones(rows, np.float32)
    w[rng.random(rows) < 0.1] = 0.0
    return codes, g * w, h * w, w


@pytest.mark.parametrize("depth", [1, 3])
def test_grow_tree_binned_matches_jax(depth):
    codes, g, h, w = _grow_inputs(seed=depth)
    F = codes.shape[1]
    kw = dict(max_depth=depth, n_bins=14, n_features=F, min_rows=1.0,
              histogram_precision="float32")
    jc, tc = _cfgs(**kw)
    jt, jnid = jtree.grow_tree_binned(
        jnp.asarray(codes), jnp.asarray(g), jnp.asarray(h), jnp.asarray(w),
        jc, jnp.ones(F, bool))
    tt, tnid = ttree.grow_tree_binned(
        torch.as_tensor(codes), torch.as_tensor(g), torch.as_tensor(h),
        torch.as_tensor(w), tc)
    for k in ("feat", "split_bin", "na_left", "is_split"):
        np.testing.assert_array_equal(tt[k].numpy(), np.asarray(jt[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(tnid.numpy(), np.asarray(jnid))
    for k in ("value", "node_w", "gain"):
        np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_predict_binned_and_raw_stacked_match_jax():
    depth = 3
    codes, g, h, w = _grow_inputs(seed=7)
    F = codes.shape[1]
    jc, tc = _cfgs(max_depth=depth, n_bins=14, n_features=F, min_rows=1.0,
                   histogram_precision="float32")
    jt, _ = jtree.grow_tree_binned(
        jnp.asarray(codes), jnp.asarray(g), jnp.asarray(h), jnp.asarray(w),
        jc, jnp.ones(F, bool))
    tree_t = {k: torch.as_tensor(np.array(v)) for k, v in jt.items()}
    v_t, n_t = ttree.predict_binned(torch.as_tensor(codes), tree_t, depth, 15)
    v_j, n_j = jtree.predict_binned(jnp.asarray(codes), jt, depth, 15)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))

    # raw-threshold walk over two trees on raw features with NaN
    rng = np.random.default_rng(3)
    edges = [np.sort(rng.normal(size=13)).astype(np.float32)
             for _ in range(F)]
    sb = np.stack([np.asarray(jt["split_bin"])] * 2)
    feat = np.stack([np.asarray(jt["feat"])] * 2)
    thr = jtree.bins_to_thresholds_stacked(sb, feat, edges)
    np.testing.assert_array_equal(
        ttree.bins_to_thresholds_stacked(sb, feat, edges), thr)
    nal = np.stack([np.asarray(jt["na_left"])] * 2)
    spl = np.stack([np.asarray(jt["is_split"])] * 2)
    val = np.stack([np.asarray(jt["value"]), -np.asarray(jt["value"])])
    X = rng.normal(size=(500, F)).astype(np.float32)
    X[rng.random(X.shape) < 0.1] = np.nan
    want = jtree.predict_raw_stacked(jnp.asarray(X), jnp.asarray(feat),
                                     jnp.asarray(thr), jnp.asarray(nal),
                                     jnp.asarray(spl), jnp.asarray(val),
                                     depth)
    want = np.asarray(want)
    for t in range(2):
        got, _ = ttree.predict_raw_tree(
            torch.as_tensor(X),
            {"feat": torch.as_tensor(feat[t]).long(),
             "thr": torch.as_tensor(thr[t]),
             "na_left": torch.as_tensor(nal[t]),
             "is_split": torch.as_tensor(spl[t]),
             "value": torch.as_tensor(val[t])}, depth)
        np.testing.assert_array_equal(got.numpy(), want[:, t])
    # the margin: f0 and the trees' values added in tree order, float32
    f0 = np.float32(0.375)
    margin = ttree.predict_raw_margin(
        torch.as_tensor(X), torch.tensor(f0), torch.as_tensor(feat).long(),
        torch.as_tensor(thr), torch.as_tensor(nal), torch.as_tensor(spl),
        torch.as_tensor(val), depth)
    np.testing.assert_array_equal(margin.numpy(),
                                  (f0 + want[:, 0]) + want[:, 1])


def test_segment_totals_sum_per_leaf():
    # level base 3: the rows' nodes 3, 5, 5 and 4, and one row (node 1)
    # off the level's window
    nid = torch.tensor([3, 5, 1, 4, 3], dtype=torch.int32)
    g = torch.tensor([1.0, 2.0, 4.0, 8.0, 16.0])
    gs, hs, ws = ttree._segment_totals(nid, torch.stack([g, g * 2, g * 3]),
                                       4, 3)
    assert gs.tolist() == [17.0, 8.0, 2.0, 0.0]
    assert hs.tolist() == [34.0, 16.0, 4.0, 0.0]
    assert ws.tolist() == [51.0, 24.0, 6.0, 0.0]


@pytest.mark.parametrize(
    "n_seg,case",
    [pytest.param(n, "spread", id=str(n)) for n in (1, 64, 512, 4096)] +
    # the kernel's edges: a row count that is not a multiple of 4, and one
    # leaf that holds every row
    [pytest.param(1, "odd_rows", id="1-odd_rows"),
     pytest.param(64, "odd_rows", id="64-odd_rows"),
     pytest.param(1, "one_node", id="1-one_node"),
     pytest.param(64, "one_node", id="64-one_node"),
     pytest.param(4096, "one_node", id="4096-one_node")])
@pytest.mark.parametrize("int_ghw", [True, False])
def test_segment_totals_plain_matches_jax(n_seg, case, int_ghw):
    """The deepest level's per-leaf sums (the plain version of the
    segment-totals kernel) against the JAX package's ``_segment_totals``
    (a one-hot product up to 256 leaves, a scatter beyond): bit-equal on
    integer masses, within 1e-6 of each leaf's absolute mass on floats."""
    from h2o3_tpu.models.tree import _segment_totals as jax_totals
    from h2o3_tpu_torch.ops.common import segment_totals_plain
    rng = np.random.default_rng(n_seg)
    rows, base = (20_003 if case == "odd_rows" else 20_000), n_seg - 1
    nid = (base + rng.integers(0, n_seg, rows)).astype(np.int32)
    if case == "one_node":
        nid[:] = base + n_seg // 2
    else:
        nid[rng.random(rows) < 0.05] = base - 1   # off the deepest level
    if int_ghw:
        ghw = np.stack([rng.integers(-8, 9, rows), rng.integers(0, 4, rows),
                        rng.integers(0, 2, rows)]).astype(np.float32)
    else:
        ghw = np.stack([rng.normal(size=rows), rng.random(rows) * 0.25,
                        np.ones(rows)]).astype(np.float32)
    got = segment_totals_plain(torch.as_tensor(nid), torch.as_tensor(ghw),
                               n_seg, base).numpy()
    local = nid - base
    valid = (local >= 0) & (local < n_seg)
    want = np.stack([np.asarray(a) for a in jax_totals(
        jnp.asarray(np.clip(local, 0, n_seg - 1)), jnp.asarray(valid),
        *(jnp.asarray(v) for v in ghw), n_seg)])
    assert got.dtype == np.float32 and got.shape == (3, n_seg)
    if int_ghw:
        np.testing.assert_array_equal(got, want)
    else:
        mass = np.stack([np.bincount(local[valid], np.abs(v[valid]),
                                     minlength=n_seg) for v in ghw])
        # one leaf of 20,000 rows: the plain version's float32 bincount
        # adds them in row order, the JAX one-hot product in blocks, so
        # each can be off the float64 sum by up to ~1e-5 of the mass; a
        # few hundred rows a leaf stay within 1e-6
        rel = 1e-5 if case == "one_node" else 1e-6
        assert (np.abs(got.astype(np.float64) - want) <= rel * mass).all()


def test_find_splits_one_node_one_feature_matches_jax():
    """A histogram that is one scan long (one node, one feature: the root
    of a one-feature frame) takes the fixed-order scan path."""
    rng = np.random.default_rng(4)
    W = 16
    trip = (rng.normal(size=(1, 1, W)).astype(np.float32),
            rng.uniform(0.1, 1.0, size=(1, 1, W)).astype(np.float32),
            rng.integers(1, 9, size=(1, 1, W)).astype(np.float32))
    jc, tc = _cfgs(max_depth=2, n_bins=W - 1, n_features=1, min_rows=1.0)
    js = jtree._find_splits(tuple(jnp.asarray(a) for a in trip), jc,
                            jnp.ones(1, bool))
    ts = ttree._find_splits(tuple(torch.as_tensor(a) for a in trip), tc,
                            torch.ones(1, dtype=torch.bool))
    for i in (1, 2, 3):
        np.testing.assert_array_equal(ts[i].numpy(), np.asarray(js[i]))
    for i in (0, 4, 5, 6, 7, 8, 9, 10):
        np.testing.assert_allclose(ts[i].numpy(), np.asarray(js[i]),
                                   rtol=1e-5, atol=1e-6)
    x = torch.as_tensor(trip[0])
    assert torch.equal(ttree._cumsum_bins(x), torch.cumsum(x, dim=-1))
