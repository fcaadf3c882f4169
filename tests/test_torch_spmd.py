"""The port's sharded trains (ROADMAP item 14) against the JAX package's
meshes on the suite's eight virtual XLA devices, the port's meshes of
CPU shards:

- ``build_histograms_sharded`` against JAX's at (4, 1);
- packed, adaptive and global GBMs: (4, 1) trees equal to JAX (4, 1)
  trees at float32 histograms, values within 1e-5 (JAX's psum may add
  the shards in another order), the same ``output["spmd"]`` layout;
- (4, 2): predictions within 1e-5 of JAX (4, 2); the port's (4, 2)
  splits bit-equal to its (4, 1) ones, on ``_data(seed=23)`` of
  tests/test_spmd_parity.py too, where JAX's two layouts disagree;
- XGBoost at (4, 1): the trees of JAX's XGBoost on its (4, 1) mesh;
- a sampled GBM, a forest and a multinomial GBM at (8, 1) against JAX
  on its eight devices, tree for tree (each shard draws over its own
  rows with the row key folded by its index);
- ``grow_tree_spmd`` against JAX's on tests/test_tree_spmd.py's problem;
- an int8 level on four shards, each with its own scale, against the
  JAX kernel in interpret mode a shard, added in shard order.

Rows are not multiples of 8·n_data, so the pad rows are exercised.
Each JAX train runs once a module (``_jax``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu.models.drf import H2ORandomForestEstimator as JaxDRF
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as JaxGBM
from h2o3_tpu.models.xgboost import H2OXGBoostEstimator as JaxXGB
from h2o3_tpu.parallel import mesh as jm
from h2o3_tpu_torch.models import tree as ttree
from h2o3_tpu_torch.models.drf import H2ORandomForestEstimator as TorchDRF
from h2o3_tpu_torch.models.gbm import H2OGradientBoostingEstimator as TorchGBM
from h2o3_tpu_torch.models.xgboost import H2OXGBoostEstimator
from h2o3_tpu_torch.ops import hist_adaptive as tha
from h2o3_tpu_torch.parallel import collectives
from h2o3_tpu_torch.parallel import mesh as tm
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-virtual-device test mesh")

ROWS = 1003
BASE = dict(ntrees=3, max_depth=3, min_rows=1.0, distribution="bernoulli",
            histogram_precision="float32", seed=7, score_tree_interval=0,
            stopping_rounds=0)
PATHS = {
    "packed": dict(nbins=14, histogram_type="quantiles_global",
                   packed_codes=True),
    "adaptive": dict(nbins=20, packed_codes=False),
    "global": dict(nbins=14, histogram_type="quantiles_global",
                   packed_codes=False),
}


def _cols(seed=0, rows=ROWS, F=6, classes=None):
    """A logistic signal with NaNs (the tests/test_torch_gbm.py frame);
    ``classes`` cuts the logit into that many labels."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, F)).astype(np.float32)
    logit = X[:, 0] * 1.5 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
    u = rng.random(rows)
    X[rng.random(X.shape) < 0.03] = np.nan
    cols = {f"f{i}": X[:, i] for i in range(F)}
    if classes:
        cut = np.quantile(logit + rng.normal(size=rows), np.linspace(
            0, 1, classes + 1)[1:-1])
        cols["label"] = np.array([f"c{k}" for k in range(classes)],
                                 dtype=object)[np.searchsorted(cut, logit)]
    else:
        y = u < 1.0 / (1.0 + np.exp(-logit))
        cols["label"] = np.array(["no", "yes"], dtype=object)[y.astype(int)]
    return cols


def _spmd_parity_cols(seed):
    """tests/test_spmd_parity.py's ``_data``: an XOR of two features."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(1024, 6)).astype(np.float32)
    X[rng.random((1024, 6)) < 0.05] = np.nan
    y = ((np.nan_to_num(X[:, 0]) > 0)
         ^ (np.nan_to_num(X[:, 1]) > 0.3)).astype(int)
    cols = {f"f{i}": X[:, i] for i in range(6)}
    cols["label"] = np.array(["n", "y"], dtype=object)[y]
    return cols


def _train_jax(est, shape, cols, **params):
    old = jm._MESH
    jm.set_mesh(jm.make_mesh(n_data=shape[0], n_model=shape[1],
                             devices=jax.devices()[:shape[0] * shape[1]]))
    try:
        fr = jh2o.Frame.from_numpy(cols)
        return est(**params).train(y="label", training_frame=fr).model, fr
    finally:
        jm.set_mesh(old)


def _train_port(est, shape, cols, **params):
    old = tm._MESH
    tm.set_mesh(tm.make_mesh(n_data=shape[0], n_model=shape[1],
                             devices=["cpu"] * (shape[0] * shape[1])))
    try:
        fr = th2o.Frame.from_numpy(cols, device="cpu")
        return est(**params).train(y="label", training_frame=fr).model, fr
    finally:
        tm.set_mesh(old)


_JAX = {}


def _jax(name, est, shape, cols, **params):
    """One JAX train a module, by name."""
    if name not in _JAX:
        _JAX[name] = _train_jax(est, shape, cols, **params)
    return _JAX[name]


def _same_splits(a, b, err=""):
    for key in ("feat", "thr", "na_left", "is_split"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=err + key)


def _jax_trees(m):
    return {k: np.asarray(getattr(m, "_" + k))
            for k in ("feat", "thr", "na_left", "is_split", "value")}


def _spmd_layout(out):
    out = dict(out["spmd"])
    coll = out.pop("collective", None)
    return out, coll


@pytest.mark.parametrize("path", list(PATHS))
def test_gbm_41_trees_match_jax_41(path):
    cols = _cols(seed=1)
    params = dict(BASE, **PATHS[path])
    jmod, _ = _jax(f"gbm41_{path}", JaxGBM, (4, 1), cols, **params)
    tmod, _ = _train_port(TorchGBM, (4, 1), cols, **params)
    _same_splits(tmod.trees, _jax_trees(jmod))
    np.testing.assert_allclose(tmod.trees["value"], np.asarray(jmod._value),
                               rtol=1e-5, atol=1e-5)
    assert abs(tmod.training_metrics.auc - jmod.training_metrics.auc) < 1e-6
    layout, coll = _spmd_layout(tmod.output)
    assert layout == _spmd_layout(jmod.output)[0] == {
        "n_data": 4, "n_model": 1, "model_axis_split_search": False}
    assert coll["n_shards"] == 4 and coll["chunks_observed"] == 3 * 3
    assert 0.0 <= coll["collective_wait_share"] < 1.0


def test_gbm_42_predictions_match_jax_42():
    """After tests/test_spmd_parity.py:71-89: the (4, 2) mesh, data
    reduce and model-axis split search, predictions within 1e-5 of JAX's
    on the same mesh, the same layout record."""
    cols = _cols(seed=2)
    params = dict(BASE, **PATHS["packed"])
    jmod, jfr = _jax("gbm42", JaxGBM, (4, 2), cols, **params)
    tmod, tfr = _train_port(TorchGBM, (4, 2), cols, **params)
    np.testing.assert_allclose(tmod.predict(tfr).vec("pyes").to_numpy(),
                               jmod.predict(jfr).vec("pyes").to_numpy(),
                               rtol=0, atol=1e-5)
    layout, coll = _spmd_layout(tmod.output)
    assert layout == _spmd_layout(jmod.output)[0] == {
        "n_data": 4, "n_model": 2, "model_axis_split_search": True}
    assert coll["n_shards"] == 4


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("seed", [23, 11])
def test_port_42_splits_bit_equal_to_port_41(path, seed):
    """The model axis changes nothing in the port: the data sharding is
    the same, and the split search runs once over every feature on the
    reduced histogram whatever the model axis (the model shards of one
    process would search their blocks one after another on one device),
    so (4, 2) is (4, 1) bit for bit, values included, and the record
    says the model axis is there. Seed 23 is where JAX's layouts
    differ."""
    cols = _spmd_parity_cols(seed)
    params = dict(BASE, ntrees=5, max_depth=4, nbins=16, min_rows=2.0,
                  **{k: v for k, v in PATHS[path].items() if k != "nbins"})
    m41, _ = _train_port(TorchGBM, (4, 1), cols, **params)
    m42, _ = _train_port(TorchGBM, (4, 2), cols, **params)
    m24, _ = _train_port(TorchGBM, (4, 4), cols, **params)
    for other in (m42, m24):
        _same_splits(m41.trees, other.trees)
        np.testing.assert_array_equal(m41.trees["value"],
                                      other.trees["value"])
    assert m42.output["spmd"]["model_axis_split_search"]


def test_sampled_gbm_81_matches_jax_8_devices():
    cols = _cols(seed=3)
    params = dict(BASE, **PATHS["packed"], sample_rate=0.7,
                  col_sample_rate_per_tree=0.8)
    jmod, _ = _jax("sampled81", JaxGBM, (8, 1), cols, **params)
    tmod, _ = _train_port(TorchGBM, (8, 1), cols, **params)
    _same_splits(tmod.trees, _jax_trees(jmod))
    np.testing.assert_allclose(tmod.trees["value"], np.asarray(jmod._value),
                               rtol=1e-5, atol=1e-5)
    # the shard's fold changes the draw: the one-shard train differs
    one, _ = _train_port(TorchGBM, (1, 1), cols, **params)
    assert not np.array_equal(one.trees["thr"], tmod.trees["thr"])


def test_drf_81_matches_jax_8_devices():
    cols = _cols(seed=4)
    params = dict(ntrees=3, max_depth=4, seed=7, histogram_precision="float32",
                  nbins=14, histogram_type="quantiles_global")
    jmod, _ = _jax("drf81", JaxDRF, (8, 1), cols, packed_codes=True,
                   **params)
    tmod, _ = _train_port(TorchDRF, (8, 1), cols, **params)
    _same_splits(tmod.trees, _jax_trees(jmod))
    np.testing.assert_allclose(tmod.trees["value"], np.asarray(jmod._value),
                               rtol=1e-6, atol=1e-6)
    jt, tt = jmod.training_metrics, tmod.training_metrics
    assert tmod.output["oob_metrics"] and tt.nobs == jt.nobs < ROWS
    assert abs(tt.auc - jt.auc) <= 1e-6
    assert tmod.output["spmd"]["n_data"] == 8


def test_multinomial_81_matches_jax_8_devices():
    """After tests/test_gbm_sharded.py:113: an enum response of three
    classes through the sharded estimator, K trees an iteration."""
    cols = _cols(seed=6, classes=3)
    params = dict(BASE, **PATHS["packed"], ntrees=2)
    params["distribution"] = "multinomial"
    jmod, _ = _jax("multi81", JaxGBM, (8, 1), cols, **params)
    tmod, tfr = _train_port(TorchGBM, (8, 1), cols, **params)
    assert tmod.trees["feat"].shape[0] == 2 * 3
    _same_splits(tmod.trees, _jax_trees(jmod))
    np.testing.assert_allclose(tmod.trees["value"], np.asarray(jmod._value),
                               rtol=1e-5, atol=1e-5)
    assert abs(tmod.training_metrics.logloss
               - jmod.training_metrics.logloss) < 1e-5
    assert tmod.predict(tfr).vec("predict").domain == ("c0", "c1", "c2")


def test_xgboost_trains_on_the_mesh():
    """XGBoost is the GBM with a parameter map: it trains on the mesh by
    inheritance, to the trees of the JAX XGBoost on its (4, 1) mesh (the
    JAX side packs its codes on the CPU only when asked), its record
    that of a sharded train."""
    cols = _cols(seed=6)
    kw = dict(ntrees=3, max_depth=3, tree_method="hist", seed=7,
              distribution="bernoulli", histogram_precision="float32")
    jmod, _ = _jax("xgb41", JaxXGB, (4, 1), cols, packed_codes=True, **kw)
    m4, _ = _train_port(H2OXGBoostEstimator, (4, 1), cols, **kw)
    assert m4.n_bins == jmod.n_bins == 254
    assert bool(m4.trees["is_split"].any())
    _same_splits(m4.trees, _jax_trees(jmod))
    np.testing.assert_allclose(m4.trees["value"], np.asarray(jmod._value),
                               rtol=1e-5, atol=1e-5)
    assert abs(m4.training_metrics.auc - jmod.training_metrics.auc) < 1e-6
    assert _spmd_layout(m4.output)[0] == _spmd_layout(jmod.output)[0] == {
        "n_data": 4, "n_model": 1, "model_axis_split_search": False}
    m1, _ = _train_port(H2OXGBoostEstimator, (1, 1), cols, **kw)
    assert m1.output["spmd"] == {"n_data": 1, "n_model": 1,
                                 "model_axis_split_search": False}


def test_build_histograms_sharded_matches_jax_41():
    from h2o3_tpu.ops.histogram import build_histograms_sharded as jbuild
    from jax.sharding import Mesh
    from h2o3_tpu_torch.ops.histogram import build_histograms_sharded
    rng = np.random.default_rng(0)
    rows, F, B1 = 512, 8, 17
    codes = rng.integers(0, B1, (rows, F)).astype(np.int32)
    seg = rng.integers(-1, 4, rows).astype(np.int32)
    ghw = np.stack([rng.normal(size=rows), rng.random(rows),
                    np.ones(rows)]).astype(np.float32)
    jmesh = Mesh(np.array(jax.devices()[:4]), ("data",))
    jh = jbuild(jnp.asarray(codes), jnp.asarray(seg), jnp.asarray(ghw), 4,
                B1, jmesh, "scatter")
    per = rows // 4
    cut = [slice(s * per, (s + 1) * per) for s in range(4)]
    th = build_histograms_sharded(
        [torch.as_tensor(codes[c]) for c in cut],
        [torch.as_tensor(seg[c]) for c in cut],
        [torch.as_tensor(ghw[:, c]).contiguous() for c in cut], 4, B1,
        tm.make_mesh(n_data=4, devices=["cpu"] * 4))
    for a, b in zip(th, jh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_grow_tree_spmd_matches_jax():
    """tests/test_tree_spmd.py's problem on the (4, 2) mesh: nid bit-equal,
    the tree equal, and both equal to the unsharded ``grow_tree``."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from h2o3_tpu.models.tree import TreeConfig as JCfg
    from h2o3_tpu.models.tree import grow_tree_spmd as jgrow
    rng = np.random.default_rng(3)
    rows, F, nbins = 512, 8, 16
    codes = rng.integers(0, nbins, (rows, F)).astype(np.int32)
    logit = (codes[:, 0] > 8) * 2.0 + (codes[:, 3] > 4) * 1.0 - 1.5
    y = (rng.random(rows) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    g = (0.5 - y).astype(np.float32)
    h = np.full(rows, 0.25, np.float32)
    w = np.ones(rows, np.float32)
    jcfg = JCfg(max_depth=4, n_bins=nbins, n_features=F, min_rows=5.0,
                hist_method="scatter")
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2),
                ("data", "model"))
    f = jax.jit(jax.shard_map(
        lambda c, gg, hh, ww, cm: jgrow(c, gg, hh, ww, jcfg, cm),
        mesh=mesh,
        in_specs=(P("data", "model"), P("data"), P("data"), P("data"),
                  P("model")),
        out_specs=({"feat": P(), "split_bin": P(), "na_left": P(),
                    "is_split": P(), "value": P()}, P("data")),
        check_vma=False))
    jt, jnid = f(jax.device_put(jnp.asarray(codes),
                                NamedSharding(mesh, P("data", "model"))),
                 jnp.asarray(g), jnp.asarray(h), jnp.asarray(w),
                 jnp.ones(F, bool))
    cfg = ttree.TreeConfig(max_depth=4, n_bins=nbins, n_features=F,
                           min_rows=5.0)
    args = [torch.as_tensor(a) for a in (codes, g, h, w)]
    tt, tnid = ttree.grow_tree_spmd(
        *args, cfg, torch.ones(F, dtype=torch.bool),
        tm.make_mesh(n_data=4, n_model=2, devices=["cpu"] * 8))
    np.testing.assert_array_equal(tnid.numpy(), np.asarray(jnid))
    for key in ("feat", "split_bin", "na_left", "is_split"):
        np.testing.assert_array_equal(tt[key].numpy(), np.asarray(jt[key]),
                                      err_msg=key)
    np.testing.assert_allclose(tt["value"].numpy(), np.asarray(jt["value"]),
                               rtol=2e-4, atol=1e-6)
    ref, ref_nid = ttree.grow_tree(args[0], *args[1:], cfg)
    np.testing.assert_array_equal(tnid.numpy(), ref_nid.numpy())
    for key in ("feat", "split_bin", "is_split"):
        np.testing.assert_array_equal(tt[key].numpy(), ref[key].numpy())


@pytest.mark.parametrize("terms", [1, 2])
def test_int8_sharded_level_matches_jax_per_shard(terms):
    """Under shard_map each JAX shard quantizes its (g, h, w) with its own
    amax and flushes its int8 sums to float32 before the psum
    (h2o3_tpu/ops/hist_adaptive.py:476-497). The port's sharded level:
    each shard's int8 level with its own scale (the plain version of K4),
    then the shard-order reduce; the JAX side: the TPU kernel in
    interpret mode a shard, added in shard order. Bit for bit; a global
    scale would differ."""
    from h2o3_tpu.ops import hist_adaptive as jha
    rng = np.random.default_rng(terms)
    rows, F, W, N = 4096, 6, 16, 2
    codes = rng.integers(0, W - 1, (rows, F)).astype(np.int8)
    nid = rng.integers(1, 3, rows).astype(np.int32)
    ghw = np.stack([rng.normal(size=rows) * (1 + 9 * (np.arange(rows)
                                                      >= rows // 2)),
                    rng.random(rows) * 0.25, np.ones(rows)]
                   ).astype(np.float32)
    btab = (np.zeros(1, np.float32), np.full(1, 5, np.float32),
            np.zeros(1, np.float32), np.ones(1, np.float32))
    tables = tha.make_tables(*(torch.as_tensor(t) for t in btab))
    per = rows // 4
    ref = None
    parts = []
    for s in range(4):
        c = slice(s * per, (s + 1) * per)
        qj, sj = jha.quantize_ghw_i8(jnp.asarray(ghw[:, c]), terms=terms)
        _n, hj = jha.binned_level_tpu_i8(
            jnp.asarray(codes[c].T.copy()), jnp.asarray(nid[c] - 1), qj, sj,
            tuple(jnp.asarray(t) for t in btab), 0, 1, 0, W, tile=1024,
            interpret=True)
        hj = np.asarray(hj)
        ref = hj if ref is None else (ref + hj).astype(np.float32)
        gh = torch.as_tensor(ghw[:, c]).contiguous()
        qs = tha.quantize_ghw_i8(gh, terms)
        parts.append(tha.binned_level(
            torch.as_tensor(codes[c]), torch.as_tensor(nid[c] - 1), gh,
            tables, 0, 1, 0, W, True, qs)[1])
    mesh = tm.make_mesh(n_data=4, devices=["cpu"] * 4)
    got = collectives.psum(parts, mesh, lead_only=True)[0]
    np.testing.assert_array_equal(got.numpy(), ref)
    whole = tha.binned_level(
        torch.as_tensor(codes), torch.as_tensor(nid - 1),
        torch.as_tensor(ghw), tables, 0, 1, 0, W, True,
        tha.quantize_ghw_i8(torch.as_tensor(ghw), terms))[1]
    assert not torch.equal(whole, got)
    assert N == 2


def test_one_shard_mesh_is_the_single_device_train():
    """A (1, 1) mesh pads nothing and reduces nothing: the trees of the
    train without a mesh, bit for bit, the record (1, 1)."""
    cols = _cols(seed=7)
    params = dict(BASE, **PATHS["adaptive"])
    a, _ = _train_port(TorchGBM, (1, 1), cols, **params)
    old = tm._MESH
    tm.set_mesh(None)
    try:
        fr = th2o.Frame.from_numpy(cols, device="cpu")
        b = TorchGBM(**params).train(y="label", training_frame=fr).model
    finally:
        tm.set_mesh(old)
    for key in ("feat", "thr", "na_left", "is_split", "value"):
        np.testing.assert_array_equal(a.trees[key], b.trees[key])
    assert a.output["spmd"] == {"n_data": 1, "n_model": 1,
                                "model_axis_split_search": False}
