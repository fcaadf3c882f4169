"""Monotone and interaction constraints (ROADMAP item A5) in the port's
GBM against the JAX package, on the packed, adaptive and global-sketch
growers (2000 rows x 5 features with 3% NA cells, depth 3, 3 trees,
float32 histograms): monotone constraints, interaction sets, both, and
both with per-node column subsets (the mtries draw, which
col_sample_rate_change_per_level turns on in the GBM) give equal trees
(feat, thr, na_left and is_split exactly, value within rtol = atol =
1e-5, as in test_torch_gbm.py). The JAX package's own property checks
(tests/test_tree_constraints.py) run on the port: predictions along a
sweep of a constrained feature never step against its direction by more
than 1e-5, an unconstrained model does, and no root-to-leaf path mixes
two interaction groups. The JAX package's refusals: an unknown column,
a monotone constraint on an enum column.

The JAX trains run on a one-device mesh, as in test_torch_sampling.py."""
import jax
import numpy as np
import pytest

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as JaxGBM
from h2o3_tpu.parallel.mesh import current_mesh, make_mesh, set_mesh
from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
from h2o3_tpu_torch.models.tree import _child_bounds, _next_allowed
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

ROWS, F = 2000, 5
BASE = dict(ntrees=3, max_depth=3, learn_rate=0.3, seed=7,
            histogram_precision="float32")
PATHS = {
    "packed": (dict(nbins=14, histogram_type="quantiles_global",
                    min_rows=1.0), dict(packed_codes=True)),
    "adaptive": (dict(nbins=20, packed_codes=False, min_rows=10.0), {}),
    "global": (dict(nbins=20, histogram_type="quantiles_global",
                    packed_codes=False, min_rows=1.0), {}),
}
MONO = {"f0": 1, "f1": -1}
SETS = [["f0", "f2"], ["f1", "f3", "f4"]]
CONSTRAINTS = {
    "monotone": dict(monotone_constraints=MONO),
    "interaction": dict(interaction_constraints=SETS),
    "both": dict(monotone_constraints=MONO, interaction_constraints=SETS),
    "both_subsets": dict(monotone_constraints=MONO,
                         interaction_constraints=SETS,
                         col_sample_rate_change_per_level=0.7),
}


@pytest.fixture(autouse=True, scope="module")
def _one_jax_device():
    old = current_mesh()
    set_mesh(make_mesh(n_data=1, devices=jax.devices()[:1]))
    yield
    set_mesh(old)


def _cols(seed=0):
    """Five normal features with 3% NA cells; a bernoulli label that
    rises with f0 and falls with f1, with interactions across the
    groups, so that the constraints bind."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(ROWS, F)).astype(np.float32)
    s = (1.2 * X[:, 0] + np.sin(3 * X[:, 0]) - X[:, 1]
         + 0.8 * np.cos(3 * X[:, 1]) + X[:, 0] * X[:, 3]
         + X[:, 2] * X[:, 4])
    y = (rng.random(ROWS) < 1.0 / (1.0 + np.exp(-s))).astype(np.float32)
    X[rng.random(X.shape) < 0.03] = np.nan
    cols = {f"f{i}": X[:, i] for i in range(F)}
    cols["label"] = y
    return cols


def _feature_paths(feat, is_split):
    """Each tree's root-to-leaf sets of split features."""
    out = []
    for t in range(feat.shape[0]):
        paths = []

        def walk(node, used):
            if node >= feat.shape[1] or not is_split[t, node]:
                if used:
                    paths.append(frozenset(used))
                return
            f = int(feat[t, node])
            walk(2 * node + 1, used | {f})
            walk(2 * node + 2, used | {f})

        walk(0, set())
        out.append(paths)
    return out


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("which", list(CONSTRAINTS))
def test_constrained_trees_match_jax(path, which):
    tp, jp = PATHS[path]
    kw = dict(BASE, distribution="bernoulli", **tp, **CONSTRAINTS[which])
    cols = _cols()
    jm = JaxGBM(**jp, **kw).train(
        y="label", training_frame=jh2o.Frame.from_numpy(cols)).model
    tm = H2OGradientBoostingEstimator(**kw).train(
        y="label",
        training_frame=th2o.Frame.from_numpy(cols, device="cpu")).model
    assert tm.ntrees_built == jm.ntrees_built
    assert bool(tm.trees["is_split"].any())
    for key in ("feat", "thr", "na_left", "is_split"):
        np.testing.assert_array_equal(tm.trees[key],
                                      np.asarray(getattr(jm, "_" + key)),
                                      err_msg=key)
    np.testing.assert_allclose(tm.trees["value"], np.asarray(jm._value),
                               rtol=1e-5, atol=1e-5)
    if "interaction_constraints" in kw:
        for paths in _feature_paths(tm.trees["feat"], tm.trees["is_split"]):
            for used in paths:
                assert used <= {0, 2} or used <= {1, 3, 4}, sorted(used)


def _mono_cols(n=4000, seed=0):
    """tests/test_tree_constraints.py's ``_mono_frame``: y rises with x0
    on average, with enough noise that an unconstrained tree steps
    down."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-2, 2, n).astype(np.float32)
    x1 = rng.normal(size=n).astype(np.float32)
    x2 = rng.normal(size=n).astype(np.float32)
    y = (2 * x0 + np.sin(4 * x0) + 1.5 * x1 * x2
         + rng.normal(scale=1.2, size=n)).astype(np.float32)
    return {"x0": x0, "x1": x1, "x2": x2, "y": y}


def _sweep(model, x1v=0.0, x2v=0.0, pts=201):
    xs = np.linspace(-2, 2, pts).astype(np.float32)
    fr = th2o.Frame.from_numpy({"x0": xs,
                                "x1": np.full(pts, x1v, np.float32),
                                "x2": np.full(pts, x2v, np.float32)},
                               device="cpu")
    return model.predict(fr).vec("predict").to_numpy()


def test_monotone_property_as_in_the_jax_tests():
    """test_monotone_increasing_property and
    test_monotone_decreasing_property on the port (fewer trees)."""
    fr = th2o.Frame.from_numpy(_mono_cols(), device="cpu")
    up = H2OGradientBoostingEstimator(
        ntrees=15, max_depth=4, seed=1, min_rows=2.0,
        monotone_constraints={"x0": 1}).train(y="y", training_frame=fr)
    free = H2OGradientBoostingEstimator(
        ntrees=15, max_depth=4, seed=1, min_rows=2.0).train(
        y="y", training_frame=fr)
    viol = 0
    for x1v, x2v in [(0.0, 0.0), (1.0, -1.0), (-0.7, 0.3)]:
        d = np.diff(_sweep(up.model, x1v, x2v))
        assert (d >= -1e-5).all(), (x1v, x2v, d.min())
        viol += int((np.diff(_sweep(free.model, x1v, x2v)) < -1e-5).any())
    assert viol > 0, "noise level too low to exercise the constraint"
    fr2 = th2o.Frame.from_numpy(_mono_cols(seed=2), device="cpu")
    down = H2OGradientBoostingEstimator(
        ntrees=10, max_depth=4, seed=3, min_rows=2.0,
        monotone_constraints={"x0": -1}).train(y="y", training_frame=fr2)
    assert (np.diff(_sweep(down.model)) <= 1e-5).all()


def test_interaction_groups_partition_branches():
    """test_interaction_constraints_partition_branches on the port."""
    rng = np.random.default_rng(4)
    n = 3000
    X = rng.normal(size=(n, 4)).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + X[:, 2] * X[:, 3]
         + 0.1 * rng.normal(size=n)).astype(np.float32)
    cols = {f"x{i}": X[:, i] for i in range(4)}
    cols["y"] = y
    m = H2OGradientBoostingEstimator(
        ntrees=6, max_depth=4, seed=5, min_rows=2.0,
        interaction_constraints=[["x0", "x1"], ["x2", "x3"]]).train(
        y="y", training_frame=th2o.Frame.from_numpy(cols,
                                                     device="cpu")).model
    n_paths = 0
    for paths in _feature_paths(m.trees["feat"], m.trees["is_split"]):
        for used in paths:
            n_paths += 1
            assert used <= {0, 1} or used <= {2, 3}, sorted(used)
    assert n_paths > 6


@pytest.mark.parametrize("param,match", [
    ({"monotone_constraints": {"nope": 1}}, "monotone_constraints column"),
    ({"interaction_constraints": [["f0", "nope"]]},
     "interaction_constraints column"),
    ({"monotone_constraints": {"colour": 1}}, "categorical column"),
])
def test_refusals_as_in_jax(param, match):
    """The JAX package's refusals (its ValueError, which its builder
    wraps in a RuntimeError; the port raises it directly)."""
    cols = _cols()
    cols["colour"] = np.array(["red", "blue"], dtype=object)[
        np.arange(ROWS) % 2]
    with pytest.raises(RuntimeError, match=match):
        JaxGBM(ntrees=1, **param).train(
            y="label", training_frame=jh2o.Frame.from_numpy(cols))
    with pytest.raises(ValueError, match=match):
        H2OGradientBoostingEstimator(ntrees=1, **param).train(
            y="label",
            training_frame=th2o.Frame.from_numpy(cols, device="cpu"))


def test_bounds_and_allowance_match_jax():
    """``_child_bounds`` and ``_next_allowed`` against the JAX package's
    on the same inputs."""
    import jax.numpy as jnp
    import torch
    from h2o3_tpu.models import tree as jtree
    rng = np.random.default_rng(3)
    N, S = 8, 3
    lo = rng.normal(size=N).astype(np.float32) - 2
    hi = lo + 4
    vl = rng.normal(size=N).astype(np.float32) * 3
    vr = rng.normal(size=N).astype(np.float32) * 3
    md = rng.integers(-1, 2, size=N).astype(np.int32)
    can = rng.random(N) < 0.7
    want = jtree._child_bounds(*(jnp.asarray(a) for a in
                                 (lo, hi, vl, vr, md, can)))
    got = _child_bounds(*(torch.as_tensor(a) for a in
                          (lo, hi, vl, vr, md, can)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    allowed = rng.random((N, F)) < 0.8
    sets = rng.random((S, F)) < 0.5
    bf = rng.integers(0, F, size=N).astype(np.int32)
    want = jtree._next_allowed(jnp.asarray(allowed), jnp.asarray(sets),
                               jnp.asarray(bf), jnp.asarray(can))
    got = _next_allowed(torch.as_tensor(allowed), torch.as_tensor(sets),
                        torch.as_tensor(bf), torch.as_tensor(can))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
