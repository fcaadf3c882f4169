"""The sharded trains on the card (ROADMAP item 14): virtual meshes of
four data shards on one card, (4, 1) and (4, 2), against the CPU port on
the same meshes. Needs a CUDA device (marked ``gpu``); imports nothing
of JAX (on the card: ``python -m pytest --noconftest -m gpu
tests/test_torch_spmd_cuda.py``)."""
import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th2o
from h2o3_tpu_torch.models import tree as tree_mod
from h2o3_tpu_torch.models.gbm import H2OGradientBoostingEstimator
from h2o3_tpu_torch.parallel import mesh as tm
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

ROWS, F = 200_003, 28
PARAMS = dict(ntrees=3, max_depth=6, seed=7, distribution="bernoulli",
              histogram_precision="float32", min_rows=1.0)
PATHS = {"packed": dict(nbins=14, histogram_type="quantiles_global"),
         "adaptive": dict(nbins=20, packed_codes=False),
         "global": dict(nbins=300, histogram_type="quantiles_global")}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest -m gpu tests/test_torch_spmd_cuda.py)")
    return torch.device("cuda")


def _cols(seed=11):
    """``chip_smoke.py``'s generator (28 HIGGS-shaped features, a
    logistic label), at phase 5's card-vs-CPU size."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(ROWS, F)).astype(np.float32)
    logit = (X[:, 0] * 1.5 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
             + 0.3 * np.sin(3 * X[:, 4]))
    cols = {f"f{i}": X[:, i] for i in range(F)}
    cols["label"] = (rng.random(ROWS) < 1 / (1 + np.exp(-logit))).astype(
        np.float32)
    return cols


def _train(cols, device, shape, monkeypatch, **kw):
    """The GBM on a (n_data, n_model) mesh of ``device`` shards, its split
    search recorded (``tree._find_splits``, a call a level): the chosen
    gain and the parent's score |G^2 / H|."""
    store = []
    orig = tree_mod._find_splits

    def call(trip, cfg, col_mask, max_bin=None, mono=None):
        out = orig(trip, cfg, col_mask, max_bin, mono)
        parent = tree_mod._leaf_score2(out[4], out[5], cfg).abs()
        store.append((out[0].cpu().numpy(), parent.cpu().numpy()))
        return out
    monkeypatch.setattr(tree_mod, "_find_splits", call)
    old = tm._MESH
    tm.set_mesh(tm.make_mesh(n_data=shape[0], n_model=shape[1],
                             devices=[device] * (shape[0] * shape[1])))
    try:
        fr = th2o.Frame.from_numpy(cols, device=device)
        m = H2OGradientBoostingEstimator(**dict(PARAMS, **kw)).train(
            y="label", training_frame=fr).model
    finally:
        tm.set_mesh(old)
        monkeypatch.setattr(tree_mod, "_find_splits", orig)
    return m, store


def _noise(rec, t, m, depth):
    """``chip_smoke.py``'s ``noise_split``: the node's gain within 4
    float32 ulps of its parent's score, a split rounding alone chose."""
    d = int(np.log2(m + 1))
    gain, parent = rec[t * depth + d]
    n = m - (2 ** d - 1)
    return bool(gain[n] <= 4 * np.spacing(np.float32(parent[n])))


@pytest.mark.gpu
@pytest.mark.parametrize("path", list(PATHS))
def test_card_virtual_mesh_trains_the_cpu_trees(cuda, monkeypatch, path):
    """(4, 1) on the card against (4, 1) on the CPU by
    ``chip_smoke.py``'s ``card_vs_cpu_splits`` rule (a differing node
    only at or below a node that split on rounding alone on both
    devices, at most one such node), the AUC within 1e-4; (4, 2)
    bit-equal to (4, 1) on each device, so it holds the CPU's (4, 2) by
    the same rule."""
    cols = _cols()
    kw = PATHS[path]
    card, gc = _train(cols, cuda, (4, 1), monkeypatch, **kw)
    host, gh = _train(cols, "cpu", (4, 1), monkeypatch, **kw)
    assert card.output["spmd"]["n_data"] == 4
    depth = PARAMS["max_depth"]
    roots = set()
    for t in range(PARAMS["ntrees"]):
        for m in range(2 ** depth - 1):
            if all(card.trees[k][t][m] == host.trees[k][t][m]
                   for k in ("feat", "thr", "na_left")):
                continue
            a = m
            while a >= 0 and not (_noise(gc, t, a, depth)
                                  and _noise(gh, t, a, depth)):
                a = (a - 1) // 2 if a else -1
            assert a >= 0, f"tree {t} node {m}: not below a noise split"
            roots.add((t, a))
    assert len(roots) <= 1, sorted(roots)
    assert abs(card.training_metrics.auc
               - host.training_metrics.auc) <= 1e-4
    for dev, ref in ((cuda, card), ("cpu", host)):
        m42, _ = _train(cols, dev, (4, 2), monkeypatch, **kw)
        assert m42.output["spmd"]["model_axis_split_search"]
        for k in ("feat", "thr", "na_left", "is_split", "value"):
            np.testing.assert_array_equal(m42.trees[k], ref.trees[k],
                                          err_msg=f"{dev} {k}")


@pytest.mark.gpu
def test_card_virtual_mesh_repeats_bit_for_bit(cuda, monkeypatch):
    """The shard-order reduce is fixed: two (4, 1) trains on the card
    give the same bits."""
    cols = _cols(seed=1)
    a, _ = _train(cols, cuda, (4, 1), monkeypatch, **PATHS["packed"])
    b, _ = _train(cols, cuda, (4, 1), monkeypatch, **PATHS["packed"])
    for k in ("feat", "thr", "value"):
        np.testing.assert_array_equal(a.trees[k], b.trees[k])
