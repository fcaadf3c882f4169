"""The streamed GBM's copy pipeline on the card: pinned staging buffers,
a side stream and the events that order it (``models/streaming.py``).
Needs a CUDA device (marked ``gpu``); imports nothing of JAX, so that it
runs where JAX is absent (on the card: ``python -m pytest --noconftest
-m gpu tests/test_torch_streaming_cuda.py``)."""
import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th2o
from h2o3_tpu_torch import memman
from h2o3_tpu_torch.models import tree as tree_mod
from h2o3_tpu_torch.models.gbm import H2OGradientBoostingEstimator
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

ROWS, F = 50_000, 28
PARAMS = dict(ntrees=3, max_depth=5, nbins=14, seed=7,
              distribution="bernoulli", histogram_precision="float32",
              histogram_type="quantiles_global", min_rows=2.0)
# four chunks of 16384 rows or fewer (the chunk rows' floor)
CHUNKED = 16384 * F * 4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest -m gpu tests/test_torch_streaming_cuda.py)")
    return torch.device("cuda")


def _cols(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(ROWS, F)).astype(np.float32)
    X[rng.random(X.shape) < 0.03] = np.nan
    logit = X[:, 0] * 1.5 - np.nan_to_num(X[:, 1])
    cols = {f"f{i}": X[:, i] for i in range(F)}
    cols["label"] = (rng.random(ROWS) < 1 / (1 + np.exp(-logit))).astype(
        np.float32)
    return cols


def _recorded(cols, device, monkeypatch, resident, **kw):
    """``_train`` with the split search (``tree._find_splits``, one call
    a level) recorded: for each level, each node's chosen gain and its
    parent's score |G^2 / H| on the host."""
    store = []
    orig = tree_mod._find_splits

    def call(trip, cfg, col_mask, max_bin=None, mono=None):
        out = orig(trip, cfg, col_mask, max_bin, mono)
        parent = tree_mod._leaf_score2(out[4], out[5], cfg)
        store.append((out[0].cpu().numpy(), parent.abs().cpu().numpy()))
        return out
    monkeypatch.setattr(tree_mod, "_find_splits", call)
    try:
        return _train(cols, device, monkeypatch, resident, **kw), store
    finally:
        monkeypatch.setattr(tree_mod, "_find_splits", orig)


def _noise_split(gains, t, m, depth):
    """Whether node ``m`` of tree ``t`` split on rounding alone: its gain
    at most 4 float32 ulps of its parent's score (``chip_smoke.py``'s
    ``noise_split``)."""
    d = int(np.log2(m + 1))
    gain, parent = gains[t * depth + d]
    n = m - (2 ** d - 1)
    return bool(gain[n] <= 4 * np.spacing(np.float32(parent[n])))


def _train(cols, device, monkeypatch, resident, levels="auto", **kw):
    monkeypatch.setenv("H2O3_STREAM_RESIDENT", str(resident))
    monkeypatch.setenv("H2O3_LEVELS_PER_PASS", levels)
    memman.reset(budget=CHUNKED)
    try:
        fr = th2o.Frame.from_numpy(cols, device=device)
        return H2OGradientBoostingEstimator(**dict(PARAMS, **kw)).train(
            y="label", training_frame=fr).model
    finally:
        memman.reset()


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [{}, {"packed_codes": False, "nbins": 20},
                                {"sample_rate": 0.8}])
def test_card_streams_the_cpu_trees(cuda, monkeypatch, kw):
    """Four chunks, one resident, on the card and on the CPU: the same
    splits at float32 histograms, but at or below one node of the train
    that split on rounding alone on both devices (its gain within 4
    float32 ulps of its parent's score: a pure node's children score as
    it does, and the order of the histogram's adds, another on the card
    than in the plain versions, picks the feature), as ``chip_smoke.py``'s
    card-vs-CPU checks allow; and the training AUC within 1e-4."""
    cols = _cols()
    card, gc = _recorded(cols, cuda, monkeypatch, 1, **kw)
    host, gh = _recorded(cols, "cpu", monkeypatch, 1, **kw)
    sp = card.output["stream_profile"]
    assert (sp["chunks"], sp["resident_chunks"]) == (4, 1)
    assert sp["copy_ms"] > 0 and 0.0 <= sp["unwaited_copy_share"] <= 1.0
    depth = PARAMS["max_depth"]
    assert len(gc) == len(gh) == PARAMS["ntrees"] * depth
    roots = set()
    for t in range(PARAMS["ntrees"]):
        for m in range(2 ** depth - 1):
            if all(card.trees[k][t][m] == host.trees[k][t][m]
                   for k in ("feat", "thr", "na_left", "is_split")):
                continue
            a = m
            while a >= 0 and not (_noise_split(gc, t, a, depth)
                                  and _noise_split(gh, t, a, depth)):
                a = (a - 1) // 2 if a else -1
            assert a >= 0, (
                f"tree {t} node {m}: feat {card.trees['feat'][t][m]} vs "
                f"{host.trees['feat'][t][m]}, not below a noise split")
            roots.add((t, a))
    assert len(roots) <= 1, sorted(roots)
    assert abs(card.training_metrics.auc
               - host.training_metrics.auc) <= 1e-4


@pytest.mark.gpu
def test_window_and_levels_do_not_change_the_card_trees(cuda, monkeypatch):
    """On the card the resident window and the levels a window change the
    copies, never the sums: no window at one level a window, two
    resident chunks at auto and every chunk resident give the same bits
    (four chunks each)."""
    cols = _cols(seed=1)
    runs = [_train(cols, cuda, monkeypatch, 0, "1"),
            _train(cols, cuda, monkeypatch, 2),
            _train(cols, cuda, monkeypatch, 4)]
    for m in runs[1:]:
        for k in ("feat", "thr", "value", "na_left", "is_split"):
            np.testing.assert_array_equal(m.trees[k], runs[0].trees[k],
                                          err_msg=k)
    assert runs[2].output["stream_profile"]["h2d_bytes_per_tree"] == 0
