"""The out-of-core GBM (ROADMAP.md item 13) held against the JAX package
on the CPU: the memory gate picks the same path at the same budget; the
host binning gives the same edges and codes; the streamed packed and
adaptive trains over two chunks, with a partial resident window and
with none, sampled, and the streamed XGBoost give the JAX package's
trees (the packed one with a partial window also at torch's default
thread pool); and the port's own contracts: a fully-resident streamed train is
bit-equal to the dense one, one level a window equals several,
a pending interrupt clamps every window to one level, a resumed
streamed train equals the uninterrupted one, the refusals raise the JAX
package's exception and words, and a dense train that runs out of
memory degrades to the streamed one.

Tolerances: splits (feature, threshold, NA side, is_split) bit-equal;
leaf values within 1e-5 (rtol and atol: the JAX package sums the
stump's and the nodes' float32 totals in XLA's order); the training AUC
within 1e-6. The JAX trains run on a one-device mesh, as in
``tests/test_fused_levels.py``. The JAX package's streamed trainer
compiles its eager ops at its first train in a process (about 30 s), so
every JAX train of this file runs in one test,
``test_streamed_trains_match_jax``.
"""
import logging

import jax
import numpy as np
import pytest

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu import memman as jmm
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as JaxGBM
from h2o3_tpu.models.xgboost import H2OXGBoostEstimator as JaxXGB
from h2o3_tpu.parallel.mesh import current_mesh, make_mesh, set_mesh
from h2o3_tpu_torch import memman as tmm
from h2o3_tpu_torch.models import tree as tree_mod
from h2o3_tpu_torch.models.drf import H2ORandomForestEstimator as TorchDRF
from h2o3_tpu_torch.models.gbm import H2OGradientBoostingEstimator as TorchGBM
from h2o3_tpu_torch.models.model_base import build_training_spec
from h2o3_tpu_torch.models.streaming import StreamedChunks
from h2o3_tpu_torch.models.xgboost import H2OXGBoostEstimator as TorchXGB
import torch
from torch_threads import DEFAULT_THREADS
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)

ROWS, F = 32_768, 6
PARAMS = dict(ntrees=3, max_depth=3, nbins=14, seed=7,
              distribution="bernoulli", histogram_precision="float32",
              min_rows=2.0)
# two chunks of 16384 rows: the chunk rows fall to their floor at this
# budget, and the window holds none of them
CHUNKED = 300_000
# streamed (the design matrix and the frame pass 0.9 of it), in one
# chunk that the window holds whole
RESIDENT = 1_500_000
VALUE_TOL = dict(rtol=1e-5, atol=1e-5)
AUC_TOL = 1e-6


@pytest.fixture(autouse=True)
def _fresh_budgets(monkeypatch):
    monkeypatch.delenv("H2O3_STREAM_RESIDENT", raising=False)
    monkeypatch.delenv("H2O3_LEVELS_PER_PASS", raising=False)
    monkeypatch.delenv("H2O3_DEVICE_BUDGET_BYTES", raising=False)
    yield
    jmm.reset()
    tmm.reset()


def _cols(seed=0, rows=ROWS):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, F)).astype(np.float32)
    X[rng.random(X.shape) < 0.03] = np.nan
    logit = X[:, 0] - 0.7 * np.nan_to_num(X[:, 1]) + 0.4 * np.nan_to_num(
        X[:, 2])
    cols = {f"x{i}": X[:, i] for i in range(F)}
    cols["label"] = (rng.random(rows) < 1 / (1 + np.exp(-logit))).astype(
        np.float32)
    return cols


def _torch_train(cols, budget, est=TorchGBM, **kw):
    """A port train with the memman budget reset just before the frame is
    made (the frame's payloads then count, as in the JAX gate)."""
    tmm.reset(budget=budget)
    fr = th2o.Frame.from_numpy(cols, device="cpu")
    return est(**dict(PARAMS, **kw)).train(y="label", training_frame=fr
                                           ).model


def _jax_train(cols, budget, est=JaxGBM, **kw):
    old = current_mesh()
    set_mesh(make_mesh(n_data=1, devices=jax.devices()[:1]))
    try:
        jmm.reset(budget=budget)
        fr = jh2o.Frame.from_numpy(cols)
        return est(**dict(PARAMS, **kw)).train(y="label", training_frame=fr
                                               ).model
    finally:
        jmm.reset()
        set_mesh(old)


def _same_splits(a, b):
    for k in ("feat", "thr", "na_left", "is_split"):
        np.testing.assert_array_equal(a.trees[k], b.trees[k], err_msg=k)


# ------------------------------------------------------------- the gate


@pytest.mark.parametrize("budget,stream", [
    (1_000_000, True), (RESIDENT, True), (3_000_000, False), (None, False)])
def test_memory_gate_picks_the_jax_path(budget, stream):
    """The same frame under the same budget takes the same path in both
    packages: the design matrix (rows + 256) x F x 4 bytes on top of the
    frame's own column payloads, which count the same bytes in both
    where the JAX package spilled none of them to the host (the port
    does not spill yet, ROADMAP.md item 18)."""
    from h2o3_tpu.models.model_base import build_training_spec as jspec
    cols = _cols(rows=ROWS)
    jmm.reset(budget=budget)
    tmm.reset(budget=budget)
    jfr = jh2o.Frame.from_numpy(cols)
    tfr = th2o.Frame.from_numpy(cols, device="cpu")
    js_ = jmm.manager().stats()
    ours = tmm.manager().stats()["device_resident_bytes"]
    assert ours == (F + 1) * ROWS * 4
    assert ours == js_["device_resident_bytes"] + js_["spilled_bytes"]
    assert (js_["spill_count"] > 0) is (budget == 1_000_000)
    js, ts = jspec(jfr, "label"), build_training_spec(tfr, "label")
    assert ts.stream is js.stream is stream
    if stream:
        assert ts.X is None and js.X is None
        np.testing.assert_array_equal(ts.X_host, js.X_host)
    else:
        assert ts.X_host is None
    assert tmm.manager().unlimited is (budget is None)


# ------------------------------------------------------ host binning


@pytest.mark.parametrize("histogram_type,nbins", [
    ("quantiles_global", 14), ("uniform_adaptive", 14),
    ("quantiles_global", 254)])
def test_host_edges_and_codes_match_jax(histogram_type, nbins):
    """``_edges_host`` and ``digitize_codes_host`` against the JAX
    package's: NaN, ±inf, a constant column, an enum column of five
    levels (one bin a level) and one of 40 levels past nbins_cats 16
    (quantile groups); at nbins 254 the codes come from the binary
    search, below 64 edges from the count. Exact."""
    from h2o3_tpu.ops import binning as jb
    from h2o3_tpu_torch.ops import binning as tb
    rng = np.random.default_rng(3)
    rows = 5000
    X = rng.normal(size=(rows, 5)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    X[:7, 0] = np.inf
    X[7:9, 0] = -np.inf
    X[:, 1] = 2.5
    X[:, 3] = rng.integers(0, 5, rows)
    X[:, 4] = rng.integers(0, 40, rows)
    is_cat = [False, False, False, True, True]
    je, jn = jb._edges_host(X, rows, is_cat, nbins, 16, histogram_type)
    te, tn = tb._edges_host(X, rows, is_cat, nbins, 16, histogram_type)
    assert (max(len(e) for e in te) > tb._COUNT_EDGES) is (nbins == 254)
    assert tn == jn
    for a, b in zip(te, je):
        np.testing.assert_array_equal(a, b)
    jc, jW = jb.digitize_codes_host(X, je, jn)
    tc, tW = tb.digitize_codes_host(X, te, tn)
    assert tW == jW and tc.dtype == jc.dtype
    np.testing.assert_array_equal(tc, jc)


# ------------------------------------------------ levels per pass


@pytest.mark.parametrize("raw,expect", [("1", 1), ("3", 3), ("9", 6),
                                        ("auto", None), ("", None)])
def test_levels_per_pass_resolves_the_override_as_jax(monkeypatch, raw,
                                                      expect):
    """The ``H2O3_LEVELS_PER_PASS`` override is read as the JAX package
    reads it (clamped to [1, depth]); ``auto`` is the port's constant
    cap of 4 levels, the JAX value at the bench shape. The JAX package
    bounds ``auto`` by its TPU kernel's VMEM, which gives 1 where the
    histograms are absurd; the port's cap reads no histogram size."""
    from h2o3_tpu.models.tree import levels_per_pass as jlpp
    monkeypatch.setenv("H2O3_LEVELS_PER_PASS", raw)
    got = tree_mod.levels_per_pass(6, 28, 16)
    assert got == jlpp(6, 28, 16)
    if expect is not None:
        assert got == expect
    else:
        assert got == 4
        assert tree_mod.levels_per_pass(14, 60_000, 32) == 4
        assert jlpp(14, 60_000, 32) == 1


# ----------------------------------------------- trains against JAX

JAX_CASES = {
    # name: (resident chunks or None for the budget's own window, kwargs)
    "packed_no_window": (None, dict(packed_codes=True)),
    "packed_partial_window": (1, dict(packed_codes=True)),
    "adaptive_no_window": (None, dict(packed_codes=False, nbins=20)),
    "adaptive_partial_window": (1, dict(packed_codes=False, nbins=20)),
    "packed_sampled": (1, dict(packed_codes=True, sample_rate=0.8,
                               col_sample_rate=0.7)),
    "xgboost_hist": (1, dict(packed_codes=True, tree_method="hist",
                             max_bins=16, est="xgb")),
    # the port at torch's default thread pool rather than the test
    # worker's share (``torch_threads``), against the JAX train of
    # "packed_partial_window"
    "packed_partial_window_default_threads": (
        1, dict(packed_codes=True, threads=DEFAULT_THREADS)),
}


def test_streamed_trains_match_jax(monkeypatch):
    """Each case of ``JAX_CASES`` streams two chunks in both packages
    (window of the budget: none; partial: ``H2O3_STREAM_RESIDENT=1``)
    and the port trains the JAX package's trees: splits bit-equal,
    values within 1e-5, AUC within 1e-6, the same chunking."""
    cols = _cols()
    jax_models = {}
    for name, (resident, kw) in JAX_CASES.items():
        kw = dict(kw)
        xgb = kw.pop("est", None) == "xgb"
        threads = kw.pop("threads", torch.get_num_threads())
        if resident is None:
            monkeypatch.delenv("H2O3_STREAM_RESIDENT", raising=False)
        else:
            monkeypatch.setenv("H2O3_STREAM_RESIDENT", str(resident))
        if xgb:
            kw.update(ntrees=3, max_depth=3, seed=7, min_rows=2.0,
                      distribution="bernoulli",
                      histogram_precision="float32")
        key = (xgb, resident, tuple(sorted(kw.items())))
        if key not in jax_models:
            jax_models[key] = _jax_train(cols, CHUNKED,
                                         JaxXGB if xgb else JaxGBM, **kw)
        jm = jax_models[key]
        old = torch.get_num_threads()
        torch.set_num_threads(threads)
        try:
            tm = _torch_train(cols, CHUNKED, TorchXGB if xgb else TorchGBM,
                              **kw)
        finally:
            torch.set_num_threads(old)
        assert jm.output.get("streamed") and tm.output["streamed"], name
        jp, tp = jm.output["stream_profile"], tm.output["stream_profile"]
        assert (tp["chunks"], tp["resident_chunks"]) == (
            jp["chunks"], jp["resident_chunks"]), name
        assert tp["chunks"] == 2
        assert tp["resident_chunks"] == (resident or 0)
        assert tm.output["packed_codes"] == jm.output["packed_codes"], name
        for k in ("feat", "thr", "na_left", "is_split"):
            np.testing.assert_array_equal(
                tm.trees[k], np.asarray(getattr(jm, "_" + k)),
                err_msg=f"{name}: {k}")
        np.testing.assert_allclose(tm.trees["value"], np.asarray(jm._value),
                                   **VALUE_TOL, err_msg=name)
        assert bool(tm.trees["is_split"].any()), name
        assert abs(tm.training_metrics.auc
                   - jm.training_metrics.auc) <= AUC_TOL, name


# ------------------------------------------------- the port's contracts


def test_fully_resident_streamed_train_is_the_dense_train():
    """A budget that forces the stream but whose window holds the whole
    frame in one chunk: the streamed packed train is bit-equal to the
    dense one, in trees, predictions and training AUC."""
    cols = _cols()
    dense = _torch_train(cols, None, packed_codes=True)
    assert not dense.output.get("streamed")
    st = _torch_train(cols, RESIDENT, packed_codes=True)
    sp = st.output["stream_profile"]
    assert st.output["streamed"] and sp["chunks"] == sp["resident_chunks"] \
        == 1
    assert st.output["levels_per_dispatch"] == 3
    for k in ("feat", "thr", "value", "na_left", "is_split", "node_w",
              "split_bin"):
        np.testing.assert_array_equal(st.trees[k], dense.trees[k],
                                      err_msg=k)
    fr = th2o.Frame.from_numpy(cols, device="cpu")
    np.testing.assert_array_equal(st.predict(fr).vec("p1").to_numpy(),
                                  dense.predict(fr).vec("p1").to_numpy())
    assert st.training_metrics.auc == dense.training_metrics.auc
    assert sp["h2d_bytes_per_tree"] == 0


@pytest.mark.parametrize("budget", [RESIDENT, CHUNKED])
def test_one_level_a_window_equals_the_fused_window(monkeypatch, budget):
    """L = 1 and L = auto give bit-identical trees, over one chunk and
    over two."""
    cols = _cols()
    models = []
    for L in ("1", "auto"):
        monkeypatch.setenv("H2O3_LEVELS_PER_PASS", L)
        models.append(_torch_train(cols, budget, packed_codes=True))
    assert models[0].output["stream_profile"]["levels_per_pass"] == 1
    assert models[1].output["stream_profile"]["levels_per_pass"] == 3
    for k in ("feat", "thr", "value", "na_left", "is_split"):
        np.testing.assert_array_equal(models[0].trees[k], models[1].trees[k])


def test_pending_interrupt_clamps_each_window_to_one_level(monkeypatch):
    """With a cancel or a preempt pending, every window clamps to one
    level (its records stored alone) and the trees do not change."""
    cols = _cols()
    real = tree_mod._store_records
    widths = []

    def spy(recs, d0, arrays):
        widths.append(len(recs))
        return real(recs, d0, arrays)

    monkeypatch.setattr(tree_mod, "_store_records", spy)
    base = _torch_train(cols, RESIDENT, packed_codes=True)
    assert widths == [3] * PARAMS["ntrees"]
    widths.clear()
    monkeypatch.setattr(StreamedChunks, "interrupt_pending",
                        lambda self: True)
    clamped = _torch_train(cols, RESIDENT, packed_codes=True)
    assert widths == [1] * (3 * PARAMS["ntrees"])
    _same_splits(base, clamped)
    np.testing.assert_array_equal(base.trees["value"],
                                  clamped.trees["value"])


def test_interrupt_pending_polls_both_checks():
    ch = object.__new__(StreamedChunks)
    ch.cancel_check = ch.interrupt_check = None
    assert not ch.interrupt_pending()
    ch.interrupt_check = lambda: True
    assert ch.interrupt_pending()
    ch.interrupt_check, ch.cancel_check = None, lambda: True
    assert ch.interrupt_pending()


@pytest.mark.parametrize("packed", [True, False])
def test_streamed_resume_is_bit_equal(tmp_path, monkeypatch, packed):
    """A streamed train over two chunks (one resident) with in-training
    checkpoints, and a train resumed from its first checkpoint: the
    same trees and the same training AUC, bit for bit (the checkpoint
    carries the exact float32 margin)."""
    monkeypatch.setenv("H2O3_STREAM_RESIDENT", "1")
    cols = _cols()
    kw = dict(packed_codes=packed, sample_rate=0.9)
    full = _torch_train(cols, CHUNKED, model_id="s",
                        in_training_checkpoints_dir=str(tmp_path), **kw)
    assert [c["trees"] for c in full.output["checkpoints"]] == [1, 2, 3]
    res = _torch_train(cols, CHUNKED, checkpoint=str(tmp_path / "s_t1.zip"),
                       **kw)
    assert res.output["streamed"] and res.ntrees_built == 3
    for k in ("feat", "thr", "value", "na_left", "is_split"):
        np.testing.assert_array_equal(res.trees[k], full.trees[k],
                                      err_msg=k)
    assert res.training_metrics.auc == full.training_metrics.auc


def _refusal_case(case):
    cols = _cols(rows=3000)
    y, kw, valid, est = "label", {}, False, "gbm"
    if case == "multinomial":
        cols["label"] = np.array(["a", "b", "c"], dtype=object)[
            np.arange(3000) % 3]
        kw = dict(distribution="multinomial")
    elif case == "validation_frame":
        valid = True
    elif case == "offset_column":
        cols["off"] = np.zeros(3000, np.float32)
        kw = dict(offset_column="off")
    elif case == "sample_rate_per_class":
        kw = dict(sample_rate_per_class=[1.0, 0.5])
    elif case == "col_sample_rate_change_per_level":
        kw = dict(col_sample_rate_change_per_level=0.5)
    elif case == "huber":
        y, kw = "x3", dict(distribution="huber")
    elif case == "constraints":
        kw = dict(monotone_constraints={"x0": 1})
    elif case == "balance_classes":
        kw = dict(balance_classes=True)
    elif case == "drf":
        est = "drf"
    return cols, y, kw, valid, est


@pytest.mark.parametrize("case", [
    "multinomial", "validation_frame", "offset_column",
    "sample_rate_per_class", "col_sample_rate_change_per_level", "huber",
    "constraints", "balance_classes", "drf"])
def test_streamed_refusals_match_jax(case):
    """What the JAX streamed path refuses, the port refuses with the same
    exception type and words (the JAX train surfaces an error of its job
    whose last line is the refusal, or raises it itself)."""
    from h2o3_tpu.models.drf import H2ORandomForestEstimator as JaxDRF
    cols, y, kw, valid, est = _refusal_case(case)
    base = dict(ntrees=1, max_depth=2, min_rows=2.0)
    if "distribution" not in kw and est == "gbm":
        kw["distribution"] = "bernoulli"
    jcls, tcls = ((JaxGBM, TorchGBM) if est == "gbm"
                  else (JaxDRF, TorchDRF))
    tmm.reset(budget=100_000)
    tfr = th2o.Frame.from_numpy(cols, device="cpu")
    with pytest.raises(NotImplementedError) as te:
        tcls(**base, **kw).train(y=y, training_frame=tfr,
                                 validation_frame=tfr if valid else None)
    jmm.reset(budget=100_000)
    jfr = jh2o.Frame.from_numpy(cols)
    if y == "label" and case != "multinomial" and est == "gbm":
        jfr["label"] = jfr.vec("label").asfactor()
    with pytest.raises(Exception) as je:
        jcls(**base, **kw).train(y=y, training_frame=jfr,
                                 validation_frame=jfr if valid else None)
    want = str(je.value).strip().splitlines()[-1]
    assert f"NotImplementedError: {te.value}" == (
        want if not isinstance(je.value, NotImplementedError)
        else f"NotImplementedError: {je.value}")


def _oom(*_a, **_k):
    raise RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB")


def test_oom_degrades_to_the_streamed_train(monkeypatch, caplog):
    """A dense train that runs out of memory completes streamed, with one
    warning, and gives the trees of a streamed train at the same budget
    (here one resident chunk: the dense train's own trees)."""
    cols = _cols()
    want = _torch_train(cols, RESIDENT, packed_codes=True)
    monkeypatch.setattr(TorchGBM, "_train_dense", _oom)
    with caplog.at_level(logging.WARNING, logger="h2o3_tpu_torch"):
        got = _torch_train(cols, None, packed_codes=True)
    said = [r.getMessage() for r in caplog.records]
    assert len(said) == 1 and "degrading to the streamed" in said[0]
    assert got.output["streamed"]
    for k in ("feat", "thr", "value", "na_left", "is_split"):
        np.testing.assert_array_equal(got.trees[k], want.trees[k])


def test_oom_in_a_refused_configuration_is_raised_again(monkeypatch):
    """Where the streamed path refuses the configuration (multinomial),
    the out-of-memory error itself is raised, the refusal chained."""
    cols, y, kw, _valid, _est = _refusal_case("multinomial")
    monkeypatch.setattr(TorchGBM, "_train_dense", _oom)
    tmm.reset()
    fr = th2o.Frame.from_numpy(cols, device="cpu")
    with pytest.raises(RuntimeError, match="out of memory") as e:
        TorchGBM(ntrees=1, max_depth=2, **kw).train(y=y, training_frame=fr)
    assert isinstance(e.value.__cause__, NotImplementedError)


def test_depth_zero_streams_no_features():
    """A stump train reads no feature: the window uploads none, and the
    root value is the one leaf of the dense stump (within 1e-6)."""
    cols = _cols()
    dense = _torch_train(cols, None, max_depth=0)
    st = _torch_train(cols, RESIDENT, max_depth=0)
    sp = st.output["stream_profile"]
    assert sp["h2d_resident_bytes"] == 3 * 4 * ROWS
    np.testing.assert_allclose(st.trees["value"], dense.trees["value"],
                               rtol=1e-6)
