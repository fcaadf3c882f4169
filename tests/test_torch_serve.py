"""The port's serving subsystem (h2o3_tpu_torch.serve) on the CPU.

Against the JAX package: the row codec's encoded matrices and decoded
rows, the served predictions of one GBM (carried across with
``GBMModel.from_jax_arrays``), ServeStats snapshots and the metrics
registry after the same recorded sequence, the circuit breaker and the
lanes. The port's own contracts, as the JAX package's test_serve.py
and test_serve_lanes.py hold them where no REST server or keyed store
is needed: micro-batched rows bit-match ``Model.predict``, the warm path
captures nothing and runs no eager predict outside the buckets, unknown
levels and missing columns are NA, a bad row fails only its request,
deploy-time validation, deadlines, backpressure, coalescing, columnar
responses, lanes and the single transient retry. The card's own tests
(graph replay against eager, slot reuse, a failed capture) are in
test_torch_serve_cuda.py."""
import threading
import time

import jax
import numpy as np
import pytest
import torch

import h2o3_tpu as jh2o
import h2o3_tpu_torch as th2o
from h2o3_tpu import serve as jserve
from h2o3_tpu.models.gbm import H2OGradientBoostingEstimator as JaxGBM
from h2o3_tpu.parallel.mesh import current_mesh, make_mesh, set_mesh
from h2o3_tpu.serve import circuit as jcircuit
from h2o3_tpu.serve import lanes as jlanes
from h2o3_tpu.serve.codec import RowCodec as JaxCodec
from h2o3_tpu.serve.stats import ServeStats as JaxStats
from h2o3_tpu.telemetry.registry import Registry as JaxRegistry
from h2o3_tpu_torch import serve
from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
from h2o3_tpu_torch.models.gbm import GBMModel
from h2o3_tpu_torch.serve import circuit as tcircuit
from h2o3_tpu_torch.serve import lanes
from h2o3_tpu_torch.serve.batcher import (MicroBatcher, ServeLaneShedError,
                                          ServeOverloadedError)
from h2o3_tpu_torch.serve.codec import RowCodec
from h2o3_tpu_torch.serve.registry import CompiledScorer
from h2o3_tpu_torch.serve.stats import ServeStats
from h2o3_tpu_torch.telemetry.registry import Registry

CARRIERS = np.array(["AA", "UA", "DL"], dtype=object)


@pytest.fixture(autouse=True, scope="module")
def _one_jax_device_and_cleanup():
    old = current_mesh()
    set_mesh(make_mesh(n_data=1, devices=jax.devices()[:1]))
    yield
    set_mesh(old)
    serve.shutdown_all()
    jserve.shutdown_all()


def _cols(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    num = rng.normal(size=n).astype(np.float32)
    num2 = rng.uniform(-2, 2, size=n).astype(np.float32)
    carrier = rng.integers(0, 3, size=n)
    logit = num * 1.2 - num2 + (carrier == 0) * 0.8
    y = rng.random(n) < 1 / (1 + np.exp(-logit))
    return {"dist": num, "hour": num2, "carrier": CARRIERS[carrier],
            "delayed": np.where(y, "YES", "NO").astype(object)}


def _rows_of(cols, idx):
    return [{"dist": float(cols["dist"][i]), "hour": float(cols["hour"][i]),
             "carrier": cols["carrier"][i]} for i in idx]


@pytest.fixture(scope="module")
def gbm_model():
    cols = _cols()
    fr = th2o.Frame.from_numpy(cols, device="cpu")
    m = H2OGradientBoostingEstimator(ntrees=10, max_depth=3, seed=1,
                                     min_rows=1.0).train(
        y="delayed", training_frame=fr).model
    m.key = "serve_gbm"
    return cols, fr, m


@pytest.fixture(scope="module")
def carried():
    """A JAX GBM and the port's copy of it."""
    cols = _cols(n=1500, seed=4)
    jm = JaxGBM(ntrees=6, max_depth=3, seed=1, min_rows=1.0).train(
        y="delayed", training_frame=jh2o.Frame.from_numpy(cols)).model
    meta = {"dist_name": jm.dist_name, "n_bins": jm.n_bins,
            "max_depth": jm.max_depth, "ntrees_built": jm.ntrees_built,
            "nclasses": jm.nclasses, "names": jm.feature_names,
            "response_domain": jm.response_domain,
            "is_cat": jm.feature_is_cat, "cat_domains": jm.cat_domains}
    tm = GBMModel.from_jax_arrays(jm._save_arrays(), meta, device="cpu")
    return cols, jm, tm


def _odd_rows(cols):
    rows = _rows_of(cols, range(12))
    rows[1]["carrier"] = "ZZ"              # unknown level
    del rows[2]["hour"]                    # missing column
    rows[3]["carrier"] = 2                 # int-coded level
    rows[4]["carrier"] = 9                 # int code out of range
    rows[5]["dist"] = None
    rows[6] = {}
    return rows


def _probs(preds, dom):
    return np.array([[p["classProbabilities"][d] for d in dom]
                     for p in preds])


# ------------------------------------------------------- against JAX

def test_codec_encode_matches_jax(carried):
    cols, jm, tm = carried
    rows = _odd_rows(cols)
    jc, tc = JaxCodec(jm), RowCodec(tm)
    for pad in (None, 12, 64):
        got, want = tc.encode(rows, pad), jc.encode(rows, pad)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert tc.unknown_categorical_levels_seen == \
        jc.unknown_categorical_levels_seen == {"carrier": 6}   # 2 x 3
    with pytest.raises(ValueError, match="pad_to"):
        tc.encode(rows, 4)


@pytest.mark.parametrize("n", [1, 7, 64])
def test_codec_decode_matches_jax(carried, n):
    _cols_, jm, tm = carried
    rng = np.random.default_rng(n)
    p1 = rng.random(64).astype(np.float32)
    scores = np.stack([1 - p1, p1], 1)
    scores[3] = 0.5                              # an argmax tie
    jd = JaxCodec(jm).decode_batch(scores, n)
    td = RowCodec(tm).decode_batch(scores, n)
    assert td.rows(0, n) == jd.rows(0, n)
    assert td.columns(0, n) == jd.columns(0, n)
    assert td.rows(n // 2, n - n // 2) == jd.rows(n // 2, n - n // 2)


def test_served_rows_match_jax_served_rows(carried):
    cols, jm, tm = carried
    rows = _rows_of(cols, range(200)) + _odd_rows(cols)
    jdep = jserve.deploy("serve_carried_jax", model=jm, buckets=(1, 8, 64),
                         max_batch=64)
    tdep = serve.deploy("serve_carried", model=tm, buckets=(1, 8, 64),
                        max_batch=64)
    try:
        want = jdep.predict_rows(rows)
        got = tdep.predict_rows(rows)
        assert [g["label"] for g in got] == [w["label"] for w in want]
        np.testing.assert_allclose(_probs(got, ("NO", "YES")),
                                   _probs(want, ("NO", "YES")),
                                   rtol=0, atol=1e-6)
        cw = jdep.predict_columnar(rows)
        cg = tdep.predict_columnar(rows)
        assert cg["predict"] == cw["predict"]
        np.testing.assert_allclose(cg["pYES"], cw["pYES"], rtol=0,
                                   atol=1e-6)
    finally:
        jserve.undeploy("serve_carried_jax")
        serve.undeploy("serve_carried")


def _record(stats):
    """One sequence of serve events."""
    for i in range(30):
        stats.record_request(float(i % 7) + 0.25 * i, 1 + i % 3,
                             lane=("interactive", "bulk")[i % 2])
    stats.record_batch(5, 8, {"queue": 1.5, "encode": 0.25,
                              "device": 3.0, "decode": 0.5})
    stats.record_batch(60, 64, {"queue": 0.5, "encode": 1.0,
                                "device": 4.0, "decode": 0.75})
    stats.record_error()
    stats.record_timeout()
    stats.record_rejected()
    stats.record_retry()
    stats.record_lane_shed("bulk")
    stats.queue_delta(9)
    stats.queue_delta(-4)
    stats.record_failed_exemplar(500.0, 3, None, "deadline")


def _strip_times(snap):
    snap = dict(snap)
    snap["slow_requests"] = [{k: v for k, v in e.items() if k != "time"}
                             for e in snap["slow_requests"]]
    return snap


def test_serve_stats_snapshot_matches_jax():
    ts, js = ServeStats("parity_model_t"), JaxStats("parity_model_j")
    _record(ts)
    _record(js)
    assert _strip_times(ts.snapshot()) == _strip_times(js.snapshot())
    assert ts.percentiles_ms([10, 50, 90]) == js.percentiles_ms([10, 50, 90])
    assert ts.stage_ms == js.stage_ms
    assert serve.stats()["total"].keys() == jserve.stats()["total"].keys()


def _drive_registry(reg):
    c = reg.counter("req_total", {"model": "m"}, help="requests")
    c.inc()
    c.inc(2.5)
    g = reg.gauge("depth", {"model": "m"})
    g.set(4)
    g.inc(-1)
    g.set_max(2)
    g.set_max(11)
    h = reg.histogram("lat_ms", {"model": "m"}, bounds=(1.0, 5.0, 25.0))
    for v in (0.5, 1.0, 3.0, 30.0, 5.0):
        h.observe(v)
    with pytest.raises(TypeError):
        reg.gauge("req_total", {"model": "m"})
    with pytest.raises(TypeError):
        reg.counter("lat_ms", {"model": "x"})
    reg.add_collector(lambda: [{"name": "view", "value": 3.0}])
    off = type(reg)(enabled=False)
    off.counter("x").inc(5)
    return (reg.samples(), reg.snapshot(), reg.value("req_total",
                                                     {"model": "m"}),
            h.cumulative(), off.value("x"))


def test_registry_matches_jax():
    assert _drive_registry(Registry()) == _drive_registry(JaxRegistry())


def test_circuit_breaker_matches_jax():
    def drive(mod):
        br = mod.CircuitBreaker(model="cb", failure_threshold=2,
                                open_secs=0.05)
        seen = [br.state, br.allow_request()]
        br.record_failure()
        seen.append(br.state)
        br.record_failure()
        seen += [br.state, br.allow_request() is not None]
        time.sleep(0.08)
        seen += [br.allow_request(), br.state,
                 br.allow_request() is not None]
        br.record_success()
        seen += [br.state, br.snapshot()["open_count"]]
        pub = br.publish()
        seen.append({k: v for k, v in pub.items() if k != "time"})
        return seen
    assert drive(tcircuit) == drive(jcircuit)


def test_lanes_match_jax(monkeypatch):
    assert lanes.LANES == jlanes.LANES
    assert lanes.LANE_LEVELS == jlanes.LANE_LEVELS
    assert lanes.DEFAULT_LANE == jlanes.DEFAULT_LANE
    for path in ("/3/Predictions/models/m/rows", "/3/Frames/f1",
                 "/3/DownloadDataset", "/x/predict", ""):
        assert lanes.default_for_path(path) == jlanes.default_for_path(path)
    for raw in ("", "0.8", "7.0", "junk", "0"):
        monkeypatch.setenv("H2O3_SERVE_LANE_BULK", raw)
        for ln in lanes.LANES:
            assert lanes.budget_fraction(ln) == jlanes.budget_fraction(ln)


def test_lane_normalize_defaults_and_rejects_unknown():
    assert lanes.normalize(None) == "interactive"
    assert lanes.normalize("") == "interactive"
    assert lanes.normalize(" Bulk ") == "bulk"
    with pytest.raises(ValueError, match="unknown lane"):
        lanes.normalize("express")


# ------------------------------------------- the port's own contracts

def test_microbatched_predictions_bit_match_predict(gbm_model):
    cols, fr, model = gbm_model
    dep = serve.deploy("serve_gbm", model=model,
                       buckets=(1, 8, 64), max_batch=64, max_delay_ms=1.0)
    try:
        idx = list(range(200))
        rows = _rows_of(cols, idx)
        ref = model.predict(fr.rows(np.asarray(idx)))
        ref_p = {d: ref.vec(f"p{d}").to_numpy() for d in
                 model.response_domain}
        ref_lbl = list(ref.vec("predict").to_strings())
        per = 20
        outs, errs = {}, []

        def client(ci):
            try:
                outs[ci] = dep.predict_rows(rows[ci * per: (ci + 1) * per])
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=client, args=(ci,))
                   for ci in range(len(rows) // per)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not errs, errs
        preds = [p for ci in range(len(threads)) for p in outs[ci]]
        assert len(preds) == len(idx)
        for i, p in enumerate(preds):
            assert p["label"] == ref_lbl[i]
            for d in model.response_domain:
                assert p["classProbabilities"][d] == float(ref_p[d][i]), \
                    (i, d)
        snap = dep.stats.snapshot()
        assert snap["rows"] == len(idx) and snap["batches"] >= 1
    finally:
        serve.undeploy("serve_gbm")


def test_warm_path_no_capture_and_no_eager_outside_buckets(gbm_model):
    cols, _fr, model = gbm_model
    dep = serve.deploy("serve_gbm", model=model,
                       buckets=(1, 8, 64), max_batch=64, max_delay_ms=0.5)
    try:
        sc = dep.scorer
        assert not sc.graphed and dep.info()["graphed"] is False
        assert sc.captures == 0 and set(sc.warm_seconds) == {1, 8, 64}
        calls = []
        real = sc._masked

        def counting(X, n):
            calls.append(X.shape[0])
            return real(X, n)
        sc._masked = counting
        rows = _rows_of(cols, range(64))
        eager0 = sc.eager_calls
        for n in (1, 3, 8, 17, 64, 5, 1, 33):
            assert len(dep.predict_rows(rows[:n])) == n
        assert sc.captures == 0 and sc.replays == 0
        assert set(calls) <= {1, 8, 64}
        assert sc.eager_calls - eager0 == len(calls) == 8
        with pytest.raises(ValueError, match="not a bucket"):
            sc.score(np.zeros((5, 3), np.float32), 5)
    finally:
        serve.undeploy("serve_gbm")


def test_unknown_levels_and_missing_columns_na(gbm_model):
    _cols_, _fr, model = gbm_model
    dep = serve.deploy("serve_gbm", model=model, buckets=(1, 8),
                       max_batch=8)
    try:
        out = dep.predict_rows([{"dist": 500.0, "carrier": "ZZ"},
                                {"dist": 500.0}])
        assert len(out) == 2
        for p in out:
            assert abs(sum(p["classProbabilities"].values()) - 1.0) < 1e-6
        assert out[0] == out[1]              # "ZZ" scores as NA
        assert dep.codec.unknown_categorical_levels_seen.get("carrier") == 1
    finally:
        serve.undeploy("serve_gbm")


def test_bad_row_fails_only_its_own_request(gbm_model):
    cols, _fr, model = gbm_model
    dep = serve.deploy("serve_gbm", model=model, buckets=(1, 8, 64),
                       max_batch=64, max_delay_ms=30.0)
    try:
        good_rows = _rows_of(cols, range(3))
        results = {}

        def client(name, rows):
            try:
                results[name] = dep.predict_rows(rows)
            except Exception as e:  # noqa: BLE001
                results[name] = e

        threads = [
            threading.Thread(target=client, args=("good", good_rows)),
            threading.Thread(target=client,
                             args=("bad", [{"dist": "not-a-number"}])),
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert isinstance(results["bad"], serve.ServeBadRequestError)
        assert serve.ServeBadRequestError.http_status == 400
        assert isinstance(results["good"], list) and \
            len(results["good"]) == 3
    finally:
        serve.undeploy("serve_gbm")


def test_deploy_rejects_one_dim_classifier_output():
    class FakeUplift:
        algo = "upliftdrf"
        feature_names = ["a", "b"]
        cat_domains = {}
        response_domain = ("0", "1")
        nclasses = 2
        params = {}
        device = torch.device("cpu")

        def _predict_matrix(self, X):
            return torch.zeros(X.shape[0])       # 1-D uplift margin

    with pytest.raises(ValueError, match="not row-servable"):
        serve.deploy("fake_uplift", model=FakeUplift(), buckets=(1, 8),
                     max_batch=8)
    assert serve.deployment("fake_uplift") is None


def test_deploy_prunes_buckets_and_checks_its_config(gbm_model):
    _cols_, _fr, model = gbm_model
    dep = serve.deploy("serve_gbm", model=model, max_batch=64)
    try:
        assert dep.info()["compiled_buckets"] == [1, 8, 64]
        assert serve.deployments() == [dep]
        with pytest.raises(ValueError, match="max_batch"):
            serve.deploy("serve_gbm", model=model, max_batch=9999,
                         buckets=(1, 8))
        assert serve.deployment("serve_gbm") is dep     # still serving
        model.params["offset_column"] = "off"
        with pytest.raises(ValueError, match="offset"):
            serve.deploy("serve_gbm_off", model=model)
    finally:
        model.params.pop("offset_column", None)
        serve.undeploy("serve_gbm")
    assert serve.undeploy("serve_gbm") is False
    with pytest.raises(KeyError, match="not deployed"):
        serve.predict_rows("serve_gbm", [{"dist": 1.0}])


def test_deploy_by_key_alone_waits_for_the_keyed_store():
    with pytest.raises(NotImplementedError, match="item 18"):
        serve.deploy("some_key")


def test_model_predict_rows_deploys_once_and_reuses(gbm_model):
    cols, fr, model = gbm_model
    try:
        rows = _rows_of(cols, range(5))
        first = model.predict_rows(rows)
        dep = serve.deployment(model.key)
        assert dep is not None
        assert model.predict_rows(rows) == first
        assert serve.deployment(model.key) is dep
        assert serve.predict_rows(model.key, rows) == first
        ref = model.predict(fr.rows(np.arange(5))).vec("pYES").to_numpy()
        assert [p["classProbabilities"]["YES"] for p in first] == \
            [float(v) for v in ref]
        st = serve.stats()
        assert st["models"][model.key]["rows"] == 15
        assert st["models"][model.key]["circuit"]["state"] == "closed"
        assert [c["model"] for c in serve.circuit_states()] == [model.key]
    finally:
        serve.shutdown_all()
    assert serve.deployments() == []


def test_gaussian_served_values_bit_match_predict():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(600, 3)).astype(np.float32)
    y = (X[:, 0] - 2 * X[:, 1] + rng.normal(size=600)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    fr = th2o.Frame.from_numpy({"a": X[:, 0], "b": X[:, 1], "c": X[:, 2],
                                "y": y}, device="cpu")
    m = H2OGradientBoostingEstimator(ntrees=5, max_depth=3, seed=2,
                                     distribution="gaussian").train(
        y="y", training_frame=fr).model
    rows = [{k: (None if np.isnan(v) else float(v))
             for k, v in zip("abc", X[i])} for i in range(100)]
    dep = serve.deploy("serve_gauss", model=m, buckets=(1, 8, 64, 512),
                       max_batch=64)
    try:
        got = [p["value"] for p in dep.predict_rows(rows)]
        col = dep.predict_columnar(rows)["predict"]
    finally:
        serve.undeploy("serve_gauss")
    want = [float(v) for v in m.predict(fr.rows(np.arange(100))).vec(
        "predict").to_numpy()]
    assert got == want and col == want


def test_balance_classes_correction_served_equals_predict(gbm_model,
                                                          carried):
    """With the class distributions set, predict and the served rows both
    un-correct the probabilities, equal to each other and to the JAX
    formula."""
    cols, fr, model = gbm_model
    _c, jm, _tm = carried
    probs = model._predict_matrix(fr.as_matrix(model.feature_names)[:50])
    want_plain = probs.numpy()
    model.output.update(prior_class_dist=[0.7, 0.3],
                        model_class_dist=[0.5, 0.5])
    jm.output.update(prior_class_dist=[0.7, 0.3],
                     model_class_dist=[0.5, 0.5])
    try:
        got = model._correct_probabilities(probs).numpy()
        np.testing.assert_array_equal(
            got, jm._correct_probabilities(want_plain))
        assert not np.array_equal(got, want_plain)
        dep = serve.deploy("serve_gbm", model=model, buckets=(1, 8, 64),
                           max_batch=64)
        rows = _rows_of(cols, range(50))
        served = dep.predict_rows(rows)
        pred = model.predict(fr.rows(np.arange(50)))
        assert [p["label"] for p in served] == \
            list(pred.vec("predict").to_strings())
        np.testing.assert_array_equal(
            _probs(served, ("NO", "YES"))[:, 1],
            pred.vec("pYES").to_numpy().astype(np.float64))
        np.testing.assert_array_equal(
            _probs(served, ("NO", "YES"))[:, 1], got[:, 1])
    finally:
        for m in (model, jm):
            m.output.pop("prior_class_dist", None)
            m.output.pop("model_class_dist", None)
        serve.undeploy("serve_gbm")


def test_columnar_bit_matches_row_dicts(gbm_model):
    cols, _fr, model = gbm_model
    dep = serve.deploy("serve_gbm", model=model, max_batch=128,
                       max_delay_ms=0.5)
    try:
        rows = _rows_of(cols, range(160))      # spans two sub-batches
        rd = dep.predict_rows(rows)
        cd = dep.predict_columnar(rows)
        assert sorted(cd) == ["pNO", "pYES", "predict"]
        assert len(cd["predict"]) == len(rows)
        for i in range(len(rows)):
            assert cd["predict"][i] == rd[i]["label"]
            assert cd["pYES"][i] == rd[i]["classProbabilities"]["YES"]
            assert cd["pNO"][i] == rd[i]["classProbabilities"]["NO"]
    finally:
        serve.undeploy("serve_gbm")


def test_columnar_and_row_requests_share_a_batch(gbm_model):
    cols, _fr, model = gbm_model
    # a window wide enough that both threads arrive in it on a loaded
    # host (the batch closes at max_batch rows or the window's end)
    dep = serve.deploy("serve_gbm", model=model, max_batch=64,
                       max_delay_ms=300.0)
    try:
        rows = _rows_of(cols, range(8))
        outs = {}

        def go(fmt):
            outs[fmt] = (dep.predict_columnar(rows) if fmt == "col"
                         else dep.predict_rows(rows))

        ts = [threading.Thread(target=go, args=(f,))
              for f in ("col", "row")]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        assert len(outs["row"]) == 8
        assert len(outs["col"]["predict"]) == 8
        for i in range(8):
            assert outs["col"]["predict"][i] == outs["row"][i]["label"]
        assert dep.stats.snapshot()["batches"] == 1
    finally:
        serve.undeploy("serve_gbm")


def test_scorer_slots_reused_in_order_keep_their_own_rows(gbm_model):
    """More batches of one bucket than its ring has slots, up to the ring
    in flight at once: each fetch returns its own batch's scores, with
    the pad rows 0 after a fuller batch used the same slot."""
    cols, fr, model = gbm_model
    sc = CompiledScorer(model, buckets=(8,))
    codec = RowCodec(model)
    X = fr.as_matrix(model.feature_names)
    want = model._predict_matrix(X).numpy()
    start = 0
    for _round in range(4):
        handles = []
        for k in range(sc.ring):
            n = 8 if k % 2 == 0 else 3
            enc = codec.encode(_rows_of(cols, range(start, start + n)), 8)
            handles.append((sc.score(enc, n), start, n))
            start += n
        for h, s0, n in handles:
            got = sc.fetch(h)
            np.testing.assert_array_equal(got[:n], want[s0:s0 + n])
            assert (got[n:] == 0).all()


# ------------------------------- batcher admission control and lanes

def _gated_batcher(gate=None, stats=None, order=None, sleep_s=0.0,
                   fail=None, **kw):
    def encode(rows, pad):
        X = np.zeros((pad, 1), np.float32)
        X[: len(rows), 0] = [float(r["x"]) for r in rows]
        return X

    def dispatch(X, n):
        if gate is not None:
            gate.wait()
        if fail is not None and fail:
            raise fail.pop(0)
        if order is not None:
            order.append([float(v) for v in X[:n, 0]])
        if sleep_s:
            time.sleep(sleep_s)
        return X[:, 0] * 2.0

    def decode(scores, n):
        vals = np.asarray(scores)[:n]

        class _Decoded:
            def rows(self, off, k):
                return [{"value": float(v)} for v in vals[off:off + k]]

            def columns(self, off, k):
                return {"value": [float(v) for v in vals[off:off + k]]}

        return _Decoded()

    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay_ms", 1.0)
    return MicroBatcher(encode=encode, dispatch=dispatch, decode=decode,
                        stats=stats or ServeStats(),
                        bucket_for=lambda n: kw["max_batch"], **kw)


def test_deadline_expiry_raises_and_counts():
    gate = threading.Event()          # closed: device "hangs"
    stats = ServeStats()
    mb = _gated_batcher(gate, stats=stats)
    try:
        with pytest.raises(serve.ServeDeadlineError):
            mb.submit([{"x": 1.0}], timeout_ms=80)
        assert stats.snapshot()["timeouts"] == 1
    finally:
        gate.set()
        mb.close()


def test_queue_backpressure_rejects_with_503():
    gate = threading.Event()
    stats = ServeStats()
    mb = _gated_batcher(gate, stats=stats, max_batch=2, queue_limit=4)
    results = {}

    def bg(i):
        try:
            results[i] = mb.submit([{"x": float(i)}, {"x": float(i)}],
                                   timeout_ms=10_000)
        except Exception as e:  # noqa: BLE001
            results[i] = e

    try:
        t0 = threading.Thread(target=bg, args=(0,))
        t0.start()
        for _ in range(400):
            if mb.pending_rows == 0 and stats.queue_depth >= 2:
                break
            time.sleep(0.005)
        threads = [threading.Thread(target=bg, args=(i,)) for i in (1, 2)]
        for t in threads:
            t.start()
        for _ in range(400):
            if mb.pending_rows == 4:
                break
            time.sleep(0.005)
        assert mb.pending_rows == 4
        with pytest.raises(ServeOverloadedError):
            mb.submit([{"x": 9.0}], timeout_ms=1_000)
        assert stats.snapshot()["rejected"] == 1
        assert serve.ServeOverloadedError.http_status == 503
        gate.set()
        t0.join(5)
        for t in threads:
            t.join(5)
        for i in (0, 1, 2):
            assert isinstance(results[i], list), results[i]
            assert results[i][0]["value"] == 2.0 * i
    finally:
        gate.set()
        mb.close()


def test_batcher_coalesces_within_tick():
    stats = ServeStats()
    mb = _gated_batcher(stats=stats, max_batch=8, max_delay_ms=30.0)
    try:
        outs = []
        threads = [threading.Thread(
            target=lambda i=i: outs.append(
                mb.submit([{"x": float(i)}])[0]["value"]))
            for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(5)
        snap = stats.snapshot()
        assert sorted(outs) == [0.0, 2.0, 4.0, 6.0]
        assert snap["batches"] <= 2, snap
        assert snap["mean_batch_occupancy"] >= 2.0, snap
    finally:
        mb.close()


def test_one_transient_retry_then_the_breaker():
    stats = ServeStats()
    br = tcircuit.CircuitBreaker(model="retry", failure_threshold=2,
                                 open_secs=60.0, stats=stats)
    fail = [RuntimeError("UNAVAILABLE: card busy")]
    mb = _gated_batcher(stats=stats, fail=fail, breaker=br)
    try:
        assert mb.submit([{"x": 3.0}])[0]["value"] == 6.0
        assert stats.retries == 1 and not fail
        # a persistent failure is not retried and counts against the card
        for _ in range(2):
            fail.append(ValueError("bad kernel"))
            with pytest.raises(ValueError, match="bad kernel"):
                mb.submit([{"x": 1.0}])
        assert br.state == "open"
        with pytest.raises(serve.ServeCircuitOpenError) as ei:
            mb.submit([{"x": 1.0}])
        assert ei.value.retry_after_s > 0
        assert stats.snapshot()["errors"] == 2
    finally:
        mb.close()


def test_closed_batcher_refuses():
    mb = _gated_batcher()
    mb.close()
    with pytest.raises(serve.ServeClosedError):
        mb.submit([{"x": 1.0}])
    with pytest.raises(ValueError, match="max_batch"):
        mb.submit([{"x": 1.0}] * 5)


def test_bulk_sheds_at_its_budget_interactive_still_admitted():
    gate = threading.Event()
    stats = ServeStats()
    mb = _gated_batcher(gate, stats=stats, max_batch=2, queue_limit=4)
    results = {}

    def bg(tag, rows, lane):
        try:
            results[tag] = mb.submit(rows, timeout_ms=10_000, lane=lane)
        except Exception as e:  # noqa: BLE001
            results[tag] = e

    try:
        t0 = threading.Thread(target=bg, args=(
            "warm", [{"x": 0.0}, {"x": 0.0}], None))
        t0.start()
        for _ in range(400):
            if mb.pending_rows == 0 and stats.queue_depth >= 2:
                break
            time.sleep(0.005)
        tb = threading.Thread(target=bg, args=(
            "bulk0", [{"x": 1.0}, {"x": 2.0}], "bulk"))
        tb.start()
        for _ in range(400):
            if mb.pending_rows == 2:
                break
            time.sleep(0.005)
        with pytest.raises(ServeLaneShedError) as ei:
            mb.submit([{"x": 3.0}], timeout_ms=1_000, lane="bulk")
        assert ei.value.retry_after_s > 0
        assert ei.value.http_status == 503
        assert isinstance(ei.value, ServeOverloadedError)
        with pytest.raises(ServeLaneShedError):
            mb.submit([{"x": 4.0}, {"x": 5.0}], timeout_ms=1_000,
                      lane="background")
        ti = threading.Thread(target=bg, args=(
            "inter", [{"x": 6.0}], "interactive"))
        ti.start()
        for _ in range(400):
            if mb.pending_rows == 3:
                break
            time.sleep(0.005)
        assert mb.pending_rows == 3
        gate.set()
        for t in (t0, tb, ti):
            t.join(5)
        assert [r["value"] for r in results["inter"]] == [12.0]
        assert [r["value"] for r in results["bulk0"]] == [2.0, 4.0]
        snap = stats.snapshot()["lanes"]
        assert snap["bulk"]["shed"] == 1
        assert snap["background"]["shed"] == 1
        assert snap["bulk"]["requests"] == 1
        assert snap["interactive"]["requests"] == 2
    finally:
        gate.set()
        mb.close()


def test_interactive_admitted_behind_bulk_boards_next_batch():
    gate = threading.Event()
    order = []
    mb = _gated_batcher(gate, order=order, max_batch=2, queue_limit=8)
    results = {}

    def bg(tag, rows, lane):
        try:
            results[tag] = mb.submit(rows, timeout_ms=10_000, lane=lane)
        except Exception as e:  # noqa: BLE001
            results[tag] = e

    try:
        t0 = threading.Thread(target=bg, args=(
            "warm", [{"x": 1.0}, {"x": 1.0}], None))
        t0.start()
        for _ in range(400):
            if mb.pending_rows == 0 and mb.stats.queue_depth >= 2:
                break
            time.sleep(0.005)
        tb = threading.Thread(target=bg, args=(
            "bulk", [{"x": 10.0}, {"x": 10.0}], "bulk"))
        tb.start()
        for _ in range(400):
            if mb.pending_rows == 2:
                break
            time.sleep(0.005)
        ti = threading.Thread(target=bg, args=(
            "inter", [{"x": 20.0}, {"x": 20.0}], "interactive"))
        ti.start()
        for _ in range(400):
            if mb.pending_rows == 4:
                break
            time.sleep(0.005)
        gate.set()
        for t in (t0, tb, ti):
            t.join(5)
        assert order[0] == [1.0, 1.0]
        assert order[1] == [20.0, 20.0]
        assert order[2] == [10.0, 10.0]
    finally:
        gate.set()
        mb.close()


def test_interactive_p99_holds_under_saturating_bulk_flood():
    def run_round(flood):
        stats = ServeStats()
        mb = _gated_batcher(stats=stats, sleep_s=0.002, max_batch=8,
                            queue_limit=16, max_delay_ms=1.0)
        stop = threading.Event()
        shed = [0]

        def bulk_hammer():
            while not stop.is_set():
                try:
                    mb.submit([{"x": 1.0}] * 8, timeout_ms=2_000,
                              lane="bulk")
                except ServeLaneShedError:
                    shed[0] += 1
                    time.sleep(0.001)
                except Exception:  # noqa: BLE001 — flood is best-effort
                    pass

        threads = [threading.Thread(target=bulk_hammer)
                   for _ in range(4 if flood else 0)]
        for t in threads:
            t.start()
        try:
            time.sleep(0.05)
            for _ in range(120):
                mb.submit([{"x": 2.0}], timeout_ms=10_000,
                          lane="interactive")
        finally:
            stop.set()
            for t in threads:
                t.join(5)
            mb.close()
        (p99,) = stats.lane_percentiles_ms("interactive", [99])
        return p99, shed[0]

    solo_p99, _ = run_round(flood=False)
    under_p99, sheds = run_round(flood=True)
    assert solo_p99 is not None and under_p99 is not None
    assert sheds > 0, "the flood never saturated the bulk budget"
    assert under_p99 <= max(2.0 * solo_p99, solo_p99 + 25.0), \
        f"interactive p99 {under_p99:.1f}ms vs solo {solo_p99:.1f}ms"


def test_lane_percentiles_reservoir():
    stats = ServeStats()
    for i in range(100):
        stats.record_request(float(i + 1), 1, lane="bulk")
    p50, p99 = stats.lane_percentiles_ms("bulk", [50, 99])
    assert 45 <= p50 <= 55
    assert 95 <= p99 <= 100
    assert stats.lane_percentiles_ms("background", [50]) == [None]
    lanes_snap = stats.snapshot()["lanes"]
    assert lanes_snap["bulk"]["requests"] == 100
    assert lanes_snap["bulk"]["p50_ms"] == p50
