"""Serving on the card (marked ``gpu``; imports nothing of JAX, so that it
runs where JAX is absent): each bucket's CUDA graph replays to the bits
of the eager predict, 64 batches of one bucket dispatched back to back
with two in flight each decode to their own rows, served rows bit-match
``Model.predict`` with no capture and no eager predict after deploy, and
a capture that fails raises out of deploy."""
import threading

import numpy as np
import pytest
import torch

import h2o3_tpu_torch as th2o
from h2o3_tpu_torch import serve
from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
from h2o3_tpu_torch.serve.codec import RowCodec
from h2o3_tpu_torch.serve.registry import CompiledScorer

CARRIERS = np.array(["AA", "UA", "DL", "B6"], dtype=object)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest -m gpu tests/test_torch_serve_cuda.py)")
    return torch.device("cuda")


def _cols(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=n).astype(np.float32)
    b = rng.uniform(-2, 2, size=n).astype(np.float32)
    c = rng.integers(0, 4, size=n)
    y = rng.random(n) < 1 / (1 + np.exp(-(a * 1.2 - b + (c == 0) * 0.8)))
    a[rng.random(n) < 0.05] = np.nan
    return {"a": a, "b": b, "carrier": CARRIERS[c],
            "delayed": np.where(y, "YES", "NO").astype(object)}


def _rows_of(cols, idx):
    return [{"a": None if np.isnan(cols["a"][i]) else float(cols["a"][i]),
             "b": float(cols["b"][i]), "carrier": cols["carrier"][i]}
            for i in idx]


def _model(dev):
    cols = _cols()
    fr = th2o.Frame.from_numpy(cols, device=dev)
    m = H2OGradientBoostingEstimator(ntrees=8, max_depth=4, seed=1,
                                     min_rows=1.0).train(
        y="delayed", training_frame=fr).model
    return cols, fr, m


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


@pytest.mark.gpu
def test_replay_equals_eager_bit_for_bit_at_every_bucket(cuda):
    cols, fr, m = _model(cuda)
    sc = CompiledScorer(m)
    assert sc.graphed and sc.captures == len(sc.buckets)
    codec = RowCodec(m)
    rng = np.random.default_rng(1)
    for b in sc.buckets:
        for n in sorted({1, max(b // 2, 1), b}):
            idx = rng.integers(0, fr.nrow, size=n)
            X = codec.encode(_rows_of(cols, idx), b)
            got = sc.fetch(sc.score(X, n))
            want = sc._masked(torch.as_tensor(X, device=cuda),
                              torch.tensor([n], device=cuda)).cpu().numpy()
            assert np.array_equal(_bits(got), _bits(want)), (b, n)
            assert (got[n:] == 0).all()
    assert sc.replays == sum(len({1, max(b // 2, 1), b})
                             for b in sc.buckets)


@pytest.mark.gpu
def test_back_to_back_batches_of_one_bucket_keep_their_rows(cuda):
    cols, fr, m = _model(cuda)
    sc = CompiledScorer(m, buckets=(64,))
    codec = RowCodec(m)
    X_all = fr.as_matrix(m.feature_names)
    want = m._predict_matrix(X_all).cpu().numpy()
    rng = np.random.default_rng(2)
    inflight, start = [], 0
    for k in range(64):
        n = int(rng.integers(1, 65))
        idx = np.arange(start, start + n) % fr.nrow
        X = codec.encode(_rows_of(cols, idx), 64)
        inflight.append((sc.score(X, n), idx, n))
        start += n
        if len(inflight) > 2:               # two in flight, as the batcher
            h, i0, n0 = inflight.pop(0)
            got = sc.fetch(h)
            assert np.array_equal(_bits(got[:n0]), _bits(want[i0])), k
            assert (got[n0:] == 0).all()
    for h, i0, n0 in inflight:
        assert np.array_equal(_bits(sc.fetch(h)[:n0]), _bits(want[i0]))


@pytest.mark.gpu
def test_served_rows_bit_match_predict_without_capture_or_eager(cuda):
    cols, fr, m = _model(cuda)
    dep = serve.deploy("serve_card", model=m, buckets=(1, 8, 64, 512),
                       max_batch=512, max_delay_ms=1.0)
    try:
        sc = dep.scorer
        assert dep.info()["graphed"] is True
        caps, eager = sc.captures, sc.eager_calls
        idx = np.arange(600)
        rows = _rows_of(cols, idx)
        outs, errs = {}, []

        def client(ci):
            try:
                outs[ci] = dep.predict_rows(rows[ci * 40:(ci + 1) * 40])
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        ts = [threading.Thread(target=client, args=(ci,))
              for ci in range(15)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not errs, errs
        got = [p for ci in range(15) for p in outs[ci]]
        ref = m.predict(fr.rows(idx))
        lbl = list(ref.vec("predict").to_strings())
        for d in m.response_domain:
            p = ref.vec(f"p{d}").to_numpy()
            assert [g["classProbabilities"][d] for g in got] == \
                [float(v) for v in p]
        assert [g["label"] for g in got] == lbl
        assert sc.captures == caps and sc.eager_calls == eager
        assert sc.replays == dep.stats.snapshot()["batches"] > 0
    finally:
        serve.undeploy("serve_card")


@pytest.mark.gpu
def test_capture_failure_raises_out_of_deploy(cuda):
    _cols_, _fr, m = _model(cuda)

    class SyncsInPredict:
        """A predict that reads a value back to the host: legal eagerly,
        illegal while a stream is being captured."""
        algo = "gbm"
        feature_names = m.feature_names
        cat_domains = m.cat_domains
        response_domain = m.response_domain
        nclasses = 2
        params = {}
        device = cuda

        def _predict_matrix(self, X):
            out = m._predict_matrix(X)
            return out * float(out.sum().item() >= 0)

    with pytest.raises(RuntimeError):
        serve.deploy("serve_sync", model=SyncsInPredict(), buckets=(1, 8),
                     max_batch=8)
    assert serve.deployment("serve_sync") is None
    # the card still serves after the failed capture
    dep = serve.deploy("serve_after", model=m, buckets=(1,), max_batch=1)
    try:
        assert len(dep.predict_rows([{"a": 1.0}])) == 1
    finally:
        serve.undeploy("serve_after")
