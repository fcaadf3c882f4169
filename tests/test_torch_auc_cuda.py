"""The fixed-order ``auc_device``: on the CPU, at scores that fall one
value to a bucket, the float64 sort reference; on the card (marked
``gpu``), the same bits over five calls, the CPU's bits, and the
reference within 1e-7. Imports nothing of JAX, so that it runs where JAX
is absent."""
import numpy as np
import pytest
import torch

from h2o3_tpu_torch.models import metrics as tmetrics
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)


def auc_inputs(n, seed, ties, weights):
    """Scores, labels and weights: scores on a 0.01 grid with ``ties``;
    unit, integer (1, 2) or dyadic (0.25, 0.5, 1.5) weights."""
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.4).astype(np.float32)
    p = np.clip(0.5 + 0.25 * (y - 0.4) + 0.2 * rng.normal(size=n), 0, 1)
    p = p.astype(np.float32)
    if ties:
        p = np.round(p, 2).astype(np.float32)
    w = np.ones(n, np.float32)
    if weights == "int":
        w[rng.random(n) < 0.2] = 2.0
    elif weights == "dyadic":
        w = rng.choice(np.float32([0.25, 0.5, 1.5]), n)
    return p, y, w


def auc_sorted_f64(p, y, w):
    """The AUC of the scores' own order in float64, ties as one step."""
    o = np.argsort(-p.astype(np.float64), kind="stable")
    s = p[o]
    tp = np.cumsum((w * y)[o].astype(np.float64))
    fp = np.cumsum((w * (1 - y))[o].astype(np.float64))
    last = np.r_[s[1:] != s[:-1], True]
    tp, fp = tp[last], fp[last]
    tpp, fpp = np.r_[0.0, tp[:-1]], np.r_[0.0, fp[:-1]]
    return ((fp - fpp) * (tp + tpp)).sum() * 0.5 / (tp[-1] * fp[-1])


@pytest.mark.parametrize("n,weights", [(300_000, "int"), (50_000, "dyadic")])
def test_auc_device_on_the_cpu_is_its_sort_reference(n, weights):
    """Scores on a 0.01 grid fall one value to a bucket, so the bucket
    curve is the sorted one: within 1e-7 of float64."""
    p, y, w = auc_inputs(n, 6, True, weights)
    got = float(tmetrics.auc_device(torch.as_tensor(p), torch.as_tensor(y),
                                    torch.as_tensor(w)))
    assert abs(got - auc_sorted_f64(p, y, w)) <= 1e-7


def test_bucket_sums_add_each_bucket_in_row_order():
    """A bucket's sum is its rows' float32 sum from the first row on,
    whatever the rows' positions: a run-restarted scan of the stably
    sorted rows, written once a bucket."""
    rng = np.random.default_rng(3)
    b = torch.as_tensor(rng.integers(0, 50, 20_000))
    v = torch.as_tensor(rng.normal(size=(20_000, 2)).astype(np.float32))
    got = tmetrics._bucket_sums(b, v)
    idx = torch.nonzero(b == 7)[:, 0]
    assert torch.equal(got[7], tmetrics._run_scan(v[idx])[-1])
    assert torch.equal(got[50:], torch.zeros_like(got[50:]))
    np.testing.assert_allclose(
        got[:50].numpy(),
        np.stack([np.bincount(b.numpy(), v[:, c].numpy().astype(np.float64),
                              50) for c in range(2)], 1), rtol=1e-5,
        atol=1e-4)


@pytest.mark.gpu
def test_auc_device_repeats_on_the_card():
    """Five calls on the card give the same bits, the CPU's bits too
    (elementwise adds in one order), within 1e-7 of the float64 sort
    reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest "
                    "--noconftest -m gpu tests/test_torch_auc_cuda.py)")
    p, y, w = auc_inputs(2_000_000, 7, True, "int")
    args = [torch.as_tensor(a, device="cuda") for a in (p, y, w)]
    runs = [tmetrics.auc_device(*args).cpu() for _ in range(5)]
    bits = [r.view(torch.int32).item() for r in runs]
    assert bits == bits[:1] * 5
    cpu = tmetrics.auc_device(*[torch.as_tensor(a) for a in (p, y, w)])
    assert cpu.view(torch.int32).item() == bits[0]
    assert abs(float(runs[0]) - auc_sorted_f64(p, y, w)) <= 1e-7
    # the validation path's shape: continuous scores, unit weights
    p, y, w = auc_inputs(500_000, 8, False, "ones")
    args = [torch.as_tensor(a, device="cuda") for a in (p, y, w)]
    bits = [tmetrics.auc_device(*args).view(torch.int32).item()
            for _ in range(5)]
    assert bits == bits[:1] * 5
