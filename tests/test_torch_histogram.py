"""Parity of the port's global-sketch histogram (h2o3_tpu_torch.ops.
histogram) with the JAX package: its plain version against the CPU
scatter reference ``_hist_scatter3`` at float32, and against the TPU
kernel ``hist_pallas3`` run in interpret mode at float32 and at bfloat16
(the TPU kernel rounds each (g, h, w) to bf16 before its float32 add)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h2o3_tpu.ops.hist_pallas import hist_pallas_from_rowmajor
from h2o3_tpu.ops.histogram import _hist_scatter3
from h2o3_tpu_torch.ops import histogram as thist
from h2o3_tpu_torch.ops import kernels
from torch_threads import torch_worker_threads  # noqa: F401 (autouse)


def _inputs(rows, F, n_nodes, B1, dtype, seed):
    """Codes with NA (the last bin), node ids with out-of-range values on
    both sides, and float (g, h, w) with some zero weights."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, B1 - 1, (rows, F))
    codes[rng.random((rows, F)) < 0.08] = B1 - 1          # NA bin
    seg = rng.integers(0, n_nodes, rows).astype(np.int32)
    out = rng.random(rows)
    seg[out < 0.07] = -1
    seg[(out >= 0.07) & (out < 0.1)] = n_nodes
    seg[(out >= 0.1) & (out < 0.12)] = n_nodes + 3
    g = rng.normal(size=rows).astype(np.float32)
    h = rng.random(rows).astype(np.float32)
    w = (rng.random(rows) < 0.9).astype(np.float32)
    return codes.astype(dtype), seg, np.stack([g, h, w])


def _plain(codes, seg, ghw, n_nodes, B1, bf16=False):
    return thist.build_histograms_plain(
        torch.as_tensor(codes), torch.as_tensor(seg), torch.as_tensor(ghw),
        n_nodes, B1, bf16).numpy()


@pytest.mark.parametrize("B1,dtype", [(15, np.uint8), (15, np.int32),
                                      (301, np.int32)])
@pytest.mark.parametrize("n_nodes", [1, 4])
def test_plain_matches_scatter_reference(B1, dtype, n_nodes):
    codes, seg, ghw = _inputs(3000, 5, n_nodes, B1, dtype, B1 + n_nodes)
    got = _plain(codes, seg, ghw, n_nodes, B1)
    ref = np.stack([np.asarray(t) for t in _hist_scatter3(
        jnp.asarray(codes), jnp.asarray(seg), jnp.asarray(ghw), n_nodes,
        B1)])
    assert got.shape == (3, n_nodes, 5, B1) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # out-of-range rows are excluded: the w mass is the in-range weight
    live = (seg >= 0) & (seg < n_nodes)
    np.testing.assert_allclose(got[2].sum(axis=(0, 2)),
                               np.full(5, ghw[2][live].sum()), rtol=1e-6)


def _interpret(codes, seg, ghw, n_nodes, B1, mxu_dtype):
    """The TPU kernel in interpret mode, as tests/test_fixes.py runs it;
    [3, n_nodes, F, B1]."""
    got = hist_pallas_from_rowmajor(
        jnp.asarray(codes.astype(np.int32)), jnp.asarray(seg),
        jnp.asarray(ghw[0]), jnp.asarray(ghw[1]), jnp.asarray(ghw[2]),
        n_nodes, B1, tile=256, mxu_dtype=mxu_dtype, interpret=True)
    return np.moveaxis(np.asarray(got), -1, 0)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B1,dtype", [(15, np.uint8), (301, np.int32)])
def test_plain_matches_tpu_kernel_in_interpret_mode(bf16, B1, dtype):
    n_nodes = 3
    codes, seg, ghw = _inputs(1000, 3, n_nodes, B1, dtype, 11 + B1)
    got = _plain(codes, seg, ghw, n_nodes, B1, bf16)
    want = _interpret(codes, seg, ghw, n_nodes, B1,
                      jnp.bfloat16 if bf16 else jnp.float32)
    # both add the same (rounded) values in float32, in another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if bf16:
        # the rounding is real: the float32 plain version is further away
        f32 = _plain(codes, seg, ghw, n_nodes, B1, False)
        assert np.abs(f32 - want).max() > 100 * np.abs(got - want).max()


def test_dispatcher_returns_the_plain_triple_on_cpu():
    codes, seg, ghw = _inputs(500, 4, 2, 15, np.uint8, 3)
    before = dict(kernels.LAUNCHES)
    trip = thist.build_histograms(torch.as_tensor(codes),
                                  torch.as_tensor(seg),
                                  torch.as_tensor(ghw), 2, 15)
    assert kernels.LAUNCHES == before
    want = _plain(codes, seg, ghw, 2, 15)
    assert len(trip) == 3
    for k in range(3):
        assert tuple(trip[k].shape) == (2, 4, 15)
        np.testing.assert_array_equal(trip[k].numpy(), want[k])


def test_dispatcher_sends_cuda_to_the_kernel_only(monkeypatch):
    class _FakeCuda:
        class device:
            type = "cuda"

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    calls = []
    monkeypatch.setattr(thist, "build_histograms_plain", refuse)
    monkeypatch.setattr(kernels, "global_hist",
                        lambda *a: calls.append(a[3:]) or ("g", "h", "w"))
    t = _FakeCuda()
    assert thist.build_histograms(t, t, t, 4, 1025, True) == ("g", "h", "w")
    assert calls == [(4, 1025, True)]
    meta = torch.empty((8, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        thist.build_histograms(meta, meta, meta, 1, 15)


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA kernel"):
        kernels.global_hist(torch.zeros((8, 2), dtype=torch.int32),
                            torch.zeros(8, dtype=torch.int32),
                            torch.zeros((3, 8)), 1, 15, False)
    for shared in (False, True):
        with pytest.raises(ValueError, match="CUDA kernel"):
            kernels.global_hist_form(torch.zeros((8, 2), dtype=torch.int32),
                                     torch.zeros(8, dtype=torch.int32),
                                     torch.zeros((3, 8)), 1, 15, False,
                                     shared)
