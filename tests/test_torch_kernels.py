"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file
imports neither JAX nor the JAX package, so it also runs where only the
port is installed: ``python -m pytest --noconftest -m gpu
tests/test_torch_kernels.py``."""
import numpy as np
import pytest
import torch

from h2o3_tpu_torch.ops import hist_adaptive as tha
from h2o3_tpu_torch.ops import kernels


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(rows, F, W, N, seed, int_ghw, dev):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, W - 1, size=(rows, F))
    codes[rng.random((rows, F)) < 0.07] = W - 1
    n_prev, base = N // 2, N - 1
    m = max(n_prev, 1)
    nid = (base - n_prev + rng.integers(0, m, rows)).astype(np.int32)
    if int_ghw:
        g = rng.integers(-8, 9, rows).astype(np.float32)
        h = rng.integers(0, 4, rows).astype(np.float32)
    else:
        g = rng.normal(size=rows).astype(np.float32)
        h = (rng.random(rows) * 0.25).astype(np.float32)
    ghw = np.stack([g, h, np.ones(rows, np.float32)])
    tables = tha.make_tables(rng.integers(0, F, m), rng.integers(1, W - 1, m),
                             rng.random(m) < 0.5, rng.random(m) < 0.8)
    return (torch.as_tensor(codes, device=dev).to(tha.code_dtype(W)),
            torch.as_tensor(nid, device=dev), torch.as_tensor(ghw, device=dev),
            tables.to(dev).contiguous(), n_prev, base)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("N", [1, 8, 32, 128])
def test_binned_level_integer_mass_bit_equal(cuda, W, N):
    c, n, g, t, n_prev, base = _inputs(50_000, 9, W, N, N + W, True, cuda)
    before = kernels.LAUNCHES["binned_level"]
    nid_k, hist_k = tha.binned_level(c, n, g, t, n_prev, N, base, W)
    assert kernels.LAUNCHES["binned_level"] == before + 1
    nid_p, hist_p = tha.binned_level_plain(c, n, g, t, n_prev, N, base, W)
    assert torch.equal(nid_k, nid_p)
    assert torch.equal(hist_k, hist_p)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
def test_binned_level_float_mass_close(cuda, bf16):
    c, n, g, t, n_prev, base = _inputs(200_000, 28, 16, 8, 3, False, cuda)
    nid_k, hist_k = tha.binned_level(c, n, g, t, n_prev, 8, base, 16, bf16)
    nid_p, hist_p = tha.binned_level_plain(c, n, g.double(), t, n_prev, 8,
                                           base, 16, bf16)
    _n, mass = tha.binned_level_plain(c, n, g.double().abs(), t, n_prev, 8,
                                      base, 16, bf16)
    assert torch.equal(nid_k, nid_p)
    # float32 sums in any order are accurate relative to the bin's
    # absolute mass, not to a signed sum that may cancel
    assert bool(((hist_k.double() - hist_p).abs()
                 <= 1e-4 + 1e-5 * mass).all())


@pytest.mark.gpu
@pytest.mark.parametrize("W", [16, 256])
def test_binned_route_only_bit_equal(cuda, W):
    c, n, _g, t, n_prev, base = _inputs(50_000, 9, W, 64, 5, True, cuda)
    before = kernels.LAUNCHES["binned_route_only"]
    got = tha.binned_route_only(c, n, t, n_prev, base, W)
    assert kernels.LAUNCHES["binned_route_only"] == before + 1
    assert torch.equal(got, tha.binned_route_only_plain(c, n, t, n_prev,
                                                        base, W))


@pytest.mark.gpu
def test_wrappers_check_their_operands(cuda):
    c, n, g, t, n_prev, base = _inputs(1000, 4, 16, 4, 1, True, cuda)
    with pytest.raises(TypeError):
        kernels.binned_level(c.to(torch.int16), n, g, t, n_prev, 4, base, 16,
                             False)
    with pytest.raises(ValueError):
        kernels.binned_level(c, n[:-1], g, t, n_prev, 4, base, 16, False)
    with pytest.raises(ValueError):
        kernels.binned_level(c.t(), n, g, t, n_prev, 4, base, 16, False)
