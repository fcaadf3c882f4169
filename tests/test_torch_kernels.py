"""The CUDA kernels against their plain PyTorch versions, on the card:
binned_level / binned_route_only on packed codes, adaptive_level /
adaptive_route_only on raw features in both layouts.

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


# ------------------------------------------------------------ adaptive bins


def _adaptive_inputs(rows, F, W, N, seed, int_ghw, layout, dev,
                     specials=False):
    """Raw features with NaN (and, with ``specials``, ±inf on a live
    range and on a zero-span feature), nid in the previous level's
    window, (g, h, w), float32 split tables and per-node ranges."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, F)).astype(np.float32)
    x[rng.random((rows, F)) < 0.07] = np.nan
    n_prev, base = N // 2, N - 1
    m = max(n_prev, 1)
    nid = (base - n_prev + rng.integers(0, m, rows)).astype(np.int32)
    lo = (rng.normal(size=(N, F)) - 2.5).astype(np.float32)
    inv = rng.uniform(0.5, 2.0, size=(N, F)).astype(np.float32) * (W - 2) / 5
    inv = inv.astype(np.float32)
    if specials:
        x[:, 1] = 0.5
        x[0::5, 1] = np.inf
        x[2::5, 1] = -np.inf
        x[1::7, 0] = np.inf
        x[3::7, 0] = -np.inf
        lo[:, 1], inv[:, 1] = 0.5, 0.0            # zero span
    if int_ghw:
        g = rng.integers(-8, 9, rows).astype(np.float32)
        h = rng.integers(0, 4, rows).astype(np.float32)
    else:
        g = rng.normal(size=rows).astype(np.float32)
        h = (rng.random(rows) * 0.25).astype(np.float32)
    ghw = np.stack([g, h, np.ones(rows, np.float32)])
    tables = tha.make_adaptive_tables(
        torch.as_tensor(rng.integers(0, F, m)),
        torch.as_tensor(rng.normal(size=m).astype(np.float32)),
        torch.as_tensor(rng.random(m) < 0.5),
        torch.as_tensor(rng.random(m) < 0.8))
    xs = x if layout == "rows_f" else np.ascontiguousarray(x.T)
    return (torch.as_tensor(xs, device=dev), torch.as_tensor(nid, device=dev),
            torch.as_tensor(ghw, device=dev), tables.to(dev).contiguous(),
            torch.as_tensor(lo, device=dev), torch.as_tensor(inv, device=dev),
            n_prev, base)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["rows_f", "f_rows"])
@pytest.mark.parametrize("W", [16, 32, 256])
@pytest.mark.parametrize("N", [1, 8, 32])
def test_adaptive_level_integer_mass_bit_equal(cuda, layout, W, N):
    x, n, g, t, lo, inv, n_prev, base = _adaptive_inputs(
        50_000, 9, W, N, N + W, True, layout, cuda)
    before = kernels.LAUNCHES["adaptive_level"]
    nid_k, hist_k = tha.adaptive_level(x, n, g, t, lo, inv, n_prev, N, base,
                                       W, layout=layout)
    assert kernels.LAUNCHES["adaptive_level"] == before + 1
    nid_p, hist_p = tha.adaptive_level_plain(x, n, g, t, lo, inv, n_prev, N,
                                             base, W, layout=layout)
    assert torch.equal(nid_k, nid_p)
    assert torch.equal(hist_k, hist_p)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["rows_f", "f_rows"])
@pytest.mark.parametrize("bf16", [False, True])
def test_adaptive_level_float_mass_close(cuda, layout, bf16):
    x, n, g, t, lo, inv, n_prev, base = _adaptive_inputs(
        200_000, 28, 32, 8, 3, False, layout, cuda)
    nid_k, hist_k = tha.adaptive_level(x, n, g, t, lo, inv, n_prev, 8, base,
                                       32, bf16, layout)
    nid_p, hist_p = tha.adaptive_level_plain(x, n, g.double(), t, lo, inv,
                                             n_prev, 8, base, 32, bf16,
                                             layout)
    _n, mass = tha.adaptive_level_plain(x, n, g.double().abs(), t, lo, inv,
                                        n_prev, 8, base, 32, bf16, layout)
    assert torch.equal(nid_k, nid_p)
    # float32 sums in any order are accurate relative to the bin's
    # absolute mass, not to a signed sum that may cancel
    assert bool(((hist_k.double() - hist_p).abs()
                 <= 1e-4 + 1e-5 * mass).all())


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["rows_f", "f_rows"])
def test_adaptive_level_nan_inf_zero_span_bit_equal(cuda, layout):
    x, n, g, t, lo, inv, n_prev, base = _adaptive_inputs(
        50_000, 6, 16, 4, 21, True, layout, cuda, specials=True)
    nid_k, hist_k = tha.adaptive_level(x, n, g, t, lo, inv, n_prev, 4, base,
                                       16, layout=layout)
    nid_p, hist_p = tha.adaptive_level_plain(x, n, g, t, lo, inv, n_prev, 4,
                                             base, 16, layout=layout)
    assert torch.equal(nid_k, nid_p)
    assert torch.equal(hist_k, hist_p)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["rows_f", "f_rows"])
def test_adaptive_route_only_bit_equal(cuda, layout):
    x, n, _g, t, _lo, _inv, n_prev, base = _adaptive_inputs(
        50_000, 9, 16, 64, 5, True, layout, cuda)
    before = kernels.LAUNCHES["adaptive_route_only"]
    got = tha.adaptive_route_only(x, n, t, n_prev, base, layout)
    assert kernels.LAUNCHES["adaptive_route_only"] == before + 1
    assert torch.equal(got, tha.adaptive_route_only_plain(x, n, t, n_prev,
                                                          base, layout))


@pytest.mark.gpu
def test_adaptive_wrappers_check_their_operands(cuda):
    x, n, g, t, lo, inv, n_prev, base = _adaptive_inputs(
        1000, 4, 16, 4, 1, True, "rows_f", cuda)
    with pytest.raises(TypeError):
        kernels.adaptive_level(x.double(), n, g, t, lo, inv, n_prev, 4, base,
                               16, False, "rows_f")
    with pytest.raises(ValueError):
        kernels.adaptive_level(x, n, g, t, lo[:1], inv, n_prev, 4, base, 16,
                               False, "rows_f")
    with pytest.raises(ValueError):       # [rows, F] read as [F, rows]
        kernels.adaptive_level(x, n, g, t, lo, inv, n_prev, 4, base, 16,
                               False, "f_rows")
    with pytest.raises(TypeError):
        kernels.adaptive_route_only(x, n, t.to(torch.int32), n_prev, base,
                                    "rows_f")
