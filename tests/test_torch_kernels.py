"""The CUDA kernels against their plain PyTorch versions, on the card:
binned_level (both forms) / binned_route_only on packed codes,
adaptive_level / adaptive_route_only on raw features in both layouts,
global_hist on unpacked global-sketch codes, the int8 fixed-point levels
binned_level_i8 / adaptive_level_i8, leaf_totals and segment_totals; and
the kernels whose float sums come in a fixed order launched five times
on inputs where any change of order would show.

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
@pytest.mark.parametrize("W", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("N", [1, 2, 4, 8, 16, 32])
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
@pytest.mark.parametrize("W,N", [(16, 1), (32, 8), (32, 32), (64, 2),
                                 (128, 4), (256, 16)])
def test_adaptive_level_float_mass_close(cuda, layout, bf16, W, N):
    x, n, g, t, lo, inv, n_prev, base = _adaptive_inputs(
        200_000, 28, W, N, 3, False, layout, cuda)
    nid_k, hist_k = tha.adaptive_level(x, n, g, t, lo, inv, n_prev, N, base,
                                       W, bf16, layout)
    nid_p, hist_p = tha.adaptive_level_plain(x, n, g.double(), t, lo, inv,
                                             n_prev, N, base, W, bf16,
                                             layout)
    _n, mass = tha.adaptive_level_plain(x, n, g.double().abs(), t, lo, inv,
                                        n_prev, N, base, W, bf16, layout)
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


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
def test_adaptive_level_atomics_ablation_close(cuda, bf16):
    x, n, g, t, lo, inv, n_prev, base = _adaptive_inputs(
        200_000, 28, 32, 8, 4, False, "rows_f", cuda)
    nid_k, hist_k = kernels.adaptive_level_atomics(x, n, g, t, lo, inv,
                                                   n_prev, 8, base, 32, bf16)
    nid_p, hist_p = tha.adaptive_level_plain(x, n, g.double(), t, lo, inv,
                                             n_prev, 8, base, 32, bf16)
    _n, mass = tha.adaptive_level_plain(x, n, g.double().abs(), t, lo, inv,
                                        n_prev, 8, base, 32, bf16)
    assert torch.equal(nid_k, nid_p)
    assert bool(((hist_k.double() - hist_p).abs()
                 <= 1e-4 + 1e-5 * mass).all())


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
def test_grouped_adaptive_level_repeats_bit_for_bit(cuda, bf16):
    """No float atomics in the grouped [rows, F] level: the same inputs
    give the same bits every launch."""
    x, n, g, t, lo, inv, n_prev, base = _adaptive_inputs(
        300_000, 28, 32, 16, 6, False, "rows_f", cuda)
    runs = [tha.adaptive_level(x, n, g, t, lo, inv, n_prev, 16, base, 32,
                               bf16)[1] for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("rows,G", [(100_000, 1), (300_000, 48),
                                    (50_000, 4096), (0, 3), (1, 2)])
def test_group_rows_matches_plain(cuda, rows, G):
    from h2o3_tpu_torch.ops.common import group_rows_plain
    rng = np.random.default_rng(rows + G)
    keys = torch.as_tensor(rng.integers(-2, G + 2, rows).astype(np.int32),
                           device=cuda)
    ghw = torch.as_tensor(rng.normal(size=(3, rows)).astype(np.float32),
                          device=cuda)
    off_k, rec = kernels.group_rows(keys, G, ghw)
    off_p, idx_p = group_rows_plain(keys, G)
    assert torch.equal(off_k, off_p)
    n = int(off_p[-1])
    assert torch.equal(rec[:n, 0].view(torch.int32), idx_p[:n])
    assert torch.equal(rec[:n, 1:].t(), ghw[:, idx_p[:n].long()])
    _off, rec0 = kernels.group_rows(keys, G)          # no masses: zeros
    assert torch.equal(rec0[:n, 0].view(torch.int32), idx_p[:n])
    assert not rec0[:n, 1:].any()


# ------------------------------------------------------------ global sketch


def _global_inputs(rows, F, B1, N, seed, int_ghw, dev):
    """Codes (uint8 below 256 bins, else int32) with NA in the last bin,
    node ids with out-of-range rows on both sides, and (g, h, w)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, B1 - 1, size=(rows, F))
    codes[rng.random((rows, F)) < 0.07] = B1 - 1
    seg = rng.integers(0, N, rows).astype(np.int32)
    out = rng.random(rows)
    seg[out < 0.08] = -1
    seg[(out >= 0.08) & (out < 0.1)] = N
    if int_ghw:
        g = rng.integers(-8, 9, rows).astype(np.float32)
        h = rng.integers(0, 4, rows).astype(np.float32)
    else:
        g = rng.normal(size=rows).astype(np.float32)
        h = (rng.random(rows) * 0.25).astype(np.float32)
    ghw = np.stack([g, h, np.ones(rows, np.float32)])
    dtype = torch.uint8 if B1 <= 256 else torch.int32
    return (torch.as_tensor(codes, device=dev).to(dtype),
            torch.as_tensor(seg, device=dev), torch.as_tensor(ghw, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("B1", [15, 257, 1025])
@pytest.mark.parametrize("N", [1, 2, 4, 8, 16, 32])
def test_global_hist_integer_mass_bit_equal(cuda, B1, N):
    from h2o3_tpu_torch.ops import histogram as thist
    c, s, g = _global_inputs(50_000, 9, B1, N, B1 + N, True, cuda)
    before = kernels.LAUNCHES["global_hist"]
    trip = thist.build_histograms(c, s, g, N, B1)
    assert kernels.LAUNCHES["global_hist"] == before + 1
    want = thist.build_histograms_plain(c, s, g, N, B1)
    assert torch.equal(torch.stack(trip), want)
    # both forms of the kernel, whichever the shapes pick
    for shared in (False, True):
        assert torch.equal(kernels.global_hist_form(c, s, g, N, B1, False,
                                                    shared), want)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B1", [15, 257, 1025])
@pytest.mark.parametrize("N", [1, 8, 16])
def test_global_hist_float_mass_close(cuda, bf16, B1, N):
    from h2o3_tpu_torch.ops import histogram as thist
    c, s, g = _global_inputs(200_000, 28, B1, N, 3, False, cuda)
    hk = kernels.global_hist(c, s, g, N, B1, bf16)
    hp = thist.build_histograms_plain(c, s, g.double(), N, B1, bf16)
    mass = thist.build_histograms_plain(c, s, g.double().abs(), N, B1, bf16)
    # float32 sums in any order are accurate relative to the bin's
    # absolute mass, not to a signed sum that may cancel
    assert bool(((hk.double() - hp).abs() <= 1e-4 + 1e-5 * mass).all())


@pytest.mark.gpu
def test_global_hist_checks_its_operands(cuda):
    c, s, g = _global_inputs(1000, 4, 15, 4, 1, True, cuda)
    with pytest.raises(TypeError):
        kernels.global_hist(c.to(torch.int16), s, g, 4, 15, False)
    with pytest.raises(ValueError):
        kernels.global_hist(c, s[:-1], g, 4, 15, False)
    with pytest.raises(ValueError):
        kernels.global_hist(c.t(), s, g, 4, 15, False)
    # one (node, feature) cell of 9000 bins is past the shared budget:
    # the kernel adds with global atomics, no tiling needed
    from h2o3_tpu_torch.ops.histogram import build_histograms_plain
    c9 = c.to(torch.int32) * 600
    assert torch.equal(kernels.global_hist(c9, s, g, 4, 9000, False),
                       build_histograms_plain(c9, s, g, 4, 9000))
    # and the shared form, forced, refuses it
    with pytest.raises(RuntimeError, match="CUDA error"):
        kernels.global_hist_form(c9, s, g, 4, 9000, False, True)


# ------------------------------------------------- int8 levels, leaf totals


def _off_window(nid, N, seed):
    """5% of the rows outside every level's window."""
    rng = np.random.default_rng(seed)
    out = torch.as_tensor(rng.random(nid.shape[0]) < 0.05, device=nid.device)
    return torch.where(out, 2 * N + 7, nid).to(torch.int32).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("W", [16, 32, 256])
@pytest.mark.parametrize("terms,N", [(1, 1), (1, 8), (1, 32), (2, 1),
                                     (2, 8), (2, 16)])
def test_binned_level_i8_bit_equal(cuda, W, terms, N):
    c, n, g, t, n_prev, base = _inputs(50_000, 9, W, N, N + W, False, cuda)
    n = _off_window(n, N, W)
    q, s = tha.quantize_ghw_i8(g, terms)
    before = kernels.LAUNCHES["binned_level_i8"]
    nid_k, hist_k = tha.binned_level(c, n, g, t, n_prev, N, base, W, True,
                                     (q, s))
    assert kernels.LAUNCHES["binned_level_i8"] == before + 1
    nid_p, hist_p = tha.binned_level_i8_plain(c, n, q, s, t, n_prev, N, base,
                                              W)
    assert torch.equal(nid_k, nid_p)
    assert torch.equal(hist_k, hist_p)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["rows_f", "f_rows"])
@pytest.mark.parametrize("W", [16, 32, 256])
@pytest.mark.parametrize("terms,N", [(1, 8), (1, 32), (2, 16)])
def test_adaptive_level_i8_bit_equal(cuda, layout, W, terms, N):
    x, n, g, t, lo, inv, n_prev, base = _adaptive_inputs(
        50_000, 9, W, N, N + W + terms, False, layout, cuda)
    n = _off_window(n, N, W)
    q, s = tha.quantize_ghw_i8(g, terms)
    before = kernels.LAUNCHES["adaptive_level_i8"]
    nid_k, hist_k = tha.adaptive_level(x, n, g, t, lo, inv, n_prev, N, base,
                                       W, True, layout, (q, s))
    assert kernels.LAUNCHES["adaptive_level_i8"] == before + 1
    nid_p, hist_p = tha.adaptive_level_i8_plain(x, n, q, s, t, lo, inv,
                                                n_prev, N, base, W, layout)
    assert torch.equal(nid_k, nid_p)
    assert torch.equal(hist_k, hist_p)


@pytest.mark.gpu
@pytest.mark.parametrize("n_prev,N", [(0, 1), (32, 64), (0, 64)])
def test_leaf_totals_close(cuda, n_prev, N):
    x, _n, g, t, _lo, _inv, _p, _b = _adaptive_inputs(
        200_000, 9, 16, 2 * max(n_prev, 1), 5 + N, False, "rows_f", cuda)
    base = N - 1
    # rows in the previous level's window, or in this one's when there
    # is no route
    rng = np.random.default_rng(N)
    n = (base - n_prev + rng.integers(0, n_prev, 200_000)
         if n_prev else base + rng.integers(0, N, 200_000))
    n = _off_window(torch.as_tensor(n, device=cuda), N, N)
    before = kernels.LAUNCHES["leaf_totals"]
    nid_k, tot_k = tha.leaf_totals(x, n, g, t, n_prev, N, base)
    assert kernels.LAUNCHES["leaf_totals"] == before + 1
    nid_p, tot_p = tha.leaf_totals_plain(x, n, g.double(), t, n_prev, N,
                                         base)
    _n, mass = tha.leaf_totals_plain(x, n, g.double().abs(), t, n_prev, N,
                                     base)
    assert torch.equal(nid_k, nid_p)
    # float32 sums in another order: within 1e-4 + 1e-5 x the node's
    # absolute mass of the float64 plain version
    assert bool(((tot_k.double() - tot_p).abs() <= 1e-4 + 1e-5 * mass).all())


@pytest.mark.gpu
def test_i8_and_totals_wrappers_check_their_operands(cuda):
    c, n, g, t, n_prev, base = _inputs(1000, 4, 16, 4, 1, False, cuda)
    q, s = tha.quantize_ghw_i8(g, 2)
    with pytest.raises(TypeError):
        kernels.binned_level_i8(c, n, q.int(), s, t, n_prev, 4, base, 16)
    with pytest.raises(ValueError):
        kernels.binned_level_i8(c, n, q[:4].contiguous(), s, t, n_prev, 4,
                                base, 16)
    with pytest.raises(ValueError):
        kernels.binned_level_i8(c, n, q, s[:2], t, n_prev, 4, base, 16)
    x, n, g, t, lo, inv, n_prev, base = _adaptive_inputs(
        1000, 4, 16, 4, 1, False, "rows_f", cuda)
    with pytest.raises(ValueError):       # [rows, F] read as [F, rows]
        kernels.adaptive_level_i8(x, n, q, s, t, lo, inv, n_prev, 4, base,
                                  16, "f_rows")
    with pytest.raises(ValueError):
        kernels.leaf_totals(x.t().contiguous(), n, g, t, n_prev, 4, base)
    with pytest.raises(TypeError):
        kernels.leaf_totals(x, n, g.double(), t, n_prev, 4, base)


# ------------------------------ the grouped packed level, fixed-order sums


@pytest.mark.gpu
@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("W", [16, 32, 256])
@pytest.mark.parametrize("N", [1, 8, 32])
def test_binned_level_forms_integer_mass_bit_equal(cuda, grouped, W, N):
    c, n, g, t, n_prev, base = _inputs(60_000, 9, W, N, 7 * N + W, True, cuda)
    n = _off_window(n, N, N)
    before = kernels.LAUNCHES["binned_level"]
    nid_k, hist_k = kernels.binned_level_form(c, n, g, t, n_prev, N, base, W,
                                              False, grouped)
    assert kernels.LAUNCHES["binned_level"] == before + 1
    nid_p, hist_p = tha.binned_level_plain(c, n, g, t, n_prev, N, base, W)
    assert torch.equal(nid_k, nid_p)
    assert torch.equal(hist_k, hist_p)


@pytest.mark.gpu
@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("W,N", [(16, 1), (16, 32), (32, 8), (256, 8)])
def test_binned_level_forms_float_mass_close(cuda, grouped, bf16, W, N):
    c, n, g, t, n_prev, base = _inputs(200_000, 28, W, N, N + 1, False, cuda)
    nid_k, hist_k = kernels.binned_level_form(c, n, g, t, n_prev, N, base, W,
                                              bf16, grouped)
    nid_p, hist_p = tha.binned_level_plain(c, n, g.double(), t, n_prev, N,
                                           base, W, bf16)
    _n, mass = tha.binned_level_plain(c, n, g.double().abs(), t, n_prev, N,
                                      base, W, bf16)
    assert torch.equal(nid_k, nid_p)
    assert bool(((hist_k.double() - hist_p).abs()
                 <= 1e-4 + 1e-5 * mass).all())


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("W", [16, 32, 256])
def test_binned_level_grouped_and_tiled_agree(cuda, bf16, W):
    """The two forms against each other: the same node ids, each bin
    within twice the float tolerance (each is within it of the plain
    version)."""
    c, n, g, t, n_prev, base = _inputs(300_000, 28, W, 16, W, False, cuda)
    nid_g, hist_g = kernels.binned_level_form(c, n, g, t, n_prev, 16, base,
                                              W, bf16, True)
    nid_t, hist_t = kernels.binned_level_form(c, n, g, t, n_prev, 16, base,
                                              W, bf16, False)
    _n, mass = tha.binned_level_plain(c, n, g.double().abs(), t, n_prev, 16,
                                      base, W, bf16)
    assert torch.equal(nid_g, nid_t)
    assert bool(((hist_g.double() - hist_t.double()).abs()
                 <= 2 * (1e-4 + 1e-5 * mass)).all())


def _adversarial_masses(rows, seed, dev):
    """(g, h, w) whose float sums change with any change of order: g of
    either sign and h from 2^-20 to 2^20."""
    rng = np.random.default_rng(seed)
    sign = np.where(rng.random(rows) < 0.5, -1.0, 1.0)
    g = sign * 2.0 ** rng.integers(-20, 21, rows)
    h = 2.0 ** rng.integers(-20, 21, rows)
    return torch.as_tensor(np.stack([g, h, np.ones(rows)]).astype(np.float32),
                           device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("W,N", [(16, 1), (16, 8), (32, 32)])
def test_binned_level_grouped_repeats_bit_for_bit(cuda, bf16, W, N):
    """Five launches of the grouped form give the same bits, with every
    row of one node in one bin of every feature."""
    c, n, _g, t, n_prev, base = _inputs(400_000, 28, W, N, 9, False, cuda)
    first = n == (base - n_prev)
    c[first] = 3
    g = _adversarial_masses(n.shape[0], 9, cuda)
    runs = [kernels.binned_level_form(c, n, g, t, n_prev, N, base, W, bf16,
                                      True) for _ in range(5)]
    assert all(torch.equal(runs[0][0], r[0]) for r in runs[1:])
    assert all(torch.equal(runs[0][1], r[1]) for r in runs[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B1,N", [(15, 1), (1025, 16)])
def test_global_hist_grouped_repeats_bit_for_bit(cuda, bf16, B1, N):
    """Five launches of the node-grouped form give the same bits, with
    every row of one node in one bin of every feature."""
    c, s, _g = _global_inputs(400_000, 28, B1, N, 4, False, cuda)
    c[s == 0] = 7
    g = _adversarial_masses(s.shape[0], 4, cuda)
    runs = [kernels.global_hist_form(c, s, g, N, B1, bf16, True)
            for _ in range(5)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    from h2o3_tpu_torch.ops.histogram import build_histograms_plain
    mass = build_histograms_plain(c, s, g.double().abs(), N, B1, bf16)
    want = build_histograms_plain(c, s, g.double(), N, B1, bf16)
    assert bool(((runs[0].double() - want).abs()
                 <= 1e-4 + 1e-5 * mass).all())


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 2, 64, 512, 4096])
def test_segment_totals_close(cuda, N):
    from h2o3_tpu_torch.ops.common import segment_totals, segment_totals_plain
    rng = np.random.default_rng(N)
    rows, base = 300_000, N - 1
    n = torch.as_tensor((base + rng.integers(0, N, rows)).astype(np.int32),
                        device=cuda)
    n = _off_window(n, N, N)
    g = torch.as_tensor(np.stack([rng.normal(size=rows),
                                  rng.random(rows) * 0.25,
                                  np.ones(rows)]).astype(np.float32),
                        device=cuda)
    before = kernels.LAUNCHES["segment_totals"]
    tot = segment_totals(n, g, N, base)
    assert kernels.LAUNCHES["segment_totals"] == before + 1
    want = segment_totals_plain(n, g.double(), N, base)
    mass = segment_totals_plain(n, g.double().abs(), N, base)
    assert tot.shape == (3, N) and tot.dtype == torch.float32
    assert bool(((tot.double() - want).abs() <= 1e-4 + 1e-5 * mass).all())
    gi = torch.as_tensor(rng.integers(-8, 9, (3, rows)).astype(np.float32),
                         device=cuda)
    assert torch.equal(segment_totals(n, gi, N, base),
                       segment_totals_plain(n, gi, N, base))


@pytest.mark.gpu
@pytest.mark.parametrize("route", [False, True])
def test_totals_repeat_bit_for_bit(cuda, route):
    """Five launches of the leaf-totals kernel (with a route, and its
    segment-totals instance) give the same bits, most rows in one node."""
    from h2o3_tpu_torch.ops.common import segment_totals
    rows, N = 400_000, 64
    x, _n, _g, t, _lo, _inv, _p, _b = _adaptive_inputs(
        rows, 9, 16, 64, 8, False, "rows_f", cuda)
    rng = np.random.default_rng(8)
    n = rng.integers(0, N, rows)
    n[rng.random(rows) < 0.8] = 5
    g = _adversarial_masses(rows, 8, cuda)
    if route:
        n = torch.as_tensor((31 + n // 2).astype(np.int32), device=cuda)
        runs = [kernels.leaf_totals(x, n, g, t, 32, N, N - 1)
                for _ in range(5)]
        assert all(torch.equal(runs[0][0], r[0]) for r in runs[1:])
        runs = [r[1] for r in runs]
    else:
        n = torch.as_tensor((N - 1 + n).astype(np.int32), device=cuda)
        runs = [segment_totals(n, g, N, N - 1) for _ in range(5)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


@pytest.mark.gpu
def test_binned_form_and_segment_wrappers_check_their_operands(cuda):
    c, n, g, t, n_prev, base = _inputs(1000, 4, 16, 4, 1, False, cuda)
    with pytest.raises(ValueError):
        kernels.binned_level_form(c.t(), n, g, t, n_prev, 4, base, 16, False,
                                  True)
    with pytest.raises(ValueError):
        kernels.segment_totals(n[:-1], g, 4, base)
    with pytest.raises(TypeError):
        kernels.segment_totals(n, g.double(), 4, base)
    with pytest.raises(ValueError):
        kernels.segment_totals(n, g, 5000, base)
