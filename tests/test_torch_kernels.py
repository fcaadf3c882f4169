"""The CUDA kernels against their plain PyTorch versions, on the card:
binned_level (every form: tensor-core grouped, wide, tiled) /
binned_route_only on packed codes, adaptive_level (the wide form too) /
adaptive_route_only on raw features in both layouts, the form rule and
forced forms that do not fit,
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
@pytest.mark.parametrize(
    "rows,N,shift",
    [(50_000, 64, False),
     (50_003, 64, False),     # rows % 4 = 3
     (50_000, 2, False),      # n_prev = 1
     (50_001, 4096, False),   # n_prev 2048
     (50_002, 64, True)])     # nid not 16-byte aligned (a view at row 1)
def test_adaptive_route_only_bit_equal(cuda, layout, rows, N, shift):
    x, n, _g, t, _lo, _inv, n_prev, base = _adaptive_inputs(
        rows, 9, 16, N, 5, True, layout, cuda)
    if shift:
        n = n[1:]
        x = x[1:] if layout == "rows_f" else x[:, 1:].contiguous()
    before = kernels.LAUNCHES["adaptive_route_only"]
    got = tha.adaptive_route_only(x, n, t, n_prev, base, layout)
    assert kernels.LAUNCHES["adaptive_route_only"] == before + 1
    want = tha.adaptive_route_only_plain(x, n, t, n_prev, base, layout)
    assert torch.equal(got, want)
    if layout == "rows_f":   # K9's loads-only floor keeps nid
        assert torch.equal(kernels.adaptive_route_floor(x, n, t, n_prev,
                                                        base), n)


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


@pytest.mark.gpu
@pytest.mark.parametrize("terms", [1, 2])
@pytest.mark.parametrize("rows,G", [(100_000, 1), (300_000, 48), (1, 2)])
def test_group_rows_i8_records_match_plain(cuda, terms, rows, G):
    """The int8 records of the grouping pass: the row id, then every q
    byte (negative ones and the two-term low byte over [-128, 127])."""
    from h2o3_tpu_torch.ops.common import (group_rows_plain,
                                           pack_i8_records_plain)
    rng = np.random.default_rng(rows + G + terms)
    keys = torch.as_tensor(rng.integers(-2, G + 2, rows).astype(np.int32),
                           device=cuda)
    q = torch.as_tensor(rng.integers(-128, 128, (3 * terms, rows))
                        .astype(np.int8), device=cuda)
    off_k, rec = kernels.group_rows(keys, G, q=q)
    off_p, idx_p = group_rows_plain(keys, G)
    assert torch.equal(off_k, off_p)
    n = int(off_p[-1])
    assert rec.dtype == torch.int32 and rec.shape == (rows, 2 * terms)
    assert torch.equal(rec[:n], pack_i8_records_plain(q, idx_p[:n]))


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


def _i8_instance(form, W):
    """Whether a forced int8 form has an instance at lane width W: the
    tensor-core grouped body at W <= 32, the wide body at W >= 64."""
    return not ((form == "grouped" and W >= 64) or
                (form == "wide" and W <= 32))


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["picked", "grouped", "wide", "tiled"])
@pytest.mark.parametrize("W", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("terms,N", [(1, 1), (1, 8), (1, 32), (2, 1),
                                     (2, 8), (2, 16)])
def test_binned_level_i8_bit_equal(cuda, form, W, terms, N):
    """Every int8 form bit-equal to the plain version; a grouped form
    forced at a W it has no instance for raises."""
    c, n, g, t, n_prev, base = _inputs(50_000, 9, W, N, N + W, False, cuda)
    n = _off_window(n, N, W)
    q, s = tha.quantize_ghw_i8(g, terms)
    before = kernels.LAUNCHES["binned_level_i8"]
    if form == "picked":
        nid_k, hist_k = tha.binned_level(c, n, g, t, n_prev, N, base, W,
                                         True, (q, s))
    elif not _i8_instance(form, W):
        with pytest.raises(RuntimeError, match="CUDA error"):
            kernels.binned_level_i8_form(c, n, q, s, t, n_prev, N, base, W,
                                         form)
        return
    else:
        nid_k, hist_k = kernels.binned_level_i8_form(
            c, n, q, s, t, n_prev, N, base, W, form)
    assert kernels.LAUNCHES["binned_level_i8"] == before + 1
    nid_p, hist_p = tha.binned_level_i8_plain(c, n, q, s, t, n_prev, N, base,
                                              W)
    assert torch.equal(nid_k, nid_p)
    assert torch.equal(hist_k, hist_p)


@pytest.mark.gpu
@pytest.mark.parametrize("W,form", [(16, "grouped"), (16, "tiled"),
                                    (256, "wide"), (256, "tiled")])
def test_binned_level_i8_codes_outside_the_lanes_add_nothing(cuda, W, form):
    """Codes outside [0, W) (negative, and past the lanes of int16 codes)
    add nothing in any form; the other features see every row."""
    c, n, g, t, n_prev, base = _inputs(50_000, 6, W, 8, W, False, cuda)
    c[::13, 2] = -4
    if W == 256:
        c[5::13, 2] = 300
    q, s = tha.quantize_ghw_i8(g, 1)
    nid_k, hist_k = kernels.binned_level_i8_form(c, n, q, s, t, n_prev, 8,
                                                 base, W, form)
    nid_p = tha.binned_route_only_plain(c, n, t, n_prev, base, W)
    assert torch.equal(nid_k, nid_p)
    keep = (c[:, 2] >= 0) & (c[:, 2] < W)
    # the routed rows' histograms (no route: n_prev 0)
    _n, hist_all = tha.binned_level_i8_plain(c.clamp(0, W - 1), nid_p, q, s,
                                             t, 0, 8, base, W)
    _n, hist_in = tha.binned_level_i8_plain(c[keep], nid_p[keep], q[:, keep],
                                            s, t, 0, 8, base, W)
    other = [0, 1, 3, 4, 5]
    assert torch.equal(hist_k[:, :, other], hist_all[:, :, other])
    assert torch.equal(hist_k[:, :, 2], hist_in[:, :, 2])


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["picked", "grouped", "wide", "tiled"])
@pytest.mark.parametrize("layout", ["rows_f", "f_rows"])
@pytest.mark.parametrize("W", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("terms,N", [(1, 1), (1, 8), (1, 32), (2, 16)])
def test_adaptive_level_i8_bit_equal(cuda, form, layout, W, terms, N):
    """Every int8 form bit-equal to the plain version; a grouped form
    forced in [F, rows] or at a W it has no instance for raises."""
    x, n, g, t, lo, inv, n_prev, base = _adaptive_inputs(
        50_000, 9, W, N, N + W + terms, False, layout, cuda)
    n = _off_window(n, N, W)
    q, s = tha.quantize_ghw_i8(g, terms)
    before = kernels.LAUNCHES["adaptive_level_i8"]
    if form == "picked":
        nid_k, hist_k = tha.adaptive_level(x, n, g, t, lo, inv, n_prev, N,
                                           base, W, True, layout, (q, s))
    elif form != "tiled" and (layout == "f_rows"
                              or not _i8_instance(form, W)):
        # the grouped forms read [rows, F] only: forced, they refuse
        with pytest.raises(RuntimeError, match="CUDA error"):
            kernels.adaptive_level_i8_form(x, n, q, s, t, lo, inv, n_prev, N,
                                           base, W, layout, form)
        return
    else:
        nid_k, hist_k = kernels.adaptive_level_i8_form(
            x, n, q, s, t, lo, inv, n_prev, N, base, W, layout, form)
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
@pytest.mark.parametrize("W,form", [(16, "grouped"), (16, "tiled"),
                                    (32, "grouped"), (32, "tiled"),
                                    (256, "tiled")])
@pytest.mark.parametrize("N", [1, 8, 32])
def test_binned_level_forms_integer_mass_bit_equal(cuda, W, form, N):
    c, n, g, t, n_prev, base = _inputs(60_000, 9, W, N, 7 * N + W, True, cuda)
    n = _off_window(n, N, N)
    before = kernels.LAUNCHES["binned_level"]
    nid_k, hist_k = kernels.binned_level_form(c, n, g, t, n_prev, N, base, W,
                                              False, form)
    assert kernels.LAUNCHES["binned_level"] == before + 1
    nid_p, hist_p = tha.binned_level_plain(c, n, g, t, n_prev, N, base, W)
    assert torch.equal(nid_k, nid_p)
    assert torch.equal(hist_k, hist_p)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("W,N,form", [
    (16, 1, "grouped"), (16, 1, "tiled"), (16, 32, "grouped"),
    (16, 32, "tiled"), (32, 8, "grouped"), (32, 8, "tiled"),
    (256, 8, "tiled")])
def test_binned_level_forms_float_mass_close(cuda, bf16, W, N, form):
    c, n, g, t, n_prev, base = _inputs(200_000, 28, W, N, N + 1, False, cuda)
    nid_k, hist_k = kernels.binned_level_form(c, n, g, t, n_prev, N, base, W,
                                              bf16, form)
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
    """A node-grouped form (tensor-core at W <= 32, wide at W = 256) and
    the tiled body against each other: the same node ids, each bin within
    twice the float tolerance (each is within it of the plain
    version)."""
    c, n, g, t, n_prev, base = _inputs(300_000, 28, W, 16, W, False, cuda)
    nid_g, hist_g = kernels.binned_level_form(c, n, g, t, n_prev, 16, base,
                                              W, bf16,
                                              "grouped" if W <= 32 else "wide")
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
@pytest.mark.parametrize("form", ["picked", "lanes", "match"])
@pytest.mark.parametrize(
    "N,rows,one_node",
    [(1, 300_000, False), (2, 300_000, False), (64, 300_000, False),
     (512, 300_000, False), (4096, 300_000, False),
     # rows % 4 = 1, 2, 3: h and w start off a 16-byte boundary
     (64, 300_001, False), (64, 300_002, False), (64, 300_003, False),
     # every row in one node
     (1, 300_001, True), (64, 300_002, True), (4096, 300_003, True)])
def test_segment_totals_close(cuda, N, rows, one_node, form):
    from h2o3_tpu_torch.ops.common import segment_totals, segment_totals_plain
    rng = np.random.default_rng(N + rows)
    base = N - 1
    if one_node:
        n = torch.full((rows,), base + N // 2, dtype=torch.int32,
                       device=cuda)
    else:
        n = torch.as_tensor((base + rng.integers(0, N, rows))
                            .astype(np.int32), device=cuda)
        n = _off_window(n, N, N)
    g = torch.as_tensor(np.stack([rng.normal(size=rows),
                                  rng.random(rows) * 0.25,
                                  np.ones(rows)]).astype(np.float32),
                        device=cuda)

    def run(ghw):
        if form == "picked":
            return segment_totals(n, ghw, N, base)
        return kernels.segment_totals_form(n, ghw, N, base, form)
    if form == "lanes" and N > 533:      # one lane-column slot past budget
        with pytest.raises(RuntimeError):
            run(g)
        return
    before = kernels.LAUNCHES["segment_totals"]
    tot = run(g)
    assert kernels.LAUNCHES["segment_totals"] == before + 1
    want = segment_totals_plain(n, g.double(), N, base)
    mass = segment_totals_plain(n, g.double().abs(), N, base)
    assert tot.shape == (3, N) and tot.dtype == torch.float32
    assert bool(((tot.double() - want).abs() <= 1e-4 + 1e-5 * mass).all())
    gi = torch.as_tensor(rng.integers(-8, 9, (3, rows)).astype(np.float32),
                         device=cuda)
    assert torch.equal(run(gi), segment_totals_plain(n, gi, N, base))


@pytest.mark.gpu
@pytest.mark.parametrize("route,form", [(False, "picked"), (False, "match"),
                                        (True, "picked")])
@pytest.mark.parametrize("share", [0.8, 1.0])
def test_totals_repeat_bit_for_bit(cuda, route, form, share):
    """Five launches of the leaf-totals kernel (with a route, and its
    segment-totals instance in both forms) give the same bits, most rows
    (share 0.8) or every row (1.0) in one node."""
    from h2o3_tpu_torch.ops.common import segment_totals
    rows, N = 400_000, 64
    x, _n, _g, t, _lo, _inv, _p, _b = _adaptive_inputs(
        rows, 9, 16, 64, 8, False, "rows_f", cuda)
    rng = np.random.default_rng(8)
    n = rng.integers(0, N, rows)
    n[rng.random(rows) < share] = 5
    g = _adversarial_masses(rows, 8, cuda)
    if route:
        n = torch.as_tensor((31 + n // 2).astype(np.int32), device=cuda)
        runs = [kernels.leaf_totals(x, n, g, t, 32, N, N - 1)
                for _ in range(5)]
        assert all(torch.equal(runs[0][0], r[0]) for r in runs[1:])
        runs = [r[1] for r in runs]
    else:
        n = torch.as_tensor((N - 1 + n).astype(np.int32), device=cuda)
        runs = [segment_totals(n, g, N, N - 1) if form == "picked" else
                kernels.segment_totals_form(n, g, N, N - 1, form)
                for _ in range(5)]
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


# ------------------------------------ the wide levels (W = 64, 128, 256)


def _wide_level(kind, rows, F, W, N, seed, int_ghw, dev):
    """One level's inputs (packed codes, int16 at W = 256; or raw features
    in [rows, F]), 5% of the rows off every window; returns (launch of a
    form by name, plain version on masses g, the masses)."""
    if kind == "binned":
        c, n, g, t, n_prev, base = _inputs(rows, F, W, N, seed, int_ghw, dev)
        n = _off_window(n, N, seed)

        def launch(form, bf16=False):
            return kernels.binned_level_form(c, n, g, t, n_prev, N, base, W,
                                             bf16, form)

        def plain(gg, bf16=False):
            return tha.binned_level_plain(c, n, gg, t, n_prev, N, base, W,
                                          bf16)
        return launch, plain, g
    x, n, g, t, lo, inv, n_prev, base = _adaptive_inputs(
        rows, F, W, N, seed, int_ghw, "rows_f", dev)
    n = _off_window(n, N, seed)

    def launch(form, bf16=False):
        return kernels.adaptive_level_form(x, n, g, t, lo, inv, n_prev, N,
                                           base, W, bf16, "rows_f", form)

    def plain(gg, bf16=False):
        return tha.adaptive_level_plain(x, n, gg, t, lo, inv, n_prev, N,
                                        base, W, bf16)
    return launch, plain, g


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["binned", "adaptive"])
@pytest.mark.parametrize("W", [64, 128, 256])
@pytest.mark.parametrize("N", [1, 8, 32])
def test_wide_forms_integer_mass_bit_equal(cuda, kind, W, N):
    launch, plain, g = _wide_level(kind, 60_000, 28, W, N, 11 * N + W, True,
                                   cuda)
    name = f"{kind}_level"
    before = kernels.LAUNCHES[name]
    nid_k, hist_k = launch("wide")
    assert kernels.LAUNCHES[name] == before + 1
    nid_p, hist_p = plain(g)
    assert torch.equal(nid_k, nid_p)
    assert torch.equal(hist_k, hist_p)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["binned", "adaptive"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("W,N", [(64, 1), (64, 32), (128, 8), (256, 1),
                                 (256, 32)])
def test_wide_form_float_mass_close(cuda, kind, bf16, W, N):
    launch, plain, g = _wide_level(kind, 200_000, 28, W, N, N + W, False,
                                   cuda)
    nid_k, hist_k = launch("wide", bf16)
    nid_p, hist_p = plain(g.double(), bf16)
    _n, mass = plain(g.double().abs(), bf16)
    assert torch.equal(nid_k, nid_p)
    assert bool(((hist_k.double() - hist_p).abs()
                 <= 1e-4 + 1e-5 * mass).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["binned", "adaptive"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("W,N", [(64, 1), (256, 8)])
def test_wide_form_repeats_bit_for_bit(cuda, kind, bf16, W, N):
    """Five launches of the wide form give the same bits on masses whose
    float sums change with any change of order."""
    launch, _plain, g = _wide_level(kind, 400_000, 28, W, N, 13, False, cuda)
    g.copy_(_adversarial_masses(g.shape[1], 13, cuda))
    runs = [launch("wide", bf16) for _ in range(5)]
    assert all(torch.equal(runs[0][0], r[0]) for r in runs[1:])
    assert all(torch.equal(runs[0][1], r[1]) for r in runs[1:])


@pytest.mark.gpu
def test_forced_forms_that_do_not_fit_raise(cuda):
    """A grouped form forced where it does not fit raises (the packed
    level past 512 features, the adaptive level in [F, rows], the wide
    body at W = 16 and the tensor-core body at W >= 64, which have no
    instance); the tiled body takes both; an unknown form name is
    refused."""
    c, n, g, t, n_prev, base = _inputs(4096, 600, 64, 4, 3, True, cuda)
    x, nx, gx, tx, lo, inv, px, bx = _adaptive_inputs(4096, 8, 64, 4, 3,
                                                      True, "f_rows", cuda)
    c16, n16, g16, t16, p16, b16 = _inputs(4096, 8, 16, 4, 3, True, cuda)
    x16, nx16, gx16, tx16, lo16, inv16, px16, bx16 = _adaptive_inputs(
        4096, 8, 16, 4, 3, True, "rows_f", cuda)
    with pytest.raises(RuntimeError):
        kernels.binned_level_form(c16, n16, g16, t16, p16, 4, b16, 16, False,
                                  "wide")
    with pytest.raises(RuntimeError):
        kernels.adaptive_level_form(x16, nx16, gx16, tx16, lo16, inv16, px16,
                                    4, bx16, 16, False, "rows_f", "wide")
    for form in ("grouped", "wide"):
        with pytest.raises(RuntimeError):
            kernels.binned_level_form(c, n, g, t, n_prev, 4, base, 64, False,
                                      form)
        with pytest.raises(RuntimeError):
            kernels.adaptive_level_form(x, nx, gx, tx, lo, inv, px, 4, bx,
                                        64, False, "f_rows", form)
    # the tensor-core body has no instance at W >= 64
    for W in (64, 128, 256):
        cw, nw, gw, tw, pw, bw = _inputs(4096, 8, W, 4, 3, True, cuda)
        xw, nxw, gxw, txw, low, invw, pxw, bxw = _adaptive_inputs(
            4096, 8, W, 4, 3, True, "rows_f", cuda)
        with pytest.raises(RuntimeError):
            kernels.binned_level_form(cw, nw, gw, tw, pw, 4, bw, W, False,
                                      "grouped")
        with pytest.raises(RuntimeError):
            kernels.adaptive_level_form(xw, nxw, gxw, txw, low, invw, pxw, 4,
                                        bxw, W, False, "rows_f", "grouped")
    nid_k, hist_k = kernels.binned_level_form(c, n, g, t, n_prev, 4, base, 64,
                                              False, "tiled")
    assert torch.equal(hist_k, tha.binned_level_plain(c, n, g, t, n_prev, 4,
                                                      base, 64)[1])
    with pytest.raises(ValueError):
        kernels.binned_level_form(c, n, g, t, n_prev, 4, base, 64, False,
                                  "fastest")


@pytest.mark.gpu
def test_level_form_rule(cuda):
    """The forms the kernels pick: the tensor-core body below W = 64, the
    wide body at W = 64, 128, 256, the tiled body past 512 features and in
    [F, rows]."""
    rows = 10_000_000
    for W in (16, 32):
        assert kernels.binned_level_picks(rows, 28, W, 16, 32) == "grouped"
        assert kernels.adaptive_level_picks(rows, 28, W, 16, 32) == "grouped"
    for W in (64, 128, 256):
        for N in (1, 32):
            assert kernels.binned_level_picks(rows, 28, W, N // 2, N) \
                == "wide"
            assert kernels.adaptive_level_picks(rows, 28, W, N // 2, N) \
                == "wide"
        assert kernels.adaptive_level_picks(rows, 28, W, 16, 32,
                                            "f_rows") == "tiled"
        assert kernels.binned_level_picks(rows, 600, W, 16, 32) == "tiled"


@pytest.mark.gpu
def test_i8_level_form_rule(cuda):
    """The forms the int8 levels pick: below W = 64 the tensor-core body
    at 3·terms·N >= 96, else the tiled body; from W = 64 the wide body,
    but for the tiled body where its whole partial is at most 48 KB on an
    adaptive or two-term level; the tiled body past 512 features and in
    [F, rows]."""
    rows = 10_000_000
    for W in (16, 32):
        for kind in ("binned", "adaptive"):
            picks = getattr(kernels, f"{kind}_level_i8_picks")
            assert picks(rows, 28, W, 16, 32, 1) == "grouped"
            assert picks(rows, 28, W, 8, 16, 2) == "grouped"
            assert picks(rows, 28, W, 8, 16, 1) == "tiled"
    for W in (64, 128, 256):
        for N in (8, 32):
            assert kernels.binned_level_i8_picks(rows, 28, W, N // 2, N,
                                                 1) == "wide"
            assert kernels.adaptive_level_i8_picks(rows, 28, W, N // 2, N,
                                                   1) == "wide"
        assert kernels.binned_level_i8_picks(rows, 28, W, 0, 1, 1) == "wide"
        assert kernels.adaptive_level_i8_picks(rows, 28, W, 16, 32, 1,
                                               "f_rows") == "tiled"
        assert kernels.binned_level_i8_picks(rows, 600, W, 16, 32,
                                             1) == "tiled"
    # the shallow levels whose tiled partial fits 48 KB
    assert kernels.adaptive_level_i8_picks(rows, 28, 64, 1, 2, 1) == "tiled"
    assert kernels.adaptive_level_i8_picks(rows, 28, 64, 2, 4, 1) == "wide"
    assert kernels.adaptive_level_i8_picks(rows, 28, 128, 0, 1, 1) == "tiled"
    assert kernels.adaptive_level_i8_picks(rows, 28, 256, 0, 1, 1) == "wide"
    assert kernels.binned_level_i8_picks(rows, 28, 64, 0, 1, 2) == "tiled"
    assert kernels.binned_level_i8_picks(rows, 28, 64, 1, 2, 2) == "wide"
    assert kernels.binned_level_i8_picks(rows, 28, 128, 0, 1, 2) == "wide"
