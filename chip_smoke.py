#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``h2o3_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a
CUDA device and the repository; without either it exits non-zero and
prints no result. It drives the port's three GBM paths: packed codes
(``histogram_type="quantiles_global"``, kernels binned_level and
binned_route_only), adaptive bins (``packed_codes=False``, H2O's
default ``uniform_adaptive``, kernels adaptive_level and
adaptive_route_only in the [rows, F] and [F, rows] layouts), the
unpacked global sketch (nbins 1024, kernel global_hist), and the packed
and adaptive paths again with int8 fixed-point masses
(``H2O3_HIST_I8=1``, set around those trains only; kernels
binned_level_i8 and adaptive_level_i8). It also holds leaf_totals, which
no path launches, against its plain version. Phases, each fatal on
failure:

1. device: the card's name and power limit;
2. build: compile the CUDA kernels from ``h2o3_tpu_torch/csrc`` (one
   nvcc per source, in parallel);
3. kernel vs plain on the card at 1M x 28, N in {1, 8, 32}: binned_level
   at W=16 (int8), W=32 (int8) and W=256 (int16), binned_route_only at
   N=64; adaptive_level at W in {16, 32, 256} and adaptive_route_only at
   N=64, both layouts, plus a case with NaN, ±inf and zero-span
   features; global_hist at B1 in {15 (uint8), 257, 1025 (int32)}, N in
   {1, 8, 16}, about 10% of the rows outside [0, N), NA codes. With
   integer-valued (g, h, w) node ids and histograms must be bit-equal to
   the plain PyTorch version; with float (g, h, w) node ids bit-equal and
   each histogram bin within 1e-4 + 1e-5 x (its absolute mass) of the
   plain version accumulated in float64, for float32 and for
   bfloat16-rounded masses. binned_level_i8 and adaptive_level_i8 (both
   layouts) at W in {16, 32, 256}, one term at N in {1, 8, 32}, two at
   N in {1, 8, 16}, NA codes / NaN features, 5% of the rows off the
   window: nid and histogram bit-equal to the plain version.
   leaf_totals at n_prev in {0, 32}, N in {1, 64}: nid bit-equal, totals
   within the float tolerance against float64;
4. the main paths at full width: 10M x 28 HIGGS-shaped rows ->
   Frame.from_numpy(device="cuda") -> bernoulli GBM, depth 6, 20 trees,
   min_rows 1, seed 7 -> training AUC -> predict; packed at nbins 14,
   adaptive at nbins 20 (W=32), then global at nbins 1024 with
   ``quantiles_global`` (B1 = 1025, int32 codes). Each path runs with the
   launch counters set to 0 just before and read just after (6 x 20
   level launches and 20 route launches of its own kernels on the packed
   and adaptive paths, 6 x 20 global_hist on the global path, 0 of any
   other kernel); then packed_i8 and adaptive_i8 on the same frame
   (6 x 20 int8 level launches, 20 route launches, 0 float level
   launches), each AUC within 0.005 of its path's bf16 AUC of this run;
5. card vs CPU, same code, each path: 200k rows, depth 6, float32
   histograms, 5 trees on each device (nbins 300 on the global path);
   tree 0's splits equal, |dAUC| <= 1e-4; and packed vs global on the
   card (200k rows, nbins 14, ``quantiles_global``, float32,
   ``packed_codes`` True vs False): every tree's split features, bins
   and NA directions identical; the two int8 paths on card and CPU at
   200k rows, depth 6, 5 trees, bf16, ``H2O3_HIST_I8`` 1 and 2: |dAUC|
   <= 1e-4, and at one term (every level an integer sum) tree 0's
   splits equal; the number of identical trees is printed;
6. timing of each kernel at the main paths' shapes (10M x 28, per level
   N = 1..32, both layouts for the adaptive kernels; global_hist at the
   six build sizes N = 1, 1, 2, 4, 8, 16 of the global path, in the form
   the shapes pick and in each form forced) against its plain version
   and its bound (global_hist also against one ``index_add_``); the
   int8 levels per level N = 1..32 at one term and N = 1..16 at two,
   beside the float level on the same inputs in the same run;
   leaf_totals at n_prev = 32, N = 64; the global_hist record comes
   last, after phase 7, whose warm global loop it is set against;
7. where the time goes: each main path's train again, warm (20 trees
   plain, three times, then 5 trees under torch.profiler: device time by
   kernel, device busy share); adaptive trained twice at float32 and
   adaptive_i8 twice at 'auto', with the split features that differ.

Before its last lines it prints each phase's wall seconds. The last
two lines of stdout are the kernel record and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside the tensor cores
SRC = {"binned_level": "h2o3_tpu_torch/csrc/hist_binned.cu",
       "binned_route_only": "h2o3_tpu_torch/csrc/hist_binned.cu",
       "binned_level_i8": "h2o3_tpu_torch/csrc/hist_binned.cu",
       "adaptive_level": "h2o3_tpu_torch/csrc/hist_adaptive.cu",
       "adaptive_route_only": "h2o3_tpu_torch/csrc/hist_adaptive.cu",
       "adaptive_level_i8": "h2o3_tpu_torch/csrc/hist_adaptive.cu",
       "leaf_totals": "h2o3_tpu_torch/csrc/hist_adaptive.cu",
       "global_hist": "h2o3_tpu_torch/csrc/hist_global.cu"}
# the TPU kernel each replaces; the adaptive kernels' layout parameter
# also covers the row-major forms (K8, K9)
REPLACES = {"binned_level": "h2o3_tpu/ops/hist_adaptive.py:930",
            "binned_route_only": "h2o3_tpu/ops/hist_adaptive.py:1282",
            "binned_level_i8": "h2o3_tpu/ops/hist_adaptive.py:1154",
            "adaptive_level": "h2o3_tpu/ops/hist_adaptive.py:641",
            "adaptive_route_only": "h2o3_tpu/ops/hist_adaptive.py:755",
            "adaptive_level_i8": "h2o3_tpu/ops/hist_adaptive.py:500",
            "leaf_totals": "h2o3_tpu/ops/hist_adaptive.py:365",
            "global_hist": "h2o3_tpu/ops/hist_pallas.py:47"}
ALSO_REPLACES = {"adaptive_level": "h2o3_tpu/ops/hist_adaptive.py:134",
                 "adaptive_route_only": "h2o3_tpu/ops/hist_adaptive.py:787"}
# the three GBM paths: their parameters and the kernels each launches
PATHS = {
    "packed": {"params": dict(nbins=14, histogram_type="quantiles_global"),
               "level": "binned_level", "route": "binned_route_only",
               "split_key": "split_bin"},
    "adaptive": {"params": dict(nbins=20, packed_codes=False),
                 "level": "adaptive_level", "route": "adaptive_route_only",
                 "split_key": "thr"},
    "global": {"params": dict(nbins=1024, histogram_type="quantiles_global"),
               "level": "global_hist", "route": None,
               "split_key": "split_bin"},
    # the packed and adaptive paths with H2O3_HIST_I8 (int8 fixed-point
    # masses, one term: every level of a depth-6 tree at bf16)
    "packed_i8": {"params": dict(nbins=14, histogram_type="quantiles_global"),
                  "level": "binned_level_i8", "route": "binned_route_only",
                  "split_key": "split_bin", "i8": 1},
    "adaptive_i8": {"params": dict(nbins=20, packed_codes=False),
                    "level": "adaptive_level_i8",
                    "route": "adaptive_route_only", "split_key": "thr",
                    "i8": 1},
}
LAYOUTS = ("rows_f", "f_rows")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# ------------------------------------------------------------ timing


def time_cuda(fn, reps: int, flush=None) -> float:
    """Median milliseconds of ``fn`` over ``reps`` calls, each between
    its own pair of CUDA events (with the L2 flushed before it when
    ``flush`` is given)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()        # evict the 50 MB L2 between launches
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def level_bound_ms(rows, F, itemsize, N, W, rows_in_level):
    """Least time for one level: each input read once (codes, nid, ghw),
    each output written once (nid', hist), or 3 float adds per
    (row in the level, feature), whichever takes longer."""
    nbytes = rows * (F * itemsize + 4 + 12 + 4) + 3 * N * F * W * 4
    ops = 3 * rows_in_level * F
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def route_bound_ms(rows, itemsize):
    """The route reads one code (or raw value), one nid and writes one
    nid per row."""
    return rows * (itemsize + 8) / HBM_BYTES_PER_S * 1e3, "bytes"


def adaptive_level_bound_ms(rows, F, N, W, rows_in_level):
    """Least time for one adaptive level: each input read once (float32
    features, nid, ghw), each output written once (nid', hist), or a
    subtract, a multiply and 3 float adds per (row in the level,
    feature), whichever takes longer."""
    nbytes = rows * (F * 4 + 4 + 12 + 4) + 3 * N * F * W * 4
    ops = 5 * rows_in_level * F
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def global_bound_ms(rows, F, itemsize, N, B1, rows_in_level):
    """Least time for one global-sketch histogram: every row's seg read
    once, the codes and ghw of the rows in [0, N) read once (no other
    row's are needed), the histogram written once; or 3 float adds per
    (row in [0, N), feature); whichever takes longer."""
    nbytes = (rows * 4 + rows_in_level * (F * itemsize + 12)
              + 3 * N * F * B1 * 4)
    ops = 3 * rows_in_level * F
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def mass_check(name, hk, hp, mass):
    """Float masses: each bin within 1e-4 + 1e-5 x its absolute mass of
    the float64 plain version."""
    excess = (hk.double() - hp).abs() - (1e-4 + 1e-5 * mass)
    if float(excess.max()) > 0:
        err = float((hk.double() - hp).abs().max())
        raise AssertionError(f"{name} float ghw: max abs err {err} beyond "
                             f"1e-4 + 1e-5 x bin mass")


# ------------------------------------------------- kernel vs plain


def level_inputs(rows, F, W, N, int_ghw, seed, dev):
    import torch
    from h2o3_tpu_torch.ops.hist_adaptive import code_dtype, make_tables
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(0, W - 1, (rows, F), generator=g, device=dev)
    na = torch.rand((rows, F), generator=g, device=dev) < 0.05
    codes = torch.where(na, W - 1, codes).to(code_dtype(W))
    n_prev, base = N // 2, N - 1
    if n_prev:
        nid = (base - n_prev + torch.randint(0, n_prev, (rows,), generator=g,
                                             device=dev)).to(torch.int32)
    else:
        nid = torch.zeros(rows, dtype=torch.int32, device=dev)
    if int_ghw:
        gg = torch.randint(-8, 9, (rows,), generator=g, device=dev).float()
        hh = torch.randint(0, 4, (rows,), generator=g, device=dev).float()
    else:
        gg = torch.randn(rows, generator=g, device=dev)
        hh = torch.rand(rows, generator=g, device=dev) * 0.25
    ghw = torch.stack([gg, hh, torch.ones(rows, device=dev)]).contiguous()
    m = max(n_prev, 1)
    tables = make_tables(
        torch.randint(0, F, (m,), generator=g, device=dev),
        torch.randint(1, W - 1, (m,), generator=g, device=dev),
        torch.rand(m, generator=g, device=dev) < 0.5,
        torch.rand(m, generator=g, device=dev) < 0.9).contiguous()
    return codes, nid, ghw, tables, n_prev, base


def check_level(rows, F, W, N, int_ghw, bf16, dev, seed):
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import binned_level_plain
    codes, nid, ghw, tables, n_prev, base = level_inputs(
        rows, F, W, N, int_ghw, seed, dev)
    nk, hk = kernels.binned_level(codes, nid, ghw, tables, n_prev, N, base,
                                  W, bf16)
    # integer masses: the float32 plain version is exact in any order.
    # Float masses: the plain version accumulates in float64, and a bin
    # passes when |kernel - plain| <= 1e-4 + 1e-5 * (the bin's absolute
    # mass, sum |x|): a float32 sum of ~1e4 signed gradients is only
    # accurate relative to that mass, and near-cancelling bins make a
    # plain rtol on the signed sum fail for any summation order.
    npl, hp = binned_level_plain(codes, nid,
                                 ghw if int_ghw else ghw.double(), tables,
                                 n_prev, N, base, W, bf16)
    torch.cuda.synchronize()
    if not torch.equal(nk, npl):
        raise AssertionError(f"binned_level W={W} N={N}: nid differs in "
                             f"{int((nk != npl).sum())} rows")
    err = float((hk.double() - hp.double()).abs().max())
    if int_ghw:
        if not torch.equal(hk, hp):
            raise AssertionError(f"binned_level W={W} N={N} integer ghw: "
                                 f"histogram not bit-equal (max {err})")
    else:
        _n, mass = binned_level_plain(codes, nid, ghw.double().abs(),
                                      tables, n_prev, N, base, W, bf16)
        mass_check(f"binned_level W={W} N={N}", hk, hp, mass)
    return err, (codes, nid, ghw, tables, n_prev, base)


def check_route(rows, F, W, N, dev, seed):
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import binned_route_only_plain
    codes, nid, _ghw, tables, n_prev, base = level_inputs(
        rows, F, W, N, True, seed, dev)
    rk = kernels.binned_route_only(codes, nid, tables, n_prev, base, W)
    rp = binned_route_only_plain(codes, nid, tables, n_prev, base, W)
    torch.cuda.synchronize()
    if not torch.equal(rk, rp):
        raise AssertionError(f"binned_route_only N={N}: nid differs")
    return 0.0, (codes, nid, tables, n_prev, base)


def phase_kernels(dev, rows=1_000_000, F=28):
    """Phase 3: every instance against its plain version at 1M rows."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import (binned_level_plain,
                                                  binned_route_only_plain)
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    seed = 0
    for W in (16, 32, 256):
        for N in (1, 8, 32):
            seed += 1
            check_level(rows, F, W, N, True, False, dev, seed)
            err, inp = check_level(rows, F, W, N, False, False, dev,
                                   seed + 100)
            err16, _ = check_level(rows, F, W, N, False, True, dev,
                                   seed + 200)
            codes, nid, ghw, tables, n_prev, base = inp
            ms = time_cuda(lambda: kernels.binned_level(
                codes, nid, ghw, tables, n_prev, N, base, W, False), 20,
                flush)
            pms = time_cuda(lambda: binned_level_plain(
                codes, nid, ghw, tables, n_prev, N, base, W, False), 3,
                flush)
            bound, by = level_bound_ms(rows, F, codes.element_size(), N, W,
                                       rows)
            print(f"binned_level {rows}x{F} W={W} N={N}: {ms:.6g} ms "
                  f"(plain {pms:.6g} ms, bound {bound:.6g} ms by {by}) "
                  f"max abs err f32 {err:.3g} bf16 {err16:.3g}", flush=True)
            del inp
    _err, (codes, nid, tables, n_prev, base) = check_route(
        rows, F, 16, 64, dev, 7)
    ms = time_cuda(lambda: kernels.binned_route_only(
        codes, nid, tables, n_prev, base, 16), 20, flush)
    pms = time_cuda(lambda: binned_route_only_plain(
        codes, nid, tables, n_prev, base, 16), 3, flush)
    bound, by = route_bound_ms(rows, 1)
    print(f"binned_route_only {rows}x{F} N=64: {ms:.6g} ms (plain "
          f"{pms:.6g} ms, bound {bound:.6g} ms by {by})", flush=True)


def adaptive_inputs(rows, F, W, N, int_ghw, seed, dev, layout,
                    specials=False):
    """Raw HIGGS-like features (5% NaN) in ``layout``, nid in the
    previous level's window, (g, h, w), float32 split tables and per-node
    ranges that cover the bulk of the values. ``specials`` adds ±inf on a
    live range (feature 0) and on a zero-span feature (feature 1)."""
    import torch
    from h2o3_tpu_torch.ops.hist_adaptive import make_adaptive_tables
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (rows, F) if layout == "rows_f" else (F, rows)
    x = torch.randn(shape, generator=g, device=dev)
    x = torch.where(torch.rand(shape, generator=g, device=dev) < 0.05,
                    torch.nan, x)
    n_prev, base = N // 2, N - 1
    lo = -4.0 + 0.5 * torch.rand((N, F), generator=g, device=dev)
    inv = (W - 2) / (7.0 + torch.rand((N, F), generator=g, device=dev))
    if specials:
        xr = x if layout == "rows_f" else x.t()
        xr[:, 1] = 0.5
        xr[0::5, 1] = torch.inf
        xr[2::5, 1] = -torch.inf
        xr[1::7, 0] = torch.inf
        xr[3::7, 0] = -torch.inf
        lo[:, 1] = 0.5
        inv[:, 1] = 0.0
    if n_prev:
        nid = (base - n_prev + torch.randint(0, n_prev, (rows,), generator=g,
                                             device=dev)).to(torch.int32)
    else:
        nid = torch.zeros(rows, dtype=torch.int32, device=dev)
    if int_ghw:
        gg = torch.randint(-8, 9, (rows,), generator=g, device=dev).float()
        hh = torch.randint(0, 4, (rows,), generator=g, device=dev).float()
    else:
        gg = torch.randn(rows, generator=g, device=dev)
        hh = torch.rand(rows, generator=g, device=dev) * 0.25
    ghw = torch.stack([gg, hh, torch.ones(rows, device=dev)]).contiguous()
    m = max(n_prev, 1)
    tables = make_adaptive_tables(
        torch.randint(0, F, (m,), generator=g, device=dev),
        torch.randn(m, generator=g, device=dev),
        torch.rand(m, generator=g, device=dev) < 0.5,
        torch.rand(m, generator=g, device=dev) < 0.9).contiguous()
    return (x.contiguous(), nid, ghw, tables, lo.contiguous(),
            inv.contiguous(), n_prev, base)


def check_adaptive_level(rows, F, W, N, int_ghw, bf16, dev, seed, layout,
                         specials=False):
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import adaptive_level_plain
    inp = adaptive_inputs(rows, F, W, N, int_ghw, seed, dev, layout,
                          specials)
    x, nid, ghw, tables, lo, inv, n_prev, base = inp
    nk, hk = kernels.adaptive_level(x, nid, ghw, tables, lo, inv, n_prev, N,
                                    base, W, bf16, layout)
    npl, hp = adaptive_level_plain(x, nid, ghw if int_ghw else ghw.double(),
                                   tables, lo, inv, n_prev, N, base, W, bf16,
                                   layout)
    torch.cuda.synchronize()
    name = f"adaptive_level {layout} W={W} N={N}"
    if not torch.equal(nk, npl):
        raise AssertionError(f"{name}: nid differs in "
                             f"{int((nk != npl).sum())} rows")
    err = float((hk.double() - hp.double()).abs().max())
    if int_ghw:
        if not torch.equal(hk, hp):
            raise AssertionError(f"{name} integer ghw: histogram not "
                                 f"bit-equal (max {err})")
    else:
        _n, mass = adaptive_level_plain(x, nid, ghw.double().abs(), tables,
                                        lo, inv, n_prev, N, base, W, bf16,
                                        layout)
        mass_check(name, hk, hp, mass)
    return err, inp


def check_adaptive_route(rows, F, N, dev, seed, layout):
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import adaptive_route_only_plain
    x, nid, _g, tables, _lo, _inv, n_prev, base = adaptive_inputs(
        rows, F, 16, N, True, seed, dev, layout)
    rk = kernels.adaptive_route_only(x, nid, tables, n_prev, base, layout)
    rp = adaptive_route_only_plain(x, nid, tables, n_prev, base, layout)
    torch.cuda.synchronize()
    if not torch.equal(rk, rp):
        raise AssertionError(f"adaptive_route_only {layout} N={N}: nid "
                             f"differs")
    return (x, nid, tables, n_prev, base)


def phase_adaptive_kernels(dev, rows=1_000_000, F=28):
    """Phase 3, adaptive half: every instance and layout against its
    plain version at 1M rows, timed with the L2 flushed."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    seed = 500
    for layout in LAYOUTS:
        for W in (16, 32, 256):
            for N in (1, 8, 32):
                seed += 1
                check_adaptive_level(rows, F, W, N, True, False, dev, seed,
                                     layout)
                err16, _ = check_adaptive_level(rows, F, W, N, False, True,
                                                dev, seed + 100, layout)
                err, inp = check_adaptive_level(rows, F, W, N, False, False,
                                                dev, seed + 200, layout)
                x, nid, ghw, tables, lo, inv, n_prev, base = inp
                ms = time_cuda(lambda: kernels.adaptive_level(
                    x, nid, ghw, tables, lo, inv, n_prev, N, base, W, False,
                    layout), 20, flush)
                bound, by = adaptive_level_bound_ms(rows, F, N, W, rows)
                print(f"adaptive_level {layout} {rows}x{F} W={W} N={N}: "
                      f"{ms:.6g} ms (bound {bound:.6g} ms by {by}) max abs "
                      f"err f32 {err:.3g} bf16 {err16:.3g}", flush=True)
                del inp, x, nid, ghw
        check_adaptive_level(rows, 6, 16, 4, True, False, dev, 77, layout,
                             specials=True)
        r = check_adaptive_route(rows, F, 64, dev, 7, layout)
        ms = time_cuda(lambda: kernels.adaptive_route_only(*r, layout), 20,
                       flush)
        print(f"adaptive_route_only {layout} {rows}x{F} N=64: {ms:.6g} ms "
              f"(bound {route_bound_ms(rows, 4)[0]:.6g} ms); NaN/±inf/"
              f"zero-span case bit-equal", flush=True)


def global_inputs(rows, F, B1, N, int_ghw, seed, dev, left_only=False):
    """Codes (uint8 below 256 bins, else int32) uniform over the real
    bins with 5% NA (the last bin), node ids and (g, h, w). About 10% of
    the rows lie outside [0, N); with ``left_only``, as at a sibling-
    subtraction level, half of them (the right children's rows)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(0, B1 - 1, (rows, F), generator=g, device=dev)
    na = torch.rand((rows, F), generator=g, device=dev) < 0.05
    dtype = torch.uint8 if B1 <= 256 else torch.int32
    codes = torch.where(na, B1 - 1, codes).to(dtype)
    if left_only:
        local = torch.randint(0, 2 * N, (rows,), generator=g, device=dev)
        seg = torch.where(local % 2 == 0, local // 2, -1)
    else:
        seg = torch.randint(0, N, (rows,), generator=g, device=dev)
        seg = torch.where(torch.rand(rows, generator=g, device=dev) < 0.1,
                          -1, seg)
    if int_ghw:
        gg = torch.randint(-8, 9, (rows,), generator=g, device=dev).float()
        hh = torch.randint(0, 4, (rows,), generator=g, device=dev).float()
    else:
        gg = torch.randn(rows, generator=g, device=dev)
        hh = torch.rand(rows, generator=g, device=dev) * 0.25
    ghw = torch.stack([gg, hh, torch.ones(rows, device=dev)]).contiguous()
    return codes, seg.to(torch.int32), ghw


def global_form(form):
    """The launch of one form of global_hist: "picked" (the training
    path's wrapper: the kernel picks from the shapes), "shared" (shared
    partials forced) or "global" (global atomics forced)."""
    from h2o3_tpu_torch.ops import kernels
    if form == "picked":
        return kernels.global_hist
    shared = {"shared": True, "global": False}[form]
    return lambda *a: kernels.global_hist_form(*a, shared)


def check_global(rows, F, B1, N, int_ghw, bf16, dev, seed, left_only=False,
                 form="picked"):
    """global_hist against its plain version, in one form (global_form)."""
    import torch
    from h2o3_tpu_torch.ops.histogram import build_histograms_plain
    codes, seg, ghw = global_inputs(rows, F, B1, N, int_ghw, seed, dev,
                                    left_only)
    hk = global_form(form)(codes, seg, ghw, N, B1, bf16)
    hp = build_histograms_plain(codes, seg, ghw if int_ghw else ghw.double(),
                                N, B1, bf16)
    torch.cuda.synchronize()
    name = f"global_hist B1={B1} N={N} form={form}"
    err = float((hk.double() - hp.double()).abs().max())
    if int_ghw:
        if not torch.equal(hk, hp):
            raise AssertionError(f"{name} integer ghw: histogram not "
                                 f"bit-equal (max {err})")
    else:
        mass = build_histograms_plain(codes, seg, ghw.double().abs(), N, B1,
                                      bf16)
        mass_check(name, hk, hp, mass)
    return err, (codes, seg, ghw)


def phase_global_kernels(dev, rows=1_000_000, F=28):
    """Phase 3, global half: global_hist against its plain version at 1M
    rows, B1 in {15, 257, 1025}, integer masses in both forms of the
    kernel, timed with the L2 flushed in the picked form and in each
    form forced (where the kernel's tile-count rule holds at 1M rows)."""
    import torch
    from h2o3_tpu_torch.ops.histogram import build_histograms_plain
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    seed = 700
    for B1 in (15, 257, 1025):
        for N in (1, 8, 16):
            seed += 1
            for form in ("shared", "global"):
                check_global(rows, F, B1, N, True, False, dev, seed,
                             form=form)
            err16, _ = check_global(rows, F, B1, N, False, True, dev,
                                    seed + 100)
            err, (codes, seg, ghw) = check_global(rows, F, B1, N, False,
                                                  False, dev, seed + 200)
            ms, ms_s, ms_g = (time_cuda(lambda: global_form(form)(
                codes, seg, ghw, N, B1, False), 20, flush)
                for form in ("picked", "shared", "global"))
            pms = time_cuda(lambda: build_histograms_plain(
                codes, seg, ghw, N, B1, False), 3, flush)
            live = int(((seg >= 0) & (seg < N)).sum())
            bound, by = global_bound_ms(rows, F, codes.element_size(), N, B1,
                                        live)
            print(f"global_hist {rows}x{F} {str(codes.dtype)[6:]} B1={B1} "
                  f"N={N}: {ms:.6g} ms (forced shared {ms_s:.6g}, "
                  f"forced global {ms_g:.6g}; plain {pms:.6g} ms, bound "
                  f"{bound:.6g} ms by {by}) max abs err f32 {err:.3g} bf16 "
                  f"{err16:.3g}", flush=True)
            del codes, seg, ghw


def off_window(nid, seed):
    """5% of the rows moved outside every level's window."""
    import torch
    g = torch.Generator(device=nid.device).manual_seed(seed)
    out = torch.rand(nid.shape[0], generator=g, device=nid.device) < 0.05
    return torch.where(out, 1 << 20, nid).to(torch.int32).contiguous()


def i8_level(kind, inp, qs, N, W, layout="rows_f"):
    """One int8 level launch (kind "binned" or "adaptive") on the inputs
    of level_inputs / adaptive_inputs and ``qs`` = (q, scales)."""
    from h2o3_tpu_torch.ops import kernels
    if kind == "binned":
        codes, nid, _g, tables, n_prev, base = inp
        return kernels.binned_level_i8(codes, nid, *qs, tables, n_prev, N,
                                       base, W)
    x, nid, _g, tables, lo, inv, n_prev, base = inp
    return kernels.adaptive_level_i8(x, nid, *qs, tables, lo, inv, n_prev, N,
                                     base, W, layout)


def i8_plain(kind, inp, qs, N, W, layout="rows_f"):
    """The plain version of ``i8_level``."""
    from h2o3_tpu_torch.ops import hist_adaptive as H
    if kind == "binned":
        codes, nid, _g, tables, n_prev, base = inp
        return H.binned_level_i8_plain(codes, nid, *qs, tables, n_prev, N,
                                       base, W)
    x, nid, _g, tables, lo, inv, n_prev, base = inp
    return H.adaptive_level_i8_plain(x, nid, *qs, tables, lo, inv, n_prev,
                                     N, base, W, layout)


def i8_inputs(kind, rows, F, W, N, seed, dev, layout="rows_f"):
    """Float (g, h, w) level inputs with 5% of the rows off the window:
    packed codes with 5% NA, or raw features with 5% NaN."""
    if kind == "binned":
        inp = level_inputs(rows, F, W, N, False, seed, dev)
    else:
        inp = adaptive_inputs(rows, F, W, N, False, seed, dev, layout)
    return (inp[0], off_window(inp[1], seed)) + tuple(inp[2:])


def check_i8(kind, rows, F, W, N, terms, dev, seed, layout="rows_f"):
    """An int8 level against its plain version: nid and histogram
    bit-equal (integer sums, the same float32 flush)."""
    import torch
    from h2o3_tpu_torch.ops.hist_adaptive import quantize_ghw_i8
    inp = i8_inputs(kind, rows, F, W, N, seed, dev, layout)
    qs = quantize_ghw_i8(inp[2], terms)
    nk, hk = i8_level(kind, inp, qs, N, W, layout)
    npl, hp = i8_plain(kind, inp, qs, N, W, layout)
    torch.cuda.synchronize()
    name = f"{kind}_level_i8 {layout} W={W} N={N} terms={terms}"
    if not torch.equal(nk, npl):
        raise AssertionError(f"{name}: nid differs in "
                             f"{int((nk != npl).sum())} rows")
    if not torch.equal(hk, hp):
        err = float((hk.double() - hp.double()).abs().max())
        raise AssertionError(f"{name}: histogram not bit-equal (max {err})")
    return inp, qs


I8_LEVELS = ((1, (1, 8, 32)), (2, (1, 8, 16)))   # (terms, N) checked


def phase_i8_kernels(dev, rows=1_000_000, F=28):
    """Phase 3, int8 levels: binned_level_i8 and adaptive_level_i8 (both
    layouts) at W in {16, 32, 256}, one term at N in {1, 8, 32}, two at
    N in {1, 8, 16}, with NA codes / NaN features and 5% of the rows off
    the window: bit-equal to the plain version."""
    seed, n = 1100, 0
    for W in (16, 32, 256):
        for terms, levels in I8_LEVELS:
            for N in levels:
                seed += 1
                check_i8("binned", rows, F, W, N, terms, dev, seed)
                for layout in LAYOUTS:
                    check_i8("adaptive", rows, F, W, N, terms, dev,
                             seed + 500, layout)
                n += 3
    print(f"int8 levels at {rows}x{F}: {n} cases (binned_level_i8, "
          f"adaptive_level_i8 rows_f and f_rows; W 16/32/256; terms 1 at N "
          f"1/8/32, terms 2 at N 1/8/16) bit-equal to the plain version",
          flush=True)


def totals_inputs(rows, F, n_prev, N, seed, dev):
    """Raw features (5% NaN), float (g, h, w), split tables of the
    previous level and nid in its window (in this level's when there is
    no route), 5% of the rows off every window."""
    import torch
    x, _n, ghw, tables, _lo, _inv, _p, _b = adaptive_inputs(
        rows, F, 16, 2 * max(n_prev, 1), False, seed, dev, "rows_f")
    g = torch.Generator(device=dev).manual_seed(seed)
    base = N - 1
    if n_prev:
        nid = base - n_prev + torch.randint(0, n_prev, (rows,), generator=g,
                                            device=dev)
    else:
        nid = base + torch.randint(0, N, (rows,), generator=g, device=dev)
    return x, off_window(nid, seed), ghw, tables, base


def check_totals(rows, F, n_prev, N, dev, seed):
    """leaf_totals against its plain version: nid bit-equal, each total
    within 1e-4 + 1e-5 x its absolute mass of the float64 plain
    version."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import leaf_totals_plain
    x, nid, ghw, tables, base = totals_inputs(rows, F, n_prev, N, seed, dev)
    nk, tk = kernels.leaf_totals(x, nid, ghw, tables, n_prev, N, base)
    npl, tp = leaf_totals_plain(x, nid, ghw.double(), tables, n_prev, N,
                                base)
    torch.cuda.synchronize()
    name = f"leaf_totals n_prev={n_prev} N={N}"
    if not torch.equal(nk, npl):
        raise AssertionError(f"{name}: nid differs in "
                             f"{int((nk != npl).sum())} rows")
    _n, mass = leaf_totals_plain(x, nid, ghw.double().abs(), tables, n_prev,
                                 N, base)
    mass_check(name, tk, tp, mass)
    return float((tk.double() - tp).abs().max()), (x, nid, ghw, tables, base)


def phase_totals_kernel(dev, rows=1_000_000, F=28):
    """Phase 3, leaf_totals at n_prev in {0, 32}, N in {1, 64}."""
    errs = {}
    for n_prev in (0, 32):
        for N in (1, 64):
            errs[f"n_prev={n_prev} N={N}"] = check_totals(
                rows, F, n_prev, N, dev, 1200 + n_prev + N)[0]
    print(f"leaf_totals at {rows}x{F}: nid bit-equal, totals within "
          f"1e-4 + 1e-5 x mass of float64; max abs err {json.dumps(errs)}",
          flush=True)


# ------------------------------------------------------- main path


def higgs_arrays(rows, seed=42):
    """The bench generator (bench.py _make_arrays): 28 HIGGS-shaped
    normal features and a logistic label."""
    rng = np.random.default_rng(seed)
    F = 28
    X = rng.normal(size=(rows, F)).astype(np.float32)
    logit = (X[:, 0] * 1.5 - X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
             + 0.3 * np.sin(3 * X[:, 4]))
    y = (rng.random(rows) < 1.0 / (1.0 + np.exp(-logit))).astype(np.int32)
    return X, y, F


def frame_of(X, y, device):
    import h2o3_tpu_torch as h2o
    cols = {f"f{i}": X[:, i] for i in range(X.shape[1])}
    cols["label"] = y.astype(np.float32)
    return h2o.Frame.from_numpy(cols, device=device)


@contextlib.contextmanager
def hist_i8(terms):
    """``H2O3_HIST_I8`` set to ``terms`` (None: unset) for the trains
    inside, and restored after."""
    old = os.environ.pop("H2O3_HIST_I8", None)
    if terms:
        os.environ["H2O3_HIST_I8"] = str(terms)
    try:
        yield
    finally:
        os.environ.pop("H2O3_HIST_I8", None)
        if old is not None:
            os.environ["H2O3_HIST_I8"] = old


def train(fr, ntrees, path="packed", i8=None, **kw):
    """A GBM of ``path``'s parameters (and ``kw``); ``H2O3_HIST_I8`` is
    ``i8`` or the path's own setting, for this train only."""
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    est = H2OGradientBoostingEstimator(
        ntrees=ntrees, max_depth=6, learn_rate=0.1,
        distribution="bernoulli", seed=7, min_rows=1.0,
        **{**PATHS[path]["params"], **kw})
    with hist_i8(i8 if i8 is not None else PATHS[path].get("i8")):
        est.train(y="label", training_frame=fr)
    return est.model


def phase_main_path(card, path, fr=None, rows=10_000_000, ntrees=20,
                    depth=6, ref_auc=None):
    """One GBM path at full width, launch counters set to 0 just before
    and read just after; the frame is made here unless given. With
    ``ref_auc`` (the float path's AUC from this run) the AUC must lie
    within 0.005 of it."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    if fr is None:
        X, y, _F = higgs_arrays(rows)
        t0 = time.perf_counter()
        fr = frame_of(X, y, "cuda")
        torch.cuda.synchronize()
        log(f"frame {rows}x{fr.ncol} on cuda in "
            f"{time.perf_counter() - t0:.2f} s")
    F = fr.ncol - 1
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    model = train(fr, ntrees, path)
    auc = model.training_metrics.auc
    pred = model.predict(fr)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    expected = {k: 0 for k in launches}
    expected[PATHS[path]["level"]] = depth * ntrees
    if PATHS[path]["route"]:
        expected[PATHS[path]["route"]] = ntrees
    if launches != expected:
        raise AssertionError(f"{path} path launched {launches}, expected "
                             f"{expected}")
    if not np.isfinite(auc) or not 0.5 < auc <= 1.0:
        raise AssertionError(f"training AUC {auc} is not a finite "
                             f"better-than-chance value")
    if ref_auc is not None and abs(auc - ref_auc) > 0.005:
        raise AssertionError(f"{path}: AUC {auc} is more than 0.005 from "
                             f"the float path's {ref_auc}")
    p1 = pred.vec("p1").to_numpy()
    if p1.shape != (rows,) or not np.all(np.isfinite(p1)) \
            or p1.min() < 0 or p1.max() > 1:
        raise AssertionError("predict: p1 is not a finite probability per "
                             "row")
    loop_s = model.output["training_loop_seconds"]
    rps = rows * model.ntrees_built / loop_s
    i8 = f" H2O3_HIST_I8={PATHS[path]['i8']}" if "i8" in PATHS[path] else ""
    print(f"main path {path}: {rows}x{F} bernoulli GBM depth {depth} "
          f"{json.dumps(PATHS[path]['params'])}{i8} {ntrees} trees: AUC "
          f"{auc!r} "
          f"training_loop_seconds {loop_s!r} rows/s {rps!r} packed_codes "
          f"{json.dumps(model.output['packed_codes'])} train_profile "
          f"{json.dumps(model.output['train_profile'])} launches "
          f"{launches} peak device memory in the train "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]",
          flush=True)
    return {"auc": auc, "loop_s": loop_s, "rows_per_s": rps,
            "launches": launches, "frame": fr, "trees": model.trees}


def phase_card_vs_cpu(path, rows=200_000, ntrees=5, **kw):
    X, y, _F = higgs_arrays(rows, seed=11)
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = train(frame_of(X, y, dev), ntrees, path,
                            histogram_precision="float32", **kw)
    mc, mh = models["cuda"], models["cpu"]
    for key in ("feat", PATHS[path]["split_key"]):
        a = mc.trees[key][0]
        b = mh.trees[key][0]
        if not np.array_equal(a, b):
            raise AssertionError(f"{path}: tree 0 {key} differs between "
                                 f"cuda and cpu: {a} vs {b}")
    d_auc = abs(mc.training_metrics.auc - mh.training_metrics.auc)
    if d_auc > 1e-4:
        raise AssertionError(f"{path}: |dAUC| cuda vs cpu = {d_auc}")
    print(f"card vs cpu, {path} {json.dumps(kw)}: {rows} rows, {ntrees} "
          f"trees, float32 histograms: tree 0 splits equal, AUC cuda "
          f"{mc.training_metrics.auc!r} cpu {mh.training_metrics.auc!r} "
          f"|dAUC| {d_auc!r}", flush=True)


def phase_card_vs_cpu_i8(path, terms, rows=200_000, ntrees=5):
    """An int8 path on the card and on the CPU, bf16 histograms. At one
    term every split level is an exact integer sum on both devices: tree
    0's splits must be equal. At two terms the N = 32 level takes the
    float bf16 level, whose float sums differ in the last bits, so a
    near-tie there may flip a split: the differing splits are printed.
    |dAUC| <= 1e-4 at both."""
    X, y, _F = higgs_arrays(rows, seed=11)
    models = {dev: train(frame_of(X, y, dev), ntrees, path, i8=terms,
                         histogram_precision="bfloat16")
              for dev in ("cuda", "cpu")}
    mc, mh = models["cuda"], models["cpu"]
    keys = ("feat", PATHS[path]["split_key"], "na_left")
    same = [all(np.array_equal(mc.trees[k][t], mh.trees[k][t]) for k in keys)
            for t in range(ntrees)]
    if terms == 1 and not same[0]:
        raise AssertionError(f"{path} H2O3_HIST_I8=1: tree 0 differs "
                             f"between cuda and cpu")
    d_auc = abs(mc.training_metrics.auc - mh.training_metrics.auc)
    if d_auc > 1e-4:
        raise AssertionError(f"{path} H2O3_HIST_I8={terms}: |dAUC| cuda vs "
                             f"cpu = {d_auc}")
    print(f"card vs cpu, {path} H2O3_HIST_I8={terms}: {rows} rows, {ntrees} "
          f"trees, bf16 histograms: {sum(same)} of {ntrees} trees identical "
          f"({split_flips(mc.trees, mh.trees)}), AUC cuda "
          f"{mc.training_metrics.auc!r} cpu {mh.training_metrics.auc!r} "
          f"|dAUC| {d_auc!r}", flush=True)


def i8_level_bound_ms(kind, rows, F, N, W, terms, rows_in_level,
                      itemsize=1):
    """Least time for one int8 level: each input read once (codes or
    float32 x, nid, q at one byte a term), each output written once
    (nid', the float32 histogram), or its integer adds (3·terms per row in
    the level and feature, and the adaptive re-bin's subtract and
    multiply) at the float32 rate, whichever takes longer."""
    width = F * (itemsize if kind == "binned" else 4)
    nbytes = rows * (width + 4 + 3 * terms + 4) + 3 * N * F * W * 4
    ops = (3 * terms + (0 if kind == "binned" else 2)) * rows_in_level * F
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def phase_i8_record(dev, launches, rows=10_000_000, F=28):
    """The int8 levels at the main paths' shapes (10M x 28; packed int8
    codes at W=16, adaptive float32 features at W=32 in the training
    layout), per level N = 1..32: one term at every level, two up to
    N = 16, and the float kernel of the same level (bfloat16 masses, as
    the path takes it without the switch) on the same inputs in the same
    run; at N = 32 (one term) the plain version, the bound and, for the
    adaptive kernel, the other layout."""
    from h2o3_tpu_torch.models.gbm import ADAPTIVE_LAYOUT
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import quantize_ghw_i8
    rec = []
    for kind, W in (("binned", 16), ("adaptive", 32)):
        name = f"{kind}_level_i8"
        per = {"float_bf16": {}, "i8_terms1": {}, "i8_terms2": {}}
        for N in (1, 2, 4, 8, 16, 32):
            inp, qs1 = check_i8(kind, rows, F, W, N, 1, dev, 1400 + N,
                                ADAPTIVE_LAYOUT)
            if kind == "binned":
                codes, nid, ghw, tables, n_prev, base = inp
                per["float_bf16"][N] = time_cuda(lambda: kernels.binned_level(
                    codes, nid, ghw, tables, n_prev, N, base, W, True), 10)
            else:
                x, nid, ghw, tables, lo, inv, n_prev, base = inp
                per["float_bf16"][N] = time_cuda(
                    lambda: kernels.adaptive_level(
                        x, nid, ghw, tables, lo, inv, n_prev, N, base, W,
                        True, ADAPTIVE_LAYOUT), 10)
            per["i8_terms1"][N] = time_cuda(lambda: i8_level(
                kind, inp, qs1, N, W, ADAPTIVE_LAYOUT), 10)
            if N <= 16:
                qs2 = quantize_ghw_i8(inp[2], 2)
                hist2 = i8_level(kind, inp, qs2, N, W, ADAPTIVE_LAYOUT)[1]
                if not hist2.equal(i8_plain(kind, inp, qs2, N, W,
                                            ADAPTIVE_LAYOUT)[1]):
                    raise AssertionError(f"{name} N={N} terms=2 at 10M: "
                                         f"histogram not bit-equal")
                per["i8_terms2"][N] = time_cuda(lambda: i8_level(
                    kind, inp, qs2, N, W, ADAPTIVE_LAYOUT), 10)
                del qs2, hist2
            if N == 32:
                pms = time_cuda(lambda: i8_plain(kind, inp, qs1, N, W,
                                                 ADAPTIVE_LAYOUT), 3)
                other = None
                if kind == "adaptive":
                    # the other layout, same values
                    xo = inp[0].t().contiguous()
                    lay = "f_rows" if ADAPTIVE_LAYOUT == "rows_f" else \
                        "rows_f"
                    inp_o = (xo,) + tuple(inp[1:])
                    other = {lay: time_cuda(lambda: i8_level(
                        kind, inp_o, qs1, N, W, lay), 10)}
                    del xo, inp_o
            del inp, qs1
        sums = {k: sum(v.values()) for k, v in per.items()}
        bound, by = i8_level_bound_ms(kind, rows, F, 32, W, 1, rows)
        form = ADAPTIVE_LAYOUT if kind == "adaptive" else "int8 codes"
        print(f"{name} at 10M x 28, W={W} ({form}), "
              f"per level N: {json.dumps(per)} ms; sum per tree "
              f"{json.dumps(sums)} ms; N=32: plain {pms!r} ms, bound "
              f"{bound!r} ms by {by}"
              + (f", other layout {json.dumps(other)} ms" if other else ""),
              flush=True)
        rec.append({"name": name, "route": "cuda", "source": SRC[name],
                    "replaces": REPLACES[name],
                    "launches": launches[name], "max_abs_err": 0.0,
                    "ms": per["i8_terms1"][32],
                    "float_level_ms": per["float_bf16"][32],
                    "ms_terms2_n16": per["i8_terms2"][16],
                    "plain_ms": pms, "bound_ms": bound, "bound_by": by,
                    "library_ms": None})
    return rec


def phase_totals_record(dev, rows=10_000_000, F=28, n_prev=32, N=64):
    """leaf_totals at 10M x 28 after a depth-6 tree's last split level
    (n_prev = 32, N = 64): time, plain version's time, bound (nid in and
    out, ghw, the one x value a row the route reads). No path launches
    it, in either package."""
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import leaf_totals_plain
    err, (x, nid, ghw, tables, base) = check_totals(rows, F, n_prev, N, dev,
                                                   1500)
    ms = time_cuda(lambda: kernels.leaf_totals(x, nid, ghw, tables, n_prev, N,
                                               base), 20)
    pms = time_cuda(lambda: leaf_totals_plain(x, nid, ghw, tables, n_prev, N,
                                              base), 3)
    nbytes = rows * (4 + 4 + 12 + 4)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, 3 * rows / F32_OPS_PER_S
    bound, by = max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")
    print(f"leaf_totals at 10M x 28, n_prev={n_prev} N={N}: {ms!r} ms, plain "
          f"{pms!r} ms, bound {bound!r} ms by {by}, max abs err {err!r}",
          flush=True)
    return [{"name": "leaf_totals", "route": "cuda",
             "source": SRC["leaf_totals"], "replaces": REPLACES["leaf_totals"],
             "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": pms,
             "bound_ms": bound, "bound_by": by, "library_ms": None}]


def phase_kernel_record(dev, launches, rows=10_000_000, F=28):
    """Each kernel at the main path's deepest shapes (10M x 28 int8,
    W=16, bfloat16-rounded (g, h, w) as histogram_precision='auto' picks
    at this size): median time, plain version's time, bound."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import (binned_level_plain,
                                                  binned_route_only_plain)
    W, N = 16, 32
    err, (codes, nid, ghw, tables, n_prev, base) = check_level(
        rows, F, W, N, False, True, dev, 1234)
    ms = time_cuda(lambda: kernels.binned_level(
        codes, nid, ghw, tables, n_prev, N, base, W, True), 20)
    pms = time_cuda(lambda: binned_level_plain(
        codes, nid, ghw, tables, n_prev, N, base, W, True), 3)
    bound, by = level_bound_ms(rows, F, 1, N, W, rows)
    per_level = {}
    for n_lvl in (1, 2, 4, 8, 16):
        _e, (c2, n2, g2, t2, p2, b2) = check_level(
            rows, F, W, n_lvl, False, True, dev, 99 + n_lvl)
        per_level[n_lvl] = time_cuda(lambda: kernels.binned_level(
            c2, n2, g2, t2, p2, n_lvl, b2, W, True), 10)
        del c2, n2, g2, t2
    per_level[N] = ms
    print(f"binned_level at 10M x 28, W=16, per level N: "
          f"{json.dumps(per_level)} ms; sum per tree "
          f"{sum(per_level.values())!r} ms", flush=True)
    rec = [{"name": "binned_level", "route": "cuda",
            "source": SRC["binned_level"],
            "replaces": REPLACES["binned_level"],
            "launches": launches["binned_level"], "max_abs_err": err,
            "ms": ms, "plain_ms": pms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}]
    del codes, nid, ghw, tables
    _e, (codes, nid, tables, n_prev, base) = check_route(
        rows, F, W, 2 * N, dev, 4321)
    ms = time_cuda(lambda: kernels.binned_route_only(
        codes, nid, tables, n_prev, base, W), 20)
    pms = time_cuda(lambda: binned_route_only_plain(
        codes, nid, tables, n_prev, base, W), 3)
    bound, by = route_bound_ms(rows, 1)
    rec.append({"name": "binned_route_only", "route": "cuda",
                "source": SRC["binned_route_only"],
                "replaces": REPLACES["binned_route_only"],
                "launches": launches["binned_route_only"],
                "max_abs_err": 0.0, "ms": ms, "plain_ms": pms,
                "bound_ms": bound, "bound_by": by, "library_ms": None})
    return rec


def phase_adaptive_record(dev, launches, rows=10_000_000, F=28):
    """The adaptive kernels at the adaptive main path's shapes (10M x 28
    float32 features, W=32, bfloat16-rounded (g, h, w) as
    histogram_precision='auto' picks at this size), in both layouts:
    per-level times, the plain version's time and the bound at N=32, the
    route at N=64. The record's time is the training path's layout."""
    import torch
    from h2o3_tpu_torch.models.gbm import ADAPTIVE_LAYOUT
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import (adaptive_level_plain,
                                                  adaptive_route_only_plain)
    W, N = 32, 32
    level_ms, route_ms, per_level = {}, {}, {}
    for layout in LAYOUTS:
        per_level[layout] = {}
        for n_lvl in (1, 2, 4, 8, 16, 32):
            e, inp = check_adaptive_level(rows, F, W, n_lvl, False, True, dev,
                                          900 + n_lvl, layout)
            x, nid, ghw, tables, lo, inv, n_prev, base = inp
            per_level[layout][n_lvl] = time_cuda(
                lambda: kernels.adaptive_level(x, nid, ghw, tables, lo, inv,
                                               n_prev, n_lvl, base, W, True,
                                               layout), 10)
            if n_lvl == N and layout == ADAPTIVE_LAYOUT:
                err = e
                pms = time_cuda(lambda: adaptive_level_plain(
                    x, nid, ghw, tables, lo, inv, n_prev, N, base, W, True,
                    layout), 3)
            del inp, x, nid, ghw
        level_ms[layout] = per_level[layout][N]
        print(f"adaptive_level {layout} at 10M x 28, W=32, per level N: "
              f"{json.dumps(per_level[layout])} ms; sum per tree "
              f"{sum(per_level[layout].values())!r} ms", flush=True)
        x, nid, tables, n_prev, base = check_adaptive_route(rows, F, 2 * N,
                                                            dev, 4321, layout)
        route_ms[layout] = time_cuda(lambda: kernels.adaptive_route_only(
            x, nid, tables, n_prev, base, layout), 20)
        if layout == ADAPTIVE_LAYOUT:
            rpms = time_cuda(lambda: adaptive_route_only_plain(
                x, nid, tables, n_prev, base, layout), 3)
        del x, nid
    print(f"adaptive layouts at 10M x 28 (training path: {ADAPTIVE_LAYOUT}):"
          f" level N=32 {json.dumps(level_ms)} ms, route N=64 "
          f"{json.dumps(route_ms)} ms", flush=True)
    bound, by = adaptive_level_bound_ms(rows, F, N, W, rows)
    rbound, rby = route_bound_ms(rows, 4)
    return [{"name": "adaptive_level", "route": "cuda",
             "source": SRC["adaptive_level"],
             "replaces": REPLACES["adaptive_level"],
             "also_replaces": ALSO_REPLACES["adaptive_level"],
             "launches": launches["adaptive_level"], "max_abs_err": err,
             "ms": level_ms[ADAPTIVE_LAYOUT], "ms_by_layout": level_ms,
             "plain_ms": pms, "bound_ms": bound, "bound_by": by,
             "library_ms": None},
            {"name": "adaptive_route_only", "route": "cuda",
             "source": SRC["adaptive_route_only"],
             "replaces": REPLACES["adaptive_route_only"],
             "also_replaces": ALSO_REPLACES["adaptive_route_only"],
             "launches": launches["adaptive_route_only"], "max_abs_err": 0.0,
             "ms": route_ms[ADAPTIVE_LAYOUT], "ms_by_layout": route_ms,
             "plain_ms": rpms, "bound_ms": rbound, "bound_by": rby,
             "library_ms": None}]


def phase_packed_vs_global(rows=200_000, ntrees=5):
    """The two sketch paths on the card at float32 histograms and 14
    bins: the packed grower and the global-sketch grower must pick the
    same splits in every tree."""
    X, y, _F = higgs_arrays(rows, seed=12)
    fr = frame_of(X, y, "cuda")
    kw = dict(nbins=14, histogram_precision="float32")
    packed = train(fr, ntrees, "packed", packed_codes=True, **kw)
    glob = train(fr, ntrees, "global", packed_codes=False, **kw)
    if not (packed.output["packed_codes"]["enabled"]
            and not glob.output["packed_codes"]["enabled"]):
        raise AssertionError("packed vs global: the paths were not taken")
    for key in ("feat", "split_bin", "na_left"):
        a, b = packed.trees[key], glob.trees[key]
        if not np.array_equal(a, b):
            raise AssertionError(f"packed vs global: {key} differs in "
                                 f"{int((a != b).sum())} of {a.size} nodes")
    print(f"packed vs global on the card: {rows} rows, {ntrees} trees, "
          f"nbins 14, float32: feat, split_bin, na_left identical; AUC "
          f"{packed.training_metrics.auc!r} vs "
          f"{glob.training_metrics.auc!r}", flush=True)


def phase_global_record(dev, launches, loop_s, ntrees, rows=10_000_000,
                        F=28, B1=1025):
    """global_hist at the global path's shapes (10M x 28 int32 codes,
    B1 = 1025, bfloat16-rounded (g, h, w) as histogram_precision='auto'
    picks at this size): the six builds of a tree (N = 1 at level 0 over
    every row; then the left children, N = 1, 2, 4, 8, 16, over half the
    rows), their sum and its share of the loop, each build also in both
    forms of the kernel (shared partials forced, global atomics forced:
    the evidence for the kernel's ``kMaxSharedTiles``); at N = 16
    the plain version's time, the bound and one ``index_add_`` over a
    precomputed flat (node, feature, bin) index of the rows in [0, N)."""
    import torch
    from h2o3_tpu_torch.ops.histogram import build_histograms_plain
    builds = [(1, False), (1, True), (2, True), (4, True), (8, True),
              (16, True)]
    forms = ("picked", "shared", "global")
    per_level = {f: [] for f in forms}
    for d, (n, left) in enumerate(builds):
        e, (codes, seg, ghw) = check_global(rows, F, B1, n, False, True, dev,
                                            1300 + d, left_only=left)
        for form in forms:
            per_level[form].append(time_cuda(lambda: global_form(form)(
                codes, seg, ghw, n, B1, True), 10))
        if d < len(builds) - 1:
            del codes, seg, ghw
    N = builds[-1][0]
    ms, err = per_level["picked"][-1], e
    pms = time_cuda(lambda: build_histograms_plain(codes, seg, ghw, N, B1,
                                                   True), 3)
    live = (seg >= 0) & (seg < N)
    bound, by = global_bound_ms(rows, F, codes.element_size(), N, B1,
                                int(live.sum()))
    # the library yardstick: one index_add_ of the bf16-rounded masses of
    # the rows in [0, N) over their flat (node, feature, bin) index; index
    # and values are built before the timing
    flat = ((seg[live].long()[:, None] * F + torch.arange(F, device=dev))
            * B1 + codes[live].long()).reshape(-1)
    vals = (ghw.t()[live].to(torch.bfloat16).float()[:, None, :]
            .expand(-1, F, 3).reshape(-1, 3).contiguous())
    out = torch.zeros((N * F * B1, 3), device=dev)
    lib_ms = time_cuda(lambda: out.index_add_(0, flat, vals), 5)
    del flat, vals, out, codes, seg, ghw, live
    sums = {f: sum(v) for f, v in per_level.items()}
    share = sums["picked"] * ntrees / (loop_s * 1e3)
    print(f"global_hist at 10M x 28, B1={B1}, per build N "
          f"{[n for n, _ in builds]}: {json.dumps(per_level)} ms; sum per "
          f"tree {json.dumps(sums)} ms, the picked form's {share!r} of the "
          f"warm loop ({loop_s!r} s for {ntrees} trees); N={N}: {ms!r} ms, "
          f"plain {pms!r} ms, index_add_ {lib_ms!r} ms, bound {bound!r} ms "
          f"by {by}", flush=True)
    return [{"name": "global_hist", "route": "cuda",
             "source": SRC["global_hist"],
             "replaces": REPLACES["global_hist"],
             "launches": launches["global_hist"], "max_abs_err": err,
             "ms": ms, "plain_ms": pms, "bound_ms": bound, "bound_by": by,
             "library_ms": lib_ms}]


def split_flips(a, b) -> str:
    """How two models' trees differ: split features that differ, and the
    first tree where any does (over the trees both have)."""
    n = min(len(a["feat"]), len(b["feat"]))
    diff = a["feat"][:n] != b["feat"][:n]
    first = int(np.argmax(diff.any(axis=1))) if diff.any() else None
    return f"{int(diff.sum())} of {diff.size} split features differ " \
           f"(first in tree {first})"


def phase_repeatability(fr, path):
    """The same train twice at float32 histograms. Float atomics add in
    another order each run; this reports how far that moves the
    trees."""
    runs = [train(fr, 20, path, histogram_precision="float32")
            for _ in range(2)]
    print(f"repeatability {path}, float32 x2: "
          f"{split_flips(runs[0].trees, runs[1].trees)}, AUC "
          f"{runs[0].training_metrics.auc!r} vs "
          f"{runs[1].training_metrics.auc!r}", flush=True)


def phase_repeatability_i8(fr):
    """The adaptive path with H2O3_HIST_I8=1 trained twice at 'auto'
    (bf16, every level an integer sum): how far the runs differ."""
    runs = [train(fr, 20, "adaptive_i8") for _ in range(2)]
    print(f"repeatability adaptive_i8, H2O3_HIST_I8=1 at 'auto' x2: "
          f"{split_flips(runs[0].trees, runs[1].trees)}, AUC "
          f"{runs[0].training_metrics.auc!r} vs "
          f"{runs[1].training_metrics.auc!r}", flush=True)


def phase_warm_profile(fr, card, path, cold_trees, ntrees=5, reps=3):
    """Where the time goes: a main path's train again (warm: kernels
    loaded, allocator grown), ``reps`` times plain at 20 trees (the
    loop is host-bound and its time spreads from train to train) and
    once with 5 trees under torch.profiler. Prints the loop times and
    their median, the device time by kernel and the device busy share of
    the whole train() call, and how the first warm retrain's trees
    differ from the cold run's. Returns the median warm 20-tree loop's
    seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    loops = []
    for i in range(reps):
        warm = train(fr, 20, path)
        if i == 0:
            print(f"repeatability {path}, cold vs warm at 'auto': "
                  f"{split_flips(cold_trees, warm.trees)}", flush=True)
        loops.append(warm.output["training_loop_seconds"])
    w_loop = float(np.median(loops))
    print(f"warm retrain {path}: {fr.nrow} rows, 20 trees, x{reps}: "
          f"training_loop_seconds {loops!r}, median {w_loop!r} (rows/s "
          f"{fr.nrow * 20 / w_loop!r}), AUC {warm.training_metrics.auc!r} "
          f"[{card}]", flush=True)
    del warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model = train(fr, ntrees, path)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    loop_s = model.output["training_loop_seconds"]
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            t = getattr(e, "self_device_time_total", None)
            if t is None:
                t = e.self_cuda_time_total
            by_name[e.key] = by_name.get(e.key, 0.0) + t / 1e3
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"warm profile {path}: {fr.nrow} rows, {ntrees} trees: "
          f"training_loop_seconds {loop_s!r} "
          f"(rows/s {fr.nrow * ntrees / loop_s!r}), train() wall "
          f"{wall * 1e3!r} ms, device busy {busy!r} ms "
          f"({busy / (wall * 1e3)!r} of the wall), train_profile "
          f"{json.dumps(model.output['train_profile'])} [{card}]",
          flush=True)
    for k, v in top:
        print(f"  device ms {v:10.3f}  {k[:100]}", flush=True)
    return w_loop


def sass_atomics(lib_path) -> str:
    """The atomic opcodes in each built kernel's SASS (``cuobjdump``),
    e.g. whether a shared-memory float add is native or a CAS loop."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "cuobjdump not found: SASS summary not printed"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    lines = []
    for fn in sass.split("Function : ")[1:]:
        ops = re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)\.[A-Z0-9_.]+)", fn)
        counts = {op: ops.count(op) for op in sorted(set(ops))}
        lines.append(f"  {fn.split(chr(10))[0][:80]}: {counts}")
    return "SASS atomics per kernel:\n" + "\n".join(lines)


class PhaseClock:
    """Wall seconds of each phase of the run (the cost of each phase)."""

    def __init__(self):
        self.t = time.perf_counter()
        self.laps = {}

    def lap(self, name):
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import h2o3_tpu_torch  # noqa: F401 — fails outside a checkout
    from h2o3_tpu_torch.ops import kernels

    # 1. device
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name} [{card}]; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 2. build
    clock = PhaseClock()
    t0 = time.perf_counter()
    kernels.build()
    log(f"build: {time.perf_counter() - t0:.2f} s\n{kernels.build_log()}")
    for so in kernels.library_paths().values():
        print(sass_atomics(so), flush=True)

    clock.lap("2 build + SASS")

    # 3. kernel vs plain
    phase_kernels(dev)
    clock.lap("3 packed kernels")
    phase_adaptive_kernels(dev)
    clock.lap("3 adaptive kernels")
    phase_global_kernels(dev)
    clock.lap("3 global kernels")
    phase_i8_kernels(dev)
    phase_totals_kernel(dev)
    clock.lap("3 int8 + totals kernels")

    # 4. the main paths, each with its own launch counts
    packed = phase_main_path(card, "packed")
    fr = packed.pop("frame")
    clock.lap("4 packed (frame included)")
    adaptive = phase_main_path(card, "adaptive", fr)
    del adaptive["frame"]
    clock.lap("4 adaptive")
    glob = phase_main_path(card, "global", fr)
    del glob["frame"]
    clock.lap("4 global")
    # the int8 paths, against the same path's bf16 AUC of this run
    packed_i8 = phase_main_path(card, "packed_i8", fr, ref_auc=packed["auc"])
    del packed_i8["frame"]
    adaptive_i8 = phase_main_path(card, "adaptive_i8", fr,
                                  ref_auc=adaptive["auc"])
    del adaptive_i8["frame"]
    clock.lap("4 packed_i8 + adaptive_i8")

    # 5. card vs cpu; the two sketch paths against each other
    phase_card_vs_cpu("packed")
    phase_card_vs_cpu("adaptive")
    clock.lap("5 packed + adaptive card vs cpu")
    phase_card_vs_cpu("global", nbins=300)
    clock.lap("5 global card vs cpu")
    phase_packed_vs_global()
    clock.lap("5 packed vs global")
    for path in ("packed_i8", "adaptive_i8"):
        for terms in (1, 2):
            phase_card_vs_cpu_i8(path, terms)
    clock.lap("5 int8 card vs cpu")

    # 6. kernels at the main paths' shapes
    rec = phase_kernel_record(dev, packed["launches"])
    rec += phase_adaptive_record(dev, adaptive["launches"])
    clock.lap("6 packed + adaptive record")
    rec += phase_i8_record(dev, {
        "binned_level_i8": packed_i8["launches"]["binned_level_i8"],
        "adaptive_level_i8": adaptive_i8["launches"]["adaptive_level_i8"]})
    rec += phase_totals_record(dev)
    clock.lap("6 int8 + totals record")

    # 7. where the time goes: a warm, profiled retrain of each main path
    phase_warm_profile(fr, card, "packed", packed["trees"])
    phase_warm_profile(fr, card, "adaptive", adaptive["trees"])
    clock.lap("7 packed + adaptive profile")
    phase_warm_profile(fr, card, "packed_i8", packed_i8["trees"])
    phase_warm_profile(fr, card, "adaptive_i8", adaptive_i8["trees"])
    clock.lap("7 packed_i8 + adaptive_i8 profile")
    warm_s = phase_warm_profile(fr, card, "global", glob["trees"])
    clock.lap("7 global profile")
    phase_repeatability(fr, "adaptive")
    phase_repeatability_i8(fr)
    del fr
    clock.lap("7 repeatability")
    rec += phase_global_record(dev, glob["launches"], warm_s, 20)
    clock.lap("6 global record")
    print(f"phase seconds: {json.dumps(clock.laps)}", flush=True)
    print("kernels run: binned_level[W=16,32,256] binned_route_only "
          "binned_level_i8[W=16,32,256 x terms=1,2] "
          "adaptive_level[rows_f,f_rows x W=16,32,256] "
          "adaptive_route_only[rows_f,f_rows] "
          "adaptive_level_i8[rows_f,f_rows x W=16,32,256 x terms=1,2] "
          "leaf_totals[n_prev=0,32 x N=1,64] "
          "global_hist[B1=15 uint8,257,1025 int32]", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rec}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
