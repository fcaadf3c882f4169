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
binned_level_i8 and adaptive_level_i8), the packed and adaptive paths at
the wide lane widths (``packed_wide``: nbins 254, W = 256 int16 codes;
``adaptive_wide``: nbins 62, W = 64; XGBoost's ``tree_method="hist"``
and ``"auto"`` at max_bins 256; the wide body of binned_level and
adaptive_level), the same two with int8 masses (``packed_wide_i8``,
``adaptive_wide_i8``: the wide body's int8 instance of
binned_level_i8 and adaptive_level_i8), and, on the packed and global
paths, the deepest
level's per-leaf sums (segment_totals, the leaf-totals kernel without a
route). It also holds leaf_totals with a route, which no path launches,
against its plain version. Phases, each fatal on failure:

1. device: the card's name and power limit;
2. build: compile the CUDA kernels from ``h2o3_tpu_torch/csrc`` (one
   nvcc per source, in parallel); print each kernel's atomic, HMMA and
   IMMA opcodes from its SASS and require HMMA and no shared float CAS
   loop (``ATOMS.CAST.SPIN``) in every float tensor-core instance of the
   node-grouped level (adaptive and packed), IMMA and no atomics in every
   int8 instance of it, no atomics at all in every float instance of the
   wide level (level_wide_kernel), the leaf-totals kernel and
   global_hist's node-grouped form, and in every int8 instance of the
   wide level shared integer adds (``ATOMS.ADD``) and no other atomic;
3. kernel vs plain on the card at 1M x 28, N in {1, 8, 32}: binned_level
   at W=16, 32, 64, 128 (int8) and 256 (int16), in the form the shapes
   pick and in every form forced (tensor-core node-grouped up to W=32,
   tiled, and from W=32 on the wide body),
   binned_route_only at N=64; adaptive_level at W in {16, 32, 64, 128,
   256} and adaptive_route_only at N=64, both layouts (in [rows, F] from
   W=32 on every grouped form forced too), plus a case with NaN, ±inf
   and zero-span features; a grouped form forced where it does not fit
   or has no instance (600 features, [F, rows], the wide body at W=16,
   the int8 wide body at W=16 and 32, the tensor-core body of the float
   and int8 levels at W=64, 128, 256) must raise;
   global_hist at B1 in {15 (uint8), 257, 1025
   (int32)}, N in {1, 8, 16, 32}, about 10% of the rows outside [0, N),
   NA codes, in the node-grouped form and with global atomics. With
   integer-valued (g, h, w) node ids and histograms must be bit-equal to
   the plain PyTorch version; with float (g, h, w) node ids bit-equal and
   each histogram bin within 1e-4 + 1e-5 x (its absolute mass) of the
   plain version accumulated in float64, for float32 and for
   bfloat16-rounded masses. binned_level_i8 and adaptive_level_i8 (both
   layouts) at W in {16, 32, 64, 128, 256}, one term at N = 1..32, two
   at N = 1..16, NA codes / NaN features, 5% of the rows off the window,
   in every form (tensor-core node-grouped at W <= 32, wide at W >= 64,
   tiled, each forced, and the one the kernel picks; [F, rows] has no
   grouped form): nid and histogram bit-equal to the plain version, the
   [rows, F] forms timed.
   leaf_totals at n_prev in {0, 32}, N in {1, 64}: nid bit-equal, totals
   within the float tolerance against float64; segment_totals at N in
   {1, 64, 512, 4096}, also five launches with the same bits;
4. the main paths at full width: 10M x 28 HIGGS-shaped rows ->
   Frame.from_numpy(device="cuda") -> bernoulli GBM, depth 6, 20 trees,
   min_rows 1, seed 7 -> training AUC -> predict; packed at nbins 14,
   adaptive at nbins 20 (W=32), then global at nbins 1024 with
   ``quantiles_global`` (B1 = 1025, int32 codes). Each path runs with the
   launch counters set to 0 just before and read just after (6 x 20
   level launches and 20 route launches of its own kernels on the packed
   and adaptive paths, 6 x 20 global_hist on the global path, 20
   segment_totals on the packed and global paths, 0 of any other kernel);
   then packed_i8 and adaptive_i8 on the same frame
   (6 x 20 int8 level launches, 20 route launches, 0 float level
   launches), each AUC within 0.005 of its path's bf16 AUC of this run;
   then packed_wide (nbins 254) and adaptive_wide (nbins 62) on the same
   frame, with the same launch counts as packed and adaptive; then
   packed_wide_i8 and adaptive_wide_i8 (the wide paths with
   ``H2O3_HIST_I8=1``: 6 x 20 int8 level launches, 20 route launches, 0
   float level launches), each AUC within 0.005 of its wide path's;
5. card vs CPU, same code, each path: 200k rows, depth 6, float32
   histograms, 5 trees on each device (nbins 300 on the global path);
   every tree's splits equal, |dAUC| <= 1e-4; and packed vs global on the
   card (200k rows, nbins 14, ``quantiles_global``, float32,
   ``packed_codes`` True vs False): every tree's split features, bins
   and NA directions identical; the two int8 paths on card and CPU at
   200k rows, depth 6, 5 trees, bf16, ``H2O3_HIST_I8`` 1 and 2: |dAUC|
   <= 1e-4, and at one term (every level an integer sum) tree 0's
   splits equal; the number of identical trees is printed; the two wide
   paths as packed and adaptive, the two wide int8 paths as the int8
   ones;
6. timing of each kernel at the main paths' shapes (10M x 28, per level
   N = 1..32; the packed level at W = 16 node-grouped at bf16 and
   float32 beside the tiled body forced, each level checked against its
   plain version at 10M rows and launched five times with the same bits,
   with one ``index_add_`` and the grouping pass alone at N = 32, and at
   W = 32 the tensor-core, wide and tiled forms; the node-grouped
   adaptive level at bf16 and float32, each level checked against its
   plain version at 10M rows, beside its shared-atomics ablation and the
   [F, rows] tiled body; global_hist at the six build sizes N = 1, 1, 2,
   4, 8, 16 of the global path, each checked at 10M rows, node-grouped
   and with global atomics forced; the grouping pass alone) against its
   plain version and its bound (binned_level at W = 16, 32 and 256,
   adaptive_level and global_hist also against one ``index_add_``); the
   int8 levels per level N = 1..32 at one term and N = 1..16 at two, W =
   16, 32, 64, 128 and 256, in each form (tensor-core or wide, tiled,
   picked), each checked bit-equal at 10M rows, beside the float level
   on the same inputs in the same run (at the path's W and at every wide
   W), and at N = 32 one ``index_add_`` of the widened q into int32, the
   plain version and the bound at each of those W; the levels where the
   rule's form took more than 5% above the fastest forced form are
   printed; leaf_totals at n_prev = 32, N = 64; segment_totals at N = 64
   beside one ``index_add_``; binned_level and adaptive_level at the wide
   widths W = 64, 128, 256, per level N = 1..32, both forms (wide,
   tiled) checked against the plain version at 10M rows and timed, the
   wide one launched five times with the same bits, the form the kernel
   picks, and at N = 32 the plain version, the bound and one
   ``index_add_``; the global_hist record comes last, after phase 7,
   whose warm global loop it is set against;
7. where the time goes: each main path's train again, warm (20 trees
   plain, three times, then 5 trees under torch.profiler: device time by
   kernel, device busy share); the packed, adaptive, global, packed_wide
   and adaptive_wide paths each trained three times at float32, the
   first right after the allocator is filled with NaN, then twice at
   'auto', and the four int8 paths twice at 'auto', with every pair of a
   path's trains required to agree bit for bit in split features, split
   keys, NA directions and leaf values (every float sum on these paths
   comes in a fixed order; integer sums in any).

Before its last lines it prints each phase's wall seconds. The last
two lines of stdout are the kernel record and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
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
       "segment_totals": "h2o3_tpu_torch/csrc/hist_adaptive.cu",
       "global_hist": "h2o3_tpu_torch/csrc/hist_global.cu"}
# the TPU kernel each replaces (adaptive_level: K8, the training layout's,
# whose record times the node-grouped form); the adaptive kernels' layout
# parameter also covers the other layout (K5; K9 beside K6)
REPLACES = {"binned_level": "h2o3_tpu/ops/hist_adaptive.py:930",
            "binned_route_only": "h2o3_tpu/ops/hist_adaptive.py:1282",
            "binned_level_i8": "h2o3_tpu/ops/hist_adaptive.py:1154",
            "adaptive_level": "h2o3_tpu/ops/hist_adaptive.py:134",
            "adaptive_route_only": "h2o3_tpu/ops/hist_adaptive.py:755",
            "adaptive_level_i8": "h2o3_tpu/ops/hist_adaptive.py:500",
            "leaf_totals": "h2o3_tpu/ops/hist_adaptive.py:365",
            "segment_totals": "h2o3_tpu/ops/hist_adaptive.py:365",
            "global_hist": "h2o3_tpu/ops/hist_pallas.py:47"}
ALSO_REPLACES = {"binned_level": "h2o3_tpu/ops/hist_adaptive.py:1014",
                 "adaptive_level": "h2o3_tpu/ops/hist_adaptive.py:641",
                 "adaptive_route_only": "h2o3_tpu/ops/hist_adaptive.py:787"}
# the three GBM paths: their parameters and the kernels each launches
# (level: 6 a tree; route and the deepest level's totals: one a tree)
PATHS = {
    "packed": {"params": dict(nbins=14, histogram_type="quantiles_global"),
               "level": "binned_level", "route": "binned_route_only",
               "totals": "segment_totals", "split_key": "split_bin"},
    "adaptive": {"params": dict(nbins=20, packed_codes=False),
                 "level": "adaptive_level", "route": "adaptive_route_only",
                 "split_key": "thr"},
    "global": {"params": dict(nbins=1024, histogram_type="quantiles_global"),
               "level": "global_hist", "route": None,
               "totals": "segment_totals", "split_key": "split_bin"},
    # the packed and adaptive paths with H2O3_HIST_I8 (int8 fixed-point
    # masses, one term: every level of a depth-6 tree at bf16)
    "packed_i8": {"params": dict(nbins=14, histogram_type="quantiles_global"),
                  "level": "binned_level_i8", "route": "binned_route_only",
                  "totals": "segment_totals", "split_key": "split_bin",
                  "i8": 1},
    "adaptive_i8": {"params": dict(nbins=20, packed_codes=False),
                    "level": "adaptive_level_i8",
                    "route": "adaptive_route_only", "split_key": "thr",
                    "i8": 1},
    # the wide lane widths: XGBoost's tree_method="hist" at max_bins=256
    # (packed int16 codes, W = 256, the wide body of binned_level) and
    # tree_method="auto" (uniform-adaptive bins at nbins 62, W = 64, the
    # wide body of adaptive_level)
    "packed_wide": {"params": dict(nbins=254,
                                   histogram_type="quantiles_global"),
                    "level": "binned_level", "route": "binned_route_only",
                    "totals": "segment_totals", "split_key": "split_bin"},
    "adaptive_wide": {"params": dict(nbins=62, packed_codes=False),
                      "level": "adaptive_level",
                      "route": "adaptive_route_only", "split_key": "thr"},
    # the wide paths with H2O3_HIST_I8 (one term: every level takes the
    # int8 kernel, on its wide body)
    "packed_wide_i8": {"params": dict(nbins=254,
                                      histogram_type="quantiles_global"),
                       "level": "binned_level_i8",
                       "route": "binned_route_only",
                       "totals": "segment_totals", "split_key": "split_bin",
                       "i8": 1},
    "adaptive_wide_i8": {"params": dict(nbins=62, packed_codes=False),
                         "level": "adaptive_level_i8",
                         "route": "adaptive_route_only", "split_key": "thr",
                         "i8": 1},
}
# the float levels' wide lane widths
WIDE_W = (64, 128, 256)
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


def torch_flush(dev):
    """A 96 MB buffer whose zeroing evicts the 50 MB L2 between timed
    launches."""
    import torch
    return torch.empty(96 << 20, dtype=torch.uint8, device=dev)


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


def binned_form(form):
    """The launch of one form of binned_level: "picked" (the training
    path's wrapper: the kernel picks from the shapes), or one forced by
    name (kernels.LEVEL_FORMS: "grouped", the tensor-core body; "wide";
    "tiled")."""
    from h2o3_tpu_torch.ops import kernels
    if form == "picked":
        return kernels.binned_level
    return lambda *a: kernels.binned_level_form(*a, form)


def adaptive_form(form):
    """The launch of one form of adaptive_level, as ``binned_form``."""
    from h2o3_tpu_torch.ops import kernels
    if form == "picked":
        return kernels.adaptive_level
    return lambda *a: kernels.adaptive_level_form(*a, form)


def check_level(rows, F, W, N, int_ghw, bf16, dev, seed, form="picked",
                inp=None):
    import torch
    from h2o3_tpu_torch.ops.hist_adaptive import binned_level_plain
    if inp is None:
        inp = level_inputs(rows, F, W, N, int_ghw, seed, dev)
    codes, nid, ghw, tables, n_prev, base = inp
    nk, hk = binned_form(form)(codes, nid, ghw, tables, n_prev, N, base, W,
                               bf16)
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
    name = f"binned_level {form} W={W} N={N}"
    if not torch.equal(nk, npl):
        raise AssertionError(f"{name}: nid differs in "
                             f"{int((nk != npl).sum())} rows")
    err = float((hk.double() - hp.double()).abs().max())
    if int_ghw:
        if not torch.equal(hk, hp):
            raise AssertionError(f"{name} integer ghw: histogram not "
                                 f"bit-equal (max {err})")
    else:
        _n, mass = binned_level_plain(codes, nid, ghw.double().abs(),
                                      tables, n_prev, N, base, W, bf16)
        mass_check(name, hk, hp, mass)
    return err, inp


def check_forms(kind, inp, N, W, bf16, forms):
    """Each of ``forms`` of a float level (kind "binned" on level_inputs,
    or "adaptive" on adaptive_inputs in [rows, F]) against the plain
    version on the same inputs, computed once in float64: nid bit-equal,
    each bin within the float tolerance (mass_check). Returns the largest
    absolute error of each form."""
    import torch
    from h2o3_tpu_torch.ops.hist_adaptive import (adaptive_level_plain,
                                                  binned_level_plain)
    if kind == "binned":
        codes, nid, ghw, tables, n_prev, base = inp
        run = lambda f: binned_form(f)(codes, nid, ghw, tables, n_prev, N,
                                       base, W, bf16)
        plain = lambda g: binned_level_plain(codes, nid, g, tables, n_prev,
                                             N, base, W, bf16)
    else:
        x, nid, ghw, tables, lo, inv, n_prev, base = inp
        run = lambda f: adaptive_form(f)(x, nid, ghw, tables, lo, inv,
                                         n_prev, N, base, W, bf16, "rows_f")
        plain = lambda g: adaptive_level_plain(x, nid, g, tables, lo, inv,
                                               n_prev, N, base, W, bf16)
    npl, hp = plain(ghw.double())
    _n, mass = plain(ghw.double().abs())
    errs = {}
    for form in forms:
        nk, hk = run(form)
        torch.cuda.synchronize()
        name = f"{kind}_level {form} W={W} N={N}"
        if not torch.equal(nk, npl):
            raise AssertionError(f"{name}: nid differs in "
                                 f"{int((nk != npl).sum())} rows")
        mass_check(name, hk, hp, mass)
        errs[form] = float((hk.double() - hp).abs().max())
        del nk, hk
    return errs


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


def level_forms(W):
    """The forced forms of a float level at lane width W: the tensor-core
    grouped body below W = 64, the wide body from W = 32 (at W = 32 the
    rule weighs the two), the tiled body."""
    if W >= 64:
        return ("wide", "tiled")
    return ("grouped", "wide", "tiled") if W == 32 else ("grouped", "tiled")


def phase_kernels(dev, rows=1_000_000, F=28):
    """Phase 3: every instance against its plain version at 1M rows; the
    packed level in the form the shapes pick and in every form forced."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import (binned_level_plain,
                                                  binned_route_only_plain)
    flush = torch_flush(dev)
    seed = 0
    for W in (16, 32, 64, 128, 256):
        forms = level_forms(W)
        for N in (1, 8, 32):
            seed += 1
            for form in forms:
                check_level(rows, F, W, N, True, False, dev, seed, form)
            err, inp = check_level(rows, F, W, N, False, False, dev,
                                   seed + 100)
            err16, _ = check_level(rows, F, W, N, False, True, dev,
                                   seed + 200)
            codes, nid, ghw, tables, n_prev, base = inp
            for form in forms:
                check_level(rows, F, W, N, False, False, dev, 0, form, inp)
            ms = {form: time_cuda(lambda: binned_form(form)(
                codes, nid, ghw, tables, n_prev, N, base, W, False), 20,
                flush) for form in forms}
            pms = time_cuda(lambda: binned_level_plain(
                codes, nid, ghw, tables, n_prev, N, base, W, False), 3,
                flush)
            bound, by = level_bound_ms(rows, F, codes.element_size(), N, W,
                                       rows)
            print(f"binned_level {rows}x{F} W={W} N={N}: {json.dumps(ms)} "
                  f"ms (plain {pms:.6g} ms, bound {bound:.6g} ms by {by}) "
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
    check_forms_refused(dev)


def check_forms_refused(dev):
    """A grouped form forced where it does not fit or has no instance
    raises, and nothing falls back: the packed level past 512 features,
    the adaptive level in [F, rows] (the int8 one too), the wide body of
    the float levels at W = 16 and of the int8 levels at W = 16 and 32,
    the tensor-core body of all four at W = 64, 128, 256 (the rule picks
    none of these)."""
    from h2o3_tpu_torch.ops import kernels
    codes, nid, ghw, tables, n_prev, base = level_inputs(2048, 600, 64, 4,
                                                         True, 3, dev)
    x, nidx, ghwx, tabx, lo, inv, n_px, base_x = adaptive_inputs(
        2048, 8, 64, 4, True, 3, dev, "f_rows")
    c16, n16, g16, t16, p16, b16 = level_inputs(2048, 8, 16, 4, True, 3, dev)
    x16, nx16, gx16, tx16, lo16, inv16, px16, bx16 = adaptive_inputs(
        2048, 8, 16, 4, True, 3, dev, "rows_f")
    launches = [(f"{kind} {form}", launch) for form in ("grouped", "wide")
                for kind, launch in (
                    ("binned_level 600 features",
                     lambda: kernels.binned_level_form(
                         codes, nid, ghw, tables, n_prev, 4, base, 64, True,
                         form)),
                    ("adaptive_level [F, rows]",
                     lambda: kernels.adaptive_level_form(
                         x, nidx, ghwx, tabx, lo, inv, n_px, 4, base_x, 64,
                         True, "f_rows", form)))]
    launches += [
        ("binned_level W=16 wide", lambda: kernels.binned_level_form(
            c16, n16, g16, t16, p16, 4, b16, 16, True, "wide")),
        ("adaptive_level W=16 wide", lambda: kernels.adaptive_level_form(
            x16, nx16, gx16, tx16, lo16, inv16, px16, 4, bx16, 16, True,
            "rows_f", "wide"))]
    # the int8 levels: the wide body below W = 64 and in [F, rows]
    from h2o3_tpu_torch.ops.hist_adaptive import quantize_ghw_i8
    for W in (16, 32):
        ci, ni, gi, ti, pi, bi = level_inputs(2048, 8, W, 4, True, 3, dev)
        xi, nxi, gxi, txi, loi, invi, pxi, bxi = adaptive_inputs(
            2048, 8, W, 4, True, 3, dev, "rows_f")
        launches += [
            (f"binned_level_i8 W={W} wide",
             lambda ci=ci, ni=ni, gi=gi, ti=ti, pi=pi, bi=bi, W=W:
             kernels.binned_level_i8_form(ci, ni, *quantize_ghw_i8(gi), ti,
                                          pi, 4, bi, W, "wide")),
            (f"adaptive_level_i8 W={W} wide",
             lambda xi=xi, nxi=nxi, gxi=gxi, txi=txi, loi=loi, invi=invi,
             pxi=pxi, bxi=bxi, W=W: kernels.adaptive_level_i8_form(
                 xi, nxi, *quantize_ghw_i8(gxi), txi, loi, invi, pxi, 4, bxi,
                 W, "rows_f", "wide"))]
    launches.append(("adaptive_level_i8 [F, rows] wide",
                     lambda: kernels.adaptive_level_i8_form(
                         x, nidx, *quantize_ghw_i8(ghwx), tabx, lo, inv,
                         n_px, 4, base_x, 64, "f_rows", "wide")))
    # the tensor-core body at W >= 64 (no instance: the wide body wins
    # every level there), float and int8
    for W in WIDE_W:
        cw, nw, gw, tw, pw, bw = level_inputs(2048, 8, W, 4, True, 3, dev)
        xw, nxw, gxw, txw, low, invw, pxw, bxw = adaptive_inputs(
            2048, 8, W, 4, True, 3, dev, "rows_f")
        launches += [
            (f"binned_level W={W} grouped",
             lambda cw=cw, nw=nw, gw=gw, tw=tw, pw=pw, bw=bw, W=W:
             kernels.binned_level_form(cw, nw, gw, tw, pw, 4, bw, W, True,
                                       "grouped")),
            (f"adaptive_level W={W} grouped",
             lambda xw=xw, nxw=nxw, gxw=gxw, txw=txw, low=low, invw=invw,
             pxw=pxw, bxw=bxw, W=W: kernels.adaptive_level_form(
                 xw, nxw, gxw, txw, low, invw, pxw, 4, bxw, W, True,
                 "rows_f", "grouped")),
            (f"binned_level_i8 W={W} grouped",
             lambda cw=cw, nw=nw, gw=gw, tw=tw, pw=pw, bw=bw, W=W:
             kernels.binned_level_i8_form(cw, nw, *quantize_ghw_i8(gw), tw,
                                          pw, 4, bw, W, "grouped")),
            (f"adaptive_level_i8 W={W} grouped",
             lambda xw=xw, nxw=nxw, gxw=gxw, txw=txw, low=low, invw=invw,
             pxw=pxw, bxw=bxw, W=W: kernels.adaptive_level_i8_form(
                 xw, nxw, *quantize_ghw_i8(gxw), txw, low, invw, pxw, 4,
                 bxw, W, "rows_f", "grouped"))]
    for name, launch in launches:
        try:
            launch()
        except (RuntimeError, ValueError):
            continue
        raise AssertionError(f"forced form {name} did not raise where it "
                             f"does not fit")
    print(f"forced grouped forms where they do not fit or have no instance "
          f"({len(launches)}: 600 features; [F, rows]; the wide body of the "
          f"float levels at W = 16 and of the int8 levels at W = 16, 32; the "
          f"tensor-core body at W = 64, 128, 256): every one raised",
          flush=True)


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
                         specials=False, form="picked"):
    import torch
    from h2o3_tpu_torch.ops.hist_adaptive import adaptive_level_plain
    inp = adaptive_inputs(rows, F, W, N, int_ghw, seed, dev, layout,
                          specials)
    x, nid, ghw, tables, lo, inv, n_prev, base = inp
    nk, hk = adaptive_form(form)(x, nid, ghw, tables, lo, inv, n_prev, N,
                                 base, W, bf16, layout)
    npl, hp = adaptive_level_plain(x, nid, ghw if int_ghw else ghw.double(),
                                   tables, lo, inv, n_prev, N, base, W, bf16,
                                   layout)
    torch.cuda.synchronize()
    name = f"adaptive_level {form} {layout} W={W} N={N}"
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
    flush = torch_flush(dev)
    seed = 500
    for layout in LAYOUTS:
        for W in (16, 32, 64, 128, 256):
            for N in (1, 8, 32):
                seed += 1
                check_adaptive_level(rows, F, W, N, True, False, dev, seed,
                                     layout)
                if layout == "rows_f" and W >= 32:
                    for form in level_forms(W):
                        check_adaptive_level(rows, F, W, N, True, False, dev,
                                             seed, layout, form=form)
                        check_adaptive_level(rows, F, W, N, False, True, dev,
                                             seed + 300, layout, form=form)
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
    path's wrapper: the kernel picks from the shapes, node-grouped
    wherever a cell fits shared memory) or "global" (global atomics
    forced)."""
    from h2o3_tpu_torch.ops import kernels
    if form == "picked":
        return kernels.global_hist
    return lambda *a: kernels.global_hist_form(*a, False)


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
    rows, B1 in {15, 257, 1025}, N in {1, 8, 16, 32}, integer masses in
    both forms of the kernel (bit-equal), float masses within tolerance,
    timed with the L2 flushed in the picked (node-grouped) form and with
    global atomics forced."""
    from h2o3_tpu_torch.ops.histogram import build_histograms_plain
    import torch
    flush = torch_flush(dev)
    seed = 700
    for B1 in (15, 257, 1025):
        for N in (1, 8, 16, 32):
            seed += 1
            for form in ("picked", "global"):
                check_global(rows, F, B1, N, True, False, dev, seed,
                             form=form)
            err16, _ = check_global(rows, F, B1, N, False, True, dev,
                                    seed + 100)
            err, (codes, seg, ghw) = check_global(rows, F, B1, N, False,
                                                  False, dev, seed + 200)
            ms, ms_g = (time_cuda(lambda: global_form(form)(
                codes, seg, ghw, N, B1, False), 20, flush)
                for form in ("picked", "global"))
            pms = time_cuda(lambda: build_histograms_plain(
                codes, seg, ghw, N, B1, False), 3, flush)
            live = int(((seg >= 0) & (seg < N)).sum())
            bound, by = global_bound_ms(rows, F, codes.element_size(), N, B1,
                                        live)
            print(f"global_hist {rows}x{F} {str(codes.dtype)[6:]} B1={B1} "
                  f"N={N}: {ms:.6g} ms (global atomics forced {ms_g:.6g}; "
                  f"plain {pms:.6g} ms, bound {bound:.6g} ms by {by}) max "
                  f"abs err f32 {err:.3g} bf16 {err16:.3g}", flush=True)
            del codes, seg, ghw


def off_window(nid, seed):
    """5% of the rows moved outside every level's window."""
    import torch
    g = torch.Generator(device=nid.device).manual_seed(seed)
    out = torch.rand(nid.shape[0], generator=g, device=nid.device) < 0.05
    return torch.where(out, 1 << 20, nid).to(torch.int32).contiguous()


def i8_forms(layout, W):
    """The forms of an int8 level at lane width W, the forced ones first
    and the one the kernel picks last: in [rows, F] the tensor-core
    grouped body at W <= 32, the wide body at W >= 64, and the tiled
    body; [F, rows] has the tiled body alone."""
    if layout != "rows_f":
        return ("tiled", "picked")
    if W <= 32:
        return ("grouped", "tiled", "picked")
    return ("wide", "tiled", "picked")


def i8_level(kind, inp, qs, N, W, layout="rows_f", form="picked"):
    """One int8 level launch (kind "binned" or "adaptive") on the inputs
    of level_inputs / adaptive_inputs and ``qs`` = (q, scales), in one
    form: "picked" (the training path's wrapper: the kernel picks from the
    shapes), or one forced by name (kernels.LEVEL_FORMS)."""
    from h2o3_tpu_torch.ops import kernels
    if kind == "binned":
        codes, nid, _g, tables, n_prev, base = inp
        args = (codes, nid, *qs, tables, n_prev, N, base, W)
        if form == "picked":
            return kernels.binned_level_i8(*args)
        return kernels.binned_level_i8_form(*args, form)
    x, nid, _g, tables, lo, inv, n_prev, base = inp
    args = (x, nid, *qs, tables, lo, inv, n_prev, N, base, W, layout)
    if form == "picked":
        return kernels.adaptive_level_i8(*args)
    return kernels.adaptive_level_i8_form(*args, form)


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


def check_i8(kind, rows, F, W, N, terms, dev, seed, layout="rows_f",
             inp=None):
    """An int8 level against its plain version in each of its forms: nid
    and histogram bit-equal (integer sums, the same float32 flush)."""
    import torch
    from h2o3_tpu_torch.ops.hist_adaptive import quantize_ghw_i8
    if inp is None:
        inp = i8_inputs(kind, rows, F, W, N, seed, dev, layout)
    qs = quantize_ghw_i8(inp[2], terms)
    npl, hp = i8_plain(kind, inp, qs, N, W, layout)
    for form in i8_forms(layout, W):
        nk, hk = i8_level(kind, inp, qs, N, W, layout, form)
        torch.cuda.synchronize()
        name = f"{kind}_level_i8 {form} {layout} W={W} N={N} terms={terms}"
        if not torch.equal(nk, npl):
            raise AssertionError(f"{name}: nid differs in "
                                 f"{int((nk != npl).sum())} rows")
        if not torch.equal(hk, hp):
            err = float((hk.double() - hp.double()).abs().max())
            raise AssertionError(f"{name}: histogram not bit-equal (max "
                                 f"{err})")
        del nk, hk
    return inp, qs


I8_LEVELS = ((1, (1, 2, 4, 8, 16, 32)), (2, (1, 2, 4, 8, 16)))  # (terms, N)


def time_i8_forms(kind, inp, qs, N, W, reps, flush=None):
    """Median ms of each [rows, F] form of an int8 level on the same
    inputs."""
    return {form: time_cuda(lambda: i8_level(kind, inp, qs, N, W, "rows_f",
                                             form), reps, flush)
            for form in i8_forms("rows_f", W)}


I8_W = (16, 32, 64, 128, 256)


def phase_i8_kernels(dev, rows=1_000_000, F=28):
    """Phase 3, int8 levels: binned_level_i8 and adaptive_level_i8 (both
    layouts) at W in {16, 32, 64, 128, 256}, one term at N = 1..32, two at
    N = 1..16, with NA codes / NaN features and 5% of the rows off the
    window, in every form (``i8_forms``: the tensor-core grouped body
    below W = 64, the wide body from W = 64, the tiled body forced, and
    the one the kernel picks; [F, rows] has no grouped form): bit-equal
    to the plain version; the [rows, F] forms timed with the L2
    flushed."""
    flush = torch_flush(dev)
    seed, n = 1100, 0
    for W in I8_W:
        for terms, levels in I8_LEVELS:
            per = {"binned": {}, "adaptive": {}}
            for N in levels:
                seed += 1
                for kind in ("binned", "adaptive"):
                    inp, qs = check_i8(kind, rows, F, W, N, terms, dev,
                                       seed + (500 if kind == "adaptive"
                                               else 0))
                    per[kind][N] = time_i8_forms(kind, inp, qs, N, W, 20,
                                                 flush)
                    del inp, qs
                    n += len(i8_forms("rows_f", W))
                check_i8("adaptive", rows, F, W, N, terms, dev, seed + 500,
                         "f_rows")
                n += 2
            print(f"int8 levels {rows}x{F} W={W} terms={terms}, per level N "
                  f"and form (ms): {json.dumps(per)}", flush=True)
    print(f"int8 levels at {rows}x{F}: {n} (level, form) cases "
          f"(binned_level_i8, adaptive_level_i8 rows_f and f_rows; W "
          f"16/32/64/128/256; terms 1 at N 1..32, terms 2 at N 1..16; "
          f"every form and the picked one) bit-equal to the plain version",
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


def segment_inputs(rows, N, seed, dev):
    """nid over the N nodes of a level at base N - 1, 5% of the rows off
    it, float (g, h, w)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    base = N - 1
    nid = base + torch.randint(0, N, (rows,), generator=g, device=dev)
    ghw = torch.stack([torch.randn(rows, generator=g, device=dev),
                       torch.rand(rows, generator=g, device=dev) * 0.25,
                       torch.ones(rows, device=dev)]).contiguous()
    return off_window(nid, seed), ghw, base


def check_segment(rows, N, dev, seed):
    """segment_totals (the leaf-totals kernel without a route) against
    its plain version: within 1e-4 + 1e-5 x each node's absolute mass of
    the float64 plain version, and five launches with the same bits."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.common import segment_totals_plain
    nid, ghw, base = segment_inputs(rows, N, seed, dev)
    runs = [kernels.segment_totals(nid, ghw, N, base) for _ in range(5)]
    tp = segment_totals_plain(nid, ghw.double(), N, base)
    mass = segment_totals_plain(nid, ghw.double().abs(), N, base)
    torch.cuda.synchronize()
    if not all(torch.equal(runs[0], r) for r in runs[1:]):
        raise AssertionError(f"segment_totals N={N}: five launches differ")
    mass_check(f"segment_totals N={N}", runs[0], tp, mass)
    return float((runs[0].double() - tp).abs().max()), (nid, ghw, base)


def phase_totals_kernel(dev, rows=1_000_000, F=28):
    """Phase 3, leaf_totals at n_prev in {0, 32}, N in {1, 64}, and its
    instance without a route, segment_totals, at N in {1, 64, 512,
    4096}."""
    errs = {}
    for n_prev in (0, 32):
        for N in (1, 64):
            errs[f"n_prev={n_prev} N={N}"] = check_totals(
                rows, F, n_prev, N, dev, 1200 + n_prev + N)[0]
    for N in (1, 64, 512, 4096):
        errs[f"segment N={N}"] = check_segment(rows, N, dev, 1250 + N)[0]
    print(f"leaf_totals at {rows}x{F}: nid bit-equal, totals within "
          f"1e-4 + 1e-5 x mass of float64; segment_totals five launches "
          f"bit-equal; max abs err {json.dumps(errs)}", flush=True)


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
    for one in ("route", "totals"):
        if PATHS[path].get(one):
            expected[PATHS[path][one]] = ntrees
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
    """A float path on the card and on the CPU at float32 histograms:
    every tree's splits (feature, split bin or threshold, NA side) must
    be equal, and |dAUC| <= 1e-4."""
    X, y, _F = higgs_arrays(rows, seed=11)
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = train(frame_of(X, y, dev), ntrees, path,
                            histogram_precision="float32", **kw)
    mc, mh = models["cuda"], models["cpu"]
    keys = ("feat", PATHS[path]["split_key"], "na_left")
    same = [all(np.array_equal(mc.trees[k][t], mh.trees[k][t])
                for k in keys) for t in range(ntrees)]
    if not all(same):
        t = same.index(False)
        raise AssertionError(
            f"{path}: {sum(same)} of {ntrees} trees' splits equal between "
            f"cuda and cpu, first differing: tree {t} "
            f"({split_flips(mc.trees, mh.trees)}): "
            + "; ".join(f"{k} {mc.trees[k][t]} vs {mh.trees[k][t]}"
                        for k in keys))
    d_auc = abs(mc.training_metrics.auc - mh.training_metrics.auc)
    if d_auc > 1e-4:
        raise AssertionError(f"{path}: |dAUC| cuda vs cpu = {d_auc}")
    print(f"card vs cpu, {path} {json.dumps(kw)}: {rows} rows, {ntrees} "
          f"trees, float32 histograms: {sum(same)} of "
          f"{ntrees} trees' splits identical "
          f"({split_flips(mc.trees, mh.trees)}), AUC cuda "
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
    codes, int16 at W = 256; adaptive float32 features in the training
    layout), per level: one term at N = 1..32 and two at N = 1..16, at W =
    16, 32, 64, 128 and 256, every form (``i8_forms``: forced, and the one
    the kernel picks, named by ``*_i8_picks``) checked bit-equal to the
    plain version at 10M rows and timed on the same inputs. At one term,
    at the path's own W (16 packed, 32 adaptive) and at every wide W, the
    float kernel of the same level (bfloat16 masses, as the path takes it
    without the switch; the wide body at the wide W) on the same inputs in
    the same run, and at N = 32 the plain version, one ``index_add_`` of
    the rows' q widened to int32 into int32 over a precomputed flat (node,
    feature, bin) index (library_ms) and the bound; for the adaptive
    kernel at its path's W the [F, rows] layout (the tiled body). Prints
    the levels where the form the rule picks took more than 5% above the
    fastest forced form (each timed forced, on the same inputs).""" 
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import adaptive_bins_plain
    rec = []
    for kind, w_path in (("binned", 16), ("adaptive", 32)):
        name = f"{kind}_level_i8"
        picks_fn = (kernels.binned_level_i8_picks if kind == "binned"
                    else kernels.adaptive_level_i8_picks)
        times, float_ms, picked, slow = {}, {}, {}, []
        plain, lib, bound, other = {}, {}, {}, None
        for W in I8_W:
            forced = [f for f in i8_forms("rows_f", W) if f != "picked"]
            for terms, levels in I8_LEVELS:
                per = {form: {} for form in i8_forms("rows_f", W)}
                for N in levels:
                    seed = 1400 + 10 * W + 100 * terms + N
                    inp, qs = check_i8(kind, rows, F, W, N, terms, dev, seed)
                    for form, ms in time_i8_forms(kind, inp, qs, N, W,
                                                  20).items():
                        per[form][N] = ms
                    # the rule's form against the fastest forced form, each
                    # timed forced on these inputs
                    fastest = min(per[f][N] for f in forced)
                    rule = picks_fn(rows, F, W, N // 2, N, terms)
                    picked.setdefault(W, {}).setdefault(terms, {})[N] = rule
                    if per[rule][N] > 1.05 * fastest:
                        slow.append(f"W={W} terms={terms} N={N}")
                    if terms == 1 and (W == w_path or W >= 64):
                        if kind == "binned":
                            codes, nid, ghw, tables, n_prev, base = inp
                            float_ms.setdefault(W, {})[N] = time_cuda(
                                lambda: kernels.binned_level(
                                    codes, nid, ghw, tables, n_prev, N, base,
                                    W, True), 10)
                        else:
                            x, nid, ghw, tables, lo, inv, n_prev, base = inp
                            float_ms.setdefault(W, {})[N] = time_cuda(
                                lambda: kernels.adaptive_level(
                                    x, nid, ghw, tables, lo, inv, n_prev, N,
                                    base, W, True, "rows_f"), 10)
                    if terms == 1 and N == 32 and (W == w_path or W >= 64):
                        plain[W] = time_cuda(lambda: i8_plain(
                            kind, inp, qs, N, W), 3)
                        nid_out = i8_level(kind, inp, qs, N, W)[0]
                        bins = (inp[0] if kind == "binned" else
                                adaptive_bins_plain(inp[0], nid_out, inp[4],
                                                    inp[5], N, inp[7], W))
                        lib[W] = index_add_ms(bins, nid_out, qs[0].t().int(),
                                              N, inp[-1], W)
                        bound[W] = i8_level_bound_ms(
                            kind, rows, F, N, W, 1, rows,
                            inp[0].element_size())
                        del bins, nid_out
                        if kind == "adaptive" and W == w_path:
                            # the same values in [F, rows]
                            inp_o = (inp[0].t().contiguous(),) + \
                                tuple(inp[1:])
                            other = {"f_rows": time_cuda(
                                lambda: i8_level(kind, inp_o, qs, N, W,
                                                 "f_rows"), 10)}
                            del inp_o
                    del inp, qs
                times.setdefault(W, {})[terms] = per
                sums = {form: sum(v.values()) for form, v in per.items()}
                print(f"{name} at 10M x 28, W={W}, terms={terms}, per level "
                      f"N and form: {json.dumps(per)} ms; sum per tree "
                      f"{json.dumps(sums)} ms; picked "
                      f"{json.dumps(picked[W][terms])}", flush=True)
        tree = {w: {t: {form: sum(v.values()) for form, v in per.items()}
                    for t, per in by_t.items()}
                for w, by_t in times.items()}
        float_tree = {w: sum(v.values()) for w, v in float_ms.items()}
        by, rest = bound[w_path][1], {w: b[0] for w, b in bound.items()}
        print(f"{name} at 10M x 28, one term, sum per tree by W (int8 "
              f"forms) {json.dumps({w: t[1] for w, t in tree.items()})} ms, "
              f"the float level (bf16, picked) {json.dumps(float_tree)} ms; "
              f"N=32 by W: picked "
              f"{json.dumps({w: times[w][1]['picked'][32] for w in plain})} "
              f"ms, plain {json.dumps(plain)} ms, index_add_ "
              f"{json.dumps(lib)} ms, bound {json.dumps(rest)} ms"
              + (f", other layout {json.dumps(other)} ms" if other else "")
              + f"; picked form more than 5% above the fastest forced one "
              f"at {slow or 'no level'}", flush=True)
        rec.append({"name": name, "route": "cuda", "source": SRC[name],
                    "replaces": REPLACES[name],
                    "launches": launches[name], "max_abs_err": 0.0,
                    "ms": times[w_path][1]["picked"][32],
                    "ms_tree": tree[w_path][1],
                    "ms_tree_terms2": tree[w_path][2],
                    "ms_tree_by_w": {w: t for w, t in tree.items()
                                     if w != w_path},
                    "float_level_ms_tree": float_tree[w_path],
                    "float_level_ms_tree_by_w": float_tree,
                    "plain_ms": plain[w_path], "bound_ms": rest[w_path],
                    "bound_by": by, "library_ms": lib[w_path],
                    "ms_by_w": {w: times[w][1]["picked"][32]
                                for w in plain},
                    "plain_ms_by_w": plain, "bound_ms_by_w": rest,
                    "library_ms_by_w": lib, "picked_by_w": picked,
                    "picked_slow": slow})
    return rec


def phase_totals_record(dev, launches, rows=10_000_000, F=28, n_prev=32,
                        N=64):
    """leaf_totals at 10M x 28 after a depth-6 tree's last split level
    (n_prev = 32, N = 64): time, plain version's time, bound (nid in and
    out, ghw, the one x value a row the route reads); no path launches it
    with a route, in either package. Its instance without a route,
    segment_totals, at the packed and global paths' deepest level (10M
    rows, N = 64): time, plain version's time, one ``index_add_`` over the
    rows' node index (library_ms), bound (nid and ghw read once)."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.common import segment_totals_plain
    from h2o3_tpu_torch.ops.hist_adaptive import leaf_totals_plain
    err, (x, nid, ghw, tables, base) = check_totals(rows, F, n_prev, N, dev,
                                                   1500)
    ms = time_cuda(lambda: kernels.leaf_totals(x, nid, ghw, tables, n_prev, N,
                                               base), 20)
    pms = time_cuda(lambda: leaf_totals_plain(x, nid, ghw, tables, n_prev, N,
                                              base), 3)
    del x
    nbytes = rows * (4 + 4 + 12 + 4)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, 3 * rows / F32_OPS_PER_S
    bound, by = max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")
    print(f"leaf_totals at 10M x 28, n_prev={n_prev} N={N}: {ms!r} ms, plain "
          f"{pms!r} ms, bound {bound!r} ms by {by}, max abs err {err!r}",
          flush=True)
    rec = [{"name": "leaf_totals", "route": "cuda",
            "source": SRC["leaf_totals"], "replaces": REPLACES["leaf_totals"],
            "launches": launches["leaf_totals"], "max_abs_err": err,
            "ms": ms, "plain_ms": pms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}]
    serr, (nid, ghw, base) = check_segment(rows, N, dev, 1501)
    sms = time_cuda(lambda: kernels.segment_totals(nid, ghw, N, base), 20)
    spms = time_cuda(lambda: segment_totals_plain(nid, ghw, N, base), 3)
    lid = nid.long() - base
    live = (lid >= 0) & (lid < N)
    idx = torch.where(live, lid, 0)
    vals = (ghw * live).t().contiguous()
    out = torch.zeros((N, 3), device=dev)
    lib_ms = time_cuda(lambda: out.index_add_(0, idx, vals), 20)
    del lid, live, idx, vals, out
    t_b, t_o = rows * (4 + 12) / HBM_BYTES_PER_S, 3 * rows / F32_OPS_PER_S
    sbound, sby = max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o
                                        else "operations")
    print(f"segment_totals at 10M rows, N={N}: {sms!r} ms, plain {spms!r} "
          f"ms, index_add_ {lib_ms!r} ms, bound {sbound!r} ms by {sby}, max "
          f"abs err {serr!r}; five launches bit-equal", flush=True)
    rec.append({"name": "segment_totals", "route": "cuda",
                "source": SRC["segment_totals"],
                "replaces": REPLACES["segment_totals"],
                "launches": launches["segment_totals"], "max_abs_err": serr,
                "ms": sms, "plain_ms": spms, "bound_ms": sbound,
                "bound_by": sby, "library_ms": lib_ms})
    return rec


def index_add_ms(bins, nid_out, vals, N, base, W, reps=5):
    """The library yardstick of a level's histogram: one ``index_add_`` of
    the values ``vals`` [rows, C] of the rows in the level's window over
    their flat (node, feature, bin) index (``bins`` [rows, F], the codes
    or the adaptive bins), index and values built before the timing:
    float values into float32, int32 into int32. The port never calls
    it."""
    import torch
    F = bins.shape[1]
    lid = nid_out.long() - base
    live = (lid >= 0) & (lid < N)
    flat = ((lid[live][:, None] * F + torch.arange(F, device=bins.device))
            * W + bins[live].long()).reshape(-1)
    v = vals[live]
    v = v[:, None, :].expand(-1, F, v.shape[1]).reshape(-1, v.shape[1])
    v = v.contiguous()
    out = torch.zeros((N * F * W, v.shape[1]), dtype=v.dtype,
                      device=bins.device)
    ms = time_cuda(lambda: out.index_add_(0, flat, v), reps)
    del flat, v, out
    return ms


def bf16_rows(ghw):
    """(g, h, w) a row, bf16-rounded, as float32 [rows, 3]."""
    import torch
    return ghw.t().to(torch.bfloat16).float()


def phase_kernel_record(dev, launches, rows=10_000_000, F=28):
    """The packed kernels at the packed main path's shapes (10M x 28 int8
    codes, W = 16, bfloat16-rounded (g, h, w) as histogram_precision=
    'auto' picks at this size). binned_level per level N = 1..32: the
    form the path takes (node-grouped) and the tiled body forced, at bf16,
    and the grouped form at float32, each level checked against the plain
    version at 10M rows (both precisions, both forms at bf16) and launched
    five times with the same bits; at N = 32 the plain version's time,
    the bound, one ``index_add_`` (library_ms) and the grouping pass
    alone. The same per level at W = 32, bf16, in the tensor-core, the
    wide and the tiled form, and one ``index_add_`` at N = 32 (the wide
    widths: phase_wide_record): the form rule (level_form in
    csrc/level_wide.cuh) rests on these. The route at N = 64."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import (binned_level_plain,
                                                  binned_route_only_plain)
    N = 32
    sums, errs, by_w, lib_by_w = {}, {}, {}, {}
    for W in (16, 32):
        forms = ("grouped", "tiled") + (("wide",) if W == 32 else ())
        per = {f"{form}_bf16": {} for form in forms}
        if W == 16:
            per["grouped_f32"] = {}
        for n_lvl in (1, 2, 4, 8, 16, 32):
            seed = 1234 + 7 * W + n_lvl
            inp = level_inputs(rows, F, W, n_lvl, False, seed, dev)
            for form, e in check_forms("binned", inp, n_lvl, W, True,
                                       forms).items():
                errs[f"W={W} {form} bf16 N={n_lvl}"] = e
            e = errs[f"W={W} grouped bf16 N={n_lvl}"]
            codes, nid, ghw, tables, n_prev, base = inp
            for form in forms:
                per[f"{form}_bf16"][n_lvl] = time_cuda(
                    lambda: binned_form(form)(codes, nid, ghw, tables,
                                              n_prev, n_lvl, base, W, True),
                    10)
            if W == 32 and n_lvl == N:
                nid_out = binned_form("picked")(codes, nid, ghw, tables,
                                                n_prev, N, base, W, True)[0]
                lib_by_w[W] = index_add_ms(codes, nid_out, bf16_rows(ghw), N,
                                           base, W)
                del nid_out
            if W == 16:
                e32, _ = check_level(rows, F, W, n_lvl, False, False, dev, 0,
                                     "grouped", inp)
                errs[f"W=16 f32 N={n_lvl}"] = e32
                per["grouped_f32"][n_lvl] = time_cuda(
                    lambda: binned_form("grouped")(
                        codes, nid, ghw, tables, n_prev, n_lvl, base, W,
                        False), 10)
                outs = [binned_form("grouped")(codes, nid, ghw, tables,
                                               n_prev, n_lvl, base, W, True)
                        for _ in range(5)]
                if not all(torch.equal(outs[0][1], o[1]) for o in outs[1:]):
                    raise AssertionError(f"binned_level grouped N={n_lvl}: "
                                         f"five launches differ")
                if n_lvl == N:
                    ms, err = per["grouped_bf16"][N], e
                    pms = time_cuda(lambda: binned_level_plain(
                        codes, nid, ghw, tables, n_prev, N, base, W, True),
                        3)
                    lib_ms = index_add_ms(codes, outs[0][0], bf16_rows(ghw),
                                          N, base, W)
                    lp = nid.long() - (base - n_prev)
                    keys = torch.where(
                        tables[3][lp.clamp(0, n_prev - 1)] != 0, lp,
                        -1).to(torch.int32)
                    group_ms = time_cuda(lambda: kernels.group_rows(
                        keys, n_prev + N, ghw), 10)
                    del lp, keys
                del outs
            del inp, codes, nid, ghw
        sums[W] = {k: sum(v.values()) for k, v in per.items()}
        by_w[W] = per
        print(f"binned_level at 10M x 28, W={W} (int8 codes), "
              f"per level N (grouped: the node-grouped tensor-core form; "
              f"wide: the wide body; tiled: the tiled body; all forced): "
              f"{json.dumps(per)} ms; sum per tree {json.dumps(sums[W])} ms",
              flush=True)
    bound, by = level_bound_ms(rows, F, 1, N, 16, rows)
    print(f"binned_level W=16 N={N}: {ms!r} ms, plain {pms!r} ms, "
          f"index_add_ {lib_ms!r} ms (W=32: {json.dumps(lib_by_w)}), "
          f"grouping pass alone {group_ms!r} ms, "
          f"bound {bound!r} ms by {by}; five launches bit-equal at every "
          f"level; max abs err vs plain {json.dumps(errs)}", flush=True)
    rec = [{"name": "binned_level", "route": "cuda",
            "source": SRC["binned_level"],
            "replaces": REPLACES["binned_level"],
            "also_replaces": ALSO_REPLACES["binned_level"],
            "launches": launches["binned_level"], "max_abs_err": err,
            "ms": ms, "ms_tree": sums[16]["grouped_bf16"],
            "ms_tree_tiled": sums[16]["tiled_bf16"],
            "ms_tree_f32": sums[16]["grouped_f32"],
            "ms_tree_by_w": {w: v for w, v in sums.items() if w != 16},
            "group_ms": group_ms, "plain_ms": pms, "bound_ms": bound,
            "bound_by": by, "library_ms": lib_ms,
            "library_ms_by_w": lib_by_w}]
    W = 16
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


def phase_wide_record(dev, rows=10_000_000, F=28):
    """The float levels at the wide lane widths (W = 64, 128 with int8
    codes, 256 with int16 codes; K8 on float32 features in [rows, F]),
    10M x 28, bfloat16-rounded masses as histogram_precision='auto' picks
    at this size, per level N = 1..32: every form (the wide body, the
    tiled body) checked against the plain version at 10M rows and timed
    on the same inputs, the wide form launched five times with the same
    bits, and the form the kernel picks (``*_picks``); at N = 32 the
    plain version's time, the bound and one ``index_add_`` over a
    precomputed flat (node, feature, bin) index (library_ms). Returns,
    per kind, the record fields the kernel line carries."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import (adaptive_bins_plain,
                                                  adaptive_level_plain,
                                                  binned_level_plain)
    N = 32
    out = {}
    for kind in ("binned", "adaptive"):
        picks = (kernels.binned_level_picks if kind == "binned"
                 else kernels.adaptive_level_picks)
        rec = {"ms_level": {}, "ms_tree": {}, "picked": {},
               "ms_tree_picked": {}, "plain_ms": {}, "bound_ms": {},
               "bound_by": {}, "library_ms": {}, "max_abs_err": {}}
        for W in WIDE_W:
            per = {form: {} for form in level_forms(W)}
            picked = {}
            err = 0.0
            for n_lvl in (1, 2, 4, 8, 16, 32):
                seed = 2600 + 7 * W + n_lvl + (0 if kind == "binned" else 50)
                if kind == "binned":
                    inp = level_inputs(rows, F, W, n_lvl, False, seed, dev)
                    run = lambda f: binned_form(f)(
                        *inp[:4], inp[4], n_lvl, inp[5], W, True)
                    n_prev, base = inp[4], inp[5]
                else:
                    inp = adaptive_inputs(rows, F, W, n_lvl, False, seed,
                                          dev, "rows_f")
                    run = lambda f: adaptive_form(f)(
                        *inp[:6], inp[6], n_lvl, inp[7], W, True, "rows_f")
                    n_prev, base = inp[6], inp[7]
                errs = check_forms(kind, inp, n_lvl, W, True, level_forms(W))
                err = max(err, errs["wide"])
                outs = [run("wide") for _ in range(5)]
                if not all(torch.equal(outs[0][1], o[1]) and
                           torch.equal(outs[0][0], o[0]) for o in outs[1:]):
                    raise AssertionError(f"{kind}_level wide W={W} "
                                         f"N={n_lvl}: five launches differ")
                for form in level_forms(W):
                    per[form][n_lvl] = time_cuda(lambda: run(form), 10)
                picked[n_lvl] = picks(rows, F, W, n_prev, n_lvl)
                if n_lvl == N:
                    nid_out = outs[0][0]
                    if kind == "binned":
                        bins = inp[0]
                        rec["plain_ms"][W] = time_cuda(
                            lambda: binned_level_plain(
                                *inp[:4], n_prev, N, base, W, True), 3)
                        b = level_bound_ms(rows, F, inp[0].element_size(),
                                           N, W, rows)
                    else:
                        bins = adaptive_bins_plain(inp[0], nid_out, inp[4],
                                                   inp[5], N, base, W)
                        rec["plain_ms"][W] = time_cuda(
                            lambda: adaptive_level_plain(
                                *inp[:6], n_prev, N, base, W, True), 3)
                        b = adaptive_level_bound_ms(rows, F, N, W, rows)
                    rec["bound_ms"][W], rec["bound_by"][W] = b
                    rec["library_ms"][W] = index_add_ms(
                        bins, nid_out, bf16_rows(inp[2]), N, base, W)
                    del bins, nid_out
                del outs, inp
                torch.cuda.empty_cache()
            sums = {form: sum(v.values()) for form, v in per.items()}
            rec["ms_level"][W] = per
            rec["ms_tree"][W] = sums
            rec["picked"][W] = picked
            rec["ms_tree_picked"][W] = sum(per[picked[n]][n] for n in per[
                "wide"])
            rec["max_abs_err"][W] = err
            dtype = ("float32 x" if kind == "adaptive" else
                     "int16 codes" if W == 256 else "int8 codes")
            print(f"{kind}_level at 10M x 28, W={W} ({dtype}), bf16, per "
                  f"level N and form (wide: the wide body; tiled: the tiled "
                  f"body; both forced and checked against the plain "
                  f"version; wide five launches bit-equal): "
                  f"{json.dumps(per)} ms; sum per "
                  f"tree {json.dumps(sums)} ms; picked {json.dumps(picked)}, "
                  f"a tree {rec['ms_tree_picked'][W]!r} ms; N=32: plain "
                  f"{rec['plain_ms'][W]!r} ms, index_add_ "
                  f"{rec['library_ms'][W]!r} ms, bound "
                  f"{rec['bound_ms'][W]!r} ms by {rec['bound_by'][W]}",
                  flush=True)
        out[kind] = rec
    return out


def phase_adaptive_record(dev, launches, rows=10_000_000, F=28):
    """The adaptive kernels at the adaptive main path's shapes (10M x 28
    float32 features, W=32). In the training layout ([rows, F], the
    node-grouped tensor-core level): per level N = 1..32 at bfloat16
    (as histogram_precision='auto' picks at this size) and at float32,
    each checked against the plain version at 10M rows, and the grouped
    kernel's shared-atomics ablation on the same inputs (checked too), and
    the wide body forced at bfloat16 (checked: the form rule keeps the
    tensor-core body at this W); the grouping pass alone at N = 32; at
    N = 32 the plain version's time and the bound. In [F, rows] (K5, the
    tiled body) per level at bfloat16.
    The route at N = 64 in both layouts."""
    import torch
    from h2o3_tpu_torch.models.gbm import ADAPTIVE_LAYOUT
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import (adaptive_bins_plain,
                                                  adaptive_level_plain,
                                                  adaptive_route_only_plain)
    W, N = 32, 32
    level_ms, route_ms = {}, {}
    per = {"bf16": {}, "f32": {}, "atomics_bf16": {}, "atomics_f32": {},
           "f_rows_bf16": {}, "wide_bf16": {}}
    errs = {}
    for n_lvl in (1, 2, 4, 8, 16, 32):
        for bf16 in (True, False):
            tag = "bf16" if bf16 else "f32"
            e, inp = check_adaptive_level(rows, F, W, n_lvl, False, bf16, dev,
                                          900 + n_lvl, "rows_f")
            errs[f"{tag} N={n_lvl}"] = e
            x, nid, ghw, tables, lo, inv, n_prev, base = inp
            per[tag][n_lvl] = time_cuda(
                lambda: kernels.adaptive_level(x, nid, ghw, tables, lo, inv,
                                               n_prev, n_lvl, base, W, bf16,
                                               "rows_f"), 10)
            if bf16:
                # the wide body at the path's W, where the rule keeps the
                # tensor-core body
                check_forms("adaptive", inp, n_lvl, W, True, ("wide",))
                per["wide_bf16"][n_lvl] = time_cuda(
                    lambda: adaptive_form("wide")(
                        x, nid, ghw, tables, lo, inv, n_prev, n_lvl, base, W,
                        True, "rows_f"), 10)
            _n, ha = kernels.adaptive_level_atomics(
                x, nid, ghw, tables, lo, inv, n_prev, n_lvl, base, W, bf16)
            _n, hp = adaptive_level_plain(x, nid, ghw.double(), tables, lo,
                                          inv, n_prev, n_lvl, base, W, bf16)
            _n, mass = adaptive_level_plain(x, nid, ghw.double().abs(),
                                            tables, lo, inv, n_prev, n_lvl,
                                            base, W, bf16)
            mass_check(f"adaptive_level atomics ablation {tag} N={n_lvl}",
                       ha, hp, mass)
            del ha, hp, mass
            per["atomics_" + tag][n_lvl] = time_cuda(
                lambda: kernels.adaptive_level_atomics(
                    x, nid, ghw, tables, lo, inv, n_prev, n_lvl, base, W,
                    bf16), 10)
            if n_lvl == N and bf16:
                err = e
                pms = time_cuda(lambda: adaptive_level_plain(
                    x, nid, ghw, tables, lo, inv, n_prev, N, base, W, True),
                    3)
                # the grouping pass alone: the level's keys (the parent of
                # a routed row), its G = n_prev + N groups
                lp = nid.long() - (base - n_prev)
                keys = torch.where(tables[3][lp.clamp(0, n_prev - 1)] > 0.5,
                                   lp, -1).to(torch.int32)
                group_ms = time_cuda(lambda: kernels.group_rows(
                    keys, n_prev + N, ghw), 10)
                del keys, lp
                # the library yardstick on the level's adaptive bins
                nid_out = kernels.adaptive_level(x, nid, ghw, tables, lo, inv,
                                                 n_prev, N, base, W, True,
                                                 "rows_f")[0]
                bins = adaptive_bins_plain(x, nid_out, lo, inv, N, base, W)
                lib_ms = index_add_ms(bins, nid_out, bf16_rows(ghw), N, base,
                                      W)
                del nid_out, bins
            del inp, x, nid, ghw
        e, inp = check_adaptive_level(rows, F, W, n_lvl, False, True, dev,
                                      900 + n_lvl, "f_rows")
        x, nid, ghw, tables, lo, inv, n_prev, base = inp
        per["f_rows_bf16"][n_lvl] = time_cuda(
            lambda: kernels.adaptive_level(x, nid, ghw, tables, lo, inv,
                                           n_prev, n_lvl, base, W, True,
                                           "f_rows"), 10)
        del inp, x, nid, ghw
    sums = {k: sum(v.values()) for k, v in per.items()}
    level_ms = {"rows_f": per["bf16"][N], "f_rows": per["f_rows_bf16"][N]}
    print(f"adaptive_level at 10M x 28, W=32, per level N (rows_f: "
          f"node-grouped tensor-core form, and its shared-atomics ablation; "
          f"wide: the wide body forced; f_rows: the tiled body): "
          f"{json.dumps(per)} ms; sum per tree "
          f"{json.dumps(sums)} ms; grouping pass alone at N=32 "
          f"{group_ms!r} ms; index_add_ on the adaptive bins at N=32 "
          f"{lib_ms!r} ms; max abs err vs plain {json.dumps(errs)}",
          flush=True)
    for layout in LAYOUTS:
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
             "ms_tree": sums["bf16"], "ms_tree_f32": sums["f32"],
             "ms_tree_atomics_ablation": sums["atomics_bf16"],
             "ms_tree_wide": sums["wide_bf16"],
             "group_ms": group_ms, "plain_ms": pms, "bound_ms": bound,
             "bound_by": by, "library_ms": lib_ms},
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
    rows), each checked against the plain version and timed in the picked
    (node-grouped) form and with global atomics forced, their sum and its
    share of the loop; at N = 16 the grouping pass alone, the plain
    version's time, the bound and one ``index_add_`` over a precomputed
    flat (node, feature, bin) index of the rows in [0, N)."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.histogram import build_histograms_plain
    builds = [(1, False), (1, True), (2, True), (4, True), (8, True),
              (16, True)]
    forms = ("picked", "global")
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
    group_ms = time_cuda(lambda: kernels.group_rows(seg, N, ghw), 10)
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
          f"warm loop ({loop_s!r} s for {ntrees} trees); N={N}: {ms!r} ms "
          f"(grouping pass alone {group_ms!r} ms), plain {pms!r} ms, "
          f"index_add_ {lib_ms!r} ms, bound {bound!r} ms by {by}",
          flush=True)
    return [{"name": "global_hist", "route": "cuda",
             "source": SRC["global_hist"],
             "replaces": REPLACES["global_hist"],
             "launches": launches["global_hist"], "max_abs_err": err,
             "ms": ms, "ms_tree": sums["picked"],
             "ms_tree_global_atomics": sums["global"], "group_ms": group_ms,
             "plain_ms": pms, "bound_ms": bound, "bound_by": by,
             "library_ms": lib_ms}]


def split_flips(a, b) -> str:
    """How two models' trees differ: split features that differ, and the
    first tree where any does (over the trees both have)."""
    n = min(len(a["feat"]), len(b["feat"]))
    diff = a["feat"][:n] != b["feat"][:n]
    first = int(np.argmax(diff.any(axis=1))) if diff.any() else None
    return f"{int(diff.sum())} of {diff.size} split features differ " \
           f"(first in tree {first})"


def poison_allocator(dev, gib=8):
    """Fill free memory of the caching allocator with NaN and give it back:
    a kernel or torch op that reads memory it never wrote then computes on
    NaN instead of on a previous run's values."""
    import torch
    free = torch.cuda.mem_get_info(dev)[0]
    n = min(gib << 30, free // 2) // 4
    t = torch.empty(n, dtype=torch.float32, device=dev)
    t.fill_(float("nan"))
    torch.cuda.synchronize()
    del t


def tree_diffs(a, b, split_key):
    """Entries of two models' trees that differ, per key: split feature,
    split key, NA direction and leaf value (bit for bit)."""
    out = {}
    for key in ("feat", split_key, "na_left", "value"):
        x, y = np.asarray(a[key]), np.asarray(b[key])
        if key == "value":
            x, y = x.view(np.uint32), y.view(np.uint32)
        out[key] = int((x != y).sum())
    return out


def check_repeats(runs, path, what):
    """Every pair of ``runs`` (models of one path) must agree bit for bit
    in every tree's splits and leaf values."""
    key = PATHS[path]["split_key"]
    pairs = {f"{i}-{j}": tree_diffs(runs[i].trees, runs[j].trees, key)
             for i in range(len(runs)) for j in range(i + 1, len(runs))}
    aucs = [r.training_metrics.auc for r in runs]
    print(f"repeatability {path}, {what}: entries that differ "
          f"{json.dumps(pairs)}, AUC {aucs!r}", flush=True)
    bad = {p: d for p, d in pairs.items() if any(d.values())}
    if bad:
        raise AssertionError(f"{path} {what}: trains differ {bad}")


def phase_repeatability(fr, path, dev):
    """The same train three times at float32 histograms in one process,
    the first right after the allocator is filled with NaN, then twice at
    'auto' (bf16 masses): every float sum on the path comes in a fixed
    order (no float atomics), so every pair must agree bit for bit in
    every tree's splits and leaf values."""
    poison_allocator(dev)
    runs = [train(fr, 20, path, histogram_precision="float32")
            for _ in range(3)]
    check_repeats(runs, path, "float32 x3 (first after NaN-filling the "
                              "allocator)")
    runs = [train(fr, 20, path) for _ in range(2)]
    check_repeats(runs, path, "'auto' (bf16) x2")


def phase_repeatability_i8(fr):
    """The int8 paths (packed and adaptive, at their own and at the wide
    lane widths, H2O3_HIST_I8=1) each trained twice at 'auto' (bf16, every
    level an integer sum): they must agree bit for bit."""
    for path in ("packed_i8", "adaptive_i8", "packed_wide_i8",
                 "adaptive_wide_i8"):
        runs = [train(fr, 20, path) for _ in range(2)]
        check_repeats(runs, path, "H2O3_HIST_I8=1 at 'auto' x2")


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


def sass_atomics(lib_path):
    """The atomic and tensor-core opcodes in each built kernel's SASS
    (``cuobjdump``), e.g. whether a shared-memory float add is native or
    a CAS loop. Returns (the printable summary, {function: {opcode:
    count}})."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "cuobjdump not found: SASS summary not printed", {}
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    lines, by_fn = [], {}
    for fn in sass.split("Function : ")[1:]:
        name = fn.split(chr(10))[0].strip()
        ops = re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED|HMMA|IMMA)\."
                         r"[A-Z0-9_.]+)", fn)
        counts = {op: ops.count(op) for op in sorted(set(ops))}
        by_fn[name] = counts
        lines.append(f"  {name[:80]}: {counts}")
    return "SASS atomics per kernel:\n" + "\n".join(lines), by_fn


def check_sass(by_fn):
    """The SASS of the kernels whose float sums must come in a fixed order:
    every float tensor-core instance of the node-grouped level (mass
    policy FloatMass with kMma, mangled ``9FloatMass`` and ``Lb1E``), the
    adaptive level's (AdaptiveBins) and the packed level's (CodeBins), has
    HMMA and no shared float CAS loop (``ATOMS.CAST.SPIN``); every int8
    instance (``I8Mass``) of both has IMMA and no shared or global atomics
    at all; every float instance of the wide level (``level_wide_kernel``,
    both bin sources, every W), the leaf-totals kernel (with and without a
    route) and global_hist's node-grouped form have no atomics at all;
    every int8 instance of the wide level (``I8Mass``, both bin sources, W
    = 64, 128, 256, one and two terms) has shared integer adds
    (``ATOMS.ADD``) and no other atomic: no CAS loop, no float atomic, no
    global atomic."""
    def mma(counts, op):
        return sum(v for k, v in counts.items() if k.startswith(op))

    def atomics(counts):
        return {k: v for k, v in counts.items()
                if k.startswith(("ATOM", "RED"))}
    per_src = {}
    for src in ("AdaptiveBins", "CodeBins"):
        grouped = {n: c for n, c in by_fn.items()
                   if "level_grouped_kernel" in n and src in n}
        fmma = {n: c for n, c in grouped.items()
                if "9FloatMass" in n and "Lb1E" in n}
        imma = {n: c for n, c in grouped.items() if "6I8Mass" in n}
        if not fmma or not imma:
            raise AssertionError(f"SASS: no float or no int8 tensor-core "
                                 f"{src} instance")
        for name, counts in fmma.items():
            if mma(counts, "HMMA") == 0 or "ATOMS.CAST.SPIN" in counts:
                raise AssertionError(f"SASS of {name}: {counts}")
        for name, counts in imma.items():
            if mma(counts, "IMMA") == 0 or atomics(counts):
                raise AssertionError(f"SASS of {name}: {counts}")
        per_src[src] = {"HMMA": [mma(c, "HMMA") for c in fmma.values()],
                        "IMMA": [mma(c, "IMMA") for c in imma.values()]}
    wide = {n: c for n, c in by_fn.items()
            if "level_wide_kernel" in n and "I8Mass" not in n}
    if len(wide) < 8:
        raise AssertionError(f"SASS: wide level instances missing: "
                             f"{sorted(wide)}")
    wide_atomics = {n: atomics(c) for n, c in wide.items() if atomics(c)}
    if wide_atomics:
        raise AssertionError(f"SASS of the wide level: atomics "
                             f"{wide_atomics}")
    # the int8 wide instances: integer sums in any order, so native shared
    # integer adds (ATOMS.ADD) are allowed; no CAS loop, no float atomic,
    # no global atomic
    wide_i8 = {n: c for n, c in by_fn.items()
               if "level_wide_kernel" in n and "I8Mass" in n}
    if len(wide_i8) < 12:
        raise AssertionError(f"SASS: int8 wide level instances missing: "
                             f"{sorted(wide_i8)}")
    for name, counts in wide_i8.items():
        bad = {k: v for k, v in atomics(counts).items()
               if not k.startswith("ATOMS.ADD")
               or any(t in k for t in ("F32", "F16", "F64", "FTZ", "CAS"))}
        if bad:
            raise AssertionError(f"SASS of {name}: atomics {bad}")
    ordered = {n: c for n, c in by_fn.items()
               if "leaf_totals_kernel" in n
               or "global_hist_grouped_kernel" in n}
    if len(ordered) < 4:
        raise AssertionError(f"SASS: leaf_totals / global_hist grouped "
                             f"instances missing: {sorted(ordered)}")
    for name, counts in ordered.items():
        if counts:
            raise AssertionError(f"SASS of {name}: atomics {counts}")
    print(f"SASS check: tensor-core grouped level instances, HMMA per "
          f"float instance (no ATOMS.CAST.SPIN) and IMMA per int8 instance "
          f"(no atomics) {json.dumps(per_src)}; ATOMS/RED in the "
          f"{len(wide)} wide level instances (level_wide_kernel): "
          f"{sum(sum(atomics(c).values()) for c in wide.values())}; "
          f"shared integer ATOMS.ADD (and no other atomic) in the "
          f"{len(wide_i8)} int8 wide instances: "
          f"{sum(sum(atomics(c).values()) for c in wide_i8.values())}; "
          f"{len(ordered)} leaf_totals / global_hist grouped instances "
          f"without atomics", flush=True)


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
    by_fn = {}
    for so in kernels.library_paths().values():
        text, counts = sass_atomics(so)
        print(text, flush=True)
        by_fn.update(counts)
    if by_fn:
        check_sass(by_fn)

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
    # the wide lane widths (XGBoost's max_bins 256 shapes)
    packed_wide = phase_main_path(card, "packed_wide", fr)
    del packed_wide["frame"]
    adaptive_wide = phase_main_path(card, "adaptive_wide", fr)
    del adaptive_wide["frame"]
    clock.lap("4 packed_wide + adaptive_wide")
    # the wide paths with int8 masses, against their float paths' AUC
    packed_wide_i8 = phase_main_path(card, "packed_wide_i8", fr,
                                     ref_auc=packed_wide["auc"])
    del packed_wide_i8["frame"]
    adaptive_wide_i8 = phase_main_path(card, "adaptive_wide_i8", fr,
                                       ref_auc=adaptive_wide["auc"])
    del adaptive_wide_i8["frame"]
    clock.lap("4 packed_wide_i8 + adaptive_wide_i8")

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
    phase_card_vs_cpu("packed_wide")
    phase_card_vs_cpu("adaptive_wide")
    clock.lap("5 wide card vs cpu")
    for path in ("packed_wide_i8", "adaptive_wide_i8"):
        for terms in (1, 2):
            phase_card_vs_cpu_i8(path, terms)
    clock.lap("5 wide int8 card vs cpu")

    # 6. kernels at the main paths' shapes
    rec = phase_kernel_record(dev, packed["launches"])
    rec += phase_adaptive_record(dev, adaptive["launches"])
    clock.lap("6 packed + adaptive record")
    rec += phase_i8_record(dev, {
        "binned_level_i8": packed_i8["launches"]["binned_level_i8"],
        "adaptive_level_i8": adaptive_i8["launches"]["adaptive_level_i8"]})
    rec += phase_totals_record(dev, {
        "leaf_totals": packed["launches"]["leaf_totals"],
        "segment_totals": packed["launches"]["segment_totals"]})
    clock.lap("6 int8 + totals record")
    wide = phase_wide_record(dev)
    by_name = {r["name"]: r for r in rec}
    by_name["binned_level"]["wide"] = wide["binned"]
    by_name["adaptive_level"]["wide"] = wide["adaptive"]
    for path, res in (("packed", packed), ("adaptive", adaptive),
                      ("packed_wide", packed_wide),
                      ("adaptive_wide", adaptive_wide),
                      ("packed_i8", packed_i8), ("adaptive_i8", adaptive_i8),
                      ("packed_wide_i8", packed_wide_i8),
                      ("adaptive_wide_i8", adaptive_wide_i8)):
        for k in ("level", "route", "totals"):
            kernel = PATHS[path].get(k)
            if kernel:
                by_name[kernel].setdefault("launches_by_path", {})[path] = \
                    res["launches"][kernel]
    clock.lap("6 wide record")

    # 7. where the time goes: a warm, profiled retrain of each main path,
    # after giving back the cached blocks of phase 6's large inputs (the
    # trains then grow the allocator's cache again in their first run)
    gc.collect()
    torch.cuda.empty_cache()
    phase_warm_profile(fr, card, "packed", packed["trees"])
    phase_warm_profile(fr, card, "adaptive", adaptive["trees"])
    clock.lap("7 packed + adaptive profile")
    phase_warm_profile(fr, card, "packed_i8", packed_i8["trees"])
    phase_warm_profile(fr, card, "adaptive_i8", adaptive_i8["trees"])
    clock.lap("7 packed_i8 + adaptive_i8 profile")
    warm_s = phase_warm_profile(fr, card, "global", glob["trees"])
    clock.lap("7 global profile")
    phase_warm_profile(fr, card, "packed_wide", packed_wide["trees"])
    phase_warm_profile(fr, card, "adaptive_wide", adaptive_wide["trees"])
    clock.lap("7 packed_wide + adaptive_wide profile")
    phase_warm_profile(fr, card, "packed_wide_i8", packed_wide_i8["trees"])
    phase_warm_profile(fr, card, "adaptive_wide_i8",
                       adaptive_wide_i8["trees"])
    clock.lap("7 packed_wide_i8 + adaptive_wide_i8 profile")
    for path in ("packed", "adaptive", "global", "packed_wide",
                 "adaptive_wide"):
        phase_repeatability(fr, path, dev)
    phase_repeatability_i8(fr)
    del fr
    clock.lap("7 repeatability")
    rec += phase_global_record(dev, glob["launches"], warm_s, 20)
    clock.lap("6 global record")
    print(f"phase seconds: {json.dumps(clock.laps)}", flush=True)
    print("kernels run: binned_level[W=16,32 x node-grouped, tiled; "
          "W=32,64,128,256 x wide, tiled; W=16 node-grouped: bf16, "
          "float32] binned_route_only "
          "binned_level_i8[W=16,32,64,128,256 x terms=1,2 x node-grouped "
          "(W<=32) or wide (W>=64), tiled, picked] "
          "adaptive_level[rows_f,f_rows x W=16,32,64,128,256; rows_f "
          "node-grouped: bf16, float32, shared-atomics ablation; rows_f x "
          "W=32 x wide, node-grouped, tiled; W=64,128,256 x wide, tiled] "
          "adaptive_route_only[rows_f,f_rows] "
          "adaptive_level_i8[rows_f x W=16,32,64,128,256 x terms=1,2 x "
          "node-grouped (W<=32) or wide (W>=64), tiled, picked; f_rows x "
          "W=16,32,64,128,256 x terms=1,2 x tiled, picked] "
          "leaf_totals[n_prev=0,32 x N=1,64] "
          "segment_totals[N=1,64,512,4096] "
          "global_hist[B1=15 uint8,257,1025 int32; node-grouped, global "
          "atomics] group_rows[alone]; index_add_ beside binned_level "
          "(W=16,32,64,128,256), adaptive_level (W=32,64,128,256), "
          "binned_level_i8 (W=16,64,128,256) and adaptive_level_i8 "
          "(W=32,64,128,256), segment_totals, global_hist", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rec}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
