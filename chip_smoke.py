#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``h2o3_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a
CUDA device and the repository; without either it exits non-zero and
prints no result. It drives the port's GBM paths from ``Frame.from_numpy`` and from a
CSV file through ``import_file``, and the XGBoost estimator (BASELINE
config #2) with a validation frame and early stopping: packed codes
(``histogram_type="quantiles_global"``, kernels binned_level and
binned_route_only), adaptive bins (``packed_codes=False``, H2O's
default ``uniform_adaptive``, kernels adaptive_level and
adaptive_route_only in the [rows, F] and [F, rows] layouts), the
unpacked global sketch (nbins 1024, kernel global_hist), and the packed
and adaptive paths again with int8 fixed-point masses
(``H2O3_HIST_I8=1``, set around those trains only; kernels
binned_level_i8 and adaptive_level_i8), the packed and adaptive paths at
the wide lane widths (``packed_wide``: nbins 254, W = 256 int16 codes,
XGBoost's ``tree_method="hist"`` at max_bins 256; ``adaptive_wide``:
nbins 62 adaptive, W = 64, the bin count of its ``"auto"``, which itself
packs; the wide body of binned_level and adaptive_level), the same two with int8 masses (``packed_wide_i8``,
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
   wide level (level_wide_kernel), the leaf-totals kernel (every form),
   global_hist's node-grouped form and the route
   (adaptive_route_only_kernel, with its loads-only floor), and in every
   int8 instance of the wide level shared integer adds (``ATOMS.ADD``)
   and no other atomic; print ``-Xptxas -v``'s registers, shared memory
   and spills for the leaf-totals and route instances;
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
   {1, 64, 512, 4096}, in both forms (lane columns, matched keys) at
   row counts with rows % 4 in {1, 2, 3} and with every row in one node
   at N in {1, 64}, picked with every row in one node at N = 4096, each
   also five launches with the same bits; the [rows, F] route bit-equal
   at a row count that is not a multiple of 4, at n_prev = 1, at
   n_prev = 2048 and on an unaligned nid, its loads-only floor returning
   nid unchanged;
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
   from a file (after phase 5): CSV -> ``import_file(device="cuda")`` ->
   GBM -> AUC -> predict, the counters set to 0 before each import. The
   HIGGS shape at 1M rows (nine significant digits, so that every
   float32 comes back exactly): every column bit-equal to
   ``Frame.from_numpy`` of the same arrays and the packed train's trees
   and AUC bit-equal to that frame's (6 x 20 binned_level, 20
   binned_route_only, 20 segment_totals). The airlines shape at 10M rows
   (the column layout of the public airline benchmark's train-10m.csv,
   drawn from a seed; enum columns of 12, 31, 7, 22 and 300 levels, NA
   cells in DepTime and UniqueCarrier): types, domain sizes and NA
   counts as drawn; H2O's default bernoulli GBM (depth 6, 20 trees) on
   adaptive bins at W = 256 (6 x 20 adaptive_level, 20
   adaptive_route_only, 0 of any other), AUC above 0.5; two float32
   trains bit for bit; a warm, profiled retrain; card vs CPU on the
   file's first 200k rows (every split equal, |dAUC| <= 1e-4). Each
   file's write and import seconds, MB/s, rows/s, H2D seconds and the
   host's cores are printed; the files are kept in the temporary
   directory, keyed by their parameters;
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
   in each form beside one ``index_add_`` (these, the route's and its
   floor's times are the device's, ``tools.time_ms``); the [rows, F]
   route at 28 and 8 features beside its loads-only floor; binned_level and adaptive_level at the wide
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

8. XGBoost, BASELINE config #2 (``phase_xgboost``): the
   ``H2OXGBoostEstimator`` on the 10M x 28 frame with a 500k-row
   validation frame (another seed; HIGGS's own held-out size), the launch
   counters set to 0 just before each train and read just after.
   ``tree_method="hist"`` at XGBoost's defaults (50 trees, depth 6, eta
   0.3, min_child_weight 1, reg_lambda 1, max_bins 256): nbins 254 at
   W = 256, exactly 6 binned_level, 1 binned_route_only and 1
   segment_totals a tree, finite better-than-chance training and
   validation AUCs, cold and warm loop seconds and rows/s, the
   validation walk's ms a tree (its margins checked against
   ``predict``), the scoring's ms an interval, the AUC's bits equal over
   five calls and on the CPU, the peak device memory.
   ``tree_method="auto"`` (nbins 62 at W = 64) with early stopping on
   the validation AUC (3 rounds, an interval of 5 trees, tolerance
   1e-3, at most 500 trees): it stops at a multiple of 5 with one
   history entry an interval, the stopping rule recomputed here from the
   printed history says stop at the last entry and at no earlier one,
   the launch counts as above at its tree count; trained twice more at
   float32: the tree count, every tree array and every history value bit
   for bit. Card vs CPU at 200k rows (validation 50k), both tree
   methods with early stopping at float32: the same tree count and
   history, every split equal, |dAUC| <= 1e-6 (min_child_weight 10).

9. the probe tools (``phase_probes``; ``h2o3_tpu_torch/tools``, the
   Hopper counterparts of the JAX package's TPU probes P1-P6, their
   kernels in ``tools/csrc/probes.cu``, built in phase 2 beside the
   training path's, whose SASS check also holds every knock-out
   instance to its body's production instance: no fewer shared loads
   but the phase's own (``PHASE_LOADS``), the grouped body's HMMA/IMMA in
   every one but the adds knock-out). At a small size every probe kernel
   against its plain version: P1 (``mxu_probe``, bf16 within 1e-5 x the
   absolute mass, int8 exact), P5 (``gather_probe``, ``onehot_probe``,
   bit-equal, indices outside the table among them), and every
   knock-out (route, ranges, bins, adds, walk, gather) of every probed
   body (the tensor-core grouped body at W = 16 packed and W = 32
   adaptive, the wide body at W = 64 adaptive and W = 256 packed, both
   with float and with int8 masses, and the tiled [F, rows] body) at N =
   2 and 32 with integer masses, bit-equal, its production instance also
   bit-equal to the training path's wrapper, the walk again on float
   masses within the mass tolerance. Then each tool's entry point at the
   JAX tools' sizes with the launch counters set to 0 just before and
   read just after (each must launch its kernels): P1 at M = 6, 24, 96,
   128, 256 (bf16 and int8 at FW 896, bf16 at 448, bf16 chained L = 4),
   eager and as a CUDA graph, beside one torch product; P5 beside
   ``index_select``; P2 as the attribution of every probed body at N = 32
   and N = 2 (10M x 28: each knock-out's ms and share, the grouping pass
   and merge alone, the residual, bound, ``index_add_``); P3 (2.5M rows,
   L = 1, 2, 4, eager against one CUDA graph); P4; P6 (the deepest
   adaptive level in every form). Each tool holds each kernel's first
   output on its timed inputs to the plain version (P1 at every M, P5 at
   2.5M rows, every knock-out at 10M rows: int8 bit for bit, float
   within the mass tolerance) and times the device alone, its reps
   queued back to back (P3's eager chains keep the host's launch time on
   purpose; its shares are of the graph's times).

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
import threading
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
    # the wide lane widths: nbins 254 packed (int16 codes, W = 256, the
    # wide body of binned_level; XGBoost's tree_method="hist" at
    # max_bins=256) and nbins 62 on adaptive bins (W = 64, the wide body
    # of adaptive_level; XGBoost's "auto" takes nbins 62 too, but packs
    # them: phase_xgboost)
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
    # from a CSV file through import_file: the HIGGS shape on the packed
    # path, and the airlines shape (enum columns of about 300 levels, so
    # no packing: adaptive bins at W = 256, the wide adaptive level) with
    # H2O's defaults (nbins 20, min_rows 10)
    "higgs_csv": {"params": dict(nbins=14,
                                 histogram_type="quantiles_global"),
                  "level": "binned_level", "route": "binned_route_only",
                  "totals": "segment_totals", "split_key": "split_bin"},
    "airlines_csv": {"params": dict(min_rows=10.0),
                     "level": "adaptive_level",
                     "route": "adaptive_route_only", "split_key": "thr",
                     "y": "dep_delayed_15min"},
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


def route_bound_ms(rows, F, itemsize, layout="rows_f"):
    """The route reads one code (or raw value), one nid and writes one
    nid per row. In [rows, F] a row's codes are contiguous, so gathering
    one code a row moves the whole 32-byte sector that holds it:
    min(F x itemsize, 32) bytes a row; in [F, rows] a warp's rows read
    one feature's contiguous run, itemsize bytes a row."""
    code = min(F * itemsize, 32) if layout == "rows_f" else itemsize
    return rows * (code + 8) / HBM_BYTES_PER_S * 1e3, "bytes"


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
    bound, by = route_bound_ms(rows, F, 1)
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


def check_route_cases(dev, F=28):
    """K9 (the [rows, F] route) bit-equal to its plain version at a row
    count that is not a multiple of 4, at n_prev = 1, at n_prev = 2048
    and on an nid that is not 16-byte aligned; its loads-only floor
    returns nid unchanged."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import adaptive_route_only_plain
    cases = {"ragged": (1_000_003, 64, False), "n_prev=1": (1_000_000, 2,
                                                            False),
             "n_prev=2048": (1_000_001, 4096, False),
             "unaligned": (1_000_002, 64, True)}
    for seed, (name, (rows, N, shift)) in enumerate(cases.items()):
        x, nid, _g, tables, _lo, _inv, n_prev, base = adaptive_inputs(
            rows, F, 16, N, True, 4400 + seed, dev, "rows_f")
        if shift:       # nid[1:]: a view whose start is 4 bytes past 16
            x, nid = x[1:], nid[1:]
        want = adaptive_route_only_plain(x, nid, tables, n_prev, base,
                                         "rows_f")
        got = kernels.adaptive_route_only(x, nid, tables, n_prev, base,
                                          "rows_f")
        floor = kernels.adaptive_route_floor(x, nid, tables, n_prev, base)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"adaptive_route_only rows_f {name}: nid "
                                 f"differs in {int((got != want).sum())} "
                                 f"rows")
        if not torch.equal(floor, nid):
            raise AssertionError(f"adaptive_route_floor {name}: nid changed")
    print(f"adaptive_route_only rows_f bit-equal at {sorted(cases)}; "
          f"loads-only floor keeps nid", flush=True)


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
              f"(bound {route_bound_ms(rows, F, 4, layout)[0]:.6g} ms); "
              f"NaN/±inf/zero-span case bit-equal", flush=True)
    check_route_cases(dev, F)


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


def segment_inputs(rows, N, seed, dev, one_node=False):
    """nid over the N nodes of a level at base N - 1, 5% of the rows off
    it (``one_node``: every row in node N // 2), float (g, h, w)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    base = N - 1
    if one_node:
        nid = torch.full((rows,), base + N // 2, dtype=torch.int32,
                         device=dev)
    else:
        nid = off_window(base + torch.randint(0, N, (rows,), generator=g,
                                              device=dev), seed)
    ghw = torch.stack([torch.randn(rows, generator=g, device=dev),
                       torch.rand(rows, generator=g, device=dev) * 0.25,
                       torch.ones(rows, device=dev)]).contiguous()
    return nid, ghw, base


def check_segment(rows, N, dev, seed, form="picked", one_node=False):
    """segment_totals (the leaf-totals kernel without a route; its form
    picked or forced) against its plain version: within 1e-4 + 1e-5 x
    each node's absolute mass of the float64 plain version, and five
    launches with the same bits."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.common import segment_totals_plain
    nid, ghw, base = segment_inputs(rows, N, seed, dev, one_node)
    runs = [kernels.segment_totals_form(nid, ghw, N, base, form)
            for _ in range(5)]
    tp = segment_totals_plain(nid, ghw.double(), N, base)
    mass = segment_totals_plain(nid, ghw.double().abs(), N, base)
    torch.cuda.synchronize()
    name = f"segment_totals {form} rows={rows} N={N} one_node={one_node}"
    if not all(torch.equal(runs[0], r) for r in runs[1:]):
        raise AssertionError(f"{name}: five launches differ")
    mass_check(name, runs[0], tp, mass)
    return float((runs[0].double() - tp).abs().max()), (nid, ghw, base)


def phase_totals_kernel(dev, rows=1_000_000, F=28):
    """Phase 3, leaf_totals at n_prev in {0, 32}, N in {1, 64}, and its
    instance without a route, segment_totals, at N in {1, 64, 512,
    4096}; in both forms at row counts that are not a multiple of 4, and
    with every row in one node at N in {1, 64, 4096}."""
    errs = {}
    for n_prev in (0, 32):
        for N in (1, 64):
            errs[f"n_prev={n_prev} N={N}"] = check_totals(
                rows, F, n_prev, N, dev, 1200 + n_prev + N)[0]
    for N in (1, 64, 512, 4096):
        errs[f"segment N={N}"] = check_segment(rows, N, dev, 1250 + N)[0]
    for form in ("lanes", "match"):
        for extra in (1, 2, 3):
            errs[f"segment {form} rows={rows + extra} N=64"] = check_segment(
                rows + extra, 64, dev, 1260 + extra, form)[0]
        for N in (1, 64):
            errs[f"segment {form} N={N} one node"] = check_segment(
                rows + 1, N, dev, 1270 + N, form, one_node=True)[0]
    errs["segment N=4096 one node"] = check_segment(
        rows + 3, 4096, dev, 1280, one_node=True)[0]
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


# ------------------------------------------------------------ CSV files

# the 22 carriers of the public airline on-time data, 2005-2007
CARRIERS = ("AA", "AQ", "AS", "B6", "CO", "DH", "DL", "EV", "F9", "FL", "HA",
            "HP", "MQ", "NW", "OH", "OO", "TZ", "UA", "US", "WN", "XE", "YV")
AIRLINES_NAMES = ("Month", "DayofMonth", "DayOfWeek", "DepTime",
                  "UniqueCarrier", "Origin", "Dest", "Distance",
                  "dep_delayed_15min")


def _table(labels):
    """A column's cell texts as a [k, width] uint8 matrix and lengths."""
    b = [lab.encode() for lab in labels]
    mat = np.zeros((len(b), max(len(x) for x in b)), np.uint8)
    for i, x in enumerate(b):
        mat[i, :len(x)] = np.frombuffer(x, np.uint8)
    return mat, np.array([len(x) for x in b], np.int64)


def _take(table, idx):
    return table[0][idx], table[1][idx]


def _sci9(x):
    """float32 values (finite) as nine-significant-digit e-notation
    cells, ``[-]d.dddddddde±XX``: a [rows, 15] uint8 matrix and lengths.
    Nine significant digits bring every float32 back exactly."""
    a = np.abs(x.astype(np.float64))
    nz = a > 0
    e = np.zeros(len(a), np.int64)
    e[nz] = np.floor(np.log10(a[nz])).astype(np.int64)
    m = np.rint(a / 10.0 ** (e - 8)).astype(np.int64)
    for fix, de in ((m >= 10 ** 9, 1), (nz & (m < 10 ** 8), -1)):
        e[fix] += de                      # log10 landed a decade off
        m[fix] = np.rint(a[fix] / 10.0 ** (e[fix] - 8)).astype(np.int64)
    body = np.empty((len(a), 14), np.uint8)
    for k in range(9):
        body[:, k + (k > 0)] = 48 + (m // 10 ** (8 - k)) % 10
    body[:, 1] = ord(".")
    body[:, 10] = ord("e")
    body[:, 11] = np.where(e < 0, ord("-"), ord("+"))
    body[:, 12] = 48 + np.abs(e) // 10
    body[:, 13] = 48 + np.abs(e) % 10
    neg = np.signbit(x)
    mat = np.zeros((len(a), 15), np.uint8)
    mat[neg, 0] = ord("-")
    mat[neg, 1:] = body[neg]
    mat[~neg, :14] = body[~neg]
    return mat, 14 + neg.astype(np.int64)


def _csv_block(cols) -> bytes:
    """CSV text of one block of rows: ``cols`` holds, per column, a
    [rows, width] uint8 matrix of the cells' bytes and the cells'
    lengths; cells are joined by commas, each row ends in a newline."""
    row_len = sum(ln for _m, ln in cols) + len(cols)
    pos = np.cumsum(row_len) - row_len
    out = np.empty(int(row_len.sum()), np.uint8)
    for j, (mat, ln) in enumerate(cols):
        short = int(ln.min())
        for k in range(mat.shape[1]):
            if k < short:
                out[pos + k] = mat[:, k]
            else:
                m = ln > k
                out[pos[m] + k] = mat[m, k]
        pos += ln
        out[pos] = ord("\n") if j == len(cols) - 1 else ord(",")
        pos += 1
    return out.tobytes()


def _write_csv(path, header, nrow, block_cols, block=1 << 18):
    """Write a CSV file by blocks of rows (``block_cols(lo, hi)`` gives a
    block's cells), to a file of its own first and then into place."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write((",".join(header) + "\n").encode())
        for lo in range(0, nrow, block):
            f.write(_csv_block(block_cols(lo, min(lo + block, nrow))))
    os.replace(tmp, path)


def write_higgs_csv(path, X, y):
    """The HIGGS-shaped arrays as a CSV file: features f0..f{F-1} in
    nine-digit e-notation, the 0/1 label as an integer."""
    F = X.shape[1]
    digits = _table(["0", "1"])
    _write_csv(path, [f"f{i}" for i in range(F)] + ["label"], len(y),
               lambda lo, hi: [_sci9(X[lo:hi, i]) for i in range(F)]
               + [_take(digits, y[lo:hi])])


def airlines_columns(rows, seed=2024):
    """A synthetic table in the column layout of the public airline
    benchmark's train-10m.csv (szilard/benchm-ml), drawn from ``seed``:
    Month, DayofMonth and DayOfWeek as "c-N" strings, DepTime (hhmm) and
    Distance as integers, UniqueCarrier (22 levels), Origin and Dest
    (300 airport codes each, drawn with a skew), the label
    dep_delayed_15min as Y/N, depending on the hour, the month, the
    carrier, the airports and the distance. About 0.2% of DepTime and
    0.1% of UniqueCarrier are NA. Returns the columns as table indices
    (``tables``, ``idx``) and what a parse must find (``expect``)."""
    rng = np.random.default_rng(seed)
    codes = rng.choice(26 ** 3, size=300, replace=False)
    airports = ["".join(chr(65 + (c // 26 ** k) % 26) for k in (2, 1, 0))
                for c in codes]
    p_air = 1.0 / (np.arange(300) + 30.0)
    p_air /= p_air.sum()
    month = rng.integers(0, 12, rows)
    dom = rng.integers(0, 31, rows)
    dow = rng.integers(0, 7, rows)
    hour = np.clip(rng.normal(13.5, 4.5, rows), 0, 23).astype(np.int64)
    dep = hour * 100 + rng.integers(0, 60, rows)
    carrier = rng.integers(0, 22, rows)
    origin = rng.choice(300, size=rows, p=p_air)
    dest = rng.choice(300, size=rows, p=p_air)
    dist = np.clip(rng.lognormal(6.4, 0.6, rows), 30, 4962).astype(np.int64)
    dep_na = rng.random(rows) < 0.002
    car_na = rng.random(rows) < 0.001
    air_eff = rng.normal(0, 0.4, 300)
    car_eff = rng.normal(0, 0.3, 22)
    mon_eff = np.array([0.1, 0, -0.1, -0.2, -0.1, 0.3, 0.35, 0.2, -0.3,
                        -0.2, -0.1, 0.4])
    logit = (-1.7 + 0.1 * (np.where(dep_na, 13, hour) - 12)
             + mon_eff[month] + np.where(car_na, 0, car_eff[carrier])
             + air_eff[origin] + 0.5 * air_eff[dest]
             + 0.1 * (dow >= 4) + 0.05 * np.log(dist / 600))
    label = (rng.random(rows) < 1 / (1 + np.exp(-logit))).astype(np.int64)
    tables = [_table([f"c-{i + 1}" for i in range(12)]),
              _table([f"c-{i + 1}" for i in range(31)]),
              _table([f"c-{i + 1}" for i in range(7)]),
              _table([str(i) for i in range(2400)] + ["NA"]),
              _table(list(CARRIERS) + ["NA"]), _table(airports),
              _table(airports), _table([str(i) for i in range(4963)]),
              _table(["N", "Y"])]
    idx = [month, dom, dow, np.where(dep_na, 2400, dep),
           np.where(car_na, 22, carrier), origin, dest, dist, label]
    expect = {"types": {n: ("int" if n in ("DepTime", "Distance")
                            else "enum") for n in AIRLINES_NAMES},
              "cards": {"Month": len(np.unique(month)),
                        "DayofMonth": len(np.unique(dom)),
                        "DayOfWeek": len(np.unique(dow)),
                        "UniqueCarrier": len(np.unique(carrier[~car_na])),
                        "Origin": len(np.unique(origin)),
                        "Dest": len(np.unique(dest)),
                        "dep_delayed_15min": len(np.unique(label))},
              "na": {n: 0 for n in AIRLINES_NAMES},
              "positives": int(label.sum())}
    expect["na"].update(DepTime=int(dep_na.sum()),
                        UniqueCarrier=int(car_na.sum()))
    return tables, idx, expect


def write_airlines_csv(path, tables, idx):
    _write_csv(path, AIRLINES_NAMES, len(idx[0]),
               lambda lo, hi: [_take(t, i[lo:hi])
                               for t, i in zip(tables, idx)])


def cached_csv(name, write):
    """A CSV file of the temporary directory, keyed by ``name`` (its
    parameters), written by ``write(path)`` unless it is there. Returns
    the path and the seconds the writing took (0 when cached)."""
    import tempfile
    path = os.path.join(tempfile.gettempdir(), f"h2o3_smoke_{name}.csv")
    t0 = time.perf_counter()
    if not os.path.exists(path):
        write(path)
    return path, time.perf_counter() - t0


def csv_prefix(src, dst, rows):
    """The header and the first ``rows`` rows of ``src`` as a file."""
    with open(src, "rb") as f:
        head = f.read(64 * (rows + 1) + (1 << 20))
    nl = np.flatnonzero(np.frombuffer(head, np.uint8) == 10)
    with open(dst, "wb") as f:
        f.write(head[:int(nl[rows]) + 1])


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
    """A GBM of ``path``'s parameters (and ``kw``) on ``path``'s response;
    ``H2O3_HIST_I8`` is ``i8`` or the path's own setting, for this train
    only."""
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    est = H2OGradientBoostingEstimator(
        ntrees=ntrees, max_depth=6, distribution="bernoulli",
        **{"learn_rate": 0.1, "seed": 7, "min_rows": 1.0,
           **PATHS[path]["params"], **kw})
    with hist_i8(i8 if i8 is not None else PATHS[path].get("i8")):
        est.train(y=PATHS[path].get("y", "label"), training_frame=fr)
    return est.model


def phase_main_path(card, path, fr=None, rows=10_000_000, ntrees=20,
                    depth=6, ref_auc=None, reset=True):
    """One GBM path at full width, launch counters set to 0 just before
    and read just after (``reset=False``: the caller set them to 0 before
    it made the frame); the frame is made here unless given. With
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
    if reset:
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
    p1 = pred.vec(pred.names[-1]).to_numpy()   # the positive class
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
          f"training_loop_seconds {loop_s!r} rows/s {rps!r} n_bins "
          f"{model.n_bins} packed_codes "
          f"{json.dumps(model.output['packed_codes'])} train_profile "
          f"{json.dumps(model.output['train_profile'])} launches "
          f"{launches} peak device memory in the train "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB [{card}]",
          flush=True)
    return {"auc": auc, "loop_s": loop_s, "rows_per_s": rps,
            "launches": launches, "frame": fr, "trees": model.trees,
            "n_bins": model.n_bins}


def phase_card_vs_cpu(path, rows=200_000, ntrees=5, **kw):
    """A float path on the card and on the CPU at float32 histograms:
    every tree's splits (feature, split bin or threshold, NA side) must
    be equal, and |dAUC| <= 1e-4."""
    X, y, _F = higgs_arrays(rows, seed=11)
    card_vs_cpu(path, lambda dev: frame_of(X, y, dev), rows, ntrees, **kw)


def card_vs_cpu(path, frame, rows, ntrees, **kw):
    """``path`` trained at float32 histograms on ``frame("cuda")`` and on
    ``frame("cpu")``: every tree's splits must be equal, and |dAUC| <=
    1e-4."""
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = train(frame(dev), ntrees, path,
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


def frames_differ(a, b):
    """The columns of two frames that differ in name, type, domain or any
    bit of their device values (NaN payloads included)."""
    import torch
    if a.names != b.names:
        return [f"names {a.names} vs {b.names}"]
    out = []
    for n in a.names:
        va, vb = a.vec(n), b.vec(n)
        if not (va.type == vb.type and va.domain == vb.domain
                and va.data.dtype == vb.data.dtype
                and torch.equal(va.data.view(torch.int32),
                                vb.data.view(torch.int32))):
            out.append(f"{n} ({va.type} vs {vb.type})")
    return out


def timed_import(name, path, rows, write_s, card):
    """``import_file(path, device="cuda")``, timed, with the parse's
    profile printed: write and parse seconds, MB/s, rows/s, the
    host-to-device seconds and the host's core count."""
    import torch
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.ingest import parse as parse_mod
    t0 = time.perf_counter()
    fr = h2o.import_file(path, device="cuda")
    torch.cuda.synchronize()
    parse_s = time.perf_counter() - t0
    prof = dict(parse_mod.LAST_PROFILE)
    mb = os.path.getsize(path) / 1e6
    if fr.nrow != rows or prof["fallback_ranges"]:
        raise AssertionError(f"csv {name}: {fr.nrow} rows (want {rows}), "
                             f"profile {prof}")
    print(f"csv {name}: {rows} rows, {fr.ncol} columns, {mb!r} MB; write "
          f"{write_s!r} s (0: cached); import_file {parse_s!r} s = "
          f"{mb / parse_s!r} MB/s, {rows / parse_s!r} rows/s, of it H2D "
          f"{prof['device_put_s']!r} s; {prof['chunks']} ranges on "
          f"{prof['workers']} threads, host cores {os.cpu_count()}; "
          f"profile {json.dumps(prof)} [{card}]", flush=True)
    return fr


@contextlib.contextmanager
def recorded_adaptive_calls(calls):
    """The adaptive grower's level and deepest-route calls, passed on and
    recorded into ``calls`` as (name, args) with every tensor but the
    feature matrix copied (the grower replaces nid and the tables level
    by level)."""
    import torch
    from h2o3_tpu_torch.models import tree
    names = ("adaptive_level", "adaptive_route_only")
    orig = {n: getattr(tree, n) for n in names}

    def recorder(name):
        def call(x, *a):
            calls.append((name, (x,) + tuple(
                t.clone() if torch.is_tensor(t) else t for t in a)))
            return orig[name](x, *a)
        return call
    for n in names:
        setattr(tree, n, recorder(n))
    try:
        yield calls
    finally:
        for n in names:
            setattr(tree, n, orig[n])


def check_train_levels(fr, path, card, flush):
    """K8 and K9 at the inputs a train of ``path`` on ``fr`` hands them:
    one tree trained with its calls recorded, then every level's
    adaptive_level (the form the training path picks, which must be the
    wide body) against adaptive_level_plain on the recorded inputs within
    the float tolerance (check_forms), and the deepest route against
    adaptive_route_only_plain bit for bit; each timed beside its plain
    version. Returns the kernels' ms for the tree."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.hist_adaptive import (adaptive_level_plain,
                                                  adaptive_route_only_plain)
    calls = []
    with recorded_adaptive_calls(calls):
        train(fr, 1, path)
    tree_ms = 0.0
    for name, a in calls:
        if name == "adaptive_level":
            (x, nid, ghw, tables, lo, inv, n_prev, N, base, W, bf16,
             layout, _qs) = a
            rows, F = x.shape
            pick = kernels.adaptive_level_picks(rows, F, W, n_prev, N,
                                                layout)
            if layout != "rows_f" or pick != "wide":
                raise AssertionError(f"{path}: level N={N} W={W} in "
                                     f"{layout} takes the {pick} form, "
                                     f"not the wide body in [rows, F]")
            inp = (x, nid, ghw, tables, lo, inv, n_prev, base)
            err = check_forms("adaptive", inp, N, W, bf16,
                              ("picked",))["picked"]
            ms = time_cuda(lambda: kernels.adaptive_level(
                x, nid, ghw, tables, lo, inv, n_prev, N, base, W, bf16,
                layout), 5, flush)
            pms = time_cuda(lambda: adaptive_level_plain(
                x, nid, ghw, tables, lo, inv, n_prev, N, base, W, bf16,
                layout), 3, flush)
            what = (f"adaptive_level {pick} W={W} N={N} bf16={bf16} "
                    f"max_abs_err {err!r}")
        else:
            x, nid, tables, n_prev, base, layout = a
            rk = kernels.adaptive_route_only(x, nid, tables, n_prev, base,
                                             layout)
            rp = adaptive_route_only_plain(x, nid, tables, n_prev, base,
                                           layout)
            if not torch.equal(rk, rp):
                raise AssertionError(f"{path}: adaptive_route_only differs "
                                     f"from its plain version in "
                                     f"{int((rk != rp).sum())} rows")
            del rk, rp
            ms = time_cuda(lambda: kernels.adaptive_route_only(
                x, nid, tables, n_prev, base, layout), 5, flush)
            pms = time_cuda(lambda: adaptive_route_only_plain(
                x, nid, tables, n_prev, base, layout), 3, flush)
            what = f"adaptive_route_only n_prev={n_prev} bit-equal"
        tree_ms += ms
        print(f"{path} train inputs [{x.shape[0]}, {x.shape[1]}]: {what}; "
              f"ms {ms!r} plain_ms {pms!r} [{card}]", flush=True)
    if [n for n, _a in calls].count("adaptive_level") != 6 \
            or calls[-1][0] != "adaptive_route_only":
        raise AssertionError(f"{path}: a tree made the calls "
                             f"{[n for n, _a in calls]}")
    print(f"{path}: the tree's 6 levels and route against their plain "
          f"versions on its own inputs; kernels {tree_ms!r} ms a tree "
          f"[{card}]", flush=True)
    return tree_ms


def phase_csv(card, higgs_rows=1_000_000, air_rows=10_000_000,
              cpu_rows=200_000):
    """The main path from a file: CSV -> ``import_file(device="cuda")``
    -> GBM -> AUC -> predict, the launch counters set to 0 before each
    import and read after its predict. The HIGGS shape at ``higgs_rows``
    (the 10M-row train already runs from ``from_numpy``): every column
    bit-equal to ``Frame.from_numpy`` of the same arrays, and the packed
    GBM's trees and AUC bit-equal to the same train from that frame. The
    airlines shape at ``air_rows``: types, domain sizes and NA counts as
    drawn, the default bernoulli GBM (depth 6, 20 trees) on adaptive bins
    at W = 256 (254 bins) with its launch counts, K8's wide body and K9
    held against their plain versions on a tree's own inputs
    (check_train_levels), two float32 trains bit for bit,
    its warm loop and profile, and card vs CPU on the file's first
    ``cpu_rows`` rows. Returns each path's launches, the airlines warm
    loop's seconds and its kernels' ms a tree."""
    import h2o3_tpu_torch as h2o
    from h2o3_tpu_torch.ops import kernels
    t_phase = time.perf_counter()
    X, y, F = higgs_arrays(higgs_rows)
    path, write_s = cached_csv(f"higgs_{higgs_rows}_42",
                               lambda p: write_higgs_csv(p, X, y))
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    fr = timed_import("higgs", path, higgs_rows, write_s, card)
    higgs = phase_main_path(card, "higgs_csv", fr, rows=higgs_rows,
                            reset=False)
    cols = {f"f{i}": X[:, i] for i in range(F)}
    cols["label"] = y
    ref_fr = h2o.Frame.from_numpy(cols, device="cuda")
    diffs = frames_differ(fr, ref_fr)
    ref = train(ref_fr, 20, "higgs_csv")
    trees = tree_diffs(higgs["trees"], ref.trees, "split_bin")
    print(f"csv higgs against from_numpy: columns that differ {diffs}; "
          f"tree entries that differ {json.dumps(trees)}; AUC "
          f"{higgs['auc']!r} vs {ref.training_metrics.auc!r}", flush=True)
    if diffs or any(trees.values()) or higgs["auc"] !=             ref.training_metrics.auc:
        raise AssertionError("csv higgs: the CSV frame or its train differs "
                             "from the from_numpy one")
    del fr, ref_fr, ref, cols, X, y, higgs["frame"]
    tables, idx, expect = airlines_columns(air_rows)
    path, write_s = cached_csv(
        f"airlines_{air_rows}_2024",
        lambda p: write_airlines_csv(p, tables, idx))
    del tables, idx
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    fr = timed_import("airlines", path, air_rows, write_s, card)
    got = {"types": fr.types,
           "cards": {n: fr.vec(n).cardinality for n in expect["cards"]},
           "na": {n: fr.vec(n).na_count() for n in fr.names},
           "positives": int((fr.vec("dep_delayed_15min").data == 1).sum())}
    if any(got[k] != expect[k] for k in expect):
        raise AssertionError(f"csv airlines: parsed {got}, drawn {expect}")
    air = phase_main_path(card, "airlines_csv", fr, rows=air_rows,
                          reset=False)
    if air["n_bins"] != 254:
        raise AssertionError(f"airlines_csv: n_bins {air['n_bins']}, not "
                             f"the 254 identity bins of the enum columns "
                             f"(W = 256)")
    level_ms = check_train_levels(fr, "airlines_csv", card,
                                  torch_flush("cuda"))
    runs = [train(fr, 20, "airlines_csv", histogram_precision="float32")
            for _ in range(2)]
    check_repeats(runs, "airlines_csv", "float32 x2")
    del runs
    warm_s = phase_warm_profile(fr, card, "airlines_csv", air["trees"])
    del fr, air["frame"]
    small = path[:-len(".csv")] + f"_head{cpu_rows}.csv"
    csv_prefix(path, small, cpu_rows)
    card_vs_cpu("airlines_csv",
                lambda dev: h2o.import_file(small, device=dev), cpu_rows, 5)
    print(f"csv phase: {time.perf_counter() - t_phase!r} s wall, parsed "
          f"{json.dumps(got['cards'])} levels, NA {json.dumps(got['na'])}",
          flush=True)
    return {"higgs_csv": higgs["launches"], "airlines_csv": air["launches"],
            "airlines_warm_s": warm_s, "airlines_kernel_ms_tree": level_ms}


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
    rows, N = 64): time in each form, plain version's time, one
    ``index_add_`` over the rows' node index (library_ms), bound (nid and
    ghw read once). The kernels' and the library call's times are the
    device's (``tools.time_ms``; ``ms_with_host`` beside segment_totals'
    is one call between two events, the wrapper's host time included)."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.ops.common import segment_totals_plain
    from h2o3_tpu_torch.ops.hist_adaptive import leaf_totals_plain
    from h2o3_tpu_torch import tools
    err, (x, nid, ghw, tables, base) = check_totals(rows, F, n_prev, N, dev,
                                                   1500)
    ms = tools.time_ms(lambda: kernels.leaf_totals(x, nid, ghw, tables,
                                                   n_prev, N, base), dev, 20)
    pms = time_cuda(lambda: leaf_totals_plain(x, nid, ghw, tables, n_prev, N,
                                              base), 3)
    del x
    nbytes = rows * (4 + 4 + 12 + 4)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, 3 * rows / F32_OPS_PER_S
    bound, by = max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")
    print(f"leaf_totals at 10M x 28, n_prev={n_prev} N={N}, device: {ms!r} "
          f"ms, plain "
          f"{pms!r} ms, bound {bound!r} ms by {by}, max abs err {err!r}",
          flush=True)
    rec = [{"name": "leaf_totals", "route": "cuda",
            "source": SRC["leaf_totals"], "replaces": REPLACES["leaf_totals"],
            "launches": launches["leaf_totals"], "max_abs_err": err,
            "ms": ms, "plain_ms": pms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}]
    serr, (nid, ghw, base) = check_segment(rows, N, dev, 1501)
    sms = tools.time_ms(lambda: kernels.segment_totals(nid, ghw, N, base),
                        dev, 20)
    host_ms = time_cuda(lambda: kernels.segment_totals(nid, ghw, N, base), 20)
    # each form forced on the same inputs (the picked one among them)
    form_ms = {}
    for form in ("lanes", "match"):
        check_segment(rows, N, dev, 1501, form)
        form_ms[form] = tools.time_ms(lambda: kernels.segment_totals_form(
            nid, ghw, N, base, form), dev, 20)
    spms = time_cuda(lambda: segment_totals_plain(nid, ghw, N, base), 3)
    lid = nid.long() - base
    live = (lid >= 0) & (lid < N)
    idx = torch.where(live, lid, 0)
    vals = (ghw * live).t().contiguous()
    out = torch.zeros((N, 3), device=dev)
    lib_ms = tools.time_ms(lambda: out.index_add_(0, idx, vals), dev, 20)
    del lid, live, idx, vals, out
    t_b, t_o = rows * (4 + 12) / HBM_BYTES_PER_S, 3 * rows / F32_OPS_PER_S
    sbound, sby = max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o
                                        else "operations")
    print(f"segment_totals at 10M rows, N={N}, device: {sms!r} ms (forms "
          f"{json.dumps(form_ms)} ms; with the host {host_ms!r} ms), plain "
          f"{spms!r} ms, index_add_ {lib_ms!r} ms, bound {sbound!r} ms by "
          f"{sby}, max abs err {serr!r}; five launches bit-equal",
          flush=True)
    rec.append({"name": "segment_totals", "route": "cuda",
                "source": SRC["segment_totals"],
                "replaces": REPLACES["segment_totals"],
                "launches": launches["segment_totals"], "max_abs_err": serr,
                "ms": sms, "ms_by_form": form_ms, "ms_with_host": host_ms,
                "plain_ms": spms,
                "bound_ms": sbound, "bound_by": sby, "library_ms": lib_ms})
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
    bound, by = route_bound_ms(rows, F, 1)
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
    The route at N = 64 in both layouts (device time, ``tools.time_ms``),
    and in [rows, F] at 28 and 8 features beside its loads-only floor
    (``route_rows_record``)."""
    import torch
    from h2o3_tpu_torch import tools
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
        route_ms[layout] = tools.time_ms(lambda: kernels.adaptive_route_only(
            x, nid, tables, n_prev, base, layout), dev, 20)
        if layout == ADAPTIVE_LAYOUT:
            rpms = time_cuda(lambda: adaptive_route_only_plain(
                x, nid, tables, n_prev, base, layout), 3)
        del x, nid
    print(f"adaptive layouts at 10M x 28 (training path: {ADAPTIVE_LAYOUT}):"
          f" level N=32 {json.dumps(level_ms)} ms, route N=64 "
          f"{json.dumps(route_ms)} ms", flush=True)
    route_rows = route_rows_record(dev, rows, (F, 8), 2 * N)
    bound, by = adaptive_level_bound_ms(rows, F, N, W, rows)
    rbound, rby = route_bound_ms(rows, F, 4, ADAPTIVE_LAYOUT)
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
             "rows_f_by_F": route_rows,
             "plain_ms": rpms, "bound_ms": rbound, "bound_by": rby,
             "library_ms": None}]


def route_rows_record(dev, rows, widths, N):
    """K9 (the [rows, F] route) at each F of ``widths`` beside its
    loads-only floor (the same nid, table and x loads and nid stores, no
    compare), both checked on the timed inputs, and the bound; device
    times (``tools.time_ms``: the calls queued behind a device-side wait,
    the wrapper's host time out of the window)."""
    import torch
    from h2o3_tpu_torch import tools
    from h2o3_tpu_torch.ops import kernels
    out = {}
    for F in widths:
        x, nid, tables, n_prev, base = check_adaptive_route(
            rows, F, N, dev, 4321 + F, "rows_f")
        if not torch.equal(kernels.adaptive_route_floor(x, nid, tables,
                                                        n_prev, base), nid):
            raise AssertionError(f"adaptive_route_floor at {rows}x{F}: "
                                 f"nid changed")
        r = {"ms": tools.time_ms(lambda: kernels.adaptive_route_only(
                 x, nid, tables, n_prev, base, "rows_f"), dev, 20),
             "floor_ms": tools.time_ms(lambda: kernels.adaptive_route_floor(
                 x, nid, tables, n_prev, base), dev, 20),
             "ms_with_host": time_cuda(lambda: kernels.adaptive_route_only(
                 x, nid, tables, n_prev, base, "rows_f"), 20),
             "bound_ms": route_bound_ms(rows, F, 4)[0]}
        out[str(F)] = r
        del x, nid
        print(f"adaptive_route_only rows_f at {rows}x{F}, n_prev={n_prev}, "
              f"device: {r['ms']!r} ms, loads-only floor {r['floor_ms']!r} "
              f"ms; with the host {r['ms_with_host']!r} ms; bound "
              f"{r['bound_ms']!r} ms", flush=True)
    return out


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


# ------------------------------------------------------------- XGBoost

# BASELINE config #2: H2OXGBoost on HIGGS-10M at XGBoost's defaults (50
# trees, depth 6, eta 0.3, min_child_weight 1, reg_lambda 1, max_bins
# 256), tree_method "hist" (packed quantile codes, nbins 254, W = 256)
# and "auto" (packed uniform edges, nbins 62, W = 64), with a validation
# frame of HIGGS's own held-out size (UCI keeps the last 500k rows)
XGB_VALID_ROWS = 500_000
XGB_PATHS = {"hist": (254, 256), "auto": (62, 64)}
# train B: early stopping on the validation AUC at H2O's tolerance
XGB_STOP = dict(ntrees=500, stopping_rounds=3, score_tree_interval=5,
                stopping_metric="AUC")


def xgb_train(fr, vfr, **kw):
    """The XGBoost estimator (bernoulli, seed 7) on ``fr`` with ``vfr``
    as its validation frame."""
    from h2o3_tpu_torch.estimators import H2OXGBoostEstimator
    est = H2OXGBoostEstimator(distribution="bernoulli", seed=7, **kw)
    est.train(y="label", training_frame=fr, validation_frame=vfr)
    return est.model


def xgb_check_launches(launches, built, what):
    """A packed XGBoost train launches six binned_level, one
    binned_route_only and one segment_totals a tree, and nothing else."""
    expected = {k: 0 for k in launches}
    expected.update(binned_level=6 * built, binned_route_only=built,
                    segment_totals=built)
    if launches != expected:
        raise AssertionError(f"{what}: launched {launches}, expected "
                             f"{expected} for {built} trees")


def xgb_check_model(m, tree_method, what):
    """The path the tree method takes, and finite better-than-chance
    training and validation AUCs."""
    n_bins, W = XGB_PATHS[tree_method]
    pc = m.output["packed_codes"]
    if m.n_bins != n_bins or not pc["enabled"] or pc["W"] != W:
        raise AssertionError(f"{what}: n_bins {m.n_bins}, packed_codes "
                             f"{pc}; expected n_bins {n_bins} at W {W}")
    for name, mm in (("training", m.training_metrics),
                     ("validation", m.validation_metrics)):
        if not np.isfinite(mm.auc) or not 0.5 < mm.auc <= 1.0:
            raise AssertionError(f"{what}: {name} AUC {mm.auc} is not a "
                                 f"finite better-than-chance value")


def stop_decisions(scores, rounds, tol, less_is_better):
    """H2O's stopping rule, recomputed here from a scoring history: after
    each entry, whether the mean of the last ``rounds`` scores fails to
    beat the mean of the ``rounds`` before them by ``tol`` relative."""
    out = []
    for i in range(1, len(scores) + 1):
        if i < 2 * rounds:
            out.append(False)
            continue
        recent = float(np.mean(scores[i - rounds:i]))
        prev = float(np.mean(scores[i - 2 * rounds:i - rounds]))
        margin = tol * abs(prev)
        out.append(recent >= prev - margin if less_is_better
                   else recent <= prev + margin)
    return out


def xgb_walk_and_score_ms(m, fr, vfr):
    """On train A's model: the validation walk of one tree over the
    validation rows (packed codes, six gathers) plus its margin update,
    in ms a tree, checked against ``predict`` over all trees; and one
    interval's scoring (deviance and AUC on the device, one copy to the
    host) in ms."""
    import torch
    from types import SimpleNamespace
    from h2o3_tpu_torch.models.distributions import Bernoulli
    from h2o3_tpu_torch.models.gbm import score_entry, valid_walk
    from h2o3_tpu_torch.models.metrics import auc_device
    from h2o3_tpu_torch.models.model_base import (build_training_spec,
                                                  build_validation_spec)
    from h2o3_tpu_torch.ops.hist_adaptive import pick_W
    spec = build_training_spec(fr, "label", classification=True)
    vspec = build_validation_spec(vfr, spec)
    walk = valid_walk(vspec.X, SimpleNamespace(edges=m.edges,
                                               n_bins=m.n_bins),
                      SimpleNamespace(W=pick_W(m.n_bins)), m.max_depth)
    trees = [{k: torch.as_tensor(m.trees[k][t], device=vfr.device)
              for k in ("feat", "split_bin", "na_left", "is_split",
                        "value")} for t in range(m.ntrees_built)]
    vm = torch.full((vfr.nrow,), float(m.f0), device=vfr.device)
    for t in trees:
        vm = vm + walk(t)
    p1 = m.predict(vfr).vec("p1").data
    err = float((torch.sigmoid(vm) - p1).abs().max())
    if not err <= 1e-5:
        raise AssertionError(f"validation walk: p1 {err} from predict's")
    walk_ms = time_cuda(lambda: vm + walk(trees[-1]), 20)
    dist = Bernoulli()
    score_ms = time_cuda(lambda: score_entry(vm, vspec, dist, 5,
                                             want_auc=True), 20)
    # the AUC that decides early stopping: the same bits in five calls on
    # the card, and on the CPU
    args = (dist.predict(vm), vspec.y.to(torch.float32), vspec.w)
    bits = {auc_device(*args).view(torch.int32).item() for _ in range(5)}
    cpu = auc_device(*(t.cpu() for t in args)).view(torch.int32).item()
    if bits != {cpu}:
        raise AssertionError(f"auc_device bits: card {bits}, cpu {cpu}")
    return walk_ms, score_ms, err


def phase_xgboost(card, fr, cpu_rows=200_000, cpu_valid_rows=50_000):
    """BASELINE config #2 on the card: the XGBoost estimator on the 10M x
    28 HIGGS-shaped frame ``fr`` with a 500k-row validation frame (another
    seed), the launch counters set to 0 just before each train and read
    just after. Train A: tree_method "hist" at XGBoost's defaults: n_bins
    254 at W = 256, 6 binned_level, 1 binned_route_only and 1
    segment_totals a tree and nothing else, finite better-than-chance
    training and validation AUCs; again twice warm (loop seconds,
    rows/s); the validation walk's ms a tree (checked against predict)
    and the scoring's ms an interval. Train B: tree_method "auto" (n_bins
    62 at W = 64) with early stopping on the validation AUC
    (``XGB_STOP``): it stops, at a multiple of 5 trees, with one history
    entry an interval, where the stopping rule recomputed here from the
    printed history says stop at the last entry and at no earlier one;
    its launches as A's at its tree count. B twice more at float32
    histograms: tree counts, every tree array and every history value bit
    for bit. Card vs CPU at ``cpu_rows`` (validation ``cpu_valid_rows``),
    both tree methods with early stopping at float32 and
    min_child_weight 10: the same tree count, every split equal, the same
    history, |dAUC| <= 1e-6."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    rows = fr.nrow
    Xv, yv, _F = higgs_arrays(XGB_VALID_ROWS, seed=43)
    vfr = frame_of(Xv, yv, "cuda")
    out = {}

    # train A: tree_method="hist" at the defaults
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    a = xgb_train(fr, vfr, tree_method="hist")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    xgb_check_launches(launches, a.ntrees_built, "xgboost hist")
    xgb_check_model(a, "hist", "xgboost hist")
    if a.ntrees_built != 50:
        raise AssertionError(f"xgboost hist built {a.ntrees_built} trees")
    out["hist"] = launches
    loops = [a.output["training_loop_seconds"]]
    for _ in range(2):
        loops.append(xgb_train(fr, vfr, tree_method="hist").output[
            "training_loop_seconds"])
    warm = float(np.median(loops[1:]))
    walk_ms, score_ms, walk_err = xgb_walk_and_score_ms(a, fr, vfr)
    print(f"xgboost hist: {rows}x{fr.ncol - 1} train, {vfr.nrow} "
          f"validation rows, 50 trees depth 6 eta 0.3 min_child_weight 1 "
          f"reg_lambda 1 max_bins 256: n_bins {a.n_bins} packed_codes "
          f"{json.dumps(a.output['packed_codes'])} launches {launches}; "
          f"training AUC {a.training_metrics.auc!r} validation AUC "
          f"{a.validation_metrics.auc!r} logloss "
          f"{a.validation_metrics.logloss!r}; training_loop_seconds cold "
          f"{loops[0]!r} warm {loops[1:]!r} median {warm!r} (rows/s "
          f"{rows * a.ntrees_built / warm!r}); train_profile "
          f"{json.dumps(a.output['train_profile'])}; validation walk "
          f"{walk_ms!r} ms a tree (p1 within {walk_err!r} of predict's); "
          f"scoring {score_ms!r} ms an interval (deviance + AUC over "
          f"{vfr.nrow} rows, one copy to the host; the AUC's bits equal in "
          f"five calls and on the CPU); peak device memory "
          f"{peak:.3f} GiB [{card}]", flush=True)
    del a

    # train B: tree_method="auto" with early stopping on the AUC
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    b = xgb_train(fr, vfr, tree_method="auto", **XGB_STOP)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    built = b.ntrees_built
    hist = json.loads(json.dumps(b.scoring_history))
    tol = b.params["stopping_tolerance"]
    rounds = XGB_STOP["stopping_rounds"]
    step = XGB_STOP["score_tree_interval"]
    print(f"xgboost auto, early stopping {json.dumps(XGB_STOP)} at "
          f"stopping_tolerance {tol!r}: {built} trees of "
          f"{XGB_STOP['ntrees']}; training_loop_seconds "
          f"{b.output['training_loop_seconds']!r} (rows/s "
          f"{rows * built / b.output['training_loop_seconds']!r}); "
          f"train_profile {json.dumps(b.output['train_profile'])}; "
          f"validation AUC {b.validation_metrics.auc!r}; launches "
          f"{launches}; scoring history {json.dumps(hist)} [{card}]",
          flush=True)
    xgb_check_launches(launches, built, "xgboost auto")
    xgb_check_model(b, "auto", "xgboost auto")
    if not (built < XGB_STOP["ntrees"] and built % step == 0
            and [e["ntrees"] for e in hist]
            == list(range(step, built + 1, step))):
        raise AssertionError(f"xgboost auto: {built} trees, history at "
                             f"{[e['ntrees'] for e in hist]}")
    rule = stop_decisions([e["auc"] for e in hist], rounds, tol, False)
    if rule != [False] * (len(hist) - 1) + [True]:
        raise AssertionError(f"xgboost auto: the stopping rule on the "
                             f"history says {rule}")
    out["auto"] = launches

    # B again twice at float32: bit for bit
    runs = [xgb_train(fr, vfr, tree_method="auto",
                      histogram_precision="float32", **XGB_STOP)
            for _ in range(2)]
    h0, h1 = runs[0].scoring_history, runs[1].scoring_history
    diffs = tree_diffs(runs[0].trees, runs[1].trees, "split_bin") \
        if runs[0].ntrees_built == runs[1].ntrees_built else "tree counts"
    same_hist = json.dumps(h0) == json.dumps(h1)
    print(f"repeatability xgboost auto with early stopping, float32 x2: "
          f"{runs[0].ntrees_built} and {runs[1].ntrees_built} trees, "
          f"entries that differ {diffs}, histories "
          f"{'equal' if same_hist else 'differ'}, validation AUC "
          f"{runs[0].validation_metrics.auc!r} "
          f"{runs[1].validation_metrics.auc!r}", flush=True)
    if isinstance(diffs, str) or any(diffs.values()) or not same_hist \
            or any(not np.array_equal(runs[0].trees[k], runs[1].trees[k])
                   for k in runs[0].trees):
        raise AssertionError("xgboost auto: float32 trains differ")
    del b, runs

    # card vs CPU at 200k rows, both tree methods, early stopping
    X, y, _F = higgs_arrays(cpu_rows, seed=11)
    Xv, yv, _F = higgs_arrays(cpu_valid_rows, seed=12)
    # min_child_weight 10, as the parity tests' min_rows: at XGBoost's 1
    # the card and the CPU took other splits from tree 11 of 30 on (|dAUC|
    # 2.3e-6), a float32 near-tie decided by each device's order of adds
    stop = dict(ntrees=60, stopping_rounds=2, score_tree_interval=3,
                stopping_metric="AUC", stopping_tolerance=3e-3,
                min_child_weight=10.0, histogram_precision="float32")
    for tree_method in ("hist", "auto"):
        ms = {dev: xgb_train(frame_of(X, y, dev), frame_of(Xv, yv, dev),
                             tree_method=tree_method, **stop)
              for dev in ("cuda", "cpu")}
        mc, mh = ms["cuda"], ms["cpu"]
        keys = ("feat", "split_bin", "na_left")
        same = (mc.ntrees_built == mh.ntrees_built
                and all(np.array_equal(mc.trees[k], mh.trees[k])
                        for k in keys))
        hc, hh = mc.scoring_history, mh.scoring_history
        d_hist = max((abs(a["auc"] - b["auc"]) for a, b in zip(hc, hh)),
                     default=0.0)
        d_auc = max(abs(mc.training_metrics.auc - mh.training_metrics.auc),
                    abs(mc.validation_metrics.auc
                        - mh.validation_metrics.auc))
        print(f"card vs cpu, xgboost {tree_method} {json.dumps(stop)}: "
              f"{cpu_rows} rows, validation {cpu_valid_rows}: trees cuda "
              f"{mc.ntrees_built} cpu {mh.ntrees_built}, splits "
              f"{'equal' if same else 'differ'} "
              f"({split_flips(mc.trees, mh.trees)}), |dAUC| training / "
              f"validation max {d_auc!r}, history |dAUC| max {d_hist!r}, "
              f"validation AUC cuda {mc.validation_metrics.auc!r} cpu "
              f"{mh.validation_metrics.auc!r}", flush=True)
        if not same or d_auc > 1e-6 or d_hist > 1e-6 \
                or [e["ntrees"] for e in hc] != [e["ntrees"] for e in hh]:
            n = min(mc.ntrees_built, mh.ntrees_built)
            diff = np.argwhere(mc.trees["feat"][:n] != mh.trees["feat"][:n])
            at = ("" if not len(diff) else
                  f"; first differing split: tree {diff[0][0]} node "
                  f"{diff[0][1]}, node weight cuda "
                  f"{mc.trees['node_w'][tuple(diff[0])]!r} cpu "
                  f"{mh.trees['node_w'][tuple(diff[0])]!r}")
            raise AssertionError(f"xgboost {tree_method}: card and cpu "
                                 f"differ{at}")
        if mc.ntrees_built >= stop["ntrees"]:
            raise AssertionError(f"xgboost {tree_method}: no early stop "
                                 f"at {cpu_rows} rows")
    return out


# ------------------------------------------------- 9. the probe tools

PROBE_SRC = "h2o3_tpu_torch/tools/csrc/probes.cu"
# the probe tools' kernels: the TPU probe each replaces, and the tool
# module (h2o3_tpu_torch/tools) that is its entry point
PROBES = {
    "mxu_probe": ("tools/kern_mxu_probe.py:47", "kern_mxu_probe"),
    "gather_probe": ("tools/kern_gather_probe.py:45", "kern_gather_probe"),
    "onehot_probe": ("tools/kern_gather_probe.py:45", "kern_gather_probe"),
    "level_knockouts_P2": ("tools/kern_ablate.py:129", "kern_ablate"),
    "level_knockouts_P3": ("tools/kern_ablate.py:233", "kern_ablate"),
    "level_knockouts_P4": ("tools/kern_ablate_t.py:120", "kern_ablate_t"),
    "level_variants_P6": ("tools/kern_variants.py:130", "kern_variants"),
}


# Shared loads (LDS, LDSM) that a knock-out instance may have fewer of
# than its body's production instance (kNone), because the phase it
# removes owns them: (body, knock-out) -> loads, as nvcc 12 for sm_90a
# counts them in the probes libraries. Any other knock-out keeps at least
# the production instance's shared loads; in the tensor-core grouped body
# it also keeps its HMMA or IMMA, which only kAdds removes.
PHASE_LOADS = {
    # the tiled body: the cell's lo and inv (ranges; bins does no re-bin),
    # the old value that each shared-add CAS loop reads (adds)
    ("tiled_adaptive", "ranges"): 2,
    ("tiled_adaptive", "bins"): 2,
    ("tiled_adaptive", "adds"): 3,
    # the grouped body: the children's lo and inv (ranges); bins also
    # drops the staged row ids and slots that the value or code loads read
    ("grouped_adaptive", "ranges"): 6,
    ("grouped_adaptive", "bins"): 18,
    ("grouped_packed", "bins"): 12,
    # its int8 instance: the children's lo and inv, and the staged split
    # feature's value that the route reads
    ("grouped_i8_adaptive", "route"): 2,
    ("grouped_i8_adaptive", "ranges"): 20,
    ("grouped_i8_adaptive", "bins"): 20,
    ("grouped_i8_packed", "route"): 2,
    # the wide body: the slot's lo and inv, a pair for each value of the
    # unrolled load window (ranges; bins does no re-bin)
    ("wide_adaptive", "ranges"): 32,
    ("wide_adaptive", "bins"): 32,
    ("wide_i8_adaptive", "ranges"): 32,
    ("wide_i8_adaptive", "bins"): 32,
}


def check_probe_sass(by_fn):
    """The knock-out instances of the probes libraries (mangled
    ``6AblateE<k>E``, k the Ablate value) against the production instance
    (k = 0) of the same body: no fewer shared loads (LDS, LDSM) than it,
    apart from the phase's own (``PHASE_LOADS``), so that the compiler
    dropped nothing upstream of the knocked-out phase; in the tensor-core
    grouped body no fewer HMMA (float) or IMMA (int8) products, and none
    under kAdds (4), which removes them. Prints every instance's counts
    beside the production instance's; raises with every instance that
    fails."""
    import re
    from h2o3_tpu_torch.tools._probes import ABLATES, BODIES
    names = {v: k for k, v in ABLATES.items()}

    def ops(c, *prefixes):
        return sum(v for k, v in c.items() if k.startswith(prefixes))
    inst = {}
    for name, c in by_fn.items():
        m = re.search(r"6AblateE(\d)E", name)
        form = next((f for f, k in (("grouped", "level_grouped_kernel"),
                                     ("wide", "level_wide_kernel"),
                                     ("tiled", "adaptive_level_kernel"))
                     if k in name), None)
        if m is None or form is None:
            continue
        kind = "packed" if "CodeBins" in name else "adaptive"
        body = f"{form}{'_i8' if 'I8Mass' in name else ''}_{kind}"
        key = (body, names[int(m.group(1))])
        if key in inst:
            raise AssertionError(f"SASS: two instances of {key}")
        inst[key] = (ops(c, "LDS"), ops(c, "HMMA", "IMMA"))
    want = {(b, a) for b, body in BODIES.items() for a in body.ablates}
    if set(inst) != want:
        raise AssertionError(f"SASS: knock-out instances missing "
                             f"{sorted(want - set(inst))} or unknown "
                             f"{sorted(set(inst) - want)}")
    rows, bad = [], []
    for (b, a), (lds, mma) in sorted(inst.items()):
        if a == "none":
            continue
        lds0, mma0 = inst[(b, "none")]
        rows.append(f"{b} {a} LDS {lds}/{lds0} MMA {mma}/{mma0}")
        if lds < lds0 - PHASE_LOADS.get((b, a), 0):
            bad.append(f"{b} {a}: {lds} shared loads against {lds0}")
        if b.startswith("grouped") and (
                (a == "adds" and mma) or (a != "adds" and mma < mma0)
                or not mma0):
            bad.append(f"{b} {a}: {mma} tensor-core products against "
                       f"{mma0}")
    print("SASS of the knock-out instances against their production "
          "instance (knock-out/production): " + "; ".join(rows),
          flush=True)
    if bad:
        raise AssertionError("SASS of the knock-out instances: "
                             + "; ".join(bad))


def probe_level_checks(dev, rows=3000, F=28):
    """Every knock-out of every probed body against its plain version at
    N = 2 and 32: integer-valued masses (every float sum exact) with nid
    and histogram bit-equal; the production instance ("none") also
    bit-equal to the training path's wrapper in the same form; the walk
    knock-out again on float masses, each bin within 1e-4 + 1e-5 x its
    absolute mass of the float64 plain version. Returns {body: max abs
    err}."""
    import torch
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.tools import kern_ablate
    from h2o3_tpu_torch.tools._probes import BODIES
    errs = {}
    for body_name, body in BODIES.items():
        errs[body_name] = 0.0
        for N in (2, 32):
            inp = kern_ablate.level_inputs(body_name, rows, F, N, 90 + N, dev,
                                           int_ghw=True)
            for ab in body.ablates:
                nk, hk = kern_ablate.knockout(body_name, ab, inp)
                npl, hp = kern_ablate.knockout_plain(body_name, ab, inp)
                torch.cuda.synchronize()
                what = f"{body_name} {ab} N={N}"
                if not torch.equal(nk, npl):
                    raise AssertionError(f"{what}: nid differs in "
                                         f"{int((nk != npl).sum())} rows")
                if not torch.equal(hk, hp.float()):
                    raise AssertionError(
                        f"{what}: histogram not bit-equal (max "
                        f"{float((hk - hp.float()).abs().max())})")
            # the probes' production instance is the training path's
            if body.kind == "adaptive" and body.mass == "float":
                ref = kernels.adaptive_level_form(
                    inp.vals, inp.nid, inp.ghw, inp.tables, inp.lo, inp.inv,
                    inp.n_prev, N, inp.level_base, body.W, True, body.layout,
                    body.form)
            elif body.kind == "adaptive":
                ref = kernels.adaptive_level_i8_form(
                    inp.vals, inp.nid, inp.q, inp.scales, inp.tables, inp.lo,
                    inp.inv, inp.n_prev, N, inp.level_base, body.W,
                    body.layout, body.form)
            elif body.mass == "float":
                ref = kernels.binned_level_form(
                    inp.vals, inp.nid, inp.ghw, inp.tables, inp.n_prev, N,
                    inp.level_base, body.W, True, body.form)
            else:
                ref = kernels.binned_level_i8_form(
                    inp.vals, inp.nid, inp.q, inp.scales, inp.tables,
                    inp.n_prev, N, inp.level_base, body.W, body.form)
            mine = kern_ablate.knockout(body_name, "none", inp)
            if not (torch.equal(ref[0], mine[0])
                    and torch.equal(ref[1], mine[1])):
                raise AssertionError(f"{body_name} N={N}: the probes' "
                                     f"production instance differs from "
                                     f"the training path's")
            if "walk" in body.ablates:
                fin = kern_ablate.level_inputs(body_name, rows, F, N, 190 + N,
                                               dev)
                _n, hk = kern_ablate.knockout(body_name, "walk", fin)
                g64 = fin.ghw
                fin.ghw = g64.double()
                _n, hp = kern_ablate.knockout_plain(body_name, "walk", fin)
                fin.ghw = g64.double().abs()
                _n, mass = kern_ablate.knockout_plain(body_name, "walk", fin)
                mass_check(f"{body_name} walk N={N}", hk, hp, mass)
                errs[body_name] = max(errs[body_name], float(
                    (hk.double() - hp).abs().max()))
            del inp
    return errs


def probe_kernel_checks(dev):
    """P1 and P5 against their plain versions at small sizes (the tools
    check them again at their own sizes): P1 at M = 6 and 24, FW 64 and
    128, K 1024, n_tiles 3, int8 exact and bf16 within 1e-5 x the absolute
    mass (``kern_mxu_probe.check``); P5 at 10,001 rows with indices outside
    [0, N) among them, bit-equal. Returns the largest absolute errors."""
    from h2o3_tpu_torch.tools import kern_gather_probe, kern_mxu_probe
    errs = {"mxu_probe": 0.0}
    for dt in ("bf16", "i8"):
        for M, FW in ((6, 64), (24, 128)):
            L, R = kern_mxu_probe.operands(M, FW, 1024, dt, dev)
            errs["mxu_probe"] = max(errs["mxu_probe"], kern_mxu_probe.check(
                L, R, 3, kern_mxu_probe.mxu(L, R, 3)))
    tab, idx = kern_gather_probe.operands(10_001, dev)
    idx[::97] = -1
    idx[5::89] = 32
    for name, onehot in (("gather_probe", False), ("onehot_probe", True)):
        errs[name] = kern_gather_probe.check(
            tab, idx, onehot, kern_gather_probe.lookup(tab, idx, onehot))
    return errs


def driven(tool, argv, need):
    """Run a probe tool's entry point (``tool.main(argv)``) with every
    launch count set to 0 just before and read just after; fails where a
    kernel of ``need`` was launched no time. Returns (result, counts)."""
    from h2o3_tpu_torch.ops import kernels
    from h2o3_tpu_torch.tools import _probes
    for counts in (kernels.LAUNCHES, _probes.LAUNCHES):
        for k in counts:
            counts[k] = 0
    res = tool.main(argv)
    got = {**{k: v for k, v in kernels.LAUNCHES.items() if v},
           **{k: v for k, v in _probes.LAUNCHES.items() if v}}
    missing = [k for k in need if not got.get(k)]
    if missing:
        raise AssertionError(f"{tool.__name__} {argv}: no launch of "
                             f"{missing} ({got})")
    return res, got


def phase_probes(card, dev):
    """9. The probe tools (h2o3_tpu_torch/tools), P1-P6: every probe
    kernel and every knock-out instance held to its plain version at a
    small size, then each tool's entry point driven at the JAX tools' own
    sizes with the launch counts read around it, each tool holding every
    kernel's first output on its timed inputs to the plain version (the
    records' max_abs_err is the largest of both sizes): P1 at M = 6, 24, 96, 128,
    256 (bf16 and int8 at FW 896, bf16 at FW 448, bf16 chained L = 4), P5,
    P2 as the attribution of every probed body at N = 32 and N = 2 (10M x
    28), P3 at L = 1, 2, 4, P4, P6. Returns the kernel records."""
    import torch
    from h2o3_tpu_torch.tools import (kern_ablate, kern_ablate_t,
                                      kern_gather_probe, kern_mxu_probe,
                                      kern_variants)
    errs = probe_kernel_checks(dev)
    level_errs = probe_level_checks(dev)
    print(f"probes vs plain at small sizes (again at the timed sizes "
          f"below): P1 and P5 {json.dumps(errs)}; "
          f"every knock-out of every body bit-equal (integer masses), the "
          f"walk within the mass tolerance (float masses, max abs err "
          f"{json.dumps(level_errs)}); [{card}]", flush=True)
    recs = []

    def rec(name, launches, err, ms, plain_ms, bound_ms, bound_by,
            library_ms, **extra):
        replaces, tool = PROBES[name]
        r = {"name": name, "route": "cuda", "source": PROBE_SRC,
             "replaces": replaces, "tool": f"h2o3_tpu_torch.tools.{tool}",
             "launches": launches, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": library_ms, **extra}
        recs.append(r)
        return r

    # P1
    mxu, launches, err = {}, 0, errs["mxu_probe"]
    for argv in (["--dt", "bf16"], ["--dt", "i8"], ["--fw", "448"],
                 ["--L", "4", "--reps", "10"]):
        res, got = driven(kern_mxu_probe, argv, ["mxu_probe"])
        launches += got["mxu_probe"]
        mxu[" ".join(argv)] = res["mxu"]
        err = max([err, *(r["max_abs_err"] for r in res["mxu"])])
    top = mxu["--dt bf16"][-1]
    L, R = kern_mxu_probe.operands(top["M"], top["FW"], kern_mxu_probe.TILE,
                                   "bf16", dev)
    n_tiles = kern_mxu_probe.ROWS // kern_mxu_probe.TILE
    plain_ms = time_cuda(lambda: kern_mxu_probe.mxu_plain(L, R, n_tiles), 3)
    del L, R
    rec("mxu_probe", launches, err, top["ms"], plain_ms,
        top["bound_ms"], "operations", top["library_ms"], by_run=mxu)
    print(f"P1 mxu_probe: M=256 bf16 FW 896 {top['ms']:.4f} ms a "
          f"contraction ({top['rate']:.1f} TFLOP/s, bound "
          f"{top['bound_ms']:.4f} ms) ; every M, dt, FW, L: "
          f"{json.dumps(mxu, default=float)} [{card}]", flush=True)

    # P5
    res, got = driven(kern_gather_probe, [],
                      ["gather_probe", "onehot_probe"])
    tab, idx = kern_gather_probe.operands(kern_gather_probe.ROWS, dev)
    for name, key, plain in (
            ("gather_probe", "lane-gather", kern_gather_probe.gather_plain),
            ("onehot_probe", "onehot-matmul",
             kern_gather_probe.onehot_plain)):
        pms = time_cuda(lambda: plain(tab, idx), 3)
        lib = res["library_ms"]
        if name == "onehot_probe":
            tb = tab.to(torch.bfloat16).float()
            lib = time_cuda(lambda: torch.index_select(tb, 1, idx), 10)
        rec(name, got[name], max(errs[name], res[f"{key} max_abs_err"]),
            res[key], pms, res["bound_ms"], "bytes", lib)
    del tab, idx
    print(f"P5 gather_probe / onehot_probe at {res['rows']} rows: "
          f"{res['lane-gather']:.4f} / {res['onehot-matmul']:.4f} ms, bound "
          f"{res['bound_ms']:.4f} ms, index_select {res['library_ms']:.4f} "
          f"ms [{card}]", flush=True)

    # P2: the attribution of every probed body at N = 32 and N = 2
    res, got = driven(kern_ablate, ["--bodies", "all", "--nodes", "32,2"],
                      ["level_knockout"])
    att = res["attribution"]
    # P2's own level: the [rows, F] adaptive one on the grouped body, N = 32
    p2 = next(a for a in att
              if a["body"] == "grouped_adaptive" and a["N"] == 32)
    rec("level_knockouts_P2", got["level_knockout"],
        max([*level_errs.values(),
             *(e for a in att for e in a["errs"].values())]),
        p2["ms"]["none"], p2["plain_ms"],
        p2["bound_ms"], p2["bound_by"], p2["library_ms"], attribution=att)
    print(f"P2 attribution (10M x 28; ms a level, shares of the base) "
          f"[{card}]: {json.dumps(att, default=float)}", flush=True)

    # P3: chained packed levels, eager against one CUDA graph
    res, got = driven(kern_ablate, ["--levels", "1,2,4"], ["level_knockout"])
    lv = res["levels"]
    inp = kern_ablate.level_inputs("grouped_packed", kern_ablate.LROWS, 28,
                                   32, 77, dev)
    pms = time_cuda(lambda: kern_ablate.knockout_plain(
        "grouped_packed", "none", inp), 3)
    lib, in_level = kern_ablate.index_add_ms("grouped_packed", inp, dev)
    bound, by = kern_ablate.level_bound_ms("grouped_packed",
                                           kern_ablate.LROWS, 28, 32,
                                           in_level)
    del inp
    rec("level_knockouts_P3", got["level_knockout"],
        max([level_errs["grouped_packed"], level_errs["wide_packed"],
             *(r["max_abs_err"] for r in lv)]),
        lv[0]["graph"]["none"], pms, bound, by, lib, levels=lv)
    print(f"P3 chained levels (2.5M x 28, N=32) [{card}]: "
          f"{json.dumps(lv, default=float)}", flush=True)

    # P4: the tiled [F, rows] body
    res, got = driven(kern_ablate_t, [], ["level_knockout"])
    rec("level_knockouts_P4", got["level_knockout"],
        max(level_errs["tiled_adaptive"], *res["errs"].values()),
        res["ms"]["none"], res["plain_ms"],
        res["bound_ms"], res["bound_by"], res["library_ms"], attribution=res)
    print(f"P4 tiled [F, rows] body (2.5M x 28, N=32) [{card}]: "
          f"{json.dumps(res, default=float)}", flush=True)

    # P6: the deepest adaptive level's forms
    res, got = driven(kern_variants, [], ["level_knockout", "adaptive_level"])
    inp = kern_ablate.level_inputs("grouped_adaptive", kern_variants.ROWS,
                                   28, 32, 1600, dev)
    pms = time_cuda(lambda: kern_ablate.knockout_plain(
        "grouped_adaptive", "none", inp), 3)
    lib, in_level = kern_ablate.index_add_ms("grouped_adaptive", inp, dev)
    bound, by = kern_ablate.level_bound_ms("grouped_adaptive",
                                           kern_variants.ROWS, 28, 32,
                                           in_level)
    del inp
    rec("level_variants_P6", got["level_knockout"] + got["adaptive_level"],
        max(v["max_abs_err"] for v in res.values()), res["grouped"]["ms"],
        pms, bound, by, lib, variants=res)
    print(f"P6 variants (10M x 28, N=32) [{card}]: "
          f"{json.dumps(res, default=float)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return recs


def sass_functions(lib_path):
    """{function: its SASS} of a built library (``cuobjdump``), None
    without the tool."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return {fn.split(chr(10))[0].strip(): fn
            for fn in sass.split("Function : ")[1:]}


def sass_atomics(lib_path):
    """The atomic, tensor-core and shared-load (LDS, LDSM) opcodes in each
    built kernel's SASS (``cuobjdump``), e.g. whether a shared-memory float
    add is native or a CAS loop. Returns (the printable summary of the
    atomic and tensor-core ones, {function: {opcode: count}})."""
    import re
    fns = sass_functions(lib_path)
    if fns is None:
        return "cuobjdump not found: SASS summary not printed", {}
    lines, by_fn = [], {}
    for name, fn in fns.items():
        ops = re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED|HMMA|IMMA)\."
                         r"[A-Z0-9_.]+|LDSM?(?![A-Z0-9_])(?:\.[A-Z0-9_.]+)?)",
                         fn)
        counts = {op: ops.count(op) for op in sorted(set(ops))}
        by_fn[name] = counts
        shown = {k: v for k, v in counts.items() if not k.startswith("LDS")}
        lines.append(f"  {name[:80]}: {shown}")
    return "SASS atomics per kernel:\n" + "\n".join(lines), by_fn


def check_sass(by_fn):
    """The SASS of the kernels whose float sums must come in a fixed order:
    every float tensor-core instance of the node-grouped level (mass
    policy FloatMass with kMma, mangled ``9FloatMass`` and ``Lb1E``), the
    adaptive level's (AdaptiveBins) and the packed level's (CodeBins), has
    HMMA and no shared float CAS loop (``ATOMS.CAST.SPIN``); every int8
    instance (``I8Mass``) of both has IMMA and no shared or global atomics
    at all; every float instance of the wide level (``level_wide_kernel``,
    both bin sources, every W), the leaf-totals kernel (each of its eight
    instances), global_hist's node-grouped form and the route (K9, its
    loads-only floor, K6) have no atomics at all;
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
    # leaf_totals: route or not x lane columns or matched keys x 16-byte
    # or scalar loads; global_hist grouped: uint8 and int32 codes
    n_leaf = sum("leaf_totals_kernel" in n for n in ordered)
    if n_leaf < 8 or len(ordered) - n_leaf < 2:
        raise AssertionError(f"SASS: leaf_totals (8) / global_hist grouped "
                             f"(2) instances missing: {sorted(ordered)}")
    for name, counts in ordered.items():
        if atomics(counts) or mma(counts, "HMMA") or mma(counts, "IMMA"):
            raise AssertionError(f"SASS of {name}: atomics {counts}")
    # the route (K9 in [rows, F] and its loads-only floor, K6 in
    # [F, rows]): no atomics
    route = {n: c for n, c in by_fn.items()
             if "adaptive_route_only_kernel" in n}
    if len(route) < 3:
        raise AssertionError(f"SASS: adaptive_route_only instances missing: "
                             f"{sorted(route)}")
    for name, counts in route.items():
        if atomics(counts):
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
          f"without atomics; {len(route)} adaptive_route_only instances "
          f"without atomics", flush=True)


def ptxas_usage(log, names):
    """What ``-Xptxas -v`` reported (registers, barriers, shared memory;
    stack frame and spills) for each kernel of the build log whose mangled
    name holds one of ``names``: {function: [its lines]}."""
    import re
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1) if any(n in m.group(1) for n in names) else None
        elif cur and ("spill" in line or "Used " in line):
            out.setdefault(cur, []).append(line.split(":", 1)[-1].strip())
    return out


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
    from h2o3_tpu_torch.tools import _probes

    # 1. device
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name} [{card}]; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 2. build: the training path's libraries and the probe tools' (phase
    # 9), every nvcc started together
    clock = PhaseClock()
    t0 = time.perf_counter()
    probes_built = []

    def build_probes():
        try:
            probes_built.append(_probes.build())
        except BaseException as e:  # re-raised below, on this thread
            probes_built.append(e)
    probes_thread = threading.Thread(target=build_probes, daemon=True)
    probes_thread.start()
    kernels.build()
    probes_thread.join()
    if isinstance(probes_built[0], BaseException):
        raise probes_built[0]
    log(f"build: {time.perf_counter() - t0:.2f} s\n{kernels.build_log()}\n"
        f"{_probes.build_log()}")
    usage = ptxas_usage(kernels.build_log(), ("leaf_totals_kernel",
                                              "adaptive_route_only_kernel"))
    if not usage:
        raise AssertionError("ptxas -v: no leaf_totals / adaptive_route_only "
                             "entry in the build log")
    print("ptxas -v, leaf totals and route instances:\n" +
          "\n".join(f"  {fn}: {'; '.join(lines)}"
                    for fn, lines in sorted(usage.items())), flush=True)
    by_fn = {}
    for so in kernels.library_paths().values():
        text, counts = sass_atomics(so)
        print(text, flush=True)
        by_fn.update(counts)
    if by_fn:
        check_sass(by_fn)
    probe_fns = {}
    for so in _probes.library_paths().values():
        probe_fns.update(sass_atomics(so)[1])
    if probe_fns:
        check_probe_sass(probe_fns)

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
    # the wide lane widths (nbins 254 packed, 62 adaptive)
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

    # 4-5 from a file: CSV -> import_file -> GBM, HIGGS and airlines shapes
    csv = phase_csv(card)
    clock.lap("4-5 csv (files, parse, trains, profile, card vs cpu)")

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
                      ("adaptive_wide_i8", adaptive_wide_i8),
                      ("higgs_csv", {"launches": csv["higgs_csv"]}),
                      ("airlines_csv", {"launches": csv["airlines_csv"]})):
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
    clock.lap("7 repeatability")

    # 8. XGBoost (BASELINE config #2): validation frame, early stopping
    xgb = phase_xgboost(card, fr)
    del fr
    for path, launches in xgb.items():
        for kernel in ("binned_level", "binned_route_only",
                       "segment_totals"):
            by_name[kernel].setdefault("launches_by_path", {})[
                f"xgboost_{path}"] = launches[kernel]
    clock.lap("8 xgboost")
    # 9. the probe tools, P1-P6
    rec += phase_probes(card, dev)
    clock.lap("9 probes")
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
          "adaptive_route_only[rows_f,f_rows; rows_f and its loads-only "
          "floor x F=28,8; ragged, n_prev=1, n_prev=2048, unaligned] "
          "adaptive_level_i8[rows_f x W=16,32,64,128,256 x terms=1,2 x "
          "node-grouped (W<=32) or wide (W>=64), tiled, picked; f_rows x "
          "W=16,32,64,128,256 x terms=1,2 x tiled, picked] "
          "leaf_totals[n_prev=0,32 x N=1,64] "
          "segment_totals[N=1,64,512,4096; lanes, match x rows%4=1,2,3, "
          "one node at N=1,64; one node at N=4096] "
          "global_hist[B1=15 uint8,257,1025 int32; node-grouped, global "
          "atomics] group_rows[alone]; index_add_ beside binned_level "
          "(W=16,32,64,128,256), adaptive_level (W=32,64,128,256), "
          "binned_level_i8 (W=16,64,128,256) and adaptive_level_i8 "
          "(W=32,64,128,256), segment_totals, global_hist; "
          "probes: mxu_probe[M=6,24,96,128,256 x bf16,int8 x FW=896,448 x "
          "L=1,4] gather_probe onehot_probe level_knockouts[grouped W=16,32 "
          "x float,int8; wide W=64,256 x float,int8; tiled f_rows W=32 x "
          "none,route,ranges,bins,adds,walk,gather x N=2,32; P3 L=1,2,4 "
          "eager, graph] level_variants[grouped, wide, tiled, atomics, "
          "noroute, noloinv]", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rec}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
