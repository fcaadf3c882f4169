#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``h2o3_tpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a
CUDA device and the repository; without either it exits non-zero and
prints no result. Phases, each fatal on failure:

1. device: the card's name and power limit;
2. build: compile the CUDA kernels from ``h2o3_tpu_torch/csrc``;
3. kernel vs plain on the card: binned_level at W=16 (int8), W=32 (int8)
   and W=256 (int16) with F=28, 1M rows and N in {1, 8, 32}, and
   binned_route_only at N=64. With integer-valued (g, h, w) node ids and
   histograms must be bit-equal to the plain PyTorch version; with float
   (g, h, w) node ids bit-equal and each histogram bin within
   1e-4 + 1e-5 x (its absolute mass) of the plain version accumulated in
   float64, for float32 and for bfloat16-rounded masses;
4. the main path at full width: 10M x 28 HIGGS-shaped rows ->
   Frame.from_numpy(device="cuda") -> bernoulli GBM, depth 6, nbins 14,
   quantiles_global, 20 trees -> training AUC -> predict, with the launch
   counters set to 0 just before and read just after (6 x 20 level
   launches and 20 route launches expected);
5. card vs CPU, same code: 200k rows, depth 6, float32 histograms,
   5 trees on each device; tree 0's splits equal, |dAUC| <= 1e-4;
6. timing of each kernel at the main path's shapes against its plain
   version and its bound;
7. where the time goes: the main path's train again, warm (20 trees
   plain, then 5 trees under torch.profiler: device time by kernel,
   device busy share).

The last two lines of stdout are the kernel record and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_OPS_PER_S = 67e12         # H100 SXM float32 rate outside the tensor cores
SRC = "h2o3_tpu_torch/csrc/hist_binned.cu"
REPLACES = {"binned_level": "h2o3_tpu/ops/hist_adaptive.py:930",
            "binned_route_only": "h2o3_tpu/ops/hist_adaptive.py:1282"}


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
    """The route reads one code, one nid and writes one nid per row."""
    return rows * (itemsize + 8) / HBM_BYTES_PER_S * 1e3, "bytes"


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
        excess = (hk.double() - hp).abs() - (1e-4 + 1e-5 * mass)
        if float(excess.max()) > 0:
            raise AssertionError(f"binned_level W={W} N={N} float ghw: "
                                 f"max abs err {err} beyond 1e-4 + 1e-5 x "
                                 f"bin mass")
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


def train(fr, ntrees, **kw):
    from h2o3_tpu_torch.estimators import H2OGradientBoostingEstimator
    est = H2OGradientBoostingEstimator(
        ntrees=ntrees, max_depth=6, learn_rate=0.1, nbins=14,
        distribution="bernoulli", seed=7, min_rows=1.0,
        histogram_type="quantiles_global", **kw)
    est.train(y="label", training_frame=fr)
    return est.model


def phase_main_path(card, rows=10_000_000, ntrees=20, depth=6):
    import torch
    from h2o3_tpu_torch.ops import kernels
    X, y, F = higgs_arrays(rows)
    t0 = time.perf_counter()
    fr = frame_of(X, y, "cuda")
    torch.cuda.synchronize()
    log(f"frame {rows}x{F + 1} on cuda in {time.perf_counter() - t0:.2f} s")
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0
    model = train(fr, ntrees)
    auc = model.training_metrics.auc
    pred = model.predict(fr)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches["binned_level"] != depth * ntrees:
        raise AssertionError(f"binned_level launched "
                             f"{launches['binned_level']} times, expected "
                             f"{depth * ntrees}")
    if launches["binned_route_only"] != ntrees:
        raise AssertionError(f"binned_route_only launched "
                             f"{launches['binned_route_only']} times, "
                             f"expected {ntrees}")
    if not np.isfinite(auc) or not 0.5 < auc <= 1.0:
        raise AssertionError(f"training AUC {auc} is not a finite "
                             f"better-than-chance value")
    p1 = pred.vec("p1").to_numpy()
    if p1.shape != (rows,) or not np.all(np.isfinite(p1)) \
            or p1.min() < 0 or p1.max() > 1:
        raise AssertionError("predict: p1 is not a finite probability per "
                             "row")
    loop_s = model.output["training_loop_seconds"]
    rps = rows * model.ntrees_built / loop_s
    pc = model.output["packed_codes"]
    print(f"main path: {rows}x{F} bernoulli GBM depth {depth} nbins 14 "
          f"{ntrees} trees: AUC {auc!r} training_loop_seconds {loop_s!r} "
          f"rows/s {rps!r} codes {pc['dtype']} W={pc['W']} "
          f"train_profile {json.dumps(model.output['train_profile'])} "
          f"launches {launches} [{card}]", flush=True)
    return {"auc": auc, "loop_s": loop_s, "rows_per_s": rps,
            "launches": launches, "frame": fr}


def phase_card_vs_cpu(rows=200_000, ntrees=5):
    X, y, _F = higgs_arrays(rows, seed=11)
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = train(frame_of(X, y, dev), ntrees,
                            histogram_precision="float32")
    mc, mh = models["cuda"], models["cpu"]
    for key in ("feat", "split_bin"):
        a = mc.trees[key][0]
        b = mh.trees[key][0]
        if not np.array_equal(a, b):
            raise AssertionError(f"tree 0 {key} differs between cuda and "
                                 f"cpu: {a} vs {b}")
    d_auc = abs(mc.training_metrics.auc - mh.training_metrics.auc)
    if d_auc > 1e-4:
        raise AssertionError(f"|dAUC| cuda vs cpu = {d_auc}")
    print(f"card vs cpu: {rows} rows, {ntrees} trees, float32 histograms: "
          f"tree 0 splits equal, AUC cuda {mc.training_metrics.auc!r} "
          f"cpu {mh.training_metrics.auc!r} |dAUC| {d_auc!r}", flush=True)


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
    rec = [{"name": "binned_level", "route": "cuda", "source": SRC,
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
    rec.append({"name": "binned_route_only", "route": "cuda", "source": SRC,
                "replaces": REPLACES["binned_route_only"],
                "launches": launches["binned_route_only"],
                "max_abs_err": 0.0, "ms": ms, "plain_ms": pms,
                "bound_ms": bound, "bound_by": by, "library_ms": None})
    return rec


def phase_warm_profile(fr, card, ntrees=5):
    """Where the time goes: the main path's train again (warm: kernels
    loaded, allocator grown), once plain at 20 trees and once with 5
    trees under torch.profiler. Prints the loop times, the device time
    by kernel and the device busy share of the whole train() call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    warm = train(fr, 20)
    w_loop = warm.output["training_loop_seconds"]
    print(f"warm retrain: {fr.nrow} rows, 20 trees: training_loop_seconds "
          f"{w_loop!r} (rows/s {fr.nrow * 20 / w_loop!r}), AUC "
          f"{warm.training_metrics.auc!r} [{card}]", flush=True)
    del warm
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model = train(fr, ntrees)
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
    print(f"warm profile: {fr.nrow} rows, {ntrees} trees: "
          f"training_loop_seconds {loop_s!r} "
          f"(rows/s {fr.nrow * ntrees / loop_s!r}), train() wall "
          f"{wall * 1e3!r} ms, device busy {busy!r} ms "
          f"({busy / (wall * 1e3)!r} of the wall), train_profile "
          f"{json.dumps(model.output['train_profile'])} [{card}]",
          flush=True)
    for k, v in top:
        print(f"  device ms {v:10.3f}  {k[:100]}", flush=True)


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
    t0 = time.perf_counter()
    kernels.build()
    log(f"build: {time.perf_counter() - t0:.2f} s\n{kernels.build_log()}")
    print(sass_atomics(kernels.library_path()), flush=True)

    # 3. kernel vs plain
    phase_kernels(dev)

    # 4. main path
    main_res = phase_main_path(card)

    # 5. card vs cpu
    phase_card_vs_cpu()

    # 6. kernels at the main path's shape
    rec = phase_kernel_record(dev, main_res["launches"])

    # 7. where the time goes: a warm, profiled retrain of the main path
    phase_warm_profile(main_res.pop("frame"), card)
    print("kernels run: binned_level[W=16,32,256] binned_route_only",
          flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": rec}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
