"""P2 and P3: phase knock-outs of the port's own level bodies, timed.

Hopper counterpart of ``tools/kern_ablate.py`` (the JAX package's TPU
probe). There, one phase of a copy of the TPU level kernel was knocked out
per variant and the delta from the base time was that phase's cost. Here
the knock-outs are compile-time instances of the bodies the training path
runs (``csrc/level_common.cuh`` ``Ablate``; ``tools/csrc/probes.cu``):

- ``route``: every parent sends every row left, without reading x;
- ``ranges``: the child's (lo, inv) are the constants -4 and (W - 2) / 8
  (the JAX probe's ``loinv``);
- ``bins``: the bin of (row, f) is (row + f) mod (W - 1), without the
  value load or the re-bin (the JAX probe's ``sel`` and ``onehot``);
- ``adds``: the mass products or shared adds are skipped, the histogram is
  zero (the JAX probe's ``left`` and ``matmul``);
- ``walk`` (the float wide body): shared float atomics, a thread a record,
  in place of the consumers' keyed fixed-order walk;
- ``gather`` (the wide body): producer p reads row p of the frame in place
  of its record's row (p < 256: the record's place in its group mod 256).

Each computes a defined function; ``knockout_plain`` is its plain version
(the plain level of ``ops/hist_adaptive.py`` on changed inputs) and serves
CPU tensors; ``knockout`` launches the kernel for CUDA tensors. The grouped
bodies' grouping pass and merge are timed alone.

P2 (the default): the deepest adaptive level (N = 32, n_prev 16, 28
features, 10,002,432 rows, bf16 masses) on the tensor-core grouped body at
W = 32 and the wide body at W = 64: each knock-out's ms a level, its delta
and share of the base, the grouping pass and the merge, the residual no
knock-out explains (the shares are not additive: ``attribute``), the
bound and one ``index_add_``. Each knock-out's first output on the timed
inputs is held to its plain version. ``--levels 1,2,4``
(P3): the packed level (int8 codes, W = 16, grouped; int16 codes, W = 256,
wide; N = 32, 2,502,656 rows) chained L levels, nid fed forward, as one
CUDA graph against L eager launch sequences, with the route, bins and adds
knock-outs: ms a level, the shares of the graph's time, and the launch
overhead the graph saves. ``--bodies all --nodes 32,2`` attributes every probed body
(``_probes.BODIES``) at the deepest level and at a shallow one.

Between timed reps the level's nid is fed back (each row's parent, so that
every rep sees the same level: the JAX tools' modular map moved the rows
out of the window after the first). A level's ms is the device's: the reps
are queued back to back (``tools.fed_ms``), so the wrapper's host time
stays out of it; P3's eager chains show that host time on purpose.

Run: ``python -m h2o3_tpu_torch.tools.kern_ablate [--levels 1,2,4]
[--bodies all] [--nodes 32,2] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from h2o3_tpu_torch.ops.common import level_hist_i8_plain, level_hist_plain
from h2o3_tpu_torch.ops.hist_adaptive import (adaptive_level_i8_plain,
                                              adaptive_level_plain,
                                              adaptive_route_only_plain,
                                              binned_level_i8_plain,
                                              binned_level_plain,
                                              binned_route_only_plain,
                                              code_dtype,
                                              make_adaptive_tables,
                                              make_tables, quantize_ghw_i8)
from h2o3_tpu_torch.tools import (F32_OPS_PER_S, HBM_BYTES_PER_S, _probes,
                                  device_arg, fed_ms, resolve, time_ms,
                                  window_ms)
from h2o3_tpu_torch.tools._probes import BODIES, LevelInputs

ROWS = 10_002_432           # the JAX probe's P2 rows
LROWS = 2_502_656           # its packed multi-level rows
F, N = 28, 32
REPS = 10


# --------------------------------------------------------------- inputs


def level_inputs(body_name: str, rows: int, F: int, N: int, seed: int,
                 dev, int_ghw: bool = False) -> LevelInputs:
    """One level of body ``body_name`` at N nodes (n_prev = N // 2, the
    rows in the previous level's window, level_base N - 1): x HIGGS-like
    (5% NaN) with per-(node, feature) ranges that cover the bulk of it, or
    codes (5% NA), split tables (10% of the parents cannot split), (g, h,
    w) (integer-valued with ``int_ghw``, so that every float sum is exact)
    or their one-term int8 q. Made by torch's generator from ``seed`` on
    ``dev``."""
    body = BODIES[body_name]
    W = body.W
    g = torch.Generator(device=dev).manual_seed(seed)
    n_prev, base = N // 2, N - 1
    m = max(n_prev, 1)
    lo = inv = None
    if body.kind == "adaptive":
        shape = (rows, F) if body.layout == "rows_f" else (F, rows)
        vals = torch.randn(shape, generator=g, device=dev)
        vals = torch.where(torch.rand(shape, generator=g, device=dev) < 0.05,
                           torch.nan, vals).contiguous()
        lo = (-4.0 + 0.5 * torch.rand((N, F), generator=g, device=dev))
        inv = (W - 2) / (7.0 + torch.rand((N, F), generator=g, device=dev))
        tables = make_adaptive_tables(
            torch.randint(0, F, (m,), generator=g, device=dev),
            torch.randn(m, generator=g, device=dev),
            torch.rand(m, generator=g, device=dev) < 0.5,
            torch.rand(m, generator=g, device=dev) < 0.9)
    else:
        codes = torch.randint(0, W - 1, (rows, F), generator=g, device=dev)
        na = torch.rand((rows, F), generator=g, device=dev) < 0.05
        vals = torch.where(na, W - 1, codes).to(code_dtype(W)).contiguous()
        tables = make_tables(
            torch.randint(0, F, (m,), generator=g, device=dev),
            torch.randint(1, W - 1, (m,), generator=g, device=dev),
            torch.rand(m, generator=g, device=dev) < 0.5,
            torch.rand(m, generator=g, device=dev) < 0.9)
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
    inp = LevelInputs(vals=vals, nid=nid, tables=tables.contiguous(),
                      n_prev=n_prev, n_nodes=N, level_base=base,
                      lo=None if lo is None else lo.contiguous(),
                      inv=None if inv is None else inv.contiguous())
    if body.mass == "i8":
        inp.q, inp.scales = quantize_ghw_i8(ghw, 1)
    else:
        inp.ghw = ghw
    return inp


# -------------------------------------------------------- plain versions


def _rows_f(body, vals):
    return vals if body.layout == "rows_f" else vals.t()


def _can(body, tables):
    return tables[3] > 0.5 if body.kind == "adaptive" else tables[3] != 0


def gather_rows(body_name: str, inp: LevelInputs) -> torch.Tensor:
    """The row whose values the gather knock-out's producer reads for each
    row: a row the level adds or routes is a record of its group (its
    parent when routed, else its node), in row order, and its producer is
    its place in the group mod 256; any other row reads itself."""
    body = BODIES[body_name]
    rows = inp.nid.shape[0]
    nid = inp.nid.long()
    lp = nid - (inp.level_base - inp.n_prev)
    can = _can(body, inp.tables)[lp.clamp(0, max(inp.n_prev, 1) - 1)]
    routed = (inp.n_prev > 0) & (lp >= 0) & (lp < inp.n_prev) & can
    ln = nid - inp.level_base
    key = torch.where(routed, lp, torch.where(
        (ln >= 0) & (ln < inp.n_nodes), inp.n_prev + ln, -1))
    order = torch.sort(key, stable=True).indices
    sk = key[order]
    first = torch.searchsorted(sk, sk)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(rows, device=nid.device) - first
    return torch.where(key >= 0, rank % 256,
                       torch.arange(rows, device=nid.device))


def _route_plain(body, inp, tables=None):
    tables = inp.tables if tables is None else tables
    if inp.n_prev == 0:
        return inp.nid.clone()
    if body.kind == "adaptive":
        return adaptive_route_only_plain(inp.vals, inp.nid, tables,
                                         inp.n_prev, inp.level_base,
                                         body.layout)
    return binned_route_only_plain(inp.vals, inp.nid, tables, inp.n_prev,
                                   inp.level_base, body.W)


def _level_plain(body, inp, vals=None, tables=None, lo=None, inv=None):
    vals = inp.vals if vals is None else vals
    tables = inp.tables if tables is None else tables
    lo = inp.lo if lo is None else lo
    inv = inp.inv if inv is None else inv
    a = (inp.n_prev, inp.n_nodes, inp.level_base, body.W)
    if body.kind == "adaptive":
        if body.mass == "i8":
            return adaptive_level_i8_plain(vals, inp.nid, inp.q, inp.scales,
                                           tables, lo, inv, *a, body.layout)
        return adaptive_level_plain(vals, inp.nid, inp.ghw, tables, lo, inv,
                                    *a, True, body.layout)
    if body.mass == "i8":
        return binned_level_i8_plain(vals, inp.nid, inp.q, inp.scales,
                                     tables, *a)
    return binned_level_plain(vals, inp.nid, inp.ghw, tables, *a, True)


def knockout_plain(body_name: str, ablate: str, inp: LevelInputs):
    """Plain version of body ``body_name`` under knock-out ``ablate``: the
    plain level on the changed inputs that define it. route: split
    thresholds that no value passes (NaN, or split_bin W) and NA left;
    ranges: lo -4 and inv (W - 2) / 8 everywhere; bins: the routed rows'
    histogram over bins (row + f) mod (W - 1); adds: the route and a zero
    histogram; walk: the level itself (the kernel adds in another order);
    gather: the level on the values with each row replaced by
    ``gather_rows``' row. Returns (nid' int32 [rows], hist [3, n_nodes, F,
    W] float32; float64 where ghw is)."""
    body = BODIES[body_name]
    if ablate not in body.ablates:
        raise ValueError(f"{body_name} takes the knock-outs {body.ablates}, "
                         f"not {ablate!r}")
    W = body.W
    if ablate in ("none", "walk"):
        return _level_plain(body, inp)
    if ablate == "route":
        t = inp.tables.clone()
        if body.kind == "adaptive":
            t[1] = torch.nan
        else:
            t[1] = W
        t[2] = 1
        return _level_plain(body, inp, tables=t)
    if ablate == "ranges":
        return _level_plain(body, inp, lo=torch.full_like(inp.lo, -4.0),
                            inv=torch.full_like(inp.inv, (W - 2) / 8.0))
    if ablate == "gather":
        src = gather_rows(body_name, inp)
        return _level_plain(body, inp, vals=inp.vals[src].contiguous())
    nid = _route_plain(body, inp)
    rows, Fv = inp.rows_features(body)
    dev = inp.nid.device
    if ablate == "adds":
        dt = inp.ghw.dtype if body.mass == "float" else torch.float32
        return nid, torch.zeros((3, inp.n_nodes, Fv, W), dtype=dt,
                                device=dev)
    # bins
    bins = (torch.arange(rows, device=dev)[:, None]
            + torch.arange(Fv, device=dev)[None, :]) % (W - 1)
    if body.mass == "i8":
        return nid, level_hist_i8_plain(nid, bins, inp.q, inp.scales,
                                        inp.n_nodes, inp.level_base, W)
    return nid, level_hist_plain(nid, bins, inp.ghw, inp.n_nodes,
                                 inp.level_base, W, True)


def knockout(body_name: str, ablate: str, inp: LevelInputs):
    """Body ``body_name`` under knock-out ``ablate``: the plain version for
    CPU tensors, the kernel for CUDA tensors."""
    dev = inp.vals.device.type
    if dev == "cpu":
        return knockout_plain(body_name, ablate, inp)
    if dev == "cuda":
        return _probes.level_knockout(body_name, ablate, inp)
    raise ValueError(f"no knock-out on {inp.vals.device}")


def check_knockout(body_name: str, ablate: str, inp: LevelInputs,
                   out) -> float:
    """``out``, the (nid', hist) of body ``body_name`` under knock-out
    ``ablate`` on ``inp``, against its plain version: nid' bit-equal; the
    histogram bit-equal on int8 masses (integer sums, one scaling) and,
    on float masses (summed in another order), each bin within 1e-4 +
    1e-5 x its absolute mass of the plain version in float64. Returns the
    largest absolute difference; raises beyond."""
    body = BODIES[body_name]
    nk, hk = out
    what = (f"{body_name} {ablate} N={inp.n_nodes} rows="
            f"{inp.nid.shape[0]}")
    if body.mass == "i8":
        npl, hp = knockout_plain(body_name, ablate, inp)
        mass = None
    else:
        g = inp.ghw
        try:
            inp.ghw = g.double()
            npl, hp = knockout_plain(body_name, ablate, inp)
            inp.ghw = inp.ghw.abs()
            mass = knockout_plain(body_name, ablate, inp)[1]
        finally:
            inp.ghw = g
    if not torch.equal(nk, npl):
        raise AssertionError(f"{what}: nid differs in "
                             f"{int((nk != npl).sum())} rows")
    diff = (hk.double() - hp.double()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if mass is None:
        if not torch.equal(hk, hp):
            raise AssertionError(f"{what}: histogram not bit-equal (max "
                                 f"abs err {err})")
    elif float((diff - (1e-4 + 1e-5 * mass)).max()) > 0:
        raise AssertionError(f"{what}: max abs err {err} beyond 1e-4 + "
                             f"1e-5 x bin mass")
    return err


# ----------------------------------------------------------- measuring


def parent_nid(nid_out: torch.Tensor, level_base: int, n_prev: int):
    """The nid that produced ``nid_out``: each routed row's parent, any
    other row's own (so that a fed-back rep sees the same level)."""
    if n_prev == 0:
        return nid_out
    return torch.where(nid_out >= level_base, (nid_out - 1) // 2, nid_out)


def timed_level(fn, inp: LevelInputs, dev, reps: int = REPS,
                first=None) -> float:
    """Median ms of ``fn(inp)`` (a level), nid fed back between reps
    (``tools.fed_ms``: the device's time, calls queued back to back); the
    warm-up's output, on ``inp`` as given, goes to ``first(out)``."""
    nid0 = inp.nid

    def feed(out):
        inp.nid = parent_nid(out[0], inp.level_base, inp.n_prev)
    try:
        return fed_ms(lambda: fn(inp), feed, dev, reps, first)
    finally:
        inp.nid = nid0


def level_bound_ms(body_name: str, rows: int, F: int, N: int,
                   rows_in_level: int):
    """Least time for one level: x or codes, nid and the masses read once,
    nid' and the histogram written once, over 3.35 TB/s; or 3 adds per
    (row in the level, feature) over 67 TFLOP/s; the larger, and which."""
    body = BODIES[body_name]
    item = 4 if body.kind == "adaptive" else code_dtype(body.W).itemsize
    mass = 12 if body.mass == "float" else 3
    nbytes = rows * (F * item + 4 + mass + 4) + 3 * N * F * body.W * 4
    ops = 3 * rows_in_level * F
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def index_add_ms(body_name: str, inp: LevelInputs, dev, reps=REPS):
    """The library yardstick of the level's histogram: one ``index_add_``
    of the masses of the rows in the level's window over their flat
    (node, feature, bin) index (bf16-rounded float32, or the int8 q
    widened to int32), index and values built before the timing. The port
    never calls it."""
    body = BODIES[body_name]
    nid, _h = knockout_plain(body_name, "none", inp) if dev.type == "cpu" \
        else _probes.level_knockout(body_name, "none", inp)
    rows, Fv = inp.rows_features(body)
    xr = _rows_f(body, inp.vals)
    lid = nid.long() - inp.level_base
    live = (lid >= 0) & (lid < inp.n_nodes)
    if body.kind == "adaptive":
        from h2o3_tpu_torch.ops.hist_adaptive import adaptive_bins_plain
        bins = adaptive_bins_plain(xr[live], nid[live], inp.lo, inp.inv,
                                   inp.n_nodes, inp.level_base, body.W)
    else:
        bins = xr[live].long()
    flat = ((lid[live][:, None] * Fv + torch.arange(Fv, device=dev))
            * body.W + bins).reshape(-1)
    if body.mass == "float":
        v = inp.ghw.t()[live].to(torch.bfloat16).float()
    else:
        v = inp.q.t()[live].to(torch.int32)
    v = v[:, None, :].expand(-1, Fv, 3).reshape(-1, 3).contiguous()
    out = torch.zeros((inp.n_nodes * Fv * body.W, 3), dtype=v.dtype,
                      device=dev)
    ms = time_ms(lambda: out.index_add_(0, flat, v), dev, reps)
    return ms, int(live.sum())


def attribute(body_name: str, rows: int, F: int, N: int, dev, seed: int,
              reps: int = REPS, extras: bool = True,
              ablates=None) -> dict:
    """The phase attribution of one level of body ``body_name``: ms a
    level of the production instance ("none") and of each knock-out (all
    the body takes, or those in ``ablates``), the knock-out's share of the
    base: (base - ms) / base; each one's first output held to its plain
    version on the timed inputs (``check_knockout``; the largest absolute
    errors in "errs"); for a grouped body the grouping pass and the merge
    alone (share: ms / base); the residual, 1 less the shares; with
    ``extras``, the bound, one ``index_add_`` and the plain version's ms.

    The shares are not additive: route, ranges, bins and gather change
    what the phases after them see (route sends every row of a parent to
    one child, ranges and bins spread the bins otherwise, gather reads 256
    rows), so a delta also holds the change downstream, and the residual
    (which may be negative) is what the deltas leave, not a phase."""
    body = BODIES[body_name]
    if ablates is None:
        ablates = body.ablates
    ablates = ("none", *[a for a in ablates if a != "none"])
    for ab in ablates:
        if ab not in body.ablates:
            raise ValueError(f"{body_name} takes the knock-outs "
                             f"{body.ablates}, not {ab!r}")
    inp = level_inputs(body_name, rows, F, N, seed, dev)
    errs = {}

    def timed(ab):
        def check(out):
            errs[ab] = check_knockout(body_name, ab, inp, out)
        return timed_level(lambda i: knockout(body_name, ab, i), inp, dev,
                           reps, check)
    ms = {ab: timed(ab) for ab in ablates}
    base = ms["none"]
    share = {ab: (base - t) / base for ab, t in ms.items() if ab != "none"}
    if body.form != "tiled" and dev.type == "cuda":
        level, group, merge = _probes.level_phases(body_name, inp)
        level()
        ms["group"] = time_ms(group, dev, reps)
        level()
        ms["merge"] = time_ms(merge, dev, reps)
        share["group"] = ms["group"] / base
        share["merge"] = ms["merge"] / base
    explained = sum(v for k, v in share.items() if k != "walk")
    out = {"body": body_name, "W": body.W, "N": N, "rows": rows, "ms": ms,
           "share": share, "residual": 1.0 - explained, "errs": errs}
    if extras:
        lib, in_level = index_add_ms(body_name, inp, dev, reps)
        out["bound_ms"], out["bound_by"] = level_bound_ms(
            body_name, rows, F, N, in_level)
        out["library_ms"] = lib
        out["plain_ms"] = time_ms(lambda: knockout_plain(body_name, "none",
                                                         inp), dev, 2)
    del inp
    return out


def print_attribution(res: dict) -> None:
    ms, share = res["ms"], res["share"]
    base = ms["none"]
    print(f"{res['body']} W={res['W']} N={res['N']} rows={res['rows']}: "
          f"base {base:.4f} ms/level", flush=True)
    for k, t in ms.items():
        if k == "none":
            continue
        what = "alone" if k in ("group", "merge") else "knocked out"
        print(f"  {k:7s}: {t:8.4f} ms ({what}), share {share[k]:+.3f}",
              flush=True)
    extra = ""
    if "bound_ms" in res:
        extra = (f"; bound {res['bound_ms']:.4f} ms ({res['bound_by']}), "
                 f"index_add_ {res['library_ms']:.4f} ms, plain "
                 f"{res['plain_ms']:.3f} ms")
    print(f"  residual: {res['residual']:+.3f}{extra}; each knock-out OK "
          f"vs plain on these inputs, max abs err "
          f"{max(res['errs'].values()):.3g}", flush=True)


# ------------------------------------------------------------- P3: L


def chained(body_name: str, ablate: str, inp: LevelInputs, L: int, dev,
            graph: bool, reps: int = REPS, first=None) -> float:
    """Median ms a level of ``L`` chained levels (nid fed forward as the
    parent ids, so that each is the same level), launched eagerly or as
    one CUDA graph (``tools.window_ms``); the first eager window's last
    level output goes to ``first(out)``, with ``inp`` as given."""
    nid0 = inp.nid.clone()

    def window():
        nid, out = nid0, None
        for _ in range(L):
            inp.nid = nid
            out = knockout(body_name, ablate, inp)
            nid = parent_nid(out[0], inp.level_base, inp.n_prev)
        inp.nid = nid0
        return out
    return window_ms(window, L, dev, graph, reps, first)


def levels_run(dev, levels, rows: int = LROWS, F: int = F,
               reps: int = REPS) -> list:
    """P3: the packed level bodies chained L levels, eager and as one CUDA
    graph, with the route, bins and adds knock-outs; each knock-out's
    first eager output held to its plain version (``check_knockout``; the
    largest absolute error in "max_abs_err"). The shares are of the graph
    times (the device's), the launch overhead is 1 less graph / eager."""
    out = []
    for body_name in ("grouped_packed", "wide_packed"):
        inp = level_inputs(body_name, rows, F, N, 77, dev)
        per_l1 = None
        for L in levels:
            r = {"body": body_name, "L": L, "eager": {}, "graph": {}}
            errs = []
            for ab in ("none", "route", "bins", "adds"):
                def check(o, ab=ab):
                    errs.append(check_knockout(body_name, ab, inp, o))
                for mode in ("eager", "graph"):
                    first = check if mode == "eager" else None
                    if dev.type == "cuda":
                        r[mode][ab] = chained(body_name, ab, inp, L, dev,
                                              mode == "graph", reps, first)
                    else:
                        r[mode][ab] = timed_level(
                            lambda i, ab=ab: knockout(body_name, ab, i), inp,
                            dev, 2, first)
            r["max_abs_err"] = max(errs)
            base, gbase = r["eager"]["none"], r["graph"]["none"]
            r["share"] = {ab: (gbase - r["graph"][ab]) / gbase
                          for ab in ("route", "bins", "adds")}
            r["launch_share"] = 1.0 - gbase / base
            if L == 1:
                per_l1 = base
            r["vs_L1"] = None if per_l1 is None else 1.0 - base / per_l1
            out.append(r)
            print(f"{body_name} L={L}: {base:8.4f} ms/level eager, "
                  f"{r['graph']['none']:8.4f} graph; shares of the "
                  f"graph's: route "
                  f"{r['share']['route']:+.3f} / bins "
                  f"{r['share']['bins']:+.3f} / adds "
                  f"{r['share']['adds']:+.3f}; launch overhead the graph "
                  f"saves {100 * r['launch_share']:5.1f}%; OK vs plain, "
                  f"max abs err {r['max_abs_err']:.3g}"
                  + ("" if r["vs_L1"] is None or L == 1 else
                     f", eager vs L=1 {100 * r['vs_L1']:+5.1f}%"),
                  flush=True)
        del inp
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    device_arg(ap)
    ap.add_argument("--levels", default="",
                    help="P3: chain lengths, e.g. 1,2,4")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--bodies", default="grouped_adaptive,wide_adaptive",
                    help="P2's bodies (_probes.BODIES), or all")
    ap.add_argument("--nodes", default=str(N),
                    help="the levels' node counts, e.g. 32,2")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    cpu = dev.type == "cpu"
    if args.levels:
        levels = [max(1, int(v)) for v in args.levels.split(",")]
        rows = args.rows or (4096 if cpu else LROWS)
        out = {"levels": levels_run(dev, levels, rows, F, args.reps)}
        if cpu:
            print("(CPU: the plain versions' times on the host, not the "
                  "card's; no graph)")
        return out
    rows = args.rows or (4096 if cpu else ROWS)
    bodies = list(BODIES) if args.bodies == "all" else args.bodies.split(",")
    nodes = [int(v) for v in args.nodes.split(",")]
    res = []
    for body_name in bodies:
        for n in nodes:
            r = attribute(body_name, rows, F, n, dev, 1300 + n, args.reps,
                          extras=n == nodes[0])
            print_attribution(r)
            res.append(r)
            if not cpu:
                torch.cuda.empty_cache()
    if cpu:
        print("(CPU: the plain versions' times on the host, not the card's)")
    return {"attribution": res}


if __name__ == "__main__":
    out = main()
    print(json.dumps(out, default=float), file=sys.stderr)
