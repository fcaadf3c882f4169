"""P1: does the histogram-shaped contraction with a small M waste the
tensor core's rows, and does back-to-back issue keep it busy?

Hopper counterpart of ``tools/kern_mxu_probe.py`` (the JAX package's TPU
probe of the MXU): ``out[M, FW] = n_tiles · L[M, TILE] · R[FW, TILE]ᵀ``,
TILE 8192, n_tiles = ROWS // TILE (ROWS 2,500,608), FW 896 (28 features x
32 bins) or 448 (x 16), M in (6, 24, 96, 128, 256), bf16 -> float32 or
int8 -> int32 (``--dt i8``). The kernel (``mxu_probe_kernel``,
``tools/csrc/probes.cu``) stages its operands once and issues the
products n_tiles times from registers (mma.sync m16n8k16 bf16, m16n8k32
s8), so it times issue, not device memory; M is padded to 16-row
fragments. ``--L 4`` chains L dependent contractions (each left operand
perturbed by the previous output), launched eagerly and as one CUDA
graph. Each M's first output is held to the plain version (int8 exact,
bf16 within 1e-5 x the absolute mass). Prints ms a contraction (queued
back to back: the device's time; eager and graph windows: with and without
the host's launch time), TFLOP/s (TOP/s), the bound (2 M FW K
n_tiles operations at NVIDIA's data-sheet dense peak of the H100 SXM, 989
TFLOP/s bf16 or 1979 TOP/s int8) and one ``torch.matmul`` (``torch._int_mm``
for int8) of L · Rᵀ, the same function once.

Run: ``python -m h2o3_tpu_torch.tools.kern_mxu_probe [M ...] [--dt i8]
[--fw 448] [--L 4] [--device cpu]``.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from h2o3_tpu_torch.tools import (_probes, device_arg, resolve, time_ms,
                                  window_ms)

ROWS = 2_500_608
TILE = 8192
FW = 896
REPS = 40
MS = (6, 24, 96, 128, 256)
PEAK_OPS_PER_S = {"bf16": 989e12, "i8": 1979e12}  # H100 SXM, dense


def operands(M: int, FW: int, tile: int, dt: str, dev):
    """The JAX probe's operands from numpy's generator (seed 0): bf16
    normal L and R, or int8 L in [-127, 127) and R in {0, 1}."""
    rng = np.random.default_rng(0)
    if dt == "i8":
        L = rng.integers(-127, 127, size=(M, tile)).astype(np.int8)
        R = rng.integers(0, 2, size=(FW, tile)).astype(np.int8)
        return torch.from_numpy(L).to(dev), torch.from_numpy(R).to(dev)
    L = torch.from_numpy(rng.normal(size=(M, tile)).astype(np.float32))
    R = torch.from_numpy(rng.normal(size=(FW, tile)).astype(np.float32))
    return (L.to(torch.bfloat16).to(dev), R.to(torch.bfloat16).to(dev))


def mxu_plain(L: torch.Tensor, R: torch.Tensor, n_tiles: int):
    """Plain version: ``n_tiles · L @ R.T`` in float64, returned as float32
    (bf16 operands) or int32 (int8: every product sum is an integer below
    2^53, so float64 holds it exactly, and |sum| < 2^31 at the probe's
    shapes)."""
    if L.dtype == torch.int8:
        p = (L.double() @ R.double().t()).long()
        return (p * n_tiles).to(torch.int32)
    p = L.double() @ R.double().t()
    return (p * n_tiles).to(torch.float32)


def check(L, R, n_tiles: int, out) -> float:
    """The kernel's ``out`` against the plain version: int8 exact; bf16
    within 1e-5 x the absolute mass (n_tiles · |L| |R|ᵀ in float64) of the
    float64 product (float32 sums in another order). Returns the largest
    absolute difference; raises beyond."""
    what = f"mxu_probe M={L.shape[0]} FW={R.shape[0]} K={L.shape[1]}"
    p = mxu_plain(L, R, n_tiles)
    if L.dtype == torch.int8:
        if not torch.equal(out, p):
            raise AssertionError(f"{what} int8: not exact")
        return 0.0
    ref = n_tiles * (L.double() @ R.double().t())
    mass = n_tiles * (L.double().abs() @ R.double().abs().t())
    err = (out.double() - ref).abs()
    if float((err - 1e-5 * mass).max()) > 0:
        raise AssertionError(f"{what} bf16: max abs err {float(err.max())} "
                             f"beyond 1e-5 x mass")
    return float(err.max())


def mxu(L, R, n_tiles):
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    if L.device.type == "cpu":
        return mxu_plain(L, R, n_tiles)
    return _probes.mxu_probe(L, R, n_tiles)


def perturb(L: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The next left operand of a chain: L plus out[0, 0] x 1e-20 (bf16),
    or L xor (out[0, 0] mod 2) (int8): a data dependence, as the JAX
    probe's."""
    if L.dtype == torch.int8:
        return L ^ (out[0, 0] % 2).to(torch.int8)
    return L + (out[0, 0] * 1e-20).to(torch.bfloat16)


def chained(L, R, n_tiles: int, chain: int, fn=None):
    """``chain`` dependent contractions by ``fn`` (the kernel, or
    ``mxu_plain``), each left operand perturbed by the previous output;
    returns the last output."""
    fn = fn or mxu
    x = L
    for _ in range(chain):
        out = fn(x, R, n_tiles)
        x = perturb(x, out)
    return out


def chain_ms(L, R, n_tiles, chain: int, dev, graph: bool, reps: int,
             first=None):
    """Median ms a contraction of ``chain`` dependent contractions,
    launched eagerly or as one CUDA graph (``tools.window_ms``); the first
    eager chain's last output goes to ``first(out)``."""
    def window():
        return chained(L, R, n_tiles, chain)
    if dev.type == "cpu":
        return time_ms(window, dev, 2, first) / chain
    return window_ms(window, chain, dev, graph, reps, first)


def chain_check(L, R, n_tiles: int, chain: int, out) -> float:
    """A chain's last output against the chain of plain versions
    (``check`` on the last one's operands)."""
    x = L
    for _ in range(chain - 1):
        x = perturb(x, mxu_plain(x, R, n_tiles))
    return check(x, R, n_tiles, out)


def library_ms(L, R, dev, reps):
    """One torch call of L · Rᵀ (the probe's function once, unscaled):
    ``torch.matmul`` at bf16, ``torch._int_mm`` at int8 where it takes the
    shapes (M > 16, a multiple of 8), else None."""
    if dev.type == "cpu":
        return None
    if L.dtype == torch.int8:
        if L.shape[0] <= 16 or L.shape[0] % 8:
            return None
        Rt = R.t()
        try:   # a yardstick only: where this build of torch refuses it
            return time_ms(lambda: torch._int_mm(L, Rt), dev, reps)
        except RuntimeError as e:
            print(f"torch._int_mm refused M={L.shape[0]}: {e}", flush=True)
            return None
    return time_ms(lambda: torch.matmul(L, R.t()), dev, reps)


def run(M: int, dt: str, fw: int, rows: int, tile: int, chain: int, dev,
        reps: int, graph: bool = True) -> dict:
    L, R = operands(M, fw, tile, dt, dev)
    n_tiles = rows // tile
    ops = 2 * M * fw * tile * n_tiles
    errs = []

    def first(out):
        errs.append(chain_check(L, R, n_tiles, chain, out))
    res = {"M": M, "dt": dt, "FW": fw, "L": chain,
           "ms": time_ms(lambda: chained(L, R, n_tiles, chain), dev, reps,
                         first) / chain,
           "eager_ms": chain_ms(L, R, n_tiles, chain, dev, False, reps,
                                first)}
    if graph and dev.type == "cuda":
        res["graph_ms"] = chain_ms(L, R, n_tiles, chain, dev, True, reps)
    res["max_abs_err"] = max(errs)
    res["bound_ms"] = ops / PEAK_OPS_PER_S[dt] * 1e3
    res["library_ms"] = library_ms(L, R, dev, reps)
    res["rate"] = ops / (res["ms"] * 1e-3) / 1e12
    tag = f" L={chain}" if chain > 1 else ""
    unit = "TOP/s" if dt == "i8" else "TFLOP/s"
    g = (f", graph {res['graph_ms']:7.3f}" if "graph_ms" in res else "")
    lib = ("" if res["library_ms"] is None else
           f", one library product {res['library_ms']:.4f} ms")
    print(f"M={M:4d}:{tag} {res['ms']:7.3f} ms/contraction queued, eager "
          f"{res['eager_ms']:7.3f}{g} ({res['rate']:6.1f} {unit}; bound "
          f"{res['bound_ms']:.3f} ms, operations){lib}; OK vs plain, max "
          f"abs err {res['max_abs_err']:.3g}", flush=True)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    device_arg(ap)
    ap.add_argument("M", nargs="*", type=int)
    ap.add_argument("--dt", default="bf16", choices=("bf16", "i8"))
    ap.add_argument("--fw", type=int, default=FW)
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--tile", type=int, default=None)
    ap.add_argument("--L", type=int, default=1, dest="chain")
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    cpu = dev.type == "cpu"
    tile = args.tile or (512 if cpu else TILE)
    rows = args.rows or (4 * tile if cpu else ROWS)
    out = [run(M, args.dt, args.fw, rows, tile, max(1, args.chain), dev,
               2 if cpu else args.reps) for M in (args.M or MS)]
    if cpu:
        print("(CPU: the plain version's times on the host, not the card's)")
    return {"mxu": out}


if __name__ == "__main__":
    print(json.dumps(main(), default=float), file=sys.stderr)
