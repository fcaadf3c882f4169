"""P5: a lane gather against a one-hot product lookup of a table.

Hopper counterpart of ``tools/kern_gather_probe.py`` (the JAX package's
TPU probe): ``out[2F, rows] = tab[2F, N][:, idx]``, F 28, N 32, float32,
2,500,608 rows, idx in [0, N) (any other index gives 0). Two kernels
(``tools/csrc/probes.cu``): ``gather_probe_kernel``, the table in shared
memory and a thread a row (exact); ``onehot_probe_kernel``, bf16(tab) ·
onehot(idx) on the tensor cores (mma.sync m16n8k16), exact for the
bf16-rounded table, as the TPU kernel's one-hot matmul. Each one's first
output is held to its plain version, bit for bit. Prints ms and rows/s
of each, the bound (idx read and out written once, over 3.35 TB/s) and one
``torch.index_select``; idx is fed back between reps as the JAX probe's.

Run: ``python -m h2o3_tpu_torch.tools.kern_gather_probe [--device cpu]``.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from h2o3_tpu_torch.tools import (HBM_BYTES_PER_S, _probes, device_arg,
                                  fed_ms, resolve, time_ms)

ROWS = 2_500_608
F, N = 28, 32
REPS = 40


def gather_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the gather: ``tab[:, idx]``, 0 where idx lies
    outside [0, N)."""
    ok = (idx >= 0) & (idx < tab.shape[1])
    return torch.where(ok[None, :], tab[:, idx.clamp(0, tab.shape[1] - 1)
                                        .long()], 0.0)


def onehot_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the one-hot product: the gather of the table
    rounded to bf16 (one nonzero product a sum, so exact)."""
    return gather_plain(tab.to(torch.bfloat16).float(), idx)


def lookup(tab, idx, onehot: bool):
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    if tab.device.type == "cpu":
        return (onehot_plain if onehot else gather_plain)(tab, idx)
    return _probes.gather_probe(tab, idx, onehot)


def check(tab, idx, onehot: bool, out) -> float:
    """The kernel's ``out`` against its plain version, bit for bit.
    Returns the largest absolute difference (0); raises on any."""
    plain = (onehot_plain if onehot else gather_plain)(tab, idx)
    if not torch.equal(out, plain):
        name = "onehot_probe" if onehot else "gather_probe"
        raise AssertionError(f"{name} at {idx.shape[0]} rows: not bit-equal "
                             f"to its plain version (max abs err "
                             f"{float((out - plain).abs().max())})")
    return 0.0


def operands(rows: int, dev):
    """The JAX probe's table and indices from numpy's generator (seed 0)."""
    rng = np.random.default_rng(0)
    tab = torch.from_numpy(rng.normal(size=(2 * F, N)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, N, rows).astype(np.int32))
    return tab.to(dev), idx.to(dev)


def idx_fed_ms(fn, idx, dev, reps: int, first=None) -> float:
    """Median ms of ``fn(idx)``, idx fed back between reps as the JAX
    probe's ((idx + out[0] mod 2) mod N; ``tools.fed_ms``); the first
    output, on ``idx``, goes to ``first(out)``."""
    state = [idx]

    def feed(out):
        state[0] = ((state[0] + out[0].to(torch.int32) % 2) % N).to(
            torch.int32)
    return fed_ms(lambda: fn(state[0]), feed, dev, reps, first)


def bound_ms(rows: int) -> float:
    return (rows * (4 + 2 * F * 4) + 2 * F * N * 4) / HBM_BYTES_PER_S * 1e3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    device_arg(ap)
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    cpu = dev.type == "cpu"
    rows = args.rows or (4096 if cpu else ROWS)
    tab, idx = operands(rows, dev)
    out = {"rows": rows, "bound_ms": bound_ms(rows)}
    for name, onehot in (("lane-gather", False), ("onehot-matmul", True)):
        errs = []
        ms = idx_fed_ms(lambda i, o=onehot: lookup(tab, i, o), idx, dev,
                        2 if cpu else args.reps,
                        lambda r, o=onehot: errs.append(check(tab, idx, o,
                                                              r)))
        out[name] = ms
        out[f"{name} max_abs_err"] = errs[0]
        print(f"{name}: {ms:.4f} ms ({rows / ms / 1e3:.0f} M rows/s), "
              f"bit-equal to its plain version", flush=True)
    if not cpu:
        out["library_ms"] = time_ms(
            lambda: torch.index_select(tab, 1, idx), dev, args.reps)
    print(f"bound {out['bound_ms']:.4f} ms (bytes)"
          + ("" if cpu else f", torch.index_select "
             f"{out['library_ms']:.4f} ms"), flush=True)
    if cpu:
        print("(CPU: the plain versions' times on the host, not the card's)")
    return out


if __name__ == "__main__":
    print(json.dumps(main(), default=float), file=sys.stderr)
