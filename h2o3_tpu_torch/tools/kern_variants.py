"""P6: a shootout of the port's forms of the deepest adaptive level.

Hopper counterpart of ``tools/kern_variants.py`` (the JAX package's TPU
probe): the deepest adaptive level (N = 32, n_prev 16, 28 features, W = 32,
10,002,432 rows, bf16 masses) in every form the port has of it:

- ``grouped``: the tensor-core grouped body, the form the training path's
  wrapper picks here (``kernels.adaptive_level``);
- ``wide``, ``tiled``: the wide body and the tiled body, forced
  (``kernels.adaptive_level_form``);
- ``atomics``: the grouped body with shared float atomics in place of its
  products (``kernels.adaptive_level_atomics``);
- ``noroute``, ``noloinv``: the grouped body's route and ranges
  knock-outs (``kern_ablate``; the JAX probe's variants of those names).

Each is timed (ms a level, nid fed back between reps) and its first
output held to its plain version on the same inputs (nid bit-equal; each
bin within 1e-4 + 1e-5 x its absolute mass of the plain version in
float64).

Run: ``python -m h2o3_tpu_torch.tools.kern_variants [--device cpu]``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from h2o3_tpu_torch.ops import kernels
from h2o3_tpu_torch.ops.hist_adaptive import adaptive_level_plain
from h2o3_tpu_torch.tools import device_arg, kern_ablate, resolve

ROWS = 10_002_432
F, W, N = 28, 32, 32
REPS = 10
BODY = "grouped_adaptive"
VARIANTS = ("grouped", "wide", "tiled", "atomics", "noroute", "noloinv")
_KNOCKOUT = {"noroute": "route", "noloinv": "ranges"}


def variant(name: str, inp, ghw=None):
    """The level in variant ``name`` (``VARIANTS``) on ``inp``'s tensors,
    its masses ``ghw`` where given: the kernels on the card, the plain
    versions on the CPU."""
    i = inp if ghw is None else dataclasses.replace(inp, ghw=ghw)
    if name in _KNOCKOUT:
        return kern_ablate.knockout(BODY, _KNOCKOUT[name], i)
    a = (i.vals, i.nid, i.ghw, i.tables, i.lo, i.inv, i.n_prev, i.n_nodes,
         i.level_base, W, True)
    if i.vals.device.type == "cpu":
        return adaptive_level_plain(*a, "rows_f")
    if name == "grouped":
        return kernels.adaptive_level(*a, "rows_f")
    if name == "atomics":
        return kernels.adaptive_level_atomics(*a)
    return kernels.adaptive_level_form(*a, "rows_f", name)


def variant_plain(name: str, inp, ghw):
    """The plain version of variant ``name`` with masses ``ghw``."""
    return kern_ablate.knockout_plain(BODY, _KNOCKOUT.get(name, "none"),
                                      dataclasses.replace(inp, ghw=ghw))


def check(name: str, inp, out) -> float:
    """Variant ``name``'s output ``out`` on ``inp`` against its plain
    version (``kern_ablate.check_knockout``: nid bit-equal, each bin
    within 1e-4 + 1e-5 x its absolute mass of the plain version in
    float64). Returns the largest absolute difference; raises beyond."""
    return kern_ablate.check_knockout(BODY, _KNOCKOUT.get(name, "none"),
                                      inp, out)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    device_arg(ap)
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    rows = args.rows or (4096 if dev.type == "cpu" else ROWS)
    inp = kern_ablate.level_inputs(BODY, rows, F, N, 1600, dev)
    out = {}
    for name in args.variants.split(","):
        errs = []
        ms = kern_ablate.timed_level(
            lambda i, n=name: variant(n, i), inp, dev, args.reps,
            lambda o, n=name: errs.append(check(n, inp, o)))
        out[name] = {"ms": ms, "max_abs_err": errs[0]}
        print(f"{name:10s}: {ms:8.4f} ms/level  [OK vs plain, max abs err "
              f"{errs[0]:.3g}]", flush=True)
    if dev.type == "cpu":
        print("(CPU: the plain versions' times on the host, not the card's)")
    return out


if __name__ == "__main__":
    print(json.dumps(main(), default=float), file=sys.stderr)
