"""P4: phase knock-outs of the tiled [F, rows] adaptive level, timed.

Hopper counterpart of ``tools/kern_ablate_t.py`` (the JAX package's TPU
probe of its transposed adaptive level, K5): the deepest level (N = 32,
28 features, W = 32, 2,500,608 rows, bf16 masses) on the port's tiled body
(``adaptive_level_kernel<32, true, 0>``, ``csrc/adaptive_bins.cuh``), the
production instance ("none", the JAX probe's ``full``) and its knock-outs
``route``, ``ranges``, ``bins`` (the JAX probe's ``repeat`` and
``onehot``: the bins without the value load and re-bin) and ``adds`` (its
``matmul``), defined and held to their plain versions in ``kern_ablate``.
Prints ms a level, rows/s and each delta from the base, the bound and one
``index_add_``.

Run: ``python -m h2o3_tpu_torch.tools.kern_ablate_t [names...]
[--device cpu]``.
"""
from __future__ import annotations

import argparse
import json
import sys

from h2o3_tpu_torch.tools import device_arg, kern_ablate, resolve

ROWS = 2_500_608
F, W, N = 28, 32, 32
REPS = 10
BODY = "tiled_adaptive"
# the JAX probe's variant names, as knock-outs of the port's body
ALIASES = {"full": "none", "repeat": "bins", "onehot": "bins",
           "matmul": "adds"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    device_arg(ap)
    ap.add_argument("names", nargs="*",
                    help="the knock-outs to run beside the production "
                         "instance (route ranges bins adds, or the JAX "
                         "probe's repeat onehot matmul); all by default")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    rows = args.rows or (4096 if dev.type == "cpu" else ROWS)
    names = list(dict.fromkeys(ALIASES.get(n, n) for n in args.names))
    res = kern_ablate.attribute(BODY, rows, F, N, dev, 1400, args.reps,
                                ablates=names or None)
    base = res["ms"]["none"]
    for n in res["ms"]:
        t = res["ms"][n]
        delta = "" if n == "none" else f"  delta={base - t:+.4f}ms"
        print(f"{n:8s}: {t:8.4f} ms/level ({rows / t / 1e3:8.1f} M rows/s)"
              f"{delta}", flush=True)
    print(f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}), index_add_ "
          f"{res['library_ms']:.4f} ms, residual {res['residual']:+.3f}",
          flush=True)
    if dev.type == "cpu":
        print("(CPU: the plain versions' times on the host, not the card's)")
    return res


if __name__ == "__main__":
    print(json.dumps(main(), default=float), file=sys.stderr)
