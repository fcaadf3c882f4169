"""The port's probe tools: Hopper counterparts of the JAX package's TPU
probes (``tools/kern_*.py``), one module each under the same name, each an
entry point (``python -m h2o3_tpu_torch.tools.kern_ablate`` and so on):

- ``kern_mxu_probe`` (P1): the histogram-shaped contraction at several M
  on the tensor cores, idle rows and back-to-back issue;
- ``kern_gather_probe`` (P5): a shared-memory gather against a one-hot
  product lookup of a [2F, N] table by a per-row index;
- ``kern_ablate`` (P2, P3): phase knock-outs of the port's own level
  bodies (``csrc/level_grouped.cuh``, ``csrc/level_wide.cuh``; float and
  int8 masses) and their attribution, and the packed level chained L
  levels as one CUDA graph against L eager launches;
- ``kern_ablate_t`` (P4): the same for the tiled ``[F, rows]`` body;
- ``kern_variants`` (P6): the deepest adaptive level in every form the
  port has, each checked against its plain version.

They run on the card unless the caller passes ``--device cpu``; on the
CPU they run the plain versions at a small size. Without a card and
without ``--device cpu`` they raise. The kernels
(``tools/csrc/probes.cu``) are built at first use, apart from the training
path's (``ops/kernels.py``); the module ``_probes`` binds them.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

# NVIDIA's data-sheet rates of the H100 SXM, for the bounds the tools print
HBM_BYTES_PER_S = 3.35e12     # device memory
F32_OPS_PER_S = 67e12         # float32 outside the tensor cores


def device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="cuda (the default: the kernels, timed with "
                             "CUDA events) or cpu (the plain versions at a "
                             "small size)")


def resolve(name: str) -> torch.device:
    """The device a tool runs on: "cpu" when asked for, else the card,
    which must be there."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("the probe tools run on a CUDA device; none is "
                           "available (pass --device cpu for the plain "
                           "versions)")
    return torch.device("cuda")


# Device cycles the card waits (about 15 ms at 1.98 GHz) before the
# timed calls of ``fed_ms`` run, so that the host queues them ahead
QUEUE_CYCLES = 30_000_000


def fed_ms(run, feed, dev: torch.device, reps: int = 10,
           first=None) -> float:
    """Median milliseconds of ``run()`` over ``reps`` calls after one
    warm-up, whose output goes to ``first(out)`` where given (a check of
    the timed inputs' result); ``feed(out)`` gets each call's output
    before the next, out of the timed window. On the card the calls are
    queued back to back behind a device-side wait, each between its own
    pair of CUDA events: the host queues a call while the device runs the
    ones before it, so a window holds the device's time for the call and
    not the host's (the wrapper's planning, its ctypes calls and
    allocations). On the CPU the host clock (a plain version's time, not
    the card's)."""
    out = run()
    if first is not None:
        first(out)
    if dev.type != "cuda":
        times = []
        for _ in range(reps):
            feed(out)
            t0 = time.perf_counter()
            out = run()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(statistics.median(times))
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize(dev)
    torch.cuda._sleep(QUEUE_CYCLES)
    for a, b in pairs:
        feed(out)
        a.record()
        out = run()
        b.record()
    torch.cuda.synchronize(dev)
    return float(statistics.median(a.elapsed_time(b) for a, b in pairs))


def time_ms(fn, dev: torch.device, reps: int = 10, first=None) -> float:
    """``fed_ms`` of ``fn`` with nothing fed back."""
    return fed_ms(fn, lambda out: None, dev, reps, first)


def window_ms(window, steps: int, dev: torch.device, graph: bool,
              reps: int = 10, first=None) -> float:
    """Median milliseconds a step of ``window()``, which runs ``steps``
    dependent steps, each window between CUDA events after a synchronize
    (so that the launches' host time shows): launched eagerly, or
    (``graph``) captured once as a CUDA graph and replayed. The first
    eager window's output goes to ``first(out)`` where given."""
    out = window()
    if first is not None:
        first(out)
    run = window
    if graph:
        s = torch.cuda.Stream(dev)
        s.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(s):
            window()
        torch.cuda.current_stream(dev).wait_stream(s)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="relaxed"):
            window()
        run = g.replay
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(statistics.median(times)) / steps
