"""Per-shard step timing: compute against collective wait, the port's
counterpart of ``h2o3_tpu/parallel/shardstats.py``.

A sharded level is bulk-synchronous: every data shard builds its
histogram, the data-axis reduce waits for all of them, and a shard that
finishes early waits at the reduce for the slowest. The growers mark
each step (a level): a mark on the lead device before the shards' work
and one after each shard's work, recorded on the shard's stream (a CUDA
event on the card, the host clock on the CPU, where the work is
synchronous). From them, for each step:

- a shard's step time: its completion from the step's start;
- ``wait(shard) = slowest - shard``: the time the shard's result waited
  at the reduce for the straggler. On one card the virtual shards'
  kernels run one after another, so the wait there measures that
  serialisation;
- ``straggler_ratio = slowest / median``.

Metrics (labelled ``{algo=...}``): ``h2o3_shard_step_ms`` and
``h2o3_collective_wait_ms`` (histograms), ``h2o3_straggler_ratio``
(gauge). ``merge_observations`` folds a train's steps into
``model.output["spmd"]["collective"]`` with the JAX package's keys. As
there, recording is a no-op on one shard or with ``H2O3_TELEMETRY=0``;
no mark needs a synchronisation until the train reads them, after its
loop.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch

from h2o3_tpu_torch import telemetry
from h2o3_tpu_torch.telemetry.registry import on_reset

_ALGO_HANDLES: Dict[str, tuple] = {}
on_reset(_ALGO_HANDLES.clear)

# the active recorder of ``recording()``, or None
_ACTIVE: Optional["StepRecorder"] = None


def _algo_handles(algo: str) -> tuple:
    h = _ALGO_HANDLES.get(algo)
    if h is None:
        reg = telemetry.registry()
        lab = {"algo": algo}
        h = _ALGO_HANDLES[algo] = (
            reg.histogram("h2o3_shard_step_ms", lab,
                          help="per-shard step completion times (ms from "
                               "the step's start)",
                          bounds=(0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0,
                                  500.0, 1000.0, 5000.0, 30_000.0)),
            reg.histogram("h2o3_collective_wait_ms", lab,
                          help="per-shard wait at the reduce for the "
                               "slowest shard (ms)",
                          bounds=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                                  50.0, 100.0, 500.0, 5000.0)),
            reg.gauge("h2o3_straggler_ratio", lab,
                      help="slowest/median shard step time, last step"))
    return h


def _mark(dev: torch.device):
    if dev.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(dev))
        return ev
    return time.perf_counter()


def _ms(a, b) -> float:
    if isinstance(a, float):
        return (b - a) * 1e3
    b.synchronize()
    return a.elapsed_time(b)


class StepMarks:
    """One step's marks: a start on the lead device, then one mark a
    shard in shard order."""

    def __init__(self, lead: torch.device):
        self.start = _mark(lead)
        self.done: List = []

    def shard_done(self, dev: torch.device) -> None:
        self.done.append(_mark(dev))

    def times_ms(self) -> List[float]:
        return [_ms(self.start, d) for d in self.done]


class StepRecorder:
    """The marks of a train's steps on a multi-shard mesh."""

    def __init__(self, algo: str):
        self.algo = algo
        self.steps: List[StepMarks] = []

    def summary(self) -> Optional[Dict[str, float]]:
        """Every step observed (metrics recorded) and merged."""
        return merge_observations([observe_sharded_step(s, algo=self.algo)
                                   for s in self.steps])


def recorder(mesh, algo: str) -> Optional[StepRecorder]:
    """A recorder for a train on ``mesh``, or None where nothing is
    observed (one data shard, or telemetry off)."""
    from h2o3_tpu_torch.parallel.mesh import n_data_shards
    if mesh is None or n_data_shards(mesh) <= 1 or not telemetry.enabled():
        return None
    return StepRecorder(algo)


@contextlib.contextmanager
def recording(rec: Optional[StepRecorder]):
    """Make ``rec`` the recorder the growers' steps report to."""
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, rec
    try:
        yield rec
    finally:
        _ACTIVE = prev


def step_begin(lead: torch.device) -> Optional[StepMarks]:
    """A new step's marks where a recorder is active, else None."""
    if _ACTIVE is None:
        return None
    marks = StepMarks(lead)
    _ACTIVE.steps.append(marks)
    return marks


def observe_sharded_step(marks: StepMarks, *, algo: str = "gbm"
                         ) -> Optional[Dict[str, float]]:
    """Record one step's per-shard step and wait metrics; returns its
    summary, or None with telemetry off or fewer than two shards."""
    if not telemetry.enabled() or marks is None or len(marks.done) < 2:
        return None
    times_ms = sorted(marks.times_ms())
    slowest = times_ms[-1]
    n = len(times_ms)
    median = (times_ms[n // 2] if n % 2 else
              0.5 * (times_ms[n // 2 - 1] + times_ms[n // 2]))
    ratio = slowest / median if median > 0 else 1.0
    waits = [slowest - t for t in times_ms]
    step_h, wait_h, ratio_g = _algo_handles(algo)
    for t in times_ms:
        step_h.observe(t)
    for w in waits:
        wait_h.observe(w)
    ratio_g.set(ratio)
    mean_wait = sum(waits) / n
    return {
        "n_shards": n,
        "slowest_ms": round(slowest, 3),
        "median_ms": round(median, 3),
        "straggler_ratio": round(ratio, 4),
        "collective_wait_ms": round(mean_wait, 3),
        "collective_wait_share": round(mean_wait / slowest, 4)
        if slowest > 0 else 0.0,
    }


def merge_observations(obs: List[Optional[Dict[str, float]]]
                       ) -> Optional[Dict[str, float]]:
    """Fold per-step observations into one per-train summary (the JAX
    package's keys, its "chunks" being the port's steps): waits and step
    times average over steps, the straggler ratio reports the worst. The
    JAX keys of stale and censored shards are left out: every step of
    the port completes on every shard before its reduce, so it has
    neither."""
    obs = [o for o in obs if o]
    if not obs:
        return None
    n = len(obs)
    return {
        "chunks_observed": n,
        "n_shards": obs[0]["n_shards"],
        "straggler_ratio": round(max(o["straggler_ratio"] for o in obs), 4),
        "straggler_ratio_mean": round(
            sum(o["straggler_ratio"] for o in obs) / n, 4),
        "collective_wait_ms": round(
            sum(o["collective_wait_ms"] for o in obs) / n, 3),
        "collective_wait_share": round(
            sum(o["collective_wait_share"] for o in obs) / n, 4),
        "slowest_ms": round(max(o["slowest_ms"] for o in obs), 3),
    }
