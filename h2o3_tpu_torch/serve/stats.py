"""Per-deployment serving telemetry — views over the metrics registry.

A copy of ``h2o3_tpu/serve/stats.py`` on the port's registry
(``h2o3_tpu_torch.telemetry``): every mutation lands in lock-striped
registry metrics labeled ``{model=<key>}``, so the same numbers reach
``serve.stats()`` and any export of the registry.

The latency reservoir (exact p50/p99 over the recent window) stays
local: quantiles don't reconstruct from fixed histogram buckets at the
precision the SLO view needs. The registry additionally gets a bucketed
``h2o3_serve_latency_ms`` histogram.

When the global registry is disabled (``H2O3_TELEMETRY=0``) a
deployment falls back to a PRIVATE always-on registry: ``serve.stats()``
keeps answering while nothing reaches the exported surface.

Lock discipline: registry metrics use the striped locks; only the
reservoir keeps a per-deployment mutex, with every critical section a
couple of array writes.
"""
from __future__ import annotations

import heapq
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from h2o3_tpu_torch.telemetry import registry as _global_registry
from h2o3_tpu_torch.telemetry.registry import Registry

# ring-buffer length for the latency reservoir: enough for stable p99
# estimates over the recent window without unbounded growth
_RESERVOIR = 4096

# per-lane latency reservoirs are smaller: three of them per
# deployment, and the lane-isolation verdict only needs a stable p99
# over the recent window, not deep history
_LANE_RESERVOIR = 2048

# slow-request exemplars kept per deployment: the top-k requests by
# latency, each carrying its trace id — serve.stats() exposes them so a
# p99 spike resolves to concrete trace ids (the spans that carry them
# wait for ROADMAP.md queue 1, item 21)
_SLOW_K = 10

# exemplar generations also rotate on wall clock, not just reservoir
# wrap: at low QPS 4096 requests can take DAYS, and a cold-start
# compile-era top-k would mask every later spike until then (their
# trace ids pointing at spans long evicted from the ring)
_SLOW_WINDOW_S = 900.0

STAGES = ("encode", "queue", "device", "decode")

# serve latency histogram bounds in ms (sub-ms micro-batch ticks up to
# deadline-scale)
_LAT_BOUNDS_MS = (0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 25.0, 50.0, 100.0,
                  250.0, 1000.0, 10_000.0)


_ANON = [0]
_ANON_LOCK = threading.Lock()


class ServeStats:
    def __init__(self, model: str = ""):
        if not model:
            # anonymous stats (embedded/unit-test use) get a unique
            # label — sharing one "?" series across instances would
            # break the fresh-counters-per-instance contract
            with _ANON_LOCK:
                _ANON[0] += 1
                model = f"_anon_{_ANON[0]}"
        self.model = model
        reg = _global_registry()
        if not reg.enabled:
            # private always-on registry: the serve stats surface must
            # not go dark when exported telemetry is off
            reg = Registry(enabled=True)
        self._reg = reg
        lab = {"model": self.model}
        self._requests = reg.counter(
            "h2o3_serve_requests_total", lab,
            help="client-visible serve requests")
        self._rows = reg.counter(
            "h2o3_serve_rows_total", lab, help="rows scored")
        self._batches = reg.counter(
            "h2o3_serve_batches_total", lab,
            help="device batches dispatched")
        self._batch_rows = reg.counter(
            "h2o3_serve_batch_rows_total", lab,
            help="live rows across dispatched batches")
        self._padded_rows = reg.counter(
            "h2o3_serve_padded_rows_total", lab,
            help="bucket-padded rows across dispatched batches")
        self._errors = reg.counter(
            "h2o3_serve_errors_total", lab,
            help="scoring failures surfaced to clients")
        self._timeouts = reg.counter(
            "h2o3_serve_timeouts_total", lab,
            help="per-request deadline expiries")
        self._rejected = reg.counter(
            "h2o3_serve_rejected_total", lab,
            help="admission-control rejections (503)")
        self._retries = reg.counter(
            "h2o3_serve_retries_total", lab,
            help="single-retry recoveries of transient device-stage "
                 "failures")
        self._queue_depth = reg.gauge(
            "h2o3_serve_queue_depth", lab,
            help="rows admitted but not yet resolved")
        self._stage_ms = {s: reg.counter(
            "h2o3_serve_stage_ms_total", {**lab, "stage": s},
            help="cumulative per-stage milliseconds") for s in STAGES}
        self._latency = reg.histogram(
            "h2o3_serve_latency_ms", lab,
            help="request latency milliseconds", bounds=_LAT_BOUNDS_MS)
        self._mu = threading.Lock()
        self._lat_ms = np.zeros(_RESERVOIR, np.float64)
        self._lat_n = 0            # total recorded (ring index = n % size)
        # deadline-class lanes: per-lane latency reservoirs
        # (created on first use — a deployment that never sees a lane
        # pays nothing for it) + shed counters, so the lane-isolation
        # contract (interactive p99 under a bulk flood) is measurable
        # from serve.stats() alone
        self._lane_lat: Dict[str, np.ndarray] = {}
        self._lane_n: Dict[str, int] = {}
        self._lane_shed: Dict[str, object] = {}
        self._lane_shed_base: Dict[str, float] = {}
        # top-k slow-request exemplars: a min-heap of
        # (latency_ms, seq, info) — seq breaks latency ties so the heap
        # never compares the info dicts. Two generations: the previous
        # reservoir window's heap is kept until the next wrap, so a
        # spike stays scrapeable for at least one full window even at
        # high QPS (an instant clear would wipe it before any poll)
        self._slow: List[tuple] = []
        self._slow_prev: List[tuple] = []
        self._slow_seq = 0
        self._slow_t0 = time.monotonic()   # current generation's start
        # queue depth is an INSTANTANEOUS property of this deployment's
        # batcher, not a monotonic series: keep the authoritative value
        # per instance (fresh at redeploy, immune to a drained old
        # deployment's late decrements) and mirror it to the gauge for
        # the registry's export
        self._qd = 0
        # redeploying a key reuses the registry series (exported
        # counters are monotonic per model) — but THIS deployment's view
        # starts fresh: snapshot/compat properties report deltas against
        # the construction-time baseline
        self._base = {c: c.value for c in
                      (self._requests, self._rows, self._batches,
                       self._batch_rows, self._padded_rows, self._errors,
                       self._timeouts, self._rejected, self._retries,
                       *self._stage_ms.values())}

    def _delta(self, c) -> float:
        return c.value - self._base.get(c, 0.0)

    # -- mutation (hot path) -------------------------------------------

    def record_request(self, latency_ms: float, rows: int,
                       trace_id: Optional[str] = None,
                       lane: Optional[str] = None):
        # reservoir honors the same enabled flag as the counters: a
        # runtime set_enabled(False) freezes the WHOLE stats surface
        # consistently instead of a moving p50 over frozen counters
        if self._reg.enabled:
            with self._mu:
                self._lat_ms[self._lat_n % _RESERVOIR] = latency_ms
                self._lat_n += 1
                self._note_slow_locked(self._lat_n % _RESERVOIR == 0,
                                       latency_ms, rows, trace_id)
                if lane is not None:
                    ring = self._lane_lat.get(lane)
                    if ring is None:
                        ring = self._lane_lat[lane] = np.zeros(
                            _LANE_RESERVOIR, np.float64)
                        self._lane_n[lane] = 0
                    ring[self._lane_n[lane] % _LANE_RESERVOIR] = \
                        latency_ms
                    self._lane_n[lane] += 1
        self._requests.inc()
        self._rows.inc(rows)
        self._latency.observe(latency_ms)

    def record_lane_shed(self, lane: str):
        """A non-interactive lane's queue budget shed a request
        — counted per lane so a bulk flood's shed rate is
        distinguishable from genuine whole-queue overload."""
        c = self._lane_shed.get(lane)
        if c is None:
            c = self._lane_shed[lane] = self._reg.counter(
                "h2o3_serve_lane_shed_total",
                {"model": self.model, "lane": lane},
                help="requests shed by a lane's queue budget")
            self._lane_shed_base[lane] = c.value
        c.inc()

    def record_failed_exemplar(self, latency_ms: float, rows: int,
                               trace_id: Optional[str],
                               error: str):
        """Failed requests (deadline blowouts, device errors) are by
        construction among the slowest responses — exactly the ones a
        latency investigation chases — so they enter the slow-request
        exemplars (flagged ``error=``) WITHOUT touching the
        success-only latency reservoir, percentile estimates or
        request counters (failures are
        counted by record_error/record_timeout)."""
        if self._reg.enabled:
            with self._mu:
                self._note_slow_locked(False, latency_ms, rows,
                                       trace_id, error)

    def _note_slow_locked(self, wrapped: bool, latency_ms: float,
                          rows: int, trace_id: Optional[str],
                          error: Optional[str] = None):
        if wrapped or \
                time.monotonic() - self._slow_t0 >= _SLOW_WINDOW_S:
            # age the exemplars with the reservoir window OR the wall
            # clock, whichever wraps first: an all-time top-k would let
            # cold-start compile latencies mask every later spike (and
            # their trace ids point at spans long evicted from the
            # ring). The wrap trigger is passed in by record_request
            # (tied to reservoir advancement) so failure-only traffic
            # cannot spuriously rotate at _lat_n == 0.
            self._slow_prev = self._slow
            self._slow = []
            self._slow_t0 = time.monotonic()
        # steady-state fast path: beyond the one monotonic read for
        # generation aging above, requests that cannot enter the top-k
        # allocate nothing
        if len(self._slow) < _SLOW_K or latency_ms > self._slow[0][0]:
            self._slow_seq += 1
            info = {"trace_id": trace_id,
                    "latency_ms": round(float(latency_ms), 3),
                    "rows": int(rows), "time": time.time()}
            if error is not None:
                info["error"] = error
            entry = (float(latency_ms), self._slow_seq, info)
            if len(self._slow) < _SLOW_K:
                heapq.heappush(self._slow, entry)
            else:
                heapq.heapreplace(self._slow, entry)

    def record_batch(self, live_rows: int, padded_rows: int,
                     stage_ms: Dict[str, float]):
        self._batches.inc()
        self._batch_rows.inc(live_rows)
        self._padded_rows.inc(padded_rows)
        for s, v in stage_ms.items():
            c = self._stage_ms.get(s)
            if c is None:
                c = self._stage_ms[s] = self._reg.counter(
                    "h2o3_serve_stage_ms_total",
                    {"model": self.model, "stage": s})
                self._base.setdefault(c, c.value)
            c.inc(v)

    def record_error(self):
        self._errors.inc()

    def record_timeout(self):
        self._timeouts.inc()

    def record_rejected(self):
        self._rejected.inc()

    def record_retry(self):
        self._retries.inc()

    def queue_delta(self, rows: int):
        with self._mu:
            self._qd += rows
            qd = self._qd
        self._queue_depth.set(qd)

    # -- compat properties (tests and callers read these as ints) ------

    @property
    def requests(self) -> int:
        return int(self._delta(self._requests))

    @property
    def rows(self) -> int:
        return int(self._delta(self._rows))

    @property
    def batches(self) -> int:
        return int(self._delta(self._batches))

    @property
    def batch_rows(self) -> int:
        return int(self._delta(self._batch_rows))

    @property
    def padded_rows(self) -> int:
        return int(self._delta(self._padded_rows))

    @property
    def errors(self) -> int:
        return int(self._delta(self._errors))

    @property
    def timeouts(self) -> int:
        return int(self._delta(self._timeouts))

    @property
    def rejected(self) -> int:
        return int(self._delta(self._rejected))

    @property
    def retries(self) -> int:
        return int(self._delta(self._retries))

    @property
    def queue_depth(self) -> int:
        with self._mu:
            return self._qd

    @property
    def stage_ms(self) -> Dict[str, float]:
        return {s: self._delta(c) for s, c in self._stage_ms.items()}

    # -- snapshot -------------------------------------------------------

    def percentiles_ms(self, qs: List[float]) -> List[Optional[float]]:
        """All requested quantiles from ONE copy of the latency ring —
        separate calls would sample different windows under concurrent
        recording (a snapshot could then report p99 < p50)."""
        with self._mu:
            n = min(self._lat_n, _RESERVOIR)
            window = self._lat_ms[:n].copy() if n else None
        if window is None:
            return [None] * len(qs)
        return [float(np.percentile(window, q)) for q in qs]

    def percentile_ms(self, q: float) -> Optional[float]:
        return self.percentiles_ms([q])[0]

    def lane_percentiles_ms(self, lane: str,
                            qs: List[float]) -> List[Optional[float]]:
        """Per-lane quantiles, one copy of the lane ring —
        same single-window discipline as percentiles_ms."""
        with self._mu:
            n = min(self._lane_n.get(lane, 0), _LANE_RESERVOIR)
            ring = self._lane_lat.get(lane)
            window = ring[:n].copy() if (ring is not None and n) else None
        if window is None:
            return [None] * len(qs)
        return [float(np.percentile(window, q)) for q in qs]

    def slow_requests(self) -> List[Dict]:
        """The top-k slowest requests (latency desc), each with its
        trace id — the exemplars serve.stats() exposes so a latency
        spike resolves to concrete trace ids."""
        with self._mu:
            entries = [e[2] for e in self._slow] + \
                      [e[2] for e in self._slow_prev]
        return sorted(entries,
                      key=lambda e: -e["latency_ms"])[:_SLOW_K]

    def snapshot(self) -> Dict:
        p50, p99 = self.percentiles_ms([50, 99])
        # striped-lock counters have no cross-counter atomic read (the
        # price of the striped locks); bound the skew
        # instead: numerators read FIRST, denominators last, so a
        # concurrent record_batch can only make the ratios dip, never
        # report occupancy/fill above the truth (fill > 1.0 clamped)
        batch_rows = self.batch_rows
        padded = self.padded_rows
        batches = self.batches
        occ = (batch_rows / batches) if batches else 0.0
        pad_eff = min((batch_rows / padded) if padded else 1.0, 1.0)
        return {
            "requests": self.requests,
            "rows": self.rows,
            "batches": batches,
            "errors": self.errors,
            "timeouts": self.timeouts,
            "rejected": self.rejected,
            "retries": self.retries,
            "queue_depth": self.queue_depth,
            "mean_batch_occupancy": round(occ, 3),
            "bucket_fill": round(pad_eff, 4),
            "p50_ms": None if p50 is None else round(p50, 3),
            "p99_ms": None if p99 is None else round(p99, 3),
            "stage_ms": {s: round(v, 3)
                         for s, v in self.stage_ms.items()},
            "slow_requests": self.slow_requests(),
            "lanes": self._lane_snapshot(),
        }

    def _lane_snapshot(self) -> Dict[str, Dict]:
        with self._mu:
            lanes = sorted(set(self._lane_n) | set(self._lane_shed))
        out: Dict[str, Dict] = {}
        for ln in lanes:
            p50, p99 = self.lane_percentiles_ms(ln, [50, 99])
            shed_c = self._lane_shed.get(ln)
            shed = 0 if shed_c is None else \
                int(shed_c.value - self._lane_shed_base.get(ln, 0.0))
            out[ln] = {
                "requests": int(self._lane_n.get(ln, 0)),
                "shed": shed,
                "p50_ms": None if p50 is None else round(p50, 3),
                "p99_ms": None if p99 is None else round(p99, 3),
            }
        return out


def merge_snapshots(snaps: List[Dict]) -> Dict:
    """Rollup across deployments for serve.stats(): counters sum; the
    percentile fields do NOT aggregate across models (quantiles don't
    add) and are left to the per-model entries."""
    out = {"requests": 0, "rows": 0, "batches": 0, "errors": 0,
           "timeouts": 0, "rejected": 0, "retries": 0, "queue_depth": 0,
           "stage_ms": {s: 0.0 for s in STAGES}}
    for s in snaps:
        for k in ("requests", "rows", "batches", "errors", "timeouts",
                  "rejected", "retries", "queue_depth"):
            out[k] += s.get(k, 0)
        for st, v in (s.get("stage_ms") or {}).items():
            out["stage_ms"][st] = out["stage_ms"].get(st, 0.0) + v
    out["stage_ms"] = {s: round(v, 3) for s, v in out["stage_ms"].items()}
    return out
