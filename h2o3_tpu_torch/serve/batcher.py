"""Micro-batching queue: concurrent row requests → padded device batches.

Counterpart of ``h2o3_tpu/serve/batcher.py``. Concurrent clients submit
small row lists; a batcher thread coalesces everything that arrives
within one tick (max_delay_ms, or until max_batch rows are waiting) into
ONE padded batch, and a collector thread fetches results + resolves the
waiting clients. Two threads — not one — because the card's scoring is
asynchronous: the batcher encodes and dispatches batch k+1 while the
collector is still waiting on batch k's copy to the host. The in-flight
queue is bounded (pipeline depth 2) so a slow device backpressures
encoding instead of buffering unboundedly.

Admission control: the pending queue is bounded in ROWS — beyond it
submit() fails fast with ServeOverloadedError (HTTP 503) instead of
growing latency without bound; each request carries a deadline —
expired requests are dropped at pick-up time (never dispatched) or
abandoned at resolve time, surfacing ServeDeadlineError.

The JAX module's spans and traces (ROADMAP.md queue 1, item 21), its
fault site ``execute`` (item 19), its performance hook (item 21) and its
fleet check (item 22) have no counterpart here yet.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from h2o3_tpu_torch.resilience import is_transient
from h2o3_tpu_torch.serve import lanes as lanes_mod
from h2o3_tpu_torch.serve.stats import ServeStats

# batches dispatched and not yet fetched, at most: the in-flight queue's
# bound (the scorer sizes its slot rings from it)
PIPELINE_DEPTH = 2


class ServeError(RuntimeError):
    """Base class; http_status picked up by the REST layer."""
    http_status = 500


class ServeOverloadedError(ServeError):
    http_status = 503


class ServeLaneShedError(ServeOverloadedError):
    """A non-interactive lane exhausted its queue budget:
    the request sheds fast with 503 + ``Retry-After`` while interactive
    admission — and the rows already queued in every lane — proceed
    untouched. Mirrors the scheduler's priority semantics: bulk load
    degrades bulk, never interactive p99."""

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class ServeBadRequestError(ServeError):
    """A request's rows failed to encode (e.g. a non-numeric string in
    a numeric column) — the client's fault, not the service's."""
    http_status = 400


class ServeDeadlineError(ServeError):
    http_status = 503


class ServeCircuitOpenError(ServeError):
    """The deployment's circuit breaker is open: its device stage is
    failing consecutively, so requests fail FAST instead of queueing
    into certain timeouts. ``retry_after_s`` feeds the HTTP
    ``Retry-After`` header."""
    http_status = 503

    def __init__(self, msg: str, retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = float(retry_after_s)


class ServeClosedError(ServeError):
    http_status = 410


class _Request:
    __slots__ = ("rows", "n", "t_enqueue", "deadline", "event",
                 "results", "error", "abandoned", "columnar", "lane")

    def __init__(self, rows: Sequence[Dict[str, Any]], deadline: float,
                 columnar: bool = False,
                 lane: str = lanes_mod.DEFAULT_LANE):
        self.lane = lane
        self.rows = rows
        self.n = len(rows)
        self.t_enqueue = time.perf_counter()
        self.deadline = deadline
        self.event = threading.Event()
        self.results = None      # [dict, ...] rows or {col: [...]} columnar
        self.error: Optional[BaseException] = None
        self.abandoned = False
        self.columnar = columnar


class MicroBatcher:
    def __init__(self, encode: Callable, dispatch: Callable,
                 decode: Callable, stats: ServeStats, *,
                 bucket_for: Callable[[int], int],
                 fetch: Callable = np.asarray,
                 max_batch: int = 512, max_delay_ms: float = 2.0,
                 queue_limit: int = 8192,
                 default_timeout_ms: float = 10_000.0, breaker=None):
        import queue as _q
        self.breaker = breaker         # serve/circuit.py CircuitBreaker
        self._encode = encode          # (rows, pad_to) -> np [pad, F]
        self._dispatch = dispatch      # (X, n_active) -> in-flight handle
        self._fetch = fetch            # handle -> host scores (waits)
        self._decode = decode          # (host scores, n) -> DecodedBatch
        self._bucket_for = bucket_for
        self.stats = stats
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1000.0
        self.queue_limit = int(queue_limit)
        self.default_timeout_s = float(default_timeout_ms) / 1000.0
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        # one FIFO per deadline-class lane: pickup drains lanes in
        # priority order, admission budgets rows per lane
        self._pending: Dict[str, deque] = {ln: deque()
                                           for ln in lanes_mod.LANES}
        self._lane_rows: Dict[str, int] = {ln: 0
                                           for ln in lanes_mod.LANES}
        self._pending_rows = 0
        self._closed = False
        self._inflight: "_q.Queue" = _q.Queue(maxsize=PIPELINE_DEPTH)
        self._batch_thread = threading.Thread(
            target=self._batch_loop, daemon=True, name="serve-batcher")
        self._collect_thread = threading.Thread(
            target=self._collect_loop, daemon=True, name="serve-collector")
        self._batch_thread.start()
        self._collect_thread.start()

    # -- client side ----------------------------------------------------

    def submit(self, rows: Sequence[Dict[str, Any]],
               timeout_ms: Optional[float] = None,
               columnar: bool = False,
               lane: Optional[str] = None):
        """Blocking scoring call for one client request. Raises
        ServeOverloadedError when the queue is full, ServeDeadlineError
        when the deadline expires first. ``columnar=True`` returns
        ``{column: [values...]}`` from the batch's vectorized decode
        instead of per-row dicts (requests of both shapes coalesce into
        the same device batch). ``lane`` is the deadline class
        (interactive > bulk > background): non-interactive lanes are
        budgeted to a fraction of the queue and shed fast
        (ServeLaneShedError, 503 + Retry-After) beyond it, so a bulk
        flood cannot ride interactive's admission headroom."""
        if not rows:
            return {} if columnar else []
        lane = lanes_mod.normalize(lane)
        if len(rows) > self.max_batch:
            raise ValueError(
                f"submit() takes at most max_batch={self.max_batch} rows "
                f"per request (got {len(rows)}); split the request")
        if self.breaker is not None:
            # fail FAST while the circuit is open: the device stage is
            # known-broken, queueing would only convert this request
            # into a slow timeout and delay coalesced innocents
            retry_after = self.breaker.allow_request()
            if retry_after is not None:
                self.stats.record_rejected()
                raise ServeCircuitOpenError(
                    f"circuit open for '{self.stats.model}' (device "
                    f"stage failing) — retry in {retry_after:.2f}s",
                    retry_after_s=retry_after)
        timeout_s = (float(timeout_ms) / 1000.0 if timeout_ms is not None
                     else self.default_timeout_s)
        deadline = time.perf_counter() + timeout_s
        req = _Request(rows, deadline, columnar=columnar, lane=lane)
        with self._cv:
            if self._closed:
                raise ServeClosedError("deployment is shut down")
            if lane != lanes_mod.DEFAULT_LANE:
                # per-lane budget: bulk/background may only occupy their
                # fraction of the queue — beyond it THIS lane sheds
                # while interactive admission is untouched
                cap = int(self.queue_limit
                          * lanes_mod.budget_fraction(lane))
                if self._lane_rows[lane] + req.n > cap:
                    self.stats.record_rejected()
                    self.stats.record_lane_shed(lane)
                    retry_s = max(self.max_delay_s * 4, 0.05)
                    raise ServeLaneShedError(
                        f"'{lane}' lane budget full "
                        f"({self._lane_rows[lane]} rows pending, lane "
                        f"cap {cap} of {self.queue_limit}) — retry in "
                        f"{retry_s:.2f}s", retry_after_s=retry_s)
            if self._pending_rows + req.n > self.queue_limit:
                self.stats.record_rejected()
                raise ServeOverloadedError(
                    f"serving queue full ({self._pending_rows} rows "
                    f"pending, limit {self.queue_limit}) — retry later")
            self._pending[lane].append(req)
            self._lane_rows[lane] += req.n
            self._pending_rows += req.n
            self._cv.notify_all()
        self.stats.queue_delta(req.n)
        resolved = req.event.wait(max(deadline - time.perf_counter(), 0.0))
        if not resolved:
            # the batcher may be timing this request out concurrently
            # (_take_batch's expired-in-queue branch runs under _mu and
            # records the timeout itself) — claim under the same lock so
            # the counter advances exactly once
            with self._mu:
                req.abandoned = True
                already_counted = req.error is not None
            if not already_counted:
                self.stats.record_timeout()
            self.stats.queue_delta(-req.n)
            # a deadline blowout is slower than every successful
            # request — without an exemplar the slow-request list would
            # show only benign latencies during the exact stall the
            # operator is investigating
            self.stats.record_failed_exemplar(
                (time.perf_counter() - req.t_enqueue) * 1e3, req.n,
                None, "deadline")
            raise ServeDeadlineError(
                f"request deadline ({timeout_s * 1e3:.0f} ms) expired "
                f"before results were ready")
        self.stats.queue_delta(-req.n)
        if req.error is not None:
            self.stats.record_failed_exemplar(
                (time.perf_counter() - req.t_enqueue) * 1e3, req.n,
                None, type(req.error).__name__)
            raise req.error
        lat_s = time.perf_counter() - req.t_enqueue
        self.stats.record_request(lat_s * 1e3, req.n, lane=req.lane)
        return req.results

    def _resolve_error(self, reqs: List[_Request], err: BaseException):
        """Resolve requests with ``err`` under the queue lock. submit()'s
        timeout path claims a request under ``_mu`` and reads
        ``req.error`` to decide which side records the failure — a bare
        write here races that claim and can double-count one request as
        both timeout and error. Abandoned requests are skipped: their
        waiter is gone."""
        with self._mu:
            for r in reqs:
                if not r.abandoned:
                    r.error = err
                r.event.set()

    # -- batcher thread -------------------------------------------------

    def _pop_next_locked(self, rows: int) -> Optional[_Request]:
        """Next request that fits the batch, drained in LANE PRIORITY
        order (interactive > bulk > background): an interactive row
        admitted behind a bulk backlog boards the next tick's batch
        instead of riding the whole backlog out. Callers hold
        ``self._cv``."""
        for ln in lanes_mod.LANES:
            q = self._pending[ln]
            if q and rows + q[0].n <= self.max_batch:
                r = q.popleft()
                self._lane_rows[ln] -= r.n
                self._pending_rows -= r.n
                return r
        return None

    def _has_pending_locked(self) -> bool:
        return any(self._pending.values())

    def _take_batch(self) -> List[_Request]:
        """Collect requests for one tick: first arrival opens a window
        of max_delay_ms; the batch closes when the window ends or
        max_batch rows are in hand."""
        batch: List[_Request] = []
        rows = 0
        window_end = None
        with self._cv:
            while True:
                while True:
                    r = self._pop_next_locked(rows)
                    if r is None:
                        break
                    now = time.perf_counter()
                    if r.abandoned or now > r.deadline:
                        # expired in queue: never dispatch it
                        if not r.abandoned:
                            r.error = ServeDeadlineError(
                                "request expired in the serving queue")
                            self.stats.record_timeout()
                            r.event.set()
                        continue
                    batch.append(r)
                    rows += r.n
                if self._closed and not batch \
                        and not self._has_pending_locked():
                    return []
                if rows >= self.max_batch:
                    return batch
                now = time.perf_counter()
                if batch and window_end is None:
                    window_end = now + self.max_delay_s
                if window_end is not None:
                    if now >= window_end:
                        return batch
                    self._cv.wait(window_end - now)
                else:
                    if self._closed:
                        return []
                    self._cv.wait(0.05)

    def _encode_batch(self, batch: List[_Request]):
        """Encode a coalesced batch. A row that refuses to encode (bad
        client input) must fail ONLY its own request — innocent
        requests sharing the tick are re-encoded without it and still
        dispatched; the offender resolves with a 400-mappable
        ServeBadRequestError instead of poisoning the whole batch."""
        rows: List[Dict[str, Any]] = []
        for r in batch:
            rows.extend(r.rows)
        n = sum(r.n for r in batch)
        try:
            return self._encode(rows, self._bucket_for(n)), batch, n
        except Exception:
            pass                     # isolate per request below
        good: List[_Request] = []
        for r in batch:
            try:
                self._encode(r.rows, r.n)
                good.append(r)
            except Exception as e:   # noqa: BLE001 — client's bad row
                self._resolve_error([r], e if isinstance(e, ServeError)
                                    else ServeBadRequestError(
                                        f"row encoding failed: {e}"))
                self.stats.record_error()
        if not good:
            return None, [], 0
        rows = []
        for r in good:
            rows.extend(r.rows)
        n = sum(r.n for r in good)
        try:
            return self._encode(rows, self._bucket_for(n)), good, n
        except BaseException as e:  # noqa: BLE001 — must not kill the loop
            self._resolve_error(good, e)
            self.stats.record_error()
            return None, [], 0

    def _batch_loop(self):
        while True:
            batch = self._take_batch()
            if not batch:
                if self._closed:
                    self._inflight.put(None)    # collector sentinel
                    return
                continue
            t0 = time.perf_counter()
            X, batch, n = self._encode_batch(batch)
            if not batch:
                continue
            t1 = time.perf_counter()
            try:
                out = self._dispatch_resilient(X, n, batch)
                t2 = time.perf_counter()
            except BaseException as e:  # noqa: BLE001 — resolve waiters
                self._resolve_error(batch, e)
                self.stats.record_error()
                if self.breaker is not None:
                    self.breaker.record_failure()
                continue
            queue_ms = (t0 - min(r.t_enqueue for r in batch)) * 1e3
            self._inflight.put(
                (out, batch, n, X,
                 {"queue": queue_ms, "encode": (t1 - t0) * 1e3,
                  "dispatch": (t2 - t1) * 1e3}))

    def _deadline_allows_retry(self, batch: List[_Request]) -> bool:
        """A retry only makes sense if every coalesced request can
        still meet its deadline afterwards (a conservative one-tick
        margin)."""
        margin = self.max_delay_s + 0.001
        return time.perf_counter() + margin < min(r.deadline
                                                  for r in batch)

    def _dispatch_resilient(self, X, n: int, batch: List[_Request]):
        """Device dispatch with ONE transient retry — a single hiccup
        recovers in-place; a persistent failure propagates to the
        breaker. The retry respects the coalesced requests' deadlines:
        if any would expire, fail now instead of burning its remaining
        budget."""
        try:
            return self._dispatch(X, n)
        except BaseException as e:  # noqa: BLE001 — classified below
            if not is_transient(e) or not self._deadline_allows_retry(
                    batch):
                raise
            self.stats.record_retry()
            return self._dispatch(X, n)

    # -- collector thread -----------------------------------------------

    def _collect_loop(self):
        while True:
            item = self._inflight.get()
            if item is None:
                return
            out, batch, n, X, tms = item
            padded = X.shape[0]
            t0 = time.perf_counter()
            # DEVICE stage (the breaker's jurisdiction): fetch, with
            # the same single-transient-retry policy as dispatch (the
            # batch is re-dispatched from its still-live encoded
            # matrix). Only failures HERE count against device health.
            try:
                try:
                    host = self._fetch(out)     # blocks until ready
                except BaseException as e:  # noqa: BLE001
                    if not is_transient(e) \
                            or not self._deadline_allows_retry(batch):
                        raise
                    self.stats.record_retry()
                    host = self._fetch(self._dispatch_resilient(
                        X, n, batch))
            except BaseException as e:  # noqa: BLE001
                self._resolve_error(batch, e)
                self.stats.record_error()
                if self.breaker is not None:
                    self.breaker.record_failure()
                continue
            if self.breaker is not None:
                # the device answered: close a half-open circuit /
                # reset the counter BEFORE decode — a host-side codec
                # bug below must not read as device sickness (the
                # breaker contract: client/host failures never count)
                self.breaker.record_success()
            # HOST decode stage: failures resolve the requests with the
            # error but leave the circuit alone
            try:
                t1 = time.perf_counter()
                decoded = self._decode(host, n)
                # per-request views over the batch-wide vectorized
                # decode: row dicts only materialize for row-format
                # requests (columnar requests slice arrays). Built
                # INSIDE the decode-stage window so the stats attribute
                # the dict cost honestly.
                off = 0
                for r in batch:
                    r.results = (decoded.columns(off, r.n) if r.columnar
                                 else decoded.rows(off, r.n))
                    off += r.n
                t2 = time.perf_counter()
            except BaseException as e:  # noqa: BLE001
                self._resolve_error(batch, e)
                self.stats.record_error()
                continue
            for r in batch:
                r.event.set()
            self.stats.record_batch(
                n, padded,
                {"queue": tms["queue"],
                 "encode": tms["encode"],
                 "device": tms["dispatch"] + (t1 - t0) * 1e3,
                 "decode": (t2 - t1) * 1e3})

    # -- lifecycle ------------------------------------------------------

    @property
    def pending_rows(self) -> int:
        with self._mu:
            return self._pending_rows

    def close(self, timeout: float = 5.0):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._batch_thread.join(timeout)
        self._collect_thread.join(timeout)
        # resolve anything still queued
        with self._cv:
            for ln in lanes_mod.LANES:
                q = self._pending[ln]
                while q:
                    r = q.popleft()
                    self._lane_rows[ln] -= r.n
                    self._pending_rows -= r.n
                    r.error = ServeClosedError("deployment shut down")
                    r.event.set()
