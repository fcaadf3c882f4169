"""Per-deployment circuit breaker for the serving device stage.

A copy of ``h2o3_tpu/serve/circuit.py``. When a deployment's DEVICE
stage fails consecutively (a sick card, a poisoned model), continuing to
queue and dispatch traffic at it burns the batcher tick, delays
coalesced innocents and converts every request into a slow timeout. The
breaker converts that into FAST failure:

- ``closed``     — healthy; device failures increment a consecutive
                   counter (any success resets it).
- ``open``       — ``failure_threshold`` consecutive device failures
                   trip it: ``submit()`` fails immediately with a
                   503-mapped ``ServeCircuitOpenError`` carrying
                   ``retry_after_s``, so clients back off and OTHER
                   deployments keep their latency.
- ``half_open``  — after ``open_secs`` the next request is admitted as
                   a PROBE batch: its success closes the circuit, its
                   failure re-opens (with a fresh cooldown).

State transitions surface on ``h2o3_circuit_state{model=...}``
(0=closed, 1=half_open, 2=open) and ``h2o3_circuit_open_total``; encode
failures (the CLIENT's bad rows) never count against the device's
health. The JAX module's flight-recorder records of each transition
return with ROADMAP.md queue 1, item 21.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from h2o3_tpu_torch.log import info, warn
from h2o3_tpu_torch.telemetry import registry

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    def __init__(self, model: str = "", failure_threshold: int = 5,
                 open_secs: float = 1.0, stats=None):
        self.model = model
        self.failure_threshold = max(int(failure_threshold), 1)
        self.open_secs = float(open_secs)
        self._mu = threading.Lock()
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._open_count = 0
        self._probe_inflight = False
        self._probe_at = 0.0
        # state gauge lives in the deployment's stats registry so it
        # follows the H2O3_TELEMETRY fallback behavior of every other
        # serve metric
        reg = stats._reg if stats is not None else None
        if reg is None:
            reg = registry()
        self._gauge = reg.gauge(
            "h2o3_circuit_state", {"model": model or "_anon"},
            help="serve circuit state (0=closed, 1=half_open, 2=open)")
        self._open_ctr = reg.counter(
            "h2o3_circuit_open_total", {"model": model or "_anon"},
            help="circuit-open transitions")

    # -- admission ------------------------------------------------------

    def allow_request(self) -> Optional[float]:
        """None = admit. A float = reject, with the suggested
        Retry-After seconds. In ``open``, the cooldown expiry admits
        ONE request (transitioning to ``half_open``); while the probe
        is in flight further requests stay rejected."""
        with self._mu:
            if self._state == CLOSED:
                return None
            now = time.monotonic()
            if self._state == OPEN:
                remaining = self.open_secs - (now - self._opened_at)
                if remaining > 0:
                    return max(remaining, 0.001)
                self._state = HALF_OPEN
                self._probe_inflight = False
                self._set_gauge()
            # HALF_OPEN: admit a single probe; reject the rest until
            # its verdict lands. A probe can die before EVER reaching
            # the device stage (queue-full rejection, expired in queue,
            # encode failure) and those paths report no verdict — so a
            # stale probe claim expires after a cooldown-sized window
            # and the next request becomes the probe, instead of the
            # deployment wedging in half-open 503s forever.
            if self._probe_inflight \
                    and now - self._probe_at <= max(self.open_secs, 1.0):
                return max(self.open_secs, 0.001)
            self._probe_inflight = True
            self._probe_at = now
            return None

    # -- verdicts (device stage only) -----------------------------------

    def record_success(self) -> None:
        with self._mu:
            self._consecutive_failures = 0
            self._probe_inflight = False
            if self._state != CLOSED:
                self._state = CLOSED
                self._set_gauge()
                info("serve circuit for '%s' closed (probe succeeded)",
                     self.model)

    def record_failure(self) -> None:
        with self._mu:
            self._consecutive_failures += 1
            tripped = (self._state == HALF_OPEN
                       or self._consecutive_failures
                       >= self.failure_threshold)
            if tripped and self._state != OPEN:
                self._state = OPEN
                self._opened_at = time.monotonic()
                self._open_count += 1
                self._probe_inflight = False
                self._open_ctr.inc()
                self._set_gauge()
                warn("serve circuit for '%s' OPEN after %d consecutive "
                     "device failures — failing fast for %.2fs",
                     self.model, self._consecutive_failures,
                     self.open_secs)
            elif tripped:
                # already open (e.g. a straggler in-flight batch): push
                # the cooldown out from the latest failure
                self._opened_at = time.monotonic()

    def _set_gauge(self) -> None:
        self._gauge.set(_STATE_CODE[self._state])

    # -- introspection --------------------------------------------------

    @property
    def state(self) -> str:
        with self._mu:
            return self._state

    def publish(self) -> Dict[str, object]:
        """Gossip-shaped state (``circuit_states``): what a PEER needs
        to shed load — the state, a Retry-After suggestion (remaining
        cooldown; a whole window when the cooldown already lapsed and
        the probe is pending) and the report's wall time so receivers
        can age it."""
        with self._mu:
            retry = 0.0
            if self._state == OPEN:
                remaining = self.open_secs - (time.monotonic()
                                              - self._opened_at)
                retry = (max(remaining, 0.05) if remaining > 0
                         else max(self.open_secs, 0.05))
            elif self._state == HALF_OPEN:
                retry = max(self.open_secs, 0.05)
            return {"model": self.model, "state": self._state,
                    "retry_after_s": round(retry, 3),
                    "open_count": self._open_count,
                    "consecutive_failures": self._consecutive_failures,
                    "time": time.time()}

    def snapshot(self) -> Dict[str, object]:
        with self._mu:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "open_count": self._open_count,
                "failure_threshold": self.failure_threshold,
                "open_secs": self.open_secs,
                "seconds_in_state": (
                    round(time.monotonic() - self._opened_at, 3)
                    if self._state == OPEN else None),
            }
