"""Process-wide metrics registry: counters, gauges, histograms with labels.

A copy of ``h2o3_tpu/telemetry/registry.py`` (host-only Python): the
serve stats keep their counters here. Reference: water/util/WaterMeter*
and the per-request counters of water/api.

Design constraints, in order:

1. **Hot-path safe.** Metric mutation sits on the serve request path, so
   instance operations take one striped lock (64 stripes shared across
   every metric, hash-partitioned by identity) — never a registry-wide
   mutex. Handle lookup (``registry().counter(...)``) is the slow path;
   call sites hold the returned handle.
2. **Measurably free when off.** ``H2O3_TELEMETRY=0`` makes every
   mutation a single attribute-load + branch (no lock, no arithmetic).
3. **Views, not copies.** Scrape-time ``collectors`` (callables run
   inside ``snapshot()``) let subsystems that keep their own state
   appear in the export without paying per-event mirroring.

The rest of the JAX package's ``telemetry`` (spans, traces, the cost
model, the flight recorder) waits for ROADMAP.md queue 1, item 21.
"""
from __future__ import annotations

import os
import threading
from bisect import bisect_left
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

_N_STRIPES = 64
_STRIPES = [threading.Lock() for _ in range(_N_STRIPES)]


def _stripe(key) -> threading.Lock:
    return _STRIPES[hash(key) % _N_STRIPES]


LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Optional[Dict[str, str]]) -> LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


# default histogram bounds: latencies in seconds, log-ish spaced from
# 100µs to 100s — wide enough for both a serve tick and a cold compile
DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5,
                   1.0, 5.0, 10.0, 50.0, 100.0)


class _Metric:
    """Base: every metric holds a back-reference to its registry so the
    enabled check is one attribute chain, togglable at runtime."""
    __slots__ = ("name", "labels", "_reg", "_lock")
    kind = "untyped"

    def __init__(self, reg: "Registry", name: str, labels: LabelKey):
        self.name = name
        self.labels = labels
        self._reg = reg
        self._lock = _stripe((name, labels))


class Counter(_Metric):
    __slots__ = ("_value",)
    kind = "counter"

    def __init__(self, reg, name, labels):
        super().__init__(reg, name, labels)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Metric):
    __slots__ = ("_value",)
    kind = "gauge"

    def __init__(self, reg, name, labels):
        super().__init__(reg, name, labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._value += n

    def set_max(self, v: float) -> None:
        """Monotonic high-watermark update (peak device memory)."""
        if not self._reg.enabled:
            return
        with self._lock:
            if v > self._value:
                self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Metric):
    """Prometheus-style cumulative-bucket histogram (+ sum and count).
    ``observe`` is O(log buckets) via bisect under one striped lock."""
    __slots__ = ("bounds", "_counts", "_sum", "_count")
    kind = "histogram"

    def __init__(self, reg, name, labels,
                 bounds: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(reg, name, labels)
        self.bounds = tuple(float(b) for b in bounds)
        self._counts = [0] * (len(self.bounds) + 1)   # +1 = +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        if not self._reg.enabled:
            return
        i = bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le_bound, cumulative_count), ...] ending with +Inf."""
        with self._lock:
            counts = list(self._counts)
        out, acc = [], 0
        for b, c in zip(self.bounds, counts[:-1]):
            acc += c
            out.append((b, acc))
        out.append((float("inf"), acc + counts[-1]))
        return out


class Registry:
    """A family dict (name → help/kind) over instance dicts
    ((name, labelkey) → metric). One creation lock; mutation locks are
    the module-level stripes."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._mu = threading.Lock()
        self._families: Dict[str, Tuple[str, str]] = {}   # name → (kind, help)
        self._metrics: Dict[Tuple[str, LabelKey], _Metric] = {}
        self._collectors: List[Callable[[], Iterable[dict]]] = []

    # -- handle factories (slow path: call once, hold the handle) -------

    def _get(self, cls, name: str, labels, help_: str, **kw):
        key = (name, _label_key(labels))
        with self._mu:
            m = self._metrics.get(key)
            if m is None:
                fam = self._families.get(name)
                if fam is not None and fam[0] != cls.kind:
                    raise TypeError(
                        f"metric '{name}' already registered as {fam[0]}, "
                        f"requested {cls.kind}")
                self._families.setdefault(name, (cls.kind, help_))
                m = cls(self, name, key[1], **kw)
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric '{name}' is a {m.kind}, "
                                f"requested {cls.kind}")
        return m

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None,
                help: str = "") -> Counter:
        return self._get(Counter, name, labels, help)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None,
              help: str = "") -> Gauge:
        return self._get(Gauge, name, labels, help)

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None,
                  help: str = "",
                  bounds: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, labels, help, bounds=bounds)

    # -- scrape-time views ---------------------------------------------

    def add_collector(self, fn: Callable[[], Iterable[dict]]) -> None:
        """Register a scrape-time view: ``fn()`` yields sample dicts
        ``{name, kind, labels, value, help?}`` evaluated inside
        ``snapshot()`` — zero hot-path cost for the producer."""
        with self._mu:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def remove_collector(self, fn) -> None:
        with self._mu:
            if fn in self._collectors:
                self._collectors.remove(fn)

    # -- snapshot -------------------------------------------------------

    def samples(self) -> List[dict]:
        """Flat sample list, metrics + collector views, stable order."""
        with self._mu:
            metrics = list(self._metrics.values())
            families = dict(self._families)
            collectors = list(self._collectors)
        out: List[dict] = []
        for m in sorted(metrics, key=lambda m: (m.name, m.labels)):
            help_ = families.get(m.name, ("", ""))[1]
            base = {"name": m.name, "kind": m.kind,
                    "labels": dict(m.labels), "help": help_}
            if isinstance(m, Histogram):
                out.append({**base, "sum": m.sum, "count": m.count,
                            "buckets": m.cumulative()})
            else:
                out.append({**base, "value": m.value})
        if not self.enabled:
            return out
        for fn in collectors:
            try:
                for s in fn():
                    s.setdefault("kind", "gauge")
                    s.setdefault("labels", {})
                    s.setdefault("help", "")
                    out.append(s)
            except Exception:      # a broken view must not sink a scrape
                continue
        return out

    def value(self, name: str,
              labels: Optional[Dict[str, str]] = None) -> float:
        """Current value of one counter/gauge (0.0 if never touched)."""
        m = self._metrics.get((name, _label_key(labels)))
        if m is None or isinstance(m, Histogram):
            return 0.0
        return m.value

    def snapshot(self) -> Dict[str, object]:
        """JSON-shaped snapshot, one entry a metric."""
        flat: Dict[str, object] = {}
        for s in self.samples():
            key = s["name"]
            if s["labels"]:
                key += "{" + ",".join(f"{k}={v}" for k, v in
                                      sorted(s["labels"].items())) + "}"
            if s["kind"] == "histogram":
                flat[key] = {"sum": round(s["sum"], 6), "count": s["count"]}
            else:
                flat[key] = s["value"]
        return flat

    def reset(self) -> None:
        """Drop every metric and collector (test isolation only)."""
        with self._mu:
            self._metrics.clear()
            self._families.clear()
            self._collectors.clear()
        if self is _REGISTRY:
            # hot-path handle caches hold metrics of THIS registry —
            # stale handles would silently record into dropped objects.
            # Each cache registers its clear via on_reset at import
            for fn in _RESET_HOOKS:
                fn()


_RESET_HOOKS: List[Callable[[], None]] = []


def on_reset(fn: Callable[[], None]) -> Callable[[], None]:
    """Register a callback Registry.reset() runs on the process
    registry. Modules that cache metric HANDLES register their cache's
    ``.clear`` here at import, so test resets cannot leave handles
    recording into dropped metric objects — no cross-module reach-ins
    from reset()."""
    _RESET_HOOKS.append(fn)
    return fn


def _env_enabled() -> bool:
    return os.environ.get("H2O3_TELEMETRY", "1") not in ("0", "false", "")


_REGISTRY = Registry(enabled=_env_enabled())


def registry() -> Registry:
    return _REGISTRY


def enabled() -> bool:
    return _REGISTRY.enabled


def set_enabled(on: bool) -> None:
    _REGISTRY.enabled = bool(on)
