"""Telemetry of the port: the process-wide metrics registry (a copy of
``h2o3_tpu/telemetry/registry.py``). Spans, traces, the cost model and
the flight recorder wait for ROADMAP.md queue 1, item 21."""
from h2o3_tpu_torch.telemetry.registry import (Counter, Gauge, Histogram,
                                               Registry, enabled, on_reset,
                                               registry, set_enabled)

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "enabled",
           "on_reset", "registry", "set_enabled"]
