"""Deadline-class admission lanes for the serving path.

A copy of ``h2o3_tpu/serve/lanes.py``. The training scheduler runs
three priority classes — ``interactive`` > ``bulk`` > ``background`` —
and these lanes are their serving mirror, enforced at the micro-batcher
(serve/batcher.py): each request carries a lane; the pending queue keeps
per-lane row budgets — ``interactive`` may fill the whole queue,
``bulk`` and ``background`` only their configured fraction of it — and
the batch pickup drains lanes in priority order, so an interactive row
admitted behind a bulk backlog still boards the next tick's batch. (The
JAX package's fleet router applies the same budgets at its front door;
the port's fleet waits for ROADMAP.md queue 1, item 22.)

A lane arrives as an explicit argument and otherwise defaults from the
request path: row-scoring endpoints are interactive, frame/batch
exports are bulk.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

__all__ = ["LANES", "LANE_LEVELS", "DEFAULT_LANE", "budget_fraction",
           "default_for_path", "normalize"]

# priority order of the JAX package's scheduler: lower level = drained
# first
LANES: Tuple[str, ...] = ("interactive", "bulk", "background")
LANE_LEVELS = {"interactive": 0, "bulk": 1, "background": 2}
DEFAULT_LANE = "interactive"

# fraction of the queue (the batcher's queue_limit rows) a lane may
# occupy. Interactive owns the whole queue —
# its isolation comes from the lower lanes' caps, not its own.
_DEFAULT_BUDGETS = {"interactive": 1.0, "bulk": 0.5, "background": 0.25}


def normalize(lane: Optional[str]) -> str:
    """Validated lane name; ``None``/empty defaults to interactive.
    Unknown names raise — a typo'd lane must not silently ride the
    highest class."""
    if not lane:
        return DEFAULT_LANE
    name = str(lane).strip().lower()
    if name not in LANE_LEVELS:
        raise ValueError(f"unknown lane '{lane}' (one of {list(LANES)})")
    return name


def budget_fraction(lane: str) -> float:
    """The lane's queue-budget fraction (``H2O3_SERVE_LANE_<LANE>``
    overrides, clamped to (0, 1]; malformed values fall back — serving
    must not break on a typo'd knob)."""
    base = _DEFAULT_BUDGETS.get(lane, 1.0)
    raw = os.environ.get(f"H2O3_SERVE_LANE_{lane.upper()}", "")
    if raw:
        try:
            v = float(raw)
            if 0.0 < v <= 1.0:
                return v
        except ValueError:
            pass
    return base


def default_for_path(path: str) -> str:
    """Lane when the client did not say: row scoring is interactive
    (a human or online system is waiting on the response); frame-batch
    scoring and bulk exports are bulk."""
    p = str(path or "").lower()
    if "/frames/" in p or p.endswith("/predict") or "downloaddataset" in p:
        return "bulk"
    return DEFAULT_LANE
