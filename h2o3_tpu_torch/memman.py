"""Device-memory budget: what a train may hold on the card.

Counterpart of the budget half of ``h2o3_tpu/memman.py``. A builder asks
``fits_device`` whether a dense design matrix, on top of the column
payloads already on the device, stays under the high watermark of the
budget; where it does not, the design matrix stays on the host and the
GBM streams row chunks through its level kernels
(``models/streaming.py``). Every ``Vec`` registers its payload here when
it is made (``frame/vec.py``), so ``stats()["device_resident_bytes"]``
counts the live column payloads, as the JAX gate counts them. A
manager counts only the payloads made after it: ``reset`` installs a new
one with none, as in the JAX package, so the same frame under the same
``reset(budget=...)`` takes the same path in both packages.

The budget is ``H2O3_DEVICE_BUDGET_BYTES`` where it is set, else the
card's memory (``torch.cuda.mem_get_info``) where there is a card, else
unlimited (the JAX CPU backend's ``1 << 62``).

``request`` evicts nothing yet: the least-recently-used spill of frames
to the host, and frames that live on the host, come with ROADMAP.md
queue 1, item 18.
"""
from __future__ import annotations

import os
import threading
import weakref
from typing import Any, Dict, Optional

import torch

_LOCK = threading.RLock()

HIGH_WATERMARK = 0.90      # a dense allocation must stay under this share
LOW_WATERMARK = 0.70       # the spill's target (item 18)
_UNLIMITED = 1 << 62


def _default_budget() -> int:
    env = os.environ.get("H2O3_DEVICE_BUDGET_BYTES")
    if env:
        return int(env)
    if torch.cuda.is_available():
        return int(torch.cuda.mem_get_info(torch.cuda.current_device())[1])
    return _UNLIMITED


class _Block:
    """One registered device payload."""

    __slots__ = ("nbytes", "__weakref__")

    def __init__(self, nbytes: int):
        self.nbytes = nbytes


class MemoryManager:
    def __init__(self, budget: Optional[int] = None):
        self.budget = int(budget) if budget is not None else _default_budget()
        # residency is the sum over live blocks: a payload's block dies
        # with its Vec
        self._blocks: "weakref.WeakSet[_Block]" = weakref.WeakSet()

    @property
    def _resident(self) -> int:
        return sum(b.nbytes for b in self._blocks)

    def register(self, nbytes: int) -> _Block:
        """Count a device payload of ``nbytes`` while the returned block
        lives (its owner keeps the reference)."""
        with _LOCK:
            b = _Block(int(nbytes))
            self._blocks.add(b)
            return b

    def request(self, nbytes: int) -> None:
        """The allocation gate of the JAX package, which spills
        least-recently-used payloads to make room for ``nbytes``; the
        port does not spill yet (ROADMAP.md item 18)."""

    def fits_device(self, nbytes: int) -> bool:
        """Whether a dense allocation of ``nbytes`` stays within the high
        watermark; the GBM streams where it does not."""
        return nbytes <= self.budget * HIGH_WATERMARK

    @property
    def unlimited(self) -> bool:
        """True where no real device limit applies (the CPU)."""
        return self.budget >= (1 << 61)

    def admission_budget(self) -> int:
        """The bytes concurrent trains may be promised: the high
        watermark of the budget."""
        return int(self.budget * HIGH_WATERMARK)

    def stats(self) -> Dict[str, Any]:
        with _LOCK:
            return {"device_budget_bytes": (self.budget if not self.unlimited
                                            else -1),
                    "device_resident_bytes": self._resident,
                    "registered_blocks": len(self._blocks),
                    "high_watermark": HIGH_WATERMARK,
                    "low_watermark": LOW_WATERMARK}


_MANAGER: Optional[MemoryManager] = None


def manager() -> MemoryManager:
    global _MANAGER
    with _LOCK:
        if _MANAGER is None:
            _MANAGER = MemoryManager()
        return _MANAGER


def reset(budget: Optional[int] = None) -> MemoryManager:
    """Install a new manager with ``budget`` (None: the default source)
    and no registered payloads."""
    global _MANAGER
    with _LOCK:
        _MANAGER = MemoryManager(budget)
        return _MANAGER
