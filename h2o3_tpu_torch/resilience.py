"""Retry with backoff for transient failures.

Counterpart of the classification and retry half of
``h2o3_tpu/resilience.py``: ``is_transient`` (status-code and socket
markers in the message), ``is_transient_io`` (storage: an ``OSError`` is
retried, except the ones that fail the same way every time) and
``retry_transient`` (bounded exponential backoff with full jitter, a
warning a retry). The JAX module's device-put retry is not ported: a
failed copy to the card raises. Its fault-injection taxonomy and retry
counters wait for ROADMAP.md queue 1, items 19 and 21.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional, TypeVar

from h2o3_tpu_torch.log import warn

T = TypeVar("T")

# status-code spellings and common socket and storage phrasings
_TRANSIENT_MARKERS = (
    "UNAVAILABLE", "INTERNAL", "DATA_LOSS", "ABORTED", "CANCELLED",
    "DEADLINE_EXCEEDED", "connection reset", "connection refused",
    "broken pipe", "temporarily unavailable", "timed out", "EAGAIN",
)

_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory", "OOM",
                "Resource exhausted")


def is_oom(exc: BaseException) -> bool:
    """An allocation failure: repeating it fails the same way."""
    if isinstance(exc, MemoryError):
        return True
    msg = str(exc)
    return any(m in msg for m in _OOM_MARKERS)


def is_transient(exc: BaseException) -> bool:
    """A failure worth retrying; an allocation failure is not one."""
    if is_oom(exc):
        return False
    msg = str(exc)
    return any(m in msg for m in _TRANSIENT_MARKERS)


def is_transient_io(exc: BaseException) -> bool:
    """The storage flavour: an ``OSError`` is retried on top of the
    generic markers, except a missing file, a directory, a permission or
    an HTTP 4xx, which fail the same way every attempt."""
    if isinstance(exc, (FileNotFoundError, IsADirectoryError,
                        NotADirectoryError, PermissionError)):
        return False
    code = getattr(exc, "code", None)       # urllib's HTTPError
    if isinstance(code, int) and 400 <= code < 500:
        return False
    if isinstance(exc, OSError):
        return True
    return is_transient(exc)


def retry_transient(fn: Callable[[], T], *, site: str,
                    attempts: int = 3, base_delay_s: float = 0.05,
                    max_delay_s: float = 2.0,
                    classify: Callable[[BaseException], bool] = is_transient,
                    sleep: Callable[[float], None] = time.sleep) -> T:
    """Call ``fn``, retrying a failure that ``classify`` calls transient
    up to ``attempts`` calls in all, after a jittered exponential delay;
    any other failure, and the last, propagates."""
    if attempts <= 1:
        return fn()
    last: Optional[BaseException] = None
    for attempt in range(attempts):
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — classified below
            if not classify(e) or attempt == attempts - 1:
                raise
            last = e
            # full jitter: uniform in (0, base * 2^attempt], capped
            delay = min(base_delay_s * (2 ** attempt), max_delay_s)
            delay *= random.random() or 0.5
            warn("%s: transient failure (%s) — retry %d/%d in %.0fms",
                 site, type(e).__name__, attempt + 1, attempts - 1,
                 delay * 1e3)
            sleep(delay)
    raise last  # pragma: no cover — the loop returns or raises
