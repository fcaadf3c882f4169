"""Logging of the port: info and warnings on the ``h2o3_tpu_torch`` logger.

Counterpart of the info and warning half of ``h2o3_tpu/log.py`` (which
logs on the logger ``h2o3_tpu``): a standard ``logging`` logger, so that
an application's handlers and ``caplog`` see the port's messages. The JAX
module's ring buffer, timeline and phase profile are not ported yet
(ROADMAP.md queue 1, item 21).
"""
from __future__ import annotations

import logging

logger = logging.getLogger("h2o3_tpu_torch")


def info(msg: str, *args) -> None:
    """Log ``msg % args`` at INFO."""
    logger.info(msg, *args)


def warn(msg: str, *args) -> None:
    """Log ``msg % args`` at WARNING."""
    logger.warning(msg, *args)
