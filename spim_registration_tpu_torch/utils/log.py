"""Logging for the port's stages.

The port's copy of the reference's `utils/log.py`: `get_logger`. Stage
times go through `utils/profiling.py` (`stage_timer`, spans) instead of
the reference's `Metrics`.
"""

from __future__ import annotations

import logging
import sys


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(f"spim.{name}")
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "[%(asctime)s %(name)s] %(message)s", "%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger

