"""Logging for the port's stages.

The port's copy of the reference's `utils/log.py`: `get_logger`, and
`Metrics`, per-stage metrics dumped as one JSON line.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Dict


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


class Metrics:
    """Accumulates per-stage metrics; one JSON-line dump at the end."""

    def __init__(self):
        self.data: Dict[str, Any] = {}
        self._t0: Dict[str, float] = {}

    def start(self, stage: str):
        self._t0[stage] = time.time()

    def stop(self, stage: str):
        self.data[f"{stage}_s"] = time.time() - self._t0.pop(stage)

    def set(self, key: str, value: Any):
        self.data[key] = value

    def dump(self, file=sys.stdout):
        json.dump(self.data, file)
        file.write("\n")
        file.flush()
