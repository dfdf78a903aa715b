"""Run manifests: config + per-stage metrics persisted next to the data.

Copy of the reference's `utils/manifest.py`: every run records what ran
with which parameters and what came out (point counts, inlier ratios,
residuals, timings), one JSON line per stage run.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
from typing import Any, Dict, Optional


def _jsonable(obj: Any) -> Any:
    import numpy as np

    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _jsonable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


def write_manifest(base_path: str, stage: str, config: Any,
                   metrics: Dict[str, Any],
                   name: Optional[str] = None) -> str:
    """Append a manifest record to `<base>/manifests/<stage>.jsonl`."""
    d = os.path.join(base_path, "manifests")
    os.makedirs(d, exist_ok=True)
    rec = {
        "stage": stage,
        "timestamp": datetime.datetime.now().isoformat(timespec="seconds"),
        "config": _jsonable(config),
        "metrics": _jsonable(metrics),
    }
    path = os.path.join(d, f"{name or stage}.jsonl")
    with open(path, "a") as f:
        json.dump(rec, f)
        f.write("\n")
    return path
