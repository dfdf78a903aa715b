"""Typed run configuration, serialized to the run manifest.

Port of the reference's `pipeline/config.py`: one dataclass tree covers
every stage; `to_json`/`from_json` give the manifest round trip and the
CLI is a thin parser over it. The tree is built from the port's parameter
dataclasses, which carry the reference's fields and defaults, so the
default configuration serializes to the reference's JSON text.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

from spim_registration_tpu_torch.deconv.lucy_richardson import (
    DeconvolutionParameters,
)
from spim_registration_tpu_torch.detect.dog import DoGParameters
from spim_registration_tpu_torch.detect.dom import DoMParameters
from spim_registration_tpu_torch.fuse.weighted_avg import FusionParameters
from spim_registration_tpu_torch.fuse.weights import (
    BlendingParameters,
    ContentBasedParameters,
)
from spim_registration_tpu_torch.match.pairwise import PairwiseParameters
from spim_registration_tpu_torch.models.ransac import RansacParameters
from spim_registration_tpu_torch.solve.global_opt import GlobalOptParameters


@dataclasses.dataclass(frozen=True)
class RunConfig:
    detection: DoGParameters = DoGParameters()
    # Difference-of-Mean detection, used by `cli detect --method dom`
    dom: DoMParameters = DoMParameters()
    pairwise: PairwiseParameters = PairwiseParameters()
    # the pipeline turns wrong-link trimming on
    global_opt: GlobalOptParameters = GlobalOptParameters(
        outlier_trim_rounds=2)
    fusion: FusionParameters = FusionParameters()
    deconvolution: DeconvolutionParameters = DeconvolutionParameters()
    label: str = "beads"


NESTED = {
    "detection": DoGParameters,
    "dom": DoMParameters,
    "pairwise": PairwiseParameters,
    "global_opt": GlobalOptParameters,
    "fusion": FusionParameters,
    "deconvolution": DeconvolutionParameters,
    "ransac": RansacParameters,
    "blending": BlendingParameters,
    "content": ContentBasedParameters,
}


def to_dict(obj: Any) -> Any:
    """A dataclass tree as plain JSON values (tuples become lists)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_dict(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple):
        return list(obj)
    return obj


def from_dict(cls, data: dict):
    """An instance of dataclass `cls` from `to_dict`'s output (missing
    fields keep their defaults)."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if f.name in NESTED and isinstance(v, dict):
            v = from_dict(NESTED[f.name], v)
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def to_json(cfg: RunConfig, path: Optional[str] = None) -> str:
    s = json.dumps(to_dict(cfg), indent=2)
    if path:
        with open(path, "w") as f:
            f.write(s + "\n")
    return s


def from_json(src: str) -> RunConfig:
    """Parse a RunConfig from a JSON string or a path to one."""
    try:
        data = json.loads(src)
    except json.JSONDecodeError:
        with open(src) as f:
            data = json.load(f)
    return from_dict(RunConfig, data)


def apply_overrides(cfg: RunConfig, overrides: dict) -> RunConfig:
    """Apply dotted-path overrides, e.g. {'detection.sigma': 2.0}; an
    unknown key raises KeyError."""
    data = to_dict(cfg)
    for key, value in overrides.items():
        node = data
        parts = key.split(".")
        for p in parts[:-1]:
            if not isinstance(node.get(p), dict):
                raise KeyError(f"unknown config key {key!r}")
            node = node[p]
        if parts[-1] not in node:
            raise KeyError(f"unknown config key {key!r}")
        node[parts[-1]] = value
    return from_dict(RunConfig, data)
