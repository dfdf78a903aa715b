"""Job kind `register`: the registration pass over one timepoint.

Set-up renders `timepoints` distinct timepoints of the simulated
acquisition on the card (`gen/scene.py`: a seeded drift of the whole
sample, fresh noise) and hands them over as host float32 tensors in
page-locked memory, as a loader that reads into pinned buffers gives
them (an upload from pageable memory runs at the host's memcpy speed,
which drifts from run to run); it warms up with one job. Job i registers timepoint
i mod `timepoints`: `register_views` detects the beads of every view,
matches every pair and solves for the views' affines, view 0 fixed.
Every job's models and points are kept, and after the window each is
held to the truth (`reference/register.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.gen import scene
from benchmark.reference import register as ref
from spim_registration_tpu_torch.detect import DoGParameters
from spim_registration_tpu_torch.match import PairwiseParameters
from spim_registration_tpu_torch.ops.kernels import segtopk
from spim_registration_tpu_torch.pipeline import (
    RegistrationConfig,
    register_views,
)


def pinned(a: np.ndarray) -> torch.Tensor:
    """A page-locked host copy of `a`."""
    t = torch.empty(a.shape, dtype=torch.float32, pin_memory=True)
    t.copy_(torch.from_numpy(a))
    return t


class Job:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.device = device
        made = scene.timepoints(config, traffic, seed, device)
        self.models = made["models"]
        self.world = [tp["world"] for tp in made["timepoints"]]
        pin = device.type == "cuda"
        self.views = [[pinned(v) if pin else torch.from_numpy(v)
                       for v in tp["views"]] for tp in made["timepoints"]]
        self.config = RegistrationConfig(
            detection=DoGParameters(**traffic["detection"]),
            pairwise=PairwiseParameters(**traffic["pairwise"]))
        V = len(self.models)
        self.pairs = V * (V - 1) // 2
        self.work = {"reg_views_per_s": float(V)}
        self.sample = None
        self.trace_jobs = traffic["trace_jobs"]

    def warm_up(self) -> None:
        self.run(0)

    def run(self, i: int):
        tp = i % len(self.views)
        res = register_views(self.views[tp], self.config,
                             device=self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return tp, res

    def keep(self, i: int, answer) -> tuple:
        tp, res = answer
        return (tp, [np.array(m, np.float64) for m in res.models],
                [np.array(p, np.float64) for p in res.points])

    def spans(self, answer) -> dict:
        _, res = answer
        return {"timings": dict(res.timings), "views": len(res.models),
                "pairs": self.pairs}

    def counters(self) -> dict:
        return {"segtopk": segtopk.segment_topk.launches}

    def facts(self) -> dict:
        return {}

    def free(self) -> None:
        del self.views

    def numbers(self, tp: int, models, points) -> dict:
        w = self.world[tp]
        return {"model_err_px": ref.model_err_px(models, self.models, w),
                "point_err_px": ref.point_err_px(points, self.models, w)}

    def check(self, kept: list) -> dict:
        """The worst of every kept timepoint's numbers."""
        worst: dict = {}
        for tp, models, points in kept:
            for k, v in self.numbers(tp, models, points).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst


def setup(config: dict, traffic: dict, seed: int, device) -> Job:
    return Job(config, traffic, seed, device)


def control(job: Job) -> dict:
    """The control's numbers: the truth in bfloat16 in the program's
    place, on every timepoint."""
    kept = [(tp,) + ref.control_answer(job.models, w)
            for tp, w in enumerate(job.world)]
    return job.check(kept)
