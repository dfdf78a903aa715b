"""Job kind `fuse`: content-based multi-view fusion of one timepoint.

Set-up renders the configuration's views on the card, each in its own
frame at the true poses (`gen/scene.py`: `poses`, `world_beads`,
`render_view`), and keeps them as host float32 tensors in page-locked
memory, as a loader that reads into pinned buffers hands them over; the
output box is the views' maximal bounding box (`reference/fuse.py`
`maximal_box`, what `fuse_dataset` and the CLI's `fuse` take when no box
is named). It warms up with one job. A job is one timepoint through the
CLI's `fuse` loop, `fuse/weighted_avg.py` `TimelapseFusion`: host arrays
in, the fused volume in the loop's one host array (page-locked on a
card), which the next timepoint overwrites. Each answer kept is a copy,
and the array is then filled with NaN (both off the job's clock), so
that rows a job leaves unwritten fail the check. The harness keeps a
seeded sample of the answers; after the window each is compared, slab
by slab on the card, with the plain reference (`reference/fuse.py`) on
the same views, over the voxels that the reference's summed weight does
not leave out; where those left out are more than the traffic's
`max_left_out_share` of the box, the check reads NaN.

A port without `TimelapseFusion` fuses each timepoint into a new
pageable array, whose pages a job faults in as the copies reach them
(4.4-4.8 s of a 13.7-14.2 s job on one H100, and six runs' p95 spread
5.2% between quartiles): the kind refuses it at set-up, naming what it
lacks.

Parameters: the configuration's `fusion` group, as far as the reference
computes it (blending on, linear samples, no downsampling, the maximal
box); the reference reads the same values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.gen import scene
from benchmark.gen import volumes as gv
from benchmark.harness import CellError
from benchmark.reference import fuse as ref
from spim_registration_tpu_torch.core.dataset import BoundingBox
from spim_registration_tpu_torch.fuse import weighted_avg
from spim_registration_tpu_torch.fuse.weights import (
    BlendingParameters,
    ContentBasedParameters,
)


def fusion_parameters(p: dict) -> weighted_avg.FusionParameters:
    """The port's parameters from the configuration's `fusion` group."""
    return weighted_avg.FusionParameters(
        use_blending=p["use_blending"],
        use_content_based=p["use_content_based"],
        blending=BlendingParameters(border=tuple(p["border"]),
                                    blending_range=tuple(
                                        p["blending_range"])),
        content=ContentBasedParameters(p["sigma1"], p["sigma2"]),
        downsample=p["downsample"], interpolation=p["interpolation"])


def require_timelapse_fusion() -> None:
    """Raises where the port has no fusion loop over timepoints."""
    if not hasattr(weighted_avg, "TimelapseFusion"):
        raise CellError("the port cannot fuse timepoints into one host "
                        "array: fuse/weighted_avg.py lacks TimelapseFusion")


def require_reference_semantics(p: dict) -> None:
    """Raises where the `fusion` group asks for what the reference does
    not compute."""
    wanted = {"use_blending": True, "interpolation": "linear",
              "downsample": 1, "bounding_box": "maximal"}
    for key, v in wanted.items():
        if p[key] != v:
            raise ValueError(f"the fuse kind's reference computes fusion "
                             f"{key} = {v!r}, not {p[key]!r}")


def render_views(config: dict, models: list, seed: int, device) -> list:
    """The views of the run's beads, each rendered on `device` and kept
    as a host float32 tensor (page-locked where `device` is a card)."""
    world = scene.world_beads(config, seed, device)
    g = gv.generator(seed, device, 2)
    pin = torch.device(device).type == "cuda"
    views = []
    for v, pts in enumerate(scene.to_view(models, world)):
        img = scene.render_view(config, pts, v, g, device)
        host = torch.empty(img.shape, dtype=torch.float32, pin_memory=pin)
        host.copy_(img)
        del img
        views.append(host)
    return views


class Job:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        require_timelapse_fusion()
        self.params = config["fusion"]
        require_reference_semantics(self.params)
        self.device = torch.device(device)
        self.models = scene.poses(config)
        self.views = render_views(config, self.models, seed, self.device)
        self.lo, self.hi = ref.maximal_box(config["shape"], self.models)
        self.box = BoundingBox("max", self.lo, self.hi)
        self.fusion = weighted_avg.TimelapseFusion(
            fusion_parameters(self.params), self.device)
        self.max_left_out = traffic["max_left_out_share"]
        self.work = dict(traffic["work"])
        self.sample = traffic["sample"]
        self.trace_jobs = traffic["trace_jobs"]
        self._want = None

    def warm_up(self) -> None:
        self.run(-1).fill(np.nan)

    def run(self, i: int) -> np.ndarray:
        out = self.fusion(self.views, self.models, self.box)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def keep(self, i: int, answer: np.ndarray) -> np.ndarray:
        """A copy of the answer; the array it lies in is filled with NaN
        for the next job."""
        kept = answer.copy()
        answer.fill(np.nan)
        return kept

    def spans(self, answer) -> dict:
        return {}

    def counters(self) -> dict:
        return dict(getattr(weighted_avg, "COUNTERS", {}))

    def facts(self) -> dict:
        """What one job moves: the views to the card, the box back."""
        return {"views": len(self.views),
                "h2d_bytes_per_job": sum(4 * v.numel() for v in self.views),
                "d2h_bytes_per_job": 4 * int(np.prod(self.box.shape))}

    def free(self) -> None:
        """The loop and its output array go; the views stay for the
        check."""
        self.fusion = None

    def reference(self, round_to=None) -> ref.Fusion:
        return ref.Fusion(self.views, self.models, self.lo, self.hi,
                          self.params, self.device, round_to)

    def want(self) -> ref.Fusion:
        """The float32 reference, staged once."""
        if self._want is None:
            self._want = self.reference()
        return self._want

    def check(self, kept: list) -> dict:
        """The worst kept answer's `reference.fuse.Comparison` numbers."""
        cmp = [ref.Comparison(self.max_left_out) for _ in kept]
        for z0, z1, fused, wsum in self.want().slabs():
            for c, got in zip(cmp, kept):
                c.add(torch.from_numpy(got[z0:z1]), fused, wsum)
        worst: dict = {}
        for c in cmp:
            for k, v in c.numbers().items():
                w = worst.get(k)
                worst[k] = v if w is None or math.isnan(v) or v > w else w
        return worst


def setup(config: dict, traffic: dict, seed: int, device) -> Job:
    return Job(config, traffic, seed, device)


def control(job: Job) -> dict:
    """The control's numbers: the reference on views and content weights
    stored in bfloat16, one below the configuration's float32, in the
    program's place."""
    low = job.reference(torch.bfloat16)
    cmp = ref.Comparison(job.max_left_out)
    for (z0, z1, fused, wsum), (_, _, got, _) in zip(job.want().slabs(),
                                                     low.slabs()):
        cmp.add(got, fused, wsum)
    return cmp.numbers()
