"""Job kind `toy`: fixed work on each device a cell gives it, for the
harness's tests of cells of several cards (no acquisition, nothing of the
port).

Set-up makes one (n, n) float32 matrix a device from the seed, on that
device. A job runs `products` steps y <- tanh(y @ m / sqrt(n)) from
y = m on every device, each device's steps queued before any device is
waited for. The check holds each kept answer against the same steps in
float64 on its device; the control computes them in bfloat16.
"""

from __future__ import annotations

import math

import torch


def step(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return torch.tanh(y @ m / math.sqrt(m.shape[0]))


def reference(m: torch.Tensor, products: int, dtype) -> torch.Tensor:
    """The job's steps on `m` in `dtype`, written apart from `step`."""
    a = m.to(dtype)
    y = a
    for _ in range(products):
        y = torch.tanh(torch.matmul(y, a) / math.sqrt(a.shape[0]))
    return y


class Job:
    def __init__(self, config: dict, traffic: dict, seed: int, devices):
        n = config["n"]
        self.devices = list(devices)
        self.mats = []
        for k, d in enumerate(self.devices):
            g = torch.Generator(device=d).manual_seed(seed + k)
            self.mats.append(torch.randn(n, n, generator=g, device=d))
        self.products = traffic["products"]
        self.work = {"toy_products_per_s":
                     float(len(self.devices) * self.products)}
        self.sample = traffic["sample"]
        self.trace_jobs = traffic["trace_jobs"]

    def warm_up(self) -> None:
        self.run(-1)

    def run(self, i: int) -> list:
        out = []
        for m in self.mats:
            y = m
            for _ in range(self.products):
                y = step(y, m)
            out.append(y)
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return out

    def keep(self, i: int, answer: list) -> list:
        return answer

    def spans(self, answer) -> dict:
        return {}

    def counters(self) -> dict:
        return {}

    def facts(self) -> dict:
        return {"cards": len(self.devices)}

    def free(self) -> None:
        pass

    def compare(self, answers: list) -> float:
        """The largest relative gap of `answers` (one a device) to the
        float64 steps."""
        worst = 0.0
        for got, m in zip(answers, self.mats):
            want = reference(m, self.products, torch.float64)
            gap = (got.double() - want).norm() / want.norm()
            worst = max(worst, float(gap))
        return worst

    def check(self, kept: list) -> dict:
        return {"rel_err": max(self.compare(a) for a in kept)}


def setup(config: dict, traffic: dict, seed: int, device,
          devices=None) -> Job:
    return Job(config, traffic, seed, devices or [device])


def control(job: Job) -> dict:
    """The steps in bfloat16 in the program's place."""
    low = [reference(m, job.products, torch.bfloat16) for m in job.mats]
    return {"rel_err": job.compare(low)}
