"""Job kind `rl`: one multi-view Richardson-Lucy run of a staged runner.

Set-up makes the configuration's inputs on the card from the seed
(`gen/<config generator>.py`), hands the port copies of them, stages a
`DeconvolutionRunner` (the port's host CP decomposition and matrix
staging included) and warms up with one job. A job is
`DeconvolutionRunner.run()`, the whole estimate back on the device; the
harness keeps a seeded sample of the estimates, and after the window
each is compared with the plain float32 FFT reference
(`reference/rl.py`) on the same inputs.

Parameters: the configuration's `deconvolution` group, then the
traffic's; the reference reads the same values (the configuration states
every one of them that the reference uses).
"""

from __future__ import annotations

import torch

from benchmark import roofline
from benchmark.harness import BENCH, load_module
from benchmark.reference import rl as ref
from spim_registration_tpu_torch.deconv import (
    DeconvolutionParameters,
    DeconvolutionRunner,
    DeconvolutionViews,
)
from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc


def parameters(config: dict, traffic: dict) -> dict:
    return {**config.get("deconvolution", {}),
            **traffic.get("deconvolution", {})}


def make_inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    gen = load_module(BENCH / "gen" / f"{config['generator']}.py",
                      f"bench_gen_{config['generator']}")
    return gen.rl_inputs(config, traffic, seed, device)


def kernel_bounds(runner, iterations: int) -> tuple:
    """The bound (seconds, `roofline.bound_s`) of all zpass and of all
    sl_rows launches of one job, launch by launch: each lowrank kernel
    entry at the quantization phase its view update uses (phase (i + v)
    of iteration i, view v), at that matrix's own rank and band; and the
    launches of each in one job."""
    out = {"zpass": 0.0, "sl_rows": 0.0}
    n = 0
    if runner.params.conv_backend != "lowrank":
        return out, {"zpass": 0, "sl_rows": 0}
    pairs = list(zip(runner.k1_ffts, runner.k2_ffts))
    Z, Y, X = runner.img_shape
    cache = {}

    def bound(entry, phase):
        key = (id(entry), phase)
        if key not in cache:
            Mz, My, Mx = (M[phase % M.shape[0]] for M in entry["mat"])
            R, N, P = Mz.shape
            nz = [float((M != 0).sum()) for M in (Mz, My, Mx)]
            zb = roofline.bound_s(*roofline.zpass_work(nz[0], R, N, P,
                                                       Y * X))
            sb = roofline.bound_s(*roofline.sl_rows_work(
                R, N, Y, X, My.shape[1], Mx.shape[1], nz[1], nz[2]))
            cache[key] = (zb, sb)
        return cache[key]

    for i in range(iterations):
        for v, pair in enumerate(pairs):
            for e in pair:
                if "mat" in e:
                    zb, sb = bound(e, i + v)
                    out["zpass"] += zb
                    out["sl_rows"] += sb
                    n += 1
    return out, {"zpass": n, "sl_rows": n}


class Job:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.device = device
        self.inputs = make_inputs(config, traffic, seed, device)
        self.params = parameters(config, traffic)
        inp = self.inputs
        prep = DeconvolutionViews(
            images=inp["images"].clone(), weights=inp["weights"].clone(),
            psfs=[p.copy() for p in inp["psfs"]], osem_factor=inp["osem"],
            psf_factors=inp["factors"])
        self.runner = DeconvolutionRunner(
            prep, DeconvolutionParameters(**self.params), device=device)
        self.iterations = self.runner.params.num_iterations
        V, Z, Y, X = inp["images"].shape
        self.work = {"rl_vupd_per_s": float(V * Z * Y * X
                                            * self.iterations)}
        self.sample = traffic["sample"]
        self.trace_jobs = traffic["trace_jobs"]

    def warm_up(self) -> None:
        self.run(-1)

    def run(self, i: int) -> torch.Tensor:
        out = self.runner.run()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def keep(self, i: int, answer: torch.Tensor) -> torch.Tensor:
        return answer

    def spans(self, answer) -> dict:
        return {}

    def counters(self) -> dict:
        return {"zpass": lc.zpass.launches, "sl_rows": lc.sl_rows.launches}

    def facts(self) -> dict:
        bounds, launches = kernel_bounds(self.runner, self.iterations)
        return {"iterations": self.iterations, "bound_s": bounds,
                "launches_per_job": launches}

    def free(self) -> None:
        del self.runner

    def reference(self, round_to=None) -> torch.Tensor:
        inp, p = self.inputs, self.params
        return ref.richardson_lucy(
            inp["images"], inp["weights"], inp["psfs"], inp["osem"],
            p["num_iterations"], psf_type=p["psf_type"],
            tikhonov_lambda=p["tikhonov_lambda"], min_value=p["min_value"],
            round_to=round_to)

    def check(self, kept: list) -> dict:
        """The worst kept estimate's `reference.rl.compare` numbers."""
        want = self.reference()
        worst: dict = {}
        for got in kept:
            for k, v in ref.compare(got, want).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst


def setup(config: dict, traffic: dict, seed: int, device) -> Job:
    return Job(config, traffic, seed, device)


# the precision one step below each that a configuration can state
LOWER = {"float32": torch.bfloat16, "bfloat16": torch.float8_e4m3fn}


def stated_precision(params: dict) -> str:
    """The precision the cell's convolutions are stated in: the lowrank
    backend's `lowrank_dtype`, float32 for the FFT backend."""
    if params.get("conv_backend") == "lowrank":
        return params["lowrank_dtype"]
    return "float32"


def control(job: Job) -> dict:
    """The control's numbers: the reference in the program's place,
    computed one precision below the stated one (bfloat16 for float32,
    fp8 e4m3 for the lowrank backend's bfloat16)."""
    lower = LOWER[stated_precision(job.params)]
    return ref.compare(job.reference(lower), job.reference())

