"""Job kind `mesh`: the z-sharded multi-view Richardson-Lucy deployment
on several cards, as `deconvolve --mesh z=N` runs it.

Set-up makes the configuration's inputs as a host stack
(`gen/<generator>.py`, each view made on the first card), builds the
traffic's mesh (`"mesh"`, e.g. "z=4") over the cell's cards with
`mesh_from_spec` and stages `sharded_deconvolution_runner(...,
device_result=True)` on it, shard by shard, then warms up with one job.
A job is one run of the staged runner, returned once every card has
finished; its answer, the per-card shards of the estimate, stays on the
cards. After the window each kept answer is compared with the plain
float32 reference streamed through the first card
(`reference/rl_streamed.py`, once a check) on the same inputs: over the
volume, and over the rows within two kernel half-supports of a shard
boundary (`nrmse_seams`), where an exchange between cards gone wrong
shows first.

A port without shard-by-shard staging would hold the whole stack, its
products and the start on the host and stage every shard from there;
set-up refuses it at once, naming what it lacks.

Parameters: the configuration's `deconvolution` group, then the
traffic's; the reference reads the same values.
"""

from __future__ import annotations

import torch

from benchmark import roofline
from benchmark.harness import BENCH, CellError, load_module
from benchmark.jobs.rl import LOWER, parameters, stated_precision
from benchmark.reference import rl_streamed as ref
from spim_registration_tpu_torch.deconv import (
    DeconvolutionParameters,
    DeconvolutionViews,
)
from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc
from spim_registration_tpu_torch.parallel import halo, sharded
from spim_registration_tpu_torch.parallel.mesh import mesh_from_spec
from spim_registration_tpu_torch.utils import profiling


def require_shard_staging() -> None:
    """Raises where the port lacks what this kind needs to stage a stack
    that one host process must not hold whole: the shard-by-shard
    staging entry and the staging span."""
    lacks = [what for what, has in (
        ("the shard-by-shard staging entry parallel/sharded.py "
         "stage_slabs", hasattr(sharded, "stage_slabs")),
        ("the staging span spim/mesh.stage (utils/profiling.py "
         "MESH_STAGE)", hasattr(profiling, "MESH_STAGE"))) if not has]
    if lacks:
        raise CellError("the port cannot stage this cell: it lacks "
                        + " and ".join(lacks))


def make_inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    gen = load_module(BENCH / "gen" / f"{config['generator']}.py",
                      f"bench_gen_{config['generator']}")
    return gen.rl_inputs(config, traffic, seed, device)


def kernel_bounds(entries, iterations: int, Y: int, X: int,
                  cards: int) -> tuple:
    """The bound (seconds, `roofline.bound_s`) of all zpass and of all
    sl_rows launches of one job over `cards` positions, launch by launch:
    each view update's lowrank entries at its quantization phase (i + v),
    each output z-slab of a conv (`_z_slabs`) one launch of each kernel,
    its z pass reading the slab's window of the halo-extended shard; and
    the launches of each in one job."""
    out = {"zpass": 0.0, "sl_rows": 0.0}
    n = 0
    k1, k2 = entries
    cache = {}

    def bound(entry, phase):
        key = (id(entry), phase)
        if key not in cache:
            Mz, My, Mx = (M[phase % M.shape[0]] for M in entry["mat"])
            R, N, P = Mz.shape
            hz = (P - N) // 2
            ny, nx = float((My != 0).sum()), float((Mx != 0).sum())
            zb = sb = 0.0
            slabs = lc._z_slabs(N, R, Y, X, Mz.element_size())
            for s, e in slabs:
                nnz = float((Mz[:, s:e] != 0).sum())
                width = min(e + 2 * hz, P) - s
                zb += roofline.bound_s(*roofline.zpass_work(
                    nnz, R, e - s, width, Y * X))
                sb += roofline.bound_s(*roofline.sl_rows_work(
                    R, e - s, Y, X, My.shape[1], Mx.shape[1], ny, nx))
            cache[key] = (zb, sb, len(slabs))
        return cache[key]

    for i in range(iterations):
        for v in range(len(k1)):
            for e in (k1[v], k2[v]):
                if "mat" in e:
                    zb, sb, k = bound(e, i + v)
                    out["zpass"] += zb * cards
                    out["sl_rows"] += sb * cards
                    n += k * cards
    return out, {"zpass": n, "sl_rows": n}


class Job:
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 devices):
        require_shard_staging()
        self.device = torch.device(device)
        self.devices = list(devices)
        self.mesh = mesh_from_spec(traffic["mesh"], self.device)
        if [self.mesh.device(p) for p in range(self.mesh.size)] \
                != self.devices:
            raise CellError(f"mesh {traffic['mesh']!r} is not the cell's "
                            f"{len(self.devices)} card(s)")
        self.inputs = make_inputs(config, traffic, seed, self.device)
        self.params = parameters(config, traffic)
        inp = self.inputs
        prep = DeconvolutionViews(
            images=inp["images"], weights=inp["weights"],
            psfs=[p.copy() for p in inp["psfs"]], osem_factor=inp["osem"],
            psf_factors=inp["factors"])
        self.execute = sharded.sharded_deconvolution_runner(
            prep, DeconvolutionParameters(**self.params), self.mesh,
            device_result=True)
        self.iterations = self.params["num_iterations"]
        V, Z, Y, X = inp["images"].shape
        self.work = {"rl_vupd_per_s": float(V * Z * Y * X
                                            * self.iterations)}
        self.sample = traffic["sample"]
        self.trace_jobs = traffic["trace_jobs"]
        zl = self.execute.slab_depth
        hz = max(p.shape[0] for p in inp["psfs"]) // 2
        # rows within two kernel half-supports of a shard boundary
        self.seams = [(b - 2 * hz, b + 2 * hz)
                      for b in range(zl, Z, zl)]
        padded = self.execute.padded_depth != Z
        self.exchanges_per_job = self.iterations * V * (4 if padded else 2)
        self._want = None

    def warm_up(self) -> None:
        self.run(-1)

    def run(self, i: int) -> list:
        out = self.execute()
        for d in dict.fromkeys(self.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return out

    def keep(self, i: int, answer: list) -> list:
        return answer

    def spans(self, answer) -> dict:
        return {}

    def counters(self) -> dict:
        x = halo.halo_exchange_z
        return {"zpass": lc.zpass.launches, "sl_rows": lc.sl_rows.launches,
                "halo.exchanges": x.exchanges, "halo.peer_bytes": x.peer_bytes}

    def facts(self) -> dict:
        _, _, Y, X = self.inputs["images"].shape
        entries = self.execute.entries
        bounds, launches = (
            kernel_bounds(entries, self.iterations, Y, X, self.mesh.size)
            if entries is not None else
            ({"zpass": 0.0, "sl_rows": 0.0}, {"zpass": 0, "sl_rows": 0}))
        return {"iterations": self.iterations, "bound_s": bounds,
                "launches_per_job": launches,
                "halo_exchanges_per_job": self.exchanges_per_job}

    def free(self) -> None:
        del self.execute

    def reference(self, round_to=None) -> torch.Tensor:
        inp, p = self.inputs, self.params
        return ref.richardson_lucy(
            inp["images"], inp["weights"], inp["psfs"], inp["osem"],
            p["num_iterations"], psf_type=p["psf_type"],
            tikhonov_lambda=p["tikhonov_lambda"], min_value=p["min_value"],
            round_to=round_to, device=self.device)

    def want(self) -> torch.Tensor:
        """The float32 reference, computed once."""
        if self._want is None:
            self._want = self.reference()
        return self._want

    def check(self, kept: list) -> dict:
        """The worst kept answer's numbers (`rl_streamed.compare`)."""
        want = self.want()
        worst: dict = {}
        for shards in kept:
            for k, v in ref.compare(shards, want, self.seams).items():
                worst[k] = max(worst.get(k, 0.0), v)
        return worst


def setup(config: dict, traffic: dict, seed: int, device,
          devices=None) -> Job:
    return Job(config, traffic, seed, device, devices or [device])


def control(job: Job) -> dict:
    """The reference one precision below the stated one (fp8 e4m3 for the
    lowrank backend's bfloat16) in the program's place."""
    lower = LOWER[stated_precision(job.params)]
    return ref.compare(job.reference(lower), job.want(), job.seams)
