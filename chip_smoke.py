#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one CUDA card
    python3 chip_smoke.py --zpass-of DIR   # the z pass alone (see below)
    python3 chip_smoke.py --sl-rows-of DIR # the rows pass alone
    python3 chip_smoke.py --segtopk-of DIR # the segment top-k alone
    python3 chip_smoke.py --dog-of DIR     # the fused DoG alone
    python3 chip_smoke.py --zfused-of DIR  # the fully fused lowrank conv
    python3 chip_smoke.py --multihost-only # phase multihost alone

Drives the port (`spim_registration_tpu_torch`, never JAX or the JAX
package) and exits nonzero on any failure:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
   builds every CUDA kernel of `spim_registration_tpu_torch/csrc/` with
   nvcc, one process per source, all at once;
2. the deconvolution path: multi-view Richardson-Lucy at the bench
   configuration (4 views x 256^3, the committed fixture PSFs,
   efficient-Bayesian, sequential, 20 iterations) with the lowrank
   backend on the kernels and with the exact FFT backend; kernel launch
   counts over one lowrank run (the conv kernels and the view update's
   two kernels), throughput, the lowrank-vs-fft accuracy
   gate after 5 iterations and each engine's self-repeat; then a
   `torch.profiler` trace of one lowrank run: device time by kernel and
   the device's idle share;
3. kernels vs their plain PyTorch versions at the main path's shapes
   (256^3, the staged bf16 matrices of the fixture PSFs at their real
   ranks): the z pass banded, dense and at a z-slab offset, at rank 48
   (`psf_rank_hard`) and on the pipeline's 208^3 box, and the fused y/x
   rows pass banded (the main path's half-supports) and dense, on the
   208^3 box and at X = 600; error, median time of single calls (CUDA
   events), plain time, library time (for the rows pass a chain of two
   cuBLAS products and a sum), the least time the card could take
   (bound) and its fraction of the measured time; for the z pass, the
   rows pass and their library calls also the time per call launched
   back to back; then phase `rl_update`: the RL view update's two
   kernels (`ops/kernels/rl_update.py`) in every form the engine uses,
   bit for bit against their plain versions on the staged 256^3 image,
   weight and estimate and on real convolutions of it (the lowrank
   entry's output and the FFT path's strided crop), with times, the byte
   bound and launches; then phase `direct`: `ops.fftconv.direct_convolve` (one
   cuDNN conv3d, with TF32 turned on around it) against `fft_convolve`
   on the RL estimate with view 0's 19^3 PSF, both boundaries (nrmse <=
   1e-5), with its, FFT's and the zpass + sl_rows pair's times; the DoG
   of phase 8 as one conv3d with G1 - G2 against `dog_reference` (its
   time is dog's library time); the exact conv of the kernel that
   zfused's entry approximates (its time is zfused's library time);
4. the detection path at the bench configuration (8 views x 256^3,
   `detect_beads_batch` and `detect_beads`): segtopk launches per batch,
   voxels/s, peaks per view; then segtopk against its plain version,
   exactly, on the detection volume's real score field and on a dense
   adversarial field, with its times and bound;
5. the matching path at the bench configuration (8 views x 128^3, 28
   pairs, RGLDM, RANSAC, the global affine solve on the device assembly):
   pairs/s, valid pairs, residuals, and the same points through the
   port's CPU path giving identical inlier sets;
6. the reconstruction through the public entry points (simulated 4-view
   256^3 scene -> register_views -> extract_psf -> prepare_views ->
   fuse_views -> deconvolve) with the transform-error and sharpening
   checks;
7. the card against the port's plain CPU path on small inputs
   (Richardson-Lucy, detection);
8. the fused Difference-of-Gaussian kernel (`dog_fused`) on the detection
   volume at the detection configuration's sigmas and on a ragged
   anisotropic volume, against its plain version, with identical peak
   sets; the fully fused lowrank conv (`conv_lowrank_folded_zfused`) is
   held in phase 3 on the staged highest-rank matrices and at 208^3;
9. the out-of-core deconvolution (`phase_ooc`): the blocked lowrank
   engine over raw disk stores at the RL configuration (4 x 256^3, 20
   iterations, 4 blocks) and on a 512^3 box x 4 views (8 blocks, 2
   iterations), each against the in-memory engine, with walls,
   voxel-updates/s, kernel launches and the device's idle share over one
   iteration (phase 3 also holds `zfused` against the zpass + sl_rows
   pair at rank 22 on 512^3);
10. the headless CLI over one dataset XML (simulate 4 x 256^3 -> detect
   -> register -> cluster-job and cluster-merge on a copy of the
   simulated XML -> fuse -> deconvolve with the lowrank backend and with
   the FFT backend -> info; then `fuse --out-of-core`, `deconvolve
   --out-of-core --block-z 64` on a 256^3 box, `tune`, `icp-refine`),
   each verb through `cli.main` in-process: per-verb walls, kernel
   launches, the registration against the simulated truth, the merged
   job against `detect` and `register`, the sharpening, lowrank against
   FFT and each out-of-core verb against its in-memory run;
11. the timelapse and cluster path (`phase_timelapse`):
   `register_timeseries` over 3 timepoints x 4 views of 256^3 (drift
   against the truth, segtopk launches), then BASELINE config #5
   (examples/timelapse_stress.py: 2 x 2 x 2 tiles x 6 views of 96^3) at
   its per-timepoint width over 4 of its 20 timepoints: `.npy` views and
   a master XML, a `run_job` a timepoint (detection, per-tile
   registration), `merge_cluster_jobs`, stabilization against the
   reference timepoint, streaming fusion; stage walls, ms a detected
   view, registrations/s, the device's idle share over one timepoint's
   jobs and over a row of fusion blocks, one tile on the card against
   the CPU and the streamed fusion against the in-memory one;
12. the rest of the CLI (`phase_formats`) on the CLI phase's scene: the
   views as a float32 CZI -> `define --format czi` (bit for bit) and
   `define` of the `.npy` copies -> `resave --format zarr` and `n5` (4
   levels, each equal bit for bit to the CPU's pyramid, f32 and uint16)
   -> `detect` / `register` on the zarr dataset against the `.npy` copies
   (points exactly, models within CLI_CLUSTER_TOL, segtopk launches) ->
   `detect --profile` (the trace names the segtopk kernel) -> `fuse
   --out` `.npy` / `.zarr` / `.n5` (equal bit for bit) -> `deconvolve
   --out psi.n5` (zpass and sl_rows launches) -> `run_checkpointed` into
   a `ZarrCheckpointer`; the verbs that need `h5py` or `imageio` run
   where they are installed and otherwise must exit 2 naming the package;
   walls per verb and MB/s of the container writes and reads;
13. the in-process device mesh (`phase_mesh`, after the pipeline phase),
   4 positions over the visible cards (all on cuda:0 on one card): (a)
   the RL main path z-sharded through `sharded_deconvolution_runner`,
   lowrank and FFT, against the in-memory runner, with both walls, the
   launches (20 iterations x kernels x 4 shards; on both backends one
   `rl_quotient` and one `rl_update` a view and shard) and zpass and
   sl_rows held against their plain versions on the first shard conv's
   inputs;
   (b) the view axis (`view=2, z=2`, parallel scheme, stacked matrices,
   float32 and bf16); (c) the pipeline's 208^3 box on `z=3` (ragged);
   (d) the detection configuration through `detect_beads_dataset(mesh=)`
   (segtopk on every shard, held exactly against its plain version on
   the first shard's field); (e) `sharded_fuse_views` and (f)
   `register_views(mesh=)` on the pipeline scene; (g) the blocked engine
   on the mesh at 4 x 256^3 x 2 iterations; (h) the CLI verbs with
   `--mesh z=1` (and `z=N` on N > 1 cards; on one card `--mesh z=2` must
   exit 2) against the same verbs without it.
14. two processes joined by `torch.distributed` (`phase_multihost`,
   after the mesh phase): `python3 chip_smoke.py --multihost-worker RANK
   2 PORT DIR` twice, each with 2 positions on its card, so (a) the RL
   main path (lowrank, then (c) FFT) runs on phase mesh's 4 shards
   across a process boundary; (b) the ("host", "z") mesh of
   `host_z_mesh(2)` with the views data-parallel across the processes;
   (d) the detection configuration through `detect_beads_dataset(mesh=)`;
   (e) `sharded_fuse_views` on the pipeline scene's box; each against the
   same mesh on one process and the in-memory engines, with the route
   (gloo through the host where the processes share a card; a second run
   with one card a worker, NCCL, where there are two), each worker's
   launches and walls, and the bytes and host seconds of the
   cross-process hops (each worker launches `rl_quotient` and
   `rl_update` once a view and position of its own in (a) and (c)); then
   (f) the CLI's `detect`, `register` and
   `deconvolve --multihost` as two processes against the same verbs
   without it, process 1 printing and writing nothing.

Each phase prints one JSON line, and a `walls` line gives every phase's
wall; then a `kernels` JSON line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`.

`--zpass-of DIR` runs only the card phase and the z pass of DIR's
package (`zpass_alone`), `--sl-rows-of DIR` the rows pass of DIR's
package (`sl_rows_alone`), `--segtopk-of DIR` the detection batch and
the segment top-k, `--dog-of DIR` the fused DoG
(`detection_kernel_alone`), `--zfused-of DIR` the fully fused lowrank
conv (`zfused_alone`), without the result line: to compare two
checkouts, run parent, change, change, parent in one call.
`--mesh-only` runs the card, build, pipeline and mesh phases of this
checkout, without the result line, and `--multihost-only` the card,
build, pipeline and multihost phases.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and dense
# bf16 tensor-core rate; a card below its 700 W limit runs slower
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_OPS_PER_S = 989e12
# H100 SXM float32 rate outside the tensor cores (compares, adds)
PEAK_F32_OPS_PER_S = 67e12
N_VIEWS, N_ITER, SHAPE = 4, 20, (256, 256, 256)
DETECT_VIEWS, SEG, ROUNDS = 8, 512, 4
GATE_TOL = 5e-4
KERNEL_TOL_NRMSE = 1e-3
KERNEL_TOL_MAX = 2.0 ** -7       # x max|out|: one bf16 ULP of the scale
# the CLI phase's lowrank deconvolution against the FFT one: its PSFs are
# approximated to psf_rank_tol = 1e-2, so that is the limit of the output
CLI_LOWRANK_TOL = 1e-2
# the out-of-core engine against the in-memory one (both lowrank bf16 on
# the kernels: the same matrices, rounding flips of one bf16 ULP over the
# iterations); block height and the size only a blocked engine is built
# for, with its iterations cut from N_ITER for the time limit
OOC_TOL = 3e-3
OOC_BLOCK_Z = 64
OOC_BIG, OOC_BIG_ITERS = 512, 2
# streaming fusion against in-memory fusion (f32, summation order)
CLI_OOC_FUSE_TOL = 1e-5
# `icp_refine`'s matrix on the card against the CPU's (f32 fits)
CLI_ICP_TOL = 1e-4
# `cluster-job`'s registered models against the `register` verb's (the
# same points, there read back from the XML's 6 decimals)
CLI_CLUSTER_TOL = 1e-4
# the timelapse phase: `register_timeseries` timepoints at the pipeline's
# width, and BASELINE config #5 (examples/timelapse_stress.py) at its
# per-timepoint width with its timepoints cut for the time limit
TL_TPS = 3
# the formats phase's `resave --levels`: 256^3 takes all 4 (down to 32^3)
FMT_LEVELS = 4
STRESS = {"tiles": (2, 2, 2), "views": 6, "tile_size": 96,
          "beads_per_tile": 120, "overlap": 0.25, "published_tps": 20,
          "tps": 4, "fused_tps": (0, 2),
          "reduced": ["timepoints 20 -> 4 (time limit)",
                      "streaming fusion of timepoints 0 and 2 (the "
                      "reference) of the 4 (time limit)"]}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nrmse(a, b) -> float:
    """The bench's nrmse: rms difference over the range of `a`."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / (a.max() - a.min()))


def sync_all() -> None:
    """Wait for every visible card (a mesh may span several)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def sync_wall(fn):
    sync_all()
    t0 = time.perf_counter()
    out = fn()
    sync_all()
    return out, time.perf_counter() - t0


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of `fn` over `reps` calls after one warm-up.
    Each call starts on an idle card, so the host's work in front of the
    launch counts."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def cuda_ms_pipelined(fn, reps: int) -> float:
    """Device time per call of `fn` launched back to back, as the main
    path launches it: CUDA events around five batches of reps // 5 calls
    (after one warm-up), the median of the mean per call. The host's work
    overlaps the device's, so this is `cuda_ms` less the host's share."""
    fn()
    torch.cuda.synchronize()
    per = max(1, reps // 5)
    times = []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(per):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / per)
    return float(np.median(times))


def device_ms(fn, reps: int = 20) -> float:
    """Device time per call of `fn`: torch.profiler's CUDA self time of
    the kernels it launches over `reps` calls (after a warm-up), without
    the host work in front of each launch that `cuda_ms` holds, and that
    `cuda_ms_pipelined` holds too where the host is slower than the
    card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise AssertionError("the profiler saw no device time")
    return us / 1e3 / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_BF16_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def kernel_error(got, want) -> dict:
    g = got.float()
    w = want.float()
    d = (g - w).abs()
    out = {"nrmse": float(torch.sqrt((d ** 2).mean()) / (w.max() - w.min())),
           "max_abs_err": float(d.max()),
           "max_abs_out": float(w.abs().max())}
    out["ok"] = bool(out["nrmse"] <= KERNEL_TOL_NRMSE
                     and out["max_abs_err"]
                     <= KERNEL_TOL_MAX * out["max_abs_out"])
    return out


def _counters():
    from spim_registration_tpu_torch.ops.kernels import dog as kd
    from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc
    from spim_registration_tpu_torch.ops.kernels import rl_update as ru
    from spim_registration_tpu_torch.ops.kernels import segtopk as st

    return {"zpass": lc.zpass, "sl_rows": lc.sl_rows,
            "segtopk": st.segment_topk, "dog": kd.dog_fused,
            "zfused": lc.zfused, "rl_quotient": ru.rl_quotient,
            "rl_update": ru.rl_update}


def reset_launches() -> None:
    """Every kernel's launch count to 0 (just before a path is driven)."""
    for fn in _counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "card", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    return smi


def phase_build() -> None:
    from spim_registration_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    regs = {}
    for name in libs:
        regs[name] = [ln.strip() for ln in build.build_log(name).splitlines()
                      if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: p.name for n, p in libs.items()},
          "ptxas": regs})


def load_fixtures():
    d = np.load(ROOT / "bench_fixtures" / "psfs.npz")
    order = [1, 3, 5, 7][:N_VIEWS]    # the most oblique extraction angles
    psfs = [np.asarray(d["psfs"][i], np.float32) for i in order]
    factors = [(d[f"az_{i}"], d[f"ay_{i}"], d[f"ax_{i}"]) for i in order]
    return psfs, factors


def ramp_weights(shape, n_views):
    def ramp1d(n, rng_px=40.0):
        x = np.arange(n, dtype=np.float32)
        dd = np.minimum(x, n - 1 - x)
        return np.where(dd >= rng_px, 1.0,
                        (1.0 - np.cos(np.pi * dd / rng_px)) * 0.5)
    R = (ramp1d(shape[0])[:, None, None] * ramp1d(shape[1])[None, :, None]
         * ramp1d(shape[2])[None, None, :])
    return np.where(R > 0, 1.0 / n_views, 0.0).astype(np.float32)


def make_rl_prep(shape, psfs, factors, seed=0, n_beads=150):
    """The bench's RL input: a bead phantom blurred on the host by each
    fixture PSF, identity registration, ramp weights, osem = #views."""
    import numpy.fft as nfft

    from spim_registration_tpu_torch.deconv import DeconvolutionViews
    from spim_registration_tpu_torch.utils.simulation import render_beads

    rng = np.random.default_rng(seed)
    pts = rng.uniform(16, shape[0] - 16, size=(n_beads, 3))
    truth = render_beads(pts, shape, sigma=1.0)
    axes = (0, 1, 2)
    tf = nfft.rfftn(truth, shape, axes)
    views = []
    for p in psfs:
        kp = np.zeros(shape, np.float32)
        kp[:p.shape[0], :p.shape[1], :p.shape[2]] = p
        kp = np.roll(kp, [-(s // 2) for s in p.shape], axis=axes)
        views.append(torch.from_numpy(nfft.irfftn(
            tf * nfft.rfftn(kp, shape, axes), shape, axes)
            .astype(np.float32)).cuda())
    w = torch.from_numpy(ramp_weights(shape, len(psfs))).cuda()
    return DeconvolutionViews(
        images=torch.stack(views),
        weights=w.expand((len(psfs),) + tuple(shape)).contiguous(),
        psfs=psfs, osem_factor=float(len(psfs)), psf_factors=factors)


def rl_params(backend, n_iter):
    from spim_registration_tpu_torch.deconv import DeconvolutionParameters

    return DeconvolutionParameters(
        num_iterations=n_iter, psf_type="efficient_bayesian",
        scheme="sequential", conv_backend=backend, psf_rank=24,
        psf_rank_tol=5e-5, psf_rank_hard=48)


# The z pass's seeded cases beside the staged main-path entry: (name,
# rank, n) for an n^3 volume
ZPASS_SEEDED = (("rank48", 48, 256), ("box208", 22, 208))


def seeded_zpass(rng, rank: int, n: int) -> tuple:
    """The z matrices (bf16, on the card) mirror-folded from seeded 19-tap
    factors at `rank` for an n^3 volume, and their band windows
    (half-support 9)."""
    from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc
    from spim_registration_tpu_torch.ops.separable import folded_conv_matrices

    f = rng.standard_normal((rank, 19)) * 0.3
    mz = torch.from_numpy(folded_conv_matrices(f, f, f, (n, 32, 32))[0])
    return mz.cuda().to(torch.bfloat16), lc.band_blocks(n, n, 9)


def seeded_volume(rng, n: int) -> torch.Tensor:
    return torch.from_numpy(rng.random((n, n, n), dtype=np.float32)
                            ).cuda().to(torch.bfloat16)


def zpass_times(lc, mz, vm, wins) -> dict:
    """The z pass banded and dense and one dense bf16 `torch.matmul` on
    the same inputs, each timed single (`cuda_ms`) and back to back
    (`cuda_ms_pipelined`); the bound counts Mz's band nonzeros, vm and
    `a` once each."""
    P, J = vm.shape[0], vm[0].numel()
    fns = {"banded": lambda: lc.zpass(mz, vm, wins),
           "dense": lambda: lc.zpass(mz, vm, None),
           "library": lambda: torch.matmul(mz, vm.view(P, J))}
    out = {}
    for k, fn in fns.items():
        out[k] = cuda_ms(fn, 20)
        out[k + "_pipelined"] = cuda_ms_pipelined(fn, 20)
    nnz = float((mz != 0).sum())
    out["bytes"] = (nnz + vm.numel() + mz.shape[0] * mz.shape[1] * J) * 2
    out["ops"] = 2.0 * nnz * J
    out["bound_ms"], out["bound_by"] = bound_ms(out["bytes"], out["ops"])
    out["frac_of_bound"] = out["bound_ms"] / out["banded"]
    return out


def zpass_alone() -> None:
    """`--zpass-of DIR`: the z pass of DIR's package alone, at rank 22 and
    48 on 256^3 and rank 22 on 208^3 (`seeded_zpass`, seeded volumes,
    seed 0): errors of the banded and dense kernel against
    `zpass_reference` and `zpass_times`; then the mesh cell's launch
    (`zpass_mesh_slab`). Builds only zpass; compares two checkouts within
    one call."""
    from spim_registration_tpu_torch.ops.kernels import build
    from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc

    lc._zpass_lib()
    emit({"phase": "zpass_build", "ptxas": [
        ln.strip() for ln in build.build_log("zpass").splitlines()
        if "registers" in ln or "spill" in ln]})
    rng = np.random.default_rng(0)
    bad = []
    for name, rank, n in (("rank22", 22, 256),) + ZPASS_SEEDED:
        mz, wins = seeded_zpass(rng, rank, n)
        vm = seeded_volume(rng, n)
        want = lc.zpass_reference(mz, vm)
        errs = {"banded": kernel_error(lc.zpass(mz, vm, wins), want),
                "dense": kernel_error(lc.zpass(mz, vm, None), want)}
        del want
        bad += [f"{name} {k}" for k, e in errs.items() if not e["ok"]]
        plan = getattr(lc, "zpass_plan", None)
        emit({"phase": "zpass", "case": name, "rank": rank, "shape": n,
              "windows": wins, "plan": plan(n, wins) if plan else None,
              "errors": errs, "times_ms": zpass_times(lc, mz, vm, wins)})
        del mz, vm
        torch.cuda.empty_cache()
    bad += zpass_mesh_slab(lc, rng)
    if bad:
        raise AssertionError(f"zpass disagrees with its plain version: {bad}")


# The mesh cell's z-pass launch: a card's first z-slab of a 1024-wide
# z=4 shard (256 planes in two slabs of 128 rows) over its halo-extended
# rows, P = 256 + 19 - 1 = 274 (rows not 16-byte aligned), at rank 16
MESH_SLAB = {"rank": 16, "rows": 128, "planes": 256, "taps": 19,
             "yx": 1024}


def zpass_mesh_slab(lc, rng) -> list:
    """The mesh cell's z-pass launch (`MESH_SLAB`): the first slab's rows
    of the z band matrices (`deconv.blocked._z_band_matrices`) from seeded
    19-tap factors, windows `band_blocks(128, 274, 9, 9)`, a seeded
    274 x 1024 x 1024 volume. Errors against `zpass_reference`,
    `zpass_times`, and the same launch on the aligned copy (Mz and vm
    zero-padded to 280 columns and rows, the same windows), which must
    equal it bit for bit; where the package counts the launches that read
    Mz from padded rows (`zpass.mz_padded`), that count of the two
    launches. Returns the failed checks."""
    from spim_registration_tpu_torch.deconv.blocked import _z_band_matrices

    c = MESH_SLAB
    hz = (c["taps"] - 1) // 2
    f = rng.standard_normal((c["rank"], c["taps"])) * 0.3
    mz = torch.from_numpy(_z_band_matrices(f, c["planes"])[:, :c["rows"]]
                          .astype(np.float32)).cuda().to(torch.bfloat16)
    P = mz.shape[2]
    wins = lc.band_blocks(c["rows"], P, hz, hz)
    vm = torch.from_numpy(rng.random((P, c["yx"], c["yx"]), dtype=np.float32)
                          ).cuda().to(torch.bfloat16)
    pad = -P % 8
    mz_al = torch.nn.functional.pad(mz, (0, pad)).contiguous()
    vm_al = torch.nn.functional.pad(vm, (0, 0, 0, 0, 0, pad)).contiguous()
    before = getattr(lc.zpass, "mz_padded", None)
    got = lc.zpass(mz, vm, wins)
    got_al = lc.zpass(mz_al, vm_al, wins)
    padded = (None if before is None else lc.zpass.mz_padded - before)
    equal = bool(torch.equal(got, got_al))
    del got_al
    want = lc.zpass_reference(mz, vm)
    errs = {"banded": kernel_error(got, want)}
    del got, want
    torch.cuda.empty_cache()
    times = zpass_times(lc, mz, vm, wins)
    times["aligned"] = cuda_ms(lambda: lc.zpass(mz_al, vm_al, wins), 20)
    times["aligned_pipelined"] = cuda_ms_pipelined(
        lambda: lc.zpass(mz_al, vm_al, wins), 20)
    emit({"phase": "zpass", "case": "mesh_slab", **c, "P": P,
          "P_aligned": P + pad, "windows": wins,
          "plan": lc.zpass_plan(P, wins), "errors": errs,
          "bitwise_aligned": equal, "mz_padded": padded,
          "times_ms": times})
    del mz, vm, mz_al, vm_al
    torch.cuda.empty_cache()
    return ([f"mesh_slab {k}" for k, e in errs.items() if not e["ok"]]
            + ([] if equal else ["mesh_slab aligned copy"]))


# The rows pass's seeded cases: (name, rank, (Z, Y, X), whether the dense
# window is timed too); half-support 9 on y and x
SL_ROWS_SEEDED = (("rank22", 22, (256, 256, 256), True),
                  ("box208", 22, (208, 208, 208), True),
                  ("x600", 22, (32, 256, 600), True))


def seeded_sl_rows(seed: int, rank: int, shape) -> tuple:
    """A seeded z-pass output `a` (R, Z, Y, X) and the y and x matrices
    mirror-folded from seeded 19-tap factors (half-support 9), bf16 on the
    card."""
    from spim_registration_tpu_torch.ops.separable import folded_conv_matrices

    Z, Y, X = shape
    f = np.random.default_rng(seed).standard_normal((rank, 19)) * 0.3
    _, my, mx = folded_conv_matrices(f, f, f, (Y, Y, X))
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.rand((rank, Z, Y, X), generator=g, device="cuda")
    return (a.to(torch.bfloat16),) + tuple(
        torch.from_numpy(M).cuda().to(torch.bfloat16) for M in (my, mx))


def sl_rows_chain(a, My, Mx):
    """The rows pass as one chain of PyTorch calls, a time yardstick only:
    two batched cuBLAS bf16 products (the x product is rounded to bf16 as
    well, which the kernel does not do) and a sum over ranks in f32."""
    b = torch.matmul(My[:, None], a)
    c = torch.matmul(b, Mx.transpose(1, 2)[:, None])
    return c.sum(dim=0, dtype=torch.float32)


def sl_rows_banded(lc):
    """`lc.sl_rows` with half-supports, or its dense form where the
    package's `sl_rows` takes none (a checkout before band windows)."""
    if "rad_y" in inspect.signature(lc.sl_rows).parameters:
        return lc.sl_rows
    return lambda a, My, Mx, rad_y=None, rad_x=None: lc.sl_rows(a, My, Mx)


def sl_rows_times(lc, a, My, Mx, rads, dense: bool, reps: int = 20) -> dict:
    """The rows pass banded (`rads` = (rad_y, rad_x)), dense where `dense`,
    and `sl_rows_chain` on the same inputs, each timed single (`cuda_ms`)
    and back to back (`cuda_ms_pipelined`); the bound counts `a` once,
    My's and Mx's band nonzeros once, `o` once, and the band's
    products."""
    banded = sl_rows_banded(lc)
    fns = {"banded": lambda: banded(a, My, Mx, *rads),
           "library": lambda: sl_rows_chain(a, My, Mx)}
    if dense:
        fns["dense"] = lambda: lc.sl_rows(a, My, Mx)
    out = {}
    for k, fn in fns.items():
        out[k] = cuda_ms(fn, reps)
        out[k + "_pipelined"] = cuda_ms_pipelined(fn, reps)
    R, Z, Y, X = a.shape
    Yo, Xo = My.shape[1], Mx.shape[1]
    nnz = lambda M: float((M != 0).sum())              # noqa: E731
    out["bytes"] = (a.numel() + nnz(My) + nnz(Mx)) * 2 + Z * Yo * Xo * 4
    out["ops"] = 2.0 * Z * (nnz(My) * X + Yo * nnz(Mx)) \
        + float(R) * Z * Yo * Xo
    out["dense_ops"] = 2.0 * R * Z * Yo * X * (Y + Xo)
    out["bound_ms"], out["bound_by"] = bound_ms(out["bytes"], out["ops"])
    out["frac_of_bound"] = out["bound_ms"] / out["banded"]
    return out


def sl_rows_case(lc, a, My, Mx, rads, dense: bool) -> dict:
    """One rows-pass case: errors of the kernel banded (`rads` = (rad_y,
    rad_x)) and, where `dense`, dense against `fused_sl_reference`, both
    plans (None in a checkout before band windows) and `sl_rows_times`."""
    banded = sl_rows_banded(lc)
    new = banded is lc.sl_rows
    want = lc.fused_sl_reference(a, My, Mx)
    errs = {"banded": kernel_error(banded(a, My, Mx, *rads), want)}
    if dense:
        errs["dense"] = kernel_error(lc.sl_rows(a, My, Mx), want)
    del want
    Y, X = a.shape[2:]
    Yo, Xo = My.shape[1], Mx.shape[1]
    plans = None
    if new:
        bb = lc.band_blocks
        plans = {"banded": list(lc.sl_rows_plan(Y, X, Yo, Xo,
                                                bb(Yo, Y, rads[0]),
                                                bb(Xo, X, rads[1]))),
                 "dense": list(lc.sl_rows_plan(Y, X, Yo, Xo))}
    return {"rad": list(rads) if new else None, "plan": plans,
            "errors": errs,
            "times_ms": sl_rows_times(lc, a, My, Mx, rads, dense)}


def sl_rows_alone() -> None:
    """`--sl-rows-of DIR`: the rows pass of DIR's package alone on
    `SL_ROWS_SEEDED` (X = 600 only where the package's `sl_rows` takes
    half-supports), each through `sl_rows_case`. Builds only sl_rows;
    compares two checkouts within one call."""
    from spim_registration_tpu_torch.ops.kernels import build
    from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc

    lc._sl_rows_lib()
    emit({"phase": "sl_rows_build", "ptxas": [
        ln.strip() for ln in build.build_log("sl_rows").splitlines()
        if "registers" in ln or "spill" in ln]})
    new = sl_rows_banded(lc) is lc.sl_rows
    bad = []
    for seed, (name, rank, shape, dense) in enumerate(SL_ROWS_SEEDED):
        if shape[2] > 512 and not new:
            continue
        a, My, Mx = seeded_sl_rows(seed, rank, shape)
        case = sl_rows_case(lc, a, My, Mx, (9, 9), dense)
        bad += [f"{name} {k}" for k, e in case["errors"].items()
                if not e["ok"]]
        emit({"phase": "sl_rows", "case": name, "rank": rank,
              "shape": list(shape), **case})
        del a, My, Mx
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"sl_rows disagrees with its plain version: "
                             f"{bad}")


def detection_kernel_alone(name: str) -> None:
    """`--segtopk-of DIR` / `--dog-of DIR`: one detection kernel of DIR's
    package alone on the detection volume, through the full run's own
    phases: `phase_detect` (the 8-view detection batch that launches
    segtopk, its walls and profile) and `phase_segtopk` (the real and
    dense fields at 32768 x 512 x 4, exactness flags), or `phase_dog` (the
    detection volume at its effective sigmas and the ragged 21 x 33 x 47
    case, errors and peak sets), each kernel with single and back-to-back
    times, plain time and bound. Builds only that kernel; compares two
    checkouts within one call."""
    from spim_registration_tpu_torch.ops.kernels import build, dog, segtopk

    (segtopk if name == "segtopk" else dog)._lib()
    emit({"phase": f"{name}_build", "ptxas": [
        ln.strip() for ln in build.build_log(name).splitlines()
        if "registers" in ln or "spill" in ln]})
    vol = detection_volume()
    if name == "segtopk":
        phase_detect(vol)
        torch.cuda.empty_cache()
        phase_segtopk(vol)
    else:
        phase_dog(vol)


def phase_kernels(runner) -> dict:
    """Each kernel against its plain version at the main path's shapes:
    the highest-rank matrix entry of the staged lowrank runner; the z pass
    also on `ZPASS_SEEDED` (rank 48 on the RL estimate, rank 22 on a
    seeded 208^3 volume), the rows pass (`sl_rows_case`) also on the
    seeded 208^3 box and X = 600 of `SL_ROWS_SEEDED`."""
    from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc

    entries = [e for e in runner.k1_ffts + runner.k2_ffts if "mat" in e]
    entry = max(entries, key=lambda e: e["mat"][0].shape[1])
    Mz, My, Mx = (M[0] for M in entry["mat"])
    rad_z, rad_y, rad_x = entry["rad"]
    R, N, P = Mz.shape
    vm = runner.psi0.to(torch.bfloat16).contiguous()
    Z, Y, X = vm.shape
    wins = lc.band_blocks(N, P, rad_z)
    s0 = N // 2
    mz_slab = Mz[:, s0:].contiguous()
    wins_slab = lc.band_blocks(N - s0, P, rad_z, off=s0)
    cases = {}
    for name, mz, w in (("banded", Mz, wins), ("dense", Mz, None),
                        ("slab", mz_slab, wins_slab)):
        got = lc.zpass(mz, vm, w)
        cases[name] = kernel_error(got, lc.zpass_reference(mz, vm))
        cases[name]["windows"] = None if w is None else [list(x) for x in w]
    zp = {"main": zpass_times(lc, Mz, vm, wins)}
    plans = {"main": list(lc.zpass_plan(P, wins))}
    rng = np.random.default_rng(5)
    for name, rank, n in ZPASS_SEEDED:
        mz, w = seeded_zpass(rng, rank, n)
        v = vm if n == Z else seeded_volume(rng, n)
        cases[name] = kernel_error(lc.zpass(mz, v, w),
                                   lc.zpass_reference(mz, v))
        cases[name]["windows"] = [list(x) for x in w]
        plans[name] = list(lc.zpass_plan(n, w))
        zp[name] = zpass_times(lc, mz, v, w)
        del mz, v
    a = lc.zpass(Mz, vm, wins)
    sl = {"main": sl_rows_case(lc, a, My, Mx, (rad_y, rad_x), True)}
    for seed, (name, rank, shape, dense) in enumerate(SL_ROWS_SEEDED[1:], 1):
        sa, smy, smx = seeded_sl_rows(seed, rank, shape)
        sl[name] = sl_rows_case(lc, sa, smy, smx, (9, 9), dense)
        del sa, smy, smx
        torch.cuda.empty_cache()
    for name, case in sl.items():
        for form, err in case.pop("errors").items():
            cases["sl_rows" + ("" if name == "main" else f"_{name}")
                  + ("" if form == "banded" else "_dense")] = err
    torch.cuda.synchronize()

    times = {
        "zpass_plain": cuda_ms(lambda: lc.zpass_reference(Mz, vm), 5),
        "sl_rows_plain": cuda_ms(lambda: lc.fused_sl_reference(a, My, Mx),
                                 5),
    }
    result = {"phase": "kernels", "rank": R, "shape": [Z, Y, X],
              "rad": [rad_z, rad_y, rad_x], "cases": cases,
              "times_ms": times, "zpass": zp, "zpass_plan": plans,
              "sl_rows": sl,
              "sl_rows_library": "torch.matmul(My[:, None], a), then "
                                 "torch.matmul(., Mx^T[:, None]), then an "
                                 "f32 sum over r: three calls that also "
                                 "round the x product to bf16"}
    emit(result)
    bad = [k for k, c in cases.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    zp_err = max(cases[k]["max_abs_err"] for k in cases
                 if not k.startswith("sl_rows"))
    sl_err = max(cases[k]["max_abs_err"] for k in cases
                 if k.startswith("sl_rows"))
    m = zp["main"]
    s = sl["main"]["times_ms"]
    return {
        "zfused": phase_zfused(entry, runner.psi0),
        "zpass": {"name": "zpass", "route": "cuda",
                  "source": "spim_registration_tpu_torch/csrc/zpass.cu",
                  "replaces": "spim_registration_tpu/ops/pallas/"
                              "lowrank_conv.py:200 (_zpass_banded_kernel) "
                              "and :188 (_zpass_kernel)",
                  "max_abs_err": zp_err, "ms": m["banded"],
                  "ms_pipelined": m["banded_pipelined"],
                  "dense_ms": m["dense"], "plain_ms": times["zpass_plain"],
                  "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
                  "library_ms": m["library"],
                  "library_ms_pipelined": m["library_pipelined"],
                  "frac_of_bound": m["frac_of_bound"]},
        "sl_rows": {"name": "sl_rows", "route": "cuda",
                    "source": "spim_registration_tpu_torch/csrc/sl_rows.cu",
                    "replaces": "spim_registration_tpu/ops/pallas/"
                                "lowrank_conv.py:65 (_sl_rows_kernel)",
                    "max_abs_err": sl_err, "ms": s["banded"],
                    "ms_pipelined": s["banded_pipelined"],
                    "dense_ms": s["dense"],
                    "plain_ms": times["sl_rows_plain"],
                    "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
                    "library_ms": s["library"],
                    "library_ms_pipelined": s["library_pipelined"],
                    "frac_of_bound": s["frac_of_bound"]},
    }


def same_bits(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Bit-for-bit equality of two tensors (NaNs and signed zeros by their
    bit patterns), with the count of elements that differ."""
    g, w = got.contiguous(), want.contiguous()
    if g.dtype != w.dtype or g.shape != w.shape:
        return {"ok": False, "differ": None,
                "dtypes": [str(g.dtype), str(w.dtype)]}
    it = torch.int16 if g.element_size() == 2 else torch.int32
    n = int((g.view(it) != w.view(it)).sum())
    return {"ok": n == 0, "differ": n}


def phase_rl_update(runner, psfs) -> dict:
    """The RL view update's two kernels (`csrc/rl_update.cu`) through
    their wrappers on the staged lowrank runner's 256^3 inputs: view 0's
    image and weight, the estimate psi and real convolutions of psi: the
    highest-rank matrix entry's lowrank conv (contiguous) and the FFT conv
    of view 0's PSF (`fft_convolve`'s crop of the padded inverse
    transform, a strided view), then the conv of each one's quotient.
    Every form the engine uses (delta or not; a bf16 quotient or psi copy
    or none; Tikhonov on and off) bit for bit against the plain versions,
    one launch a call; times of the main path's forms (single calls,
    back to back, profiler device time), their plain chains and the
    bound: the bytes read and written once at 3.35 TB/s."""
    from spim_registration_tpu_torch.ops.fftconv import (
        fft_convolve,
        pad_shape_for,
        prepare_kernel_fft,
    )
    from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc
    from spim_registration_tpu_torch.ops.kernels import rl_update as ru

    psi = runner.psi0
    image, weight = runner.images[0], runner.weights[0]
    osem = float(np.float32(runner.osem))
    lam = runner.lam
    min_value = float(np.float32(runner.params.min_value * runner.avg))
    entries = [e for e in runner.k1_ffts + runner.k2_ffts if "mat" in e]
    entry = max(entries, key=lambda e: e["mat"][0].shape[1])
    mats = [M[0] for M in entry["mat"]]
    k = torch.from_numpy(np.asarray(psfs[0], np.float32)).cuda()
    fs = pad_shape_for(psi.shape, k.shape)
    kf = prepare_kernel_fft(k, fs)

    def lowrank_conv(x):
        return lc.conv_lowrank_folded_fused(x, *mats, *entry["rad"])

    def fft_conv(x):
        return fft_convolve(x, None, kernel_fft=kf, fft_shape=fs,
                            boundary="mirror")

    # (conv1, conv2, the engine's delta form) of each backend
    convs = {}
    c1 = lowrank_conv(psi)
    convs["lowrank"] = (c1, lowrank_conv(ru.rl_quotient_reference(
        image, c1, True, True)), True)
    c1 = fft_conv(psi)
    convs["fft_crop"] = (c1, fft_conv(ru.rl_quotient_reference(image, c1)),
                         False)
    if convs["fft_crop"][0].is_contiguous() \
            or convs["fft_crop"][0].stride(2) != 1:
        raise AssertionError("the FFT conv is not a strided crop: "
                             f"{convs['fft_crop'][0].stride()}")
    torch.cuda.synchronize()
    reset_launches()
    cases, n_calls = {}, 0
    for name, (c1, c2, _) in convs.items():
        for delta in (False, True):
            for bf16 in (False, True):
                key = f"quotient_{name}_delta{int(delta)}_bf16{int(bf16)}"
                cases[key] = same_bits(
                    ru.rl_quotient(image, c1, delta, bf16),
                    ru.rl_quotient_reference(image, c1, delta, bf16))
                for lam_ in (lam, None):
                    got, want = psi.clone(), psi.clone()
                    out = ru.rl_update(got, c2, weight, osem, lam_,
                                       min_value, delta, bf16)
                    ref = ru.rl_update_reference(want, c2, weight, osem,
                                                 lam_, min_value, delta,
                                                 bf16)
                    key = (f"update_{name}_delta{int(delta)}_copy"
                           f"{int(bf16)}_lam{int(lam_ is not None)}")
                    cases[key] = same_bits(got, want)
                    cases[key + "_out"] = same_bits(out, ref)
                    n_calls += 1
    torch.cuda.synchronize()
    launches = read_launches()
    expected = dict.fromkeys(launches, 0)
    expected.update(rl_quotient=len(convs) * 4, rl_update=n_calls)

    n_vox = float(psi.numel())
    scratch = psi.clone()
    c1_lr, c2_lr, _ = convs["lowrank"]
    c1_ft, c2_ft, _ = convs["fft_crop"]
    # (kernel, form, call, plain chain, bytes a voxel: f32 reads and
    # writes 4, a bf16 write 2)
    forms = (
        ("rl_quotient", "lowrank",
         lambda: ru.rl_quotient(image, c1_lr, True, True),
         lambda: ru.rl_quotient_reference(image, c1_lr, True, True), 10),
        ("rl_quotient", "fft_crop",
         lambda: ru.rl_quotient(image, c1_ft),
         lambda: ru.rl_quotient_reference(image, c1_ft), 12),
        ("rl_update", "lowrank",
         lambda: ru.rl_update(scratch, c2_lr, weight, osem, lam, min_value,
                              True, True),
         lambda: ru.rl_update_reference(scratch, c2_lr, weight, osem, lam,
                                        min_value, True, True), 18),
        ("rl_update", "fft_crop",
         lambda: ru.rl_update(scratch, c2_ft, weight, osem, lam, min_value),
         lambda: ru.rl_update_reference(scratch, c2_ft, weight, osem, lam,
                                        min_value), 16),
    )
    times = {}
    for kernel, form, fn, plain, per_vox in forms:
        n_bytes = n_vox * per_vox
        bound, by = bound_ms(n_bytes, 0.0)
        t = {"ms": cuda_ms(fn, 20), "ms_pipelined": cuda_ms_pipelined(fn, 50),
             "ms_device": device_ms(fn), "plain_ms": cuda_ms(plain, 10),
             "bytes": n_bytes, "bound_ms": bound, "bound_by": by}
        t["frac_of_bound"] = bound / t["ms"]
        t["frac_of_bound_device"] = bound / t["ms_device"]
        times[f"{kernel}_{form}"] = t
    del scratch, convs, c1_lr, c2_lr, c1_ft, c2_ft, kf
    bad = [key for key, c in cases.items() if not c["ok"]]
    emit({"phase": "rl_update", "shape": list(psi.shape),
          "entry_rank": int(mats[0].shape[0]), "rad": list(entry["rad"]),
          "lam": lam, "osem": osem, "min_value": min_value,
          "cases": cases, "launches": launches,
          "expected_launches": expected, "times_ms": times})
    if bad:
        raise AssertionError(f"rl_update kernels differ from their plain "
                             f"versions: {bad}")
    if launches != expected:
        raise AssertionError(f"rl_update launches {launches}, expected "
                             f"{expected}")
    out = {}
    for kernel, what in (
            ("rl_quotient", "q = clamp(image / clamp_min(conv1, 1e-12), 0, "
                            "1e4) [- 1], f32 or bf16"),
            ("rl_update", "psi = clamp_min(reg(psi * (1 + osem w d)), "
                          "min) in place [+ bf16 copy]")):
        main, crop = times[f"{kernel}_lowrank"], times[f"{kernel}_fft_crop"]
        out[kernel] = {
            "name": kernel, "route": "cuda",
            "source": "spim_registration_tpu_torch/csrc/rl_update.cu",
            "replaces": "the engine's plain elementwise chain "
                        "(deconv/lucy_richardson.py); no TPU kernel",
            "computes": what, "bitwise": True, "max_abs_err": 0.0,
            "ms": main["ms"], "ms_pipelined": main["ms_pipelined"],
            "ms_device": main["ms_device"], "plain_ms": main["plain_ms"],
            "bytes": main["bytes"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"],
            "frac_of_bound": main["frac_of_bound"],
            "frac_of_bound_device": main["frac_of_bound_device"],
            "fft_crop_ms_device": crop["ms_device"],
            "fft_crop_bound_ms": crop["bound_ms"],
            "fft_crop_plain_ms": crop["plain_ms"],
            "library_ms": None,
            "library": "none: the plain version is a chain of PyTorch "
                       "elementwise kernels (plain_ms)"}
    return out


def zfused_plan_info(lc, shape, rads):
    """The package's `zfused_plan` for a shape and half-supports as a
    dict (tile rows, windows, x stage rows, shared memory, MACs a voxel
    and rank), or None in a checkout without one."""
    plan = getattr(lc, "zfused_plan", None)
    p = plan(*shape, *rads) if plan else None
    if p is None:
        return None
    return {"z": list(p.z), "y": list(p.y), "x": list(p.x), "nx": p.nx,
            "smem": p.smem, "macs_per_voxel": p.macs_per_voxel(),
            "axes": "n, h, window, tile, origin offset"}


# zfused's seeded cases beside the 512^3 box: (name, rank, n) for an n^3
# volume, 19 taps per axis (half-supports 9)
ZFUSED_SEEDED = (("rank22", 22, 256), ("box208", 22, 208))


def seeded_zfused(rng, rank: int, n: int, h: int = 9) -> tuple:
    """Band matrices mirror-folded from seeded (2h + 1)-tap factors on
    every axis of an n^3 volume (bf16 on the card) and a seeded f32
    volume on the card."""
    from spim_registration_tpu_torch.ops.separable import folded_conv_matrices

    mats = [torch.from_numpy(M).cuda().to(torch.bfloat16)
            for M in folded_conv_matrices(
                *[rng.standard_normal((rank, 2 * h + 1)) * 0.3
                  for _ in range(3)], (n, n, n))]
    vol = torch.from_numpy(rng.random((n,) * 3).astype(np.float32)).cuda()
    return mats, vol


def zfused_alone() -> None:
    """`--zfused-of DIR`: the fully fused lowrank conv of DIR's package
    alone, at rank 22 on seeded 256^3 and 208^3 volumes (`ZFUSED_SEEDED`,
    seed 0) against `conv_lowrank_folded` and against the zpass + sl_rows
    pair, and on `zfused_512`'s box against the pair; each case with its
    plan and the kernel's and the pair's times (`cuda_ms`) in this call.
    Builds only zfused; compares two checkouts within one call."""
    from spim_registration_tpu_torch.ops.kernels import build
    from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc
    from spim_registration_tpu_torch.ops.separable import conv_lowrank_folded

    lc._zfused_lib()
    emit({"phase": "zfused_build", "ptxas": [
        ln.strip() for ln in build.build_log("zfused").splitlines()
        if "registers" in ln or "spill" in ln]})
    rng = np.random.default_rng(0)
    bad = []
    h = 9
    for name, rank, n in ZFUSED_SEEDED:
        mats, vol = seeded_zfused(rng, rank, n, h)
        vm = vol.to(torch.bfloat16)
        got = lc.zfused(vm, *mats, h, h, h)
        errs = {"plain": kernel_error(got, conv_lowrank_folded(vol, *mats)),
                "pair": kernel_error(got, lc.conv_lowrank_folded_fused(
                    vm, *mats, h, h, h).to(vm.dtype))}
        del got
        bad += [f"{name} {k}" for k, e in errs.items() if not e["ok"]]
        times = {"ms": cuda_ms(lambda: lc.zfused(vm, *mats, h, h, h), 10),
                 "pair_ms": cuda_ms(lambda: lc.conv_lowrank_folded_fused(
                     vm, *mats, h, h, h).to(vm.dtype), 10)}
        emit({"phase": "zfused", "case": name, "rank": rank, "shape": n,
              "plan": zfused_plan_info(lc, (n, n, n), (h, h, h)),
              "errors": errs, "times_ms": times})
        del mats, vol, vm
        torch.cuda.empty_cache()
    big = zfused_512(rng)
    if not big["error"]["ok"]:
        bad.append("box512 pair")
    emit({"phase": "zfused", "case": "box512", **big})
    if bad:
        raise AssertionError(f"zfused disagrees: {bad}")


def phase_zfused(entry, psi) -> dict:
    """The fully fused lowrank conv (kernel #6) through its entry point
    `conv_lowrank_folded_zfused` on the staged highest-rank entry (the
    main path's matrices and half-supports) and the RL estimate psi:
    against the plain chain `conv_lowrank_folded` and against the
    zpass + sl_rows pair; then a ragged 208^3 case (rank 22, 19 taps per
    axis, random factors); times, bound and launches."""
    from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc
    from spim_registration_tpu_torch.ops.separable import conv_lowrank_folded

    Mz, My, Mx = (M[0] for M in entry["mat"])
    rads = entry["rad"]
    rz = rads[0]
    ry, rx = lc.band_radius(My), lc.band_radius(Mx)
    R = Mz.shape[0]
    Z, Y, X = psi.shape
    reset_launches()
    got = lc.conv_lowrank_folded_zfused(psi, Mz, My, Mx, hz=rz)
    torch.cuda.synchronize()
    launches = read_launches()
    cases = {"plain": kernel_error(got, conv_lowrank_folded(psi, Mz, My,
                                                            Mx)),
             "pair": kernel_error(got, lc.conv_lowrank_folded_fused(
                 psi, Mz, My, Mx, *rads))}
    rng = np.random.default_rng(4)
    n = 208
    mats, vol = seeded_zfused(rng, R, n)
    cases["ragged_208"] = kernel_error(
        lc.conv_lowrank_folded_zfused(vol, *mats, hz=9),
        conv_lowrank_folded(vol, *mats))
    del mats, vol
    big = zfused_512(rng)
    cases["box512_vs_pair"] = big.pop("error")
    vm = psi.to(torch.bfloat16).contiguous()
    times = {"ms": cuda_ms(lambda: lc.zfused(vm, Mz, My, Mx, rz, ry, rx),
                           10),
             "plain_ms": cuda_ms(lambda: conv_lowrank_folded(vm, Mz, My, Mx),
                                 3),
             "pair_ms": cuda_ms(lambda: lc.conv_lowrank_folded_fused(
                 vm, Mz, My, Mx, *rads).to(vm.dtype), 10)}
    # the kernel reads only the band of each matrix: its nonzeros
    nnz = lambda M: float((M != 0).sum())              # noqa: E731
    n_bytes = float(vm.numel() * 2 + Z * Y * X * 4) \
        + (nnz(Mz) + nnz(My) + nnz(Mx)) * 2
    n_ops = 2.0 * (nnz(Mz) * Y * X + nnz(My) * Z * X + nnz(Mx) * Z * Y) \
        + float(R) * Z * Y * X
    bound, by = bound_ms(n_bytes, n_ops)
    emit({"phase": "kernels", "kernel": "zfused", "rank": R, "rad": [rz, ry,
                                                                    rx],
          "shape": [Z, Y, X], "cases": cases, "times_ms": times,
          "plans": {"entry": zfused_plan_info(lc, (Z, Y, X), (rz, ry, rx)),
                    "ragged_208": zfused_plan_info(lc, (n,) * 3, (9,) * 3)},
          "bytes": n_bytes, "ops": n_ops, "bound_ms": bound,
          "launches": launches, "box512": big})
    bad = [k for k, c in cases.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"zfused disagrees on {bad}")
    if launches["zfused"] != 1:
        raise AssertionError(f"zfused launches {launches}")
    return {"name": "zfused", "route": "cuda",
            "source": "spim_registration_tpu_torch/csrc/zfused.cu",
            "replaces": "spim_registration_tpu/ops/pallas/"
                        "lowrank_conv.py:430 (_zfused_kernel)",
            "launches": launches["zfused"],
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "pair_ms": times["pair_ms"], "box512_ms": big["ms"],
            "box512_pair_ms": big["pair_ms"], "bound_ms": bound,
            "bound_by": by, "library_ms": None}


def zfused_512(rng) -> dict:
    """`zfused` at rank 22 on a 512^3 box (19 taps per axis, seeded
    factors, half-supports 9), where the zpass + sl_rows pair holds a
    5.9 GB `a` intermediate (two z-slabs under `_A_SLAB_BYTES`): its
    error against the pair and both times (`cuda_ms`) in one call."""
    from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc
    from spim_registration_tpu_torch.ops.separable import folded_conv_matrices

    n, R, h = OOC_BIG, 22, 9
    mats = [torch.from_numpy(M).cuda().to(torch.bfloat16)
            for M in folded_conv_matrices(
                *[rng.standard_normal((R, 2 * h + 1)) * 0.3
                  for _ in range(3)], (n, n, n))]
    g = torch.Generator(device="cuda").manual_seed(8)
    vm = torch.rand((n, n, n), generator=g, device="cuda").to(torch.bfloat16)

    def fused():
        return lc.zfused(vm, *mats, h, h, h)

    def pair():
        return lc.conv_lowrank_folded_fused(vm, *mats, h, h, h).to(vm.dtype)

    err = kernel_error(fused(), pair())
    torch.cuda.empty_cache()
    out = {"rank": R, "shape": [n, n, n], "rad": [h, h, h], "error": err,
           "plan": zfused_plan_info(lc, (n,) * 3, (h,) * 3),
           "a_bytes": R * n ** 3 * 2,
           "pair_slabs": len(lc._z_slabs(n, R, n, n, 2)),
           "ms": cuda_ms(fused, 5), "pair_ms": cuda_ms(pair, 5)}
    del mats, vm
    torch.cuda.empty_cache()
    return out


def phase_dog(vol: np.ndarray) -> dict:
    """The fused DoG (kernel #5) through `dog_fused` on the detection
    volume (normalized as detection normalizes it) at the detection
    configuration's effective sigmas, against `dog_reference`, with the
    peak sets of `find_peaks_localized` on both; then a ragged anisotropic
    21 x 33 x 47 case; times, bound and launches."""
    from spim_registration_tpu_torch.detect import (
        DoGParameters,
        effective_sigmas,
    )
    from spim_registration_tpu_torch.ops.extrema import find_peaks_localized
    from spim_registration_tpu_torch.ops.gaussian import dog_sigmas
    from spim_registration_tpu_torch.ops.kernels import dog as kd

    params = DoGParameters(sigma=1.8, threshold=0.004)
    s1 = effective_sigmas(params)
    s2 = tuple(s * 2.0 ** (1.0 / params.steps_per_octave) for s in s1)
    norm = np.float32(dog_sigmas(params.sigma, params.threshold)[2])
    v = torch.from_numpy(vol).cuda()
    v = (v - v.min()) / torch.clamp(v.max() - v.min(), min=1e-12)
    reset_launches()
    got = kd.dog_fused(v, s1, s2)
    torch.cuda.synchronize()
    launches = read_launches()
    want = kd.dog_reference(v, s1, s2)
    tol = 1e-5 * float(v.abs().max())
    err = float((got - want).abs().max())

    def peaks(dog):
        pos, _, ok, _ = find_peaks_localized(dog * norm, params.threshold,
                                             params.max_peaks)
        p = pos[ok].cpu().numpy()
        return p[np.lexsort(np.round(p).T)]

    pk, pp = peaks(got), peaks(want)
    same = pk.shape == pp.shape and np.array_equal(np.round(pk),
                                                   np.round(pp))
    rng = np.random.default_rng(6)
    small = torch.from_numpy(rng.normal(size=(21, 33, 47)).astype(
        np.float32)).cuda()
    a1, a2 = (1.2, 1.8, 1.8), (1.5, 2.2, 2.2)
    err_small = float((kd.dog_fused(small, a1, a2)
                       - kd.dog_reference(small, a1, a2)).abs().max())
    tol_small = 1e-5 * float(small.abs().max())
    fused = lambda: kd.dog_fused(v, s1, s2)                # noqa: E731
    times = {"ms": cuda_ms(fused, 20),
             "ms_pipelined": cuda_ms_pipelined(fused, 20),
             "ms_device": device_ms(fused),
             "plain_ms": cuda_ms(lambda: kd.dog_reference(v, s1, s2), 10)}
    _, radii = kd.dog_taps(s1, s2)
    taps = float((2 * radii + 1).sum())
    n_vox = float(v.numel())
    t_bytes = 2 * n_vox * 4 / PEAK_BYTES_PER_S * 1e3
    # f32 instructions a voxel of the cheapest separable form: x reads one
    # input for both sigmas, so each mirrored pair is added once for both
    # (max radius adds) and each sigma takes r + 1 FMAs; y and z read two
    # inputs, 2r + 1 FMAs a sigma (the z pass folds the difference into
    # negated taps). An add takes an FMA's issue slot, so the rate is
    # half the 67 TFLOP/s, which counts an FMA as two operations.
    (r1z, r1y, r1x), (r2z, r2y, r2x) = radii.tolist()
    instr = (max(r1x, r2x) + r1x + r2x + 2
             + 2 * (r1y + r2y + 1) + 2 * (r1z + r2z + 1))
    t_ops = n_vox * 2 * instr / PEAK_F32_OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    plan = getattr(kd, "dog_plan", None)
    emit({"phase": "dog", "shape": list(vol.shape), "sigma1": list(s1),
          "sigma2": list(s2), "radii": radii.tolist(), "max_abs_err": err,
          "tol": tol, "peaks": [len(pk), len(pp)], "same_peaks": same,
          "max_peak_pos_diff_px": (float(np.abs(pk - pp).max())
                                   if same and len(pk) else None),
          "ragged": {"shape": [21, 33, 47], "sigma1": a1, "sigma2": a2,
                     "max_abs_err": err_small, "tol": tol_small},
          "plan": (plan(*vol.shape, kd._lib().spim_dog_radius(
              int(radii.max())), torch.cuda.get_device_properties(
                  0).multi_processor_count)._asdict() if plan else None),
          "times_ms": times, "taps_per_voxel": taps,
          "f32_instructions_per_voxel": instr, "bytes_ms": t_bytes,
          "ops_ms": t_ops, "bound_ms": bound,
          "frac_of_bound": bound / times["ms"],
          "frac_of_bound_pipelined": bound / times["ms_pipelined"],
          "frac_of_bound_device": bound / times["ms_device"],
          "launches": launches})
    if not (err <= tol and err_small <= tol_small):
        raise AssertionError(f"dog_fused differs from its plain version: "
                             f"{err} (tol {tol}), ragged {err_small}")
    if not same or len(pk) < 380:
        raise AssertionError(f"dog_fused peaks {len(pk)} vs plain "
                             f"{len(pp)}, same sites {same}")
    if launches["dog"] != 1:
        raise AssertionError(f"dog_fused launches {launches}")
    return {"name": "dog", "route": "cuda",
            "source": "spim_registration_tpu_torch/csrc/dog.cu",
            "replaces": "spim_registration_tpu/ops/pallas/dog.py:115 "
                        "(dog_pallas inner kernel)",
            "launches": launches["dog"], "max_abs_err": max(err, err_small),
            "ms": times["ms"], "ms_pipelined": times["ms_pipelined"],
            "ms_device": times["ms_device"],
            "plain_ms": times["plain_ms"], "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


DIRECT_TOL = 1e-5       # nrmse of direct_convolve against fft_convolve
DIRECT_REPS = 5


def dev_nrmse(a: torch.Tensor, b: torch.Tensor) -> float:
    """`nrmse` on the card, in float64, over the range of `b`."""
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).mean().sqrt() / (b.max() - b.min()))


def dog_as_one_kernel(s1, s2) -> np.ndarray:
    """blur(s1) - blur(s2) as one non-separable kernel: the outer products
    of `dog_taps`' 1-D taps, G1 zero-padded to G2's radius, less G2."""
    from spim_registration_tpu_torch.ops.kernels import dog as kd

    taps, radii = kd.dog_taps(s1, s2)
    R = radii.max(axis=0)
    out = np.zeros(tuple(2 * R + 1), np.float64)
    for s, sign in ((0, 1.0), (1, -1.0)):
        kz, ky, kx = (taps[s, a, :2 * radii[s, a] + 1].astype(np.float64)
                      for a in range(3))
        lo = R - radii[s]
        out[lo[0]:lo[0] + kz.size, lo[1]:lo[1] + ky.size,
            lo[2]:lo[2] + kx.size] += sign * np.einsum("i,j,k->ijk", kz, ky,
                                                        kx)
    return out.astype(np.float32)


def phase_direct(runner, psfs, vol: np.ndarray, smi: str) -> dict:
    """`ops.fftconv.direct_convolve` (one cuDNN `conv3d`) at full width:
    (a) on the RL estimate (256^3 f32) with view 0's fixture PSF (19^3)
    against `fft_convolve`, mirror and zero boundary, with TF32 turned on
    around the calls (the function must keep f32 by itself), times of
    single calls beside FFT's and the zpass + sl_rows pair's on that
    PSF's staged entry; (b) the DoG of phase dog as one convolution with
    G1 - G2 against `dog_reference`, its time the dog kernel's library
    time; (c) the exact convolution of the kernel that phase kernels'
    zfused entry approximates, its time zfused's library time."""
    from spim_registration_tpu_torch.deconv.lucy_richardson import (
        compound_kernels,
    )
    from spim_registration_tpu_torch.detect import (
        DoGParameters,
        effective_sigmas,
    )
    from spim_registration_tpu_torch.ops.fftconv import (
        direct_convolve,
        fft_convolve,
        pad_shape_for,
        prepare_kernel_fft,
    )
    from spim_registration_tpu_torch.ops.kernels import dog as kd
    from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc

    psi = runner.psi0
    n_vox = float(psi.numel())
    k = torch.from_numpy(psfs[0]).cuda()
    a = {"shape": list(psi.shape), "kernel": list(k.shape),
         "f32_ops_bound_ms": 2 * n_vox * k.numel()
         / PEAK_F32_OPS_PER_S * 1e3}
    ok = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        for b in ("mirror", "zero"):
            d = direct_convolve(psi, k, b)
            if not torch.backends.cudnn.allow_tf32:
                raise AssertionError("direct_convolve left TF32 changed")
            f = fft_convolve(psi, k, boundary=b)
            a[f"nrmse_{b}"] = dev_nrmse(d, f)
            a[f"finite_{b}"] = bool(torch.isfinite(d).all())
            ok &= (a[f"nrmse_{b}"] <= DIRECT_TOL and a[f"finite_{b}"]
                   and d.shape == psi.shape)
            del d, f
            a[f"direct_ms_{b}"] = cuda_ms(
                lambda b=b: direct_convolve(psi, k, b), DIRECT_REPS)
            a[f"fft_ms_{b}"] = cuda_ms(
                lambda b=b: fft_convolve(psi, k, boundary=b), DIRECT_REPS)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    fs = pad_shape_for(psi.shape, k.shape)
    kf = prepare_kernel_fft(k, fs)
    a["fft_prepared_ms_mirror"] = cuda_ms(lambda: fft_convolve(
        psi, None, kernel_fft=kf, fft_shape=fs), DIRECT_REPS)
    del kf
    e0 = runner.k1_ffts[0]
    if "mat" in e0:
        Mz, My, Mx = (M[0] for M in e0["mat"])
        a["pair_rank"] = int(Mz.shape[0])
        a["pair_ms"] = cuda_ms(lambda: lc.conv_lowrank_folded_fused(
            psi, Mz, My, Mx, *e0["rad"]), DIRECT_REPS)
    else:
        a["pair_ms"] = "view 0's PSF runs on the FFT fallback"
    torch.cuda.empty_cache()

    params = DoGParameters(sigma=1.8, threshold=0.004)
    s1 = effective_sigmas(params)
    s2 = tuple(s * 2.0 ** (1.0 / params.steps_per_octave) for s in s1)
    v = torch.from_numpy(vol).cuda()
    v = (v - v.min()) / torch.clamp(v.max() - v.min(), min=1e-12)
    g = torch.from_numpy(dog_as_one_kernel(s1, s2)).cuda()
    err = float((direct_convolve(v, g, "mirror")
                 - kd.dog_reference(v, s1, s2)).abs().max())
    tol = 1e-5 * float(v.abs().max())
    dog = {"shape": list(v.shape), "sigma1": list(s1), "sigma2": list(s2),
           "kernel": list(g.shape), "max_abs_err": err, "tol": tol,
           "ms": cuda_ms(lambda: direct_convolve(v, g, "mirror"),
                         DIRECT_REPS)}
    ok &= err <= tol
    del v, g
    torch.cuda.empty_cache()

    kernels = list(psfs) + compound_kernels(psfs, runner.params.psf_type)
    entries = list(runner.k1_ffts) + list(runner.k2_ffts)
    top = max((i for i, e in enumerate(entries) if "mat" in e),
              key=lambda i: entries[i]["mat"][0].shape[1])
    kz = torch.from_numpy(np.asarray(kernels[top], np.float32)).cuda()
    Mz, My, Mx = (M[0] for M in entries[top]["mat"])
    exact = direct_convolve(psi, kz, "mirror")
    zf = {"entry": ("k1" if top < len(psfs) else "k2")
          + f"[{top % len(psfs)}]", "rank": int(Mz.shape[0]),
          "kernel": list(kz.shape),
          "lowrank_pair_vs_exact_nrmse": dev_nrmse(
              lc.conv_lowrank_folded_fused(psi, Mz, My, Mx,
                                           *entries[top]["rad"]), exact),
          "exact_ms": cuda_ms(lambda: direct_convolve(psi, kz, "mirror"),
                              DIRECT_REPS)}
    del exact
    torch.cuda.empty_cache()
    emit({"phase": "direct", "nvidia_smi": smi, "tol_nrmse": DIRECT_TOL,
          "a_rl_shape": a, "b_dog": dog, "c_zfused_exact": zf})
    if not ok:
        raise AssertionError("direct_convolve disagrees (phase direct)")
    return {"dog_ms": dog["ms"], "zfused_exact_ms": zf["exact_ms"]}


def write_store(path: str, vol: torch.Tensor):
    """A raw float32 store of a (Z, Y, X) card tensor, written in z-slabs."""
    from spim_registration_tpu_torch.native_blocks import RawVolumeStore

    st = RawVolumeStore(path, tuple(vol.shape), create=True)
    for z0 in range(0, vol.shape[0], OOC_BLOCK_Z):
        st.write_block((z0, 0, 0), vol[z0:z0 + OOC_BLOCK_Z].cpu().numpy())
    return st


def phantom_views(shape, psfs, seed: int, n_beads: int) -> torch.Tensor:
    """A seeded bead phantom (sigma 1, 16 px from the faces) blurred on the
    card by each PSF (circular FFT conv), plus 0.01: (V, Z, Y, X)."""
    from spim_registration_tpu_torch.ops.fftconv import prepare_kernel_fft
    from spim_registration_tpu_torch.utils.simulation import render_beads

    rng = np.random.default_rng(seed)
    pts = rng.uniform(16, np.array(shape) - 16, size=(n_beads, 3))
    tf = torch.fft.rfftn(torch.from_numpy(render_beads(pts, shape,
                                                       sigma=1.0)).cuda())
    views = torch.empty((len(psfs),) + tuple(shape), device="cuda")
    for v, p in enumerate(psfs):
        kf = prepare_kernel_fft(torch.from_numpy(p).cuda(), shape)
        views[v] = torch.clamp(torch.fft.irfftn(tf * kf, s=shape), min=0.0)
    del tf
    return views.add_(0.01)


def ooc_block_kernels(name, runner, psi_store, img_stores) -> dict:
    """`zpass` and `sl_rows` against their plain versions at the block
    shapes the out-of-core run gave them: for an edge block and an
    interior block of the first view whose two kernels run lowrank, the
    stage-1 band (R, bz + 2 r2z, bz + 2 r2z + 2 rz) over psi's halo rows
    read from the store and the stage-2 band (R, bz, bz + 2 rz) over
    q - 1 (q from the plain stage 1 and the image's halo rows), with the
    runner's own entries (dither phase 0): the z pass with its windows
    centred at rz against `zpass_reference`, the rows pass with its y/x
    windows on the plain `a` against `fused_sl_reference`, and the block
    conv's entry point (`conv_lowrank_folded_fused`, z_off = rz) against
    the plain chain of the two. Returns each kernel's largest error."""
    from spim_registration_tpu_torch.deconv.blocked import _mirror_q_edges
    from spim_registration_tpu_torch.native_blocks import read_mirror_z
    from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc

    Z = runner.shape[0]
    bz, hz, r2z = runner.bz, runner.hz, runner.r2z
    lr = [v for v in range(len(runner.e1))
          if "mat" in runner.e1[v] and "mat" in runner.e2[v]]
    if not lr:
        raise AssertionError(f"ooc {name}: no view runs both convs lowrank")
    v = lr[0]

    def load(store, lo, hi):
        return torch.from_numpy(read_mirror_z(store, lo, hi)).cuda()

    cases, bands = {}, {}
    for where, z0 in (("edge", 0), ("interior", bz * (Z // bz // 2))):
        x = load(psi_store, z0 - hz, z0 + bz + hz)
        img_ext = load(img_stores[v], z0 - r2z, z0 + bz + r2z)
        for stage, entry, trim in ((1, runner.e1[v], runner.t1[v]),
                                   (2, runner.e2[v], runner.t2[v])):
            Tz, My, Mx = (M[0] for M in entry["mat"])
            rz, ry, rx = entry["rad"]
            xp = x[trim:x.shape[0] - trim] if trim else x
            vm = xp.to(Tz.dtype).contiguous()
            R, N, P = Tz.shape
            a_ref = lc.zpass_reference(Tz, vm)
            want = lc.fused_sl_reference(a_ref, My, Mx)
            key = f"{where}_stage{stage}"
            bands[key] = {"z0": z0, "band": [R, N, P],
                          "plane": list(vm.shape[1:]), "rad": [rz, ry, rx]}
            cases[key + "_zpass"] = kernel_error(
                lc.zpass(Tz, vm, lc.band_blocks(N, P, rz, off=rz)), a_ref)
            cases[key + "_sl_rows"] = kernel_error(
                lc.sl_rows(a_ref, My, Mx, ry, rx), want)
            cases[key + "_conv"] = kernel_error(lc.conv_lowrank_folded_fused(
                xp, Tz, My, Mx, rz, ry, rx, z_off=rz), want)
            del a_ref
            if stage == 1:
                q = torch.clamp(img_ext / torch.clamp(want, min=1e-12),
                                0.0, 1e4)
                x = _mirror_q_edges(q, z0 - r2z, Z) - 1.0
            del want
        torch.cuda.empty_cache()
    emit({"phase": "ooc_block_kernels", "case": name, "view": v,
          "bands": bands, "cases": cases})
    bad = [k for k, c in cases.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"ooc {name}: the block kernels disagree with "
                             f"their plain versions: {bad}")
    return {k: max(c["max_abs_err"] for n, c in cases.items()
                   if n.endswith("_" + k)) for k in ("zpass", "sl_rows")}


def ooc_case(name, images, weights, psfs, factors, n_iter,
             workdir) -> tuple:
    """One out-of-core case: the in-memory lowrank run of the inputs
    (the reference; its staging and its run timed apart, the run's wall
    including the copy of psi to the host), then the inputs into raw
    stores under `workdir` and the blocked lowrank run at OOC_BLOCK_Z
    with its launch counts (from 0 just before it), wall,
    voxel-updates/s and nrmse against the in-memory run; then the block
    kernels against their plain versions (`ooc_block_kernels`) and a
    profile of one more iteration (resumed from the psi store): device
    busy time and idle share. Returns (launch counts, the block
    kernels' largest errors)."""
    from spim_registration_tpu_torch.deconv import (
        DeconvolutionRunner,
        DeconvolutionViews,
    )
    from spim_registration_tpu_torch.deconv.blocked import (
        BlockedDeconvolutionInputs,
        BlockedDeconvolutionRunner,
    )
    from spim_registration_tpu_torch.native_blocks import RawVolumeStore

    V = images.shape[0]
    shape = tuple(images.shape[1:])
    params = rl_params("lowrank", n_iter)
    prep = DeconvolutionViews(images=images, weights=weights, psfs=psfs,
                              osem_factor=float(V), psf_factors=factors)
    mem, mem_stage_s = sync_wall(lambda: DeconvolutionRunner(prep, params))
    ref, mem_s = sync_wall(lambda: mem.run().cpu().numpy())
    del prep, mem
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    img_st = [write_store(os.path.join(workdir, f"img{v}.raw"), images[v])
              for v in range(V)]
    w_st = [write_store(os.path.join(workdir, f"w{v}.raw"), weights[v])
            for v in range(V)]
    stores_s = time.perf_counter() - t0
    psi = RawVolumeStore(os.path.join(workdir, "psi.raw"), shape,
                         create=True)
    inputs = BlockedDeconvolutionInputs(img_st, w_st, psfs, float(V),
                                        psf_factors=factors)
    runner, stage_s = sync_wall(lambda: BlockedDeconvolutionRunner(
        inputs, psi, params, block_z=OOC_BLOCK_Z))
    reset_launches()
    _, wall = sync_wall(runner.run)
    launches = read_launches()
    got = psi.read_block((0, 0, 0), shape)
    err = nrmse(ref, got)
    n_blocks = shape[0] // OOC_BLOCK_Z
    n_mat = sum("mat" in e for e in runner.e1 + runner.e2)
    expected = n_iter * n_blocks * n_mat
    block_errs = ooc_block_kernels(name, runner, psi, img_st)
    prof = device_profile(lambda: runner.run(num_iterations=1,
                                             init_psi=False))
    out = {"case": name, "shape": list(shape), "views": V, "iters": n_iter,
           "block_z": OOC_BLOCK_Z, "blocks": n_blocks,
           "mat_kernels": n_mat, "fft_kernels": 2 * V - n_mat,
           "in_memory_staging_s": mem_stage_s, "in_memory_s": mem_s,
           "stores_s": stores_s, "staging_s": stage_s,
           "wall_s": wall,
           "voxel_updates_per_s": float(np.prod(shape)) * V * n_iter / wall,
           "in_memory_voxel_updates_per_s":
               float(np.prod(shape)) * V * n_iter / mem_s,
           "nrmse_vs_in_memory": err, "tol": OOC_TOL,
           "launches": launches, "expected_launches": expected,
           "block_kernels_max_abs_err": block_errs,
           "profile_one_iteration": {k: prof[k] for k in (
               "wall_s", "device_busy_s", "idle_share", "top")}}
    emit({"phase": "ooc", **out})
    if not (got.shape == shape and np.all(np.isfinite(got))):
        raise AssertionError(f"ooc {name}: bad output")
    if not err <= OOC_TOL:
        raise AssertionError(f"ooc {name}: nrmse {err} > {OOC_TOL}")
    if launches["zpass"] != expected or launches["sl_rows"] != expected:
        raise AssertionError(f"ooc {name}: launches {launches}, expected "
                             f"{expected} of zpass and sl_rows")
    return launches, block_errs


def phase_ooc(psfs, factors) -> dict:
    """The out-of-core deconvolution (`BlockedDeconvolutionRunner` over
    `RawVolumeStore`s in a temporary directory of the checkout, lowrank
    bf16 on the kernels) through `ooc_case`: at the RL main path's
    configuration (4 views x 256^3, 20 iterations, block_z 64: 4 blocks)
    and on a 512^3 box x 4 views (8 blocks; seeded bead phantom blurred
    on the card by the fixture PSFs; OOC_BIG_ITERS iterations, cut from
    N_ITER for the time limit only). Where the disk cannot take the big
    case's stores, its z is cut (a multiple of the block height) and the
    reason printed. Returns the launch counts of the 256^3 run and each
    block kernel's largest error against its plain version over both
    cases (`ooc_block_kernels`)."""
    import shutil
    import tempfile

    from spim_registration_tpu_torch.native_blocks import native_path

    emit({"phase": "ooc_io", "block_io": native_path()})
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_ooc_smoke_") as d:
        prep = make_rl_prep(SHAPE, psfs, factors)
        launches, errs = ooc_case("main", prep.images, prep.weights, psfs,
                                  factors, N_ITER, d)
        del prep
        torch.cuda.empty_cache()
    big = [OOC_BIG] * 3
    vol_bytes = 4 * OOC_BIG ** 3
    # image + weight per view, psi and its scratch, and slack
    need = (2 * N_VIEWS + 2) * vol_bytes * 1.2
    free = shutil.disk_usage(ROOT).free
    reduced = []
    if free < need:
        z = int(OOC_BIG * free / need) // OOC_BLOCK_Z * OOC_BLOCK_Z
        if z < OOC_BLOCK_Z:
            raise AssertionError(f"ooc big: {free} bytes free on disk, "
                                 f"{need:.0f} needed")
        reduced.append(f"z {OOC_BIG} -> {z}: {free} bytes free on disk, "
                       f"{need:.0f} needed")
        big[0] = z
    reduced.append(f"iterations {N_ITER} -> {OOC_BIG_ITERS} (time limit)")
    emit({"phase": "ooc_big_setup", "shape": big, "reduced": reduced,
          "disk_free_bytes": free})
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_ooc_smoke_") as d:
        images = phantom_views(tuple(big), psfs, seed=7,
                               n_beads=150 * 8 * big[0] // OOC_BIG)
        w = torch.from_numpy(ramp_weights(tuple(big), N_VIEWS)).cuda()
        weights = w.expand((N_VIEWS,) + tuple(big)).contiguous()
        del w
        _, big_errs = ooc_case("big", images, weights, psfs, factors,
                               OOC_BIG_ITERS, d)
        del images, weights
        torch.cuda.empty_cache()
    return launches, {k: max(errs[k], big_errs[k]) for k in errs}


def phase_cli() -> None:
    """The headless CLI on one dataset XML, each verb through `cli.main`
    in-process in a temporary directory of the checkout: simulate 4 views
    of 256^3 (300 beads, per-view PSF blur, seed 11) -> detect -> register
    -> fuse -> deconvolve (lowrank, 10 iterations; the raw extracted PSFs
    decompose to 1% at ranks ~20, hence psf_rank_tol=0.01) -> the same
    deconvolve on the exact FFT backend, which the lowrank output is held
    against (nrmse <= CLI_LOWRANK_TOL) -> info; then the out-of-core
    verbs: `fuse --out-of-core` held against `fuse` (CLI_OOC_FUSE_TOL),
    and on a 256^3 box from `define-bbox` (z a multiple of the block
    height) the lowrank `deconvolve --out-of-core --block-z 64` held
    against the in-memory `deconvolve` of the box (OOC_TOL); `tune` on
    view (0, 0); `icp-refine` on a copy of the registered XML. The two
    new verbs' library calls are also held card against CPU on their
    inputs: `sweep_detection`'s peak counts exact, each view's
    `icp_refine` matrix within CLI_ICP_TOL. `cluster-job --tp 0` and
    `cluster-merge` run on a copy of the simulated XML taken before
    `detect`: the merged points equal `detect`'s, the merged models
    `register`'s within CLI_CLUSTER_TOL."""
    import contextlib
    import io
    import shutil
    import tempfile

    from spim_registration_tpu_torch import cli
    from spim_registration_tpu_torch.core.xml_io import load_dataset
    from spim_registration_tpu_torch.detect.tune import sweep_detection
    from spim_registration_tpu_torch.fuse.bounding_box import (
        maximal_bounding_box,
    )
    from spim_registration_tpu_torch.match.icp import icp_refine

    walls, launches, logs = {}, {}, {}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_cli_smoke_") as d:
        xml = os.path.join(d, "dataset.xml")
        fused_p, psi_p, fft_p, fused_ooc_p, box_p, box_ooc_p = (
            os.path.join(d, f) for f in (
                "fused.npy", "psi.npy", "psi_fft.npy", "fused_ooc.npy",
                "psi_box.npy", "psi_box_ooc.npy"))
        icp_xml = os.path.join(d, "icp.xml")
        # the cluster verbs run on a copy of the simulated XML in a
        # directory of its own (its interest point files apart from the
        # main XML's), beside links to the same volumes
        cdir = os.path.join(d, "cluster")
        cxml, cjob = (os.path.join(cdir, f) for f in ("dataset.xml",
                                                      "job_tp0.xml"))
        lowrank = ["--set", "deconvolution.conv_backend=lowrank",
                   "--set", "deconvolution.num_iterations=10",
                   "--set", "deconvolution.psf_rank_tol=0.01"]
        verbs = {
            "simulate": ["simulate", "--out", d, "--views", str(N_VIEWS),
                         "--shape", *map(str, SHAPE), "--beads", "300",
                         "--blur", "--seed", "11"],
            "detect": ["detect", xml],
            "register": ["register", xml],
            "cluster_job": ["cluster-job", cxml, "--tp", "0", "--out",
                            cjob],
            "cluster_merge": ["cluster-merge", cxml, cjob],
            "fuse": ["fuse", xml, "--out", fused_p],
            "deconvolve": ["deconvolve", xml, "--out", psi_p, *lowrank],
            "deconvolve_fft": ["deconvolve", xml, "--out", fft_p,
                               "--set", "deconvolution.conv_backend=fft",
                               "--set", "deconvolution.num_iterations=10"],
            "info": ["info", xml],
            "fuse_ooc": ["fuse", xml, "--out", fused_ooc_p, "--out-of-core"],
            "define_bbox": ["define-bbox", xml, "ooc", "--min", "0", "0",
                            "0", "--max", *map(str, SHAPE)],
            "deconvolve_box": ["deconvolve", xml, "--bbox", "ooc", "--out",
                               box_p, *lowrank],
            "deconvolve_ooc": ["deconvolve", xml, "--bbox", "ooc", "--out",
                               box_ooc_p, *lowrank, "--out-of-core",
                               "--block-z", str(OOC_BLOCK_Z)],
            "tune": ["tune", xml, "--view", "0", "0"],
            "icp_refine": ["icp-refine", icp_xml],
        }
        for name, argv in verbs.items():
            if name == "icp_refine":
                shutil.copy(xml, icp_xml)
            if name == "detect":
                os.makedirs(cdir)
                shutil.copy(xml, cxml)
                for f in os.listdir(d):
                    if f.startswith("tp") and f.endswith(".npy"):
                        os.symlink(os.path.join(d, f),
                                   os.path.join(cdir, f))
            buf = io.StringIO()
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            launches[name] = read_launches()
            logs[name] = buf.getvalue().strip().splitlines()[-6:]
            if rc != 0:
                raise AssertionError(f"cli {name} exited {rc}: {logs[name]}")
        ds = load_dataset(xml)
        views = ds.views_of_timepoint(0)
        errs, n_pts = [], []
        for v in views:
            p = v.interest_points["beads"].points
            n_pts.append(len(p))
            A = v.model()
            T = np.load(os.path.join(d, f"truth_tp0_setup{v.setup_id}.npy"))
            errs.append(float(np.mean(np.linalg.norm(
                (p @ A[:, :3].T + A[:, 3]) - (p @ T[:, :3].T + T[:, 3]),
                axis=1))))
        names = [[t.name for t in v.transforms] for v in views]
        merged = load_dataset(cxml)
        cluster = {"points_equal_detect": [], "model_diff": [],
                   "transforms": [], "backup": os.path.exists(cxml + "~1")}
        for v in views:
            m = merged.views[v.view_id]
            a, b = m.interest_points["beads"], v.interest_points["beads"]
            cluster["points_equal_detect"].append(
                bool(np.array_equal(a.points, b.points)
                     and np.array_equal(a.intensities, b.intensities)))
            cluster["model_diff"].append(float(np.abs(
                m.model() - v.model()).max()))
            cluster["transforms"].append([t.name for t in m.transforms])
        icp_names = [[t.name for t in v.transforms]
                     for v in load_dataset(icp_xml).views_of_timepoint(0)]
        fused, psi, psi_fft, fused_ooc, box, box_ooc = (
            np.load(f) for f in (fused_p, psi_p, fft_p, fused_ooc_p, box_p,
                                 box_ooc_p))
        vol0 = cli._dataset_with_loader(xml).get_image((0, 0))
        # the two new verbs' library calls on the card against the same
        # calls on the CPU, on the verbs' own inputs
        sweeps = {dev: sweep_detection(vol0, device=dev)
                  for dev in ("cuda", "cpu")}
        del vol0
        pts_world = [v.interest_points["beads"].points
                     @ v.model()[:, :3].T + v.model()[:, 3] for v in views]
        icp_cmp = []
        for i in range(1, len(views)):
            got = {dev: icp_refine(pts_world[i], pts_world[0], device=dev)
                   for dev in ("cuda", "cpu")}
            icp_cmp.append({
                "max_abs_diff": float(np.abs(got["cuda"][0]
                                             - got["cpu"][0]).max()),
                "matches": [len(got[d][1]) for d in got],
                "residual_px": [float(got[d][2]) for d in got],
                "iters": [int(got[d][3]) for d in got]})
        bbox = maximal_bounding_box([tuple(v.size) for v in views],
                                    [v.model() for v in views])
    A0 = views[0].model()
    world = views[0].interest_points["beads"].points @ A0[:, :3].T + A0[:, 3]
    idx = np.round(world).astype(int) - np.array(bbox.min)
    idx = idx[np.all((idx >= 0) & (idx < np.array(bbox.shape)), axis=1)]
    pk_f = float(np.mean(fused[tuple(idx.T)]))
    pk_d = float(np.mean(psi[tuple(idx.T)]))
    gate = nrmse(psi_fft, psi)
    ooc = {"fuse_nrmse": nrmse(fused, fused_ooc),
           "fuse_tol": CLI_OOC_FUSE_TOL,
           "deconvolve_box_shape": list(box.shape),
           "deconvolve_nrmse": nrmse(box, box_ooc), "deconvolve_tol": OOC_TOL,
           "icp_transforms": icp_names,
           # per view against view 0: matches and residual (px), as printed
           "icp": [[int(ln.split(" matches")[0].split()[-1]),
                    float(ln.split("residual ")[1].split()[0])]
                   for ln in logs["icp_refine"] if "icp " in ln],
           "icp_card_vs_cpu": icp_cmp, "icp_tol": CLI_ICP_TOL,
           "tune_suggested": [ln for ln in logs["tune"]
                              if ln.startswith("suggested")],
           "tune_table_card": [[s, t, n] for (s, t), n
                               in sorted(sweeps["cuda"].items())],
           "tune_table_card_equals_cpu": sweeps["cuda"] == sweeps["cpu"]}
    emit({"phase": "cli", "views": N_VIEWS, "shape": list(SHAPE),
          "cluster": cluster, "cluster_model_tol": CLI_CLUSTER_TOL,
          "out_of_core_and_extras": ooc,
          "walls_s": walls, "launches": launches,
          "points_per_view": n_pts, "transforms": names,
          "transform_error_px": errs, "transform_error_tol": 0.5,
          "bbox": [list(map(int, bbox.min)), list(map(int, bbox.max))],
          "fused_shape": list(fused.shape), "psi_shape": list(psi.shape),
          "peak_fused": pk_f, "peak_deconv": pk_d,
          "sharpening": pk_d / max(pk_f, 1e-12),
          "lowrank_vs_fft_nrmse": gate, "lowrank_vs_fft_tol": CLI_LOWRANK_TOL,
          "stdout_tail": logs})
    if any(n != ["registration"] for n in names) or min(n_pts) < 100:
        raise AssertionError(f"the XML did not keep the transforms and "
                             f"points: {names}, {n_pts}")
    if not max(errs) < 0.5:
        raise AssertionError(f"cli registration error {errs} px >= 0.5")
    if launches["detect"]["segtopk"] == 0:
        raise AssertionError(f"detect did not run segtopk: {launches}")
    # the merged job gives the `detect` verb's points and, within the
    # card's f32 rounding of points read back from the XML's 6 decimals,
    # the `register` verb's models
    if not (all(cluster["points_equal_detect"])
            and max(cluster["model_diff"]) <= CLI_CLUSTER_TOL
            and all(n == ["registration"] for n in cluster["transforms"])
            and cluster["backup"]
            and launches["cluster_job"]["segtopk"] == N_VIEWS):
        raise AssertionError(f"cluster-job / cluster-merge: {cluster}, "
                             f"launches {launches['cluster_job']}")
    if launches["deconvolve"]["zpass"] == 0 \
            or launches["deconvolve"]["sl_rows"] == 0:
        raise AssertionError(f"deconvolve did not run the kernels: "
                             f"{launches['deconvolve']}")
    if not (fused.shape == psi.shape == bbox.shape
            and np.all(np.isfinite(psi))):
        raise AssertionError(f"bad outputs {fused.shape} {psi.shape}")
    if not pk_d > 1.5 * pk_f:
        raise AssertionError(f"cli deconvolution did not sharpen: {pk_d} "
                             f"vs {pk_f}")
    if not gate <= CLI_LOWRANK_TOL:
        raise AssertionError(f"cli lowrank vs fft nrmse {gate} > "
                             f"{CLI_LOWRANK_TOL}")
    if not (fused_ooc.shape == fused.shape
            and ooc["fuse_nrmse"] <= CLI_OOC_FUSE_TOL):
        raise AssertionError(f"cli fuse --out-of-core: {ooc}")
    if not (box.shape == box_ooc.shape == SHAPE
            and np.all(np.isfinite(box_ooc))
            and ooc["deconvolve_nrmse"] <= OOC_TOL):
        raise AssertionError(f"cli deconvolve --out-of-core: {ooc}")
    if launches["deconvolve_ooc"]["zpass"] == 0 \
            or launches["deconvolve_ooc"]["sl_rows"] == 0:
        raise AssertionError(f"deconvolve --out-of-core did not run the "
                             f"kernels: {launches['deconvolve_ooc']}")
    if launches["tune"]["segtopk"] == 0 or not ooc["tune_suggested"] \
            or sweeps["cuda"] != sweeps["cpu"]:
        raise AssertionError(f"tune: {launches['tune']}, {logs['tune']}, "
                             f"card {sweeps['cuda']} vs cpu "
                             f"{sweeps['cpu']}")
    if not all(c["max_abs_diff"] <= CLI_ICP_TOL for c in icp_cmp):
        raise AssertionError(f"icp_refine on the card vs the CPU: {icp_cmp}")
    # every view but the first (the reference) gains an "icp" transform,
    # newest first; as in the reference, it holds the ICP correction
    # composed with the whole earlier chain (ROADMAP.md section 3), so
    # the residuals are the measure here: the mean distance of
    # nearest-neighbour pairs within 5 px, detection noise of both
    # points included
    if icp_names[0] != ["registration"] \
            or any(n != ["icp", "registration"] for n in icp_names[1:]) \
            or len(ooc["icp"]) != N_VIEWS - 1 \
            or not all(m >= 100 and r < 1.0 for m, r in ooc["icp"]):
        raise AssertionError(f"icp-refine: {icp_names}, {ooc['icp']}")


def _fmt_placeholders(d: str) -> dict:
    """Inputs for the verbs that need `imageio`: TIFF stacks and
    MicroManager stacks, written with imageio where it is installed, and
    otherwise as empty files of the right names (the verbs must refuse
    them before reading a byte)."""
    import importlib.util

    have = importlib.util.find_spec("imageio") is not None
    tif, mm = os.path.join(d, "tiff"), os.path.join(d, "mm")
    os.makedirs(tif)
    os.makedirs(mm)
    rng = np.random.default_rng(13)
    pages = rng.integers(0, 4000, (2 * 4, 10, 12)).astype(np.uint16)
    for path, arr in ((os.path.join(tif, f"tp0_setup{s}.tif"),
                       pages[:4]) for s in range(2)):
        if have:
            import imageio.v3 as iio

            iio.imwrite(path, arr)
        else:
            open(path, "wb").close()
    path = os.path.join(mm, "acq_MMStack_Pos0.ome.tif")
    if have:
        import imageio.v3 as iio

        iio.imwrite(path, pages)
    else:
        open(path, "wb").close()
    with open(os.path.join(mm, "metadata.txt"), "w") as f:
        json.dump({"Summary": {"Frames": 1, "Slices": 4, "Channels": 2,
                               "Positions": 1, "SlicesFirst": False}}, f)
    return {"tiff": tif, "mm": mm}


def phase_formats() -> dict:
    """The rest of the CLI on the CLI phase's scene (4 x 256^3, 300
    beads, the per-view blur, seed 11, `simulate` into `.npy` views), each
    verb through `cli.main` in-process in a temporary directory of the
    checkout: the views written as a float32 CZI (`write_czi`) ->
    `define --format czi` (every view read through the CZI loader equal
    to the `.npy` bit for bit) and `define` of the `.npy` pattern ->
    `resave --format zarr` and `--format n5` (4 levels, (16, 64, 64)
    chunks; every level of both equal bit for bit to the port's
    `_pyramid` run on the CPU on the same view, f32 and the n5's uint16)
    -> `detect` and `register` on the zarr dataset against the same verbs
    on the `.npy` copies (points exactly, models within CLI_CLUSTER_TOL;
    segtopk launches) -> `detect --profile` (the trace names the segtopk
    kernel) -> `fuse --out` `.npy`, `.zarr`, `.n5` (read-backs equal the
    `.npy` bit for bit) -> `deconvolve --out psi.n5` (lowrank; zpass and
    sl_rows launches) -> `run_checkpointed(5, ZarrCheckpointer.save)`
    over 10 iterations (`load_latest` gives (10, psi) bit for bit). Last,
    the verbs that need `h5py` or `imageio` (`resave --format hdf5`,
    `fuse --append-hdf5`, `define` of TIFF stacks and of MicroManager
    stacks) run where the package is installed and otherwise must exit 2
    naming it. Walls per verb, MB/s of the container writes and reads."""
    import contextlib
    import importlib.util
    import io
    import tempfile

    from spim_registration_tpu_torch import cli
    from spim_registration_tpu_torch.core import zarr_store
    from spim_registration_tpu_torch.core.czi import write_czi
    from spim_registration_tpu_torch.core.xml_io import load_dataset
    from spim_registration_tpu_torch.deconv import (
        DeconvolutionRunner,
        extract_psf,
        prepare_views_for_deconvolution,
    )
    from spim_registration_tpu_torch.fuse.bounding_box import (
        maximal_bounding_box,
    )
    from spim_registration_tpu_torch.pipeline.config import (
        RunConfig,
        apply_overrides,
    )

    walls, launches, logs, rates = {}, {}, {}, {}
    checks = {}

    def run(name, argv, want_rc=0):
        out, err = io.StringIO(), io.StringIO()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        launches[name] = read_launches()
        logs[name] = (out.getvalue().strip().splitlines()[-4:]
                      + err.getvalue().strip().splitlines()[-2:])
        if rc != want_rc:
            raise AssertionError(f"formats: {name} exited {rc}, not "
                                 f"{want_rc}: {logs[name]}")
        return err.getvalue()

    def timed_io(name, n_bytes, fn):
        t0 = time.perf_counter()
        out = fn()
        rates[name] = {"mb": n_bytes / 1e6,
                       "s": time.perf_counter() - t0}
        rates[name]["mb_per_s"] = rates[name]["mb"] / rates[name]["s"]
        return out

    lowrank = ["--set", "deconvolution.conv_backend=lowrank",
               "--set", "deconvolution.num_iterations=10",
               "--set", "deconvolution.psf_rank_tol=0.01"]
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_formats_smoke_") as d:
        npy_dir, czi_dir = (os.path.join(d, n) for n in ("npy", "czi"))
        npy_xml, czi_xml = (os.path.join(p, "dataset.xml")
                            for p in (npy_dir, czi_dir))
        run("simulate", ["simulate", "--out", npy_dir, "--views",
                         str(N_VIEWS), "--shape", *map(str, SHAPE),
                         "--beads", "300", "--blur", "--seed", "11"])
        vols = [np.load(os.path.join(npy_dir, f"tp0_setup{s}.npy"))
                for s in range(N_VIEWS)]
        view_mb = sum(v.nbytes for v in vols)
        os.makedirs(czi_dir)
        timed_io("write_czi", view_mb, lambda: write_czi(
            os.path.join(czi_dir, "acq.czi"),
            {(0, s, 0, 0): v for s, v in enumerate(vols)}))
        run("define_czi", ["define", czi_dir, "--format", "czi"])
        run("define_pattern", ["define", npy_dir])
        ds = cli._dataset_with_loader(czi_xml)
        got = timed_io("read_czi", view_mb, lambda: [
            ds.get_image((0, s)) for s in range(N_VIEWS)])
        checks["czi_equal"] = all(g.dtype == np.float32
                                  and np.array_equal(g, v)
                                  for g, v in zip(got, vols))
        del got
        zarr_p, n5_p = (os.path.join(czi_dir, f"data.{x}")
                        for x in ("zarr", "n5"))
        run("resave_zarr", ["resave", czi_xml, "--format", "zarr",
                            "--levels", str(FMT_LEVELS)])
        run("resave_n5", ["resave", czi_xml, "--format", "n5", "--levels",
                          str(FMT_LEVELS), "--out", n5_p])
        # every level against the CPU's pyramid of the same view; the n5
        # one of the view scaled into uint16 as `resave_n5_bdv` scales it
        levels = zarr_store._mipmap_levels(SHAPE, FMT_LEVELS)
        scale = 65535.0 / (max(float(v.max()) for v in vols) or 1.0)
        pyr_equal, level_mb = {"zarr": [], "n5": []}, {"zarr": 0, "n5": 0}
        read_s = {"zarr": 0.0, "n5": 0.0}
        for s, v in enumerate(vols):
            u16 = np.clip(v * scale, 0, 65535)
            for (li, _f, want), (_l, _g, want16) in zip(
                    zarr_store._pyramid(v, levels, np.float32, "cpu"),
                    zarr_store._pyramid(u16, levels, np.uint16, "cpu")):
                t0 = time.perf_counter()
                a = zarr_store.zarr_loader(zarr_p, li)((0, s))
                read_s["zarr"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                b = zarr_store.open_volume(os.path.join(
                    n5_p, f"setup{s}", "timepoint0", f"s{li}"), "n5").read()
                read_s["n5"] += time.perf_counter() - t0
                pyr_equal["zarr"].append(a.dtype == want.dtype
                                         and np.array_equal(a, want))
                pyr_equal["n5"].append(b.dtype == np.uint16
                                       and np.array_equal(b.T, want16))
                level_mb["zarr"] += a.nbytes / 1e6
                level_mb["n5"] += b.nbytes / 1e6
        for k in ("zarr", "n5"):
            rates[f"resave_{k}_write"] = {
                "mb": level_mb[k], "s": walls[f"resave_{k}"],
                "mb_per_s": level_mb[k] / walls[f"resave_{k}"],
                "note": "the verb's wall: the reads, pyramids and writes"}
            rates[f"read_{k}_levels"] = {
                "mb": level_mb[k], "s": read_s[k],
                "mb_per_s": level_mb[k] / read_s[k]}
        checks["levels"] = len(levels)
        checks["pyramid_equal"] = pyr_equal
        del vols
        # the `.npy` copies first, so neither pair's walls hold the first
        # detection's and registration's start-up
        run("detect_npy", ["detect", npy_xml])
        run("register_npy", ["register", npy_xml])
        run("detect", ["detect", czi_xml])
        run("register", ["register", czi_xml])
        a_ds, b_ds = load_dataset(czi_xml), load_dataset(npy_xml)
        checks["points_equal_npy"] = []
        checks["model_diff_npy"] = []
        for vid, b in sorted(b_ds.views.items()):
            pa = a_ds.views[vid].interest_points["beads"]
            pb = b.interest_points["beads"]
            checks["points_equal_npy"].append(bool(
                np.array_equal(pa.points, pb.points)
                and np.array_equal(pa.intensities, pb.intensities)))
            checks["model_diff_npy"].append(float(np.abs(
                a_ds.views[vid].model() - b.model()).max()))
        prof = os.path.join(d, "profile")
        run("detect_profile", ["detect", czi_xml, "--profile", prof])
        traces = os.listdir(prof)
        checks["trace_files"] = traces
        checks["trace_names_segtopk"] = any(
            "seg_topk_kernel" in open(os.path.join(prof, t)).read()
            for t in traces)
        outs = {x: os.path.join(d, f"fused.{x}") for x in ("npy", "zarr",
                                                           "n5")}
        for x, p in outs.items():
            run(f"fuse_{x}", ["fuse", czi_xml, "--out", p])
        fused = np.load(outs["npy"])
        back = {"zarr": zarr_store.open_volume(outs["zarr"]).read(),
                "n5": zarr_store.open_volume(outs["n5"], "n5").read()}
        checks["fused_shape"] = list(fused.shape)
        checks["fuse_export_equal"] = {x: bool(np.array_equal(b, fused))
                                       for x, b in back.items()}
        checks["fuse_export_nrmse"] = {x: nrmse(fused, b)
                                       for x, b in back.items()}
        for x in ("zarr", "n5"):
            p = os.path.join(d, f"direct.{x}")
            timed_io(f"write_fused_{x}", fused.nbytes,
                     lambda: zarr_store.create_volume(
                         p, fused.shape, driver=x).write(fused))
            timed_io(f"read_fused_{x}", fused.nbytes,
                     lambda: zarr_store.open_volume(p, x).read())
        del back
        psi_p = os.path.join(d, "psi.n5")
        run("deconvolve_n5", ["deconvolve", czi_xml, "--out", psi_p,
                              *lowrank])
        psi_n5 = zarr_store.open_volume(psi_p, "n5").read()
        checks["psi_shape"] = list(psi_n5.shape)
        checks["psi_finite"] = bool(np.all(np.isfinite(psi_n5)))
        # the checkpointed engine on the deconvolve verb's inputs
        ds = cli._dataset_with_loader(czi_xml)
        views = ds.views_of_timepoint(0)
        vols = [ds.get_image(v.view_id) for v in views]
        models = [v.model() for v in views]
        psfs = [extract_psf(vol, v.model(),
                            v.interest_points["beads"].points)[0]
                for v, vol in zip(views, vols)]
        bbox = maximal_bounding_box([v.shape for v in vols], models)
        cfg = apply_overrides(RunConfig(), {
            "deconvolution.conv_backend": "lowrank",
            "deconvolution.num_iterations": 10,
            "deconvolution.psf_rank_tol": 0.01})
        runner = DeconvolutionRunner(prepare_views_for_deconvolution(
            vols, models, psfs, bbox), cfg.deconvolution)
        del vols
        ck = zarr_store.ZarrCheckpointer(os.path.join(d, "ckpt"))
        reset_launches()
        psi, walls["run_checkpointed"] = sync_wall(
            lambda: runner.run_checkpointed(5, ck.save))
        launches["run_checkpointed"] = read_launches()
        it, restored = ck.load_latest()
        checks["checkpoint"] = {"iteration": it, "equal": bool(
            restored is not None
            and np.array_equal(restored, psi.cpu().numpy()))}
        del runner, psi
        # the verbs that need h5py or imageio
        fx = _fmt_placeholders(d)
        have = {m: importlib.util.find_spec(m) is not None
                for m in ("h5py", "imageio")}
        optional = {
            "resave_hdf5": ("h5py", ["resave", czi_xml, "--format", "hdf5",
                                     "--out", os.path.join(d, "x.h5")]),
            "fuse_append_hdf5": ("h5py", ["fuse", czi_xml, "--append-hdf5",
                                          os.path.join(d, "x.h5")]),
            "define_tiff": ("imageio", ["define", fx["tiff"], "--pattern",
                                        "tp{tp}_setup{setup}.tif"]),
            "define_micromanager": ("imageio", ["define", fx["mm"]]),
        }
        not_run = {}
        for name, (pkg, argv) in optional.items():
            err = run(name, argv, want_rc=0 if have[pkg] else 2)
            if not have[pkg]:
                if f"`{pkg}` package" not in err:
                    raise AssertionError(f"formats: {name} without {pkg} "
                                         f"did not name it: {err!r}")
                not_run[name] = (f"`{pkg}` is not installed: exit 2, "
                                 f"stderr names it")
    emit({"phase": "formats", "views": N_VIEWS, "shape": list(SHAPE),
          "not_run": not_run, "walls_s": walls, "io": rates,
          "launches": launches, "checks": checks,
          "cluster_model_tol": CLI_CLUSTER_TOL, "stdout_tail": logs})
    bad = []
    if not checks["czi_equal"]:
        bad.append("czi views")
    if not all(all(v) for v in pyr_equal.values()):
        bad.append("pyramid levels")
    if not (all(checks["points_equal_npy"])
            and max(checks["model_diff_npy"]) <= CLI_CLUSTER_TOL):
        bad.append("detect/register on zarr vs npy")
    if launches["detect"]["segtopk"] == 0:
        bad.append("detect launched no segtopk")
    if not checks["trace_names_segtopk"]:
        bad.append("profile trace")
    if not all(checks["fuse_export_equal"].values()):
        bad.append("zarr/n5 export of fuse")
    if launches["deconvolve_n5"]["zpass"] == 0 \
            or launches["deconvolve_n5"]["sl_rows"] == 0:
        bad.append("deconvolve launched no zpass/sl_rows")
    if not (checks["psi_finite"]
            and checks["psi_shape"] == list(bbox.shape)):
        bad.append("psi.n5")
    if checks["checkpoint"] != {"iteration": 10, "equal": True}:
        bad.append("checkpoint")
    if bad:
        raise AssertionError(f"formats: {bad}")
    return {k: launches[v][k] for k, v in (("segtopk", "detect"),
                                           ("zpass", "deconvolve_n5"),
                                           ("sl_rows", "deconvolve_n5"))}


def phase_rl(psfs, factors) -> tuple:
    """The main path at the bench configuration. Returns (kernel launch
    counts of one 20-iteration lowrank run, the staged lowrank runner)."""
    from spim_registration_tpu_torch.deconv import DeconvolutionRunner

    (prep, t_prep) = sync_wall(lambda: make_rl_prep(SHAPE, psfs, factors))
    info = {"phase": "rl", "shape": list(SHAPE), "views": N_VIEWS,
            "iters": N_ITER, "prep_s": t_prep}
    outs5 = {}
    counts = lowrank = None
    for backend in ("lowrank", "fft"):
        runner, t_stage = sync_wall(
            lambda: DeconvolutionRunner(prep, rl_params(backend, N_ITER)))
        info[f"{backend}_staging_s"] = t_stage
        if backend == "lowrank":
            lowrank = runner
            def rank(e):
                return int(e["mat"][0].shape[1]) if "mat" in e else -1
            info["ranks_k1"] = [rank(e) for e in runner.k1_ffts]
            info["ranks_k2"] = [rank(e) for e in runner.k2_ffts]
            info["rel_err_k1"] = runner.lowrank_errs_k1
            info["rel_err_k2"] = runner.lowrank_errs_k2
            n_mat = sum(r > 0 for r in info["ranks_k1"] + info["ranks_k2"])
            info["fft_fallback_kernels"] = 2 * N_VIEWS - n_mat
        out, info[f"{backend}_first_run_s"] = sync_wall(runner.run)
        walls = []
        for rep in range(5):
            if backend == "lowrank" and rep == 0:
                # the path's counted run: counts from 0 around it
                reset_launches()
            out, wall = sync_wall(runner.run)
            if backend == "lowrank" and rep == 0:
                counts = read_launches()
            walls.append(wall)
        med = float(np.median(walls))
        info[f"{backend}_walls_s"] = walls
        info[f"{backend}_median_s"] = med
        info[f"{backend}_voxel_updates_per_s"] = \
            float(np.prod(SHAPE)) * N_VIEWS * N_ITER / med
        o = out.cpu().numpy()
        if o.shape != SHAPE or not np.all(np.isfinite(o)):
            raise AssertionError(f"{backend}: bad output {o.shape}")
        outs5[backend] = runner.run(num_iterations=5).cpu().numpy()
        info[f"{backend}_self_repeat_nrmse_5it"] = nrmse(
            outs5[backend], runner.run(num_iterations=5).cpu().numpy())
    gate = nrmse(outs5["fft"], outs5["lowrank"])
    info.update({"gate_lowrank_vs_fft_nrmse_5it": gate, "gate_tol": GATE_TOL,
                 "gate_ok": gate < GATE_TOL, "launches": counts})
    expected = N_ITER * (2 * N_VIEWS - info["fft_fallback_kernels"])
    info["expected_launches"] = expected
    emit(info)
    if not gate < GATE_TOL:
        raise AssertionError(f"lowrank vs fft gate {gate} >= {GATE_TOL}")
    views = N_ITER * N_VIEWS
    info["expected_update_launches"] = views
    if counts != {"zpass": expected, "sl_rows": expected, "segtopk": 0,
                  "dog": 0, "zfused": 0, "rl_quotient": views,
                  "rl_update": views}:
        raise AssertionError(f"kernel launches {counts}, expected "
                             f"{expected} of zpass and sl_rows and "
                             f"{views} of rl_quotient and rl_update")
    return counts, lowrank


def device_profile(fn, top: int = 14) -> dict:
    """Device time by kernel and the device's idle share over one call of
    `fn` (torch.profiler; on a mesh of several cards the busy time sums
    over the cards)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync_all()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = sync_wall(fn)
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    if busy_us <= 0:
        raise AssertionError("the profiler saw no device time")
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "idle_share": 1.0 - busy_us / 1e6 / wall,
            "top": [{"name": k[:90], "device_ms": us / 1e3, "count": n,
                     "share": us / busy_us} for k, us, n in rows[:top]]}


def phase_profile(runner) -> None:
    """Device time by kernel over one deconvolution run."""
    runner.run(num_iterations=2)
    emit({"phase": "profile", **device_profile(runner.run)})


def detection_volume() -> np.ndarray:
    """bench.py's detection volume: 400 beads (sigma 1.5) in 256^3 plus
    noise 0.005, seed 5."""
    from spim_registration_tpu_torch.utils.simulation import render_beads

    rng = np.random.default_rng(5)
    pts = rng.uniform(8, SHAPE[0] - 8, size=(400, 3))
    return render_beads(pts, SHAPE, sigma=1.5) \
        + rng.normal(0, 0.005, SHAPE).astype(np.float32)


def phase_detect(vol: np.ndarray) -> int:
    """The detection path at bench.py's configuration: 8 views of the
    detection volume with per-view noise 1e-4 (seed 11),
    DoGParameters(sigma=1.8, threshold=0.004), through detect_beads_batch
    and detect_beads. Returns segtopk's launches in one batch call."""
    from spim_registration_tpu_torch.detect import (
        DoGParameters,
        detect_beads,
        detect_beads_batch,
    )

    rng = np.random.default_rng(11)
    stack = np.stack([vol + rng.normal(0, 1e-4, vol.shape).astype(np.float32)
                      for _ in range(DETECT_VIEWS)])
    vols = torch.from_numpy(stack).cuda()
    del stack
    params = DoGParameters(sigma=1.8, threshold=0.004)
    _, first_s = sync_wall(lambda: detect_beads_batch(vols, params))
    reset_launches()
    res, wall = sync_wall(lambda: detect_beads_batch(vols, params))
    counts = read_launches()
    walls = [wall] + [sync_wall(lambda: detect_beads_batch(vols, params))[1]
                      for _ in range(4)]
    _, single_first_s = sync_wall(lambda: detect_beads(vols[0], params))
    single = [sync_wall(lambda: detect_beads(vols[0], params))[1]
              for _ in range(5)]
    med, smed = float(np.median(walls)), float(np.median(single))
    prof = device_profile(lambda: detect_beads_batch(vols, params))
    n_vox = float(np.prod(SHAPE))
    peaks = [len(p) for p, _ in res]
    inside = all(bool(np.all((p >= 0) & (p <= np.array(SHAPE) - 1)))
                 for p, _ in res)
    emit({"phase": "detect", "views": DETECT_VIEWS, "shape": list(SHAPE),
          "params": {"sigma": 1.8, "threshold": 0.004},
          "peaks_per_view": peaks, "launches": counts,
          "batch_first_s": first_s, "batch_walls_s": walls,
          "batch_median_s": med,
          "batch_voxels_per_s": DETECT_VIEWS * n_vox / med,
          "single_first_s": single_first_s, "single_walls_s": single,
          "single_median_s": smed, "single_voxels_per_s": n_vox / smed,
          "profile": prof})
    if counts["segtopk"] != DETECT_VIEWS:
        raise AssertionError(f"segtopk launches {counts}, expected "
                             f"{DETECT_VIEWS} per batch call")
    if not inside or min(peaks) < 380 or max(peaks) > 400:
        raise AssertionError(f"detection: {peaks} peaks per view (400 "
                             f"beads; the reference finds 398)")
    return counts["segtopk"]


def phase_segtopk(vol: np.ndarray) -> dict:
    """segtopk against its plain version at the main path's shape (256^3
    = 32768 segments of 512, 4 rounds), exactly, on the detection
    volume's real score field and on a dense adversarial field (few
    distinct values, so ties in every segment; every tenth segment all
    -inf); single and back-to-back times, plain and library times and
    the bound."""
    from spim_registration_tpu_torch.ops.extrema import candidate_score
    from spim_registration_tpu_torch.ops.gaussian import (
        difference_of_gaussian,
        dog_sigmas,
    )
    from spim_registration_tpu_torch.ops.kernels import segtopk as st

    v = torch.from_numpy(vol).cuda()
    v = (v - v.min()) / torch.clamp(v.max() - v.min(), min=1e-12)
    s1, s2, norm = dog_sigmas(1.8, 0.004)
    score = candidate_score(difference_of_gaussian(v, s1, s2)
                            * np.float32(norm), 0.004)
    S = score.numel() // SEG
    real = score.view(S, SEG)
    g = torch.Generator(device="cuda").manual_seed(3)
    dense = torch.randint(0, 8, (S, SEG), generator=g, device="cuda"
                          ).float() / 8
    dense[torch.rand((S, SEG), generator=g, device="cuda") < 0.3] = -np.inf
    dense[3::10] = -np.inf
    fields = {"real": real, "dense": dense}
    cases = {}
    for name, tiles in fields.items():
        got = st.segment_topk(tiles, ROUNDS)
        want = st.segment_topk_reference(tiles, ROUNDS)
        torch.cuda.synchronize()
        if name == "real":
            real_counts = want[2]
        cases[name] = {
            "equal": [bool(torch.equal(a, b)) for a, b in zip(got, want)],
            "max_abs_err": float((got[0] - want[0]).abs().nan_to_num(
                0.0).max()),
            "finite_entries": int(torch.isfinite(tiles).sum()),
            "overflowing_segments": int((want[2] > ROUNDS).sum())}
    times = {}
    for name, fn in (
            ("ms", lambda: st.segment_topk(real, ROUNDS)),
            ("dense_ms", lambda: st.segment_topk(dense, ROUNDS)),
            # values and indices only: no counts and no first-index rule
            ("library_ms", lambda: torch.topk(real, ROUNDS, dim=1))):
        times[name] = cuda_ms(fn, 50)
        times[name + "_pipelined"] = cuda_ms_pipelined(fn, 50)
        times[name + "_device"] = device_ms(fn)
    times["plain_ms"] = cuda_ms(
        lambda: st.segment_topk_reference(real, ROUNDS), 5)
    n_bytes = S * SEG * 4 + S * ROUNDS * 8 + S * 4
    # compares the real field needs: the count, then one round a segment
    # per entry above -inf, at most ROUNDS (past them the answer is fixed)
    n_ops = float(SEG * (S + int(torch.clamp(real_counts, max=ROUNDS).sum())))
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    emit({"phase": "kernels", "kernel": "segtopk", "segments": S,
          "seg": SEG, "rounds": ROUNDS, "cases": cases, "times_ms": times,
          "bytes": n_bytes, "ops": n_ops, "bound_ms": bound,
          "frac_of_bound": bound / times["ms"],
          "frac_of_bound_pipelined": bound / times["ms_pipelined"],
          "frac_of_bound_device": bound / times["ms_device"],
          "library": "torch.topk(tiles, 4, dim=1): no counts, no "
                     "first-index tie rule"})
    bad = [k for k, c in cases.items() if not all(c["equal"])]
    if bad:
        raise AssertionError(f"segtopk differs from its plain version on "
                             f"{bad}")
    return {"name": "segtopk", "route": "cuda",
            "source": "spim_registration_tpu_torch/csrc/segtopk.cu",
            "replaces": "spim_registration_tpu/ops/pallas/segtopk.py:31 "
                        "(_seg_topk_kernel)",
            "max_abs_err": max(c["max_abs_err"] for c in cases.values()),
            "ms": times["ms"], "ms_pipelined": times["ms_pipelined"],
            "ms_device": times["ms_device"],
            "dense_ms": times["dense_ms"], "plain_ms": times["plain_ms"],
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": times["library_ms"],
            "library_ms_pipelined": times["library_ms_pipelined"]}


def phase_match() -> None:
    """The matching path at bench.py's configuration: 8 views x 128^3
    (seed 7, 250 beads, full circle), detected on the card; all 28 pairs
    through match_pairs_batched (RGLDM, ratio 3, 256 points); the global
    affine solve with 2 trim rounds on the device assembly; the same
    points through the port's CPU path."""
    from spim_registration_tpu_torch.detect import (
        DoGParameters,
        detect_beads_batch,
    )
    from spim_registration_tpu_torch.match import (
        PairwiseParameters,
        match_pairs_batched,
    )
    from spim_registration_tpu_torch.solve import (
        GlobalOptParameters,
        PairMatches,
        solve_global,
    )
    from spim_registration_tpu_torch.utils.simulation import (
        make_multiview_scene,
    )

    scene = make_multiview_scene(
        np.random.default_rng(7), n_views=8, shape=(128, 128, 128),
        n_beads=250, full_circle=True, max_perturb_deg=2.0, max_shift=3.0,
        noise=5e-4, bead_sigma=1.0, psf_sigmas=[(3.0, 1.0, 1.0)] * 8)
    points = [p for p, _ in detect_beads_batch(
        np.stack(scene.volumes), DoGParameters(sigma=1.8, threshold=0.006))]
    V = len(points)
    pairs = [(i, j) for i in range(V) for j in range(i + 1, V)]
    params = PairwiseParameters(method="rgldm", ratio_of_distance=3.0,
                                max_points=256)
    _, first_s = sync_wall(lambda: match_pairs_batched(points, pairs,
                                                       params))
    walls = []
    for _ in range(5):
        results, w = sync_wall(lambda: match_pairs_batched(points, pairs,
                                                           params))
        walls.append(w)
    wall = float(np.median(walls))
    prof = device_profile(lambda: match_pairs_batched(points, pairs, params))
    matches = [PairMatches(view_i=i, view_j=j, p=points[i][r.inliers[:, 0]],
                           q=points[j][r.inliers[:, 1]])
               for (i, j), r in results.items()
               if r.valid and len(r.inliers)]
    n_corr = sum(len(m.p) for m in matches)
    gres, solve_s = sync_wall(lambda: solve_global(
        matches, fixed_views=[0], params=GlobalOptParameters(
            model="affine", outlier_trim_rounds=2)))
    cpu, cpu_s = sync_wall(lambda: match_pairs_batched(
        points, pairs, params, device="cpu"))
    differ = [f"{i}-{j}" for (i, j) in pairs
              if cpu[(i, j)].valid != results[(i, j)].valid
              or not np.array_equal(cpu[(i, j)].inliers,
                                    results[(i, j)].inliers)]
    n_valid = sum(r.valid for r in results.values())
    worst = sorted(gres.per_pair_error.items(), key=lambda kv: -kv[1])[:5]
    emit({"phase": "match", "views": V, "points_per_view":
          [len(p) for p in points], "pairs": len(pairs),
          "valid_pairs": n_valid, "first_s": first_s, "walls_s": walls,
          "median_s": wall, "pairs_per_s": len(pairs) / wall,
          "correspondences": n_corr, "device_assembly": n_corr >= 2000,
          "solve_s": solve_s, "residual_mean_px": gres.mean_error,
          "residual_max_px": gres.max_error, "trimmed": gres.trimmed,
          "worst_pairs_px": [[f"{i}-{j}", e] for (i, j), e in worst],
          "cpu_s": cpu_s, "pairs_differing_from_cpu": differ,
          "profile": prof})
    if n_valid != len(pairs):
        raise AssertionError(f"{n_valid}/{len(pairs)} pairs valid")
    if differ:
        raise AssertionError(f"card and CPU differ on pairs {differ}")
    if not (np.isfinite(gres.max_error) and gres.max_error < 1.0):
        raise AssertionError(f"global solve residual {gres.max_error} px")


def pipeline_scene():
    """The reconstruction's simulated acquisition: 4 views of 256^3, 300
    beads (sigma 0.8) blurred by per-view PSFs, noise 0.003, seed 11."""
    from spim_registration_tpu_torch.utils.simulation import (
        make_multiview_scene,
    )

    return make_multiview_scene(
        np.random.default_rng(11), n_views=N_VIEWS, shape=SHAPE,
        n_beads=300, bead_sigma=0.8, noise=0.003,
        psf_sigmas=[(2.5, 1.0, 1.0), (1.0, 1.0, 2.5), (2.0, 1.2, 1.2),
                    (1.2, 1.2, 2.0)])


def pipeline_registration_config():
    from spim_registration_tpu_torch.detect import DoGParameters
    from spim_registration_tpu_torch.match import PairwiseParameters
    from spim_registration_tpu_torch.pipeline import RegistrationConfig

    return RegistrationConfig(
        detection=DoGParameters(sigma=2.0, threshold=0.008),
        pairwise=PairwiseParameters(model="affine", max_points=512))


def phase_pipeline() -> None:
    """Simulated views -> register_views -> PSFs -> prep -> fusion ->
    deconvolution through the public entry points, on the registered
    models (the demo's flow, examples/full_pipeline_demo.py)."""
    from spim_registration_tpu_torch.core.dataset import BoundingBox
    from spim_registration_tpu_torch.deconv import (
        DeconvolutionParameters,
        condition_psf,
        deconvolve,
        extract_psf,
        prepare_views_for_deconvolution,
    )
    from spim_registration_tpu_torch.fuse import FusionParameters, fuse_views
    from spim_registration_tpu_torch.pipeline import register_views

    walls = {}
    t0 = time.perf_counter()
    scene = pipeline_scene()
    walls["simulate_s"] = time.perf_counter() - t0
    lo, hi = (24, 24, 24), (232, 232, 232)       # 208^3: ragged tiles
    bbox = BoundingBox("b", lo, hi)

    cfg = pipeline_registration_config()
    reset_launches()
    reg, walls["register_views_s"] = sync_wall(
        lambda: register_views(scene.volumes, cfg))
    reg_launches = read_launches()
    errs = []
    for v in range(N_VIEWS):
        p = scene.view_points[v]
        e = p @ reg.models[v][:, :3].T + reg.models[v][:, 3]
        t = p @ scene.models[v][:, :3].T + scene.models[v][:, 3]
        errs.append(float(np.mean(np.linalg.norm(e - t, axis=1))))

    def psfs_and_factors():
        psfs, factors, used = [], [], []
        for v in range(N_VIEWS):
            psf, n = extract_psf(scene.volumes[v], reg.models[v],
                                 reg.points[v], psf_shape=(13, 13, 13))
            psf, fac = condition_psf(psf, denoise_rank=8,
                                     return_factors=True)
            psfs.append(psf)
            factors.append(fac)
            used.append(n)
        return psfs, factors, used

    (psfs, factors, used), walls["extract_psf_s"] = sync_wall(
        psfs_and_factors)
    prep, walls["prepare_views_s"] = sync_wall(
        lambda: prepare_views_for_deconvolution(
            scene.volumes, reg.models, psfs, bbox))
    prep.psf_factors = factors
    fused, walls["fuse_views_s"] = sync_wall(
        lambda: fuse_views(scene.volumes, reg.models, bbox,
                           FusionParameters()))
    reset_launches()
    deconv, walls["deconvolve_s"] = sync_wall(
        lambda: deconvolve(prep, DeconvolutionParameters(
            num_iterations=10, conv_backend="lowrank")))
    launches = read_launches()
    shape = tuple(h - l for l, h in zip(lo, hi))
    for name, vol in (("fused", fused), ("deconv", deconv)):
        if vol.shape != shape or not np.all(np.isfinite(vol)):
            raise AssertionError(f"{name}: bad output {vol.shape}")
    idx = np.round(scene.world_points).astype(int) - np.array(lo)
    idx = idx[np.all((idx >= 0) & (idx < np.array(shape)), axis=1)]
    pk_f = float(np.mean(fused[tuple(idx.T)]))
    pk_d = float(np.mean(deconv[tuple(idx.T)]))
    n_valid = sum(r.valid for r in reg.pair_results.values())
    emit({"phase": "pipeline", "views": N_VIEWS, "scene": list(SHAPE),
          "bbox": [list(lo), list(hi)],
          "points_per_view": [len(p) for p in reg.points],
          "valid_pairs": f"{n_valid}/{len(reg.pair_results)}",
          "inliers_per_pair": {f"{i}-{j}": r.num_inliers
                               for (i, j), r in reg.pair_results.items()},
          "residual_mean_px": reg.mean_error,
          "residual_max_px": reg.max_error,
          "transform_error_px": errs, "transform_error_tol": 0.5,
          "registration_timings_s": reg.timings,
          "register_launches": reg_launches,
          "beads_used_for_psf": used,
          "walls": walls, "deconvolve_launches": launches,
          "peak_fused": pk_f, "peak_deconv": pk_d,
          "sharpening": pk_d / max(pk_f, 1e-12)})
    if not max(errs) < 0.5:
        raise AssertionError(f"registration error {errs} px >= 0.5")
    if reg_launches["segtopk"] != N_VIEWS:
        raise AssertionError(f"register_views launched segtopk "
                             f"{reg_launches['segtopk']} times, expected "
                             f"{N_VIEWS}")
    if not pk_d > 1.5 * pk_f:
        raise AssertionError(f"deconvolution did not sharpen: {pk_d} vs "
                             f"{pk_f}")
    if launches["zpass"] == 0 or launches["sl_rows"] == 0:
        raise AssertionError(f"deconvolve did not run the kernels: "
                             f"{launches}")
    return {"scene": scene, "reg": reg, "cfg": cfg, "bbox": bbox,
            "prep": prep, "fused": fused, "deconv": deconv}


def timelapse_series() -> dict:
    """`register_timeseries` at the pipeline's width: TL_TPS timepoints x
    4 views of 256^3. Timepoint 0 is the pipeline phase's scene; each later
    one is the whole sample drifted in the world by a seeded uniform +-3 px
    translation (seed 12), each view re-rendered (`render_beads`, sigma
    1.7, noise 0.003), as tests/test_timelapse_cluster.py builds its
    series. The default (middle) reference timepoint; the pipeline phase's
    registration parameters."""
    from spim_registration_tpu_torch.pipeline.timelapse import (
        register_timeseries,
    )
    from spim_registration_tpu_torch.utils.simulation import render_beads

    scene = pipeline_scene()
    rng = np.random.default_rng(12)
    drifts = {0: np.zeros(3)}
    vols = {0: scene.volumes}
    view_pts = {0: scene.view_points}
    invs = [np.linalg.inv(np.vstack([A, [0, 0, 0, 1]]))[:3]
            for A in scene.models]
    for tp in range(1, TL_TPS):
        drifts[tp] = rng.uniform(-3, 3, 3)
        world = scene.world_points - drifts[tp]
        view_pts[tp] = [world @ M[:, :3].T + M[:, 3] for M in invs]
        vols[tp] = [render_beads(p, SHAPE, 1.7)
                    + rng.normal(0, 0.003, SHAPE).astype(np.float32)
                    for p in view_pts[tp]]
    reset_launches()
    res, wall = sync_wall(lambda: register_timeseries(
        vols, pipeline_registration_config()))
    launches = read_launches()
    ref = TL_TPS // 2
    # S maps timepoint tp's registered frame (view 0's, the world less
    # drifts[tp]) onto the reference's: a translation by the drift
    # difference; the final model of (tp, v) is the true view model plus it
    drift_err = {tp: float(np.abs(res.stabilization[tp][:, 3]
                                  - (drifts[tp] - drifts[ref])).max())
                 for tp in drifts}
    model_err = {}
    for (tp, v), F in res.models.items():
        p = view_pts[tp][v]
        T = scene.models[v]
        want = p @ T[:, :3].T + T[:, 3] + (drifts[tp] - drifts[ref])
        model_err[f"{tp},{v}"] = float(np.mean(np.linalg.norm(
            p @ F[:, :3].T + F[:, 3] - want, axis=1)))
    stats = {s.timepoint: {"candidates": s.num_candidates,
                           "inliers": s.num_inliers,
                           "mean_error_px": s.mean_error,
                           "max_error_px": s.max_error, "valid": s.valid}
             for s in res.statistics}
    out = {"timepoints": TL_TPS, "views": N_VIEWS, "shape": list(SHAPE),
           "reference_tp": ref, "wall_s": wall,
           "drift_px": {tp: d.tolist() for tp, d in drifts.items()},
           "drift_error_px": drift_err, "drift_tol_px": 0.3,
           "statistics": stats, "model_error_px": model_err,
           "model_error_tol_px": 0.5, "launches": launches,
           "points_per_view": {tp: [len(p) for p in r.points]
                               for tp, r in res.per_timepoint.items()}}
    emit({"phase": "timelapse_series", **out})
    bad_stats = [tp for tp, st in stats.items() if tp != ref
                 and not (st["valid"] and st["mean_error_px"] < 0.5)]
    if max(drift_err.values()) > 0.3 or bad_stats:
        raise AssertionError(f"timelapse stabilization: drift errors "
                             f"{drift_err}, statistics {stats}")
    if max(model_err.values()) >= 0.5:
        raise AssertionError(f"timelapse models: {model_err} px >= 0.5")
    if launches["segtopk"] != TL_TPS * N_VIEWS:
        raise AssertionError(f"register_timeseries launched segtopk "
                             f"{launches['segtopk']} times, expected "
                             f"{TL_TPS * N_VIEWS}")
    return out


def stress_scene(cfg: dict):
    """examples/timelapse_stress.py's acquisition (BASELINE config #5) on
    the port's simulation: a bead cloud over the tiled world (seed 42),
    drifted per timepoint by a random walk (sigma 1.2 px) drawn for the
    published number of timepoints (so the first ones are the published
    run's), each view a rotation about its tile's centre moved to the
    tile, perturbed by up to 1.5 px. Returns the geometry and a renderer
    that draws each view's noise from the shared generator in the
    example's order (timepoint, tile, view)."""
    from spim_registration_tpu_torch.utils.simulation import (
        render_beads,
        rotation_about_axis,
    )

    G, V, E = cfg["tiles"], cfg["views"], cfg["tile_size"]
    step = E * (1.0 - cfg["overlap"])
    tiles = [(a, b, c) for a in range(G[0]) for b in range(G[1])
             for c in range(G[2])]
    world_dims = tuple(int(step * (g - 1) + E) for g in G)
    rng = np.random.default_rng(42)
    world0 = rng.uniform(8, np.asarray(world_dims, float) - 8,
                         (cfg["beads_per_tile"] * len(tiles), 3))
    drifts = np.cumsum(np.vstack([np.zeros(3), rng.normal(
        0, 1.2, (cfg["published_tps"] - 1, 3))]), axis=0)[:cfg["tps"]]

    def nominal_model(tile, v):
        R = rotation_about_axis(1, 360.0 / V * v)
        c = np.full(3, E / 2.0)
        A = np.concatenate([R, (c - R @ c)[:, None]], axis=1)
        A[:, 3] += np.array(tiles[tile]) * step
        return A

    perturb = {(t, v): np.zeros(3) if v == 0 else rng.uniform(-1.5, 1.5, 3)
               for t in range(len(tiles)) for v in range(V)}

    def true_model(tile, v):
        A = nominal_model(tile, v)
        A[:, 3] += perturb[(tile, v)]
        return A

    def render_view(tp, tile, v):
        A4 = np.vstack([true_model(tile, v), [0, 0, 0, 1]])
        inv = np.linalg.inv(A4)[:3]
        pts = (world0 + drifts[tp]) @ inv[:, :3].T + inv[:, 3]
        vol = render_beads(pts, (E, E, E), 1.7)
        return (vol + rng.normal(0, 0.003, vol.shape)).astype(np.float32)

    return {"tiles": tiles, "world_dims": world_dims, "drifts": drifts,
            "nominal_model": nominal_model, "render_view": render_view}


def timelapse_stress(tmp: str) -> tuple:
    """examples/timelapse_stress.py's production path on the port's
    modules at BASELINE config #5's per-timepoint width (STRESS: 2 x 2 x 2
    tiles x 6 views of 96^3, 120 beads a tile, 25% overlap, world 168^3),
    its timepoints cut for the time limit. A: `.npy` views and the master
    XML; B: a `run_job` a timepoint (`detect_beads`, then `register_views`
    a tile on points from the nominal models) and `merge_cluster_jobs`;
    C: each timepoint's pool (one view a tile, `_dedupe` at 1.5 px)
    matched against the reference timepoint's (RGLDM, translation, seed
    99 + tp); D: `fuse_views_streaming` a timepoint into the world box.
    Checks: stabilization residuals < 0.5 px; one tile of timepoint 0 on
    the card against the CPU (peak sets equal, models within 1e-4); the
    reference timepoint's streamed fusion against `fuse_views`
    (nrmse <= CLI_OOC_FUSE_TOL); segtopk launches = views x timepoints
    where `find_peaks` extracts by segments, else 0: a 96^3 field has
    1728 segments of 512, and the default `max_peaks` (8192) is more than
    4 rounds of them keep, so the port, like the reference
    (ops/extrema.py `_segmented_compact_topk`), sorts the whole field.
    Returns the phase line and the segtopk launches of stage B."""
    from spim_registration_tpu_torch.core.dataset import (
        BoundingBox,
        Dataset,
        ViewDescription,
        ViewTransform,
    )
    from spim_registration_tpu_torch.core.imgloaders import npy_loader
    from spim_registration_tpu_torch.core.xml_io import save_dataset
    from spim_registration_tpu_torch.detect import DoGParameters, detect_beads
    from spim_registration_tpu_torch.fuse import FusionParameters, fuse_views
    from spim_registration_tpu_torch.fuse.streaming import (
        fuse_views_streaming,
    )
    from spim_registration_tpu_torch.match import (
        PairwiseParameters,
        match_pair,
    )
    from spim_registration_tpu_torch.native_blocks import RawVolumeStore
    from spim_registration_tpu_torch.pipeline import (
        RegistrationConfig,
        register_views,
    )
    from spim_registration_tpu_torch.pipeline.cluster import (
        find_job_xmls,
        merge_cluster_jobs,
        run_job,
    )
    from spim_registration_tpu_torch.pipeline.timelapse import _dedupe

    cfg = STRESS
    T, V, E = cfg["tps"], cfg["views"], cfg["tile_size"]
    ref_tp = T // 2
    sc = stress_scene(cfg)
    tiles, world_dims, drifts = sc["tiles"], sc["world_dims"], sc["drifts"]
    n_views = len(tiles) * V
    walls = {}

    # ---- A: the views as .npy and the master XML
    t0 = time.perf_counter()
    ds = Dataset(base_path=tmp)
    for tp in range(T):
        for ti in range(len(tiles)):
            for v in range(V):
                setup = ti * V + v
                np.save(os.path.join(tmp, f"tp{tp}_setup{setup}.npy"),
                        sc["render_view"](tp, ti, v))
                vd = ViewDescription(view_id=(tp, setup), tile=ti,
                                     angle=int(360 / V * v), size=(E, E, E))
                vd.transforms = [ViewTransform(
                    "nominal", sc["nominal_model"](ti, v))]
                ds.add_view(vd)
    master = os.path.join(tmp, "dataset.xml")
    save_dataset(ds, master)
    walls["A_define_s"] = time.perf_counter() - t0

    # ---- B: a cluster job a timepoint, then the merge
    dparams = DoGParameters(sigma=1.8, threshold=0.008)
    reg_cfg = RegistrationConfig(detection=dparams,
                                 pairwise=PairwiseParameters(
                                     model="affine", max_points=512))
    spent = {"detect_s": 0.0, "register_s": 0.0, "match_s": 0.0,
             "solve_s": 0.0}
    n_points = []

    def process_tp(job_ds, tp):
        job_ds.loader = npy_loader(tmp)
        for ti in range(len(tiles)):
            setups = [ti * V + v for v in range(V)]
            vols = [job_ds.get_image((tp, s)) for s in setups]
            points = []
            t1 = time.perf_counter()
            for s, vol in zip(setups, vols):
                pts, resp = detect_beads(vol, dparams)
                job_ds.set_interest_points((tp, s), "beads", pts, resp)
                points.append(pts)
                n_points.append(len(pts))
            t2 = time.perf_counter()
            res = register_views(None, reg_cfg, points=points,
                                 initial_models=[sc["nominal_model"](ti, v)
                                                 for v in range(V)])
            spent["detect_s"] += t2 - t1
            spent["register_s"] += time.perf_counter() - t2
            spent["match_s"] += res.timings["match"]
            spent["solve_s"] += res.timings.get("solve", 0.0)
            for s, model in zip(setups, res.models):
                job_ds.views[(tp, s)].transforms = [
                    ViewTransform("registered", model)]

    k = min(dparams.max_peaks, E ** 3)
    segments = -(-E ** 3 // SEG)
    by_segments = k <= ROUNDS * segments
    expected = n_views * T if by_segments else 0
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tp in range(T):
        run_job(master, tp, process_tp)
    walls["B_jobs_s"] = time.perf_counter() - t0
    launches = read_launches()
    per_view_ms = 1e3 * spent["detect_s"] / (n_views * T)
    regs_per_s = len(tiles) * T / spent["register_s"]
    reg_split_s = {k: spent[k] for k in ("match_s", "solve_s")}
    points_per_view = [int(np.min(n_points)), int(np.median(n_points)),
                       int(np.max(n_points))]
    t0 = time.perf_counter()
    merged = merge_cluster_jobs(master, find_job_xmls(tmp))
    merged.loader = npy_loader(tmp)
    walls["B_merge_s"] = time.perf_counter() - t0

    # ---- C: stabilization against the reference timepoint
    t0 = time.perf_counter()
    pools = {}
    for tp in range(T):
        parts = []
        for (vtp, s), vd in merged.views.items():
            # one view a tile: all 48 would put ~48 copies of every bead
            # in the pool (examples/timelapse_stress.py)
            if vtp != tp or s % V != 0:
                continue
            A = vd.model()
            parts.append(vd.interest_points["beads"].points @ A[:, :3].T
                         + A[:, 3])
        pools[tp] = _dedupe(np.concatenate(parts), min_distance=1.5)
    stab_params = PairwiseParameters(
        method="rgldm", ratio_of_distance=3.0, model="translation",
        max_points=min(1024, max(len(p) for p in pools.values())))
    stab = {}
    for tp in range(T):
        if tp == ref_tp:
            continue
        res = match_pair(pools[tp], pools[ref_tp], stab_params,
                         seed=99 + tp)
        stab[tp] = {"valid": res.valid, "inliers": res.num_inliers,
                    "residual_px": res.mean_error,
                    # recovered drift ~ -(drift_tp - drift_ref)
                    "drift_error_px": float(np.linalg.norm(
                        res.model[:, 3] - (drifts[ref_tp] - drifts[tp])))}
        if not res.valid:
            continue
        S4 = np.vstack([res.model, [0, 0, 0, 1]])
        for (vtp, s), vd in merged.views.items():
            if vtp == tp:
                A4 = np.vstack([vd.model(), [0, 0, 0, 1]])
                vd.transforms = [ViewTransform("stabilized", (S4 @ A4)[:3])]
    save_dataset(merged, master)
    walls["C_stabilize_s"] = time.perf_counter() - t0

    # ---- D: streaming fusion a timepoint, disk to disk
    bbox = BoundingBox("world", (0, 0, 0), world_dims)
    fparams = FusionParameters(z_chunk=32)
    block = (32, 128, 128)
    fused_tps = cfg["fused_tps"]

    def fuse_tp(tp, box, name):
        setups = sorted(s for (vtp, s) in merged.views if vtp == tp)
        stores, models = [], []
        for s in setups:
            vol = merged.get_image((tp, s))
            st = RawVolumeStore(os.path.join(tmp, f"view_tp{tp}_{s}.raw"),
                                vol.shape, create=True)
            st.write_block((0, 0, 0), vol)
            stores.append(st)
            models.append(merged.views[(tp, s)].model())
        out = RawVolumeStore(os.path.join(tmp, name), box.shape,
                             create=True)
        fuse_views_streaming(stores, models, box, out, fparams, block=block)
        for s in setups:
            os.unlink(os.path.join(tmp, f"view_tp{tp}_{s}.raw"))

    fuse_walls = {}
    t0 = time.perf_counter()
    for tp in fused_tps:
        fuse_walls[tp] = sync_wall(
            lambda: fuse_tp(tp, bbox, f"fused_tp{tp}.raw"))[1]
    walls["D_fuse_s"] = time.perf_counter() - t0
    # the idle share of stage D over the reference timepoint's first row of
    # blocks (a whole timepoint's trace takes the profiler ~30 s to read)
    slab = BoundingBox("slab", (0, 0, 0), (block[0],) + world_dims[1:])
    fuse_prof = device_profile(
        lambda: fuse_tp(ref_tp, slab, "slab.raw"), top=8)
    setups = sorted(s for (vtp, s) in merged.views if vtp == ref_tp)
    streamed = RawVolumeStore(os.path.join(tmp, f"fused_tp{ref_tp}.raw"),
                              bbox.shape).read_block((0, 0, 0), bbox.shape)
    in_memory = fuse_views([merged.get_image((ref_tp, s)) for s in setups],
                           [merged.views[(ref_tp, s)].model()
                            for s in setups], bbox, fparams)
    fuse_err = nrmse(in_memory, streamed)

    # ---- the card against the CPU on tile 0 of timepoint 0
    vols = [merged.get_image((0, s)) for s in range(V)]
    det = {dev: [detect_beads(v, dparams, device=dev)[0] for v in vols]
           for dev in ("cuda", "cpu")}
    same_peaks = all(
        a.shape == b.shape and np.array_equal(np.round(a), np.round(b))
        for a, b in zip(det["cuda"], det["cpu"]))
    nominals = [sc["nominal_model"](0, v) for v in range(V)]
    regs = {dev: register_views(None, reg_cfg, points=det["cpu"],
                                initial_models=nominals, device=dev)
            for dev in ("cuda", "cpu")}
    model_diff = max(float(np.abs(a - b).max()) for a, b in
                     zip(regs["cuda"].models, regs["cpu"].models))
    pos_diff = max(float(np.abs(a - b).max()) for a, b in
                   zip(det["cuda"], det["cpu"])) if same_peaks else None

    # ---- the device's idle share over one timepoint's stage B
    prof = device_profile(lambda: run_job(
        master, ref_tp, process_tp,
        out_xml=os.path.join(tmp, "profiled_job.xml")), top=8)

    out = {
        "config": {k: cfg[k] for k in ("tiles", "views", "tile_size",
                                       "beads_per_tile", "overlap")},
        "world_dims": list(world_dims), "timepoints": T,
        "reference_tp": ref_tp, "views_per_tp": n_views,
        "reduced": cfg["reduced"], "walls_s": walls,
        "detect_ms_per_view": per_view_ms,
        "registrations_per_s": regs_per_s,
        "registration_split_s": reg_split_s,
        "points_per_view_min_median_max": points_per_view,
        "stabilization": stab,
        "max_residual_px": max(v["residual_px"] for v in stab.values()),
        "residual_tol_px": 0.5,
        "fused_tps": list(fused_tps), "fuse_walls_s": fuse_walls,
        "stage_d_profile_first_block_row": fuse_prof,
        "fusion_streamed_vs_in_memory_nrmse": fuse_err,
        "fusion_tol": CLI_OOC_FUSE_TOL,
        "tile_card_vs_cpu": {"same_peaks": same_peaks,
                             "max_pos_diff_px": pos_diff,
                             "max_model_diff": model_diff, "tol": 1e-4},
        "launches": launches, "segtopk_expected": expected,
        "peak_selection": (f"max_peaks {k} {'<=' if by_segments else '>'} "
                           f"{ROUNDS} rounds x {segments} segments: "
                           + ("segtopk" if by_segments
                              else "a sort of the whole field")),
        "stage_b_profile": prof}
    emit({"phase": "timelapse", **out})
    if not all(v["valid"] for v in stab.values()) \
            or out["max_residual_px"] >= 0.5:
        raise AssertionError(f"timelapse stabilization: {stab}")
    if not same_peaks or model_diff > 1e-4:
        raise AssertionError(f"timelapse tile on the card vs the CPU: "
                             f"{out['tile_card_vs_cpu']}")
    if not (fuse_err <= CLI_OOC_FUSE_TOL and np.all(np.isfinite(streamed))):
        raise AssertionError(f"timelapse streamed fusion vs in-memory: "
                             f"nrmse {fuse_err}")
    if launches["segtopk"] != expected:
        raise AssertionError(f"timelapse stage B launched segtopk "
                             f"{launches['segtopk']} times, expected "
                             f"{expected}")
    return out, launches["segtopk"]


def phase_timelapse() -> dict:
    """The timelapse and cluster path: `register_timeseries` at the
    pipeline's width (`timelapse_series`), then the production path of
    BASELINE config #5 (`timelapse_stress`) in a temporary directory of
    the checkout. Returns segtopk's launches in each."""
    import tempfile

    series = timelapse_series()["launches"]["segtopk"]
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT,
                                     prefix="_timelapse_smoke_") as d:
        _, stress = timelapse_stress(d)
    return {"series": series, "config5": stress}


def phase_small_vs_cpu() -> None:
    """The card against the port's plain CPU path on small inputs:
    lowrank RL (bf16 matrices through the kernels; both round the same f32
    sums to bf16 once, a flipped rounding compounds over iterations, hence
    the 2e-4 tolerance of the CPU parity tests), and detection on a 96^3
    bead volume (identical peak sets, sub-pixel positions within 1e-3
    px)."""
    from spim_registration_tpu_torch.detect import DoGParameters, detect_beads
    from spim_registration_tpu_torch.convert import views_from_numpy
    from spim_registration_tpu_torch.deconv import (
        DeconvolutionParameters,
        DeconvolutionRunner,
        gaussian_psf,
    )
    from spim_registration_tpu_torch.ops.fftconv import direct_convolve_np
    from spim_registration_tpu_torch.utils.simulation import render_beads

    shape = (40, 36, 44)
    rng = np.random.default_rng(3)
    truth = render_beads(rng.uniform(8, 28, size=(12, 3)), shape, sigma=1.1)
    psfs = [gaussian_psf((9, 9, 9), (2.0, 1.0, 1.4)),
            gaussian_psf((9, 9, 9), (1.0, 1.3, 2.0))]
    imgs = np.stack([direct_convolve_np(truth, p) for p in psfs])
    w = np.full(imgs.shape, 0.5, np.float32)
    params = DeconvolutionParameters(num_iterations=4, conv_backend="lowrank",
                                     psf_rank=8, psf_rank_tol=1e-3)
    out = {}
    for dev in ("cuda", "cpu"):
        prep = views_from_numpy(imgs, w, psfs, 2.0, device=dev)
        out[dev] = DeconvolutionRunner(prep, params, device=dev,
                                       ).run().cpu().numpy()
    nr = nrmse(out["cpu"], out["cuda"])

    dshape = (96, 96, 96)
    vol = render_beads(rng.uniform(6, 90, size=(80, 3)), dshape, sigma=1.5) \
        + rng.normal(0, 0.005, dshape).astype(np.float32)
    # max_peaks <= 4 x the 1728 segments, so the selection runs segtopk
    dparams = DoGParameters(sigma=1.8, threshold=0.004, max_peaks=2048)
    reset_launches()
    (pc, _), (pg, _) = (detect_beads(vol, dparams, device=d)
                        for d in ("cpu", "cuda"))
    det_launches = read_launches()["segtopk"]
    same = pc.shape == pg.shape and np.array_equal(np.round(pc),
                                                   np.round(pg))
    dpos = float(np.abs(pc - pg).max()) if same else None
    emit({"phase": "small_vs_cpu", "shape": list(shape), "nrmse": nr,
          "tol": 2e-4, "detect_shape": list(dshape),
          "detect_peaks": [len(pc), len(pg)], "detect_same_peaks": same,
          "detect_max_pos_diff_px": dpos, "detect_pos_tol_px": 1e-3,
          "detect_segtopk_launches": det_launches})
    if not nr < 2e-4:
        raise AssertionError(f"card vs CPU nrmse {nr}")
    if not same or dpos > 1e-3 or det_launches != 1:
        raise AssertionError(f"card vs CPU detection: {len(pg)} vs "
                             f"{len(pc)} peaks, same sites {same}, max "
                             f"position difference {dpos}, segtopk "
                             f"launches {det_launches}")


# ------------------------------------------------------------------ mesh

# phase mesh: positions of the in-process mesh (all on one card when it
# is the only one); the limits: sharded RL against the in-memory engine
# (nrmse; the blocked engine, which re-tiles z the same way, reached
# 2.18e-5 against it, PERF.md), the FFT backend as
# tests/test_parallel.py:102, the blocked engine on the mesh against it
# on one device (the same block updates), fusion and the CLI as
# tests/test_cli_mesh.py, detection as tests/test_parallel.py:170-172
MESH_POSITIONS = 4
# case (a)'s walls: runs of each engine after its warm-up
MESH_WALL_RUNS = 5
MESH_RL_TOL = 1e-4
MESH_FFT_RTOL, MESH_FFT_ATOL = 2e-3, 2e-4
MESH_VIEW_F32_ITERS = 2
MESH_OOC_ITERS, MESH_OOC_TOL = 2, 1e-5
MESH_FUSE_ATOL = 2e-6
MESH_DETECT_PX = 0.05
MESH_MODEL_TOL = 1e-4
MESH_CLI_DECONV_TOL = 2e-5
# the sub-pixel walk moves its centre while an offset exceeds 0.5: a peak
# whose offset lies within MESH_STEP_BOUNDARY of 0.5 may end a voxel
# apart in two engines whose DoG differ by f32 rounding. Case (h) accepts
# such a pair only with a float64 witness (`tie_witness`): the float64
# DoG's fit at the centre the walk left puts that offset within
# MESH_TIE_EPS of 0.5, so f32 rounding decides the step. At most one
# such pair in MESH_STEP_BOUNDARY_PER peaks.
MESH_STEP_BOUNDARY = 1e-3
MESH_TIE_EPS = 1e-4
MESH_STEP_BOUNDARY_PER = 100


def mesh_devices(n: int = MESH_POSITIONS) -> list:
    """n mesh positions over the visible cards in turn (all on cuda:0
    when it is the only one)."""
    k = torch.cuda.device_count()
    return [torch.device("cuda", i % k) for i in range(n)]


class capture_first:
    """Record the arguments of the first call of `module.name` inside the
    block (the call still runs). A wrapper keeps its counters on its
    module's name (`zpass.launches += 1`, `zpass.mz_padded`): where that
    name is the one patched, the spy carries every integer counter of the
    real function meanwhile and hands the counts back to it on exit."""

    def __init__(self, module, name: str):
        self.module, self.name, self.args = module, name, None

    def __enter__(self):
        real = getattr(self.module, self.name)

        def spy(*a, **kw):
            if self.args is None:
                self.args = (a, kw)
            return real(*a, **kw)

        self.start = {k: v for k, v in vars(real).items()
                      if type(v) is int}
        vars(spy).update(self.start)
        self.real, self.spy = real, spy
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        for k, v in self.start.items():
            setattr(self.real, k, getattr(self.real, k)
                    + getattr(self.spy, k) - v)
        setattr(self.module, self.name, self.real)


def mesh_kernels_at_shard(zp_args, sl_args) -> dict:
    """zpass and sl_rows on the first shard conv's own inputs (the band
    (R, zl, zl + 2 hz) over a halo-extended 64-row shard) against their
    plain versions, with single-call times."""
    from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc

    (mz, vm, win), _ = zp_args
    (a, My, Mx, ry, rx), _ = sl_args
    out = {"zpass": kernel_error(lc.zpass(mz, vm, win),
                                 lc.zpass_reference(mz, vm)),
           "sl_rows": kernel_error(lc.sl_rows(a, My, Mx, ry, rx),
                                   lc.fused_sl_reference(a, My, Mx))}
    out["zpass"].update(shape={"Mz": list(mz.shape), "vm": list(vm.shape)},
                        ms=cuda_ms(lambda: lc.zpass(mz, vm, win), 10),
                        plain_ms=cuda_ms(lambda: lc.zpass_reference(mz, vm),
                                         3))
    out["sl_rows"].update(shape={"a": list(a.shape), "My": list(My.shape)},
                          ms=cuda_ms(lambda: lc.sl_rows(a, My, Mx, ry, rx),
                                     10),
                          plain_ms=cuda_ms(
                              lambda: lc.fused_sl_reference(a, My, Mx), 3))
    return out


def wall_spread(walls) -> dict:
    """Median, least and largest of a list of walls (s), and the spread
    (largest - least) over the median."""
    med = float(np.median(walls))
    return {"n": len(walls), "median_s": med, "min_s": float(min(walls)),
            "max_s": float(max(walls)),
            "spread": float((max(walls) - min(walls)) / med)}


def mesh_rl(prep, mesh) -> dict:
    """(a) config #4 through `sharded_deconvolution_runner` on the z mesh,
    lowrank (sequential, 20 iterations) and FFT, each against the
    in-memory runner on the card; walls of both (MESH_WALL_RUNS runs
    after a warm-up, with their median and spread; the sharded run
    returns its shards on the card); launches of the counted run (on
    both backends one `rl_quotient` and one `rl_update` a view and
    position), and of the lowrank run a torch.profiler breakdown of one
    more; zpass and sl_rows held against their plain versions on the
    first shard conv's inputs."""
    from spim_registration_tpu_torch.deconv import DeconvolutionRunner
    from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc
    from spim_registration_tpu_torch.parallel import (
        sharded_deconvolution_runner,
    )
    from spim_registration_tpu_torch.parallel.mesh import gather

    info = {}
    for backend in ("lowrank", "fft"):
        params = rl_params(backend, N_ITER)
        mem = DeconvolutionRunner(prep, params)
        want = mem.run()
        mem_walls = [sync_wall(mem.run)[1] for _ in range(MESH_WALL_RUNS)]
        run, stage_s = sync_wall(lambda: sharded_deconvolution_runner(
            prep, params, mesh, device_result=True))
        with capture_first(lc, "zpass") as zp, \
                capture_first(lc, "sl_rows") as sl:
            sync_wall(run)
        reset_launches()
        shards, wall = sync_wall(run)
        launches = read_launches()
        walls = [wall] + [sync_wall(run)[1]
                          for _ in range(MESH_WALL_RUNS - 1)]
        got = gather(shards, mesh, ("z",))[:SHAPE[0]]
        want = want.cpu().numpy()
        n_upd = N_ITER * prep.images.shape[0] * mesh.size
        case = {"staging_s": stage_s, "sharded_walls_s": walls,
                "sharded_wall": wall_spread(walls),
                "in_memory_walls_s": mem_walls,
                "in_memory_wall": wall_spread(mem_walls),
                "launches": launches,
                "expected_update_launches": n_upd,
                "update_launches_ok": launches["rl_quotient"]
                == launches["rl_update"] == n_upd,
                "finite": bool(np.all(np.isfinite(got)))}
        if backend == "lowrank":
            n_mat = sum("mat" in e for e in mem.k1_ffts + mem.k2_ffts)
            case["expected_launches"] = N_ITER * n_mat * mesh.size
            case["nrmse"] = nrmse(want, got)
            case["tol"] = MESH_RL_TOL
            case["ok"] = bool(case["nrmse"] <= MESH_RL_TOL and case["finite"]
                              and case["update_launches_ok"]
                              and launches["zpass"] == launches["sl_rows"]
                              == case["expected_launches"])
            case["profile"] = device_profile(run)
            case["shard_kernels"] = mesh_kernels_at_shard(zp.args, sl.args)
            case["ok"] &= all(k["ok"] for k in
                              case["shard_kernels"].values())
        else:
            d = np.abs(got - want)
            case["max_abs_err"] = float(d.max())
            case["rtol"], case["atol"] = MESH_FFT_RTOL, MESH_FFT_ATOL
            case["ok"] = bool(np.all(d <= MESH_FFT_ATOL + MESH_FFT_RTOL
                                     * np.abs(want)) and case["finite"]
                              and case["update_launches_ok"])
        info[backend] = case
        del mem, run, shards
        torch.cuda.empty_cache()
    return info


def mesh_view_axis(prep) -> dict:
    """(b) the view axis: `view=2, z=2` positions, the parallel scheme,
    stacked lowrank matrices, each against the in-memory parallel run
    (MESH_RL_TOL): bf16 over 20 iterations (its dither phase advances per
    iteration, the in-memory run's per view-update, so the two round
    differently) and float32 (one phase: the same sums) over
    MESH_VIEW_F32_ITERS iterations: the float32 kernels take ~0.24 s a
    conv at these shapes (7.6 s for 2 iterations, NVIDIA H100 80GB HBM3,
    700.00 W)."""
    from spim_registration_tpu_torch.deconv import DeconvolutionRunner
    from spim_registration_tpu_torch.parallel import (
        make_mesh,
        sharded_deconvolve,
    )

    mesh = make_mesh(("view", "z"), (2, 2), devices=mesh_devices())
    out = {"mesh": {"view": 2, "z": 2}}
    for dtype, n_iter in (("bfloat16", N_ITER),
                          ("float32", MESH_VIEW_F32_ITERS)):
        tol = MESH_RL_TOL
        params = dataclasses.replace(rl_params("lowrank", n_iter),
                                     scheme="parallel", lowrank_dtype=dtype)
        want = DeconvolutionRunner(prep, params).run().cpu().numpy()
        reset_launches()
        got, wall = sync_wall(lambda: sharded_deconvolve(
            prep, params, mesh, view_axis="view"))
        launches = read_launches()
        e = nrmse(want, got)
        out[dtype] = {"iters": n_iter, "nrmse": e, "tol": tol,
                      "wall_s": wall,
                      "launches": launches,
                      "ok": bool(e <= tol and np.all(np.isfinite(got))
                                 and launches["zpass"] > 0
                                 and launches["sl_rows"] > 0)}
    return out


def mesh_ragged(pipe) -> dict:
    """(c) the pipeline's 208^3 box on `z=3` (208 = 3 x 69 + 1: mirror
    rows re-pinned after every update), its 10 lowrank iterations against
    the pipeline phase's in-memory `deconvolve`."""
    from spim_registration_tpu_torch.deconv import DeconvolutionParameters
    from spim_registration_tpu_torch.parallel import (
        make_mesh,
        sharded_deconvolution_runner,
    )

    mesh = make_mesh(("z",), (3,), devices=mesh_devices(3))
    params = DeconvolutionParameters(num_iterations=10,
                                     conv_backend="lowrank")
    run = sharded_deconvolution_runner(pipe["prep"], params, mesh)
    reset_launches()
    got, wall = sync_wall(run)
    launches = read_launches()
    e = nrmse(pipe["deconv"], got)
    return {"depth": run.true_depth, "padded_depth": run.padded_depth,
            "nrmse": e, "tol": MESH_RL_TOL, "wall_s": wall,
            "launches": launches,
            "ok": bool(e <= MESH_RL_TOL and got.shape == pipe["deconv"].shape
                       and launches["zpass"] > 0)}


def _nearest(a: np.ndarray, b: np.ndarray) -> float:
    """The largest distance from a point of `a` to its nearest in `b`."""
    if len(a) == 0:
        return 0.0
    d = np.linalg.norm(a[:, None] - b[None], axis=-1)
    return float(d.min(axis=1).max())


def detect_views() -> dict:
    """Phase detect's 8 views: the detection volume, each with its own
    noise (seed 11)."""
    vol = detection_volume()
    rng = np.random.default_rng(11)
    return {(0, s): vol + rng.normal(0, 1e-4, vol.shape).astype(np.float32)
            for s in range(DETECT_VIEWS)}


def views_dataset(views: dict):
    """A dataset of in-memory views of SHAPE (the loader reads `views`)."""
    from spim_registration_tpu_torch.core.dataset import (
        Dataset,
        ViewDescription,
    )

    ds = Dataset(base_path=str(ROOT))
    for vid in views:
        ds.views[vid] = ViewDescription(view_id=vid, size=SHAPE)
    ds.loader = views.__getitem__
    return ds


def mesh_detect(mesh) -> dict:
    """(d) phase detect's 8 views through `detect_beads_dataset(mesh=...)`
    against the single-device engine: the same counts, every point within
    MESH_DETECT_PX of one of the other's; segtopk held against its plain
    version, exactly, on the first shard's field."""
    from spim_registration_tpu_torch.detect import DoGParameters
    from spim_registration_tpu_torch.detect.dog import detect_beads_dataset
    from spim_registration_tpu_torch.ops import extrema
    from spim_registration_tpu_torch.ops.kernels import segtopk as st

    views = detect_views()
    params = DoGParameters(sigma=1.8, threshold=0.004)
    pts, walls, launches = {}, {}, {}
    for name, kw in (("single", {}), ("mesh", {"mesh": mesh})):
        ds = views_dataset(views)
        if name == "mesh":
            with capture_first(extrema, "segment_topk") as cap:
                detect_beads_dataset(ds, view_ids=[(0, 0)], params=params,
                                     **kw)
        reset_launches()
        _, walls[name] = sync_wall(lambda: detect_beads_dataset(
            ds, params=params, **kw))
        launches[name] = read_launches()
        pts[name] = {vid: np.asarray(ds.views[vid].interest_points[
            "beads"].points) for vid in views}
    counts = {k: [len(pts[k][v]) for v in views] for k in pts}
    far = max(max(_nearest(pts["single"][v], pts["mesh"][v]),
                  _nearest(pts["mesh"][v], pts["single"][v]))
              for v in views)
    seg = {"segments": 0, "equal": [False], "max_abs_err": None}
    if cap.args is not None:   # None: no shard took the segment path
        (tiles, rounds), _ = cap.args
        got = st.segment_topk(tiles, rounds)
        want = st.segment_topk_reference(tiles, rounds)
        torch.cuda.synchronize()
        seg = {"segments": int(tiles.shape[0]),
               "equal": [bool(torch.equal(a, b)) for a, b in zip(got, want)],
               "max_abs_err": float((got[0] - want[0]).abs()
                                    .nan_to_num(0.0).max())}
    out = {"counts": counts, "max_nearest_px": far, "tol_px": MESH_DETECT_PX,
           "walls_s": walls, "launches": launches, "shard_segtopk": seg,
           "expected_segtopk": DETECT_VIEWS * mesh.size}
    out["ok"] = bool(counts["single"] == counts["mesh"]
                     and far < MESH_DETECT_PX and all(seg["equal"])
                     and launches["mesh"]["segtopk"]
                     == out["expected_segtopk"])
    return out


def mesh_fuse_register(pipe, mesh) -> dict:
    """(e) `sharded_fuse_views` on the pipeline scene's box against the
    pipeline phase's `fuse_views`; (f) `register_views(mesh=...)` against
    its single-device registration: the same inlier sets (as point pairs:
    the sharded detection lists points in another order), models within
    MESH_MODEL_TOL."""
    from spim_registration_tpu_torch.fuse import FusionParameters
    from spim_registration_tpu_torch.parallel import sharded_fuse_views
    from spim_registration_tpu_torch.pipeline import register_views

    scene, reg = pipe["scene"], pipe["reg"]
    fused, fwall = sync_wall(lambda: sharded_fuse_views(
        scene.volumes, reg.models, pipe["bbox"], FusionParameters(),
        mesh=mesh))
    fuse_err = float(np.abs(fused - pipe["fused"]).max())
    reset_launches()
    mreg, rwall = sync_wall(lambda: register_views(
        scene.volumes, pipe["cfg"], mesh=mesh))
    launches = read_launches()
    model_err = max(float(np.abs(a - b).max())
                    for a, b in zip(reg.models, mreg.models))

    def pairs_of(res, points, pair):
        i, j = pair
        rows = np.round(np.concatenate(
            [points[i][res.inliers[:, 0]], points[j][res.inliers[:, 1]]],
            1), 3)
        return rows[np.lexsort(rows.T)]

    same = all(
        r.num_inliers == mreg.pair_results[p].num_inliers
        and np.allclose(pairs_of(r, reg.points, p),
                        pairs_of(mreg.pair_results[p], mreg.points, p),
                        atol=2e-3)
        for p, r in reg.pair_results.items())
    return {"fuse": {"wall_s": fwall, "max_abs_err": fuse_err,
                     "atol": MESH_FUSE_ATOL,
                     "ok": bool(fuse_err <= MESH_FUSE_ATOL)},
            "register": {"wall_s": rwall, "model_max_err": model_err,
                         "tol": MESH_MODEL_TOL, "same_inliers": same,
                         "launches": launches,
                         "ok": bool(same and model_err <= MESH_MODEL_TOL
                                    and launches["segtopk"]
                                    == N_VIEWS * mesh.size)}}


def mesh_ooc(prep, mesh) -> dict:
    """(g) the blocked lowrank engine on the mesh (4 blocks of 64 rows, one
    a position) against the same engine on one device, at 4 x 256^3 over
    MESH_OOC_ITERS iterations (cut from 20 for time; the width is not
    cut), in-memory stores."""
    from spim_registration_tpu_torch.deconv.blocked import (
        ArrayStore,
        BlockedDeconvolutionInputs,
        BlockedDeconvolutionRunner,
    )

    imgs = prep.images.cpu().numpy()
    ws = prep.weights.cpu().numpy()
    params = rl_params("lowrank", MESH_OOC_ITERS)
    inputs = BlockedDeconvolutionInputs(
        [ArrayStore(imgs[v]) for v in range(N_VIEWS)],
        [ArrayStore(ws[v]) for v in range(N_VIEWS)], prep.psfs,
        prep.osem_factor, psf_factors=prep.psf_factors)
    out, walls, launches = {}, {}, {}
    for name, kw in (("single", {}), ("mesh", {"mesh": mesh})):
        psi = ArrayStore(np.zeros(SHAPE, np.float32))
        runner = BlockedDeconvolutionRunner(inputs, psi, params,
                                            block_z=OOC_BLOCK_Z, **kw)
        reset_launches()
        _, walls[name] = sync_wall(runner.run)
        launches[name] = read_launches()
        out[name] = psi.array
    e = nrmse(out["single"], out["mesh"])
    return {"iters": MESH_OOC_ITERS, "block_z": OOC_BLOCK_Z, "nrmse": e,
            "identical": bool(np.array_equal(out["single"], out["mesh"])),
            "tol": MESH_OOC_TOL, "walls_s": walls, "launches": launches,
            "ok": bool(e <= MESH_OOC_TOL and launches["mesh"]["zpass"] > 0
                       and launches["mesh"] == launches["single"])}


def step_boundary_pairs(a: np.ndarray, b: np.ndarray, atol: float):
    """Match two peak lists: (unmatched, boundary pairs). A point of `a`
    without a point of `b` within `atol` is a boundary pair [a_i, b_j]
    where b_j, its nearest point of `b`, lies within 1.5 px and the
    sub-pixel offset of a_i or b_j on the axis they differ most sits
    within MESH_STEP_BOUNDARY of +-0.5: the refinement's step rule (move
    the centre one voxel while an offset exceeds 0.5) may then take
    either side on f32 rounding differences of the two engines' DoG,
    which `tie_witness` checks. Returns (points of `a` left unmatched
    otherwise, the boundary pairs)."""
    if len(a) == 0 or len(b) == 0:
        return len(a) + len(b), []
    d = np.linalg.norm(a[:, None] - b[None], axis=-1)
    left, pairs = 0, []
    for i in np.nonzero(d.min(axis=1) > atol)[0]:
        j = int(d[i].argmin())
        ax = int(np.abs(a[i] - b[j]).argmax())
        fracs = [abs(p[ax] - np.round(p[ax])) for p in (a[i], b[j])]
        if d[i, j] <= 1.5 and min(abs(f - 0.5) for f in fracs) \
                <= MESH_STEP_BOUNDARY:
            pairs.append([a[i].tolist(), b[j].tolist()])
        else:
            left += 1
    return left, pairs


def tie_witness(vol: np.ndarray, params, pair, mesh) -> dict:
    """Float64 evidence that a step-boundary pair is an f32 tie. `pair`
    is the two engines' points; a is the one whose offset sits nearer
    +-0.5 on the axis the two differ most. The quadratic fit is taken at
    the two voxels a lies between on that axis (its rounded voxel on the
    others) on three response fields: the single-device detection's
    (`dog_response`) in float64 and in float32, and the z-sharded
    engine's on `mesh` (`_dog_shards`, float32). It is a tie where, at
    one of the two voxels, the float64 offset on that axis lies within
    MESH_TIE_EPS of the step threshold 0.5 and the two engines' float32
    offsets lie on either side of it (one steps, the other does not)."""
    from spim_registration_tpu_torch.detect.dog import dog_response
    from spim_registration_tpu_torch.ops.extrema import (
        _gather27,
        _quadratic_step_batched,
    )
    from spim_registration_tpu_torch.parallel.sharded_detect import (
        _REFINE_MARGIN,
        _dog_shards,
    )

    if params.downsample_z != 1 or params.downsample_xy != 1:
        raise ValueError("tie_witness: the CLI's detection has no "
                         "downsampling")
    a, b = (np.asarray(p, np.float64) for p in pair)
    ax = int(np.abs(a - b).argmax())
    if abs(abs(b[ax] - np.round(b[ax])) - 0.5) \
            < abs(abs(a[ax] - np.round(a[ax])) - 0.5):
        a, b = b, a
    c = np.round(a).astype(np.int64)
    centres = []
    for k in (np.floor(a[ax]), np.ceil(a[ax])):
        c[ax] = int(k)
        centres.append(c.copy())

    def fit(dog, z_lo=0):
        """The offsets on `ax` at the centres; dog[0] is global row z_lo."""
        Z, Y, X = dog.shape
        base = torch.tensor([(int(q[0]) - z_lo) * Y * X + int(q[1]) * X
                             + int(q[2]) for q in centres],
                            device=dog.device)
        off, _ = _quadratic_step_batched(_gather27(dog.reshape(-1), base,
                                                   Y * X, X))
        return off[:, ax].double().cpu().tolist()

    v = torch.from_numpy(np.asarray(vol, np.float32)).cuda()
    offsets = {"single_f64": fit(dog_response(v.double(), params)),
               "single_f32": fit(dog_response(v, params))}
    del v
    dogs, zl, _ = _dog_shards(vol, params, mesh, mesh.axis_names[-1])
    p = int(centres[0][0]) // zl
    offsets["mesh_f32"] = fit(dogs[p], p * zl - _REFINE_MARGIN)
    del dogs
    gaps = [abs(abs(o) - 0.5) for o in offsets["single_f64"]]
    t = int(np.argmin(gaps))
    steps = [abs(offsets[k][t]) > 0.5 for k in ("single_f32", "mesh_f32")]
    return {"axis": ax, "centres": [q.tolist() for q in centres],
            **{f"offset_{k}": o for k, o in offsets.items()},
            "gap_f64": gaps[t], "tol": MESH_TIE_EPS,
            "f32_steps": steps,
            "ok": bool(gaps[t] <= MESH_TIE_EPS and steps[0] != steps[1])}


def mesh_cli() -> dict:
    """(h) the CLI verbs with `--mesh z=1` (and `z=N` where N > 1 cards are
    visible) on phase cli's dataset (simulated again from its seed),
    against the same verbs without `--mesh`, as tests/test_cli_mesh.py
    pairs them: `detect` on two copies (the same counts; every point
    within 1e-3 px of one of the other's, except step-boundary pairs
    (`step_boundary_pairs`), at most one in MESH_STEP_BOUNDARY_PER
    points, each held to its float64 witness (`tie_witness`)); `register`
    with and without on two copies of one detected XML (models within
    1e-5); `fuse` and `deconvolve` (FFT, 3 iterations) on one registered
    XML (atol MESH_FUSE_ATOL, nrmse < MESH_CLI_DECONV_TOL); `cluster-job
    --tp 0` on two copies (points as `detect`'s; models within
    CLI_CLUSTER_TOL, and where witnessed ties moved points, the difference
    is printed and the mesh job's models are held within CLI_CLUSTER_TOL
    of `register` without the mesh on the single-device points with the
    tie points swapped for the mesh's). On one card `detect --mesh z=2`
    must exit 2 with "mesh needs 2 devices, have 1"."""
    import contextlib
    import io
    import shutil
    import tempfile

    from spim_registration_tpu_torch import cli
    from spim_registration_tpu_torch.core.xml_io import (
        load_dataset,
        save_dataset,
    )
    from spim_registration_tpu_torch.parallel import mesh_from_spec

    def run(argv) -> int:
        err, buf = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        run.err = err.getvalue()
        return rc

    def ok_run(argv) -> None:
        if run(argv) != 0:
            raise AssertionError(f"cli {argv} exited non-zero: "
                                 f"{run.err[-400:]}")

    def state(xml):
        ds = load_dataset(xml)
        pts = {vid: np.asarray(vd.interest_points["beads"].points)
               for vid, vd in ds.views.items()}
        return pts, {vid: vd.model() for vid, vd in ds.views.items()}

    def model_err(a, b) -> float:
        return max(float(np.abs(a[v] - b[v]).max()) for v in a)

    def compare_points(xml_one, xml_mesh, mesh_obj):
        """Counts, unmatched points and the witnessed step-boundary
        pairs of two detections of the base dataset."""
        p1, pm = state(xml_one)[0], state(xml_mesh)[0]
        counts = [[len(p1[v]), len(pm[v])] for v in p1]
        left, pairs = 0, []
        for v in p1:
            n_left, bp = step_boundary_pairs(p1[v], pm[v], 1e-3)
            left += n_left
            for pr in bp:
                pairs.append({"view": list(v), "pair": pr,
                              "witness": tie_witness(
                                  base_ds.get_image(v), params, pr,
                                  mesh_obj)})
        n_pts = sum(c[0] for c in counts)
        ok = bool(all(a == b for a, b in counts) and left == 0
                  and len(pairs) * MESH_STEP_BOUNDARY_PER <= n_pts
                  and all(p["witness"]["ok"] for p in pairs))
        return {"counts": counts, "unmatched": left,
                "step_boundary_pairs": pairs, "ok": ok}

    n_cards = torch.cuda.device_count()
    specs = ["z=1"] + ([f"z={n_cards}"] if n_cards > 1 else [])
    walls = {}
    out = {"specs": specs}
    ok = True
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_mesh_smoke_") as d:
        def copy(name, src="base"):
            shutil.copytree(os.path.join(d, src), os.path.join(d, name))
            return os.path.join(d, name, "dataset.xml")

        t0 = time.perf_counter()
        ok_run(["simulate", "--out", os.path.join(d, "base"), "--views",
                str(N_VIEWS), "--shape", *map(str, SHAPE), "--beads", "300",
                "--blur", "--seed", "11"])
        walls["simulate"] = time.perf_counter() - t0
        base_ds = cli._dataset_with_loader(os.path.join(d, "base",
                                                        "dataset.xml"))
        params = cli._load_config(cli.build_parser().parse_args(
            ["detect", os.path.join(d, "base", "dataset.xml")])).detection
        one = copy("one")
        ok_run(["detect", one])
        reg = copy("reg", "one")
        ok_run(["register", reg])
        fused1, psi1 = (os.path.join(d, f) for f in ("f1.npy", "p1.npy"))
        ok_run(["fuse", reg, "--out", fused1])
        iters = ["--set", "deconvolution.num_iterations=3"]
        ok_run(["deconvolve", reg, "--out", psi1, *iters])
        job1 = copy("job_one")
        ok_run(["cluster-job", job1, "--tp", "0"])
        job1 = os.path.join(os.path.dirname(job1), "job_tp0.xml")
        for spec in specs:
            tag = spec.replace("=", "")
            mesh = ["--mesh", spec]
            t0 = time.perf_counter()
            det = copy("det_" + tag)
            ok_run(["detect", det, *mesh])
            regm = copy("reg_" + tag, "one")
            ok_run(["register", regm, *mesh])
            fused, psi = (os.path.join(d, f"{f}_{tag}.npy")
                          for f in ("f", "p"))
            ok_run(["fuse", reg, "--out", fused, *mesh])
            ok_run(["deconvolve", reg, "--out", psi, *iters, *mesh])
            job = copy("job_" + tag)
            ok_run(["cluster-job", job, "--tp", "0", *mesh])
            job = os.path.join(os.path.dirname(job), "job_tp0.xml")
            walls[spec] = time.perf_counter() - t0
            mesh_obj = mesh_from_spec(spec, "cuda")
            detect = compare_points(one, det, mesh_obj)
            cluster = compare_points(job1, job, mesh_obj)
            cluster["model_max_err"] = model_err(state(job1)[1],
                                                 state(job)[1])
            if cluster["step_boundary_pairs"]:
                # the single-device points (`detect` without the mesh:
                # the job's) with the tie points swapped for the mesh's,
                # registered without the mesh
                swap = copy("swap_" + tag, "one")
                ds = load_dataset(swap)
                for bp in cluster["step_boundary_pairs"]:
                    ips = ds.views[tuple(bp["view"])].interest_points[
                        "beads"]
                    a, b = (np.asarray(q) for q in bp["pair"])
                    i = int(np.abs(ips.points - a).max(axis=1).argmin())
                    ips.points[i] = b
                save_dataset(ds, swap)
                ok_run(["register", swap])
                cluster["swapped_model_max_err"] = model_err(
                    state(swap)[1], state(job)[1])
                cluster["ok"] &= bool(cluster["swapped_model_max_err"]
                                      <= CLI_CLUSTER_TOL)
            else:
                cluster["ok"] &= bool(cluster["model_max_err"]
                                      <= CLI_CLUSTER_TOL)
            case = {
                "detect": detect, "cluster_job": cluster,
                "register_model_max_err": model_err(state(reg)[1],
                                                    state(regm)[1]),
                "fuse_max_abs_err": float(np.abs(
                    np.load(fused1) - np.load(fused)).max()),
                "deconvolve_nrmse": nrmse(np.load(psi1), np.load(psi))}
            case["ok"] = bool(
                detect["ok"] and cluster["ok"]
                and case["register_model_max_err"] <= 1e-5
                and case["fuse_max_abs_err"] <= MESH_FUSE_ATOL
                and case["deconvolve_nrmse"] < MESH_CLI_DECONV_TOL)
            ok &= case["ok"]
            out[spec] = case
        if n_cards == 1:
            rc = run(["detect", copy("refuse"), "--mesh", "z=2"])
            out["refused_z2"] = {"rc": rc, "said": run.err.strip()[-120:]}
            ok &= rc == 2 and "mesh needs 2 devices, have 1" in run.err
    out["walls_s"] = walls
    out["ok"] = bool(ok)
    return out


def phase_mesh(psfs, factors, pipe) -> dict:
    """The in-process device mesh at full width (cases (a)-(h) of the
    functions above), MESH_POSITIONS positions over the visible cards.
    Prints one JSON line per case; returns the launches of zpass,
    sl_rows, rl_quotient and rl_update in (a)'s counted lowrank run and of
    segtopk in (d)'s meshed detection, and the shard-shape errors."""
    from spim_registration_tpu_torch.parallel import make_mesh

    mesh = make_mesh(("z",), (MESH_POSITIONS,), devices=mesh_devices())
    devs = [str(d) for d in mesh.devices.flat]
    prep = make_rl_prep(SHAPE, psfs, factors)   # (a), (b), (g)
    results = {}
    for name, fn, args in (
            ("rl", mesh_rl, (prep, mesh)),
            ("view_axis", mesh_view_axis, (prep,)),
            ("ragged", mesh_ragged, (pipe,)),
            ("detect", mesh_detect, (mesh,)),
            ("fuse_register", mesh_fuse_register, (pipe, mesh)),
            ("ooc", mesh_ooc, (prep, mesh)),
            ("cli", mesh_cli, ())):
        t0 = time.perf_counter()
        results[name] = fn(*args)
        torch.cuda.empty_cache()
        emit({"phase": "mesh", "case": name, "devices": devs,
              "wall_s": time.perf_counter() - t0, **results[name]})
    bad = [n for n, r in results.items()
           if not all(c["ok"] for c in ([r] if "ok" in r else
                                        [v for v in r.values()
                                         if isinstance(v, dict)
                                         and "ok" in v]))]
    if bad:
        raise AssertionError(f"phase mesh failed: {bad}")
    rl = results["rl"]["lowrank"]
    shard = rl["shard_kernels"]
    return {**{k: rl["launches"][k]
               for k in ("zpass", "sl_rows", "rl_quotient", "rl_update")},
            "segtopk": results["detect"]["launches"]["mesh"]["segtopk"],
            "errors": {"zpass": shard["zpass"]["max_abs_err"],
                       "sl_rows": shard["sl_rows"]["max_abs_err"],
                       "segtopk": results["detect"]["shard_segtopk"][
                           "max_abs_err"]}}



# phase multihost: two processes joined by torch.distributed, each driving
# MH_LOCAL positions on its card(s), so the mesh of (a), (c), (d) and (e)
# has phase mesh's 4 positions across a process boundary. The limits: (a)
# against the in-memory runner MH_RL_TOL (the one-process mesh measured
# 2.358e-5 on an H100; the blocked engine 2.18e-5), every case against the
# same mesh on one process MH_MESH_TOL x max (the cross-process steps move
# data and add no arithmetic), (d) peak sets identical, the CLI as phase
# mesh (h) holds its verbs (1e-3 px or a witnessed f32 tie, 1e-5,
# MESH_CLI_DECONV_TOL)
MH_WORLD = 2
MH_LOCAL = 2
MH_RL_TOL = 5e-5
MH_MESH_TOL = 1e-6
MH_VIEW_ITERS = 1
MH_CLI_ITERS = 3
MH_TIMEOUT_S = 600
MH_REDUCED = ["(b) the float32 view axis: 20 -> 1 iteration (the time "
              "limit: 2 iterations took 9.6 s in each worker, NVIDIA "
              "H100 80GB HBM3, 700.00 W)"]
# how a worker is started (the script itself), and the port's CLI
MH_WORKER = [sys.executable, str(Path(__file__).resolve())]
MH_CLI = [sys.executable, "-m", "spim_registration_tpu_torch.cli"]


def mh_device() -> torch.device:
    """A worker's card: the first it sees (one card each on the NCCL run,
    where CUDA_VISIBLE_DEVICES gives each worker its own)."""
    return torch.device("cuda", 0)


def mh_cases(mesh, hz, prep, fuse_in, timed_runs: int, save) -> dict:
    """Cases (a)-(e) on a z mesh `mesh` and a ("host", "z") mesh `hz`;
    `save(name, array)` keeps each result. Returns walls and launches."""
    from spim_registration_tpu_torch.detect import DoGParameters
    from spim_registration_tpu_torch.detect.dog import detect_beads_dataset
    from spim_registration_tpu_torch.fuse import FusionParameters
    from spim_registration_tpu_torch.parallel import (
        multihost,
        sharded_deconvolution_runner,
        sharded_deconvolve,
        sharded_fuse_views,
    )
    from spim_registration_tpu_torch.parallel.mesh import gather

    info = {}
    for case, backend, runs in (("a", "lowrank", timed_runs),
                                ("c", "fft", 1)):
        run = sharded_deconvolution_runner(prep, rl_params(backend, N_ITER),
                                           mesh, device_result=True)
        sync_wall(run)                              # warm-up
        before = dict(multihost.traffic)
        reset_launches()
        shards, wall = sync_wall(run)
        launches = read_launches()
        hops = {k: multihost.traffic[k] - before[k] for k in before}
        walls = [wall] + [sync_wall(run)[1] for _ in range(runs - 1)]
        save(case, gather(shards, mesh, ("z",))[:SHAPE[0]])
        info[case] = {"launches": launches, "walls_s": walls,
                      "wall": wall_spread(walls), "hops": hops}
        del run, shards
        torch.cuda.empty_cache()
    params = dataclasses.replace(rl_params("lowrank", MH_VIEW_ITERS),
                                 scheme="parallel", lowrank_dtype="float32")
    reset_launches()
    got, wall = sync_wall(lambda: sharded_deconvolve(
        prep, params, hz, axis_name="z", view_axis="host"))
    save("b", got)
    info["b"] = {"launches": read_launches(), "wall_s": wall,
                 "iters": MH_VIEW_ITERS}
    ds = views_dataset(detect_views())
    reset_launches()
    _, wall = sync_wall(lambda: detect_beads_dataset(
        ds, params=DoGParameters(sigma=1.8, threshold=0.004), mesh=mesh))
    info["d"] = {"launches": read_launches(), "wall_s": wall}
    for vid, vd in sorted(ds.views.items()):
        save(f"d_{vid[1]}", np.asarray(vd.interest_points["beads"].points))
    got, wall = sync_wall(lambda: sharded_fuse_views(
        fuse_in["volumes"], fuse_in["models"], fuse_in["bbox"],
        FusionParameters(), mesh=mesh))
    save("e", got)
    info["e"] = {"wall_s": wall}
    return info


def mh_fuse_inputs(d: str) -> dict:
    """The pipeline scene's views, registered models and box, as the
    parent stored them for the workers."""
    from spim_registration_tpu_torch.core.dataset import BoundingBox

    z = np.load(os.path.join(d, "fuse_in.npz"))
    return {"volumes": [np.load(os.path.join(d, f"fuse_view{v}.npy"),
                                mmap_mode="r") for v in range(N_VIEWS)],
            "models": list(z["models"]),
            "bbox": BoundingBox("b", tuple(int(v) for v in z["lo"]),
                                tuple(int(v) for v in z["hi"]))}


def multihost_worker(rank: int, world: int, port: int, d: str) -> None:
    """One process of phase multihost: joins the group on localhost:port,
    loads the kernels phase build built, runs `mh_cases` on the mesh of
    world x MH_LOCAL positions, writes its results into DIR and prints
    one JSON line (route, walls, launches, the cross-process bytes and
    seconds)."""
    from spim_registration_tpu_torch.ops.kernels import build
    from spim_registration_tpu_torch.parallel import (
        host_z_mesh,
        initialize_multihost,
        multihost,
    )
    from spim_registration_tpu_torch.parallel.mesh import make_mesh
    from spim_registration_tpu_torch.utils.device import set_exact_float32

    missing = [n for n in build.SOURCES if not build._target(n).exists()]
    if missing:
        raise RuntimeError(f"kernels not built before the workers: {missing}")
    set_exact_float32()
    t0 = time.perf_counter()
    route = initialize_multihost(f"localhost:{port}", world, rank)
    join_s = time.perf_counter() - t0
    dev = mh_device()
    mesh = make_mesh(("z",), (world * MH_LOCAL,), devices=[dev] * MH_LOCAL)
    hz = host_z_mesh(MH_LOCAL, device=dev)
    psfs, factors = load_fixtures()
    prep = make_rl_prep(SHAPE, psfs, factors)

    def save(name, a):
        if rank == 0 or name == "a":   # (a) from both: every process
            np.save(os.path.join(d, f"{name}_rank{rank}.npy"), a)

    info = mh_cases(mesh, hz, prep, mh_fuse_inputs(d), MESH_WALL_RUNS, save)
    line = {"worker": rank, "route": route, "join_s": join_s,
            "positions": mesh.local_positions,
            "devices": [str(mesh.device(p)) for p in mesh.local_positions],
            "wall_s": time.perf_counter() - t0, **info}
    multihost.shutdown_multihost()
    emit(line)


def mh_spawn(argvs, envs, timeout: float = MH_TIMEOUT_S) -> list:
    """Start one process per argv at once from the checkout's root; the
    outputs, or AssertionError when any fails or times out (every one is
    killed then)."""
    procs = [subprocess.Popen(a, env=e, cwd=str(ROOT), text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for a, e in
             zip(argvs, envs)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"a process timed out after {timeout} s: "
                             f"{argvs}")
    for a, p, o in zip(argvs, procs, outs):
        if p.returncode != 0:
            raise AssertionError(f"{a} exited {p.returncode}:\n{o[-3000:]}")
    return outs


def mh_env(**extra) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def mh_references(psfs, factors, pipe, fuse_in) -> dict:
    """The one-process results the workers are held against: the in-memory
    runner and the same mesh on this process (positions on
    `mesh_devices`), for every case."""
    from spim_registration_tpu_torch.deconv import DeconvolutionRunner
    from spim_registration_tpu_torch.parallel import make_mesh

    prep = make_rl_prep(SHAPE, psfs, factors)
    mesh = make_mesh(("z",), (MH_WORLD * MH_LOCAL,),
                     devices=mesh_devices(MH_WORLD * MH_LOCAL))
    hz = make_mesh(("host", "z"), (MH_WORLD, MH_LOCAL),
                   devices=mesh_devices(MH_WORLD * MH_LOCAL))
    ref = {}
    info = mh_cases(mesh, hz, prep, fuse_in, 1,
                    lambda name, a: ref.__setitem__(name, np.asarray(a)))
    for case, params in (
            ("a", rl_params("lowrank", N_ITER)),
            ("c", rl_params("fft", N_ITER)),
            ("b", dataclasses.replace(rl_params("lowrank", MH_VIEW_ITERS),
                                      scheme="parallel",
                                      lowrank_dtype="float32"))):
        ref["mem_" + case] = DeconvolutionRunner(prep, params).run() \
            .cpu().numpy()
    ref["info"] = info
    ref["fused"] = pipe["fused"]
    del prep
    torch.cuda.empty_cache()
    return ref


def mh_check(d: str, ref: dict, workers: list) -> dict:
    """The workers' results against `mh_references`."""
    def load(name, rank=0):
        return np.load(os.path.join(d, f"{name}_rank{rank}.npy"))

    def vs_mesh(got, want):
        err = float(np.abs(got - want).max())
        return {"max_abs_err_vs_one_process": err,
                "tol": MH_MESH_TOL * float(np.abs(want).max()),
                "ok": bool(err <= MH_MESH_TOL * np.abs(want).max())}

    out = {}
    for case in ("a", "b", "c"):
        gots = [load(case, r) for r in range(MH_WORLD)] if case == "a" \
            else [load(case)]
        c = vs_mesh(gots[0], ref[case])
        c["same_on_every_process"] = all(np.array_equal(g, gots[0])
                                         for g in gots)
        c["finite"] = bool(np.all(np.isfinite(gots[0])))
        mem = ref["mem_" + case]
        if case == "c":
            dd = np.abs(gots[0] - mem)
            c["max_abs_err_vs_in_memory"] = float(dd.max())
            c["ok_vs_in_memory"] = bool(np.all(
                dd <= MESH_FFT_ATOL + MESH_FFT_RTOL * np.abs(mem)))
        else:
            c["nrmse_vs_in_memory"] = nrmse(mem, gots[0])
            tol = MH_RL_TOL if case == "a" else MESH_RL_TOL
            c["in_memory_tol"] = tol
            c["ok_vs_in_memory"] = bool(c["nrmse_vs_in_memory"] <= tol)
        c["ok"] = bool(c["ok"] and c["same_on_every_process"] and c["finite"]
                       and c["ok_vs_in_memory"])
        out[case] = c
    # every worker launches its positions' share of the one-process count
    per_pos = ref["info"]["a"]["launches"]["zpass"] // (MH_WORLD * MH_LOCAL)
    out["a"]["launches_ok"] = all(
        w["a"]["launches"]["zpass"] == w["a"]["launches"]["sl_rows"]
        == per_pos * MH_LOCAL > 0 for w in workers)
    # and the view update's kernels once a view and position of its own,
    # on both sequential backends
    n_upd = N_ITER * N_VIEWS * MH_LOCAL
    for case in ("a", "c"):
        out[case]["update_launches_ok"] = all(
            w[case]["launches"]["rl_quotient"]
            == w[case]["launches"]["rl_update"] == n_upd for w in workers)
        out[case]["ok"] &= out[case]["update_launches_ok"]
    out["a"]["ok"] &= out["a"]["launches_ok"]
    seg = [w["d"]["launches"]["segtopk"] for w in workers]
    same = [bool(np.array_equal(load(f"d_{s}"), ref[f"d_{s}"]))
            for s in range(DETECT_VIEWS)]
    out["d"] = {"counts": [len(ref[f"d_{s}"]) for s in range(DETECT_VIEWS)],
                "identical": same, "segtopk_each_worker": seg,
                "ok": bool(all(same) and all(
                    n == DETECT_VIEWS * MH_LOCAL for n in seg))}
    e = vs_mesh(load("e"), ref["e"])
    e["max_abs_err_vs_fuse_views"] = float(np.abs(load("e")
                                                  - ref["fused"]).max())
    e["ok"] = bool(e["ok"] and e["max_abs_err_vs_fuse_views"]
                   <= MESH_FUSE_ATOL)
    out["e"] = e
    return out


def mh_run_workers(d: str, visible=None) -> list:
    """Both workers on a free port (CUDA_VISIBLE_DEVICES = visible[rank]
    where given); their JSON lines."""
    port = free_port()
    envs = [mh_env(**({} if visible is None
                      else {"CUDA_VISIBLE_DEVICES": visible[r]}))
            for r in range(MH_WORLD)]
    outs = mh_spawn([MH_WORKER + ["--multihost-worker", str(r),
                                  str(MH_WORLD), str(port), d]
                     for r in range(MH_WORLD)], envs)
    return [json.loads([ln for ln in o.splitlines()
                        if ln.startswith("{")][-1]) for o in outs]


def mh_snapshot(root: str) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            st = os.stat(os.path.join(dirpath, f))
            out[os.path.relpath(os.path.join(dirpath, f), root)] = (
                st.st_size, st.st_mtime_ns)
    return out


def mh_cli(d: str) -> dict:
    """(f) `detect`, `register` and `deconvolve --multihost` as two
    processes (COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID) on phase
    cli's 4 x 256^3 dataset (simulated once here), each against the same
    verb run once without `--multihost` on the same input: detection
    equal to `detect_beads_dataset` on the same mesh (`--mesh auto`:
    every process's cards) on one process, and against the single-device
    verb as phase mesh (h) holds it (the same counts, every point within
    1e-3 px except step-boundary pairs, at most one in
    MESH_STEP_BOUNDARY_PER points, each an f32 tie by `tie_witness`: the
    z-sharded DoG rounds otherwise than the whole volume's); models
    within 1e-5; psi nrmse < MESH_CLI_DECONV_TOL. Process 1 reads a copy
    of the dataset, which must stay as it was, and prints no results."""
    import contextlib
    import io
    import shutil

    from spim_registration_tpu_torch import cli
    from spim_registration_tpu_torch.core.xml_io import load_dataset
    from spim_registration_tpu_torch.detect.dog import detect_beads_dataset
    from spim_registration_tpu_torch.parallel import make_mesh

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(argv)
        if rc != 0:
            raise AssertionError(f"cli {argv} exited {rc}")

    def state(xml):
        ds = load_dataset(xml)
        return ({v: np.asarray(vd.interest_points["beads"].points)
                 for v, vd in ds.views.items()
                 if "beads" in vd.interest_points},
                {v: vd.model() for v, vd in ds.views.items()})

    c = os.path.join(d, "cli")
    base = os.path.join(c, "base")
    walls = {}
    t0 = time.perf_counter()
    run(["simulate", "--out", base, "--views", str(N_VIEWS), "--shape",
         *map(str, SHAPE), "--beads", "300", "--blur", "--seed", "11"])
    walls["simulate"] = time.perf_counter() - t0
    verbs = (("detect", []), ("register", []),
             ("deconvolve", ["--out", "psi.npy", "--set",
                             f"deconvolution.num_iterations={MH_CLI_ITERS}"]))
    out = {"walls_s": walls}
    src = base
    for verb, extra in verbs:
        dirs = {k: os.path.join(c, f"{verb}_{k}")
                for k in ("single", "rank0", "rank1")}
        for k in dirs:
            shutil.copytree(src, dirs[k])

        def argv(k):
            return [verb, os.path.join(dirs[k], "dataset.xml")] + [
                os.path.join(dirs[k], a) if a == "psi.npy" else a
                for a in extra]

        t0 = time.perf_counter()
        run(argv("single"))
        walls[verb + "_single"] = time.perf_counter() - t0
        before = mh_snapshot(dirs["rank1"])
        port = free_port()
        t0 = time.perf_counter()
        logs = mh_spawn(
            [MH_CLI + [*argv(f"rank{r}"), "--multihost"]
             for r in range(MH_WORLD)],
            [mh_env(COORDINATOR_ADDRESS=f"localhost:{port}",
                    NUM_PROCESSES=MH_WORLD, PROCESS_ID=r)
             for r in range(MH_WORLD)])
        walls[verb + "_multihost"] = time.perf_counter() - t0
        said = {"detect": "points", "register": "residual",
                "deconvolve": "deconvolved"}[verb]
        case = {"rank0_prints": said in logs[0],
                "rank1_silent": said not in logs[1]
                and "view (" not in logs[1],
                "rank1_wrote_nothing": mh_snapshot(dirs["rank1"]) == before}
        one = os.path.join(dirs["single"], "dataset.xml")
        multi = os.path.join(dirs["rank0"], "dataset.xml")
        if verb == "detect":
            p1, pm = state(one)[0], state(multi)[0]
            counts = [[len(p1[v]), len(pm[v])] for v in sorted(p1)]
            case["counts"] = counts
            case["max_nearest_px"] = max(
                max(_nearest(p1[v], pm[v]), _nearest(pm[v], p1[v]))
                for v in p1)
            params = cli._load_config(cli.build_parser().parse_args(
                ["detect", one])).detection
            n = MH_WORLD * torch.cuda.device_count()   # `--mesh auto`
            mesh = make_mesh(("z",), (n,), devices=mesh_devices(n))
            ds = cli._dataset_with_loader(os.path.join(base, "dataset.xml"))
            detect_beads_dataset(ds, params=params, mesh=mesh)
            # within the XML's 6 decimals
            case["equal_to_one_process_mesh"] = all(
                np.allclose(np.asarray(ds.views[v].interest_points[
                    "beads"].points), pm[v], rtol=0, atol=1e-6)
                for v in pm)
            left, pairs = 0, []
            for v in sorted(p1):
                n_left, bp = step_boundary_pairs(p1[v], pm[v], 1e-3)
                left += n_left
                pairs += [{"view": list(v), "pair": pr,
                           "witness": tie_witness(ds.get_image(v), params,
                                                  pr, mesh)} for pr in bp]
            case["unmatched"] = left
            case["step_boundary_pairs"] = pairs
            case["ok"] = bool(
                all(a == b for a, b in counts) and left == 0
                and len(pairs) * MESH_STEP_BOUNDARY_PER
                <= sum(c[0] for c in counts)
                and all(p["witness"]["ok"] for p in pairs)
                and case["equal_to_one_process_mesh"])
        elif verb == "register":
            m1, mm = state(one)[1], state(multi)[1]
            case["model_max_err"] = max(float(np.abs(m1[v] - mm[v]).max())
                                        for v in m1)
            case["ok"] = case["model_max_err"] <= 1e-5
        else:
            a = np.load(os.path.join(dirs["single"], "psi.npy"))
            b = np.load(os.path.join(dirs["rank0"], "psi.npy"))
            case["nrmse"] = nrmse(a, b)
            case["ok"] = bool(a.shape == b.shape
                              and case["nrmse"] < MESH_CLI_DECONV_TOL)
        case["ok"] = bool(case["ok"] and case["rank0_prints"]
                          and case["rank1_silent"]
                          and case["rank1_wrote_nothing"])
        out[verb] = case
        src = dirs["rank0"]
    out["ok"] = all(out[v]["ok"] for v, _ in verbs)
    return out


def phase_multihost(psfs, factors, pipe) -> dict:
    """Two processes on the card: cases (a)-(e) of `mh_cases` in both
    workers over 2 x MH_LOCAL positions, held against the same mesh on
    this process and the in-memory engines (`mh_check`), on the route
    `initialize_multihost` picks (gloo through the host on one card; a
    second run with one card a worker, NCCL, where there are two or
    more), then the CLI (`mh_cli`). Prints one JSON line per run; returns
    each worker's launches of zpass, sl_rows, rl_quotient and rl_update in
    (a) and of segtopk in (d)."""
    import tempfile

    n_cards = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()      # every card
    runs = [("default", None)]
    if n_cards >= 2:
        runs.append(("one card a worker", [str(r) for r in range(MH_WORLD)]))
    launches = {}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_multihost_smoke_") \
            as d:
        scene, reg, bbox = pipe["scene"], pipe["reg"], pipe["bbox"]
        for v in range(N_VIEWS):
            np.save(os.path.join(d, f"fuse_view{v}.npy"),
                    np.asarray(scene.volumes[v], np.float32))
        np.savez(os.path.join(d, "fuse_in.npz"), models=np.stack(reg.models),
                 lo=np.asarray(bbox.min), hi=np.asarray(bbox.max))
        t0 = time.perf_counter()
        ref = mh_references(psfs, factors, pipe, mh_fuse_inputs(d))
        ref_s = time.perf_counter() - t0
        ok = True
        for name, visible in runs:
            t0 = time.perf_counter()
            workers = mh_run_workers(d, visible)
            wall = time.perf_counter() - t0
            checks = mh_check(d, ref, workers)
            hop = [w["a"]["hops"] for w in workers]
            line = {"phase": "multihost", "run": name, "nvidia_smi": smi,
                    "route": workers[0]["route"],
                    "processes": MH_WORLD, "positions_each": MH_LOCAL,
                    "devices": [w["devices"] for w in workers],
                    "wall_s": wall, "references_s": ref_s,
                    "reduced": MH_REDUCED,
                    "a_bytes_across_per_run": sum(h["bytes"] for h in hop),
                    "a_hop_s_per_run": [h["seconds"] for h in hop],
                    "a_exchanges_per_run": [h["exchanges"] for h in hop],
                    "a_walls_s": [w["a"]["walls_s"] for w in workers],
                    "a_wall": [w["a"]["wall"] for w in workers],
                    "a_one_process_wall_s": ref["info"]["a"]["walls_s"],
                    "c_walls_s": [w["c"]["walls_s"] for w in workers],
                    "launches": {c: [w[c]["launches"] for w in workers]
                                 for c in ("a", "b", "c", "d")},
                    "walls_s": {c: [w[c].get("wall_s") for w in workers]
                                for c in ("b", "d", "e")},
                    "join_s": [w["join_s"] for w in workers],
                    "worker_walls_s": [w["wall_s"] for w in workers],
                    **checks}
            if n_cards < 2:
                line["nccl"] = f"not run: {n_cards} card"
            emit(line)
            ok &= all(checks[c]["ok"] for c in ("a", "b", "c", "d", "e"))
            if name == "default":
                launches = {
                    **{k: [w["a"]["launches"][k] for w in workers]
                       for k in ("zpass", "sl_rows", "rl_quotient",
                                 "rl_update")},
                    "segtopk": [w["d"]["launches"]["segtopk"]
                                for w in workers]}
        t0 = time.perf_counter()
        cli_out = mh_cli(d)
        emit({"phase": "multihost", "case": "cli",
              "wall_s": time.perf_counter() - t0, **cli_out})
        ok &= cli_out["ok"]
    if not ok:
        raise AssertionError("phase multihost failed")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    alone = ap.add_mutually_exclusive_group()
    alone.add_argument("--zpass-of", metavar="DIR",
                       help="time only the z pass of DIR's package (`.` "
                            "for this checkout; another one, such as an "
                            "older commit unpacked beside it, for a "
                            "comparison within one call) and print no "
                            "result line")
    alone.add_argument("--sl-rows-of", metavar="DIR",
                       help="the same for the fused y/x rows pass")
    alone.add_argument("--segtopk-of", metavar="DIR",
                       help="the same for the segment top-k")
    alone.add_argument("--dog-of", metavar="DIR",
                       help="the same for the fused Difference-of-Gaussian")
    alone.add_argument("--zfused-of", metavar="DIR",
                       help="the same for the fully fused lowrank conv")
    alone.add_argument("--mesh-only", action="store_true",
                       help="run only the card, build, pipeline and mesh "
                            "phases of this checkout, without the result "
                            "line")
    alone.add_argument("--multihost-only", action="store_true",
                       help="run only the card, build, pipeline and "
                            "multihost phases of this checkout, without "
                            "the result line")
    alone.add_argument("--multihost-worker", nargs=4,
                       metavar=("RANK", "WORLD", "PORT", "DIR"),
                       help="one process of phase multihost (started by "
                            "that phase)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA card", file=sys.stderr)
        return 1
    other = (args.zpass_of or args.sl_rows_of or args.segtopk_of
             or args.dog_of or args.zfused_of)
    sys.path.insert(0, str(Path(other or ROOT).resolve()))
    import spim_registration_tpu_torch  # noqa: F401  (fails without the repo)

    if other:
        phase_card()
        if args.zpass_of:
            zpass_alone()
        elif args.sl_rows_of:
            sl_rows_alone()
        elif args.zfused_of:
            zfused_alone()
        else:
            from spim_registration_tpu_torch.utils.device import (
                set_exact_float32,
            )

            set_exact_float32()
            detection_kernel_alone("segtopk" if args.segtopk_of else "dog")
        return 0

    # the CP-factor cache stays inside the checkout
    os.environ.setdefault("SPIM_FACTOR_CACHE_DIR",
                          str(ROOT / ".factor_cache"))
    if args.multihost_worker:
        rank, world, port, d = args.multihost_worker
        multihost_worker(int(rank), int(world), int(port), d)
        return 0
    from spim_registration_tpu_torch.utils.device import set_exact_float32

    set_exact_float32()
    walls = {}
    t_start = time.perf_counter()

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        return out

    smi = timed("card", phase_card)
    timed("build", phase_build)
    psfs, factors = load_fixtures()
    if args.mesh_only or args.multihost_only:
        pipe = timed("pipeline", phase_pipeline)
        if args.mesh_only:
            timed("mesh", phase_mesh, psfs, factors, pipe)
        else:
            timed("multihost", phase_multihost, psfs, factors, pipe)
        emit({"phase": "walls", "seconds": walls,
              "total_s": time.perf_counter() - t_start})
        return 0
    counts, runner = timed("rl", phase_rl, psfs, factors)
    timed("profile", phase_profile, runner)
    kernels = timed("kernels", phase_kernels, runner)
    kernels.update(timed("rl_update", phase_rl_update, runner, psfs))
    vol = detection_volume()
    direct = timed("direct", phase_direct, runner, psfs, vol, smi)
    del runner
    counts["segtopk"] = timed("detect", phase_detect, vol)
    kernels["segtopk"] = timed("segtopk", phase_segtopk, vol)
    kernels["dog"] = timed("dog", phase_dog, vol)
    del vol
    kernels["dog"]["library_ms"] = direct["dog_ms"]
    kernels["dog"]["library"] = ("direct_convolve(vol, G1 - G2, 'mirror'): "
                                 "one cuDNN conv3d")
    kernels["zfused"]["library_ms"] = direct["zfused_exact_ms"]
    kernels["zfused"]["library"] = ("direct_convolve of the kernel the "
                                    "entry approximates (cuDNN conv3d, "
                                    "f32): the exact conv that the lowrank "
                                    "conv approximates")
    timed("match", phase_match)
    pipe = timed("pipeline", phase_pipeline)
    mesh = timed("mesh", phase_mesh, psfs, factors, pipe)
    multihost = timed("multihost", phase_multihost, psfs, factors, pipe)
    del pipe
    launches_timelapse = timed("timelapse", phase_timelapse)
    timed("small_vs_cpu", phase_small_vs_cpu)
    ooc, ooc_errs = timed("ooc", phase_ooc, psfs, factors)
    for name in ("zpass", "sl_rows"):
        kernels[name]["launches_ooc"] = ooc[name]
        kernels[name]["max_abs_err_ooc_blocks"] = ooc_errs[name]
    timed("cli", phase_cli)
    launches_formats = timed("formats", phase_formats)
    emit({"phase": "walls", "seconds": walls,
          "total_s": time.perf_counter() - t_start})
    for name in ("zpass", "sl_rows", "segtopk", "rl_quotient", "rl_update"):
        kernels[name]["launches"] = counts[name]
    kernels["segtopk"]["launches_timelapse"] = launches_timelapse["series"]
    kernels["segtopk"]["launches_timelapse_config5"] = \
        launches_timelapse["config5"]
    for name, n in launches_formats.items():
        kernels[name]["launches_formats"] = n
    for name in ("zpass", "sl_rows", "segtopk", "rl_quotient", "rl_update"):
        kernels[name]["launches_mesh"] = mesh[name]
        kernels[name]["launches_multihost"] = multihost[name]
    for name in ("zpass", "sl_rows", "segtopk"):
        kernels[name]["max_abs_err_mesh_shard"] = mesh["errors"][name]
    emit({"kernels": [kernels[k] for k in ("zpass", "sl_rows", "segtopk",
                                           "dog", "zfused", "rl_quotient",
                                           "rl_update")]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
