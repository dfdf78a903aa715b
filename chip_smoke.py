#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Drives the port (`spim_registration_tpu_torch`, never JAX or the JAX
package) and exits nonzero on any failure:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
   builds every CUDA kernel of `spim_registration_tpu_torch/csrc/` with
   nvcc, one process per source, all at once;
2. the main path: multi-view Richardson-Lucy at the bench configuration
   (4 views x 256^3, the committed fixture PSFs, efficient-Bayesian,
   sequential, 20 iterations) with the lowrank backend on the kernels and
   with the exact FFT backend; kernel launch counts over one lowrank run,
   throughput, the lowrank-vs-fft accuracy gate after 5 iterations and
   each engine's self-repeat; then a `torch.profiler` trace of one
   lowrank run: device time by kernel and the device's idle share;
3. kernels vs their plain PyTorch versions at the main path's shapes
   (256^3, the staged bf16 matrices of the fixture PSFs at their real
   ranks): the z pass banded, dense and at a z-slab offset, and the fused
   y/x rows pass; error, median time (CUDA events), plain time, one-call
   library time and the least time the card could take (bound);
4. the registered reconstruction through the public entry points
   (simulated 4-view 256^3 scene -> extract_psf -> prepare_views ->
   fuse_views -> deconvolve) with the sharpening check;
5. the card against the port's plain CPU path on a small input.

Each phase prints one JSON line; then a `kernels` JSON line, the
nvidia-smi line, and last `{"ok": true, "device": {...}}`.
"""

from __future__ import annotations

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
N_VIEWS, N_ITER, SHAPE = 4, 20, (256, 256, 256)
GATE_TOL = 5e-4
KERNEL_TOL_NRMSE = 1e-3
KERNEL_TOL_MAX = 2.0 ** -7       # x max|out|: one bf16 ULP of the scale


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nrmse(a, b) -> float:
    """The bench's nrmse: rms difference over the range of `a`."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / (a.max() - a.min()))


def sync_wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of `fn` over `reps` calls after one warm-up."""
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


def phase_kernels(runner) -> dict:
    """Each kernel against its plain version at the main path's shapes:
    the highest-rank matrix entry of the staged lowrank runner."""
    from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc

    entries = [e for e in runner.k1_ffts + runner.k2_ffts if "mat" in e]
    entry = max(entries, key=lambda e: e["mat"][0].shape[1])
    Mz, My, Mx = (M[0] for M in entry["mat"])
    rad_z = entry["rad"][0]
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
    a = lc.zpass(Mz, vm, wins)
    cases["sl_rows"] = kernel_error(lc.sl_rows(a, My, Mx),
                                    lc.fused_sl_reference(a, My, Mx))
    torch.cuda.synchronize()

    isz = 2
    nnz = lambda M: float((M != 0).sum())              # noqa: E731
    zp_bytes = (Mz.numel() + vm.numel() + R * N * Y * X) * isz
    zp_ops = 2.0 * nnz(Mz) * Y * X
    sl_bytes = (a.numel() + My.numel() + Mx.numel()) * isz \
        + Z * My.shape[1] * Mx.shape[1] * 4
    sl_ops = 2.0 * Z * (nnz(My) * X + My.shape[1] * nnz(Mx)) \
        + float(R) * Z * My.shape[1] * Mx.shape[1]
    zp_bound, zp_by = bound_ms(zp_bytes, zp_ops)
    sl_bound, sl_by = bound_ms(sl_bytes, sl_ops)
    times = {
        "zpass_banded": cuda_ms(lambda: lc.zpass(Mz, vm, wins), 20),
        "zpass_dense": cuda_ms(lambda: lc.zpass(Mz, vm, None), 20),
        "zpass_plain": cuda_ms(lambda: lc.zpass_reference(Mz, vm), 5),
        "zpass_library": cuda_ms(
            lambda: torch.matmul(Mz, vm.view(P, Y * X)), 20),
        "sl_rows": cuda_ms(lambda: lc.sl_rows(a, My, Mx), 20),
        "sl_rows_plain": cuda_ms(lambda: lc.fused_sl_reference(a, My, Mx),
                                 5),
    }
    result = {"phase": "kernels", "rank": R, "shape": [Z, Y, X],
              "rad_z": rad_z, "cases": cases, "times_ms": times,
              "zpass_bytes": zp_bytes, "zpass_ops": zp_ops,
              "sl_rows_bytes": sl_bytes, "sl_rows_ops": sl_ops,
              "sl_rows_dense_ops": 2.0 * R * Z * My.shape[1] * X
              * (Y + Mx.shape[1]),
              "bound_ms": {"zpass": zp_bound, "sl_rows": sl_bound}}
    emit(result)
    bad = [k for k, c in cases.items() if not c["ok"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    zp_err = max(cases[k]["max_abs_err"] for k in ("banded", "dense", "slab"))
    return {
        "zpass": {"name": "zpass", "route": "cuda",
                  "source": "spim_registration_tpu_torch/csrc/zpass.cu",
                  "replaces": "spim_registration_tpu/ops/pallas/"
                              "lowrank_conv.py:200 (_zpass_banded_kernel) "
                              "and :188 (_zpass_kernel)",
                  "max_abs_err": zp_err, "ms": times["zpass_banded"],
                  "dense_ms": times["zpass_dense"],
                  "plain_ms": times["zpass_plain"], "bound_ms": zp_bound,
                  "bound_by": zp_by, "library_ms": times["zpass_library"]},
        "sl_rows": {"name": "sl_rows", "route": "cuda",
                    "source": "spim_registration_tpu_torch/csrc/sl_rows.cu",
                    "replaces": "spim_registration_tpu/ops/pallas/"
                                "lowrank_conv.py:65 (_sl_rows_kernel)",
                    "max_abs_err": cases["sl_rows"]["max_abs_err"],
                    "ms": times["sl_rows"],
                    "plain_ms": times["sl_rows_plain"],
                    "bound_ms": sl_bound, "bound_by": sl_by,
                    "library_ms": None},
    }


def phase_rl(psfs, factors) -> tuple:
    """The main path at the bench configuration. Returns (kernel launch
    counts of one 20-iteration lowrank run, the staged lowrank runner)."""
    from spim_registration_tpu_torch.deconv import DeconvolutionRunner
    from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc

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
                # the main path's counted run: counts from 0 around it
                lc.zpass.launches = 0
                lc.sl_rows.launches = 0
            out, wall = sync_wall(runner.run)
            if backend == "lowrank" and rep == 0:
                counts = {"zpass": lc.zpass.launches,
                          "sl_rows": lc.sl_rows.launches}
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
    if counts != {"zpass": expected, "sl_rows": expected}:
        raise AssertionError(f"kernel launches {counts}, expected "
                             f"{expected} each")
    return counts, lowrank


def phase_profile(runner) -> None:
    """Device time by kernel over one main-path run (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    runner.run(num_iterations=2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = sync_wall(runner.run)
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_us = sum(r[1] for r in rows)
    emit({"phase": "profile", "wall_s": wall, "device_busy_s": busy_us / 1e6,
          "idle_share": 1.0 - busy_us / 1e6 / wall,
          "top": [{"name": k[:90], "device_ms": us / 1e3, "count": n,
                   "share": us / max(busy_us, 1e-9)}
                  for k, us, n in rows[:14]]})
    if busy_us <= 0:
        raise AssertionError("the profiler saw no device time")


def phase_pipeline() -> None:
    """Registered views -> PSFs -> prep -> fusion -> deconvolution through
    the public entry points (ground-truth registration: the registration
    stages are not ported yet)."""
    from spim_registration_tpu_torch.core.dataset import BoundingBox
    from spim_registration_tpu_torch.deconv import (
        DeconvolutionParameters,
        condition_psf,
        deconvolve,
        extract_psf,
        prepare_views_for_deconvolution,
    )
    from spim_registration_tpu_torch.fuse import FusionParameters, fuse_views
    from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc
    from spim_registration_tpu_torch.utils.simulation import (
        make_multiview_scene,
    )

    walls = {}
    t0 = time.perf_counter()
    scene = make_multiview_scene(
        np.random.default_rng(11), n_views=N_VIEWS, shape=SHAPE,
        n_beads=300, bead_sigma=0.8, noise=0.003,
        psf_sigmas=[(2.5, 1.0, 1.0), (1.0, 1.0, 2.5), (2.0, 1.2, 1.2),
                    (1.2, 1.2, 2.0)])
    walls["simulate_s"] = time.perf_counter() - t0
    lo, hi = (24, 24, 24), (232, 232, 232)       # 208^3: ragged tiles
    bbox = BoundingBox("b", lo, hi)

    def psfs_and_factors():
        psfs, factors, used = [], [], []
        for v in range(N_VIEWS):
            psf, n = extract_psf(scene.volumes[v], scene.models[v],
                                 scene.view_points[v], psf_shape=(13, 13, 13))
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
            scene.volumes, scene.models, psfs, bbox))
    prep.psf_factors = factors
    fused, walls["fuse_views_s"] = sync_wall(
        lambda: fuse_views(scene.volumes, scene.models, bbox,
                           FusionParameters()))
    lc.zpass.launches = 0
    lc.sl_rows.launches = 0
    deconv, walls["deconvolve_s"] = sync_wall(
        lambda: deconvolve(prep, DeconvolutionParameters(
            num_iterations=10, conv_backend="lowrank")))
    launches = {"zpass": lc.zpass.launches, "sl_rows": lc.sl_rows.launches}
    shape = tuple(h - l for l, h in zip(lo, hi))
    for name, vol in (("fused", fused), ("deconv", deconv)):
        if vol.shape != shape or not np.all(np.isfinite(vol)):
            raise AssertionError(f"{name}: bad output {vol.shape}")
    idx = np.round(scene.world_points).astype(int) - np.array(lo)
    idx = idx[np.all((idx >= 0) & (idx < np.array(shape)), axis=1)]
    pk_f = float(np.mean(fused[tuple(idx.T)]))
    pk_d = float(np.mean(deconv[tuple(idx.T)]))
    emit({"phase": "pipeline", "views": N_VIEWS, "scene": list(SHAPE),
          "bbox": [list(lo), list(hi)], "beads_used_for_psf": used,
          "walls": walls, "launches": launches,
          "peak_fused": pk_f, "peak_deconv": pk_d,
          "sharpening": pk_d / max(pk_f, 1e-12)})
    if not pk_d > 1.5 * pk_f:
        raise AssertionError(f"deconvolution did not sharpen: {pk_d} vs "
                             f"{pk_f}")
    if launches["zpass"] == 0 or launches["sl_rows"] == 0:
        raise AssertionError(f"deconvolve did not run the kernels: "
                             f"{launches}")


def phase_small_vs_cpu() -> None:
    """The card's lowrank RL (bf16 matrices through the kernels) against
    the port's plain CPU path on the same small input. Both round the
    same f32 sums to bf16 once; a flipped rounding compounds over
    iterations, hence the 2e-4 tolerance of the CPU parity tests."""
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
    emit({"phase": "small_vs_cpu", "shape": list(shape), "nrmse": nr,
          "tol": 2e-4})
    if not nr < 2e-4:
        raise AssertionError(f"card vs CPU nrmse {nr}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one "
              "NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import spim_registration_tpu_torch  # noqa: F401  (fails without the repo)

    # the CP-factor cache stays inside the checkout
    os.environ.setdefault("SPIM_FACTOR_CACHE_DIR",
                          str(ROOT / ".factor_cache"))
    from spim_registration_tpu_torch.utils.device import set_exact_float32

    set_exact_float32()
    smi = phase_card()
    phase_build()
    psfs, factors = load_fixtures()
    counts, runner = phase_rl(psfs, factors)
    phase_profile(runner)
    kernels = phase_kernels(runner)
    del runner
    torch.cuda.empty_cache()
    phase_pipeline()
    phase_small_vs_cpu()
    for name in ("zpass", "sl_rows"):
        kernels[name]["launches"] = counts[name]
    emit({"kernels": [kernels["zpass"], kernels["sl_rows"]]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
