#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Drives the port (`spim_registration_tpu_torch`, never JAX or the JAX
package) and exits nonzero on any failure:

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
   builds every CUDA kernel of `spim_registration_tpu_torch/csrc/` with
   nvcc, one process per source, all at once;
2. the deconvolution path: multi-view Richardson-Lucy at the bench
   configuration (4 views x 256^3, the committed fixture PSFs,
   efficient-Bayesian, sequential, 20 iterations) with the lowrank
   backend on the kernels and with the exact FFT backend; kernel launch
   counts over one lowrank run, throughput, the lowrank-vs-fft accuracy
   gate after 5 iterations and each engine's self-repeat; then a
   `torch.profiler` trace of one lowrank run: device time by kernel and
   the device's idle share;
3. kernels vs their plain PyTorch versions at the main path's shapes
   (256^3, the staged bf16 matrices of the fixture PSFs at their real
   ranks): the z pass banded, dense and at a z-slab offset, and the fused
   y/x rows pass; error, median time (CUDA events), plain time, one-call
   library time and the least time the card could take (bound);
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
   (Richardson-Lucy, detection).

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
# H100 SXM float32 rate outside the tensor cores (compares, adds)
PEAK_F32_OPS_PER_S = 67e12
N_VIEWS, N_ITER, SHAPE = 4, 20, (256, 256, 256)
DETECT_VIEWS, SEG, ROUNDS = 8, 512, 4
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


def _counters():
    from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc
    from spim_registration_tpu_torch.ops.kernels import segtopk as st

    return {"zpass": lc.zpass, "sl_rows": lc.sl_rows,
            "segtopk": st.segment_topk}


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
    if counts != {"zpass": expected, "sl_rows": expected, "segtopk": 0}:
        raise AssertionError(f"kernel launches {counts}, expected "
                             f"{expected} of zpass and sl_rows")
    return counts, lowrank


def device_profile(fn, top: int = 14) -> dict:
    """Device time by kernel and the device's idle share over one call of
    `fn` (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
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
    distinct values, so ties in every segment; all--inf segments);
    times and bound."""
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
        cases[name] = {
            "equal": [bool(torch.equal(a, b)) for a, b in zip(got, want)],
            "max_abs_err": float((got[0] - want[0]).abs().nan_to_num(
                0.0).max()),
            "finite_entries": int(torch.isfinite(tiles).sum()),
            "overflowing_segments": int((want[2] > ROUNDS).sum())}
    times = {"ms": cuda_ms(lambda: st.segment_topk(real, ROUNDS), 50),
             "plain_ms": cuda_ms(
                 lambda: st.segment_topk_reference(real, ROUNDS), 5),
             # values and indices only: no counts and no first-index rule
             "library_ms": cuda_ms(lambda: torch.topk(real, ROUNDS, dim=1),
                                   20),
             "dense_ms": cuda_ms(lambda: st.segment_topk(dense, ROUNDS), 50)}
    n_bytes = S * SEG * 4 + S * ROUNDS * 8 + S * 4
    n_ops = float(S * SEG * (ROUNDS + 1))   # compares: count + each round
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_OPS_PER_S * 1e3
    bound = max(t_bytes, t_ops)
    emit({"phase": "kernels", "kernel": "segtopk", "segments": S,
          "seg": SEG, "rounds": ROUNDS, "cases": cases, "times_ms": times,
          "bytes": n_bytes, "ops": n_ops, "bound_ms": bound,
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
            "ms": times["ms"], "plain_ms": times["plain_ms"],
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": times["library_ms"]}


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
    from spim_registration_tpu_torch.detect import DoGParameters
    from spim_registration_tpu_torch.fuse import FusionParameters, fuse_views
    from spim_registration_tpu_torch.match import PairwiseParameters
    from spim_registration_tpu_torch.pipeline import (
        RegistrationConfig,
        register_views,
    )
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

    cfg = RegistrationConfig(
        detection=DoGParameters(sigma=2.0, threshold=0.008),
        pairwise=PairwiseParameters(model="affine", max_points=512))
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
    vol = detection_volume()
    counts["segtopk"] = phase_detect(vol)
    torch.cuda.empty_cache()
    kernels["segtopk"] = phase_segtopk(vol)
    del vol
    torch.cuda.empty_cache()
    phase_match()
    torch.cuda.empty_cache()
    phase_pipeline()
    phase_small_vs_cpu()
    for name in ("zpass", "sl_rows", "segtopk"):
        kernels[name]["launches"] = counts[name]
    emit({"kernels": [kernels["zpass"], kernels["sl_rows"],
                      kernels["segtopk"]]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
