"""Multi-view Richardson-Lucy deconvolution engine.

Port of the reference's `deconv/lucy_richardson.py` (the "Efficient
Bayesian-based multi-view deconvolution" algorithm, Preibisch et al.,
Nat. Methods 2014):

    psi^0 = weighted average of the views (or constant)
    per iteration, per view v (sequential = OSEM ordering):
        conv1 = psi (x) P_v                      (kernel1)
        q     = img_v / conv1          (clamped)
        conv2 = q (x) K2_v                       (kernel2, PSFTYPE variant)
        psi  <- psi * (1 + osem * w_v * (conv2 - 1)),  clamped to minValue
    optional Tikhonov damping with lambda.

kernel2 variants ('.' = pointwise product on the common support, '(x)' =
convolution, * = coordinate mirror; renormalized to sum 1):
  INDEPENDENT         K2_v = P_v*
  EFFICIENT_BAYESIAN  K2_v = P_v* . prod_{w!=v} (P_v* (x) P_w (x) P_w*)
  OPTIMIZATION_I      K2_v = P_v* . prod_{w!=v} (P_v* (x) P_w)
  OPTIMIZATION_II     K2_v = P_v* . (P_v* (x) P_v)
(the reference module's docstring derives them).

Convolution backends:
- "fft": exact frequency-domain convolution on `torch.fft`;
- "lowrank": adaptive-rank CP form of each kernel as mirror-folded conv
  matrices (`ops/separable.py`), with a per-kernel exact-FFT fallback for
  kernels that miss `psf_rank_tol` even at the escalated rank cap. With
  `lowrank_fused` "auto" (on a CUDA device) or True, each conv runs
  through the hand-written CUDA kernels (`ops/kernels/lowrank_conv.py`);
  False selects the plain torch chain. bf16 matrices are dithered over
  `lowrank_dither_phases` quantization phases;
- "separable": per-rank pad+valid tap passes of the same CP form;
- any other string (the reference's documented "direct" included) runs
  the "fft" path, as in the reference; `ops.fftconv.direct_convolve` is
  a plain function that no engine calls.

The iteration and view loops are Python loops (the reference's
`fori_loop`/`scan`). The estimate psi is updated in place: each `run`
works on its own copy of the starting estimate.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from spim_registration_tpu_torch.ops.fftconv import (
    fft_convolve,
    pad_shape_for,
    prepare_kernel_fft,
)
from spim_registration_tpu_torch.ops.kernels.lowrank_conv import (
    conv_lowrank_folded_fused,
    operand_dtype,
)
from spim_registration_tpu_torch.ops.kernels.rl_update import (
    regularize_,
    rl_quotient,
    rl_quotient_reference,
    rl_update,
)
from spim_registration_tpu_torch.ops.separable import (
    conv_lowrank_folded,
    conv_separable_lowrank,
    decompose_for_rl,
    folded_conv_matrices,
)
from spim_registration_tpu_torch.utils.device import resolve_device
from spim_registration_tpu_torch.utils.profiling import (
    CONV,
    RECORDER,
    RL_RUN,
    UPDATE,
    PhaseTimer,
    profiler_active,
    span,
)

# the engine's span of a phase, iteration or view while tracing is off
_OFF = contextlib.nullcontext()

PSFType = str  # "independent" | "efficient_bayesian" | "optimization_i" | "optimization_ii"


@dataclasses.dataclass(frozen=True)
class DeconvolutionParameters:
    num_iterations: int = 10
    psf_type: PSFType = "efficient_bayesian"
    osem_factor: Optional[float] = None   # None -> from prep (overlap count)
    tikhonov_lambda: float = 0.0006       # reference default lambda
    min_value: float = 0.0001             # psi floor (x avg intensity)
    init: str = "average"                 # "average" | "constant"
    debug_interval: int = 0               # if >0, collect psi every k iters
    # "sequential": OSEM ordering, one view after another. "parallel":
    # simultaneous multi-view RL, update factor 1 + sum_v w_v (conv2_v - 1)
    scheme: str = "sequential"
    # "fft" | "lowrank" | "separable"; any other string runs "fft"
    # (module docstring)
    conv_backend: str = "fft"
    psf_rank: int = 16
    psf_rank_max_error: float = 0.05
    psf_rank_tol: float = 5e-4
    # if `psf_rank_tol` is not met at `psf_rank`, decomposition grows up to
    # `psf_rank_hard` (None -> 2*psf_rank); a kernel that still misses the
    # tolerance runs on the exact FFT path (that kernel only)
    psf_rank_hard: Optional[int] = None
    # matmul storage dtype of the lowrank backend
    lowrank_dtype: str = "bfloat16"
    # bf16 rounding dithered over this many per-view-update phases so the
    # time-averaged effective kernel is unbiased
    lowrank_dither_phases: int = 4
    # "auto": the CUDA kernels on a CUDA device, the plain torch chain on
    # the CPU; True: the kernels' wrappers (their plain versions on the
    # CPU); False: the plain torch chain
    lowrank_fused: object = "auto"


def resolve_lowrank_fused(flag, device: torch.device) -> bool:
    """Resolve the "auto" value of `lowrank_fused` for a device."""
    if flag != "auto":
        return bool(flag)
    return torch.device(device).type == "cuda"


def _mirror(k: np.ndarray) -> np.ndarray:
    return k[::-1, ::-1, ::-1].copy()


def _bf16_dither_stack(M: np.ndarray, phases: int) -> np.ndarray:
    """(phases, ...) bf16-bound variants of M whose rounding errors
    average to ~zero: phase p adds ((p+0.5)/phases - 0.5) * ULP_bf16(M)
    before the round-to-nearest cast (dithered quantization)."""
    x = np.asarray(M, np.float64)
    mag = np.abs(x)
    # bf16: 7 explicit mantissa bits -> ULP = 2^(exponent - 7)
    ulp = np.where(mag > 0,
                   np.exp2(np.floor(np.log2(np.maximum(mag, 1e-300))) - 7),
                   0.0)
    ds = (np.arange(phases) + 0.5) / phases - 0.5
    return np.stack([x + d * ulp for d in ds]).astype(np.float32)


def _folded_matrix_banks(kernels: Sequence[np.ndarray], img_shape,
                         rank: int, adapt_tol: float,
                         dtype: torch.dtype, dither_phases: int = 1,
                         rank_hard: Optional[int] = None,
                         factors: Optional[Sequence] = None,
                         device=None):
    """Per-view lowrank-backend kernel entries.

    Each entry is a dict:
      {"mat": (Mz, My, Mx), "rad": (rz, ry, rx)} — the mirror-folded
        conv-matrix triple, each (phases, R, n, n) with a leading
        quantization-phase axis (size 1 when dithering is off or dtype
        is float32), and the per-axis band half-supports; or
      {"kernel": k} — this kernel missed `adapt_tol` even at the
        escalated rank cap; the runner turns it into an exact-FFT entry
        ({"fft": spectrum}).

    Ranks adapt per kernel (views are not padded to a common rank).
    `factors`: optional per-kernel exact CP factor banks. Returns
    (entries, rel_errs)."""
    phases = dither_phases if dtype == torch.bfloat16 else 1
    phases = max(int(phases), 1)
    out, errs = [], []
    for i, k in enumerate(kernels):
        fac = factors[i] if factors is not None else None
        with span("spim/deconv.decompose"):
            az, ay, ax, err = decompose_for_rl(
                np.asarray(k, np.float64), rank, max_error=float("inf"),
                adapt_tol=adapt_tol, rank_hard=rank_hard, factors=fac)
            errs.append(float(err))
            if err > adapt_tol:
                out.append({"kernel": np.asarray(k, np.float32)})
                continue
            mats = folded_conv_matrices(az, ay, ax, img_shape,
                                        dtype=np.float64)
            triple = []
            for M in mats:
                stack = (_bf16_dither_stack(M, phases) if phases > 1
                         else np.asarray(M, np.float32)[None])
                triple.append(torch.from_numpy(stack).to(device).to(dtype))
        rads = tuple((f.shape[1] - 1) // 2 for f in (az, ay, ax))
        out.append({"mat": tuple(triple), "rad": rads})
    return out, errs


def _stack_factor_banks(kernels: Sequence[np.ndarray], rank: int,
                        max_error: float, device=None):
    """Per-view CP factor banks (az, ay, ax), padded with zeros (centred)
    to common tap counts and ranks so they stack along the view axis."""
    banks = []
    for k in kernels:
        with span("spim/deconv.decompose"):
            banks.append(decompose_for_rl(np.asarray(k, np.float64), rank,
                                          max_error))
    rmax = max(b[0].shape[0] for b in banks)
    out = []
    for d in range(3):
        taps = max(b[d].shape[1] for b in banks)
        padded = []
        for b in banks:
            arr = b[d]
            pad = taps - arr.shape[1]
            lo = pad // 2
            padded.append(np.pad(arr, ((0, rmax - arr.shape[0]),
                                       (lo, pad - lo))))
        out.append(torch.as_tensor(np.stack(padded), dtype=torch.float32,
                                   device=device))
    return tuple(out)


def _np_conv_same(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Convolution of two small kernels, cropped to a.shape (centred)."""
    import numpy.fft as fft

    shape = tuple(sa + sb - 1 for sa, sb in zip(a.shape, b.shape))
    axes = (0, 1, 2)
    full = fft.irfftn(fft.rfftn(a, shape, axes) * fft.rfftn(b, shape, axes),
                      shape, axes)
    sl = tuple(slice((f - s) // 2, (f - s) // 2 + s)
               for f, s in zip(shape, a.shape))
    return full[sl]


def compound_kernels(psfs: Sequence[np.ndarray], psf_type: PSFType
                     ) -> List[np.ndarray]:
    """Build kernel2 for each view per the PSFTYPE ladder (module
    docstring). All pointwise-product terms are evaluated on P_v's
    support."""
    psfs = [np.asarray(p, np.float64) for p in psfs]
    out = []
    for v, p in enumerate(psfs):
        pvm = _mirror(p)
        k2 = pvm.copy()
        if psf_type == "independent":
            pass
        elif psf_type == "efficient_bayesian":
            for w, pw in enumerate(psfs):
                if w == v:
                    continue
                term = _np_conv_same(_np_conv_same(pvm, pw), _mirror(pw))
                k2 = k2 * np.maximum(term, 0.0)
        elif psf_type == "optimization_i":
            for w, pw in enumerate(psfs):
                if w == v:
                    continue
                term = _np_conv_same(pvm, pw)
                k2 = k2 * np.maximum(term, 0.0)
        elif psf_type == "optimization_ii":
            term = _np_conv_same(pvm, p)
            k2 = k2 * np.maximum(term, 0.0)
        else:
            raise ValueError(f"unknown psf_type {psf_type!r}")
        k2 = np.maximum(k2, 0.0)
        out.append((k2 / k2.sum()).astype(np.float32))
    return out


def _rl_iterate(psi, images, weights, k1, k2, osem, lam, min_value,
                num_iterations, fft_shape, scheme="sequential",
                conv_backend="fft", lowrank_fused=False, phases=None):
    """Run `num_iterations` RL iterations, updating `psi` IN PLACE.

    k1 / k2: per-view kernels — stacked spectra (V, ...) for the fft
    backend, (az, ay, ax) stacked factor banks for the separable backend,
    per-view entry dicts for the lowrank backend.

    In the sequential scheme the elementwise work around the convolutions
    runs through `ops/kernels/rl_update.py`: the quotient and the
    estimate's update, each one kernel on CUDA tensors (their plain chain
    on the CPU). Where a convolution runs on the lowrank kernels with bf16
    matrices, its operand (the quotient, the estimate after the previous
    view) is written in bf16 by the pass that computes it; the first view
    of a run casts inside its convolution. The parallel scheme runs the
    plain chain.

    `phases`: None, or a `utils.profiling.PhaseTimer` that opens the
    iteration and view spans and takes a lap after each phase of a view
    update: `conv`, each call into a convolution; `update`, the rest (the
    quotient, `q - 1`, the estimate's update and regularization)."""
    if scheme not in ("sequential", "parallel"):
        raise ValueError(f"unknown RL scheme {scheme!r}")
    V = images.shape[0]
    lowrank = conv_backend == "lowrank"

    def fft_conv(x, kfft):
        return fft_convolve(x, None, kernel_fft=kfft, fft_shape=fft_shape,
                            boundary="mirror")

    sequential = scheme == "sequential"
    quotient = rl_quotient if sequential else rl_quotient_reference

    def bf16_operand(entry):
        # the pass that computes a bf16 operand of the lowrank kernels
        # writes it so (sequential scheme)
        return (sequential and lowrank and lowrank_fused
                and operand_dtype(entry) == torch.bfloat16)

    if lowrank:
        mats = [e["mat"] for e in list(k1) + list(k2) if "mat" in e]
        n_phases = mats[0][0].shape[0] if mats else 1

        def conv(x, entry, step):
            if "mat" not in entry:
                return fft_conv(x, entry["fft"])
            mz, my, mx = (M[step % n_phases] for M in entry["mat"])
            if lowrank_fused:
                return conv_lowrank_folded_fused(x, mz, my, mx, *entry["rad"])
            return conv_lowrank_folded(x, mz, my, mx)
    elif conv_backend == "separable":
        k1, k2 = ([tuple(b[v] for b in bank) for v in range(V)]
                  for bank in (k1, k2))

        def conv(x, factors, step):
            return conv_separable_lowrank(x, *factors)
    else:
        def conv(x, kfft, step):
            return fft_conv(x, kfft)

    def view_conv2(x, v, step):
        """(x (x) K1 -> quotient) (x) K2, and whether it is in DELTA form
        (the quotient less 1)."""
        conv1 = conv(x, k1[v], step)
        if phases is not None:
            phases.lap(CONV)
        # on the matmul path in DELTA form K2 (x) (q - 1): equal for a
        # mass-1 kernel, but it cancels the bf16 matrices' row-sum
        # rounding and rounds the small field q - 1
        delta = lowrank and "mat" in k2[v]
        q = quotient(images[v], conv1, delta, bf16_operand(k2[v]))
        if phases is not None:
            phases.lap(UPDATE)
        conv2 = conv(q, k2[v], step)
        if phases is not None:
            phases.lap(CONV)
        return conv2, delta

    # the parallel scheme's sum starts at 1 on the lowrank path (the
    # others add 1 to the sum of the views' terms)
    acc0 = (torch.ones((), dtype=psi.dtype, device=psi.device)
            if lowrank and not sequential else None)
    # the operand of the next conv of psi: psi, or its bf16 copy
    x = psi
    # lowrank phase schedule (i + v): the phase advances across
    # iterations for every view
    for i in range(num_iterations):
        with _OFF if phases is None else phases.iteration():
            if sequential:
                for v in range(V):
                    with _OFF if phases is None else phases.view():
                        conv2, delta = view_conv2(x, v, i + v)
                        last = i == num_iterations - 1 and v == V - 1
                        x = rl_update(psi, conv2, weights[v], osem, lam,
                                      min_value, delta, not last and
                                      bf16_operand(k1[(v + 1) % V]))
                        if phases is not None:
                            phases.lap(UPDATE)
            else:
                acc = acc0
                for v in range(V):
                    with _OFF if phases is None else phases.view():
                        conv2, delta = view_conv2(psi, v, i + v)
                        t = weights[v] * (conv2 if delta else conv2 - 1.0)
                        acc = t if acc is None else acc + t
                        if phases is not None:
                            phases.lap(UPDATE)
                regularize_(psi.mul_(acc if lowrank else 1.0 + acc), lam,
                            min_value)
                if phases is not None:
                    phases.lap(UPDATE)
    return psi


class DeconvolutionRunner:
    """Stages all inputs on the device ONCE; `.run()` executes RL
    iterations. `device`: default CUDA; "cpu" runs on the host."""

    def __init__(self, prep,
                 params: DeconvolutionParameters = DeconvolutionParameters(),
                 device=None):
        with span("spim/deconv.stage"):
            self._stage(prep, params, device)

    def _stage(self, prep, params: DeconvolutionParameters, device) -> None:
        self.device = dev = resolve_device(device)
        self.params = params
        self.images = torch.as_tensor(prep.images, dtype=torch.float32,
                                      device=dev)
        self.weights = torch.as_tensor(prep.weights, dtype=torch.float32,
                                       device=dev)
        self.img_shape = tuple(self.images.shape[1:])

        with span("spim/deconv.compound"):
            k2s = compound_kernels(prep.psfs, params.psf_type)
        if params.conv_backend == "separable":
            self.fft_shape = None
            self.k1_ffts = _stack_factor_banks(
                prep.psfs, params.psf_rank, params.psf_rank_max_error, dev)
            self.k2_ffts = _stack_factor_banks(
                k2s, params.psf_rank, params.psf_rank_max_error, dev)
        elif params.conv_backend == "lowrank":
            dt = (torch.bfloat16 if params.lowrank_dtype == "bfloat16"
                  else torch.float32)
            factors = getattr(prep, "psf_factors", None)
            common = dict(dither_phases=params.lowrank_dither_phases,
                          rank_hard=params.psf_rank_hard, device=dev)
            k1_entries, self.lowrank_errs_k1 = _folded_matrix_banks(
                prep.psfs, self.img_shape, params.psf_rank,
                params.psf_rank_tol, dt, factors=factors, **common)
            k2_entries, self.lowrank_errs_k2 = _folded_matrix_banks(
                k2s, self.img_shape, params.psf_rank,
                params.psf_rank_tol, dt, **common)
            # kernels that missed the tolerance even at the escalated
            # rank cap run on the exact FFT path (per-kernel mix)
            fb = [e["kernel"] for e in k1_entries + k2_entries
                  if "kernel" in e]
            self.fft_shape = None
            if fb:
                max_k = tuple(max(k.shape[d] for k in fb) for d in range(3))
                self.fft_shape = pad_shape_for(self.img_shape, max_k)
                for entries in (k1_entries, k2_entries):
                    for i, e in enumerate(entries):
                        if "kernel" in e:
                            entries[i] = {"fft": prepare_kernel_fft(
                                torch.as_tensor(e["kernel"], device=dev),
                                self.fft_shape)}
            self.k1_ffts = tuple(k1_entries)
            self.k2_ffts = tuple(k2_entries)
        else:
            # "fft", and as in the reference any other string ("direct",
            # which no engine implements, included): the exact FFT path
            max_k = tuple(max(max(p.shape[d] for p in prep.psfs),
                              max(k.shape[d] for k in k2s))
                          for d in range(3))
            self.fft_shape = pad_shape_for(self.img_shape, max_k)
            self.k1_ffts = torch.stack([
                prepare_kernel_fft(torch.as_tensor(p, dtype=torch.float32,
                                                   device=dev),
                                   self.fft_shape) for p in prep.psfs])
            self.k2_ffts = torch.stack([
                prepare_kernel_fft(torch.as_tensor(k, dtype=torch.float32,
                                                   device=dev),
                                   self.fft_shape) for k in k2s])

        iw = self.images * self.weights
        wsum = self.weights.sum(dim=0)
        avg = float(iw.sum() / torch.clamp(wsum.sum(), min=1e-9))
        if params.init == "average":
            psi0 = iw.sum(dim=0)
            psi0 = torch.where(wsum > 1e-9,
                               psi0 / torch.clamp(wsum, min=1e-9),
                               torch.full((), avg, device=dev))
        else:
            psi0 = torch.full(self.img_shape, avg, dtype=torch.float32,
                              device=dev)
        del iw
        self.psi0 = torch.clamp(psi0, min=params.min_value * avg)
        self.avg = avg
        self.osem = (params.osem_factor if params.osem_factor is not None
                     else prep.osem_factor)
        self.lam = (params.tikhonov_lambda
                    if params.tikhonov_lambda > 0 else None)

    def run(self, num_iterations: Optional[int] = None, psi0=None
            ) -> torch.Tensor:
        """Execute RL iterations on the device; returns the estimate as a
        tensor (a new one: `psi0` and the staged start are not changed)."""
        n = (num_iterations if num_iterations is not None
             else self.params.num_iterations)
        start = self.psi0 if psi0 is None else torch.as_tensor(
            psi0, dtype=torch.float32, device=self.device)

        def iterate(phases=None):
            return _rl_iterate(
                start.clone(), self.images, self.weights, self.k1_ffts,
                self.k2_ffts, float(np.float32(self.osem)), self.lam,
                float(np.float32(self.params.min_value * self.avg)),
                n, self.fft_shape, scheme=self.params.scheme,
                conv_backend=self.params.conv_backend,
                lowrank_fused=resolve_lowrank_fused(
                    self.params.lowrank_fused, self.device),
                phases=phases)

        if not profiler_active():
            return iterate()
        # traced: the run's spans, and its phases timed in stream order
        with span(RL_RUN, run_id=RECORDER.new_run_id()) as s:
            phases = PhaseTimer(self.device, s.run_id)
            try:
                return iterate(phases)
            finally:
                phases.close()

    def run_checkpointed(self, checkpoint_every: int,
                         checkpoint_fn=None,
                         num_iterations: Optional[int] = None,
                         psi0=None) -> torch.Tensor:
        """Run in segments of `checkpoint_every` iterations, invoking
        `checkpoint_fn(iteration, psi_ndarray)` after each segment (pass a
        restored array back as `psi0` to resume). As in the reference,
        each segment restarts the dither phase schedule."""
        n = (num_iterations if num_iterations is not None
             else self.params.num_iterations)
        psi = self.psi0 if psi0 is None else psi0
        done = 0
        while done < n:
            step = min(checkpoint_every, n - done)
            psi = self.run(num_iterations=step, psi0=psi)
            done += step
            if checkpoint_fn is not None:
                checkpoint_fn(done, psi.cpu().numpy())
        return psi


def deconvolve(prep, params: DeconvolutionParameters = DeconvolutionParameters(),
               device=None) -> np.ndarray:
    """Run multi-view RL on prepared views (`DeconvolutionViews`).

    Returns the deconvolved volume (Z, Y, X) float32 on the host."""
    return DeconvolutionRunner(prep, params, device).run().cpu().numpy()
