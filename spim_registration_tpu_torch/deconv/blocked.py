"""Out-of-core (blocked) multi-view Richardson-Lucy deconvolution.

Port of the reference's `deconv/blocked.py` (`Block` /
`BlockGeneratorFixedSizePrecise` and `LRFFT`'s block loop): volumes larger
than device memory are deconvolved by streaming z-slab blocks between
disk and the card. Per view-update, each block reads the CURRENT psi with
a halo of the full compound support (r1 + r2, re-read as the reference
re-reads source halos per conv), computes the update for its interior and
writes it back, so the blocked result equals the in-memory engine
(seam-free).

Per iteration, for each view v (OSEM-sequential): for each block, read
psi(block + r1 + r2), img_v(block + r2) and w_v(block), run the update on
the device (two convolutions, the quotient `rl_quotient` and the
multiplicative update `rl_update` of `ops/kernels/rl_update.py`: a kernel
each on a card, their plain versions on the CPU), write psi(block). Each
view-update ping-pongs between the psi store and a scratch store: every
block of a view's update must read the pre-update psi. The psi store
doubles as the checkpoint: a run resumes from the last completed
iteration (`init_psi=False`).

Convolutions:
- "fft": overlap-save in z (valid interior rows), mirror in y/x, on
  `torch.fft` at block-sized FFT shapes;
- "lowrank": the CP form of each kernel as a (R, n_out, n_out + 2 rz) z
  band matrix over the re-read halo rows and the full-axis mirror-folded
  y/x matrices. Each block conv goes through
  `conv_lowrank_folded_fused`: on the card it launches the hand-written
  kernels `zpass` (z band windows centred at rz) and `sl_rows` (y/x band
  windows) and raises where they cannot run; on the CPU the same calls
  take the kernels' plain versions. The route follows the device alone,
  as the reference's follows the platform (`lowrank_fused` is the
  in-memory engine's switch). Kernels that miss `psf_rank_tol` run the
  exact FFT path (per-kernel mix), bf16 matrices dither over the phase
  schedule step = iteration + view, and conv2 runs in delta form, its
  operand written in bf16 by the quotient's pass where it reads bf16
  matrices, as in the in-memory engine.

With a `mesh` (`parallel.Mesh`), block k of each view-update runs on
mesh position k % mesh.size (the reference's `_view_update_meshed` runs
groups of `mesh.size` blocks as one sharded program): every block of a
view-update reads the pre-update psi, so the blocks are independent and
the result is the single-device loop's. The loop is the same one, with
the same write-back pipeline; only each block's device changes. A mesh
that spans processes is refused (ValueError): the reference's engine
cannot run one either (its `_view_update_meshed` reads the group's
output back on the host, which a jax.Array on another process's devices
refuses), and the stores of one engine are read and written by one
process.

Stores: anything with `.shape`, `.read_block(lo, hi)`,
`.write_block(lo, arr)` — `native_blocks.RawVolumeStore` (threaded
pread/pwrite) or the in-memory `ArrayStore` below.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from spim_registration_tpu_torch.deconv.lucy_richardson import (
    DeconvolutionParameters,
    _bf16_dither_stack,
    compound_kernels,
)
from spim_registration_tpu_torch.native_blocks import (
    RawVolumeStore,
    read_mirror_z,
)
from spim_registration_tpu_torch.ops.fftconv import (
    fft_shape_for,
    overlap_save_convolve,
    prepare_kernel_fft,
)
from spim_registration_tpu_torch.ops.kernels.lowrank_conv import (
    conv_lowrank_folded_fused,
    operand_dtype,
)
from spim_registration_tpu_torch.ops.kernels.rl_update import (
    rl_quotient,
    rl_update,
)
from spim_registration_tpu_torch.ops.separable import (
    decompose_for_rl,
    folded_conv_matrices,
)
from spim_registration_tpu_torch.utils.device import on_device, resolve_device


class ArrayStore:
    """In-memory store with the block-store interface (tests / staging)."""

    def __init__(self, array: np.ndarray):
        self.array = np.asarray(array, np.float32)
        self.shape = tuple(self.array.shape)

    def read_block(self, lo, hi) -> np.ndarray:
        sl = tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))
        return np.array(self.array[sl])

    def write_block(self, lo, data: np.ndarray) -> None:
        sl = tuple(slice(int(a), int(a) + s)
                   for a, s in zip(lo, data.shape))
        self.array[sl] = data


def _mirror_q_edges(q: torch.Tensor, z_lo: int, z_true: int) -> torch.Tensor:
    """Re-pin quotient rows outside the true volume to the mirror of the
    interior quotient: the in-memory engine mirror-pads q itself before
    conv2, while a block near the global edge computes q on mirror-read
    inputs — not the same for asymmetric kernels. Exact edge parity needs
    q[Z+d] := q[Z-2-d] (and q[-d] := q[d]); sources lie inside the block.
    `z_lo` is the global row of q[0]. Changes `q` in place."""
    n = q.shape[0]
    g = np.arange(z_lo, z_lo + n)
    outside = np.nonzero((g < 0) | (g > z_true - 1))[0]
    if outside.size == 0:
        return q
    src = np.abs(g[outside])
    src = np.where(src > z_true - 1, 2 * (z_true - 1) - src, src)
    li = np.clip(src - z_lo, 0, n - 1)
    dev = q.device
    q[torch.as_tensor(outside, device=dev)] = q[torch.as_tensor(li,
                                                                device=dev)]
    return q


def _z_band_matrices(az: np.ndarray, n_out: int) -> np.ndarray:
    """(R, n_out, n_out + taps - 1) Toeplitz z band matrices: row i gives
    out[i] = sum_j flip(az_r)[j] * x[i + j] over a block's halo-extended
    rows (a copy of the reference's `parallel.sharded._z_band_matrices`).
    No mirror is folded in: the halo rows re-read from the store are the
    true neighbours, and the global edges are mirror-read."""
    bank = np.asarray(az, np.float64)[:, ::-1]  # flip: true convolution
    R, taps = bank.shape
    T = np.zeros((R, n_out, n_out + taps - 1), np.float64)
    for i in range(n_out):
        T[:, i, i:i + taps] = bank
    return T


def _decompose(k, params, factors=None):
    """`decompose_for_rl` at the RL engines' rank policy (adaptive rank up
    to the escalated cap, no error limit): (az, ay, ax, rel_err)."""
    return decompose_for_rl(
        np.asarray(k, np.float64), params.psf_rank,
        max_error=float("inf"), adapt_tol=params.psf_rank_tol,
        rank_hard=params.psf_rank_hard, factors=factors)


def _stage_matrices(az, ay, ax, n_out: int, yx, params, device=None):
    """(Tz, My, Mx) for one kernel's CP factors: Tz the (R, n_out,
    n_out + taps - 1) z band matrix over halo-extended rows, My/Mx the
    full-axis mirror-folded matrices, each with a leading dither-phase
    axis, in the matrix dtype on `device`."""
    dt = torch.bfloat16 if params.lowrank_dtype == "bfloat16" \
        else torch.float32
    phases = params.lowrank_dither_phases if dt == torch.bfloat16 else 1
    phases = max(int(phases), 1)
    _, My, Mx = folded_conv_matrices(az, ay, ax, (1,) + tuple(yx),
                                     dtype=np.float64)
    triple = []
    for M in (_z_band_matrices(az, n_out), My, Mx):
        stack = (_bf16_dither_stack(M, phases) if phases > 1
                 else np.asarray(M, np.float32)[None])
        triple.append(torch.from_numpy(stack).to(device).to(dt))
    return tuple(triple)


def _lowrank_stage_entries(kernels, n_out: int, yx, params, factors=None,
                           device=None):
    """Per-kernel lowrank entries for ONE conv stage of the blocked loop:
    {"mat": (Tz, My, Mx), "rad": (rz, ry, rx)} (`_stage_matrices`) — or
    None for kernels that miss `psf_rank_tol` at the escalated cap (the
    caller gives those the exact per-block FFT path). The z-sharded RL
    engine (`parallel/sharded.py`) stages its shard convs here too.
    Returns (entries, rel_errs, z_tap_radii)."""
    entries, errs, radii = [], [], []
    for i, k in enumerate(kernels):
        fac = factors[i] if factors is not None else None
        az, ay, ax, err = _decompose(k, params, fac)
        errs.append(float(err))
        if err > params.psf_rank_tol:
            entries.append(None)
            radii.append(0)
            continue
        rads = tuple((f.shape[1] - 1) // 2 for f in (az, ay, ax))
        entries.append({"mat": _stage_matrices(az, ay, ax, n_out, yx,
                                               params, device),
                        "rad": rads})
        radii.append(rads[0])
    return entries, errs, radii


def _entry_to(entry: dict, dev: torch.device) -> dict:
    """A kernel entry's tensors copied to `dev`."""
    return {k: (tuple(t.to(dev) for t in val) if k == "mat"
                else val.to(dev) if k == "fft" else val)
            for k, val in entry.items()}


@dataclasses.dataclass
class BlockedDeconvolutionInputs:
    """Disk-resident inputs: per-view image/weight stores on the bbox
    grid (the streamed analog of `DeconvolutionViews`)."""

    image_stores: Sequence
    weight_stores: Sequence
    psfs: List[np.ndarray]
    osem_factor: float
    # optional exact CP factors per PSF (condition_psf / fixtures): they
    # make the lowrank conv exact by construction
    psf_factors: Optional[Sequence] = None


class _WriteBack:
    """The two-block write-back pipeline: block k's result is copied to
    the host (into a pinned buffer, asynchronously, on a card) as soon as
    its update is queued, and written to the store only after block k+1's
    update is queued, so disk reads and writes overlap the device's
    work. At most two blocks are in flight."""

    def __init__(self, device: torch.device, block_shape):
        self.cuda = device.type == "cuda"
        self.bufs = ([torch.empty(block_shape, dtype=torch.float32,
                                  pin_memory=True) for _ in range(2)]
                     if self.cuda else None)
        self.pending = []
        self.slot = 0

    def push(self, store, lo, out: torch.Tensor) -> None:
        if self.cuda:
            buf = self.bufs[self.slot]
            self.slot ^= 1
            buf.copy_(out, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self.pending.append((store, lo, buf, ev))
        else:
            self.pending.append((store, lo, out, None))
        if len(self.pending) > 1:
            self._write(*self.pending.pop(0))

    def flush(self) -> None:
        while self.pending:
            self._write(*self.pending.pop(0))

    @staticmethod
    def _write(store, lo, t: torch.Tensor, ev) -> None:
        if ev is not None:
            ev.synchronize()
        store.write_block(lo, t.numpy())


class BlockedDeconvolutionRunner:
    """RL deconvolution for volumes that do not fit in device memory.

    psi lives in `psi_store` (disk); each (view, block) update streams
    through the device. Matches `DeconvolutionRunner` seam-free and
    edge-exact for both conv backends, "fft" and "lowrank" (module
    docstring). `device`: default CUDA; "cpu" runs on the host. `mesh`:
    block k runs on position k % mesh.size, whatever the mesh's axes
    (module docstring; its devices replace `device`)."""

    def __init__(self, inputs: BlockedDeconvolutionInputs, psi_store,
                 params: DeconvolutionParameters = DeconvolutionParameters(),
                 block_z: Optional[int] = None, scratch_store=None,
                 device=None, mesh=None):
        if params.conv_backend not in ("fft", "lowrank"):
            raise ValueError("blocked deconvolution supports "
                             "conv_backend 'fft' or 'lowrank'; got "
                             + params.conv_backend)
        if params.scheme != "sequential":
            raise ValueError("blocked deconvolution is OSEM-sequential")
        if mesh is not None and mesh.spans_processes:
            raise ValueError(
                "the blocked engine runs on one process: its stores are "
                "read and written by the process that runs it, so a mesh "
                "that spans processes is not supported")
        # block k runs on self._devices[k % len(self._devices)]
        self._devices = ([resolve_device(device)] if mesh is None
                         else list(mesh.devices.flat))
        self.device = dev = self._devices[0]
        self.inputs = inputs
        self.params = params
        self.psi_store = psi_store
        self.shape = tuple(psi_store.shape)
        Z, Y, X = self.shape

        k2s = compound_kernels(inputs.psfs, params.psf_type)
        self.r1 = [tuple(s // 2 for s in np.shape(p)) for p in inputs.psfs]
        self.r2 = [tuple(s // 2 for s in np.shape(k)) for k in k2s]
        # common halo/crop radii: the stage-1 crop (hz - r2z) must cover
        # every view's k1 z-radius, so hz = max(r1) + max(r2), not
        # max(r1 + r2)
        self.r1z = max(a[0] for a in self.r1)
        self.r2z = max(b[0] for b in self.r2)
        self.hz = self.r1z + self.r2z

        if block_z is None:
            block_z = max(self.hz * 2, Z // 8)
            while Z % block_z:
                block_z += 1
        if Z % block_z:
            raise ValueError(f"block_z={block_z} must divide Z={Z}")
        self.bz = int(block_z)

        # per-view entries: {"fft": spectrum at the block conv's FFT
        # shape} or {"mat": ...}; spectra are made only where a kernel
        # runs on the FFT path
        self.fs1 = [fft_shape_for((self.bz + 2 * self.hz, Y + 2 * r[1],
                                   X + 2 * r[2])) for r in self.r1]
        self.fs2 = [fft_shape_for((self.bz + 2 * self.r2z, Y + 2 * r[1],
                                   X + 2 * r[2])) for r in self.r2]

        def spectrum(k, fshape):
            return {"fft": prepare_kernel_fft(torch.as_tensor(
                np.asarray(k, np.float32), device=dev), fshape)}

        V = len(inputs.psfs)
        self.backend = params.conv_backend
        self.t1 = self.t2 = [0] * V
        if self.backend == "lowrank":
            n1 = self.bz + 2 * self.r2z  # stage-1 (conv1) output rows
            self.e1, self.lowrank_errs_k1, rad1 = _lowrank_stage_entries(
                inputs.psfs, n1, (Y, X), params,
                factors=getattr(inputs, "psf_factors", None), device=dev)
            self.e2, self.lowrank_errs_k2, rad2 = _lowrank_stage_entries(
                k2s, self.bz, (Y, X), params, device=dev)
            self.t1 = [self.r1z - r for r in rad1]
            self.t2 = [self.r2z - r for r in rad2]
        else:
            self.e1 = [None] * V
            self.e2 = [None] * V
        for v in range(V):  # fft backend, or missed tol: exact FFT path
            if self.e1[v] is None:
                self.e1[v] = spectrum(inputs.psfs[v], self.fs1[v])
            if self.e2[v] is None:
                self.e2[v] = spectrum(k2s[v], self.fs2[v])

        # the entries on every device the blocks run on
        self._entries = {dev: (self.e1, self.e2)}
        for d in self._devices:
            if d not in self._entries:
                self._entries[d] = tuple([_entry_to(e, d) for e in es]
                                         for es in (self.e1, self.e2))

        self.osem = (params.osem_factor if params.osem_factor is not None
                     else inputs.osem_factor)
        # `rl_update`'s form: float32-rounded, None where off
        self.lam = (float(np.float32(params.tikhonov_lambda))
                    if params.tikhonov_lambda > 0 else None)
        self.avg = None  # set by initialize_psi / resume
        self.scratch_store = (scratch_store if scratch_store is not None
                              else self._make_scratch(psi_store))

    @staticmethod
    def _make_scratch(psi_store):
        """A second store of the same kind for the view-update ping-pong."""
        if isinstance(psi_store, ArrayStore):
            return ArrayStore(np.zeros(psi_store.shape, np.float32))
        if isinstance(psi_store, RawVolumeStore):
            return RawVolumeStore(psi_store.path + ".scratch",
                                  psi_store.shape, create=True)
        raise ValueError(
            "pass scratch_store= explicitly for custom store types")

    # ------------------------------------------------------------------
    def _blocks(self):
        Z, Y, X = self.shape
        return [((z0, 0, 0), (z0 + self.bz, Y, X))
                for z0 in range(0, Z, self.bz)]

    def _global_average(self) -> float:
        s_wi = s_w = 0.0
        for lo, hi in self._blocks():
            for img_s, w_s in zip(self.inputs.image_stores,
                                  self.inputs.weight_stores):
                img = img_s.read_block(lo, hi)
                w = w_s.read_block(lo, hi)
                s_wi += float((img * w).sum())
                s_w += float(w.sum())
        return s_wi / max(s_w, 1e-9)

    def initialize_psi(self) -> float:
        """Two streaming passes: global average, then psi0 blocks."""
        avg = self._global_average()
        floor = self.params.min_value * avg
        for lo, hi in self._blocks():
            shape = tuple(h - l for l, h in zip(lo, hi))
            if self.params.init == "average":
                acc = np.zeros(shape, np.float32)
                wsum = np.zeros(shape, np.float32)
                for img_s, w_s in zip(self.inputs.image_stores,
                                      self.inputs.weight_stores):
                    img = img_s.read_block(lo, hi)
                    w = w_s.read_block(lo, hi)
                    acc += img * w
                    wsum += w
                psi0 = np.where(wsum > 1e-9,
                                acc / np.maximum(wsum, 1e-9), avg)
            else:
                psi0 = np.full(shape, avg, np.float32)
            self.psi_store.write_block(lo, np.maximum(psi0, floor))
        self.avg = avg
        return avg

    # ------------------------------------------------------------------
    def _conv(self, x, entry, trim, step, rz_fft, ry, rx, fshape):
        if "fft" in entry:
            return overlap_save_convolve(x, entry["fft"], rz_fft,
                                         x.shape[0] - 2 * rz_fft, ry, rx,
                                         fshape)
        mats = entry["mat"]
        Tz, My, Mx = (M[step % M.shape[0]] for M in mats)
        xp = x[trim:x.shape[0] - trim] if trim else x
        rz, ry, rx = entry["rad"]
        return conv_lowrank_folded_fused(xp, Tz, My, Mx, rz, ry, rx,
                                         z_off=rz)

    def _block_update(self, psi_ext, img_ext, w, v, step, z_lo, dev):
        """One view's RL update for one z-slab block: psi_ext (bz + 2 hz,
        Y, X) with the global z edges mirror-read; y/x mirror boundaries
        are applied locally, as the in-memory engine mirrors full axes.
        The tensors lie on `dev`, one of the devices the blocks run on.
        The update is written in place into psi_ext's interior rows, which
        are returned."""
        r1, r2 = self.r1[v], self.r2[v]
        e1, e2 = (es[v] for es in self._entries[dev])
        conv1 = self._conv(psi_ext, e1, self.t1[v], step, self.hz - self.r2z,
                           r1[1], r1[2], self.fs1[v])
        delta = "mat" in e2  # as the in-memory lowrank engine
        q = _mirror_q_edges(rl_quotient(
            img_ext, conv1, delta, operand_dtype(e2) == torch.bfloat16),
            z_lo, self.shape[0])
        conv2 = self._conv(q, e2, self.t2[v], step, self.r2z, r2[1], r2[2],
                           self.fs2[v])
        return rl_update(psi_ext[self.hz:self.hz + self.bz], conv2, w,
                         float(np.float32(self.osem)), self.lam,
                         float(np.float32(self.params.min_value * self.avg)),
                         delta)

    def run(self, num_iterations: Optional[int] = None,
            init_psi: bool = True, progress_fn=None):
        """Stream RL iterations; psi_store holds the result (and is the
        resume checkpoint — pass init_psi=False to continue a run)."""
        n = (num_iterations if num_iterations is not None
             else self.params.num_iterations)
        if init_psi:
            self.initialize_psi()
        elif self.avg is None:
            self.avg = self._global_average()
        Z, Y, X = self.shape
        devs = self._devices
        wb = _WriteBack(self.device, (self.bz, Y, X))
        src, dst = self.psi_store, self.scratch_store
        for it in range(n):
            for v in range(len(self.inputs.psfs)):
                # halos read from SRC (the pre-update psi), updates go to
                # DST: no block sees its predecessor's update
                for k, (lo, hi) in enumerate(self._blocks()):
                    dev = devs[k % len(devs)]
                    z0 = lo[0]
                    reads = (read_mirror_z(src, z0 - self.hz,
                                           z0 + self.bz + self.hz),
                             read_mirror_z(self.inputs.image_stores[v],
                                           z0 - self.r2z,
                                           z0 + self.bz + self.r2z),
                             self.inputs.weight_stores[v].read_block(lo, hi))
                    with on_device(dev):
                        out = self._block_update(
                            *(torch.from_numpy(a).to(dev) for a in reads),
                            v, it + v, z0 - self.r2z, dev)
                        wb.push(dst, lo, out)
                wb.flush()
                src, dst = dst, src
            if progress_fn is not None:
                progress_fn(it + 1)
        if src is not self.psi_store:  # odd number of view-updates
            for lo, hi in self._blocks():
                self.psi_store.write_block(lo, src.read_block(lo, hi))
        return self.psi_store
