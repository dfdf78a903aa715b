"""Sharded kernels on a device mesh: Gaussian / DoG, FFT convolution,
fusion and the multi-view Richardson-Lucy engine.

Port of the reference's `parallel/sharded.py`: volumes are z-sharded over
a mesh axis; every convolution exchanges its PSF-support halo with the
mesh neighbours (`halo_exchange_z`) and computes shard-locally, so psi
never leaves its shards during RL. The reference traces one `shard_map`
program; here every step runs at each position in turn
(`mesh.shard_map`), and the shards cross positions only through
`parallel/mesh.py`.

The lowrank backend's z pass consumes each halo-extended shard through
`conv_lowrank_folded_fused` with the z band matrix (R, zl, zl + 2 hz)
centred at column `hz`: on a card it launches the hand-written kernels
`zpass` (the band windows) and `sl_rows` (the mirror-folded y/x passes),
on the CPU the same call takes their plain versions. The route follows
the device alone, as in the out-of-core engine (`lowrank_fused` selects
between the kernels and the plain chain only in the in-memory engine).
The RL engine has one loop for each scheme, `run_sequential` and
`run_parallel`; the backends (FFT, separable, z-sharded lowrank, lowrank
stacked over a view axis) give them only how a view convolves and the
few values in which their view updates differ. In both schemes the
elementwise work is `ops/kernels/rl_update.py`'s: the quotient is
`rl_quotient`, the sequential update `rl_update` (a kernel each on a
card, their plain versions on the CPU), the parallel update
`regularize_`. The quotient and the sequential update write the next
convolution's operand in the dtype it reads, so a lowrank bf16 operand
crosses the halo exchange in bf16.

Inputs are host arrays (or tensors); outputs are host arrays, except
`device_result`. Across processes (`parallel/multihost.py`) every
process stages and runs its own positions, and the outputs are gathered
to every process (`gather`, the reference's `process_allgather`). The RL
engine stages shard by shard (`stage_slabs`): a position receives its own
z-slab of the views and computes its share of the starting estimate, so
no whole stack is copied or multiplied on the host.

Tracing (`utils/profiling.py`): the RL runner's staging is the span
`spim/mesh.stage` (its kernel decompositions `spim/mesh.decompose`);
while a profiler runs, a run is `spim/mesh.run` over `spim/mesh.iteration`
and `spim/mesh.view`, and each card's stream time splits into the phases
`spim/mesh.halo` (the exchange: peer copies and the extended slab),
`spim/mesh.conv` (each convolution call) and `spim/mesh.update` (the
rest). Counters: `halo_exchange_z.exchanges` / `.peer_bytes`.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import numpy as np
import torch

from spim_registration_tpu_torch.deconv.blocked import (
    _decompose,
    _entry_to,
    _lowrank_stage_entries,
    _stage_matrices,
)
from spim_registration_tpu_torch.deconv.lucy_richardson import (
    _stack_factor_banks,
    compound_kernels,
)
from spim_registration_tpu_torch.ops.fftconv import (
    fft_shape_for,
    overlap_save_convolve,
    prepare_kernel_fft,
)
from spim_registration_tpu_torch.ops.gaussian import (
    conv_axis_valid,
    gaussian_kernel_1d,
    mirror_pad,
)
from spim_registration_tpu_torch.ops.kernels.lowrank_conv import (
    conv_lowrank_folded_fused,
    operand_dtype,
)
from spim_registration_tpu_torch.ops.kernels.rl_update import (
    regularize_,
    rl_quotient,
    rl_update,
)
from spim_registration_tpu_torch.ops.separable import mirror_indices
from spim_registration_tpu_torch.parallel.halo import halo_exchange_z
from spim_registration_tpu_torch.parallel.mesh import (
    Mesh,
    allgather,
    gather,
    psum,
    shard,
    shard_map,
)
from spim_registration_tpu_torch.utils.device import on_device
from spim_registration_tpu_torch.utils.profiling import (
    MESH_CONV,
    MESH_DECOMPOSE,
    MESH_HALO,
    MESH_ITERATION,
    MESH_RUN,
    MESH_STAGE,
    MESH_UPDATE,
    MESH_VIEW,
    RECORDER,
    PhaseTimer,
    profiler_active,
    span,
)

_OFF = contextlib.nullcontext()


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().astype(np.float32, copy=False)
    return np.asarray(a, np.float32)


def _per_device(mesh: Mesh, make) -> list:
    """make(device) once per distinct device of this process, listed per
    position (None at other processes' positions)."""
    done = {}
    for p in mesh.local_positions:
        dev = mesh.device(p)
        if dev not in done:
            done[dev] = make(dev)
    return [done[mesh.device(p)] if mesh.is_local(p) else None
            for p in range(mesh.size)]


def _check_depth(Z: int, nz: int) -> None:
    if Z % nz:
        raise ValueError(f"volume depth {Z} does not split over a "
                         f"{nz}-shard mesh axis")


# ---------------------------------------------------------------- gaussian

def _local_gaussian(xp: torch.Tensor, kernels, h: int) -> torch.Tensor:
    """Blur a halo-extended shard (zl + 2h rows) to its zl interior rows."""
    kz, ky, kx = kernels
    rz = (kz.shape[0] - 1) // 2
    if h > rz:  # trim excess halo so the valid conv lands on the interior
        xp = xp[h - rz: xp.shape[0] - (h - rz)]
    out = conv_axis_valid(xp, kz, 0)
    out = conv_axis_valid(mirror_pad(out, (ky.shape[0] - 1) // 2, 1), ky, 1)
    return conv_axis_valid(mirror_pad(out, (kx.shape[0] - 1) // 2, 2), kx, 2)


def sharded_gaussian_blur(vol, sigmas, mesh: Mesh,
                          axis_name: str = "z") -> np.ndarray:
    """Separable Gaussian blur of a z-sharded volume (mirror boundary)."""
    vol = _host(vol)
    _check_depth(vol.shape[0], mesh.shape[axis_name])
    ks_np = [gaussian_kernel_1d(float(s)) for s in sigmas]
    h = (ks_np[0].shape[0] - 1) // 2
    ks = _per_device(mesh, lambda d: [torch.as_tensor(k, device=d)
                                      for k in ks_np])
    xs = halo_exchange_z(shard(vol, mesh, (axis_name,)), h, mesh, axis_name)
    out = shard_map(lambda p, xp, k: _local_gaussian(xp, k, h), mesh, xs, ks)
    return gather(out, mesh, (axis_name,))


def sharded_dog(vol, sigma1, sigma2, mesh: Mesh,
                axis_name: str = "z") -> np.ndarray:
    """Difference-of-Gaussian of a z-sharded volume."""
    g1 = sharded_gaussian_blur(vol, (sigma1,) * 3, mesh, axis_name)
    g2 = sharded_gaussian_blur(vol, (sigma2,) * 3, mesh, axis_name)
    return g1 - g2


# ---------------------------------------------------------------- fft conv

def sharded_fft_convolve(vol, kernel, mesh: Mesh,
                         axis_name: str = "z") -> np.ndarray:
    """FFT-convolve a z-sharded volume with a small (replicated) kernel:
    per-shard overlap-save over exchanged halos, mirror boundary.

    A depth Z that does not split over the axis is extended by its own
    mirror continuation to nz * ceil((Z + h) / nz) rows, so the rows near
    the true bottom edge see the mirror data of the unsharded
    convolution, and the extension is cropped. Kernel supports deeper
    than a shard take multi-hop halos, up to h <= Z - 1."""
    vol = _host(vol)
    kernel = np.asarray(kernel, np.float32)
    nz = mesh.shape[axis_name]
    Z, Y, X = vol.shape
    kz, ky, kx = kernel.shape
    h = kz // 2
    if h > Z - 1:
        raise ValueError(f"kernel z support {kz} exceeds volume depth {Z}")
    zl = -(-max(Z + h, nz) // nz) if Z % nz else Z // nz
    Zp = zl * nz
    if Zp != Z:
        vol = vol[mirror_indices(Z, Zp - Z)[Zp - Z:]]
    ry, rx = ky // 2, kx // 2
    fshape = fft_shape_for((zl + 2 * h, Y + 2 * ry, X + 2 * rx))
    kf = _per_device(mesh, lambda d: prepare_kernel_fft(
        torch.as_tensor(kernel, device=d), fshape))
    xs = halo_exchange_z(shard(vol, mesh, (axis_name,)), h, mesh, axis_name)
    out = shard_map(lambda p, xp, k: overlap_save_convolve(
        xp, k, h, zl, ry, rx, fshape), mesh, xs, kf)
    return gather(out, mesh, (axis_name,))[:Z]


# ---------------------------------------------------------------- fusion

def sharded_fuse_views(volumes, models, bbox, params=None,
                       mesh: Optional[Mesh] = None,
                       axis_name: str = "z") -> np.ndarray:
    """Weighted-average fusion with the OUTPUT box z-sharded over the mesh
    (the reference's `FusionHelper` thread split as mesh positions).

    Each position fuses its own output z-slab with the single-device
    `fuse_views` chunk step (`_fuse_chunk`: one view after another into
    the slab's accumulators); the views are replicated, the output rows
    disjoint, so no shard exchanges anything. Ragged output depths pad
    the slab grid and crop the extra rows."""
    from spim_registration_tpu_torch.fuse.weighted_avg import (
        FusionParameters,
        _fuse_chunk,
        _view_maps,
    )

    if params is None:
        params = FusionParameters()
    if mesh is None:
        raise ValueError("sharded_fuse_views requires a mesh")
    ds = params.downsample
    out_shape = tuple(s // ds for s in bbox.shape)
    if any(s == 0 for s in out_shape):
        raise ValueError(f"empty bounding box {bbox}")
    nz = mesh.shape[axis_name]
    Z = out_shape[0]
    zl = -(-Z // nz)
    chunk_shape = (zl,) + out_shape[1:]
    views = _per_device(mesh, lambda d: _view_maps(volumes, models, bbox,
                                                   params, d))

    def f(p, vws):
        return _fuse_chunk(vws, mesh.index(p, axis_name) * zl, chunk_shape,
                           params, mesh.device(p))

    return gather(shard_map(f, mesh, views), mesh, (axis_name,))[:Z]


# ------------------------------------------------------- lowrank (sharded)

def _clamp_kernel_z(k, max_taps: int):
    """Centre-crop a kernel's z support to `max_taps` (odd) and
    renormalize (a copy of the reference's): the ragged-depth pad >= h
    guarantee comes from the clamped kernel shape, so a PSF deeper than
    2 * Zp - 1 is clamped before its decomposition. Returns (kernel,
    clamped)."""
    k = np.asarray(k)
    if k.shape[0] <= max_taps:
        return k, False
    off = (k.shape[0] - max_taps) // 2
    kc = k[off:off + max_taps].copy()
    kc /= max(kc.sum(), 1e-12)
    return kc, True


def _sharded_lowrank_entries(kernels, zl, yx, params, mesh: Mesh, fft,
                             factors=None, max_z_taps=None) -> list:
    """Per-position lowrank entries of one conv stage: each kernel's z
    support clamped to `max_z_taps`, then the blocked engine's
    `_lowrank_stage_entries` with the z band over a halo-extended shard of
    `zl` rows, staged on this process's first device and copied to its
    others. A kernel that missed `psf_rank_tol` gets `fft(kernel, device)`,
    the exact per-shard FFT entry."""
    ks, facs = [], []
    for i, k in enumerate(kernels):
        fac = factors[i] if factors is not None else None
        if max_z_taps is not None:
            k, clamped = _clamp_kernel_z(k, max_z_taps)
            if clamped:  # exact factors no longer match the clamped kernel
                fac = None
        ks.append(np.asarray(k, np.float32))
        facs.append(fac)
    entries, _, _ = _lowrank_stage_entries(ks, zl, yx, params, facs,
                                           device=mesh.first_device())
    return _per_device(mesh, lambda d: [
        fft(k, d) if e is None else _entry_to(e, d)
        for k, e in zip(ks, entries)])


def _stacked_lowrank_matrices(kernels, zl, yx, params, factors=None):
    """Stacked (across views) lowrank matrices for view-axis sharding:
    per-view adaptive ranks bucketed to the largest by zero factor rows
    (a zero row adds exactly 0) and taps zero-padded, centred, to a common
    support, so (Tz, My, Mx) stack to (V, phases, R, n, p) host tensors
    in the matrix dtype. Returns (triple, (rz, ry, rx)), or None if any
    kernel misses `psf_rank_tol` at the escalated cap (the caller then
    runs the exact FFT backend)."""
    banks = []
    for i, k in enumerate(kernels):
        fac = factors[i] if factors is not None else None
        az, ay, ax, err = _decompose(k, params, fac)
        if err > params.psf_rank_tol:
            return None
        banks.append([az, ay, ax])
    rmax = max(b[0].shape[0] for b in banks)
    for d in range(3):
        taps = max(b[d].shape[1] for b in banks)
        for b in banks:
            padt = taps - b[d].shape[1]
            lo = padt // 2
            b[d] = np.pad(b[d], ((0, rmax - b[d].shape[0]),
                                 (lo, padt - lo)))
    per_view = [_stage_matrices(*b, zl, yx, params) for b in banks]
    rads = tuple((f.shape[1] - 1) // 2 for f in banks[0])
    return tuple(torch.stack(s) for s in zip(*per_view)), rads


# ------------------------------------------------------- staging (RL)

def _stack_source(a) -> torch.Tensor:
    """A (V, Z, Y, X) stack as a tensor, without a copy where it is one: a
    tensor as it is (on the host or a card), a float32 array through
    `torch.from_numpy` (another dtype converted to float32 once)."""
    if isinstance(a, torch.Tensor):
        return a.detach()
    a = np.asarray(a)
    if a.dtype != np.float32:
        a = a.astype(np.float32)
    return torch.from_numpy(a)


def _slab_rows(z0: int, zl: int, Z: int):
    """The source rows of global rows [z0, z0 + zl) of a depth Z mirror-
    extended past its end: a slice where all lie inside, else an index
    tensor (row Z + d reads row Z - 2 - d); and how many lie inside."""
    n_in = max(0, min(zl, Z - z0))
    if n_in == zl:
        return slice(z0, z0 + zl), zl
    g = np.arange(z0, z0 + zl)
    return torch.as_tensor(np.where(g < Z, g, 2 * (Z - 1) - g)), n_in


def _stage_slab(img_src, w_src, z0: int, zl: int, Z: int, u0: int, Vl: int,
                dev: torch.device) -> tuple:
    """One position's slab: views [u0, u0 + Vl) of rows [z0, z0 + zl) of
    the images and weights on `dev`, copied view by view (weights 0 past
    Z: no signal there), and over all views of the slab, in view order,
    iw = sum_v w_v img_v and wsum = sum_v w_v (past Z from the mirror
    rows' weights) with their float64 sums over the rows inside Z."""
    rows, n_in = _slab_rows(z0, zl, Z)
    V, _, Y, X = img_src.shape

    def take(src, v):
        if isinstance(rows, slice):
            return src[v, rows]
        return src[v].index_select(0, rows.to(src.device))

    imgs = torch.empty((Vl, zl, Y, X), dtype=torch.float32, device=dev)
    ws = torch.empty_like(imgs)
    iw = wsum = None
    with on_device(dev):
        for v in range(V):
            mine = u0 <= v < u0 + Vl
            img = imgs[v - u0] if mine else torch.empty_like(imgs[0])
            w = ws[v - u0] if mine else torch.empty_like(imgs[0])
            img.copy_(take(img_src, v), non_blocking=True)
            w.copy_(take(w_src, v), non_blocking=True)
            if iw is None:
                iw, wsum = img * w, w.clone()
            else:
                iw += img * w
                wsum += w
        if n_in < zl:
            ws[:, n_in:] = 0.0
        sums = torch.stack([iw[:n_in].sum(dtype=torch.float64),
                            wsum[:n_in].sum(dtype=torch.float64)])
    return imgs, ws, sums, iw, wsum


def stage_slabs(images, weights, mesh: Mesh, zl: int, Z: int,
                min_value: float, axis_name: str = "z",
                view_axis: Optional[str] = None) -> tuple:
    """Shard-by-shard staging of a sharded RL run.

    Each position of this process receives only its own z-slab (zl rows
    at its index along `axis_name`, past the true depth Z the mirror
    extension) of its views (all of them, or its block along
    `view_axis`), copied view by view from `images` / `weights` ((V, Z,
    Y, X) host arrays or tensors; from pinned host memory the copies run
    asynchronously). Each card computes its slab's wsum and sum_v w_v
    img_v, and their float64 sums; the mean is the sum of those scalars
    over the z-slabs (gathered across processes) and nothing else of the
    stack meets on the host. Positions on one device that hold the same
    slab share its tensors.

    Returns (imgs, ws, psi0, mean): per-position slabs (Vl, zl, Y, X) of
    the images and weights, the starting estimate's shards (the weighted
    mean of the views, the mean where no view weighs, floored at
    min_value * mean), and the mean."""
    img_src, w_src = _stack_source(images), _stack_source(weights)
    V = img_src.shape[0]
    nv = mesh.shape[view_axis] if view_axis is not None else 1
    if V % nv:
        raise ValueError(f"dimension 0 of size {V} does not split over "
                         f"mesh axis {view_axis!r} of size {nv}")
    Vl = V // nv
    slabs, keys, sums = {}, [None] * mesh.size, [None] * mesh.size
    for p in mesh.local_positions:
        dev = mesh.device(p)
        u0 = mesh.index(p, view_axis) * Vl if view_axis is not None else 0
        keys[p] = (dev, mesh.index(p, axis_name), u0)
        if keys[p] not in slabs:
            slabs[keys[p]] = _stage_slab(img_src, w_src, keys[p][1] * zl,
                                         zl, Z, u0, Vl, dev)
        sums[p] = slabs[keys[p]][2]
    iw_sum = w_sum = 0.0
    for p, t in enumerate(allgather(sums, mesh)):
        if view_axis is None or mesh.index(p, view_axis) == 0:
            t = t.cpu()                       # every z-slab once
            iw_sum += float(t[0])
            w_sum += float(t[1])
    mean = float(iw_sum / max(w_sum, 1e-9))
    psi0 = {}
    for dev, i, _ in slabs:
        if (dev, i) not in psi0:
            _, _, _, iw, wsum = next(v for k, v in slabs.items()
                                     if k[:2] == (dev, i))
            with on_device(dev):
                psi0[dev, i] = torch.where(
                    wsum > 1e-9, iw / wsum.clamp(min=1e-9),
                    mean).clamp(min=min_value * mean)
    imgs = [None if k is None else slabs[k][0] for k in keys]
    ws = [None if k is None else slabs[k][1] for k in keys]
    start = [None if k is None else psi0[k[:2]] for k in keys]
    return imgs, ws, start, mean


# ---------------------------------------------------------------- deconv

def _mirror_restore_z(xs: list, Z_true: int, hr: int, mesh: Mesh,
                      axis_name: str) -> list:
    """Re-pin the ragged mirror-extension rows (global z >= Z_true) to the
    mirror continuation of the current data: row Z + d <- row Z - 2 - d.

    Kept after every psi update and on every quotient before its conv, it
    makes each conv's input window equal the unsharded engine's mirror
    window, so the ragged-depth sharded RL is exact at the true bottom
    edge. `hr` = max(1, 2 pad - zl + 1) reaches every source row
    (multi-hop through `halo_exchange_z`)."""
    zl = mesh.first(xs).shape[0]
    xps = halo_exchange_z(xs, hr, mesh, axis_name)

    def f(p, x, xp):
        rows = _restore_rows(mesh.index(p, axis_name) * zl, zl, Z_true, hr,
                             x.device)
        if rows is None:
            return x
        out = x.clone()
        out[rows[0]] = xp[rows[1]]
        return out

    return shard_map(f, mesh, xs, xps)


@functools.lru_cache(maxsize=256)
def _restore_rows(z0: int, zl: int, Z_true: int, hr: int,
                  device: torch.device):
    """A shard's rows at or past Z_true and the rows of its hr-extended
    block that hold their mirror sources (row Z + d <- row Z - 2 - d), as
    index tensors on `device` (cached: one host-to-device copy a shape);
    None for a shard inside the true depth."""
    g = z0 + np.arange(zl)
    rows = np.nonzero(g >= Z_true)[0]
    if rows.size == 0:
        return None
    li = np.clip(2 * Z_true - 2 - g[rows] - z0 + hr, 0, zl + 2 * hr - 1)
    return (torch.as_tensor(rows, device=device),
            torch.as_tensor(li, device=device))


def sharded_deconvolve(prep, params, mesh: Mesh, axis_name: str = "z",
                       view_axis: Optional[str] = None) -> np.ndarray:
    """Multi-view RL with psi and the views z-sharded over the mesh.

    One-shot convenience over `sharded_deconvolution_runner` (stage once,
    run once): the math of `deconv.lucy_richardson.deconvolve`, with every
    convolution per-shard over live halos. With `view_axis` (a second
    mesh axis) the parallel update scheme runs views data-parallel: each
    view shard convolves its views against the (view-replicated,
    z-sharded) psi, and the update factor is summed over the view axis
    (`psum`)."""
    return sharded_deconvolution_runner(
        prep, params, mesh, axis_name=axis_name, view_axis=view_axis)()


def sharded_deconvolution_runner(prep, params, mesh: Mesh,
                                 axis_name: str = "z",
                                 view_axis: Optional[str] = None,
                                 device_result: bool = False):
    """Stage kernels and inputs on the mesh once and return a zero-arg
    callable that runs the sharded RL iterations (the mesh counterpart of
    `DeconvolutionRunner`'s staging / run split): repeated runs time the
    iterations, not the host's kernel decomposition.

    The callable returns psi (Z, Y, X) on the host, or with
    `device_result` the list of per-position psi shards at the padded
    depth (`execute.padded_depth`; the true depth is
    `execute.true_depth`). It also carries the staging's `mean` and
    `floor` (min_value * mean in float32), the starting shards (`start`),
    the shard depth (`slab_depth`), and on the z-sharded lowrank path the
    first position's kernel entries (`entries`: k1 and k2 by view).

    The staging, shard by shard (`stage_slabs`), is the span
    `spim/mesh.stage` and ends once every card of this process has
    finished it."""
    with span(MESH_STAGE):
        execute = _stage_runner(prep, params, mesh, axis_name, view_axis,
                                device_result)
        for d in dict.fromkeys(mesh.device(p) for p in mesh.local_positions):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
    return execute


def _stage_runner(prep, params, mesh: Mesh, axis_name: str,
                  view_axis: Optional[str], device_result: bool):
    """`sharded_deconvolution_runner`'s staging and its run."""
    V, Z, Y, X = tuple(prep.images.shape)
    nz = mesh.shape[axis_name]
    scheme = params.scheme
    if view_axis is not None and scheme != "parallel":
        raise ValueError("view-axis sharding requires scheme='parallel' "
                         "(sequential OSEM is inherently view-serial)")

    k2s = compound_kernels(prep.psfs, params.psf_type)
    raw = tuple(max(max(np.shape(p)[d] for p in prep.psfs),
                    max(k.shape[d] for k in k2s)) for d in range(3))
    raw = tuple(k if k % 2 else k + 1 for k in raw)

    def _kshape(zloc):
        # kernels may be deeper than a shard: halos are multi-hop and
        # overlap-save needs only h <= Zp - 1 (the global mirror limit),
        # so thin shards do not truncate the PSF
        lim = (2 * nz * zloc - 1, 2 * Y - 1, 2 * X - 1)
        return tuple(min(k, m) for k, m in zip(raw, lim))

    # Ragged depths: mirror-extend the volume to Zp = nz * zl with a pad
    # >= h, kept live by `_mirror_restore_z`. zl iterates to a fixpoint
    # because the kernel clamp (2 Zp - 1) loosens as zl grows.
    if Z % nz == 0:
        zl, pad = Z // nz, 0
    else:
        zl = -(-Z // nz)
        for _ in range(8):
            zl_new = -(-(Z + _kshape(zl)[0] // 2) // nz)
            if zl_new == zl:
                break
            zl = zl_new
        pad = nz * zl - Z
        if pad > Z - 1:
            raise ValueError(
                f"volume depth {Z} too thin to mirror-extend over a "
                f"{nz}-shard mesh (needs {pad} mirror rows)")
    kshape = _kshape(zl)

    def _fit(k):
        out = np.zeros(kshape, np.float32)
        sl_src, sl_dst = [], []
        for d in range(3):
            if k.shape[d] <= kshape[d]:
                off = (kshape[d] - k.shape[d]) // 2
                sl_src.append(slice(0, k.shape[d]))
                sl_dst.append(slice(off, off + k.shape[d]))
            else:
                off = (k.shape[d] - kshape[d]) // 2
                sl_src.append(slice(off, off + kshape[d]))
                sl_dst.append(slice(0, kshape[d]))
        out[tuple(sl_dst)] = k[tuple(sl_src)]
        return out / max(out.sum(), 1e-12)

    h = kshape[0] // 2
    ry, rx = kshape[1] // 2, kshape[2] // 2
    fshape = fft_shape_for((zl + 2 * h, Y + 2 * ry, X + 2 * rx))
    psfs = [np.asarray(p, np.float32) for p in prep.psfs]
    factors = getattr(prep, "psf_factors", None)

    def spectra(kernels):
        """Per position: the FFT of each fitted kernel at fshape."""
        fitted = [_fit(np.asarray(k, np.float32)) for k in kernels]
        return _per_device(mesh, lambda d: [prepare_kernel_fft(
            torch.as_tensor(k, device=d), fshape) for k in fitted])

    backend = params.conv_backend
    stacked = None
    if backend == "lowrank" and view_axis is not None:
        # view-axis lowrank: ranks bucketed so the matrices stack over the
        # view axis; if any kernel misses the tolerance the whole job runs
        # the exact FFT backend (accuracy is never silently reduced)
        with span(MESH_DECOMPOSE):
            s1 = _stacked_lowrank_matrices(psfs, zl, (Y, X), params,
                                           factors=factors)
        with span(MESH_DECOMPOSE):
            s2 = _stacked_lowrank_matrices(k2s, zl, (Y, X), params)
        if s1 is None or s2 is None:
            backend = "fft"
        else:
            stacked = tuple(
                (tuple(shard(M, mesh, (view_axis,), M.dtype) for M in trip),
                 rads)
                for trip, rads in (s1, s2))
    if stacked is not None:
        k1, k2 = stacked
    elif backend == "separable":
        k1, k2 = (shard_map(
            lambda p, bk: [tuple(b[v] for b in bk) for v in range(V)],
            mesh, _per_device(mesh, lambda d, ks=ks: _stack_factor_banks(
                [_fit(np.asarray(k, np.float32)) for k in ks],
                params.psf_rank, params.psf_rank_max_error, d)))
            for ks in (psfs, k2s))
    elif backend == "lowrank":
        def fft_entry(k, d):
            return {"fft": prepare_kernel_fft(
                torch.as_tensor(_fit(k), device=d), fshape)}

        with span(MESH_DECOMPOSE):
            k1 = _sharded_lowrank_entries(psfs, zl, (Y, X), params, mesh,
                                          fft_entry, factors=factors,
                                          max_z_taps=kshape[0])
        with span(MESH_DECOMPOSE):
            k2 = _sharded_lowrank_entries(k2s, zl, (Y, X), params, mesh,
                                          fft_entry, max_z_taps=kshape[0])
    else:
        # "fft", and as in the reference any other string: exact FFT
        k1, k2 = spectra(psfs), spectra(k2s)

    osem = float(np.float32(params.osem_factor
                            if params.osem_factor is not None
                            else prep.osem_factor))
    lam = (float(np.float32(params.tikhonov_lambda))
           if params.tikhonov_lambda > 0 else None)
    # shard by shard; a ragged depth's rows past Z mirror the data, with
    # weights 0 there (no signal)
    imgs, ws, psi_start, avg = stage_slabs(
        prep.images, prep.weights, mesh, zl, Z, params.min_value,
        axis_name, view_axis)
    minv = float(np.float32(params.min_value * avg))
    hr = max(1, 2 * pad - zl + 1) if pad else 0
    Vl = mesh.first(imgs).shape[0]
    # global view of local view u at position p (views split over the
    # view axis, whole otherwise)
    v0 = [mesh.index(p, view_axis) * Vl if view_axis is not None else 0
          for p in range(mesh.size)]
    n_iter = params.num_iterations

    def each(fn, *shards):
        return shard_map(fn, mesh, *shards)

    timer = [None]      # a traced run's PhaseTimer

    def lap(phase):
        if timer[0] is not None:
            timer[0].lap(phase)

    def iteration():
        return _OFF if timer[0] is None else timer[0].iteration()

    def view():
        return _OFF if timer[0] is None else timer[0].view()

    def exchange(xs, depth):
        """The halo exchange of a convolution, its phases marked: the
        update before it, then the exchange."""
        lap(MESH_UPDATE)
        xps = halo_exchange_z(xs, depth, mesh, axis_name)
        lap(MESH_HALO)
        return xps

    def convolved(out):
        lap(MESH_CONV)
        return out

    def restore(xs):
        if pad == 0:
            return xs
        return _mirror_restore_z(xs, Z, hr, mesh, axis_name)

    def fft_conv(xs, kf):
        """kf: per position, the spectrum to apply there."""
        xps = exchange(xs, h)
        return convolved(each(lambda p, xp, k: overlap_save_convolve(
            xp, k, h, zl, ry, rx, fshape), xps, kf))

    def sep_conv(xs, banks_):
        """Sum-of-separable conv: the z pass over exchanged halo rows, the
        y/x passes mirror-padded locally; factors flipped so the
        correlation-style `conv_axis_valid` computes true convolution."""
        hz = (banks_[0][0].shape[-1] - 1) // 2
        xps = exchange(xs, hz)

        def f(p, xp, bank):
            az, ay, ax = (torch.flip(b, dims=(1,)) for b in bank)
            total = None
            for kz, ky, kx in zip(az, ay, ax):
                out = conv_axis_valid(xp, kz, 0) if hz > 0 else xp * kz[0]
                for axis, k in ((1, ky), (2, kx)):
                    r = (k.shape[0] - 1) // 2
                    out = (conv_axis_valid(mirror_pad(out, r, axis), k, axis)
                           if r > 0 else out * k[0])
                total = out if total is None else total + out
            return total

        return convolved(each(f, xps, banks_))

    def mat_conv(xs, mats, rads):
        """mats: per position the (Tz, My, Mx) of one phase; the band
        matrix's half-support hz is the halo and the band offset."""
        Tz = mesh.first(mats)[0]
        hz = (Tz.shape[-1] - Tz.shape[-2]) // 2
        xps = exchange(xs, hz)
        return convolved(each(lambda p, xp, m: conv_lowrank_folded_fused(
            xp, *m, rad_z=hz, rad_y=rads[1], rad_x=rads[2], z_off=hz),
            xps, mats))

    # What the backends differ in, and all they give the two loops below:
    # `conv(xs, ks, u, step)` convolves with local view u's kernel of
    # `ks` (k1 or k2) at dither step `step`; `delta(u)`: view u's second
    # conv takes q - 1; `bf16(ks, u)`: that conv of `ks` reads a bf16
    # operand; `step(i, u)`: the dither step of view u in iteration i;
    # `running`: the parallel factor sums from one, else its 1 is added
    # after the sum (and its `psum` over a view axis).
    if stacked is not None:
        # view-axis lowrank RL on the (view, z) mesh: each view shard
        # convolves its views with its stacked matrices; the bf16 phase
        # advances per iteration, the same for every view on every shard
        n_phases = mesh.first(k1[0][0]).shape[1]

        def conv(xs, ks, u, step):
            K, rads = ks
            return mat_conv(xs, each(lambda p, *trip: tuple(
                M[u, step % n_phases] for M in trip), *K), rads)

        def delta(u):
            return True

        def bf16(ks, u):
            return mesh.first(ks[0][0]).dtype == torch.bfloat16

        def step(i, u):
            return i

        running = False
    elif backend == "lowrank":
        # z-sharded lowrank RL: unrolled per-view kernels with adaptive
        # ranks, the bf16 phase schedule (iteration + view), conv2 in
        # delta form K2 (x) (q - 1), exact-FFT entries (float32 operands)
        # where a kernel missed its tolerance
        mats = [e["mat"] for e in mesh.first(k1) + mesh.first(k2)
                if "mat" in e]
        n_phases = mats[0][0].shape[0] if mats else 1

        def conv(xs, ks, v, step):
            e = mesh.first(ks)[v]
            if "fft" in e:
                return fft_conv(xs, each(lambda p, k: k[v]["fft"], ks))
            ph = step % n_phases
            return mat_conv(xs, each(lambda p, k: tuple(
                M[ph] for M in k[v]["mat"]), ks), e["rad"])

        def delta(v):
            return "mat" in mesh.first(k2)[v]

        def bf16(ks, v):
            return operand_dtype(mesh.first(ks)[v]) == torch.bfloat16

        def step(i, v):
            return i + v

        running = True
    else:
        # FFT or separable backend, in float32, which these convolutions
        # read; view u of position p is global view v0[p] + u
        def conv(xs, ks, u, step):
            local = each(lambda p, k: k[v0[p] + u], ks)
            if backend == "separable":
                return sep_conv(xs, local)
            return fft_conv(xs, local)

        def delta(u):
            return False

        def bf16(ks, u):
            return False

        def step(i, u):
            return None

        running = False

    def run_sequential(psi):
        """The sequential (OSEM) scheme of the z-only engines: at every
        position the quotient and the estimate's update (in place; a run
        starts from a copy of the staged start) are one `rl_quotient` and
        one `rl_update`. Each pass writes the next convolution's operand
        in the dtype it reads, so the halo exchange before it moves bf16
        rows there; the first convolution of a run casts inside itself.
        At a ragged depth the estimate's mirror rows are re-pinned after
        its update, so there the update writes no copy and the
        convolution casts."""
        psi = each(lambda p, x: x.clone(), psi)
        x = psi                 # the next conv's operand: psi or a copy
        for i in range(n_iter):
            with iteration():
                for v in range(V):
                    with view():
                        d, b = delta(v), bf16(k2, v)
                        q = restore(each(lambda p, img, c: rl_quotient(
                            img[v], c, d, b), imgs, conv(x, k1, v, i + v)))
                        last = i == n_iter - 1 and v == V - 1
                        copy = (pad == 0 and not last
                                and bf16(k1, (v + 1) % V))
                        x = each(lambda p, s, c, w: rl_update(
                            s, c, w[v], osem, lam, minv, d, copy),
                            psi, conv(q, k2, v, i + v), ws)
                        if pad:
                            psi = x = restore(psi)
                        lap(MESH_UPDATE)
        return psi

    def run_parallel(psi):
        """The parallel scheme: every view's factor at the iteration's
        estimate, then one update. At every position the quotient is one
        `rl_quotient`, written in the dtype its convolution reads; view
        u's term is w_u * d_u, d_u its second conv, less 1 unless
        `delta(u)`; the terms sum from one where `running`, else 1 is
        added to their sum, summed over a view axis by `psum`; the new
        estimate is `regularize_` of psi times that factor."""
        for i in range(n_iter):
            with iteration():
                acc = (each(lambda p, x: torch.ones((), device=x.device), psi)
                       if running else None)
                for u in range(Vl):
                    with view():
                        d, b = delta(u), bf16(k2, u)
                        q = restore(each(lambda p, img, c: rl_quotient(
                            img[u], c, d, b), imgs,
                            conv(psi, k1, u, step(i, u))))
                        t = each(lambda p, w, c: w[u] * (
                            c if d else c - 1.0), ws,
                            conv(q, k2, u, step(i, u)))
                        acc = t if acc is None else each(
                            lambda p, a, b: a + b, acc, t)
                        lap(MESH_UPDATE)
                if view_axis is not None:
                    acc = psum(acc, mesh, view_axis)
                psi = restore(each(lambda p, x, f: regularize_(
                    x * (f if running else 1.0 + f), lam, minv), psi, acc))
                lap(MESH_UPDATE)
        return psi

    engine = run_sequential if scheme == "sequential" else run_parallel

    def execute():
        if not profiler_active():
            out = engine(psi_start)
        else:
            # traced: the run's spans, and each card's phases
            with span(MESH_RUN, run_id=RECORDER.new_run_id()) as s:
                timer[0] = PhaseTimer(
                    [mesh.device(p) for p in mesh.local_positions],
                    s.run_id, (MESH_HALO, MESH_CONV, MESH_UPDATE),
                    (MESH_ITERATION, MESH_VIEW))
                try:
                    out = engine(psi_start)
                finally:
                    timer[0].close()
                    timer[0] = None
        if device_result:
            return out
        return gather(out, mesh, (axis_name,))[:Z]

    execute.true_depth = Z
    execute.padded_depth = nz * zl
    execute.slab_depth = zl
    execute.mean = avg
    execute.floor = minv
    execute.start = psi_start
    execute.entries = (None if stacked is not None or backend != "lowrank"
                       else (mesh.first(k1), mesh.first(k2)))
    return execute
