"""Local extremum detection + sub-pixel quadratic localization.

Port of the reference's `ops/extrema.py` (ImgLib1 DoG peak detection and
`SubpixelLocalization`):

- candidates are voxels equal to their 3x3x3 window max (`_pool3`, a
  max-pool that pads with -inf like the reference's SAME `reduce_window`),
  above threshold and off the border; strictness (center strictly above
  all 26 neighbours) is checked afterwards on the selected rows only;
- selection is `_segmented_compact_topk`: per-segment extraction of the
  sparse score field (`ops/kernels/segtopk.py`, the CUDA kernel on the
  card) and a small sort of the survivors, with an exact guard: if any
  segment holds more candidates than extraction rounds, the exact top-k
  of the whole field is taken instead;
- sub-pixel refinement is batched over peaks: one 27-neighbourhood gather
  per iteration and closed-form (adjugate) 3x3 Newton steps, the
  reference's re-centering `while_loop` as a Python loop on a synced
  flag.

The reference's `lax.cond` branches become host branches on one synced
scalar; both sides of each branch are exact, so the results do not
depend on which one runs. The reference's hot-slice gathers (a transfer
saving for its remote TPU) are not carried over: every row of the peak
budget is refined, which gives the same rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from spim_registration_tpu_torch.ops.kernels.segtopk import segment_topk
from spim_registration_tpu_torch.ops.topk import top_k


def _pool3(vol: torch.Tensor, minimum: bool = False) -> torch.Tensor:
    """3x3x3 window max (or min) with the -inf (+inf) border of the
    reference's SAME `reduce_window`."""
    v = -vol if minimum else vol
    m = F.max_pool3d(v[None, None], 3, stride=1, padding=1)[0, 0]
    return -m if minimum else m


def _interior_mask(shape, device) -> torch.Tensor:
    axes = [(torch.arange(n, device=device) >= 1)
            & (torch.arange(n, device=device) <= n - 2) for n in shape]
    return axes[0][:, None, None] & axes[1][None, :, None] \
        & axes[2][None, None, :]


def _gather27(flat: torch.Tensor, base: torch.Tensor, YX: int,
              X: int) -> torch.Tensor:
    """(P, 27) neighbourhood values around flat base indices, raster
    order of a (3, 3, 3) reshape; indices clamp like `take(mode="clip")`."""
    offs = torch.tensor([dz * YX + dy * X + dx
                         for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                         for dx in (-1, 0, 1)], device=base.device)
    idx = (base[:, None] + offs[None, :]).clamp(0, flat.shape[0] - 1)
    return flat[idx.reshape(-1)].reshape(-1, 27)


def _segmented_compact_topk(score: torch.Tensor, k: int, seg: int = 512,
                            rounds: int = 4):
    """Exact top-k (values descending, ties by index) of a sparse score
    field whose non-candidates are -inf.

    The field is seen as (S, seg) segments; `segment_topk` extracts each
    segment's `rounds` largest entries (first index among equal values,
    masking by index) and counts its finite entries. If no segment holds
    more than `rounds` candidates, every candidate survived and a sort of
    the S * rounds survivors gives the answer; otherwise (one synced flag)
    the whole field is sorted. The survivors are reordered to round-major,
    the reference's layout, so that value ties break in the same row
    order. Returns (vals (k,), idx (k,) int64)."""
    n = score.shape[0]
    S = -(-n // seg)
    padded = torch.full((S * seg,), -torch.inf, dtype=score.dtype,
                        device=score.device)
    padded[:n] = score
    if k > rounds * S:  # extraction cannot retain k candidates
        return top_k(padded, k)
    va, ia, counts = segment_topk(padded.view(S, seg), rounds)
    if bool((counts > rounds).any()):
        return top_k(padded, k)
    va = va.T.reshape(-1)
    ia = ia.T.reshape(-1).long()
    v2, sel = top_k(va, k)
    return v2, ia[sel]


def candidate_score(dog: torch.Tensor, threshold: float,
                    find_minima: bool = False) -> torch.Tensor:
    """The flat sparse score field of peak selection: |DoG| where a voxel
    equals its 3x3x3 max (or min), is above threshold and off the border;
    -inf elsewhere."""
    cand = dog >= _pool3(dog)
    if find_minima:
        cand |= dog <= _pool3(dog, minimum=True)
    cand &= (dog.abs() >= threshold) & _interior_mask(dog.shape, dog.device)
    return torch.where(cand, dog.abs(),
                       torch.full_like(dog, -torch.inf)).reshape(-1)


def _select_candidates(dog: torch.Tensor, threshold: float, max_peaks: int,
                       find_minima: bool):
    """Top-`max_peaks` candidate rows by |response|: (idx (P,) flat,
    clamped into the field, valid (P,), candidate count)."""
    n = dog.numel()
    k = min(max_peaks, n)
    vals, idx = _segmented_compact_topk(
        candidate_score(dog, threshold, find_minima), k)
    if k < max_peaks:
        vals = F.pad(vals, (0, max_peaks - k), value=-torch.inf)
        idx = F.pad(idx, (0, max_peaks - k))
    valid = (vals >= threshold) & torch.isfinite(vals)
    cand_count = valid.sum(dtype=torch.int32)
    return idx.clamp(0, n - 1), valid, cand_count


def _strict(nb: torch.Tensor, find_minima: bool) -> torch.Tensor:
    center = nb[:, 13]
    others = torch.cat([nb[:, :13], nb[:, 14:]], dim=1)
    s = (center[:, None] > others).all(dim=1)
    if find_minima:
        s |= (center[:, None] < others).all(dim=1)
    return s


def _unravel(idx: torch.Tensor, shape) -> torch.Tensor:
    _, y, x = shape
    return torch.stack([idx // (y * x), (idx // x) % y, idx % x], dim=-1)


def find_peaks(dog: torch.Tensor, threshold: float, max_peaks: int = 4096,
               find_minima: bool = False, return_count: bool = False):
    """Top-`max_peaks` strict extrema with |response| >= threshold.

    Returns (coords (P, 3) int32, response (P,), valid (P,) bool), invalid
    rows zero; with `return_count`, also the pre-strictness candidate
    count (all valid rows lie within the first `count` rows)."""
    z, y, x = dog.shape
    flat = dog.reshape(-1)
    idx, valid, cand_count = _select_candidates(dog, threshold, max_peaks,
                                                find_minima)
    valid = valid & _strict(_gather27(flat, idx, y * x, x), find_minima)
    coords = _unravel(idx, dog.shape).to(torch.int32)
    coords = torch.where(valid[:, None], coords, torch.zeros_like(coords))
    resp = torch.where(valid, flat[idx], torch.zeros_like(flat[idx]))
    if return_count:
        return coords, resp, valid, cand_count
    return coords, resp, valid


def _step_mask(off: torch.Tensor, v: torch.Tensor,
               max_offset: float) -> torch.Tensor:
    s = torch.where(off.abs() > max_offset, torch.sign(off),
                    torch.zeros_like(off)).to(torch.int64)
    return s * v[:, None].to(torch.int64)


def _clip(c: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return torch.minimum(c.clamp(min=1), hi)


def _refine_from(dog, c0, valid, first, max_iterations, max_offset,
                 compact_budget=None):
    """The re-centering loop of `subpixel_localize`, seeded with a
    precomputed first fit (off, val) at c0 — the fused detection path
    reuses the strictness gather as the first fit.

    Rows are independent, and a row whose first fit does not step is
    idempotent under refits, so when at most `compact_budget` rows step
    the walk runs on those rows only and writes them back; otherwise on
    all rows. Both give the same result."""
    z, y, x = dog.shape
    flat = dog.reshape(-1)
    YX = y * x
    hi = torch.tensor([z - 2, y - 2, x - 2], device=dog.device)

    def walk(c, off, val, v):
        moved = bool((_step_mask(off, v, max_offset) != 0).any())
        i = 1
        while i < max_iterations and moved:
            base = c[:, 0] * YX + c[:, 1] * x + c[:, 2]
            off, val = _quadratic_step_batched(_gather27(flat, base, YX, x))
            c2 = _clip(c + _step_mask(off, v, max_offset), hi)
            moved = bool((c2 != c).any())
            c = c2
            i += 1
        return c, off, val

    off0, val0 = first
    c0 = _clip(c0.long(), hi)
    c1 = _clip(c0 + _step_mask(off0, valid, max_offset), hi)

    B = compact_budget
    rows = None
    if B is not None and B < c0.shape[0]:
        need = (c1 != c0).any(dim=1)
        if int(need.sum()) <= B:
            rows = need.nonzero()[:, 0]
    if rows is None:
        c, off, val = walk(c1, off0, val0, valid)
    else:
        c, off, val = c1.clone(), off0.clone(), val0.clone()
        c[rows], off[rows], val[rows] = walk(c1[rows], off0[rows],
                                             val0[rows], valid[rows])
    return _finish(dog, c, off, val, valid)


def _finish(dog, c, off, val, valid):
    """Positions, values and validity of the settled fits: a fit whose
    offset stays >= 1 voxel or that lies outside the volume is invalid."""
    pos = c.to(dog.dtype) + off
    shape = torch.tensor(dog.shape, dtype=dog.dtype, device=dog.device)
    ok = valid & (off.abs() < 1.0).all(dim=-1) & (
        (pos >= 0) & (pos <= shape - 1.0)).all(dim=-1)
    pos = torch.where(ok[:, None], pos, torch.zeros_like(pos))
    val = torch.where(ok, val, torch.zeros_like(val))
    return pos, val, ok


def find_peaks_localized(dog: torch.Tensor, threshold: float,
                         max_peaks: int, find_minima: bool = False,
                         max_iterations: int = 4, max_offset: float = 0.5):
    """Fused `find_peaks` + `subpixel_localize`: one 27-neighbourhood
    gather serves the strictness check and the first quadratic fit.
    Returns (pos (P, 3), val (P,), ok (P,), cand_count)."""
    z, y, x = dog.shape
    flat = dog.reshape(-1)
    idx, valid, cand_count = _select_candidates(dog, threshold, max_peaks,
                                                find_minima)
    nb = _gather27(flat, idx, y * x, x)
    valid = valid & _strict(nb, find_minima)
    first = _quadratic_step_batched(nb)
    pos, val, ok = _refine_from(dog, _unravel(idx, dog.shape), valid, first,
                                max_iterations, max_offset,
                                compact_budget=256)
    return pos, val, ok, cand_count


def _quadratic_step_batched(nb: torch.Tensor):
    """Batched Newton step on (P, 27) 3x3x3 neighbourhoods: gradient by
    central differences, Hessian by the 27-point stencils, offset
    = -H^-1 g through the closed-form adjugate of the symmetric 3x3."""
    nb = nb.reshape(nb.shape[0], 3, 3, 3)
    c = nb[:, 1, 1, 1]
    gz = 0.5 * (nb[:, 2, 1, 1] - nb[:, 0, 1, 1])
    gy = 0.5 * (nb[:, 1, 2, 1] - nb[:, 1, 0, 1])
    gx = 0.5 * (nb[:, 1, 1, 2] - nb[:, 1, 1, 0])
    hzz = nb[:, 2, 1, 1] - 2 * c + nb[:, 0, 1, 1]
    hyy = nb[:, 1, 2, 1] - 2 * c + nb[:, 1, 0, 1]
    hxx = nb[:, 1, 1, 2] - 2 * c + nb[:, 1, 1, 0]
    hzy = 0.25 * (nb[:, 2, 2, 1] - nb[:, 2, 0, 1]
                  - nb[:, 0, 2, 1] + nb[:, 0, 0, 1])
    hzx = 0.25 * (nb[:, 2, 1, 2] - nb[:, 2, 1, 0]
                  - nb[:, 0, 1, 2] + nb[:, 0, 1, 0])
    hyx = 0.25 * (nb[:, 1, 2, 2] - nb[:, 1, 0, 2]
                  - nb[:, 1, 2, 0] + nb[:, 1, 0, 0])
    hzz = hzz + 1e-12
    hyy = hyy + 1e-12
    hxx = hxx + 1e-12
    A = hyy * hxx - hyx * hyx
    B = hyx * hzx - hzy * hxx
    C = hzy * hyx - hyy * hzx
    det = hzz * A + hzy * B + hzx * C
    det = torch.where(det.abs() < 1e-30, torch.full_like(det, 1e-30), det)
    E = hzz * hxx - hzx * hzx
    Fc = hzy * hzx - hzz * hyx
    I = hzz * hyy - hzy * hzy  # noqa: E741
    oz = -(A * gz + B * gy + C * gx) / det
    oy = -(B * gz + E * gy + Fc * gx) / det
    ox = -(C * gz + Fc * gy + I * gx) / det
    off = torch.stack([oz, oy, ox], dim=-1)
    g = torch.stack([gz, gy, gx], dim=-1)
    val = c + 0.5 * (g * off).sum(dim=-1)
    return off, val


def subpixel_localize(dog: torch.Tensor, coords: torch.Tensor,
                      valid: torch.Tensor, max_iterations: int = 4,
                      max_offset: float = 0.5):
    """Iteratively re-centered quadratic refinement (batched over peaks):
    while any |offset| component exceeds `max_offset` the integer center
    moves one voxel that way and the fit repeats (at most
    `max_iterations` fits); invalid rows are frozen. Fits whose offset
    stays >= 1 voxel or that land outside the volume are invalid."""
    z, y, x = dog.shape
    flat = dog.reshape(-1)
    YX = y * x
    hi = torch.tensor([z - 2, y - 2, x - 2], device=dog.device)
    c = _clip(coords.long(), hi)
    off = torch.zeros((c.shape[0], 3), dtype=dog.dtype, device=dog.device)
    val = torch.zeros((c.shape[0],), dtype=dog.dtype, device=dog.device)
    for _ in range(max_iterations):
        base = c[:, 0] * YX + c[:, 1] * x + c[:, 2]
        off, val = _quadratic_step_batched(_gather27(flat, base, YX, x))
        c2 = _clip(c + _step_mask(off, valid, max_offset), hi)
        moved = bool((c2 != c).any())
        c = c2
        if not moved:
            break
    return _finish(dog, c, off, val, valid)
