"""Phase correlation for translation initialization.

Port of the reference's `ops/phase_correlation.py` (the stitching
initializer): the normalized cross-power spectrum's peak gives the
integer shift between two volumes; a 3x3x3 quadratic fit (the detection
sub-pixel step, `ops.extrema._quadratic_step_batched`) refines it. Two
rfftns, one irfftn and a top-k on `torch.fft`; the wrap-around
disambiguation runs on the host, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from spim_registration_tpu_torch.ops.extrema import _quadratic_step_batched
from spim_registration_tpu_torch.ops.topk import top_k
from spim_registration_tpu_torch.utils.device import resolve_device


def _pcm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    cross = torch.fft.rfftn(a) * torch.conj(torch.fft.rfftn(b))
    cross = cross / torch.clamp(torch.abs(cross), min=1e-12)
    return torch.fft.irfftn(cross, s=a.shape)


def phase_correlation_shift(a: np.ndarray, b: np.ndarray,
                            num_peaks: int = 5, subpixel: bool = True,
                            device=None):
    """Estimate the translation t such that b(x) ~= a(x - t).

    Checks the `num_peaks` strongest correlation peaks under each of the
    2^3 wrap-around interpretations and returns the one maximizing the
    real overlap correlation. Returns (shift (3,) float, peak_correlation
    float). `device`: default CUDA; "cpu" runs on the host."""
    dev = resolve_device(device)
    an = np.asarray(a, np.float32)
    bn = np.asarray(b, np.float32)
    pcm = _pcm(torch.from_numpy(an).to(dev), torch.from_numpy(bn).to(dev))
    vals, idx = top_k(pcm.reshape(-1), num_peaks)
    shape = np.asarray(an.shape)
    coords = np.stack(np.unravel_index(idx.cpu().numpy(), an.shape), axis=-1)

    best = None
    for c in coords:
        for alt in _wrap_alternatives(c, shape):
            score = _overlap_corr(an, bn, alt)
            if best is None or score > best[1]:
                best = (alt.astype(np.float64), score)
    shift, score = best

    if subpixel:
        # quadratic refine around the strongest peak (wrap neighbours)
        c = coords[0]
        padded = F.pad(pcm[None, None], (1, 1) * 3, mode="circular")[0, 0]
        nb = padded[c[0]:c[0] + 3, c[1]:c[1] + 3, c[2]:c[2] + 3]
        off, _val = _quadratic_step_batched(nb.reshape(1, 27))
        shift = shift + np.clip(off[0].cpu().numpy(), -1.0, 1.0)
    return shift, float(score)


def _wrap_alternatives(c, shape):
    outs = []
    for mask in range(8):
        alt = c.astype(np.int64).copy()
        for d in range(3):
            if mask >> d & 1:
                alt[d] = alt[d] - shape[d]
        outs.append(alt)
    return outs


def _overlap_corr(a: np.ndarray, b: np.ndarray, shift) -> float:
    """Correlation of a and b over the overlap implied by integer shift
    (b shifted by +shift aligns with a)."""
    s = np.round(shift).astype(int)
    sl_a, sl_b = [], []
    for d in range(3):
        if s[d] >= 0:
            n = a.shape[d] - s[d]
            if n <= 2:
                return -np.inf
            sl_a.append(slice(s[d], s[d] + n))
            sl_b.append(slice(0, n))
        else:
            n = a.shape[d] + s[d]
            if n <= 2:
                return -np.inf
            sl_a.append(slice(0, n))
            sl_b.append(slice(-s[d], -s[d] + n))
    aa = a[tuple(sl_a)].ravel()
    bb = b[tuple(sl_b)].ravel()
    if aa.std() < 1e-9 or bb.std() < 1e-9:
        return -np.inf
    n_vox = aa.size
    if n_vox < 27:
        return -np.inf
    r = float(np.corrcoef(aa, bb)[0, 1])
    # weight by overlap size a little so tiny overlaps don't win on noise
    return r * min(1.0, n_vox / (0.05 * a.size))


def translation_from_shift(shift) -> np.ndarray:
    """(3,4) affine moving view B onto A given the phase-corr shift."""
    return np.concatenate([np.eye(3), np.asarray(shift, float)[:, None]],
                          axis=1)
