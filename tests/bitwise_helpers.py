"""Helpers shared by the RL view-update tests (`test_torch_rl_update.py`,
`test_torch_mesh_engine.py`): bit-for-bit comparison of volumes, and a
PSF that no low rank reproduces.

Imported by its bare name (pytest puts `tests/` on `sys.path`), so the
files that use it still run alone with `--noconftest` on a machine with a
card and no JAX. Imports neither jax nor the reference."""

import numpy as np
import torch


def _bits(t):
    """A tensor's bit patterns, so that NaNs and signed zeros compare."""
    t = t.contiguous()
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def assert_bitwise(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    same = _bits(got) == _bits(want)
    assert bool(same.all()), (
        f"{int((~same).sum())} of {same.numel()} differ, first at "
        f"{tuple(int(i) for i in torch.nonzero(~same)[0])}")


def _rotated_gaussian(shape, sigmas, angle_deg):
    """A Gaussian turned about y: a PSF that no low rank reproduces."""
    t = np.deg2rad(angle_deg)
    R = np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0],
                  [-np.sin(t), 0, np.cos(t)]])
    Ci = np.linalg.inv(R @ np.diag(np.square(sigmas)) @ R.T)
    X = np.stack(np.meshgrid(*[np.arange(s) - s // 2 for s in shape],
                             indexing="ij"), -1).astype(float)
    k = np.exp(-0.5 * np.einsum("...i,ij,...j->...", X, Ci, X))
    return (k / k.sum()).astype(np.float32)
