"""The port's `fuse_views` against the benchmark's plain fusion reference
(benchmark/reference/fuse.py, the check of the fuse cell) on seeded
random views at a small size, on the CPU: an axis-aligned view beside
general affines and axis-aligned views alone, blending alone and with
content weights, a box inside the views and one that reaches past them.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_fuse_reference.py -q
"""

import numpy as np
import pytest
import torch

from benchmark.reference import fuse as ref
from spim_registration_tpu_torch.core.dataset import BoundingBox
from spim_registration_tpu_torch.fuse import (
    BlendingParameters,
    ContentBasedParameters,
    FusionParameters,
    fuse_views,
    maximal_bounding_box,
)
from spim_registration_tpu_torch.ops.resample import is_axis_aligned

torch.set_num_threads(2)

SHAPES = [(20, 24, 28), (22, 20, 26), (18, 26, 24)]
RANGE = (5.0, 6.0, 4.0)
BORDER = (0.0, 1.0, 0.5)


def _rotation(axis, deg):
    a = np.deg2rad(deg)
    c, s = np.cos(a), np.sin(a)
    i, j = [k for k in range(3) if k != axis]
    R = np.eye(3)
    R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
    return R


def _models(affine: bool) -> list:
    """View 0 fixed; the others shifted and scaled (axis-aligned) or
    turned about their centres (general affines)."""
    out = [np.concatenate([np.eye(3), np.zeros((3, 1))], 1)]
    for v, shape in enumerate(SHAPES[1:], start=1):
        if affine:
            R = _rotation(v, 17.0 * v) @ _rotation(0, 4.0)
            c = np.asarray(shape, np.float64) / 2
            t = c - R @ c + [1.5, -0.75, 2.25]
        else:
            R = np.diag([1.0, 0.9 + 0.15 * v, 1.1])
            t = np.array([1.5 * v, -2.0, 0.25 * v])
        out.append(np.concatenate([R, t[:, None]], 1))
    return out


CONTENT = {"blending": None, "content": (2.0, 4.0),
           "content_wider_than_views": (20.0, 40.0)}


@pytest.mark.parametrize("box", ["inside", "past_views"])
@pytest.mark.parametrize("weights", sorted(CONTENT))
@pytest.mark.parametrize("affine", [False, True], ids=["aligned", "affine"])
def test_fuse_views_matches_the_plain_reference(affine, weights, box):
    """Within 2e-6 where the reference's summed weight is 1e-2 or more
    (the port's float32 view coordinates, ulp 4e-6 at 30 px, and weights
    against the reference's float64 ones; values in [0, 1]), within 3e-5
    where it is less: there only blending ramps of 1e-2 or less weigh,
    their float32 relative error (the cosine of a small angle, the
    coordinate) reaches ~1e-5, and the quotient takes it times the views'
    difference, up to 1 on random views. The voxels the reference leaves
    out of its comparison (summed weight in (0, 1e-6), ramps within ~0.02
    px of a view's face: the float32 ramp has lost most of its digits and
    a voxel may fall on the other side of the 1e-9 cut, ROADMAP queue 3
    item 12) are named and not compared."""
    rng = np.random.default_rng(11)
    views = [rng.random(s, dtype=np.float32) for s in SHAPES]
    models = _models(affine)
    assert [is_axis_aligned(np.linalg.inv(np.vstack([m, [0, 0, 0, 1]]))[:3])
            for m in models] == [True] + [not affine] * 2
    lo, hi = ref.maximal_box(SHAPES[0], models[:1])
    if box == "past_views":
        lo, hi = ref.maximal_box(SHAPES[0], models)
        lo, hi = tuple(a - 3 for a in lo), tuple(b + 2 for b in hi)
    else:
        lo, hi = tuple(a + 3 for a in lo), tuple(b - 4 for b in hi)
    sig = CONTENT[weights]
    params = {"blending_range": RANGE, "border": BORDER,
              "use_content_based": sig is not None,
              "sigma1": sig and sig[0], "sigma2": sig and sig[1]}
    got = fuse_views(views, models, BoundingBox("b", lo, hi), FusionParameters(
        use_content_based=sig is not None,
        blending=BlendingParameters(border=BORDER, blending_range=RANGE),
        content=ContentBasedParameters(*(sig or (20.0, 40.0))), z_chunk=7),
        device="cpu")
    want, wsum = ref.Fusion(views, models, lo, hi, params, "cpu").slab(
        0, hi[0] - lo[0])
    want, wsum = want.numpy(), wsum.numpy()
    assert got.shape == want.shape
    left_out = (wsum > 0) & (wsum < ref.WEIGHT_FLOOR)
    apart = np.abs(got - want) > np.where(wsum >= 1e-2, 2e-6, 3e-5)
    assert not (apart & ~left_out).any(), np.argwhere(apart & ~left_out)
    assert left_out.sum() < 0.02 * left_out.size
    cmp = ref.Comparison(0.02)
    cmp.add(torch.from_numpy(got), torch.from_numpy(want),
            torch.from_numpy(wsum))
    assert cmp.numbers()["max_err"] < 3e-5 / float(want.max() - want.min())


def test_maximal_box_is_the_ports():
    shapes = [SHAPES[0]] * 3
    for affine in (False, True):
        models = _models(affine)
        box = maximal_bounding_box(shapes, models)
        assert ref.maximal_box(SHAPES[0], models) == (tuple(box.min),
                                                      tuple(box.max))


def test_mirror_blur_matches_the_ports_at_every_width():
    """The reference's float64 FFT blur with periodic reflection against
    the port's banded matmul with repeated mirror padding, for a
    half-width below, at and past the axis length."""
    from spim_registration_tpu_torch.ops.gaussian import gaussian_blur_3d

    vol = torch.from_numpy(np.random.default_rng(3).random(
        (9, 13, 17), dtype=np.float32))
    for sigma in (1.0, 4.0, 5.5, 20.0):
        want = gaussian_blur_3d(vol, (sigma,) * 3)
        got = ref.blur_3d(vol, sigma)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
