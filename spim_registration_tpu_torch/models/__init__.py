"""Affine transform utilities (the fits come with the matching slice)."""

from spim_registration_tpu_torch.models.affine import (  # noqa: F401
    apply_affine,
    compose,
    identity_affine,
    invert_affine,
    matrix_4x4,
)
