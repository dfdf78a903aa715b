"""Geometric transform models: affine utilities, closed-form batched fits
of translation / rigid / similarity / affine models, and RANSAC."""

from spim_registration_tpu_torch.models.affine import (  # noqa: F401
    MODEL_MIN_POINTS,
    apply_affine,
    compose,
    fit_affine,
    fit_model,
    fit_regularized,
    fit_rigid,
    fit_similarity,
    fit_translation,
    identity_affine,
    invert_affine,
    matrix_4x4,
    residuals,
)
from spim_registration_tpu_torch.models.ransac import (  # noqa: F401
    RansacParameters,
    RansacResult,
    filter_ransac,
    filter_ransac_batched,
)
