"""Multi-view Richardson-Lucy deconvolution."""

from spim_registration_tpu_torch.deconv.lucy_richardson import (  # noqa: F401
    DeconvolutionParameters,
    DeconvolutionRunner,
    PSFType,
    compound_kernels,
    deconvolve,
)
from spim_registration_tpu_torch.deconv.prep import (  # noqa: F401
    DeconvolutionViews,
    prepare_views_for_deconvolution,
)
from spim_registration_tpu_torch.deconv.psf import (  # noqa: F401
    condition_psf,
    extract_psf,
    gaussian_psf,
)
from spim_registration_tpu_torch.deconv.prep_streamed import (  # noqa: F401
    prepare_views_streamed,
)
from spim_registration_tpu_torch.deconv.blocked import (  # noqa: F401
    ArrayStore,
    BlockedDeconvolutionInputs,
    BlockedDeconvolutionRunner,
)
