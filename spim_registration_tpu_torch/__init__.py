"""PyTorch/CUDA port of the multi-view SPIM reconstruction package.

The JAX package `spim_registration_tpu` is the reference; this package
reimplements its in-memory reconstruction on PyTorch: registration (DoG
bead detection -> descriptor matching + RANSAC -> global solve,
`pipeline.register_views`) and deconvolution (PSF extraction ->
deconvolution prep -> multi-view Richardson-Lucy, plus weighted-average
fusion), with hand-written CUDA kernels for the lowrank convolution
(`ops/kernels/lowrank_conv.py`) and the peak selection
(`ops/kernels/segtopk.py`); sources in `csrc/`.

Conventions are the reference's:
- volumes are indexed (z, y, x), view stacks (v, z, y, x);
- point coordinates are float (z, y, x) voxel units of the full-resolution
  view image;
- affine transforms are (3, 4) matrices mapping homogeneous (z, y, x, 1)
  view coordinates to world coordinates.

Entry points take a `device` argument that defaults to CUDA and raise when
no card is present, unless the caller asks for `device="cpu"`. The package
imports neither `jax` nor anything of `spim_registration_tpu`.
"""

__version__ = "0.1.0"
