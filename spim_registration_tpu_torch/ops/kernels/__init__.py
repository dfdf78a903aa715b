"""Hand-written CUDA kernels (sources in `spim_registration_tpu_torch/csrc/`)."""
