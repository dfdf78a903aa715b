"""Carry state into the port from plain numpy arrays and from the
reference's parameter objects.

The reference package keeps its state in JAX arrays; `np.asarray` turns
them into numpy (bf16 arrays arrive with the `bfloat16` numpy dtype of
`ml_dtypes`). These functions build the port's counterparts from such
arrays, and the port's parameter dataclasses from the reference's (read
field by field, by name), without importing the reference — so a test
can run both packages on bit-identical inputs and one configuration.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from spim_registration_tpu_torch.deconv.prep import DeconvolutionViews
from spim_registration_tpu_torch.detect.dog import DoGParameters
from spim_registration_tpu_torch.match.pairwise import PairwiseParameters
from spim_registration_tpu_torch.models.ransac import RansacParameters
from spim_registration_tpu_torch.pipeline.run import RegistrationConfig
from spim_registration_tpu_torch.solve.global_opt import GlobalOptParameters
from spim_registration_tpu_torch.utils.device import resolve_device


def tensor_from_numpy(arr, device=None) -> torch.Tensor:
    """numpy -> tensor on `device`, keeping the dtype; numpy bfloat16
    (ml_dtypes) arrives as torch.bfloat16 bit for bit."""
    dev = resolve_device(device)
    a = np.array(arr, order="C")   # a writable copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def views_from_numpy(images, weights, psfs, osem_factor, psf_factors=None,
                     device=None) -> DeconvolutionViews:
    """The port's `DeconvolutionViews` from (V, Z, Y, X) numpy images and
    weights, per-view numpy PSFs and optional CP factor banks."""
    return DeconvolutionViews(
        images=tensor_from_numpy(np.asarray(images, np.float32), device),
        weights=tensor_from_numpy(np.asarray(weights, np.float32), device),
        psfs=[np.asarray(p, np.float32) for p in psfs],
        osem_factor=float(osem_factor),
        psf_factors=psf_factors,
    )


def lowrank_entries_from_numpy(entries, device=None) -> tuple:
    """The port's lowrank kernel entries from the reference runner's
    `k1_ffts` / `k2_ffts` entries with their arrays as numpy:

      {"mat": (Mz, My, Mx)} with the leading phase axis, plus "rad" (the
        per-axis half-supports, a tuple or an object holding it in
        `.value`) -> {"mat": tensors in the same dtype, "rad": tuple};
      {"fft": spectrum} -> {"fft": complex tensor}. A spectrum is bound to
        the FFT shape it was made for: give the runner that shape too.
    """
    out = []
    for e in entries:
        if "mat" in e:
            rad = e["rad"]
            rad = tuple(int(r) for r in getattr(rad, "value", rad))
            out.append({"mat": tuple(tensor_from_numpy(m, device)
                                     for m in e["mat"]),
                        "rad": rad})
        elif "fft" in e:
            out.append({"fft": tensor_from_numpy(e["fft"], device)})
        else:
            raise ValueError(f"unknown lowrank entry keys {sorted(e)}")
    return tuple(out)


def _fields(cls, obj, **nested):
    """An instance of the port's dataclass `cls` with each field read by
    name from `obj` (the reference's counterpart); `nested` maps a field
    name to the converter of its value."""
    return cls(**{f.name: nested.get(f.name, lambda v: v)(
        getattr(obj, f.name)) for f in dataclasses.fields(cls)})


def dog_parameters(obj) -> DoGParameters:
    return _fields(DoGParameters, obj)


def ransac_parameters(obj) -> RansacParameters:
    return _fields(RansacParameters, obj)


def pairwise_parameters(obj) -> PairwiseParameters:
    return _fields(PairwiseParameters, obj, ransac=ransac_parameters)


def global_opt_parameters(obj) -> GlobalOptParameters:
    return _fields(GlobalOptParameters, obj)


def registration_config(obj) -> RegistrationConfig:
    return _fields(RegistrationConfig, obj, detection=dog_parameters,
                   pairwise=pairwise_parameters,
                   global_opt=global_opt_parameters)
