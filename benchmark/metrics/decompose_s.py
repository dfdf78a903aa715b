"""Seconds of CP decomposition and conv-matrix staging in one staging of a
`DeconvolutionRunner`: its `spim/deconv.decompose` spans (each kernel's
decomposition, folded matrices, dither stack and upload;
`utils/profiling.py`) over the process's stagings; nothing to read where
no kernel was decomposed."""


def read(trace):
    from spim_registration_tpu_torch.utils import profiling

    read_spans = getattr(profiling, "read_spans", None)
    if read_spans is None:
        return None
    totals = read_spans()["totals"]
    stage = totals.get("spim/deconv.stage")
    dec = totals.get("spim/deconv.decompose")
    if not stage or not stage["count"] or not dec or not dec["count"]:
        return None
    return dec["host_s"] / stage["count"]
