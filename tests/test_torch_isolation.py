"""The port's boundaries: it imports without JAX and without the reference
package, its entry points refuse to run on the host unless asked to, and
(on a CUDA card only) each hand-written kernel matches its plain version.

This file imports neither jax nor the reference, so on a machine with a
card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_isolation.py
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spim_registration_tpu_torch.ops.kernels import build
from spim_registration_tpu_torch.ops.kernels import lowrank_conv as lc
from spim_registration_tpu_torch.ops.kernels import segtopk as st

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now fails
import spim_registration_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
leaked = sorted(m for m in sys.modules
                if m == "spim_registration_tpu"
                or m.startswith("spim_registration_tpu."))
assert not leaked, leaked
assert "jax" not in [m.split(".")[0] for m in sys.modules
                     if sys.modules[m] is not None]
print(len(names))
"""


def test_port_imports_without_jax_or_reference():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_entry_points_refuse_to_run_without_cuda(monkeypatch):
    """With no card, every entry point called without `device` raises
    instead of running on the host."""
    from spim_registration_tpu_torch.convert import views_from_numpy
    from spim_registration_tpu_torch.core.dataset import BoundingBox
    from spim_registration_tpu_torch.deconv import (
        DeconvolutionRunner,
        deconvolve,
        extract_psf,
        prepare_views_for_deconvolution,
    )
    from spim_registration_tpu_torch.detect import (
        detect_beads,
        detect_beads_batch,
    )
    from spim_registration_tpu_torch.fuse import fuse_views
    from spim_registration_tpu_torch.match import (
        match_pair,
        match_pairs_batched,
    )
    from spim_registration_tpu_torch.pipeline import register_views
    from spim_registration_tpu_torch.solve import (
        GlobalOptParameters,
        PairMatches,
        solve_global,
    )
    from spim_registration_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol = np.ones((8, 8, 8), np.float32)
    ident = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    psf = np.ones((3, 3, 3), np.float32) / 27
    bbox = BoundingBox("b", (0, 0, 0), (8, 8, 8))
    prep = views_from_numpy(vol[None], vol[None], [psf], 1.0, device="cpu")
    pts = np.random.default_rng(0).uniform(0, 8, (10, 3)).astype(np.float32)
    pm = [PairMatches(0, 1, pts, pts + 1.0)]
    calls = [
        lambda: resolve_device(None),
        lambda: resolve_device("cuda"),
        lambda: DeconvolutionRunner(prep),
        lambda: deconvolve(prep),
        lambda: fuse_views([vol], [ident], bbox),
        lambda: extract_psf(vol, ident, np.array([[4.0, 4.0, 4.0]])),
        lambda: prepare_views_for_deconvolution([vol], [ident], [psf], bbox),
        lambda: views_from_numpy(vol[None], vol[None], [psf], 1.0),
        lambda: detect_beads(vol),
        lambda: detect_beads_batch(vol[None]),
        lambda: match_pair(pts, pts),
        lambda: match_pairs_batched([pts, pts, pts], [(0, 1), (1, 2)]),
        lambda: solve_global(pm, [0], GlobalOptParameters(
            device_assembly=True)),
        lambda: register_views([vol, vol]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_sources_present():
    for name in build.SOURCES:
        src = build.SRC_DIR / f"{name}.cu"
        text = src.read_text()
        assert 'extern "C"' in text and "Replaces" in text


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernels_match_plain_on_cuda(dtype):
    """zpass (banded, dense, slab offset) and sl_rows on ragged shapes,
    and the fused conv against the plain chain, on the card."""
    _cuda_or_skip()
    from spim_registration_tpu_torch.ops.separable import (
        conv_lowrank_folded,
        folded_conv_matrices,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    dt = getattr(torch, dtype)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def close(got, want, rel):
        g, w = got.float(), want.float()
        err = float((g - w).abs().max())
        assert err <= rel * float(w.abs().max()) + 1e-30, err

    # one bf16 ULP of the output's scale (both sides round an f32 sum once)
    rel = 2.0 ** -7 if dt == torch.bfloat16 else 1e-5
    for (R, Z, Y, X, taps, s0) in ((3, 40, 20, 37, 9, 0),
                                   (2, 150, 33, 50, 7, 64),
                                   (2, 130, 65, 300, 19, 0)):
        az = rng.standard_normal((R, taps))
        Mz, My, Mx = (torch.from_numpy(M).to(dev).to(dt) for M in
                      folded_conv_matrices(az, az, az, (Z, Y, X)))
        vm = torch.from_numpy(rng.standard_normal((Z, Y, X))
                              .astype(np.float32)).to(dev).to(dt)
        rad = (taps - 1) // 2
        mzs = Mz[:, s0:].contiguous()
        n0, n1 = lc.zpass.launches, lc.sl_rows.launches
        want = lc.zpass_reference(mzs, vm)
        for wins in (lc.band_blocks(Z - s0, Z, rad, off=s0), None):
            close(lc.zpass(mzs, vm, wins), want, rel)
        a = lc.zpass_reference(Mz, vm)
        close(lc.sl_rows(a, My, Mx), lc.fused_sl_reference(a, My, Mx), rel)
        assert lc.zpass.launches == n0 + 2
        assert lc.sl_rows.launches == n1 + 1
        vol = torch.from_numpy(rng.random((Z, Y, X)).astype(np.float32)
                               ).to(dev)
        got = lc.conv_lowrank_folded_fused(vol, Mz, My, Mx, rad_z=rad)
        close(got, conv_lowrank_folded(vol, Mz, My, Mx),
              2.0 ** -6 if dt == torch.bfloat16 else 1e-5)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_segtopk_matches_plain_on_cuda():
    """segtopk against its plain version, exactly: sparse fields, equal
    values inside a segment, overflowing and all--inf segments, a ragged
    segment count, every supported width and round count."""
    _cuda_or_skip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    for seg, S, rounds in ((512, 1001, 4), (256, 77, 3), (128, 512, 6)):
        x = np.full((S, seg), -np.inf, np.float32)
        pos = rng.choice(S * seg, size=S * 3, replace=False)
        x.reshape(-1)[pos] = rng.integers(1, 6, S * 3) / 8.0   # many ties
        x[5, :9] = 0.5                                         # overflow
        x[7] = -np.inf                                         # all -inf
        x[9, ::7] = rng.random(len(x[9, ::7]))                 # dense row
        t = torch.from_numpy(x)
        want = st.segment_topk_reference(t, rounds)
        n0 = st.segment_topk.launches
        got = st.segment_topk(t.to(dev), rounds)
        assert st.segment_topk.launches == n0 + 1
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), (seg, S, rounds)
    with pytest.raises(ValueError, match="cannot take"):
        st.segment_topk(torch.zeros((4, 100), device=dev))
    with pytest.raises(ValueError, match="float32"):
        st.segment_topk(torch.zeros((4, 512), device=dev,
                                    dtype=torch.float64))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernel_wrappers_raise_on_unsupported_input():
    _cuda_or_skip()
    dev = torch.device("cuda")
    Mz = torch.zeros((2, 8, 8), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtype"):
        lc.zpass(Mz, torch.zeros((8, 4, 4), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        lc.zpass(Mz.transpose(1, 2), torch.zeros(
            (8, 4, 4), device=dev, dtype=torch.bfloat16))
    a = torch.zeros((2, 4, 4, 600), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cannot take"):
        lc.sl_rows(a, torch.zeros((2, 4, 4), device=dev,
                                  dtype=torch.bfloat16),
                   torch.zeros((2, 600, 600), device=dev,
                               dtype=torch.bfloat16))
