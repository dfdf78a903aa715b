"""The port's boundaries: it imports without JAX and without the reference
package, its entry points refuse to run on the host unless asked to, and
(on a CUDA card only) each hand-written kernel matches its plain version.

This file imports neither jax nor the reference, so on a machine with a
card and no JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_isolation.py
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from spim_registration_tpu_torch.ops.kernels import build
from spim_registration_tpu_torch.ops.kernels import dog as kd
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
    from spim_registration_tpu_torch.pipeline.timelapse import (
        register_timeseries,
    )
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
        lambda: register_timeseries({0: [vol, vol]}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


_NEW_MODULES = ("cli", "core.dataset", "core.xml_io", "core.imgloaders",
                "utils.manifest", "ops.integral", "detect.dom", "detect.dog",
                "ops.resample", "fuse.bounding_box", "fuse.weighted_avg",
                "pipeline.config", "convert", "ops.kernels.dog",
                "ops.kernels.lowrank_conv", "ops.kernels.rl_update",
                "native_blocks",
                "deconv.blocked", "deconv.prep_streamed", "fuse.streaming",
                "match.centerofmass", "match.icp", "ops.phase_correlation",
                "pipeline.phase_init", "detect.tune",
                "solve.optimization_types", "pipeline.tools",
                "pipeline.timelapse", "pipeline.cluster", "utils.log",
                "utils.profiling", "core.define", "core.czi",
                "core.micromanager", "core.dhm", "core.zarr_store",
                "core.resave", "parallel", "parallel.mesh",
                "parallel.halo", "parallel.sharded",
                "parallel.sharded_detect", "parallel.multihost")

_IMPORT_NEW = r"""
import importlib, sys
sys.modules["jax"] = None
sys.modules["imageio"] = None      # the card's machine has none of these
sys.modules["h5py"] = None
sys.modules["tensorstore"] = None
for n in sys.argv[1:]:
    importlib.import_module("spim_registration_tpu_torch." + n)
from spim_registration_tpu_torch import cli
args = cli.build_parser().parse_args(["detect", "d.xml", "--method", "dom"])
assert args.device == "cuda" and args.fn is cli.cmd_detect
assert not [m for m in sys.modules if m.startswith("spim_registration_tpu.")]
print("ok")
"""


@pytest.mark.parametrize("module", _NEW_MODULES)
def test_cli_path_modules_import_without_jax(module):
    """Each module of the CLI path (and of kernels #5/#6) imports with jax,
    imageio, h5py and tensorstore blocked, and the CLI parses its verbs."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_NEW, module],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


_RAW_STORES = r"""
import sys
for m in ("jax", "imageio", "h5py", "tensorstore"):
    sys.modules[m] = None
import numpy as np
from spim_registration_tpu_torch.core.zarr_store import (
    create_volume, open_volume)
vol = np.arange(40 * 36 * 28, dtype=np.float32).reshape(40, 36, 28)
for driver in ("zarr", "n5"):
    path = sys.argv[1] + "/v." + driver
    v = create_volume(path, vol.shape, chunks=(16, 16, 16), driver=driver)
    v.write(vol)
    v.write_block((13, 30, 20), -vol[:5, :6, :8])
    want = vol.copy()
    want[13:18, 30:36, 20:28] = -vol[:5, :6, :8]
    assert np.array_equal(open_volume(path, driver).read(), want), driver
print("ok")
"""


def test_raw_zarr_and_n5_round_trip_without_optional_packages(tmp_path):
    """zarr and n5 need nothing beyond numpy: a round trip with a partial
    block write, with jax, imageio, h5py and tensorstore blocked."""
    out = subprocess.run([sys.executable, "-c", _RAW_STORES, str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "ok"


def test_format_entry_points_refuse_to_run_without_cuda(monkeypatch,
                                                         tmp_path):
    """The pyramids of `resave` run on the card unless the CPU is named
    (HDF5's go through the same `_pyramid`; h5py is absent on the card's
    machine, where this file also runs)."""
    from spim_registration_tpu_torch import cli
    from spim_registration_tpu_torch.core.dataset import (
        Dataset,
        ViewDescription,
    )
    from spim_registration_tpu_torch.core.imgloaders import memory_loader
    from spim_registration_tpu_torch.core.zarr_store import (
        _mipmap_levels,
        _pyramid,
        resave_n5_bdv,
        resave_zarr,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol = np.ones((8, 8, 8), np.float32)
    ds = Dataset(base_path=str(tmp_path),
                 loader=memory_loader({(0, 0): vol}))
    ds.add_view(ViewDescription(view_id=(0, 0), size=(8, 8, 8)))
    np.save(tmp_path / "tp0_setup0.npy", vol)
    assert cli.main(["define", str(tmp_path)]) == 0
    for call in (lambda: next(_pyramid(vol, _mipmap_levels(vol.shape),
                                       np.float32)),
                 lambda: resave_zarr(ds, str(tmp_path / "z")),
                 lambda: resave_n5_bdv(ds, str(tmp_path / "n")),
                 lambda: cli.main(["resave", str(tmp_path / "dataset.xml"),
                                   "--format", "zarr"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_cli_path_entry_points_refuse_to_run_without_cuda(monkeypatch,
                                                          tmp_path):
    from spim_registration_tpu_torch import cli
    from spim_registration_tpu_torch.core.dataset import (
        Dataset,
        ViewDescription,
    )
    from spim_registration_tpu_torch.core.imgloaders import memory_loader
    from spim_registration_tpu_torch.core.xml_io import save_dataset
    from spim_registration_tpu_torch.detect import (
        detect_beads_dataset,
        detect_beads_dom,
    )
    from spim_registration_tpu_torch.fuse import fuse_dataset
    from spim_registration_tpu_torch.ops.resample import resample_affine_auto
    from spim_registration_tpu_torch.pipeline.tools import display_view

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol = np.ones((8, 8, 8), np.float32)
    ds = Dataset(base_path=str(tmp_path),
                 loader=memory_loader({(0, 0): vol}))
    ds.add_view(ViewDescription(view_id=(0, 0), size=(8, 8, 8)))
    np.save(tmp_path / "tp0_setup0.npy", vol)
    save_dataset(ds, str(tmp_path / "dataset.xml"))
    for call in (lambda: detect_beads_dataset(ds),
                 lambda: detect_beads_dom(vol),
                 lambda: fuse_dataset(ds, [(0, 0)]),
                 lambda: resample_affine_auto(vol, np.eye(3, 4), (4, 4, 4)),
                 lambda: display_view(ds, (0, 0)),
                 lambda: cli.main(["detect", str(tmp_path / "dataset.xml")]),
                 lambda: cli.main(["cluster-job",
                                   str(tmp_path / "dataset.xml"), "--tp",
                                   "0"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_out_of_core_and_extras_refuse_to_run_without_cuda(monkeypatch,
                                                          tmp_path):
    from spim_registration_tpu_torch.core.dataset import BoundingBox
    from spim_registration_tpu_torch.detect.tune import (
        suggest_threshold,
        sweep_detection,
    )
    from spim_registration_tpu_torch.match.icp import icp_refine
    from spim_registration_tpu_torch.ops.phase_correlation import (
        phase_correlation_shift,
    )
    from spim_registration_tpu_torch.pipeline.phase_init import (
        translation_init,
    )
    from spim_registration_tpu_torch.deconv.blocked import (
        ArrayStore,
        BlockedDeconvolutionInputs,
        BlockedDeconvolutionRunner,
    )
    from spim_registration_tpu_torch.deconv.prep_streamed import (
        prepare_views_streamed,
    )
    from spim_registration_tpu_torch.fuse.streaming import (
        fuse_views_streaming,
        streaming_content_lowres,
    )
    from spim_registration_tpu_torch.fuse.weights import (
        ContentBasedParameters,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vol = np.ones((8, 8, 8), np.float32)
    ident = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    psf = np.ones((3, 3, 3), np.float32) / 27
    bbox = BoundingBox("b", (0, 0, 0), (8, 8, 8))
    inputs = BlockedDeconvolutionInputs([ArrayStore(vol)], [ArrayStore(vol)],
                                        [psf], 1.0)
    for call in (
            lambda: BlockedDeconvolutionRunner(inputs, ArrayStore(vol)),
            lambda: prepare_views_streamed(lambda v: vol, [ident], [psf],
                                           bbox, str(tmp_path / "p")),
            lambda: fuse_views_streaming([ArrayStore(vol)], [ident], bbox,
                                         ArrayStore(vol)),
            lambda: streaming_content_lowres(ArrayStore(vol),
                                             ContentBasedParameters()),
            lambda: icp_refine(vol[0], vol[0]),
            lambda: phase_correlation_shift(vol, vol),
            lambda: translation_init([vol, vol]),
            lambda: sweep_detection(vol),
            lambda: suggest_threshold(vol)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_mesh_refuses_to_run_without_cuda(monkeypatch):
    """A mesh over the cards (the default) raises without one; the CPU
    has to be named, as for every entry point."""
    from spim_registration_tpu_torch.parallel import (
        make_mesh,
        mesh_from_spec,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: make_mesh(), lambda: make_mesh(("z",), (1,)),
                 lambda: mesh_from_spec("z=2"),
                 lambda: mesh_from_spec("auto", "cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert mesh_from_spec("z=2", "cpu").shape == {"z": 2}


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
    """zpass (banded, dense, slab offset) and sl_rows (banded, dense) on
    ragged shapes, and the fused conv against the plain chain, on the
    card; then zpass alone at rank 1 and 48, ragged N, J % 8 != 0, dense
    windows at P = 300 (rows not 16-byte aligned) and P = 512 (the
    64-column instance), R x N over the grid's 65535, the main path's
    y * x through the TMA store, and the raise on a window no instance
    takes; then sl_rows alone, banded, on ragged Yo and Xo, Y not a
    multiple of 16, rank 1 and 48, ragged z-groups of four and of two
    slices (half-support 24) and X = 600, and windows wider than a block
    holds (dense planes up to 1300 x 64 and 128 x 600, a band of
    half-support 150), walked in pieces, through TMA loads and through
    cp.async copies."""
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
        d = (g - w).abs()
        err = float(d.max())
        assert err <= rel * float(w.abs().max()) + 1e-30, err
        # nrmse catches a fragment-layout or ring fault confined to a few
        # elements
        nrmse = float(torch.sqrt((d.double() ** 2).mean())
                      / (w.max() - w.min()))
        assert nrmse <= 1e-3, nrmse

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
        want = lc.fused_sl_reference(a, My, Mx)
        close(lc.sl_rows(a, My, Mx), want, rel)
        close(lc.sl_rows(a, My, Mx, rad, rad), want, rel)
        assert lc.zpass.launches == n0 + 2
        assert lc.sl_rows.launches == n1 + 2
        vol = torch.from_numpy(rng.random((Z, Y, X)).astype(np.float32)
                               ).to(dev)
        got = lc.conv_lowrank_folded_fused(vol, Mz, My, Mx, rad, rad, rad)
        close(got, conv_lowrank_folded(vol, Mz, My, Mx),
              2.0 ** -6 if dt == torch.bfloat16 else 1e-5)
    # (R, Z, Y, X, taps or None for the dense window, first slab row)
    for (R, Z, Y, X, taps, s0) in ((1, 128, 16, 64, 19, 0),
                                   (48, 256, 8, 64, 19, 0),
                                   (4, 100, 9, 24, 7, 0),
                                   (2, 70, 5, 7, 9, 0),
                                   (2, 300, 4, 40, None, 0),
                                   (1, 512, 2, 64, None, 0),
                                   (3, 256, 6, 33, 19, 96),
                                   (1100, 64, 2, 8, 19, 0)):
        az = rng.standard_normal((R, taps or 19))
        Mz = torch.from_numpy(folded_conv_matrices(az, az, az, (Z, 32, 32))[0]
                              if taps else rng.standard_normal((R, Z, Z))
                              ).to(dev).to(dt)[:, s0:].contiguous()
        vm = torch.from_numpy(rng.standard_normal((Z, Y, X))
                              .astype(np.float32)).to(dev).to(dt)
        wins = (lc.band_blocks(Z - s0, Z, (taps - 1) // 2, off=s0)
                if taps else None)
        n0 = lc.zpass.launches
        close(lc.zpass(Mz, vm, wins), lc.zpass_reference(Mz, vm), rel)
        assert lc.zpass.launches == n0 + 1, (R, Z, Y, X)
    if dt == torch.bfloat16:
        # the main path's y * x = 256^2 leaves through the TMA tensor map
        # (a map that cannot be built raises); J % 8 != 0 through threads
        az = rng.standard_normal((2, 19))
        Mz = torch.from_numpy(folded_conv_matrices(az, az, az, (256, 32, 32))
                              [0]).to(dev).to(dt)
        vm = torch.from_numpy(rng.random((256, 256, 256), dtype=np.float32)
                              ).to(dev).to(dt)
        a = lc.zpass(Mz, vm, lc.band_blocks(256, 256, 9))
        assert lc.zpass_tma_store(a)
        close(a, lc.zpass_reference(Mz, vm), rel)
        assert not lc.zpass_tma_store(torch.empty((2, 70, 5, 7), device=dev,
                                                  dtype=dt))
        Mz = torch.zeros((1, 64, 600), device=dev, dtype=dt)
        with pytest.raises(ValueError, match="cannot take"):
            lc.zpass(Mz, torch.zeros((600, 2, 8), device=dev, dtype=dt))
    # (R, Z, Y, X, taps, band windows or dense, whether bf16 takes the
    # TMA loads)
    for (R, Z, Y, X, taps, banded, tma) in (
            (1, 5, 100, 130, 19, True, False),
            (48, 4, 64, 64, 19, True, True),
            (3, 9, 256, 256, 19, True, True),
            (2, 3, 40, 600, 19, True, True),
            (2, 5, 128, 600, 19, True, True),
            (2, 5, 256, 256, 49, True, True),
            (4, 6, 200, 136, 7, True, True),
            # wider than a block holds: y in pieces of 256 ...
            (2, 3, 304, 336, 19, False, True),
            (2, 3, 300, 330, 19, False, False),
            (1, 2, 1300, 64, 19, False, False),
            (2, 2, 600, 600, 301, True, True),
            # ... and x in pieces of 64
            (3, 2, 128, 600, 19, False, True)):
        f = rng.standard_normal((R, taps)) * 0.3
        _, My, Mx = (torch.from_numpy(M).to(dev).to(dt) for M in
                     folded_conv_matrices(f, f, f, (8, Y, X)))
        a = torch.from_numpy(rng.standard_normal((R, Z, Y, X))
                             .astype(np.float32)).to(dev).to(dt)
        rad = (taps - 1) // 2 if banded else None
        if dt == torch.bfloat16:
            assert lc.sl_rows_tma_load(a, My, Mx) is tma
        n1 = lc.sl_rows.launches
        close(lc.sl_rows(a, My, Mx, rad, rad),
              lc.fused_sl_reference(a, My, Mx), rel)
        assert lc.sl_rows.launches == n1 + 1, (R, Z, Y, X)
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
    # more segments than the persistent grid has warps (a few thousand on
    # an H100), and a count that is no multiple of it: segments with 0,
    # 1, `rounds` and `rounds + 1` entries, ties at the count boundary
    S, seg, rounds = 3 * 8448 + 517, 512, 4
    x = np.full((S, seg), -np.inf, np.float32)
    count = rng.choice([0, 1, rounds, rounds + 1], size=S)
    for s in np.nonzero(count)[0]:
        x[s, rng.choice(seg, size=count[s], replace=False)] = \
            rng.integers(1, 3, count[s]) / 4
    x[S - 1] = rng.integers(0, 4, seg) / 4       # a dense last segment
    x[S - 2] = -np.inf                           # -0 before +0: a tie
    x[S - 2, [3, 300]] = -0.0
    x[S - 2, [7, 200]] = 0.0
    t = torch.from_numpy(x)
    want = st.segment_topk_reference(t, rounds)
    got = st.segment_topk(t.to(dev), rounds)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w), S
    # the values bit for bit: the sign of each zero too
    assert torch.equal(got[0].cpu().view(torch.int32),
                       want[0].view(torch.int32))
    assert got[1][S - 2].cpu().tolist() == [(S - 2) * seg + i
                                            for i in (3, 7, 200, 300)]
    with pytest.raises(ValueError, match="cannot take"):
        st.segment_topk(torch.zeros((4, 100), device=dev))
    with pytest.raises(ValueError, match="float32"):
        st.segment_topk(torch.zeros((4, 512), device=dev,
                                    dtype=torch.float64))
    torch.cuda.synchronize()


def _segtopk_first_port(x, rounds):
    """numpy transliteration of the first CUDA port of segtopk (one warp a
    segment, lane l holding positions (i >> 2) * 128 + 4 l + (i & 3)):
    per round a first-max scan of each lane's registers with `>`, a
    5-step xor butterfly in which the partner's (value, position) wins if
    larger or equal at a smaller position, lane 0's pair written, and
    every lane whose own winner it holds masks it. With a NaN in the
    segment these compares, not the contract, define the outcome."""
    S, seg = x.shape
    lane = np.arange(32)
    reg = np.arange(seg // 32)
    pos = (reg[None, :] >> 2) * 128 + lane[:, None] * 4 + (reg[None, :] & 3)
    vals = np.empty((S, rounds), np.float32)
    idx = np.empty((S, rounds), np.int32)
    counts = np.empty(S, np.int32)
    for s in range(S):
        v = x[s][pos].copy()
        counts[s] = int((v > -np.inf).sum())
        for r in range(rounds):
            best, bi = v[:, 0].copy(), np.zeros(32, np.int64)
            for i in reg[1:]:
                m = v[:, i] > best
                best[m], bi[m] = v[m, i], i
            bpos = (bi >> 2) * 128 + lane * 4 + (bi & 3)
            for off in (16, 8, 4, 2, 1):
                ov, op = best[lane ^ off], bpos[lane ^ off]
                take = (ov > best) | ((ov == best) & (op < bpos))
                best, bpos = np.where(take, ov, best), np.where(take, op, bpos)
            vals[s, r], idx[s, r] = best[0], s * seg + bpos[0]
            own = ((bpos & 127) >> 2) == lane
            v[lane[own], ((bpos >> 7) * 4 + (bpos & 3))[own]] = -np.inf
    return vals, idx, counts


def _nan_free_field(seed, S, seg):
    rng = np.random.default_rng(seed)
    x = np.full((S, seg), -np.inf, np.float32)
    pos = rng.choice(S * seg, size=S * 6, replace=False)
    x.reshape(-1)[pos] = rng.integers(1, 4, S * 6) / 4.0      # many ties
    x[1] = rng.integers(0, 3, seg) / 2.0                        # dense
    x[2] = -np.inf
    return x


@pytest.mark.parametrize("seg", [128, 512])
def test_segtopk_first_port_transliteration_is_the_contract(seg):
    """On fields without NaN the first port's compares give the contract
    (`segment_topk_reference`) bit for bit, so the transliteration that
    pins NaN segments on the card is the first port's kernel."""
    x = _nan_free_field(seg, 24, seg)
    want = st.segment_topk_reference(torch.from_numpy(x), 5)
    for g, w in zip(_segtopk_first_port(x, 5), want):
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.cuda
def test_segtopk_nan_segments_keep_the_first_ports_rounds():
    """NaN fields are outside segtopk's contract (detection's scores hold
    none); a segment holding a NaN runs the first port's rounds, so its
    outputs are the first port's bit for bit: NaN at the front, the back
    and among ties, one and several a segment, beside NaN-free ones."""
    _cuda_or_skip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    for seg, rounds in ((512, 4), (256, 6), (128, 3)):
        x = _nan_free_field(seg + 1, 40, seg)
        for s in range(3, 40, 2):
            x[s, rng.choice(seg, size=1 + s % 4, replace=False)] = np.nan
        x[5, 0] = x[7, seg - 1] = np.nan
        got = st.segment_topk(torch.from_numpy(x).to(dev), rounds)
        want = _segtopk_first_port(x, rounds)
        g0 = got[0].cpu().numpy()
        np.testing.assert_array_equal(g0.view(np.int32),
                                      want[0].view(np.int32))
        np.testing.assert_array_equal(got[1].cpu().numpy(), want[1])
        np.testing.assert_array_equal(got[2].cpu().numpy(), want[2])


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
    # a dense 300 x 600 window runs in pieces, as does X = 600 with band
    # windows; only Z past the grid raises
    bf = dict(device=dev, dtype=torch.bfloat16)
    a = torch.zeros((2, 4, 300, 600), **bf)
    My, Mx = torch.zeros((2, 300, 300), **bf), torch.zeros((2, 600, 600), **bf)
    assert not lc.sl_rows(a, My, Mx).any()
    assert not lc.sl_rows(a, My, Mx, 9, 9).any()
    with pytest.raises(ValueError, match="grid limit"):
        lc.sl_rows(torch.zeros((1, 65536, 1, 8), **bf),
                   torch.zeros((1, 1, 1), **bf), torch.zeros((1, 8, 8), **bf))


@pytest.mark.cuda
def test_lowrank_runner_on_cuda():
    """Lowrank runs of a 16 x 40 x 600 box (X > 512, bf16) and of a
    4 x 4 x 3700 box (float32: X past one block of the float32 rows
    pass) go through the kernels, and agree with runs on the plain chain
    (bf16: rounding flips of one ULP; float32: sums in another order)."""
    _cuda_or_skip()
    from spim_registration_tpu_torch.convert import views_from_numpy
    from spim_registration_tpu_torch.deconv import (
        DeconvolutionParameters,
        DeconvolutionRunner,
        gaussian_psf,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)
    psfs = [gaussian_psf((9, 9, 9), (2.0, 1.0, 1.4)),
            gaussian_psf((9, 9, 9), (1.0, 1.3, 2.0))]
    for shape, dtype, tol in (((16, 40, 600), "bfloat16", 1e-3),
                              ((4, 4, 3700), "float32", 1e-5)):
        imgs = rng.random((2,) + shape).astype(np.float32) + 0.1
        w = np.full(imgs.shape, 0.5, np.float32)
        prep = views_from_numpy(imgs, w, psfs, 2.0, device="cuda")
        params = DeconvolutionParameters(
            num_iterations=2, conv_backend="lowrank", psf_rank=8,
            psf_rank_tol=1e-3, lowrank_dtype=dtype)
        n0, n1 = lc.zpass.launches, lc.sl_rows.launches
        got = DeconvolutionRunner(prep, params, device="cuda").run()
        torch.cuda.synchronize()
        launched = (lc.zpass.launches - n0, lc.sl_rows.launches - n1)
        assert got.shape == shape and bool(torch.isfinite(got).all())
        assert launched[0] > 0 and launched[1] > 0, (shape, launched)
        chain = DeconvolutionRunner(prep, dataclasses.replace(
            params, lowrank_fused=False), device="cuda").run()
        d = (got.double() - chain.double()).pow(2).mean().sqrt()
        assert float(d / (chain.max() - chain.min())) <= tol, shape


@pytest.mark.cuda
def test_sharded_lowrank_on_cuda():
    """The z-sharded lowrank RL on a mesh of one card at two positions
    (ragged depth 37 -> shards of 19 with mirror rows) launches zpass and
    sl_rows on every shard conv, keeps every shard on the card, and
    agrees with the same mesh on the host (bf16 rounding flips)."""
    _cuda_or_skip()
    from spim_registration_tpu_torch.convert import views_from_numpy
    from spim_registration_tpu_torch.deconv import (
        DeconvolutionParameters,
        gaussian_psf,
    )
    from spim_registration_tpu_torch.parallel import (
        make_mesh,
        sharded_deconvolution_runner,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)
    psfs = [gaussian_psf((9, 9, 9), (2.0, 1.0, 1.4)),
            gaussian_psf((9, 9, 9), (1.0, 1.3, 2.0))]
    imgs = rng.random((2, 37, 40, 48)).astype(np.float32) + 0.1
    prep = views_from_numpy(imgs, np.full(imgs.shape, 0.5, np.float32),
                            psfs, 2.0, device="cpu")
    params = DeconvolutionParameters(num_iterations=2,
                                     conv_backend="lowrank", psf_rank=8,
                                     psf_rank_tol=1e-3)
    out = {}
    for dev in ("cuda:0", "cpu"):
        mesh = make_mesh(("z",), (2,), devices=[dev, dev])
        n0 = lc.zpass.launches, lc.sl_rows.launches
        shards = sharded_deconvolution_runner(prep, params, mesh,
                                              device_result=True)()
        torch.cuda.synchronize()
        assert all(s.device == torch.device(dev) for s in shards)
        launched = (lc.zpass.launches - n0[0], lc.sl_rows.launches - n0[1])
        # 2 iterations x 2 views x 2 convs x 2 shards
        assert launched == ((16, 16) if dev != "cpu" else (0, 0)), launched
        out[dev] = torch.cat([s.cpu() for s in shards])[:37].numpy()
    d = np.sqrt(np.mean((out["cuda:0"] - out["cpu"]) ** 2))
    assert d / (out["cpu"].max() - out["cpu"].min()) <= 1e-3


@pytest.mark.cuda
def test_dog_kernel_matches_plain_on_cuda():
    _cuda_or_skip()
    from spim_registration_tpu_torch.utils.device import set_exact_float32

    set_exact_float32()
    rng = np.random.default_rng(2)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def tma_tiles(shape, R, ty):
        """csrc/dog.cu's TMA tiles: X % 4 == 0 and every cell of the
        tile's window mirrors a cell of the window (period 2(n - 1))."""
        Z, Y, X = shape
        h = (R + 3) // 4 * 4

        def own(o, w, n):
            k = np.arange(o, o + w)
            src = (n - 1) - np.abs(k % max(2 * n - 2, 1) - (n - 1)) \
                if n > 1 else 0 * k
            return bool(np.all((src >= o) & (src < o + w)))

        return 0 if X % 4 else sum(
            own(i * 32 - h, 32 + 2 * h, X) and own(j * ty - R, ty + 2 * R, Y)
            for i in range(-(-X // 32)) for j in range(-(-Y // ty)))

    # (shape, sigma1, sigma2, whether some tiles load by TMA): X % 4 != 0
    # (cp.async only), X smaller than a tile, interior tiles by TMA beside
    # face tiles, Z < 2R with Y smaller than a tile, radius 15 (Z < 2R)
    for shape, s1, s2, tma in (
            ((21, 33, 47), (1.2, 1.8, 1.8), (1.5, 2.2, 2.2), False),
            ((70, 65, 97), 1.8, 1.8 * 2 ** 0.25, False),
            ((9, 40, 3), (0.0, 1.0, 2.0), (0.5, 1.5, 2.5), False),
            ((40, 150, 100), 1.8, 1.8 * 2 ** 0.25, True),
            ((10, 20, 30), 1.8, 1.8 * 2 ** 0.25, False),
            ((24, 100, 96), 4.0, 4.9, True)):
        _, radii = kd.dog_taps(s1, s2)
        R = kd._lib().spim_dog_radius(int(radii.max()))
        plan = kd.dog_plan(*shape, R, sms)
        assert (tma_tiles(shape, R, plan.ty) > 0) == tma, (shape, plan)
        v = torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                             ).cuda()
        n0 = kd.dog_fused.launches
        got = kd.dog_fused(v, s1, s2)
        assert kd.dog_fused.launches == n0 + 1
        want = kd.dog_reference(v, s1, s2)
        assert float((got - want).abs().max()) <= 1e-5 * float(
            v.abs().max())
    with pytest.raises(ValueError, match="float32"):
        kd.dog_fused(v.double(), 1.0, 2.0)
    with pytest.raises(ValueError, match="taps"):
        kd.dog_fused(v, 11.0, 12.0)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_zfused_kernel_matches_plain_on_cuda():
    _cuda_or_skip()
    from spim_registration_tpu_torch.ops.separable import (
        conv_lowrank_folded,
        folded_conv_matrices,
    )

    rng = np.random.default_rng(3)
    # then `zfused_plan`'s main-path tiling (14 x 14 x 24 at half-supports
    # 9, rank 22) with a ragged tile edge on every axis, by TMA and
    # (X % 8 != 0) by element copies; half-supports that differ on every
    # axis; and half-supports 15 (the 16-row x tiles); `tma`: the route the
    # host picks
    for shape, R, taps, tma in (((32, 16, 128), 4, (7, 9, 5), True),
                                ((37, 50, 300), 3, (9, 7, 19), False),
                                ((40, 20, 45), 5, (19, 3, 1), False),
                                ((64, 48, 64), 22, (19, 19, 19), True),
                                ((61, 45, 62), 22, (19, 19, 19), False),
                                ((56, 40, 64), 6, (17, 11, 5), True),
                                ((64, 64, 64), 3, (31, 31, 31), True)):
        facs = [rng.standard_normal((R, t)) for t in taps]
        Ms = [torch.from_numpy(M).cuda().to(torch.bfloat16)
              for M in folded_conv_matrices(*facs, shape)]
        vol = torch.from_numpy(rng.random(shape).astype(np.float32)).cuda()
        plan = lc.zfused_plan(*shape, (taps[0] - 1) // 2,
                              lc.band_radius(Ms[1]), lc.band_radius(Ms[2]))
        assert lc.zfused_tma_load(vol.to(torch.bfloat16), *Ms, plan) == tma
        n0 = lc.zfused.launches
        got = lc.conv_lowrank_folded_zfused(vol, *Ms, hz=(taps[0] - 1) // 2)
        assert lc.zfused.launches == n0 + 1
        want = conv_lowrank_folded(vol, *Ms)
        d = (got - want).abs()
        # nrmse catches a fragment-layout fault confined to a few elements
        nrmse = float(torch.sqrt((d.double() ** 2).mean())
                      / (want.max() - want.min()))
        assert nrmse <= 1e-3, (shape, nrmse)
        assert float(d.max()) <= 2.0 ** -7 * float(want.abs().max())
    with pytest.raises(ValueError, match="bfloat16"):
        lc.zfused(vol, *(M.float() for M in Ms), 9, 1, 0)
    big = torch.zeros((1, 64, 64), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cannot take"):
        lc.zfused(torch.zeros((64, 64, 64), device="cuda",
                              dtype=torch.bfloat16), big, big, big, 40, 40, 40)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_blocked_lowrank_on_cuda():
    """The out-of-core lowrank engine on the card: every block conv of a
    bf16 run launches `zpass` and `sl_rows` (views x blocks x 2 convs x
    iterations of each), and the run agrees with the same run on the CPU,
    where the block convs take the kernels' plain versions (rounding
    flips of one bf16 ULP compound over the iterations, hence 1e-3)."""
    _cuda_or_skip()
    from spim_registration_tpu_torch.deconv import (
        DeconvolutionParameters,
        gaussian_psf,
    )
    from spim_registration_tpu_torch.deconv.blocked import (
        ArrayStore,
        BlockedDeconvolutionInputs,
        BlockedDeconvolutionRunner,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)
    shape, V, bz, n_it = (48, 40, 72), 2, 16, 2
    psfs = [gaussian_psf((9, 9, 9), (2.0, 1.0, 1.4)),
            gaussian_psf((9, 9, 9), (1.0, 1.3, 2.0))]
    imgs = rng.random((V,) + shape).astype(np.float32) + 0.1
    w = np.full(shape, 1.0 / V, np.float32)
    inputs = BlockedDeconvolutionInputs(
        [ArrayStore(imgs[v]) for v in range(V)],
        [ArrayStore(w) for _ in range(V)], psfs, 2.0)
    params = DeconvolutionParameters(
        num_iterations=n_it, conv_backend="lowrank", psf_rank=8,
        psf_rank_tol=1e-3)
    out = {}
    for device in ("cuda", "cpu"):
        psi = ArrayStore(np.zeros(shape, np.float32))
        n0, n1 = lc.zpass.launches, lc.sl_rows.launches
        runner = BlockedDeconvolutionRunner(inputs, psi, params,
                                            block_z=bz, device=device)
        runner.run()
        torch.cuda.synchronize()
        launched = (lc.zpass.launches - n0, lc.sl_rows.launches - n1)
        n_mat = sum("mat" in e for e in runner.e1 + runner.e2)
        want = n_it * (shape[0] // bz) * n_mat if device == "cuda" else 0
        assert launched == (want, want), (device, launched)
        out[device] = psi.array.copy()
    assert np.all(np.isfinite(out["cuda"]))
    chain = out["cpu"].astype(np.float64)
    d = np.sqrt(np.mean((out["cuda"] - chain) ** 2))
    assert d / (chain.max() - chain.min()) <= 1e-3
