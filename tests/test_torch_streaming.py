"""The port's streaming fusion (spim_registration_tpu_torch/fuse/
streaming.py, with `_accumulate_view_chunk` of fuse/weighted_avg.py)
against the reference's, on the reference tests' scene (3 views of
64^3, 40 beads, bbox 8..56; tests/test_streaming.py), on the CPU.

Tolerances: streaming against streaming and against in-memory fusion
atol 2e-4 (the reference test's bound); content weights through the
low-res pyramid nrmse < 5e-3 against in-memory fusion (the reference
test's bound) and < 1e-5 against the reference's pyramid path."""

import functools

import numpy as np
import pytest
import torch

from spim_registration_tpu.core.dataset import BoundingBox as RefBBox
from spim_registration_tpu.fuse import FusionParameters as RefFP
from spim_registration_tpu.fuse import fuse_views as ref_fuse
from spim_registration_tpu.fuse.streaming import (
    fuse_views_streaming as ref_streaming,
)
from spim_registration_tpu.fuse.streaming import (
    streaming_content_lowres as ref_lowres,
)
from spim_registration_tpu.fuse.weights import (
    ContentBasedParameters as RefCP,
)
from spim_registration_tpu.native_blocks import RawVolumeStore as RefStore
from spim_registration_tpu.utils.simulation import make_multiview_scene
from spim_registration_tpu_torch.core.dataset import BoundingBox
from spim_registration_tpu_torch.fuse import (
    ContentBasedParameters,
    FusionParameters,
    fuse_views,
)
from spim_registration_tpu_torch.fuse.streaming import (
    fuse_views_streaming,
    streaming_content_lowres,
)
from spim_registration_tpu_torch.native_blocks import RawVolumeStore

torch.set_num_threads(2)

LO, HI = (8, 8, 8), (56, 56, 56)


@functools.lru_cache(maxsize=None)
def _scene():
    return make_multiview_scene(np.random.default_rng(42), n_views=3,
                                shape=(64, 64, 64), n_beads=40, noise=0.0)


def _stores(tmp_path, Store, tag):
    out = []
    for v, vol in enumerate(_scene().volumes):
        st = Store(str(tmp_path / f"{tag}{v}.raw"), vol.shape, create=True)
        st.write_block((0, 0, 0), vol)
        out.append(st)
    return out


def _nrmse(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / (b.max() - b.min()))


@pytest.mark.parametrize("content", [False, True])
def test_streaming_fusion_matches_reference(tmp_path, content):
    scene = _scene()
    bbox = BoundingBox("b", LO, HI)
    out = RawVolumeStore(str(tmp_path / "out.raw"), bbox.shape, create=True)
    fuse_views_streaming(_stores(tmp_path, RawVolumeStore, "p"),
                         scene.models, bbox, out,
                         FusionParameters(use_content_based=content),
                         block=(16, 32, 32), device="cpu")
    got = out.read_block((0, 0, 0), bbox.shape)
    ref_out = RefStore(str(tmp_path / "ref.raw"), bbox.shape, create=True)
    ref_streaming(_stores(tmp_path, RefStore, "r"), scene.models,
                  RefBBox("b", LO, HI), ref_out,
                  RefFP(use_content_based=content), block=(16, 32, 32))
    want = ref_out.read_block((0, 0, 0), bbox.shape)
    mem = fuse_views(scene.volumes, scene.models, bbox,
                     FusionParameters(use_content_based=content),
                     device="cpu")
    if content:
        assert _nrmse(got, want) < 1e-5
        assert _nrmse(got, mem) < 5e-3
    else:
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
        np.testing.assert_allclose(got, mem, atol=2e-4, rtol=0)


def test_streaming_content_lowres_matches_reference(tmp_path):
    rng = np.random.default_rng(42)
    vol = rng.uniform(0, 1, (64, 48, 48)).astype(np.float32)
    vol[20:30, 20:30, 20:30] += 3.0
    st = RawVolumeStore(str(tmp_path / "c.raw"), vol.shape, create=True)
    st.write_block((0, 0, 0), vol)
    got = streaming_content_lowres(
        st, ContentBasedParameters(sigma1=5.0, sigma2=10.0), ds=4, slab=32,
        device="cpu")
    want = ref_lowres(RefStore(str(tmp_path / "c.raw"), vol.shape),
                      RefCP(sigma1=5.0, sigma2=10.0), ds=4, slab=32)
    assert got.shape == want.shape == (16, 12, 12)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_streaming_fusion_partial_coverage(tmp_path):
    """Blocks whose world extent misses a view entirely are handled."""
    vol = np.random.default_rng(42).uniform(0.1, 1.0, (32, 32, 32)).astype(
        np.float32)
    ident = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    bbox = BoundingBox("b", (-16, 0, 0), (48, 32, 32))
    st = RawVolumeStore(str(tmp_path / "v.raw"), vol.shape, create=True)
    st.write_block((0, 0, 0), vol)
    out = RawVolumeStore(str(tmp_path / "o.raw"), bbox.shape, create=True)
    fuse_views_streaming([st], [ident], bbox, out,
                         FusionParameters(use_blending=False),
                         block=(16, 32, 32), device="cpu")
    got = out.read_block((0, 0, 0), bbox.shape)
    np.testing.assert_allclose(got[16:48], vol, atol=1e-5)
    assert np.all(got[:15] == 0)
    with pytest.raises(ValueError, match="out store shape"):
        fuse_views_streaming([st], [ident], BoundingBox("b", (0, 0, 0),
                                                        (8, 8, 8)), out,
                             device="cpu")
