"""The port's block decomposition and raw volume store
(spim_registration_tpu_torch/native_blocks.py) against the reference's
(spim_registration_tpu/native_blocks.py): the same block lists, the same
files on disk, on both the C++ library and the numpy path."""

import numpy as np
import pytest

from spim_registration_tpu import native_blocks as ref_nb
from spim_registration_tpu_torch import native_blocks as nb

CASES = [((37, 20, 51), (16, 16, 16), (4, 4, 4)),
         ((48, 32, 32), (12, 32, 32), (9, 0, 0)),
         ((5, 7, 3), (2, 3, 5), (1, 2, 3)),
         ((64, 64, 64), (64, 128, 128), (0, 0, 0))]


def test_library_builds_into_the_ports_build_dir():
    """g++ builds the port's own copy of native/spimblocks.cpp into the
    package's gitignored _build/, named by the source's hash."""
    assert nb.native_path() == "native"
    assert nb._target().parent == nb.BUILD_DIR
    assert nb._target().exists()
    assert nb.SRC_PATH.name == "spimblocks.cpp"
    assert nb.SRC_PATH.parent.name == "native"


@pytest.mark.parametrize("dims,block,halo", CASES)
def test_decompose_equals_reference(dims, block, halo):
    got = nb.decompose(dims, block, halo)
    want = ref_nb.decompose(dims, block, halo)
    assert [tuple(map(tuple, (b.out_lo, b.out_hi, b.in_lo, b.in_hi,
                              b.pad_lo, b.pad_hi))) for b in got] == [
        tuple(tuple(int(v) for v in t) for t in (
            b.out_lo, b.out_hi, b.in_lo, b.in_hi, b.pad_lo, b.pad_hi))
        for b in want]
    # the numpy loop gives the library's records
    rows = nb._decompose_rows(dims, block, halo)
    assert [list(r) for r in rows] == [
        [v for t in (b.out_lo, b.out_hi, b.in_lo, b.in_hi, b.pad_lo,
                     b.pad_hi) for v in t] for b in got]
    covered = np.zeros(dims, np.int32)
    for b in got:
        covered[b.out_lo[0]:b.out_hi[0], b.out_lo[1]:b.out_hi[1],
                b.out_lo[2]:b.out_hi[2]] += 1
    assert covered.min() == 1 and covered.max() == 1


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_store_round_trip_and_reference_files(tmp_path, monkeypatch, path):
    """Strided block reads and writes; a file the port writes reads back
    through the reference's store and the other way round."""
    if path == "numpy":
        monkeypatch.setattr(nb, "get_lib", lambda: None)
    rng = np.random.default_rng(1)
    shape = (24, 18, 30)
    vol = rng.normal(size=shape).astype(np.float32)
    st = nb.RawVolumeStore(str(tmp_path / "v.raw"), shape, create=True)
    assert (st._lib is None) == (path == "numpy")
    st.write_block((0, 0, 0), vol)
    np.testing.assert_array_equal(st.read_block((0, 0, 0), shape), vol)
    np.testing.assert_array_equal(st.read_block((5, 3, 7), (20, 11, 29)),
                                  vol[5:20, 3:11, 7:29])
    patch = rng.normal(size=(4, 4, 4)).astype(np.float32)
    st.write_block((10, 10, 10), patch)
    vol[10:14, 10:14, 10:14] = patch
    ref = ref_nb.RawVolumeStore(str(tmp_path / "v.raw"), shape)
    np.testing.assert_array_equal(ref.read_block((0, 0, 0), shape), vol)
    ref.write_block((2, 0, 0), -vol[:3])
    np.testing.assert_array_equal(st.read_block((2, 0, 0), (5, 18, 30)),
                                  -vol[:3])
    with pytest.raises(ValueError, match="invalid block range"):
        st.read_block((0, 0, 0), (25, 18, 30))


def test_padded_block_read_mirrors(tmp_path):
    rng = np.random.default_rng(2)
    shape = (16, 16, 16)
    vol = rng.normal(size=shape).astype(np.float32)
    st = nb.RawVolumeStore(str(tmp_path / "v.raw"), shape, create=True)
    st.write_block((0, 0, 0), vol)
    ref = ref_nb.RawVolumeStore(str(tmp_path / "v.raw"), shape)
    want = np.pad(vol, 2, mode="reflect")
    for b, rb in zip(nb.decompose(shape, (8, 8, 8), (2, 2, 2)),
                     ref_nb.decompose(shape, (8, 8, 8), (2, 2, 2))):
        got = st.read_block_padded(b)
        np.testing.assert_array_equal(got, ref.read_block_padded(rb))
        np.testing.assert_array_equal(
            got, want[b.out_lo[0]:b.out_hi[0] + 4,
                      b.out_lo[1]:b.out_hi[1] + 4,
                      b.out_lo[2]:b.out_hi[2] + 4])
