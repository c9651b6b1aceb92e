"""The port's native data core (frl_distributed_ml_scaffold_tpu_torch/
data/native.py and its copy of native/frl_data.cpp) on the CPU.

- The port's C++ source is a byte-identical copy of the JAX package's.
- Its library builds under the repository's ``build/native/``, never in
  the JAX package's directory, and is the one loaded.
- Every entry point and dtype (``gather_rows`` float32 and uint8,
  ``gather_windows`` uint16 and uint32, ``augment_batch`` train and eval)
  gives the same bits through the C++ core, through its numpy plain
  version and through the JAX package's ``data/native.py``. (The JAX
  package's own numpy fallback divides uint8 by 255 where its C++
  multiplies by the float32 reciprocal, one ulp apart on 126 of the 256
  values; the port's plain version multiplies, as the C++ does.)
- An index, window or crop out of range raises alike on both paths, and
  ``calls`` counts the path each call took.
- ``gather_rows(..., out=)`` writes the same bits into a slice of a
  larger batch on both paths, and refuses an ``out`` of the wrong shape
  or dtype.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

from pathlib import Path

import numpy as np
import pytest

from frl_distributed_ml_scaffold_tpu.data import native as jnative
from frl_distributed_ml_scaffold_tpu_torch.data import native as tnative

REPO = Path(__file__).resolve().parents[1]

requires_native = pytest.mark.skipif(
    not tnative.native_available(), reason="no C++ toolchain (g++)")


@pytest.fixture
def numpy_only(monkeypatch):
    """The port's entry points with the library absent: the numpy path."""
    monkeypatch.setattr(tnative, "_load", lambda: None)


def test_cpp_source_is_a_byte_identical_copy():
    port = REPO / "frl_distributed_ml_scaffold_tpu_torch/native/frl_data.cpp"
    ref = REPO / "frl_distributed_ml_scaffold_tpu/native/frl_data.cpp"
    assert tnative.SRC == port
    assert port.read_bytes() == ref.read_bytes()


@requires_native
def test_library_builds_under_build_and_is_the_one_loaded():
    path = tnative.library_path()
    assert path.parent == REPO / "build" / "native"
    assert path.name.endswith(f".{tnative.host_arch_tag()}.so")
    assert path.exists() and tnative._load()._name == str(path)
    assert "frl_distributed_ml_scaffold_tpu/" not in tnative._load()._name


def _images(dtype, n=24, size=12):
    rng = np.random.default_rng(0)
    if dtype == np.uint8:
        return rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8)
    return rng.random((n, size, size, 3), dtype=np.float32)


@requires_native
@pytest.mark.parametrize("dtype", [np.float32, np.uint8],
                         ids=["f32", "u8"])
def test_gather_rows_cpp_numpy_and_jax_agree(dtype):
    src = _images(dtype)
    idx = np.array([0, 23, 7, 7, 12, 3], np.int64)
    before = dict(tnative.calls)
    got = tnative.gather_rows(src, idx)
    assert tnative.calls["native"] == before["native"] + 1
    assert got.dtype == np.float32 and got.shape == (6, 12, 12, 3)
    np.testing.assert_array_equal(got, tnative.gather_rows_numpy(src, idx))
    assert jnative.native_available()
    np.testing.assert_array_equal(got, jnative.gather_rows(src, idx))
    if dtype == np.uint8:
        np.testing.assert_allclose(got, src[idx] / 255.0, rtol=1e-6)


@requires_native
@pytest.mark.parametrize("dtype", [np.uint16, np.uint32],
                         ids=["u16", "u32"])
def test_gather_windows_cpp_numpy_and_jax_agree(dtype):
    src = np.random.default_rng(1).integers(
        0, np.iinfo(dtype).max, size=4096, dtype=np.int64).astype(dtype)
    starts = np.array([0, 17, 4096 - 33, 1000, 17], np.int64)
    got = tnative.gather_windows(src, starts, 33)
    assert got.dtype == np.int32 and got.shape == (5, 33)
    np.testing.assert_array_equal(
        got, tnative.gather_windows_numpy(src, starts, 33))
    np.testing.assert_array_equal(got, jnative.gather_windows(src, starts, 33))
    for row, s in zip(got, starts):
        np.testing.assert_array_equal(row, src[s: s + 33].astype(np.int32))


@requires_native
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_augment_cpp_numpy_and_jax_agree(train):
    x = _images(np.float32, n=16, size=12)
    for crop, seed in ((8, 0), (8, 2**63 - 5), (12, 77)):
        got = tnative.augment_batch(x, crop, seed=seed, train=train)
        assert got.shape == (16, crop, crop, 3)
        np.testing.assert_array_equal(
            got, tnative.augment_numpy(x, crop, seed=seed, train=train))
        np.testing.assert_array_equal(
            got, jnative.augment_batch(x, crop, seed=seed, train=train))
    if train:  # crops and flips differ across samples and seeds
        a = tnative.augment_batch(x, 8, seed=1, train=True)
        b = tnative.augment_batch(x, 8, seed=2, train=True)
        assert not np.array_equal(a, b)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_bounds_raise_alike_on_both_paths(path, request):
    if path == "numpy":
        request.getfixturevalue("numpy_only")
    elif not tnative.native_available():
        pytest.skip("no C++ toolchain (g++)")
    before = dict(tnative.calls)
    src = _images(np.uint8, n=4, size=6)
    with pytest.raises(IndexError, match="index 4 out of bounds for 4 rows"):
        tnative.gather_rows(src, np.array([0, 4]))
    with pytest.raises(IndexError, match="index -1 out of bounds"):
        tnative.gather_rows(src, np.array([-1]))
    toks = np.zeros(100, np.uint16)
    with pytest.raises(IndexError, match=r"start 90 \(\+11\) out of bounds"):
        tnative.gather_windows(toks, np.array([90]), 11)
    with pytest.raises(IndexError, match="start -1"):
        tnative.gather_windows(toks, np.array([-1]), 5)
    with pytest.raises(ValueError, match="crop 7 exceeds stored image size"):
        tnative.augment_batch(src.astype(np.float32), 7, seed=0, train=True)
    assert tnative.calls == before  # refused before either path ran
    # In range, the call is counted on the path it took.
    tnative.gather_rows(src, np.array([3]))
    assert tnative.calls[path] == before[path] + 1


@pytest.mark.parametrize("dtype", [np.float32, np.uint8],
                         ids=["f32", "u8"])
@pytest.mark.parametrize("path", ["native", "numpy"])
def test_gather_rows_into_a_slice_on_both_paths(path, dtype, request):
    if path == "numpy":
        request.getfixturevalue("numpy_only")
    elif not tnative.native_available():
        pytest.skip("no C++ toolchain (g++)")
    src = _images(dtype)
    idx = np.array([2, 2, 9, 20], np.int64)
    batch = np.full((7, 12, 12, 3), -1.0, np.float32)
    before = dict(tnative.calls)
    got = tnative.gather_rows(src, idx, out=batch[2:6])
    assert tnative.calls[path] == before[path] + 1
    assert np.shares_memory(got, batch)
    np.testing.assert_array_equal(batch[2:6], jnative.gather_rows(src, idx))
    assert (batch[:2] == -1).all() and (batch[6:] == -1).all()
    for bad in (batch[:3], batch[2:6].astype(np.float64), batch[2:6, ::2]):
        with pytest.raises(ValueError, match="out must be C-contiguous"):
            tnative.gather_rows(src, idx, out=bad)


def test_numpy_path_gives_the_same_batches(numpy_only):
    """With the library absent every entry point takes its numpy version,
    whose bits are the C++ core's (held above) and the JAX package's."""
    assert not tnative.native_available()
    x = _images(np.uint8, n=8, size=10)
    idx = np.array([1, 5, 5, 0])
    rows = tnative.gather_rows(x, idx)
    np.testing.assert_array_equal(
        rows, np.ascontiguousarray(x[idx], np.float32)
        * (np.float32(1) / np.float32(255)))
    out = tnative.augment_batch(rows, 8, seed=9, train=True)
    np.testing.assert_array_equal(
        out, jnative._augment_numpy(rows, 8, seed=9, train=True,
                                    mean=jnative._IMAGENET_MEAN,
                                    std=jnative._IMAGENET_STD))
    toks = np.arange(50, dtype=np.uint32)
    np.testing.assert_array_equal(
        tnative.gather_windows(toks, np.array([3, 40]), 10),
        np.stack([np.arange(3, 13), np.arange(40, 50)]).astype(np.int32))
