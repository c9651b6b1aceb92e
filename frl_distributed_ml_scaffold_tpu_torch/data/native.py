"""The native data core: ctypes bindings for the port's copy of
``native/frl_data.cpp`` (the JAX package's ``data/native.py``).

The library is built with g++ at first use into ``build/native/`` at the
repository root (git-ignored), named by a hash of the source and the
flags and by a tag of the host's CPU: it is built with ``-march=native``,
so a library built on one host's CPU is never loaded on another's. The
build writes a temporary file and renames it into place, so processes
that build at once never load a torn library.

Entry points, each with a numpy plain version that gives the same bits:

- ``gather_rows``: ``dst[i] = src[idx[i]]`` as float32; uint8 rows are
  scaled to [0, 1] by the float32 reciprocal of 255, as the C++ does;
- ``gather_windows``: ``dst[i] = src[starts[i]:starts[i] + window]`` of a
  uint16 / uint32 token stream, as int32;
- ``augment_batch``: NHWC random crop, horizontal flip and per-channel
  normalize (train) or center crop and normalize (eval), the crop and
  flip drawn from splitmix64 streams of ``seed``.

Bounds are checked before either path runs, so both fail alike. When g++
is missing or fails, every entry point takes its numpy version with a
warning: ``native_available()`` says which path is live, and ``calls``
counts the calls that took each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

from frl_distributed_ml_scaffold_tpu_torch.utils.logging import get_logger

SRC = Path(__file__).resolve().parents[1] / "native" / "frl_data.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
#: Calls of the entry points by the path they took.
calls = {"native": 0, "numpy": 0}


def host_arch_tag() -> str:
    """Machine arch + a hash of the CPU feature flags: each distinct
    microarchitecture builds and loads its own library."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.lower().startswith(("flags", "features")):
                    flags = line
                    break
    except OSError:
        pass
    h = hashlib.sha256(flags.encode()).hexdigest()[:8]
    return f"{platform.machine()}-{h}"


def library_path() -> Path:
    tag = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    name = f"libfrl_data-{tag.hexdigest()[:12]}.{host_arch_tag()}.so"
    return BUILD_DIR / name


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (subprocess.SubprocessError, OSError) as e:
        get_logger().warning(
            "native data core build failed (%s); using the numpy versions", e)
        tmp.unlink(missing_ok=True)
        return False


def _bind(lib: ctypes.CDLL) -> None:
    f32 = ctypes.POINTER(ctypes.c_float)
    i64 = ctypes.POINTER(ctypes.c_int64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    n = ctypes.c_int64
    lib.frl_gather_rows.argtypes = [f32, i64, f32, n, n]
    lib.frl_gather_rows_u8.argtypes = [ctypes.POINTER(ctypes.c_uint8), i64,
                                       f32, n, n]
    lib.frl_gather_windows_u16.argtypes = [ctypes.POINTER(ctypes.c_uint16),
                                           i64, i32, n, n]
    lib.frl_gather_windows_u32.argtypes = [ctypes.POINTER(ctypes.c_uint32),
                                           i64, i32, n, n]
    lib.frl_augment_batch.argtypes = [f32, f32, n, n, n, n, n,
                                      ctypes.c_uint64, ctypes.c_int, f32, f32]


def _load_uncached() -> ctypes.CDLL | None:
    out = library_path()
    if not out.exists() and not _build(out):
        return None
    try:
        lib = ctypes.CDLL(str(out))
        _bind(lib)
    except (OSError, AttributeError) as e:
        get_logger().warning(
            "native data core load failed (%s); using the numpy versions", e)
        return None
    return lib


def _load() -> ctypes.CDLL | None:
    """The library, built on the first call (the others wait for it)."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _lib = _load_uncached()
            _tried = True
        return _lib


def native_available() -> bool:
    return _load() is not None


def _count(path: str) -> None:
    with _lock:
        calls[path] += 1


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


_INV_255 = np.float32(1.0) / np.float32(255.0)


def gather_rows_numpy(src: np.ndarray, idx: np.ndarray,
                      out: np.ndarray | None = None) -> np.ndarray:
    """The plain version of ``gather_rows``."""
    if out is None:
        out = np.empty((len(idx),) + src.shape[1:], np.float32)
    out[...] = src[idx]
    if src.dtype == np.uint8:
        out *= _INV_255
    return out


def gather_rows(src: np.ndarray, idx: np.ndarray,
                out: np.ndarray | None = None) -> np.ndarray:
    """``dst[i] = src[idx[i]]`` as float32 (a row is the trailing dims),
    written into ``out`` when given (C-contiguous float32 of that shape).

    ``src`` is typically a memmapped shard, read in place: the page faults
    happen in the C++ pool's per-row copies. float32 rows are copied,
    uint8 rows converted and scaled to [0, 1] in the same pass; other
    dtypes and non-contiguous sources take the numpy version."""
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= len(src)):
        bad = idx[(idx < 0) | (idx >= len(src))][0]
        raise IndexError(
            f"gather_rows index {bad} out of bounds for {len(src)} rows")
    shape = (len(idx),) + src.shape[1:]
    if out is None:
        out = np.empty(shape, np.float32)
    elif (out.shape != shape or out.dtype != np.float32
          or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(
            f"gather_rows out must be C-contiguous float32 {shape}, got "
            f"{out.dtype} {out.shape}")
    lib = _load()
    u8 = src.dtype == np.uint8
    if lib is None or not src.flags["C_CONTIGUOUS"] or (
            src.dtype != np.float32 and not u8):
        _count("numpy")
        return gather_rows_numpy(src, idx, out)
    _count("native")
    row = int(np.prod(src.shape[1:], dtype=np.int64))
    args = (_ptr(idx, ctypes.c_int64), _ptr(out, ctypes.c_float), len(idx),
            row)
    if u8:
        lib.frl_gather_rows_u8(_ptr(src, ctypes.c_uint8), *args)
    else:
        lib.frl_gather_rows(_ptr(src, ctypes.c_float), *args)
    return out


def gather_windows_numpy(src: np.ndarray, starts: np.ndarray,
                         window: int) -> np.ndarray:
    """The plain version of ``gather_windows``."""
    return np.asarray(src[starts[:, None] + np.arange(window)], np.int32)


def gather_windows(src: np.ndarray, starts: np.ndarray,
                   window: int) -> np.ndarray:
    """``dst[i] = src[starts[i] : starts[i] + window]`` as int32, from a
    1-D uint16 / uint32 token stream (the LM token-bin read path)."""
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    if starts.size and (starts.min() < 0
                        or starts.max() + window > len(src)):
        bad = starts[(starts < 0) | (starts + window > len(src))][0]
        raise IndexError(
            f"gather_windows start {bad} (+{window}) out of bounds for "
            f"{len(src)} tokens")
    lib = _load()
    ctype = {np.dtype(np.uint16): ctypes.c_uint16,
             np.dtype(np.uint32): ctypes.c_uint32}.get(src.dtype)
    if lib is None or ctype is None or not src.flags["C_CONTIGUOUS"]:
        _count("numpy")
        return gather_windows_numpy(src, starts, window)
    _count("native")
    out = np.empty((len(starts), window), np.int32)
    fn = (lib.frl_gather_windows_u16 if ctype is ctypes.c_uint16
          else lib.frl_gather_windows_u32)
    fn(_ptr(src, ctype), _ptr(starts, ctypes.c_int64),
       _ptr(out, ctypes.c_int32), len(starts), window)
    return out


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def augment_batch(x: np.ndarray, crop: int, *, seed: int, train: bool,
                  mean: np.ndarray = IMAGENET_MEAN,
                  std: np.ndarray = IMAGENET_STD) -> np.ndarray:
    """NHWC random crop + flip + normalize (train) or center crop +
    normalize (eval), float32 out."""
    n, h, w, c = x.shape
    if crop > h or crop > w:
        raise ValueError(f"crop {crop} exceeds stored image size {h}x{w}")
    mean = np.ascontiguousarray(np.broadcast_to(mean, (c,)), np.float32)
    std = np.ascontiguousarray(np.broadcast_to(std, (c,)), np.float32)
    lib = _load()
    if lib is None:
        _count("numpy")
        return augment_numpy(x, crop, seed=seed, train=train, mean=mean,
                             std=std)
    _count("native")
    x = np.ascontiguousarray(x, np.float32)
    out = np.empty((n, crop, crop, c), np.float32)
    lib.frl_augment_batch(
        _ptr(x, ctypes.c_float), _ptr(out, ctypes.c_float), n, h, w, c, crop,
        ctypes.c_uint64(seed & (2**64 - 1)), int(train),
        _ptr(mean, ctypes.c_float), _ptr(std, ctypes.c_float))
    return out


_M64 = (1 << 64) - 1


def _splitmix64(s: int) -> tuple[int, int]:
    """One splitmix64 step, as the C++ core's RNG."""
    s = (s + 0x9E3779B97F4A7C15) & _M64
    z = s
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return s, (z ^ (z >> 31)) & _M64


def _uniform01(s: int) -> tuple[int, np.float32]:
    s, z = _splitmix64(s)
    return s, np.float32(z >> 40) * np.float32(1.0 / 16777216.0)


def augment_numpy(x, crop, *, seed, train, mean=IMAGENET_MEAN,
                  std=IMAGENET_STD):
    """The plain version of ``augment_batch``: the C++ core's per-sample
    splitmix64 streams and draw order (no draw where the crop has no
    freedom), so a batch does not depend on which path built it."""
    n, h, w, c = x.shape
    seed &= _M64
    out = np.empty((n, crop, crop, c), np.float32)
    max_y, max_x = h - crop, w - crop
    for i in range(n):
        if train:
            s = seed ^ ((0x243F6A8885A308D3 * (i + 1)) & _M64)
            y0 = x0 = 0
            if max_y > 0:
                s, u = _uniform01(s)
                y0 = min(int(np.float32(u * np.float32(max_y + 1))), max_y)
            if max_x > 0:
                s, u = _uniform01(s)
                x0 = min(int(np.float32(u * np.float32(max_x + 1))), max_x)
            s, u = _uniform01(s)
            patch = x[i, y0:y0 + crop, x0:x0 + crop]
            if u < np.float32(0.5):
                patch = patch[:, ::-1]
        else:
            y0, x0 = max_y // 2, max_x // 2
            patch = x[i, y0:y0 + crop, x0:x0 + crop]
        out[i] = (np.asarray(patch, np.float32) - mean) / std
    return out
