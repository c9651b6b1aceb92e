"""flax's msgpack params files, read and written in plain Python.

The JAX package saves and loads a params tree with flax's
``serialization.to_bytes`` / ``msgpack_restore`` (``tools/
import_hf_gpt2.py`` writes one, ``trainer.init_params_path`` reads one).
This module is their counterpart without ``msgpack`` or flax:

- the tree is nested maps with string keys; a leaf array is msgpack ext
  type 1 holding the msgpack array ``(shape, dtype name, C-order
  bytes)``; a numpy scalar is ext type 3 with the same payload;
- an array of more than ``MAX_CHUNK_SIZE`` bytes is stored as flax's
  chunked map: ``{"__msgpack_chunked_array__": True, "shape": {"0": d0,
  ...}, "chunks": {"0": flat[:n], "1": flat[n:2n], ...}}``, ``n`` the
  chunk size in elements;
- ``bfloat16`` is a dtype name like any other: its bytes are the
  tensor's through a ``uint16`` view.

``load`` reads the file into one buffer and returns CPU tensors that
alias it (a chunked leaf is the one concatenation); nothing else copies
the bytes. ``dumps`` writes what ``to_bytes`` writes for the same tree,
byte for byte: the msgpack encodings are the smallest ones, as the
``msgpack`` package packs them (``use_bin_type=True``, so ``str8`` and
``bin``). It writes what a params tree holds (maps with string keys,
arrays, numpy scalars); anything else, a tuple or a float, raises.
"""

from __future__ import annotations

import os
import struct
import warnings
from typing import Any, BinaryIO

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax's: msgpack caps one object at 2**31 - 1
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_SCALAR = 1, 3

_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


# ------------------------------------------------------------------ reading


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf, self.pos = buf, 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def obj(self) -> Any:
        b = self.uint(1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):  # bin 8 / 16 / 32
            return self.take(self.uint(1 << (b - 0xC4)))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8 / 16 / 32
            n = self.uint(1 << (b - 0xC7))
            return self.ext(self.sint(1), self.take(n))
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:  # uint 8 / 16 / 32 / 64
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:  # int 8 / 16 / 32 / 64
            return self.sint(1 << (b - 0xD0))
        if 0xD4 <= b <= 0xD8:  # fixext 1 / 2 / 4 / 8 / 16
            code = self.sint(1)
            return self.ext(code, self.take(1 << (b - 0xD4)))
        if b in (0xD9, 0xDA, 0xDB):  # str 8 / 16 / 32
            return str(self.take(self.uint(1 << (b - 0xD9))), "utf-8")
        if b in (0xDC, 0xDD):  # array 16 / 32
            return [self.obj() for _ in range(self.uint(2 << (b - 0xDC)))]
        if b in (0xDE, 0xDF):  # map 16 / 32
            return self.map(self.uint(2 << (b - 0xDE)))
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        if _CHUNKED in out:
            return _unchunk(out)
        return out

    def ext(self, code: int, data: memoryview) -> Any:
        if code not in (_EXT_NDARRAY, _EXT_SCALAR):
            raise ValueError(f"msgpack ext type {code} is not a flax array")
        shape, name, raw = _Reader(data).obj()
        if name not in _DTYPES:
            raise ValueError(f"array dtype {name!r} is not supported "
                             f"(have {sorted(_DTYPES)})")
        dtype = _DTYPES[name]
        if len(raw) == 0:
            return torch.empty(shape, dtype=dtype)
        with warnings.catch_warnings():
            # A read-only buffer (``loads`` of bytes): the tensors are
            # only read, cast and moved, never written.
            warnings.filterwarnings("ignore", "The given buffer is not "
                                    "writable")
            return torch.frombuffer(raw, dtype=dtype).reshape(shape)


def _unchunk(data: dict) -> torch.Tensor:
    shape = [data["shape"][str(i)] for i in range(len(data["shape"]))]
    chunks = [data["chunks"][str(i)] for i in range(len(data["chunks"]))]
    return torch.cat(chunks).reshape(shape)


def loads(data) -> Any:
    """The tree encoded in ``data`` (bytes, bytearray or memoryview):
    nested dicts of CPU tensors that alias ``data``."""
    reader = _Reader(memoryview(data).cast("B"))
    tree = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the "
                         "msgpack object")
    return tree


def load(path: str) -> Any:
    """``msgpack_restore`` of the file at ``path``: the file is read once
    into a buffer that the returned tensors alias."""
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as fh:
        if fh.readinto(buf) != len(buf):
            raise ValueError(f"{path}: short read")
    return loads(buf)


# ------------------------------------------------------------------ writing


def _head(out: list, fix: int, fix_max: int, codes: tuple, n: int) -> None:
    """A length-prefixed header: the fix form below ``fix_max``, else the
    first of ``codes`` (1-, 2- then 4-byte lengths, or 2- then 4-byte
    when two codes are given) whose length field holds ``n``."""
    if n < fix_max:
        out.append(bytes([fix | n]))
        return
    widths = (1, 2, 4)[-len(codes):]
    for code, width in zip(codes, widths):
        if n < 1 << (8 * width):
            out.append(bytes([code]) + n.to_bytes(width, "big"))
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _int(out: list, o: int) -> None:
    if 0 <= o < 0x80 or -32 <= o < 0:
        out.append(struct.pack(">b" if o < 0 else ">B", o))
        return
    for code, fmt, lo, hi in ((0xCC, ">B", 0, 0xFF), (0xD0, ">b", -0x80, 0),
                              (0xCD, ">H", 0, 0xFFFF),
                              (0xD1, ">h", -0x8000, 0),
                              (0xCE, ">I", 0, 0xFFFFFFFF),
                              (0xD2, ">i", -0x80000000, 0),
                              (0xCF, ">Q", 0, 0xFFFFFFFFFFFFFFFF),
                              (0xD3, ">q", -0x8000000000000000, 0)):
        if lo <= o <= hi:
            out.append(bytes([code]) + struct.pack(fmt, o))
            return
    raise OverflowError(f"integer {o} does not fit msgpack")


def _raw(x) -> tuple[tuple, str, memoryview]:
    """(shape, dtype name, C-order bytes) of a tensor or numpy array,
    the bytes viewed, not copied, where the array is contiguous."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise TypeError(f"dtype {t.dtype} is not supported")
        if t.numel() == 0:
            return tuple(t.shape), _NAMES[t.dtype], memoryview(b"")
        flat = t.reshape(-1).view(torch.uint8)
        return tuple(t.shape), _NAMES[t.dtype], memoryview(flat.numpy())
    a = np.asarray(x)
    if not a.flags.c_contiguous:
        a = a.copy(order="C")
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("Object and structured dtypes not supported "
                         "for serialization of ndarrays.")
    return a.shape, a.dtype.name, memoryview(a.reshape(-1).view(np.uint8))


def _array(out: list, x, code: int) -> None:
    shape, name, data = _raw(x)
    inner: list = []
    _head(inner, 0x90, 16, (0xDC, 0xDD), 3)
    _head(inner, 0x90, 16, (0xDC, 0xDD), len(shape))
    for d in shape:
        _int(inner, int(d))
    _str(inner, name)
    _head(inner, 0x100, 0, (0xC4, 0xC5, 0xC6), len(data))
    n = sum(len(p) for p in inner) + len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(bytes([fixext[n], code]))
    else:
        _head(out, 0x100, 0, (0xC7, 0xC8, 0xC9), n)
        out.append(bytes([code]))
    out.extend(inner)
    out.append(data)


def _str(out: list, s: str) -> None:
    b = s.encode("utf-8")
    _head(out, 0xA0, 32, (0xD9, 0xDA, 0xDB), len(b))
    out.append(b)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(np.asarray(x).nbytes)


def _chunk(x) -> dict:
    """flax's ``_chunk``: the flat array cut into ``MAX_CHUNK_SIZE``-byte
    pieces (views)."""
    a = x if isinstance(x, torch.Tensor) else np.asarray(x)
    itemsize = a.element_size() if isinstance(a, torch.Tensor) else (
        a.dtype.itemsize)
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = a.reshape(-1)
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(a.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in
                       enumerate(range(0, flat.shape[0], size))}}


def _is_array(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def _pack(out: list, o) -> None:
    """One object of a params tree: a map with string keys, an array or
    numpy scalar, and the bools and ints of a chunked map."""
    if o is True or o is False:
        out.append(b"\xc3" if o else b"\xc2")
    elif type(o) is int:
        _int(out, o)
    elif type(o) is str:
        _str(out, o)
    elif type(o) is dict:
        _head(out, 0x80, 16, (0xDE, 0xDF), len(o))
        for k, v in o.items():
            _pack(out, k)
            if _is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE:
                v = _chunk(v)
            _pack(out, v)
    elif _is_array(o):
        _array(out, o, _EXT_NDARRAY)
    elif isinstance(o, np.generic):
        _array(out, np.asarray(o), _EXT_SCALAR)
    else:
        raise TypeError(f"can not serialize {type(o).__name__!r} object")


def _pieces(tree) -> list:
    if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        tree = _chunk(tree)
    out: list = []
    _pack(out, tree)
    return out


def dumps(tree) -> bytes:
    """``to_bytes`` of ``tree``: nested dicts (string keys) of tensors or
    numpy arrays."""
    return b"".join(_pieces(tree))


def dump(tree, fh: BinaryIO) -> None:
    """``dumps`` written piece by piece to ``fh``: the array bytes go out
    as views, with no joined copy of the file in memory."""
    for piece in _pieces(tree):
        fh.write(piece)
