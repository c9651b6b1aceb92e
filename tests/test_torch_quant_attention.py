"""The port's decode attention over a QUANTIZED cache (frl_distributed_ml_
scaffold_tpu_torch/ops/decode_attention.py, ``k_scale``/``v_scale``) held
against the JAX package's quantized Pallas kernels (``_decode_kernel_quant``,
``_paged_decode_kernel_quant``, ``_paged_verify_kernel_quant``) run in
interpret mode on the CPU, and against its dense quantized references.

Inputs are made from a numpy seed and quantized ONCE by the JAX package
(per (row, position, head), scales stored in bf16, as its model stores
them); the same bytes go to both packages. On the CPU the port's routers
take their plain versions (the CUDA kernels run only on the card:
tests/test_torch_kernels_cuda.py and ``chip_smoke.py``).

Tolerances: fp32 2e-6 (summation order and exp only: both versions
compute in fp32 from the same payloads and scales); bf16 2e-2 (both round
the output to bf16, ulp 2^-7 relative at |o| <= 4).
"""

from __future__ import annotations

import ctypes
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frl_distributed_ml_scaffold_tpu_torch.ops import _build
from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as tda
from frl_distributed_ml_scaffold_tpu_torch.ops.quantization import byte_view

jda = importlib.import_module(
    "frl_distributed_ml_scaffold_tpu.ops.decode_attention"
)
jq = importlib.import_module("frl_distributed_ml_scaffold_tpu.ops.quantization")

B, S, H, D, T = 4, 64, 4, 32, 5
TOL = {"float32": 2e-6, "bfloat16": 2e-2}
FORMATS = ["int8", "fp8_e4m3"]
OCCUPANCY = {
    "mixed": [1, 33, S, S + 1],
    "past_capacity": [S + 9, 3, S, S + 100],
}


_TORCH = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn,
          "fp8_e5m2": torch.float8_e5m2}


class Cache:
    """One quantized K/V pair: the JAX arrays and the port's tensors,
    holding the same payload bytes and bf16 scales."""

    def __init__(self, k, v, fmt):
        self.j = []
        self.t = []
        for x in (k, v):
            qx, sx = jq.quantize(jnp.asarray(x), fmt, channel_axes=tuple(
                range(x.ndim - 1)))
            sx = sx[..., 0].astype(jnp.bfloat16)
            self.j.append((qx, sx))
            payload = torch.from_numpy(np.asarray(qx).view(np.uint8).copy())
            self.t.append((
                payload.view(_TORCH[fmt]),
                torch.from_numpy(np.asarray(sx, np.float32)).to(torch.bfloat16),
            ))

    def jax(self):
        (k, ks), (v, vs) = self.j
        return k, v, dict(k_scale=ks, v_scale=vs)

    def port(self):
        (k, ks), (v, vs) = self.t
        return k, v, dict(k_scale=ks, v_scale=vs)


def _contiguous(seed, fmt, kv_len):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, H, D)).astype(np.float32)
    v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, Cache(k, v, fmt), np.asarray(kv_len, np.int32)


def _paged(seed, fmt, bs, kv_len, t=None):
    """q, quantized pools [B*M + 1, bs, H, D] (block 0 the trash block),
    shuffled tables [B, M] over blocks 1.., kv_len."""
    rng = np.random.default_rng(seed)
    m = S // bs
    n = B * m + 1
    qshape = (B, H, D) if t is None else (B, t, H, D)
    q = rng.standard_normal(qshape).astype(np.float32)
    k = rng.standard_normal((n, bs, H, D)).astype(np.float32)
    v = rng.standard_normal((n, bs, H, D)).astype(np.float32)
    tables = (rng.permutation(n - 1) + 1).reshape(B, m).astype(np.int32)
    return q, Cache(k, v, fmt), np.asarray(kv_len, np.int32), tables


def _jax_out(fn, q, cache, *args, dtype, **kw):
    k, v, sc = cache.jax()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    out = fn(jnp.asarray(q, jdt), k, v, *(jnp.asarray(a) for a in args),
             **sc, **kw)
    return np.asarray(out.astype(jnp.float32))


def _port_out(fn, q, cache, *args, dtype, **kw):
    k, v, sc = cache.port()
    tdt = getattr(torch, dtype)
    qt = torch.from_numpy(q).to(tdt)
    out = fn(qt, k, v, *(torch.from_numpy(a) for a in args), **sc, **kw)
    assert out.dtype == tdt and out.shape == qt.shape
    return out.float().numpy()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("occupancy", ["mixed", "past_capacity"])
def test_decode_quant_matches_pallas_kernel(fmt, dtype, occupancy):
    q, cache, kv_len = _contiguous(0, fmt, OCCUPANCY[occupancy])
    got = _port_out(tda.decode_attention, q, cache, kv_len, dtype=dtype)
    np.testing.assert_allclose(
        got, _jax_out(jda._local_decode, q, cache, kv_len, dtype=dtype,
                      impl="flash", interpret=True),
        atol=TOL[dtype], rtol=0,
    )
    if dtype == "float32":
        lens = np.maximum(kv_len, 1)
        k, v, sc = cache.jax()
        want = jda.dense_decode_attention_quant(
            jnp.asarray(q), k, v, jnp.asarray(lens), sc["k_scale"],
            sc["v_scale"],
        )
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL[dtype],
                                   rtol=0)
        k, v, sc = cache.port()
        np.testing.assert_array_equal(
            got,
            tda.dense_decode_attention_quant(
                torch.from_numpy(q), k, v, torch.from_numpy(lens),
                sc["k_scale"], sc["v_scale"],
            ).numpy(),
        )


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [8, 16])
def test_paged_decode_quant_matches_pallas_kernel(fmt, dtype, bs):
    q, cache, kv_len, tables = _paged(1, fmt, bs, [1, 17, S, S + 9])
    got = _port_out(tda.paged_decode_attention, q, cache, kv_len, tables,
                    dtype=dtype)
    np.testing.assert_allclose(
        got, _jax_out(jda._local_paged_decode, q, cache, kv_len, tables,
                      dtype=dtype, impl="flash", interpret=True),
        atol=TOL[dtype], rtol=0,
    )
    if dtype == "float32":
        np.testing.assert_allclose(
            got, _jax_out(jda._local_paged_decode, q, cache, kv_len, tables,
                          dtype=dtype, impl="dense", interpret=None),
            atol=TOL[dtype], rtol=0,
        )


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [8, 16])
def test_paged_verify_quant_matches_pallas_kernel(fmt, dtype, bs):
    q, cache, kv_len, tables = _paged(2, fmt, bs, [T, 23, S, S + 2], t=T)
    got = _port_out(tda.paged_verify_attention, q, cache, kv_len, tables,
                    dtype=dtype)
    np.testing.assert_allclose(
        got, _jax_out(jda._local_paged_verify, q, cache, kv_len, tables,
                      dtype=dtype, impl="flash", interpret=True),
        atol=TOL[dtype], rtol=0,
    )
    if dtype == "float32":
        np.testing.assert_allclose(
            got, _jax_out(jda._local_paged_verify, q, cache, kv_len, tables,
                          dtype=dtype, impl="dense", interpret=None),
            atol=TOL[dtype], rtol=0,
        )


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_verify_position_j_equals_decode_at_its_occupancy(fmt):
    """Query j of a tile at total occupancy L is the single-token decode
    at occupancy L - T + 1 + j, bit for bit (greedy acceptance over a
    quantized pool rests on it)."""
    q, cache, kv_len, tables = _paged(3, fmt, 8, [T, 17, 40, S], t=T)
    tile = _port_out(tda.paged_verify_attention, q, cache, kv_len, tables,
                     dtype="float32")
    for j in range(T):
        dec = _port_out(tda.paged_decode_attention,
                        np.ascontiguousarray(q[:, j]), cache,
                        kv_len - T + 1 + j, tables, dtype="float32")
        np.testing.assert_array_equal(tile[:, j], dec)


def _poison(cache: Cache, fmt: str, dead: np.ndarray) -> Cache:
    """A copy of the port's side of ``cache`` with NaN scales and, where
    the format has one, NaN payloads (int8 has none: its largest value)
    wherever ``dead`` ([rows, positions]) is True."""
    bad = {"int8": 0x7F, "fp8_e4m3": 0x7F, "fp8_e5m2": 0x7F}[fmt]
    d = torch.from_numpy(dead)
    out = object.__new__(Cache)
    out.t = []
    for payload, scale in cache.t:
        p, s = payload.clone(), scale.clone()
        byte_view(p)[d] = bad
        s[d] = float("nan")
        out.t.append((p, s))
    return out


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("op", ["contiguous", "decode", "verify"])
def test_dirty_cache_leaves_the_output_bit_identical(fmt, op):
    """Every position no row's occupancy reaches, payload and scale,
    poisoned (NaN scales; NaN payloads where the format has them): the
    output is bit-identical."""
    if op == "contiguous":
        q, cache, kv_len = _contiguous(4, fmt, [1, 33, S, S + 1])
        args, fn = (kv_len,), tda.decode_attention
        dead = np.arange(S)[None, :] >= kv_len[:, None]
    else:
        t = T if op == "verify" else None
        q, cache, kv_len, tables = _paged(5, fmt, 8, [T, 17, 9, 33], t=t)
        args = (kv_len, tables)
        fn = getattr(tda, f"paged_{op}_attention")
        dead = np.ones(cache.t[0][0].shape[:2], bool)
        for row, n in enumerate(kv_len):
            for p in range(min(int(n), S)):
                dead[tables[row, p // 8], p % 8] = False
    assert dead.any()
    for dtype in ("float32", "bfloat16"):
        clean = _port_out(fn, q, cache, *args, dtype=dtype)
        dirty = _port_out(fn, q, _poison(cache, fmt, dead), *args, dtype=dtype)
        assert np.isfinite(clean).all()
        np.testing.assert_array_equal(dirty, clean)


@pytest.mark.parametrize("op", ["contiguous", "decode", "verify"])
def test_one_scale_without_the_other_raises(op):
    if op == "contiguous":
        q, cache, kv_len = _contiguous(6, "int8", OCCUPANCY["mixed"])
        k, v, sc = cache.port()
        args, fn = (torch.from_numpy(kv_len),), tda.decode_attention
        what = "cache"
    else:
        t = T if op == "verify" else None
        q, cache, kv_len, tables = _paged(6, "int8", 8, OCCUPANCY["mixed"], t=t)
        k, v, sc = cache.port()
        args = (torch.from_numpy(kv_len), torch.from_numpy(tables))
        fn = getattr(tda, f"paged_{op}_attention")
        what = "pool"
    q = torch.from_numpy(q)
    for one in ({"k_scale": sc["k_scale"]}, {"v_scale": sc["v_scale"]}):
        with pytest.raises(ValueError, match=f"a quantized {what} quantizes "
                           "both of its halves"):
            fn(q, k, v, *args, **one)
    for impl in ("dense", "flash"):
        assert np.isfinite(fn(q, k, v, *args, **sc, impl=impl).numpy()).all()


def test_cpu_quant_takes_the_plain_version_and_launches_nothing():
    routers = (tda.decode_attention, tda.paged_decode_attention,
               tda.paged_verify_attention)
    for r in routers:
        r.launches = r.quant_launches = 0
    q, cache, kv_len = _contiguous(7, "fp8_e4m3", OCCUPANCY["mixed"])
    np.testing.assert_array_equal(
        _port_out(tda.decode_attention, q, cache, kv_len, dtype="float32"),
        _port_out(tda.decode_attention, q, cache, kv_len, dtype="float32",
                  impl="dense"),
    )
    q, cache, kv_len, tables = _paged(7, "fp8_e4m3", 8, [1, 9, 30, S], t=T)
    k, v, sc = cache.port()
    np.testing.assert_array_equal(
        _port_out(tda.paged_verify_attention, q, cache, kv_len, tables,
                  dtype="float32"),
        tda.dense_paged_verify_attention(
            torch.from_numpy(q), k, v, torch.from_numpy(kv_len),
            torch.from_numpy(tables), sc["k_scale"], sc["v_scale"],
        ).numpy(),
    )
    assert all(r.launches == r.quant_launches == 0 for r in routers)


@pytest.mark.parametrize(
    "case",
    ["payload_dtype", "mixed_payloads", "scale_dtype", "scale_shape",
     "scale_strides", "head_dim", "q_dtype"],
)
@pytest.mark.parametrize("op", ["contiguous", "paged"])
def test_quant_kernel_argument_checks(case, op):
    """What the quantized CUDA kernels do not take is refused in Python
    before any pointer is handed over (checked here on CPU tensors)."""
    lead = (B, S, H) if op == "contiguous" else (2 * B + 1, 8, H)
    q = torch.zeros((B, H, D) if op == "contiguous" else (B, T, H, D))
    k = torch.zeros((*lead, D), dtype=torch.int8)
    v = torch.zeros((*lead, D), dtype=torch.int8)
    ks = torch.ones(lead, dtype=torch.bfloat16)
    vs = torch.ones(lead, dtype=torch.bfloat16)
    kv_len = torch.full((B,), T, dtype=torch.int32)
    err = ValueError
    if case == "payload_dtype":
        k, v, err = k.half(), v.half(), TypeError
    elif case == "mixed_payloads":
        v, err = v.view(torch.float8_e4m3fn), TypeError
    elif case == "scale_dtype":
        ks = ks.float()
    elif case == "scale_shape":
        ks = ks[:, :-1]
    elif case == "scale_strides":
        vs = torch.ones((*lead[:-1], 2 * H), dtype=torch.bfloat16)[..., :H]
    elif case == "head_dim":
        q, k, v = q[..., :16], k[..., :16], v[..., :16]
    else:
        q, err = q.half(), TypeError
    with pytest.raises(err):
        if op == "contiguous":
            tda._check_kernel_args(q, k, v, kv_len, ks, vs)
        else:
            tables = torch.ones(B, 8, dtype=torch.int32)
            tda._check_paged_args(q, k, v, kv_len, tables, 4, ks, vs)


def test_quant_kernel_source_is_found():
    assert "quant_attention" in _build.sources()
    assert _build.library_path("quant_attention").parent == _build.BUILD_DIR


@pytest.mark.parametrize("case", ["misaligned_base", "head_stride"])
def test_quant_paged_kernels_refuse_pools_they_cannot_read_16_bytes_at_a_time(
        case):
    """A quantized pool must be 16-byte aligned with N, bs and H strides
    in multiples of 16 bytes (one copy carries 16 payload bytes). The
    wrapper raises; the model's per-layer pool views pass."""
    q = torch.zeros(B, T, H, D)
    kv_len = torch.full((B,), T, dtype=torch.int32)
    tables = torch.ones(B, 8, dtype=torch.int32)
    lead = (2 * B + 1, 8, H)
    ks = torch.ones(lead, dtype=torch.bfloat16)
    size = (2 * B + 1) * 8 * H * D
    if case == "misaligned_base":
        flat = torch.zeros(size + 16, dtype=torch.int8)
        off = next(i for i in range(1, 16) if flat[i:].data_ptr() % 16)
        k = flat[off: off + size].view(*lead, D)
    else:
        # Each head's D payload bytes followed by 8 bytes of padding.
        k = torch.zeros((*lead, D + 8), dtype=torch.int8)[..., :D]
    with pytest.raises(ValueError, match="16 bytes at a time"):
        tda._check_paged_args(q, k, k, kv_len, tables, 4, ks, ks.clone())
    layers = torch.zeros((3, *lead, D), dtype=torch.int8)
    tda._check_paged_args(q, layers[0], layers[1], kv_len, tables, 4, ks,
                          ks.clone())


def _recording_launch(monkeypatch, calls):
    """Run the quantized launch wrappers on CPU tensors with a stand-in for
    the CUDA entry point that records its name, its int arguments and the
    kv_len it was handed (read through its pointer, as the kernel reads
    it), with a fixed SM count and stream, so the host side is checked
    without a card. Every quantized entry point takes q, k, v, the two
    scales and kv_len as its first six pointers and B as its first int."""
    def bind(source, name, n_ptr, n_int, n_long):
        def fn(*args):
            lens = (ctypes.c_int32 * args[n_ptr]).from_address(args[5])
            calls.append({"name": name, "n_int": n_int,
                          "ints": args[n_ptr: n_ptr + n_int],
                          "kv_len": list(lens)})
            return 0
        return fn

    monkeypatch.setattr(tda, "_bind", bind)
    monkeypatch.setattr(tda, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    for router in (tda.decode_attention, tda.paged_decode_attention,
                   tda.paged_verify_attention):
        monkeypatch.setattr(router, "quant_launches", router.quant_launches)


def test_quant_paged_launch_passes_the_split_count(monkeypatch):
    """The quantized paged entry points take the split count as their
    last int argument, after the payload format; the default is
    paged_splits' and never depends on the occupancy."""
    calls = []
    _recording_launch(monkeypatch, calls)
    q, cache, _, tables = _paged(3, "fp8_e4m3", 16, [1, 1, 1, 1], t=T)
    k, v, sc = cache.port()
    q = torch.from_numpy(q).bfloat16()
    tables = torch.from_numpy(tables)
    for lens in ([1, 1, 1, 1], [S, S + 9, 7, S]):
        tda._flash_paged_verify(q, k, v, torch.tensor(lens, dtype=torch.int32),
                                tables, **sc)
    tda._flash_paged_decode(q[:, 0], k, v, torch.ones(B, dtype=torch.int32),
                            tables, splits=5, **sc)
    want = tda.paged_splits(B * H, tables.shape[1] * k.shape[1], 132)
    assert [c["name"] for c in calls] == [
        "frl_paged_verify_attention_quant"] * 2 + [
        "frl_paged_decode_attention_quant"]
    assert [c["ints"][-2:] for c in calls] == [(1, want), (1, want), (1, 5)]
    assert [c["kv_len"] for c in calls] == [[1, 1, 1, 1], [S, S + 9, 7, S],
                                            [1, 1, 1, 1]]


# The contiguous launch's host side at a capacity that splits: S_SPLIT
# positions, B*H = 16 rows and heads on 132 SMs (decode_splits: 4).
S_SPLIT = 1024
CONTIGUOUS_LENS = {
    "zero": [0, 0, 0, 0],
    "mixed": [0, 1, 333, S_SPLIT],
    "past_capacity": [S_SPLIT + 37, 3, S_SPLIT, S_SPLIT + 1000],
}


@pytest.mark.parametrize("lens", sorted(CONTIGUOUS_LENS))
@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_decode_launch_passes_the_split_count_and_kv_len_unclamped(
        dtype, fmt, lens, monkeypatch):
    """The router's kernel branch over a quantized contiguous cache hands
    the entry point kv_len as it came (0 and > S included: the kernel
    clamps each row to [1, S], so the router launches no clamp) and
    decode_splits(B*H, S, SMs) as its split count, after the payload
    format; an explicit ``splits=`` overrides it. bf16 q takes the
    tensor-core kernel, fp32 q the CUDA-core one (the count is then
    ignored)."""
    calls = []
    _recording_launch(monkeypatch, calls)
    monkeypatch.setattr(tda, "_use_kernel", lambda q, impl: impl == "flash")
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(
        np.float32)).to(getattr(torch, dtype))
    k, v = (torch.zeros(B, 2 * S_SPLIT, H, D, dtype=torch.int8)[:, :S_SPLIT]
            .view(_TORCH[fmt]) for _ in range(2))
    ks, vs = (torch.ones(B, S_SPLIT, H, dtype=torch.bfloat16)
              for _ in range(2))
    kv_len = torch.tensor(CONTIGUOUS_LENS[lens], dtype=torch.int32)
    out = tda.decode_attention(q, k, v, kv_len, k_scale=ks, v_scale=vs)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert tda.decode_attention.quant_launches == 1
    tda._flash_decode_quant(q, k, v, kv_len, ks, vs, splits=7)
    want = tda.decode_splits(B * H, S_SPLIT, 132)
    assert want == 4
    ids = (B, H, S_SPLIT, D, {"float32": 0, "bfloat16": 1}[dtype],
           {"int8": 0, "fp8_e4m3": 1, "fp8_e5m2": 2}[fmt])
    assert [c["name"] for c in calls] == ["frl_decode_attention_quant"] * 2
    assert [c["ints"] for c in calls] == [(*ids, want), (*ids, 7)]
    assert [c["kv_len"] for c in calls] == [CONTIGUOUS_LENS[lens]] * 2


@pytest.mark.parametrize("case", ["misaligned_base", "row_stride",
                                  "position_stride", "head_stride"])
@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3", "fp8_e5m2"])
def test_quant_decode_kernel_refuses_caches_it_cannot_read_16_bytes_at_a_time(
        fmt, case):
    """With bf16 q the quantized contiguous cache must be 16-byte aligned
    with row, position and head strides in multiples of 16 bytes (one
    copy carries 16 payload bytes): the wrapper raises before any pointer
    is handed over. fp32 q's kernel reads bytes and keeps its rule (a
    padded head still raises: each position's [H, D] must be contiguous).
    The engine's per-layer views of one 2S-capacity buffer pass."""
    q = torch.zeros(B, H, D, dtype=torch.bfloat16)
    kv_len = torch.ones(B, dtype=torch.int32)
    ks = torch.ones(B, S, H, dtype=torch.bfloat16)
    n = B * S * H * D
    if case == "misaligned_base":
        flat = torch.zeros(n + 16, dtype=torch.int8)
        off = next(i for i in range(1, 16) if flat[i:].data_ptr() % 16)
        k = flat[off: off + n].view(B, S, H, D)
    elif case == "row_stride":
        # Each row followed by 8 bytes of padding.
        k = torch.zeros(B, S * H * D + 8, dtype=torch.int8)[:, : S * H * D]
        k = k.view(B, S, H, D)
    elif case == "position_stride":
        # Each position's [H, D] followed by 8 bytes of padding.
        k = torch.zeros(B, S, H * D + 8, dtype=torch.int8)[..., : H * D]
        k = k.unflatten(2, (H, D))
    else:
        # Each head's D payload bytes followed by 8 bytes of padding.
        k = torch.zeros(B, S, H, D + 8, dtype=torch.int8)[..., :D]
    k = k.view(_TORCH[fmt])
    with pytest.raises(ValueError, match="16 bytes at a time"):
        tda._check_kernel_args(q, k, k, kv_len, ks, ks.clone())
    if case == "head_stride":
        with pytest.raises(ValueError, match=r"\[H, D\] contiguous"):
            tda._check_kernel_args(q.float(), k, k, kv_len, ks, ks.clone())
    else:
        tda._check_kernel_args(q.float(), k, k, kv_len, ks, ks.clone())
    layers = torch.zeros(3, B, 2 * S, H, D, dtype=torch.int8)[:, :, :S]
    layers = layers.view(_TORCH[fmt])
    tda._check_kernel_args(q, layers[0], layers[1], kv_len, ks, ks.clone())
