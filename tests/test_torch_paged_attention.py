"""The port's paged decode and verify attention (frl_distributed_ml_scaffold_
tpu_torch/ops/decode_attention.py) held against the JAX package's paged
Pallas kernels, run in interpret mode on the CPU, and its dense references.

Inputs are made from a numpy seed: a pool of ``B * M + 1`` blocks (block 0
the trash block) and shuffled tables. On the CPU the port's routers take
their plain versions (the CUDA kernels run only on the card:
tests/test_torch_kernels_cuda.py and ``chip_smoke.py``).

Tolerances: fp32 2e-6 (summation order and exp only); bf16 2e-2 (both
round the output to bf16, and the Pallas kernels round unnormalised
probabilities where the plain versions round normalised ones).
"""

from __future__ import annotations

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frl_distributed_ml_scaffold_tpu_torch.ops import _build
from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as tda

jda = importlib.import_module(
    "frl_distributed_ml_scaffold_tpu.ops.decode_attention"
)

B, S, H, D, T = 4, 64, 4, 32, 5
TOL = {"float32": 2e-6, "bfloat16": 2e-2}
OCCUPANCY = {
    "one": [1, 1, 1, 1],
    "block_edges": [8, 9, 16, 17],
    "mid": [T, 40, 23, 63],
    "full": [S, S, S, S],
    "retired": [S + 9, T + 2, S, S + 100],
}


def _inputs(seed: int, bs: int, kv_len, t: int | None = None):
    """q ([B, H, D] or [B, t, H, D]), pools [B*M + 1, bs, H, D], shuffled
    tables [B, M] over blocks 1.., kv_len [B]."""
    rng = np.random.default_rng(seed)
    m = S // bs
    n = B * m + 1
    qshape = (B, H, D) if t is None else (B, t, H, D)
    q = rng.standard_normal(qshape).astype(np.float32)
    k = rng.standard_normal((n, bs, H, D)).astype(np.float32)
    v = rng.standard_normal((n, bs, H, D)).astype(np.float32)
    tables = (rng.permutation(n - 1) + 1).reshape(B, m).astype(np.int32)
    return q, k, v, np.asarray(kv_len, np.int32), tables


def _jax(fn, q, k, v, kv_len, tables, dtype, **kw):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    out = fn(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(kv_len), jnp.asarray(tables), **kw,
    )
    return np.asarray(out.astype(jnp.float32))


def _port(fn, q, k, v, kv_len, tables, dtype, **kw):
    tdt = getattr(torch, dtype)
    qt = torch.from_numpy(q).to(tdt)
    out = fn(
        qt, torch.from_numpy(k).to(tdt), torch.from_numpy(v).to(tdt),
        torch.from_numpy(kv_len), torch.from_numpy(tables), **kw,
    )
    assert out.dtype == tdt and out.shape == qt.shape
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("occupancy", sorted(OCCUPANCY))
def test_paged_decode_matches_pallas_kernel(dtype, bs, occupancy):
    args = _inputs(0, bs, OCCUPANCY[occupancy])
    got = _port(tda.paged_decode_attention, *args, dtype)
    np.testing.assert_allclose(
        got, _jax(jda._local_paged_decode, *args, dtype, impl="flash",
                  interpret=True),
        atol=TOL[dtype], rtol=0,
    )
    if dtype == "float32":
        lens = np.maximum(args[3], 1)
        np.testing.assert_allclose(
            got, _jax(jda.dense_paged_decode_attention, *args[:3], lens,
                      args[4], dtype),
            atol=TOL[dtype], rtol=0,
        )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("occupancy", ["mid", "block_edges", "full", "retired"])
def test_paged_verify_matches_pallas_kernel(dtype, bs, occupancy):
    args = _inputs(1, bs, OCCUPANCY[occupancy], t=T)
    got = _port(tda.paged_verify_attention, *args, dtype)
    np.testing.assert_allclose(
        got, _jax(jda._local_paged_verify, *args, dtype, impl="flash",
                  interpret=True),
        atol=TOL[dtype], rtol=0,
    )
    if dtype == "float32":
        np.testing.assert_allclose(
            got, _jax(jda.dense_paged_verify_attention, *args, dtype),
            atol=TOL[dtype], rtol=0,
        )


@pytest.mark.parametrize("bs", [8, 16])
def test_verify_position_j_equals_decode_at_its_occupancy(bs):
    """Query j of a tile at total occupancy L is the single-token decode
    at occupancy L - T + 1 + j, bit for bit (the property greedy
    acceptance rests on)."""
    q, k, v, kv_len, tables = _inputs(2, bs, [T, 17, 40, S], t=T)
    tile = _port(tda.paged_verify_attention, q, k, v, kv_len, tables,
                 "float32")
    for j in range(T):
        dec = _port(tda.paged_decode_attention, np.ascontiguousarray(q[:, j]),
                    k, v, kv_len - T + 1 + j, tables, "float32")
        np.testing.assert_array_equal(tile[:, j], dec)


@pytest.mark.parametrize("op", ["decode", "verify"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dirty_blocks_leave_the_output_bit_identical(op, dtype):
    """Blocks no row's occupancy reaches, and positions past occupancy
    in the blocks it does, contribute exactly nothing: fill them with
    large garbage and the output is bit-identical."""
    bs = 8
    t = T if op == "verify" else None
    fn = getattr(tda, f"paged_{op}_attention")
    q, k, v, kv_len, tables = _inputs(3, bs, [T, 17, 9, 33], t=t)
    # Rows 2 and 3 reach only part of their tables; the rest is dirty.
    clean = _port(fn, q, k, v, kv_len, tables, dtype)
    kd, vd = k.copy(), v.copy()
    used = np.zeros(k.shape[:2], bool)
    for row, n in enumerate(kv_len):
        for p in range(min(int(n), S)):
            used[tables[row, p // bs], p % bs] = True
    kd[~used], vd[~used] = 1e4, -1e4
    np.testing.assert_array_equal(
        _port(fn, q, kd, vd, kv_len, tables, dtype), clean
    )


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    tda.paged_decode_attention.launches = 0
    tda.paged_verify_attention.launches = 0
    dec = _inputs(4, 8, OCCUPANCY["mid"])
    ver = _inputs(4, 8, OCCUPANCY["mid"], t=T)
    np.testing.assert_array_equal(
        _port(tda.paged_decode_attention, *dec, "float32"),
        _port(tda.dense_paged_decode_attention, *dec, "float32"),
    )
    np.testing.assert_array_equal(
        _port(tda.paged_verify_attention, *ver, "float32", impl="dense"),
        _port(tda.dense_paged_verify_attention, *ver, "float32"),
    )
    assert tda.paged_decode_attention.launches == 0
    assert tda.paged_verify_attention.launches == 0


@pytest.mark.parametrize("op", ["decode", "verify"])
def test_paged_refusals(op):
    fn = getattr(tda, f"paged_{op}_attention")
    q, k, v, kv_len, tables = (
        torch.from_numpy(a)
        for a in _inputs(5, 8, OCCUPANCY["mid"], t=T if op == "verify" else None)
    )
    with pytest.raises(ValueError, match="must be passed together"):
        fn(q, k, v, kv_len, tables, v_scale=kv_len)
    with pytest.raises(KeyError, match="unknown decode_attention impl"):
        fn(q, k, v, kv_len, tables, impl="paged")


@pytest.mark.parametrize(
    "case",
    ["head_dim", "dtype", "block_size", "table_dtype", "pool_mismatch",
     "q_rank", "tile"],
)
def test_paged_kernel_argument_checks(case):
    """What the CUDA kernels do not take is refused in Python before any
    pointer is handed over (checked here on CPU tensors)."""
    q = torch.zeros(B, T, H, D)
    k = torch.zeros(2 * B + 1, 8, H, D)
    v = torch.zeros(2 * B + 1, 8, H, D)
    kv_len = torch.full((B,), T, dtype=torch.int32)
    tables = torch.ones(B, 8, dtype=torch.int32)
    want, err = 4, ValueError
    if case == "head_dim":
        q, k, v = q[..., :16], k[..., :16], v[..., :16]
    elif case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
        err = TypeError
    elif case == "block_size":
        k, v = k[:, :6], v[:, :6]
    elif case == "table_dtype":
        tables = tables.long()
    elif case == "pool_mismatch":
        v = torch.zeros(2 * B + 1, 16, H, D)[:, :8]
    elif case == "q_rank":
        want = 3
    else:
        with pytest.raises(ValueError, match="verify tile"):
            tda._flash_paged_verify(
                torch.zeros(B, tda.MAX_VERIFY_TILE + 1, H, D), k, v, kv_len,
                tables,
            )
        return
    with pytest.raises(err):
        tda._check_paged_args(q, k, v, kv_len, tables, want)


def test_paged_kernel_source_is_found():
    assert "paged_attention" in _build.sources()
    assert _build.library_path("paged_attention").parent == _build.BUILD_DIR


@pytest.mark.parametrize(
    "bh, cap, sms, want",
    [
        (128, 1024, 132, 1),  # the serving path: 8 slots x 16 heads
        (384, 1024, 132, 1),  # 24 slots: B*H >= SMs
        (16, 2048, 132, 8),   # one slot: capped at the cluster size
        (16, 1024, 132, 4),   # one slot: one split per 256 positions
        (32, 1024, 132, 4),   # 2 slots
        (64, 256, 132, 1),    # one table of 256 positions: no split
        (66, 4096, 132, 2),
        (1, 16, 132, 1),
    ],
)
def test_paged_split_count_rule(bh, cap, sms, want):
    """The paged kernels' split count for bf16 q: about one CTA per SM in
    all, 1 from B*H >= SMs, at most 8 (one cluster), one per 256
    positions of the table's capacity."""
    got = tda.paged_splits(bh, cap, sms)
    assert got == want
    assert 1 <= got <= tda.MAX_DECODE_SPLITS


def _recording_launch(monkeypatch, calls):
    """Run the paged launch wrappers on CPU tensors with a stand-in for
    the CUDA entry point that records its arguments (and a fixed SM
    count and stream), so the host side is checked without a card."""
    def bind(source, name, n_ptr, n_int, n_long):
        def fn(*args):
            calls.append({"name": name, "n_ptr": n_ptr, "n_int": n_int,
                          "ints": args[n_ptr: n_ptr + n_int]})
            return 0
        return fn

    monkeypatch.setattr(tda, "_bind", bind)
    monkeypatch.setattr(tda, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    for router in (tda.paged_decode_attention, tda.paged_verify_attention):
        monkeypatch.setattr(router, "launches", router.launches)


@pytest.mark.parametrize("op", ["decode", "verify"])
def test_paged_split_count_never_reads_the_occupancy(op, monkeypatch):
    """The split count comes from B*H, the table's capacity and the SM
    count only (paged_splits takes nothing else), so the decode at n and
    the verify at n + T - 1 partition positions alike; it is the entry
    point's last int argument, and an explicit count overrides it."""
    import inspect

    assert list(inspect.signature(tda.paged_splits).parameters) == [
        "bh", "cap", "sm_count"]
    calls = []
    _recording_launch(monkeypatch, calls)
    t = T if op == "verify" else None
    q, k, v, _, tables = (torch.from_numpy(a) for a in
                          _inputs(7, 16, OCCUPANCY["mid"], t=t))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    launch = getattr(tda, f"_flash_paged_{op}")
    for lens in ([1, 1, 1, 1], [T, 40, 23, 63], [S, S + 9, 7, S]):
        launch(q, k, v, torch.tensor(lens, dtype=torch.int32), tables)
    launch(q, k, v, torch.ones(B, dtype=torch.int32), tables, splits=3)
    want = tda.paged_splits(B * H, tables.shape[1] * k.shape[1], 132)
    assert [c["ints"][-1] for c in calls] == [want, want, want, 3]
    assert all(c["name"] == f"frl_paged_{op}_attention"
               and c["n_int"] == 9 for c in calls)


@pytest.mark.parametrize("case", ["misaligned_base", "position_stride",
                                  "block_stride"])
def test_paged_kernels_refuse_pools_they_cannot_read_16_bytes_at_a_time(case):
    """The pools must be 16-byte aligned with N, bs and H strides in
    multiples of 16 bytes: the kernels copy a position's head slice 16
    bytes at a time. The wrapper raises rather than copying the pool; the
    model's per-layer views of one [L, N, bs, H, D] allocation pass."""
    q = torch.zeros(B, T, H, D, dtype=torch.bfloat16)
    kv_len = torch.full((B,), T, dtype=torch.int32)
    tables = torch.ones(B, 8, dtype=torch.int32)
    n, bs = 2 * B + 1, 8
    size = n * bs * H * D
    if case == "misaligned_base":
        flat = torch.zeros(size + 8, dtype=torch.bfloat16)
        off = next(i for i in range(1, 8) if flat[i:].data_ptr() % 16)
        k = flat[off: off + size].view(n, bs, H, D)
    elif case == "position_stride":
        # Each position's [H, D] followed by 4 bf16 (8 bytes) of padding.
        k = torch.zeros(n, bs, H * D + 4, dtype=torch.bfloat16)
        k = k[..., : H * D].unflatten(2, (H, D))
    else:
        # Each block followed by 4 bf16 (8 bytes) of padding.
        k = torch.zeros(n, bs * H * D + 4, dtype=torch.bfloat16)
        k = k[:, : bs * H * D].view(n, bs, H, D)
    with pytest.raises(ValueError, match="16 bytes at a time"):
        tda._check_paged_args(q, k, k, kv_len, tables, 4)
    layers = torch.zeros(3, n, bs, H, D, dtype=torch.bfloat16)
    tda._check_paged_args(q, layers[1], layers[2], kv_len, tables, 4)
