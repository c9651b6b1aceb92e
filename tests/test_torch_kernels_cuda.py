"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda`` and skipped without a card (a CUDA kernel has no CPU
mode). This file imports no JAX, so it also runs on a machine that has
none; there, skip the repository conftest (which sets up JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerances as in test_torch_decode_attention.py: fp32 1e-5, bf16 2e-2;
the flash kernels as in chip_smoke.py (relative to the output's scale);
the BatchNorm-backward and AdamW kernels as in chip_smoke.py.
Caches are poisoned with chip_smoke.py's helper, so both hold the kernels
to one rule.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import numpy as np
import pytest
import torch

from chip_smoke import poisoned
from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as tda
from frl_distributed_ml_scaffold_tpu_torch.ops.quantization import quantize_kv

B, S, H, D = 4, 64, 4, 32
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    """On the card: the CUDA kernel against the plain version, including
    occupancy past capacity and a strided cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, D), (B, S, H, D), (B, S, H, D)))
    kv_len = np.asarray([1, 33, S, S + 1], np.int32)
    q = torch.from_numpy(q).to("cuda", tdt)
    big = torch.zeros(B, 2 * S, H, D, device="cuda", dtype=tdt)
    k_, v_ = big.clone(), big.clone()
    k_[:, :S] = torch.from_numpy(k).to("cuda", tdt)
    v_[:, :S] = torch.from_numpy(v).to("cuda", tdt)
    k_, v_ = k_[:, :S], v_[:, :S]
    lens = torch.from_numpy(kv_len).cuda()
    before = tda.decode_attention.launches
    got = tda.decode_attention(q, k_, v_, lens)
    want = tda.dense_decode_attention(q, k_, v_, lens)
    torch.cuda.synchronize()
    assert tda.decode_attention.launches == before + 1
    torch.testing.assert_close(
        got.float(), want.float(), atol=TOL[dtype], rtol=0
    )


# Split edges of the contiguous kernel: (B, H, S, D, occupancies). The
# path's 8 x 16 (one split) at S = 128 (kv_len 0, which the kernel clamps
# to 1 as the router does), 1024 and 4096 (kv_len 1 and > S, many
# passes), one and two slots (8 and 4 splits, chunks that do not divide
# n), B*H >= 2 x 132 (one split), and head dims with idle lanes (96) and
# two 16-byte chunks a lane (256 fp32), both split 4 ways.
DECODE_EDGES = {
    "S128": (8, 16, 128, 64, [0, 1, 128, 165, 63, 64, 65, 127]),
    "S1024": (8, 16, 1024, 64, [1, 1024, 1061, 1000, 129, 385, 7, 513]),
    "S4096": (8, 16, 4096, 64, [1, 4096, 4200, 3001, 1025, 129, 2, 4095]),
    "one_slot": (1, 16, 4096, 64, [2999]),
    "two_slots": (2, 16, 1024, 64, [1000, 1030]),
    "wide": (24, 16, 256, 64, [1, 256, 300] + list(range(3, 255, 12))),
    "D96": (2, 4, 1024, 96, [1000, 1030]),
    "D256": (2, 2, 1024, 256, [1, 777]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DECODE_EDGES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_decode_kernel_split_edges(dtype, case):
    """On the card: the split-KV kernel against the plain version at the
    edges of its split (empty and ragged chunks, kv_len 1 and > S, one
    split and eight) through a strided q and strided caches; NaN past
    every row's occupancy leaves the output bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    b, h, s, d, lens = DECODE_EDGES[case]
    tdt = getattr(torch, dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = tda.decode_splits(b * h, s, sms)
    assert (splits > 1) == (case in ("one_slot", "two_slots", "D96", "D256"))
    rng = np.random.default_rng(11)
    q = torch.from_numpy(rng.standard_normal((b, h, 2 * d)).astype(
        np.float32)).to("cuda", tdt)[..., d:]
    k, v = (torch.from_numpy(rng.standard_normal((b, 2 * s, h, d)).astype(
        np.float32)).to("cuda", tdt)[:, :s] for _ in range(2))
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = tda.decode_attention.launches
    got = tda.decode_attention(q, k, v, kv_len)
    n = kv_len.clamp_min(1)
    want = tda.dense_decode_attention(q, k, v, n)
    torch.cuda.synchronize()
    assert tda.decode_attention.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    dead = torch.arange(s, device="cuda")[None, :] >= n[:, None]
    kd, vd, _ = poisoned(k, v, {}, dead)
    assert torch.equal(tda.decode_attention(q, kd, vd, kv_len), got)


def _paged_inputs(dtype, t=None, bs=16, m=8):
    """q, pools [B*m + 1, bs, H, D] (block 0 trash), shuffled tables,
    occupancies 1, a block edge + 1, m*bs and past m*bs (a retired
    row)."""
    rng = np.random.default_rng(6)
    n = B * m + 1
    qshape = (B, H, D) if t is None else (B, t, H, D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to("cuda", dtype)
               for s in (qshape, (n, bs, H, D), (n, bs, H, D)))
    tables = torch.from_numpy(
        (rng.permutation(n - 1) + 1).reshape(B, m).astype(np.int32)).cuda()
    kv_len = torch.tensor([1 if t is None else t, bs + 1, m * bs,
                           m * bs + 7], dtype=torch.int32, device="cuda")
    return q, k, v, kv_len, tables


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["decode", "verify"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernels_match_plain_versions(op, dtype):
    """On the card: the paged decode and verify kernels against their
    plain versions, with occupancy past the table; unreferenced blocks
    full of NaN leave the output bit-identical; verify query 0 is the
    decode kernel's output bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    tdt = getattr(torch, dtype)
    t = 5 if op == "verify" else None
    router = getattr(tda, f"paged_{op}_attention")
    plain = getattr(tda, f"dense_paged_{op}_attention")
    q, k, v, kv_len, tables = _paged_inputs(tdt, t)
    before = router.launches
    got = router(q, k, v, kv_len, tables)
    want = plain(q, k, v, kv_len, tables)
    torch.cuda.synchronize()
    assert router.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    # NaN in every block no row's occupancy reaches.
    bs = k.shape[1]
    used = torch.zeros(k.shape[0], dtype=torch.bool, device="cuda")
    for row, n in enumerate(kv_len.clamp(max=tables.shape[1] * bs).tolist()):
        used[tables[row, : (n - 1) // bs + 1].long()] = True
    kd, vd, _ = poisoned(k, v, {}, ~used)
    assert torch.equal(router(q, kd, vd, kv_len, tables), got)
    if op == "verify":
        dec = tda.paged_decode_attention(q[:, 0].contiguous(), k, v,
                                         kv_len - 4, tables)
        assert torch.equal(got[:, 0], dec)


# ------------------------------------------------------- quantized cache

QFORMATS = ["int8", "fp8_e4m3", "fp8_e5m2"]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", QFORMATS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_decode_kernel_matches_plain_version(fmt, dtype):
    """On the card: the quantized contiguous kernel against its plain
    version, on a strided cache with occupancy past capacity; positions
    past occupancy poisoned (NaN scales, NaN payloads) leave the output
    bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    q = q.to("cuda", tdt)
    kv = [torch.from_numpy(rng.standard_normal((B, 2 * S, H, D)).astype(
        np.float32)).cuda() for _ in range(2)]
    (k, ks), (v, vs) = (quantize_kv(x, fmt) for x in kv)
    k, ks, v, vs = k[:, :S], ks[:, :S], v[:, :S], vs[:, :S]
    sc = dict(k_scale=ks, v_scale=vs)
    lens = torch.tensor([1, 33, S, S + 1], dtype=torch.int32, device="cuda")
    before = tda.decode_attention.quant_launches
    got = tda.decode_attention(q, k, v, lens, **sc)
    want = tda.dense_decode_attention_quant(q, k, v, lens, ks, vs)
    torch.cuda.synchronize()
    assert tda.decode_attention.quant_launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    dead = torch.arange(S, device="cuda")[None, :] >= lens[:, None]
    kd, vd, sd = poisoned(k, v, sc, dead)
    assert torch.equal(tda.decode_attention(q, kd, vd, lens, **sd), got)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["decode", "verify"])
@pytest.mark.parametrize("fmt", QFORMATS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_paged_kernels_match_plain_versions(op, fmt, dtype):
    """On the card: the quantized paged decode and verify kernels against
    their plain versions, with occupancy past the table; every pool
    position no row's occupancy reaches poisoned leaves the output
    bit-identical; quantized verify query 0 is the quantized decode
    kernel's output bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    tdt = getattr(torch, dtype)
    t = 5 if op == "verify" else None
    router = getattr(tda, f"paged_{op}_attention")
    plain = getattr(tda, f"dense_paged_{op}_attention")
    q, kf, vf, kv_len, tables = _paged_inputs(torch.float32, t)
    q = q.to(tdt)
    (k, ks), (v, vs) = quantize_kv(kf, fmt), quantize_kv(vf, fmt)
    sc = dict(k_scale=ks, v_scale=vs)
    before = router.quant_launches
    got = router(q, k, v, kv_len, tables, **sc)
    want = plain(q, k, v, kv_len, tables, ks, vs)
    torch.cuda.synchronize()
    assert router.quant_launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    bs, cap = k.shape[1], tables.shape[1] * k.shape[1]
    dead = torch.ones(k.shape[:2], dtype=torch.bool, device="cuda")
    for row, n in enumerate(kv_len.clamp(max=cap).tolist()):
        p = torch.arange(n, device="cuda")
        dead[tables[row, p // bs].long(), p % bs] = False
    kd, vd, sd = poisoned(k, v, sc, dead)
    assert torch.equal(router(q, kd, vd, kv_len, tables, **sd), got)
    if op == "verify":
        dec = tda.paged_decode_attention(q[:, 0].contiguous(), k, v,
                                         kv_len - 4, tables, **sc)
        assert torch.equal(got[:, 0], dec)


# The quantized contiguous kernel for bf16 q (csrc/paged_tc.cuh without
# its table) at DECODE_EDGES' shapes, bar D = 96 (it takes head dims 32,
# 64, 128 and 256).
QUANT_DECODE_EDGES = sorted(c for c in DECODE_EDGES if c != "D96")


def _quant_cache(rng, b, s, h, d, fmt):
    """A quantized K/V pair [b, s, h, d] and its scales, views into a
    2s-capacity buffer (as a grown engine cache is), and the scale
    keywords."""
    (k, ks), (v, vs) = (quantize_kv(torch.from_numpy(rng.standard_normal(
        (b, 2 * s, h, d)).astype(np.float32)).cuda(), fmt) for _ in range(2))
    k, ks, v, vs = k[:, :s], ks[:, :s], v[:, :s], vs[:, :s]
    return k, v, dict(k_scale=ks, v_scale=vs)


@pytest.mark.cuda
@pytest.mark.parametrize("case", QUANT_DECODE_EDGES)
@pytest.mark.parametrize("fmt", QFORMATS)
def test_quant_decode_kernel_split_edges(fmt, case):
    """On the card: bf16 q over a quantized contiguous cache at the edges
    of the split (kv_len 0, 1 and > S, one slot at 8 splits, two slots,
    B*H = 384 at one split, D = 256) through a strided q and a cache view
    into a 2S buffer, against the plain version; NaN payloads and scales
    past every row's occupancy leave the output bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    b, h, s, d, lens = DECODE_EDGES[case]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert (tda.decode_splits(b * h, s, sms) > 1) == (
        case in ("one_slot", "two_slots", "D256"))
    rng = np.random.default_rng(14)
    q = torch.from_numpy(rng.standard_normal((b, h, 2 * d)).astype(
        np.float32)).to("cuda", torch.bfloat16)[..., d:]
    k, v, sc = _quant_cache(rng, b, s, h, d, fmt)
    kv_len = torch.tensor(lens, dtype=torch.int32, device="cuda")
    before = tda.decode_attention.quant_launches
    got = tda.decode_attention(q, k, v, kv_len, **sc)
    n = kv_len.clamp_min(1)
    want = tda.dense_decode_attention_quant(q, k, v, n, **sc)
    torch.cuda.synchronize()
    assert tda.decode_attention.quant_launches == before + 1
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL["bfloat16"], rtol=0)
    dead = torch.arange(s, device="cuda")[None, :] >= n[:, None]
    kd, vd, sd = poisoned(k, v, sc, dead)
    assert torch.equal(tda.decode_attention(q, kd, vd, kv_len, **sd), got)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("fmt", QFORMATS)
def test_quant_decode_kernel_at_every_split(fmt, d):
    """On the card: bf16 q over a quantized contiguous cache whose
    capacity no tile divides (S = 300: 19 tiles of 16, the last ragged;
    at 7 and 8 splits a CTA has one tile or none), at every forced split
    count 1..8 and each head dim, through a strided q and a cache view
    into a 2S buffer, occupancies 0, 1, 17, 150, S and > S: each held to
    the plain version, and bit-identical with NaN payloads and scales
    past every row's occupancy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    b, h, s = 6, 2, 300
    rng = np.random.default_rng(15)
    q = torch.from_numpy(rng.standard_normal((b, h, 2 * d)).astype(
        np.float32)).to("cuda", torch.bfloat16)[..., :d]
    k, v, sc = _quant_cache(rng, b, s, h, d, fmt)
    kv_len = torch.tensor([0, 1, 17, 150, s, s + 37], dtype=torch.int32,
                          device="cuda")
    n = kv_len.clamp_min(1)
    want = tda.dense_decode_attention_quant(q, k, v, n, **sc)
    dead = torch.arange(s, device="cuda")[None, :] >= n[:, None]
    kd, vd, sd = poisoned(k, v, sc, dead)
    for splits in range(1, tda.MAX_DECODE_SPLITS + 1):
        got = tda._flash_decode_quant(q, k, v, kv_len, splits=splits, **sc)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL["bfloat16"], rtol=0,
                                   msg=lambda m: f"splits={splits}: {m}")
        assert torch.equal(tda._flash_decode_quant(
            q, kd, vd, kv_len, splits=splits, **sd), got), splits


# ------------------------------------- paged kernels' split over positions


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("fmt", ["none"] + QFORMATS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernels_at_every_tile_and_split(dtype, fmt, d):
    """On the card: the paged verify kernel at T = 1..8 and the paged
    decode of its query 0 (at kv_len - T + 1, through q[:, 0]'s strided
    view, as the model calls it), at every forced split count 1..8, over
    occupancies that cross split boundaries, one past the table and 2
    (kv_len - T + 1 < 1 from T = 3): each held to its plain version;
    NaN in every pool position no row's occupancy reaches leaves both
    bit-identical; query 0 equals the decode at the same split count bit
    for bit. bf16 q runs the tensor-core kernels (csrc/paged_tc.cuh);
    fp32 q the CUDA-core ones, which take no split."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(13)
    b, h, m, bs = 4, 2, 16, 16  # 16 tiles of 16: work for every split
    n = b * m + 1
    q8 = torch.from_numpy(rng.standard_normal(
        (b, tda.MAX_VERIFY_TILE, h, d)).astype(np.float32)).to("cuda", tdt)
    kf, vf = (torch.from_numpy(rng.standard_normal((n, bs, h, d)).astype(
        np.float32)).cuda() for _ in range(2))
    if fmt == "none":
        k, v, sc = kf.to(tdt), vf.to(tdt), {}
    else:
        (k, ks), (v, vs) = quantize_kv(kf, fmt), quantize_kv(vf, fmt)
        sc = dict(k_scale=ks, v_scale=vs)
    tables = torch.from_numpy(
        (rng.permutation(n - 1) + 1).reshape(b, m).astype(np.int32)).cuda()
    kv_len = torch.tensor([2, 33, 130, 270], dtype=torch.int32,
                          device="cuda")
    dead = torch.ones((n, bs), dtype=torch.bool, device="cuda")
    for row, occ in enumerate(kv_len.clamp(max=m * bs).tolist()):
        p = torch.arange(occ, device="cuda")
        dead[tables[row, p // bs].long(), p % bs] = False
    kd, vd, sd = poisoned(k, v, sc, dead)
    for t in range(1, tda.MAX_VERIFY_TILE + 1):
        q = q8[:, :t]
        dec_lens = (kv_len - (t - 1)).clamp_min(1)
        want_v = tda.dense_paged_verify_attention(q, k, v, kv_len, tables,
                                                  **sc)
        want_d = tda.dense_paged_decode_attention(q[:, 0], k, v, dec_lens,
                                                  tables, **sc)
        for s in range(1, tda.MAX_DECODE_SPLITS + 1):
            got_v = tda._flash_paged_verify(q, k, v, kv_len, tables,
                                            splits=s, **sc)
            got_d = tda._flash_paged_decode(q[:, 0], k, v, dec_lens, tables,
                                            splits=s, **sc)
            torch.cuda.synchronize()
            for got, want in ((got_v, want_v), (got_d, want_d)):
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=TOL[dtype], rtol=0,
                                           msg=lambda m: f"T={t} s={s}: {m}")
            assert torch.equal(got_v[:, 0], got_d), (t, s)
            assert torch.equal(tda._flash_paged_verify(
                q, kd, vd, kv_len, tables, splits=s, **sd), got_v), (t, s)
            assert torch.equal(tda._flash_paged_decode(
                q[:, 0], kd, vd, dec_lens, tables, splits=s, **sd),
                got_d), (t, s)


# ------------------------------------------------------ flash attention

# (B, T, H, D): a T that is not a multiple of the kernels' 64-row tile,
# the three head dims the kernels take, a T below one tile, and a long
# ragged T.
FLASH_SHAPES = [(2, 200, 3, 32), (2, 136, 2, 64), (1, 72, 2, 128),
                (1, 40, 2, 64), (2, 1000, 4, 64)]
# As a fraction of max(1, max|plain|), and as chip_smoke.py's FLASH_TOL:
# bf16 rounds the output and P (dS for dQ) at other points than the plain
# version; fp32 differs in summation order only.
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _flash_close(got, want, dtype):
    scale = max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_TOL[dtype] * scale, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: f"T{s[1]}_D{s[3]}")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernels_match_plain_versions(dtype, shape, causal):
    """On the card: the forward, dQ and dK/dV kernels against the plain
    versions, reading (B, H, T, D) views of (B, T, H, D) tensors through
    strides; each wrapper counts one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa

    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(8)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", tdt).transpose(1, 2) for _ in range(4))
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    o_ref, lse_ref = fa.dense_fwd_lse(q, k, v, causal=causal)
    dq = fa.flash_bwd_dq(q, k, v, o_ref, lse_ref, do, causal=causal)
    dk, dv = fa.flash_bwd_dkv(q, k, v, o_ref, lse_ref, do, causal=causal)
    want = fa.dense_bwd_lse(q, k, v, o_ref, lse_ref, do, causal=causal)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(n + 1 for n in before)
    _flash_close(o, o_ref, dtype)
    _flash_close(lse, lse_ref, "float32")
    for got, ref in zip((dq, dk, dv), want):
        _flash_close(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t", [40, 1000, 1024])
def test_flash_bf16_dq_kernel_matches_plain_backward(t, d, causal):
    """On the card: the bf16 dQ kernel (tensor cores) against
    ``dense_bwd_lse`` below one tile, at a ragged T and at the path's T,
    for every head dim it takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(12)
    shape = (1, t, 2, d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", torch.bfloat16).transpose(1, 2)
        for _ in range(4))
    o_ref, lse_ref = fa.dense_fwd_lse(q, k, v, causal=causal)
    before = fa.flash_bwd_dq.launches
    dq = fa.flash_bwd_dq(q, k, v, o_ref, lse_ref, do, causal=causal)
    want = fa.dense_bwd_lse(q, k, v, o_ref, lse_ref, do, causal=causal)[0]
    torch.cuda.synchronize()
    assert fa.flash_bwd_dq.launches == before + 1
    _flash_close(dq, want, "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_kernels_read_a_strided_do(dtype):
    """On the card: dQ and dK/dV read a dO that is a non-contiguous view
    (every other 64-column half of a wider tensor) through its strides,
    and agree with the plain backward on the same view."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa

    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(10)
    b, t, h, d = 2, 136, 2, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((b, t, h, d)).astype(
        np.float32)).to("cuda", tdt).transpose(1, 2) for _ in range(3))
    wide = torch.from_numpy(rng.standard_normal((b, t, h, 2 * d)).astype(
        np.float32)).to("cuda", tdt)
    do = wide[..., d:].transpose(1, 2)
    assert not do.is_contiguous()
    o_ref, lse_ref = fa.dense_fwd_lse(q, k, v, causal=True)
    dq = fa.flash_bwd_dq(q, k, v, o_ref, lse_ref, do, causal=True)
    dk, dv = fa.flash_bwd_dkv(q, k, v, o_ref, lse_ref, do, causal=True)
    want = fa.dense_bwd_lse(q, k, v, o_ref, lse_ref, do, causal=True)
    torch.cuda.synchronize()
    for got, ref in zip((dq, dk, dv), want):
        _flash_close(got, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_function_runs_the_kernels(dtype):
    """On the card: the differentiable router launches the forward kernel,
    then dQ and dK/dV in the backward, and its gradients agree with the
    plain backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from frl_distributed_ml_scaffold_tpu_torch.ops import flash_attention as fa

    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(9)
    shape = (2, 128, 4, 64)
    q, k, v, w = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", tdt) for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    o = fa.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(o, leaves, w)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(n + 1 for n in before)
    bhtd = [x.transpose(1, 2) for x in (q, k, v)]
    o_ref, lse_ref = fa.dense_fwd_lse(*bhtd, causal=True)
    want = fa.dense_bwd_lse(*bhtd, o_ref, lse_ref, w.transpose(1, 2),
                            causal=True)
    _flash_close(o, o_ref.transpose(1, 2), dtype)
    for got, ref in zip(grads, want):
        _flash_close(got, ref.transpose(1, 2), dtype)


# The BatchNorm-backward kernels (csrc/fused_bn.cu), as fractions of
# max(1, max|plain|): the sums are fp32 in both, in another order; dx may
# round one bf16 ulp (2^-7 relative) the other way.
BN_TOL = {"sums": 1e-5, "float32": 1e-5, "bfloat16": 2 ** -7}


def _bn_close(got, want, tol):
    scale = max(1.0, want.float().abs().max().item())
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * scale, (err, tol, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(4096, 64), (1000, 2048), (333, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bn_kernels_match_plain_versions(dtype, m, c):
    """On the card: the sums and dx kernels against their plain versions
    (random gamma; a ragged M and a C off the 16-byte vector), one launch
    each; a layout other than row-major (M, C) raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from frl_distributed_ml_scaffold_tpu_torch.ops import fused_bn as fb

    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(m + c)
    x = torch.from_numpy((rng.standard_normal((m, c)) * 2 + 0.5).astype(
        np.float32)).to("cuda", tdt)
    dy = torch.from_numpy(rng.standard_normal((m, c)).astype(
        np.float32)).to("cuda", tdt)
    scale = torch.from_numpy(rng.uniform(-0.5, 1.5, c).astype(
        np.float32)).to("cuda", tdt)
    _, mean, var = fb.bn_train_forward(x, scale, torch.zeros_like(scale),
                                       1e-5, tdt)
    before = (fb.bn_sums.launches, fb.bn_dx.launches)
    dbeta, dgamma = fb.bn_sums(x, dy, mean, var, 1e-5)
    dx = fb.bn_dx(x, dy, scale, mean, var, dgamma, dbeta, 1e-5, m)
    torch.cuda.synchronize()
    assert (fb.bn_sums.launches, fb.bn_dx.launches) == (before[0] + 1,
                                                        before[1] + 1)
    want = fb.fallback_bwd(x, dy, scale, mean, var, 1e-5)
    _bn_close(dbeta, want[2], BN_TOL["sums"])
    _bn_close(dgamma, want[1], BN_TOL["sums"])
    assert dx.dtype == tdt
    _bn_close(dx, want[0], BN_TOL[dtype])
    with pytest.raises(ValueError, match="row-major"):
        fb.bn_sums(x.t().contiguous().t(), dy, mean, var, 1e-5)


@pytest.mark.cuda
def test_fused_batchnorm_runs_the_kernels():
    """On the card: ``FusedBatchNorm``'s backward launches the sums and dx
    kernels once each on an NHWC activation, and its gradients agree with
    autograd through the plain forward (fp32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from frl_distributed_ml_scaffold_tpu_torch.ops import fused_bn as fb

    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((4, 14, 14, 256)).astype(
        np.float32)).cuda()
    w = torch.from_numpy(rng.standard_normal((4, 14, 14, 256)).astype(
        np.float32)).cuda()
    gamma = torch.from_numpy(rng.uniform(-0.5, 1.5, 256).astype(np.float32))
    grads = {}
    for cls in (fb.BatchNorm, fb.FusedBatchNorm):
        mod = cls(256, device="cuda")
        with torch.no_grad():
            mod.scale.copy_(gamma)
        leaf = x.clone().requires_grad_()
        before = fb.bn_sums.launches
        y = mod(leaf, train=True, updates={})
        grads[cls] = torch.autograd.grad(y, [leaf, mod.scale, mod.bias], w)
        torch.cuda.synchronize()
        assert fb.bn_sums.launches == before + (cls is fb.FusedBatchNorm)
    for got, want in zip(grads[fb.FusedBatchNorm], grads[fb.BatchNorm]):
        _bn_close(got, want, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65536, 65539, 2359296])
def test_adamw_kernel_matches_plain_version(n):
    """On the card: the AdamW kernel against ``adamw_math`` on one leaf
    (the kernel's smallest, a ragged one, the path's largest), 1e-6
    absolute; ``update_leaf`` routes a leaf below 65536 elements to the
    plain math and launches nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from frl_distributed_ml_scaffold_tpu_torch.ops import fused_adamw as fa

    rng = np.random.default_rng(n)
    g, m, p = (torch.from_numpy((s * rng.standard_normal(n)).astype(
        np.float32)).cuda() for s in (1e-2, 1e-2, 0.05))
    v = torch.from_numpy((1e-4 * rng.uniform(size=n)).astype(
        np.float32)).cuda()
    hp = dict(b1=0.9, b2=0.999, eps=1e-8, wd=1e-4)
    want = fa.adamw_math(g, m, v, p, 1e-3, 1 - 0.9 ** 6, 1 - 0.999 ** 6, **hp)
    before = fa.adamw_kernel.launches
    fa.update_leaf(g, m, v, p, 1e-3, 1 - 0.9 ** 6, 1 - 0.999 ** 6, **hp)
    torch.cuda.synchronize()
    assert fa.adamw_kernel.launches == before + 1
    for got, ref in zip((p, m, v), want):
        assert (got - ref).abs().max().item() <= 1e-6
    small = [t[:1000].clone() for t in (g, m, v, p)]
    fa.update_leaf(*small, 1e-3, 0.5, 0.5, **hp)
    assert fa.adamw_kernel.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65539, 2359296])
def test_adamw_kernel_reads_bf16_grads(n):
    """On the card: the AdamW kernel with a bf16 g (read in place, widened
    in registers) against ``adamw_math`` on the same bf16 g, 1e-6
    absolute, one launch; p, m and v stay float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from frl_distributed_ml_scaffold_tpu_torch.ops import fused_adamw as fa

    rng = np.random.default_rng(n + 1)
    g, m, p = (torch.from_numpy((s * rng.standard_normal(n)).astype(
        np.float32)).cuda() for s in (1e-2, 1e-2, 0.05))
    g = g.bfloat16()
    v = torch.from_numpy((1e-4 * rng.uniform(size=n)).astype(
        np.float32)).cuda()
    hp = dict(b1=0.9, b2=0.999, eps=1e-8, wd=1e-4)
    want = fa.adamw_math(g, m, v, p, 1e-3, 1 - 0.9 ** 6, 1 - 0.999 ** 6, **hp)
    before = fa.adamw_kernel.launches
    fa.update_leaf(g, m, v, p, 1e-3, 1 - 0.9 ** 6, 1 - 0.999 ** 6, **hp)
    torch.cuda.synchronize()
    assert fa.adamw_kernel.launches == before + 1
    for got, ref in zip((p, m, v), want):
        assert got.dtype == torch.float32
        assert (got - ref).abs().max().item() <= 1e-6
