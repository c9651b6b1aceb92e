"""The serving path over a QUANTIZED KV cache (``model.kv_cache_quant``
int8 / fp8_e4m3) on the CPU: the port's model (contiguous and paged
branches, prefill, decode, verify tile), cache taxonomy and
``ServingEngine`` (bucketed, and paged with the prefix cache and n-gram
speculation) against the JAX package's, under ``fp32`` on the same
carried-across params, the JAX side running its quantized Pallas kernels
in interpret mode.

Cache leaves: each written token is quantized once by each package from
its own fp32 K/V. Layer 0's K/V come out of the same embedding and
projection, and its payload bytes and bf16 scales are bit-identical;
deeper layers see the two frameworks' fp32 GEMMs, which differ in the
last bits, so a value sitting on a rounding boundary may land on the
neighbouring code: those payloads must match on all but 0.1 % of their
elements, and there by exactly one code, with the scales bit-identical.
Logits 1e-4 (fp32 summation order only). Engines token for token, with
the same completion fields and ``stats``, and each request equal to the
port's own ``generate()``.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY, build_pair, jax_params, pallas_interpret

from frl_distributed_ml_scaffold_tpu.config.schema import (
    GPTConfig as JaxGPTConfig,
)
from frl_distributed_ml_scaffold_tpu.config.schema import (
    ServingConfig as JaxServingConfig,
)
from frl_distributed_ml_scaffold_tpu.models import generation as jgen
from frl_distributed_ml_scaffold_tpu.serving import ServingEngine as JaxEngine
from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
    GPTConfig,
    ServingConfig,
)
from frl_distributed_ml_scaffold_tpu_torch.models import generation as tgen
from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as tda
from frl_distributed_ml_scaffold_tpu_torch.ops.quantization import (
    byte_view,
    quantize_kv,
)
from frl_distributed_ml_scaffold_tpu_torch.serving import (
    ServeRequest,
    ServingEngine,
)

V = TINY["vocab_size"]
FORMATS = ["int8", "fp8_e4m3"]
_JNP = {torch.float8_e4m3fn: jnp.float8_e4m3fn, torch.int8: jnp.int8}


@pytest.fixture(scope="module")
def params():
    return jax_params()


def _pair(params, fmt):
    jm, tm = build_pair(params, "fp32", kv_cache_quant=fmt)
    return jm, params, tm


# ------------------------------------------------------------- leaves


def _jnp(t: torch.Tensor):
    """A port cache leaf as a JAX array with the same bits."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    if t.dtype in _JNP:
        return jnp.asarray(byte_view(t).numpy()).view(_JNP[t.dtype])
    return jnp.asarray(t.numpy())


def _to_jax(cache: dict) -> dict:
    top = ("pos_index", "block_tables")
    return {
        **{k: _jnp(v) for k, v in cache.items() if k in top},
        "blocks": {"attn": {
            k: _jnp(v) for k, v in cache.items() if k not in top
        }},
    }


def _flat(jcache) -> dict:
    out = {k: np.asarray(v) for k, v in jcache.items() if k != "blocks"}
    out.update({k: np.asarray(v) for k, v in jcache["blocks"]["attn"].items()})
    return out


def _codes(a) -> np.ndarray:
    """Payload codes as signed ints: int8 values, or fp8 bytes ordered so
    that neighbouring magnitudes of one sign are neighbouring codes."""
    if isinstance(a, torch.Tensor):
        a = byte_view(a).numpy()
    a = np.asarray(a)
    if a.dtype == np.int8:
        return a.astype(np.int64)
    u = a.view(np.uint8).astype(np.int64)
    return np.where(u >= 128, -(u - 128), u)


def _assert_leaves(tcache: dict, jcache):
    j = _flat(jcache)
    assert sorted(j) == sorted(tcache)
    for name, leaf in tcache.items():
        if leaf.dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(leaf.numpy(), j[name], err_msg=name)
        elif leaf.dtype == torch.bfloat16:  # scales: bit for bit
            np.testing.assert_array_equal(
                leaf.float().numpy(), j[name].astype(np.float32), err_msg=name
            )
        else:  # payloads
            assert leaf.dtype == {"int8": torch.int8}.get(
                str(j[name].dtype), torch.float8_e4m3fn), name
            t, w = _codes(leaf), _codes(j[name])
            np.testing.assert_array_equal(t[0], w[0], err_msg=name)
            diff = t != w
            assert diff.sum() <= max(1, diff.size // 1000), (name, diff.sum())
            assert (np.abs(t - w)[diff] == 1).all(), name


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_prefill_and_decode_match_jax(params, fmt):
    """Ragged left-padded prefill over the quantized bucket and three
    decode steps through the quantized kernels; logits and every leaf
    (payloads, bf16 scales, cursors) after each."""
    jm, _, tm = _pair(params, fmt)
    jm = jm.clone(cache_len=32)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, V, (3, 12)).astype(np.int32)
    lens = np.asarray([12, 5, 9], np.int32)
    tda.decode_attention.quant_launches = 0
    with pallas_interpret():
        jl, jc = jgen._prefill(jm, params, jnp.asarray(prompt),
                               jnp.asarray(lens))
        tl, tc = tgen._prefill(tm, torch.from_numpy(prompt),
                               torch.from_numpy(lens), cache_len=32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        assert tc["key_scale"].shape == (2, 3, 32, 4)
        assert tc["key_scale"].dtype == torch.bfloat16
        _assert_leaves(tc, jc)
        for _ in range(3):
            tok = rng.integers(0, V, (3,)).astype(np.int32)
            jl, jc = jgen._decode_step(jm, params, jc, jnp.asarray(tok))
            tl, tc = tgen._decode_step(tm, tc, torch.from_numpy(tok))
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                       rtol=0)
        _assert_leaves(tc, jc)
    assert tda.decode_attention.quant_launches == 0  # the CPU: plain version


def _quant_paged_cache(tm, fmt, bs, rng):
    """A port quantized paged cache: pools filled with quantized random
    K/V (payloads and bf16 scales), shuffled tables for 3 rows whose
    cursors sit at 5, 17 and 30."""
    m = TINY["seq_len"] // bs
    n = 3 * m + 1
    cache = tm.init_paged_cache(3, bs, n)
    for name in ("key_pool", "value_pool"):
        x = torch.from_numpy(rng.standard_normal(
            cache[name].shape).astype(np.float32))
        qx, sx = quantize_kv(x, fmt)
        byte_view(cache[name]).copy_(byte_view(qx))
        cache[name + "_scale"].copy_(sx)
    cache["block_tables"].copy_(torch.from_numpy(
        (rng.permutation(n - 1) + 1).reshape(3, m).astype(np.int32)))
    tgen.rewind_cache_indices(cache, torch.tensor([5, 17, 30],
                                                  dtype=torch.int32))
    return cache


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_paged_decode_and_verify_match_jax(params, fmt):
    """The quantized paged branch: a decode step then a verify tile over
    quantized pools (scale pools through the same tables); logits and
    every leaf after each."""
    jm, _, tm = _pair(params, fmt)
    bs = 8
    jp = jm.clone(kv_block_size=bs,
                  kv_pool_blocks=3 * (TINY["seq_len"] // bs) + 1)
    rng = np.random.default_rng(1)
    tc = _quant_paged_cache(tm, fmt, bs, rng)
    jc = _to_jax(tc)
    _assert_leaves(tc, jc)
    tok = rng.integers(0, V, (3,)).astype(np.int32)
    tile = rng.integers(0, V, (3, 5)).astype(np.int32)
    with pallas_interpret():
        jl, jc = jgen._decode_step(jp, params, jc, jnp.asarray(tok))
        tl, tc = tgen._decode_step(tm, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        _assert_leaves(tc, jc)
        jl, jc = jgen._verify_step(jp, params, jc, jnp.asarray(tile))
        tl, tc = tgen._verify_step(tm, tc, torch.from_numpy(tile))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        _assert_leaves(tc, jc)


def test_splice_moves_quantized_blocks_and_scales_like_jax(params):
    """The admission splice over a quantized pool: 1-byte payload blocks
    and their [L, N, bs, H] scale blocks land at their pool ids, bit for
    bit as in the JAX splice."""
    jm, _, tm = _pair(params, "fp8_e4m3")
    rng = np.random.default_rng(9)
    bs = 8
    cache = _quant_paged_cache(tm, "fp8_e4m3", bs, rng)
    jc = _to_jax(cache)
    prompt = rng.integers(0, V, (1, 21)).astype(np.int32)
    _, slot = tgen._prefill(tm, torch.from_numpy(prompt), None, cache_len=32)
    jslot = {"pos_index": _jnp(slot["pos_index"]),
             "blocks": {"attn": {k: _jnp(v) for k, v in slot.items()
                                 if k != "pos_index"}}}
    jc = jgen.splice_pool_blocks(jc, jslot, jnp.asarray([7, 2], jnp.int32),
                                 jnp.int32(1), jnp.int32(2), block_size=bs)
    tgen.splice_pool_blocks(cache, slot, [7, 2], 1, 2, block_size=bs)
    j = _flat(jc)
    assert sorted(j) == sorted(cache)
    for name, leaf in cache.items():
        if leaf.dtype == torch.bfloat16:
            got, want = leaf.float().numpy(), j[name].astype(np.float32)
        else:
            got = byte_view(leaf).numpy()
            want = j[name].view(got.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)


# ------------------------------------------------------------- engines


def _check_same(jeng, jdone, eng, comps, fields):
    assert sorted(comps) == sorted(jdone)
    for rid, c in comps.items():
        j = jdone[rid]
        np.testing.assert_array_equal(c.tokens, j.tokens, err_msg=str(rid))
        for field in fields:
            assert getattr(c, field) == getattr(j, field), (rid, field)


def _run(pair, reqs, *, num_slots, **serving):
    """The same requests through the JAX engine (Pallas kernels in
    interpret mode) and the port's; returns (port engine, completions
    by id, JAX engine, its completions)."""
    jm, params, tm = pair
    with pallas_interpret():
        jeng = JaxEngine(jm, params, num_slots=num_slots, temperature=0.0,
                         serving=JaxServingConfig(**serving))
        for p, n in reqs:
            jeng.submit(p, n)
        jdone = {c.id: c for c in jeng.run()}
    eng = ServingEngine(tm, num_slots=num_slots, temperature=0.0,
                        serving=ServingConfig(**serving), device="cpu")
    for p, n in reqs:
        eng.submit(p, n)
    comps = {c.id: c for c in eng.run()}
    for i, (p, n) in enumerate(reqs):
        ref = tgen.generate(tm, p[None], max_new_tokens=n, temperature=0.0,
                            device="cpu")[0].numpy()
        np.testing.assert_array_equal(comps[i].tokens, ref, err_msg=str(i))
    return eng, comps, jeng, jdone


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_bucketed_engine_matches_jax_and_generate(params, fmt):
    """5 requests through 3 slots over the quantized bucketed cache:
    slots refill and the bucket grows (scale leaves pad and graft with
    the K/V); every completion equals the JAX engine's and the port's
    own quantized generate()."""
    rng = np.random.default_rng(11)
    reqs = [(rng.integers(0, V, size=int(rng.integers(2, 30))).astype(
        np.int32), int(rng.integers(2, 10))) for _ in range(5)]
    eng, comps, jeng, jdone = _run(_pair(params, fmt), reqs, num_slots=3)
    _check_same(jeng, jdone, eng, comps, ("finish_reason", "prompt_len"))
    assert any(k.startswith("grow_") for k in eng.stats)
    assert {k: v for k, v in eng.stats.items() if k in jeng.stats} == {
        k: jeng.stats[k] for k in eng.stats}
    assert set(eng.cache) >= {"key_scale", "value_scale"}
    # The live cache's bytes per slot equal the analytic estimate (scales
    # included), and the JAX package's.
    assert tgen.cache_bytes_per_slot(eng.cache, 3) == (
        tgen.estimate_cache_bytes_per_slot(eng.model.config, eng.bucket,
                                           kv_dtype_bytes=4)
    ) == jgen.estimate_cache_bytes_per_slot(
        JaxGPTConfig(**TINY, kv_cache_quant=fmt), eng.bucket,
        kv_dtype_bytes=4)


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_paged_engine_with_prefix_and_ngram_matches_jax(params, fmt):
    """The quantized paged engine: shared-prefix hits (the seed gathers
    payload AND scale blocks from the pool), block appends, n-gram
    drafts through the quantized verify tile, rollback across a block
    boundary; token for token, same completion fields, same ``stats``
    and allocator state as the JAX engine, and equal to generate()."""
    rng = np.random.default_rng(0)
    pre = rng.integers(0, V, size=20).astype(np.int32)
    reqs = [
        (np.concatenate([pre, rng.integers(0, V, size=5).astype(np.int32)]), 12),
        (np.tile(np.asarray([3, 9, 4, 7], np.int32), 5), 20),
        (np.concatenate([pre, rng.integers(0, V, size=6).astype(np.int32)]), 7),
        (rng.integers(0, V, size=3).astype(np.int32), 14),
    ]
    eng, comps, jeng, jdone = _run(
        _pair(params, fmt), reqs, num_slots=3, kv_block_size=8,
        speculate="ngram", speculate_k=4)
    _check_same(jeng, jdone, eng, comps,
                ("finish_reason", "prompt_len", "prefix_cache_hit",
                 "prefill_tokens_saved", "spec_accept_rate"))
    assert dict(eng.stats) == dict(jeng.stats)
    assert eng._free == jeng._free and eng._reserved_future == 0
    np.testing.assert_array_equal(eng._ref, jeng._ref)
    s = eng.stats
    assert s["prefix_hits"] > 0 and s["block_append"] > 0
    assert s["decode_verify"] > 0 and 0 < s["spec_accepted"] <= s["spec_proposed"]
    assert eng.cache["key_pool_scale"].shape[1:] == (eng.pool_blocks, 8, 4)
    assert eng.block_bytes() == tgen.estimate_pool_block_bytes(
        eng.model.config, 8, kv_dtype_bytes=4
    ) == jgen.estimate_pool_block_bytes(
        JaxGPTConfig(**TINY, kv_cache_quant=fmt), 8, kv_dtype_bytes=4)


def test_seed_of_a_prefix_hit_gathers_payloads_and_scales(params):
    """``_seed_for`` over a quantized pool: the matched blocks' payload
    and [L, N, bs, H] scale blocks, bit for bit, at the seed's leading
    positions, zeros after, cursors at the prefix length."""
    _, _, tm = _pair(params, "fp8_e4m3")
    eng = ServingEngine(tm, num_slots=2, temperature=0.0, device="cpu",
                        serving=ServingConfig(kv_block_size=8))
    rng = np.random.default_rng(3)
    eng.cache = _quant_paged_cache(tm, "fp8_e4m3", 8, rng)
    req = ServeRequest(0, np.arange(19, dtype=np.int32), 4)
    seed = eng._seed_for(req, {"m": 2, "shared": [9, 4]})
    assert seed["key_scale"].shape == (2, 1, 32, 4)
    assert seed["cached_key"].dtype == torch.float8_e4m3fn
    for pool_name, slot_name in tgen.SLOT_LEAF_OF.items():
        pool, got = byte_view(eng.cache[pool_name]), byte_view(seed[slot_name])
        want = torch.cat([pool[:, 9], pool[:, 4]], dim=1)
        assert torch.equal(got[:, 0, :16], want), pool_name
        assert not got[:, 0, 16:].float().any(), pool_name
    assert seed["cache_index"].tolist() == [[16], [16]]
    assert seed["pos_index"].tolist() == [16]


def test_capacity_estimates_at_gpt2_medium():
    """The bytes the quantized cache saves at GPT-2-medium (head_dim 64):
    a 16-position pool block is 24 x (2*16*16*64 + 2*16*16*2) = 811008
    bytes against 1572864 in bf16, and a 1024-position slot 0.52x."""
    for fmt in FORMATS:
        q = dataclasses.replace(GPTConfig(), kv_cache_quant=fmt)
        assert tgen.estimate_pool_block_bytes(q, 16) == 811008
        jq = JaxGPTConfig(kv_cache_quant=fmt)
        assert tgen.estimate_cache_bytes_per_slot(q, 1024) == (
            jgen.estimate_cache_bytes_per_slot(jq, 1024))
    assert tgen.estimate_pool_block_bytes(GPTConfig(), 16) == 1572864
    ratio = (tgen.estimate_cache_bytes_per_slot(GPTConfig(), 1024)
             / tgen.estimate_cache_bytes_per_slot(q, 1024))
    assert 1.9 < ratio < 1.95
