"""The paged serving path on the CPU: the port's paged model branch,
generation helpers and ``ServingEngine`` (paged pool, shared-prefix
cache, n-gram speculation) against the JAX package's, under ``fp32`` on
the same carried-across params, the JAX side running its paged Pallas
kernels in interpret mode.

Engines are compared token for token, with the same completion fields and
the same ``stats``. Model steps and cache leaves compare at 1e-4 (fp32
summation order only); cursors, tables and splices exactly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY, build_pair, jax_params, pallas_interpret

from frl_distributed_ml_scaffold_tpu.config.schema import (
    ServingConfig as JaxServingConfig,
)
from frl_distributed_ml_scaffold_tpu.models import generation as jgen
from frl_distributed_ml_scaffold_tpu.serving import ServingEngine as JaxEngine
from frl_distributed_ml_scaffold_tpu.serving.engine import (
    ngram_propose as jax_ngram_propose,
)
from frl_distributed_ml_scaffold_tpu_torch.config.schema import ServingConfig
from frl_distributed_ml_scaffold_tpu_torch.models import generation as tgen
from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as tda
from frl_distributed_ml_scaffold_tpu_torch.serving import (
    ServingEngine,
    ngram_propose,
)

V = TINY["vocab_size"]


@pytest.fixture(scope="module")
def pair():
    params = jax_params()
    jm, tm = build_pair(params, "fp32")
    return jm, params, tm


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_jax(cache: dict) -> dict:
    """The port's flat cache dict as the JAX model's cache tree."""
    top = ("pos_index", "block_tables")
    return {
        **{k: jnp.asarray(_np(v)) for k, v in cache.items() if k in top},
        "blocks": {"attn": {
            k: jnp.asarray(_np(v)) for k, v in cache.items() if k not in top
        }},
    }


def _flat(jcache) -> dict:
    """The JAX cache tree as the port's flat dict of numpy leaves."""
    out = {k: np.asarray(v) for k, v in jcache.items() if k != "blocks"}
    out.update({k: np.asarray(v) for k, v in jcache["blocks"]["attn"].items()})
    return out


def _assert_leaves(tcache: dict, jcache, atol=1e-4):
    j = _flat(jcache)
    assert sorted(j) == sorted(tcache)
    for name, leaf in tcache.items():
        if leaf.dtype in (torch.int32, torch.int64):
            np.testing.assert_array_equal(_np(leaf), j[name], err_msg=name)
        else:
            np.testing.assert_allclose(_np(leaf), j[name], atol=atol, rtol=0,
                                       err_msg=name)


# ---------------------------------------------------------------- model


def _paged_caches(tm, bs: int, rng):
    """A port paged cache with a random pool and shuffled tables for 3
    rows whose cursors sit at 5, 17 and 30, and its JAX twin."""
    m = TINY["seq_len"] // bs
    n = 3 * m + 1
    cache = tm.init_paged_cache(3, bs, n)
    cache["key_pool"].copy_(torch.from_numpy(
        rng.standard_normal(cache["key_pool"].shape).astype(np.float32)))
    cache["value_pool"].copy_(torch.from_numpy(
        rng.standard_normal(cache["value_pool"].shape).astype(np.float32)))
    cache["block_tables"].copy_(torch.from_numpy(
        (rng.permutation(n - 1) + 1).reshape(3, m).astype(np.int32)))
    idx = torch.tensor([5, 17, 30], dtype=torch.int32)
    tgen.rewind_cache_indices(cache, idx)
    return cache, _to_jax(cache)


@pytest.mark.parametrize("bs", [8, 16])
def test_paged_decode_and_verify_steps_match_jax(pair, bs):
    """The paged model branch: a decode step, then a verify tile, then a
    rewind; logits and every cache leaf (pools, tables, cursors) agree
    with the JAX paged model after each."""
    jm, params, tm = pair
    jp = jm.clone(kv_block_size=bs,
                  kv_pool_blocks=3 * (TINY["seq_len"] // bs) + 1)
    rng = np.random.default_rng(bs)
    tc, jc = _paged_caches(tm, bs, rng)
    tok = rng.integers(0, V, (3,)).astype(np.int32)
    tile = rng.integers(0, V, (3, 5)).astype(np.int32)
    tda.paged_decode_attention.launches = 0
    with pallas_interpret():
        jl, jc = jgen._decode_step(jp, params, jc, jnp.asarray(tok))
        tl, tc = tgen._decode_step(tm, tc, torch.from_numpy(tok))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-4, rtol=0)
        _assert_leaves(tc, jc)
        jl, jc = jgen._verify_step(jp, params, jc, jnp.asarray(tile))
        tl, tc = tgen._verify_step(tm, tc, torch.from_numpy(tile))
        assert tuple(tl.shape) == (3, 5, V)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-4, rtol=0)
        _assert_leaves(tc, jc)
    new_idx = np.asarray([7, 20, 0], np.int32)
    jc = jgen.rewind_cache_indices(jc, jnp.asarray(new_idx))
    tgen.rewind_cache_indices(tc, torch.from_numpy(new_idx))
    _assert_leaves(tc, jc)
    assert tda.paged_decode_attention.launches == 0


def test_ragged_multi_token_paged_call_raises(pair):
    _, _, tm = pair
    cache = tm.init_paged_cache(2, 8, 9)
    with pytest.raises(NotImplementedError, match="verify tile"):
        tm(torch.zeros(2, 3, dtype=torch.int32), cache,
           torch.tensor([3, 2], dtype=torch.int32))


def test_seeded_suffix_prefill_matches_jax_and_the_full_prefill(pair):
    """A suffix prefill against a seeded cache (the shared-prefix
    admission): the port's masks and positions start from the seed's
    cursors, so its logits and leaves equal the JAX seeded prefill's,
    and its logits equal a full-prompt prefill's."""
    jm, params, tm = pair
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, V, (1, 27)).astype(np.int32)
    m_tok, s_c, s_p = 16, 32, 16
    # Seed: the prefix's K/V from a full prefill, cursors at 16.
    _, full = tgen._prefill(tm, torch.from_numpy(prompt[:, :m_tok]), None,
                            cache_len=s_c)
    seed = {k: v.clone() for k, v in full.items()}
    suffix = np.zeros((1, s_p), np.int32)
    suffix[0, s_p - 11:] = prompt[0, m_tok:]
    lens = np.asarray([11], np.int32)
    jseed = {"pos_index": jnp.asarray(_np(seed["pos_index"])),
             "blocks": {"attn": {k: jnp.asarray(_np(seed[k])) for k in
                                 ("cached_key", "cached_value", "cache_index")}}}
    with pallas_interpret():
        jl, jc = jgen._prefill(jm.clone(cache_len=s_c), params,
                               jnp.asarray(suffix), jnp.asarray(lens),
                               cache=jseed)
    tl, tc = tgen._prefill(tm, torch.from_numpy(suffix),
                           torch.from_numpy(lens), cache_len=s_c, cache=seed)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=1e-4, rtol=0)
    j = _flat(jc)
    for name in ("cache_index", "pos_index"):
        np.testing.assert_array_equal(_np(tc[name]), j[name])
    assert int(tc["pos_index"][0]) == 27
    for name in ("cached_key", "cached_value"):
        np.testing.assert_allclose(_np(tc[name])[:, :, :27],
                                   j[name][:, :, :27], atol=1e-4, rtol=0)
    whole, _ = tgen._prefill(tm, torch.from_numpy(prompt), None,
                             cache_len=s_c)
    np.testing.assert_allclose(_np(tl), _np(whole), atol=1e-4, rtol=0)


def test_splice_pool_blocks_matches_jax(pair):
    """The admission splice, leaf by leaf: the private blocks from
    logical block m0 land at their pool ids, the slot's cursors are set,
    and no other block or row moves."""
    jm, params, tm = pair
    rng = np.random.default_rng(9)
    bs, n = 8, 13
    cache = tm.init_paged_cache(3, bs, n)
    cache["key_pool"].copy_(torch.from_numpy(
        rng.standard_normal(cache["key_pool"].shape).astype(np.float32)))
    jc = _to_jax(cache)
    prompt = rng.integers(0, V, (1, 21)).astype(np.int32)
    _, slot_cache = tgen._prefill(tm, torch.from_numpy(prompt), None,
                                  cache_len=32)
    jslot = {"pos_index": jnp.asarray(_np(slot_cache["pos_index"])),
             "blocks": {"attn": {k: jnp.asarray(_np(v))
                                 for k, v in slot_cache.items()
                                 if k != "pos_index"}}}
    ids = [7, 2]
    jc = jgen.splice_pool_blocks(jc, jslot, jnp.asarray(ids, jnp.int32),
                                 jnp.int32(1), jnp.int32(2), block_size=bs)
    tgen.splice_pool_blocks(cache, slot_cache, ids, 1, 2, block_size=bs)
    _assert_leaves(cache, jc, atol=0)
    assert tgen.pool_block_bytes(cache) == jgen.pool_block_bytes(jc) == (
        tgen.estimate_pool_block_bytes(tm.config, bs, kv_dtype_bytes=4)
    )
    assert tgen.blocks_for_tokens(17, 8) == jgen.blocks_for_tokens(17, 8) == 3
    assert tgen.POOL_LEAF_OF == jgen.POOL_LEAF_OF
    assert tgen.SLOT_LEAF_OF == jgen.SLOT_LEAF_OF


def test_ngram_propose_matches_jax_on_random_histories():
    rng = np.random.default_rng(11)
    for _ in range(200):
        alphabet = int(rng.integers(2, 12))
        hist = rng.integers(0, alphabet, size=int(rng.integers(0, 40)))
        k = int(rng.integers(0, 6))
        max_ngram = int(rng.integers(1, 5))
        np.testing.assert_array_equal(
            ngram_propose(hist, k, max_ngram),
            jax_ngram_propose(hist, k, max_ngram),
        )


# ---------------------------------------------------------------- engine


def _check_same(jeng, jdone, eng, comps):
    assert sorted(comps) == sorted(jdone)
    for rid, c in comps.items():
        j = jdone[rid]
        np.testing.assert_array_equal(c.tokens, j.tokens, err_msg=str(rid))
        for field in ("finish_reason", "prompt_len", "prefix_cache_hit",
                      "prefill_tokens_saved", "spec_accept_rate"):
            assert getattr(c, field) == getattr(j, field), (rid, field)
    assert dict(eng.stats) == dict(jeng.stats)
    # Every reservation unwound, every slot's blocks released.
    assert eng._reserved_future == jeng._reserved_future == 0
    assert all(not b for b in eng._slot_blocks)
    assert eng._free == jeng._free
    np.testing.assert_array_equal(eng._ref, jeng._ref)
    assert eng.pool_utilization() == jeng.pool_utilization()


def _run(pair, reqs, *, num_slots, eos_id=None, **serving):
    jm, params, tm = pair
    with pallas_interpret():
        jeng = JaxEngine(jm, params, num_slots=num_slots, eos_id=eos_id,
                         temperature=0.0,
                         serving=JaxServingConfig(**serving))
        for p, n in reqs:
            jeng.submit(p, n)
        jdone = {c.id: c for c in jeng.run()}
    eng = ServingEngine(tm, num_slots=num_slots, eos_id=eos_id,
                        temperature=0.0, serving=ServingConfig(**serving),
                        device="cpu")
    tda.paged_decode_attention.launches = 0
    tda.paged_verify_attention.launches = 0
    for p, n in reqs:
        eng.submit(p, n)
    done = eng.run()
    assert tda.paged_decode_attention.launches == 0  # the CPU: plain version
    assert tda.paged_verify_attention.launches == 0
    comps = {c.id: c for c in done}
    _check_same(jeng, jdone, eng, comps)
    return eng, [c.id for c in done], comps


def test_engine_block_append_mid_decode_matches_jax(pair):
    rng = np.random.default_rng(3)
    reqs = [
        # 3-token prompt + 14 new crosses the first 8-block boundary.
        (np.arange(3, dtype=np.int32), 14),
        (rng.integers(0, V, size=9).astype(np.int32), 5),
        (rng.integers(0, V, size=2).astype(np.int32), 8),
    ]
    eng, _, _ = _run(pair, reqs, num_slots=2, kv_block_size=8)
    assert eng.stats["block_append"] > 0 and eng.stats["decode_paged"] > 0
    assert not any(k.startswith("grow_") for k in eng.stats)
    assert eng.block_bytes() == tgen.estimate_pool_block_bytes(
        eng.model.config, 8, kv_dtype_bytes=4)


def test_engine_prefix_sharing_cow_and_retire_order_match_jax(pair):
    rng = np.random.default_rng(17)
    pre = rng.integers(0, V, size=20).astype(np.int32)  # 2 full blocks + 4
    tails = [rng.integers(0, V, size=n).astype(np.int32) for n in (4, 5, 6)]
    reqs = [(np.concatenate([pre, t]), n) for t, n in zip(tails, (12, 3, 7))]
    reqs.append((np.concatenate(
        [pre, rng.integers(0, V, size=4).astype(np.int32)]), 4))
    eng, order, comps = _run(pair, reqs, num_slots=3, kv_block_size=8)
    ids = sorted(comps)
    assert order != ids  # retired in another order than admitted
    assert [comps[i].prefix_cache_hit for i in ids] == [False, True, True, True]
    assert [comps[i].prefill_tokens_saved for i in ids] == [0, 16, 16, 16]
    assert len(eng._prefix_cache[pre[:16].tobytes()]) == 2  # COW: not 3


def test_engine_pool_exhaustion_defers_the_queue_head_like_jax(pair):
    reqs = [(((np.arange(9) + 3 * i) % V).astype(np.int32), 6)
            for i in range(5)]
    eng, _, _ = _run(pair, reqs, num_slots=3, kv_block_size=8,
                     kv_pool_blocks=5)
    assert eng.stats["admission_deferred"] > 0
    with pytest.raises(ValueError, match="KV blocks"):
        eng.submit(np.arange(40, dtype=np.int32), 10)


def test_engine_ngram_speculation_accepts_and_rolls_back_like_jax(pair):
    """Acceptance (a repetitive prompt) and rollback across a block
    boundary (rejected drafts whose tail block returns to the pool)."""
    rng = np.random.default_rng(0)
    pre = rng.integers(0, V, size=20).astype(np.int32)
    reqs = [
        (np.concatenate([pre, rng.integers(0, V, size=5).astype(np.int32)]), 12),
        (np.tile(np.asarray([3, 9, 4, 7], np.int32), 5), 20),
        (np.concatenate([pre, rng.integers(0, V, size=6).astype(np.int32)]), 7),
        (rng.integers(0, V, size=3).astype(np.int32), 14),
    ]
    eng, _, comps = _run(pair, reqs, num_slots=3, kv_block_size=8,
                         speculate="ngram", speculate_k=4)
    s = eng.stats
    assert s["decode_verify"] > 0 and s["decode_paged"] > 0
    assert 0 < s["spec_accepted"] <= s["spec_proposed"]
    assert s["block_rollback"] > 0 and s["prefix_hits"] > 0
    assert any(c.spec_accept_rate > 0 for c in comps.values())


def test_seq_len_edge_verify_tile_drops_writes_past_the_table(pair):
    """A request whose prompt + budget == seq_len rides another slot's
    verify tile at the end of the context, so its padding columns run
    past the block table. The port drops those writes and stays
    token-identical to generate(); the JAX model clamps them onto the
    row's last table column, overwriting real positions of its last
    block (ROADMAP C.4). Engine level: both engines agree with
    generate() here (the clobbered K/V does not flip a greedy pick);
    model level: the clobber shows in the JAX pool and not in the
    port's."""
    jm, params, tm = pair
    rng = np.random.default_rng(5)
    seq = TINY["seq_len"]
    edge = rng.integers(0, V, size=seq - 8).astype(np.int32)
    reqs = [(edge, 8), (np.tile(np.asarray([3, 9, 4, 7], np.int32), 5), 12)]
    edge_verifies = []
    orig = ServingEngine._spec_verify

    def spy(self, drafts):
        if self._active[0] and self._len[0] - 1 + self.spec_k >= seq:
            edge_verifies.append(int(self._len[0] - 1))
        return orig(self, drafts)

    ServingEngine._spec_verify = spy
    try:
        eng, _, comps = _run(pair, reqs, num_slots=2, kv_block_size=8,
                             speculate="ngram", speculate_k=4)
    finally:
        ServingEngine._spec_verify = orig
    assert edge_verifies, "no verify tile ran past the table"
    # _run held the JAX engine to the port's; generate() is held to the
    # JAX package's in test_torch_serving.py.
    for i, (p, n) in enumerate(reqs):
        ref = tgen.generate(tm, p[None], max_new_tokens=n, temperature=0.0,
                            device="cpu")[0].numpy()
        np.testing.assert_array_equal(comps[i].tokens, ref)

    # Model level: one verify tile at cursor seq - 3 (columns seq .. seq+1
    # run past the table of 16 blocks).
    bs = 8
    jp = jm.clone(kv_block_size=bs, kv_pool_blocks=3 * (seq // bs) + 1)
    tc, jc = _paged_caches(tm, bs, rng)
    tgen.rewind_cache_indices(tc, torch.tensor([seq - 3, 4, 9],
                                               dtype=torch.int32))
    jc = _to_jax(tc)
    before = tc["key_pool"].clone()
    last = int(tc["block_tables"][0, -1])
    tile = rng.integers(0, V, (3, 5)).astype(np.int32)
    with pallas_interpret():
        _, jc = jgen._verify_step(jp, params, jc, jnp.asarray(tile))
    tgen._verify_step(tm, tc, torch.from_numpy(tile))
    jpool = _flat(jc)["key_pool"]
    # Offsets 0 and 1 of the row's last block hold positions seq-8, seq-7.
    np.testing.assert_array_equal(_np(tc["key_pool"][:, last, :2]),
                                  _np(before[:, last, :2]))
    assert not np.allclose(jpool[:, last, :2], _np(before[:, last, :2]))


@pytest.mark.parametrize(
    "case", ["not_paged", "sampled", "zero_k", "unknown"]
)
def test_speculation_refusals_match_jax(pair, case):
    jm, params, tm = pair
    kw = {
        "not_paged": (dict(speculate="ngram"), 0.0),
        "sampled": (dict(kv_block_size=8, speculate="ngram"), 0.5),
        "zero_k": (dict(kv_block_size=8, speculate="ngram", speculate_k=0),
                   0.0),
        "unknown": (dict(kv_block_size=8, speculate="medusa"), 0.0),
    }[case]
    errors = []
    with pytest.raises(ValueError) as info:
        JaxEngine(jm, params, num_slots=1, temperature=kw[1],
                  serving=JaxServingConfig(**kw[0]))
    errors.append(str(info.value))
    with pytest.raises(ValueError) as info:
        ServingEngine(tm, num_slots=1, temperature=kw[1],
                      serving=ServingConfig(**kw[0]), device="cpu")
    errors.append(str(info.value))
    assert errors[0] == errors[1]
