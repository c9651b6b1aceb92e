"""Autoregressive generation for the port's GPT: prefill + KV-cache decode.

The port of the JAX package's ``models/generation.py`` for the serving
path. One prefill over the (left-padded, ragged) prompt fills every
layer's cache; then one single-token decode step per new token, in a
Python loop where the JAX package scans. The cache is bucketed to the
smallest power of two covering prompt + budget (``next_cache_bucket``).
The serving engine's paged pool adds the speculative verify step and
cursor rewind, and the block-pool taxonomy (``POOL_LEAF_OF``,
``splice_pool_blocks``, ``pool_block_bytes``) at the end of the module.

Under a mesh (``mesh_context``) with the model's parameters placed by
``shard_params_for_serving``, ``generate`` and ``beam_search`` decode
over this rank's heads and, when they divide, this rank's rows of the
batch (``GPT.cache_rows``), every rank ending with every row's tokens.
The byte counts report the whole arrays, as the JAX functions count
them, when given the model's head count.

Sampling: greedy (``temperature=0``), temperature, top-k and nucleus
(top-p), drawing from an explicit ``torch.Generator``. The draws differ
from ``jax.random``'s; greedy decoding is the same function in both.
``beam_search`` runs over the same prefill and decode step. A
pipelined model (``pipeline_stages > 1``) decodes on its ``stages=1``
twin (``_plain_stack``): the port keeps the plain names under every
pipeline backend, so the twin takes the same tensors.
"""

from __future__ import annotations

import torch

from frl_distributed_ml_scaffold_tpu_torch import resolve_device
from frl_distributed_ml_scaffold_tpu_torch.ops.quantization import byte_view


def _sample(
    logits: torch.Tensor, generator: torch.Generator | None, *,
    temperature: float, top_k: int, top_p: float = 0.0,
) -> torch.Tensor:
    """[B, V] logits -> [B] sampled int32 token ids (fp32 softmax)."""
    logits = logits.float()
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temperature
    neg = torch.finfo(torch.float32).min
    if 0 < top_k < logits.shape[-1]:  # k >= V keeps everything
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, neg)
    if 0.0 < top_p < 1.0:
        # Inclusive nucleus, scattered back by POSITION (value thresholding
        # would keep every token tied with the boundary logit).
        order = torch.argsort(-logits, dim=-1, stable=True)
        probs = torch.softmax(torch.gather(logits, -1, order), dim=-1)
        keep_sorted = torch.cumsum(probs, dim=-1) - probs < top_p
        keep = torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
        logits = logits.masked_fill(~keep, neg)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32
    )


def _plain_stack(model):
    """Decode always runs on the plain layer stack: a pipeline-trained
    model (``pipeline_stages > 1``) is swapped for its ``stages=1`` twin
    holding the same tensors (the JAX ``_plain_stack``; its restack is a
    reshape there, nothing here). Callers that decode many times can do
    this once and pass the twin."""
    cfg = getattr(model, "config", None)
    if cfg is None or getattr(cfg, "pipeline_stages", 1) <= 1:
        return model
    import dataclasses

    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import (
        GPT,
        unstack_pipeline_params,
    )

    plain = GPT(dataclasses.replace(cfg, pipeline_stages=1), model.policy,
                device="meta")
    plain.load_state_dict(unstack_pipeline_params(cfg, model.state_dict()),
                          assign=True)
    return plain


def next_cache_bucket(seq_len: int, needed: int, floor: int = 8) -> int:
    """Smallest power of two >= ``needed`` (and >= ``floor``), with
    ``seq_len`` itself as the terminal bucket."""
    if needed > seq_len:
        raise ValueError(f"needed cache {needed} exceeds seq_len {seq_len}")
    b = 1 << max(needed, floor, 1).bit_length()
    if b // 2 >= max(needed, floor, 1):
        b //= 2
    return min(b, seq_len)


def _take_logits(out):
    """The logits of a forward: an MoE model returns ``(logits, aux)``."""
    return out[0] if isinstance(out, tuple) else out


@torch.no_grad()
def _prefill(model, prompt, lengths, *, cache_len: int, cache=None):
    """One pass over the (possibly left-padded ragged) prompt creates and
    fills a cache of capacity ``cache_len``; returns (last-position
    logits ``[B, V]``, cache). Prompts are right-aligned, so position -1
    is every row's real last token.

    ``cache`` seeds the pass instead of an empty cache: the serving
    engine's shared-prefix path prefills only a prompt's SUFFIX against a
    contiguous cache whose leading positions hold the shared prefix's K/V
    (gathered from the pool) and whose ``cache_index`` / ``pos_index``
    start at the prefix length. The model's masks and positions start
    from those indices, so the attention is that of a full-prompt
    prefill."""
    if cache is None:
        cache = model.init_cache(prompt.shape[0], cache_len)
    logits = _take_logits(model(prompt, cache, lengths))
    return logits[:, -1], cache


@torch.no_grad()
def _decode_step(model, cache: dict, tok: torch.Tensor):
    """One single-token decode step for every row: returns (logits
    ``[B, V]``, the cache, advanced in place)."""
    return _take_logits(model(tok[:, None], cache))[:, 0], cache


@torch.no_grad()
def _verify_step(model, cache: dict, toks: torch.Tensor):
    """One batched speculative-verify forward: ``toks [B, T]`` is each
    row's last accepted token followed by T-1 drafts. Returns (logits
    ``[B, T, V]`` at every position, the cache). On a paged cache every
    position scores causally in one pass, so position 0's logits are the
    single-token step's and greedy acceptance is exact. The cursors
    advance by T; ``rewind_cache_indices`` rolls rejected positions
    back."""
    return _take_logits(model(toks, cache)), cache


def rewind_cache_indices(cache: dict, new_idx) -> dict:
    """Speculative rollback: set every row's write cursor (the per-layer
    ``cache_index [L, B]`` rows and ``pos_index [B]``) to ``new_idx
    [B]``, in place. Rejected positions' K/V stay in the pool past the
    cursor, masked out of every later read and overwritten by later
    writes; every other leaf is untouched."""
    new_idx = torch.as_tensor(new_idx).to(
        device=cache["pos_index"].device, dtype=torch.int32
    )
    cache["cache_index"].copy_(new_idx[None, :].expand_as(cache["cache_index"]))
    cache["pos_index"].copy_(new_idx)
    return cache


def generate(
    model,
    prompt,
    *,
    max_new_tokens: int,
    temperature: float = 1.0,
    top_k: int = 0,
    top_p: float = 0.0,
    eos_id: int | None = None,
    generator: torch.Generator | None = None,
    prompt_lengths=None,
    device=None,
) -> torch.Tensor:
    """Sample ``max_new_tokens`` continuations of ``prompt`` ([B, Tp]
    int). Returns ``[B, Tp + max_new_tokens]``; positions after an
    ``eos_id`` emission are padded with ``eos_id``. Ragged batches pass
    LEFT-padded prompts plus ``prompt_lengths [B]``. ``device=None``
    means ``cuda``; the model must live on the resolved device."""
    model = _plain_stack(model)
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model lives on {model.device}, asked for {dev}")
    cfg = model.config
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    b, tp = prompt.shape
    if tp + max_new_tokens > cfg.seq_len:
        raise ValueError(
            f"prompt ({tp}) + max_new_tokens ({max_new_tokens}) exceeds the "
            f"model context ({cfg.seq_len}) — the KV cache is sized to it"
        )
    # Prefill writes [0, Tp) and rows extend to at most Tp + new - 1.
    cache_len = next_cache_bucket(cfg.seq_len, tp + max_new_tokens)
    if prompt_lengths is not None:
        prompt_lengths = torch.as_tensor(prompt_lengths, device=dev)
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)

    logits, cache = _prefill(model, prompt, prompt_lengths, cache_len=cache_len)
    tok = _sample(logits, generator, **kw)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    if eos_id is not None:
        done = tok == eos_id
    toks = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = _decode_step(model, cache, tok)
        tok = _sample(logits, generator, **kw)
        if eos_id is not None:
            tok = torch.where(done, torch.full_like(tok, eos_id), tok)
            done = done | (tok == eos_id)
        toks.append(tok)
    return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)


def _gather_cache_rows(cache: dict, rows: torch.Tensor,
                       batch_rows: int) -> dict:
    """The per-beam rows of a contiguous decode cache reordered by
    ``rows``: K/V, scales and the per-row bookkeeping (``cache_index``,
    ``pos_index``) follow their beam, since under ragged prompts the
    beams of different rows sit at different positions. A cache split
    over the batch axes (``GPT.cache_rows``) holds this rank's slice of
    the ``batch_rows`` rows, and each of them takes a parent of the same
    prompt, so of the same slice."""
    held = cache["pos_index"].shape[0]
    if held != batch_rows:
        lo = _row0(held)
        rows = rows[lo:lo + held] - lo
        batch_rows = held
    out = {}
    for name, leaf in cache.items():
        ax = cache_batch_axis(leaf, batch_rows)
        out[name] = leaf if ax is None else leaf.index_select(ax, rows)
    return out


def _row0(held: int) -> int:
    """The first global row of this rank's ``held`` rows of a cache split
    over the batch axes of the current mesh."""
    from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
        current_mesh_env,
    )

    return current_mesh_env().batch_index * held


def _repeat_cache_rows(cache: dict, w: int, batch_rows: int) -> dict:
    """A ``[B]``-row cache as ``[B * W]`` beams, each row repeated ``w``
    times in place (row b's beams are rows ``b * w .. b * w + w - 1``;
    a split cache's slice of them, since its rows are whole prompts)."""
    batch_rows = cache["pos_index"].shape[0]
    out = {}
    for name, leaf in cache.items():
        ax = cache_batch_axis(leaf, batch_rows)
        out[name] = leaf if ax is None else leaf.repeat_interleave(w, dim=ax)
    return out


@torch.no_grad()
def beam_search(
    model,
    prompt,
    *,
    max_new_tokens: int,
    num_beams: int = 4,
    eos_id: int | None = None,
    length_penalty: float = 0.0,
    prompt_lengths=None,
    cache_len: int | None = None,
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic beam decode of ``prompt`` ([B, Tp] int, LEFT-padded
    with ``prompt_lengths`` when ragged); returns ``([B, Tp + new] best
    tokens, [B] scores)``, the JAX package's ``beam_search``.

    One prefill over the ``[B]`` prompt, its cache then repeated to
    ``[B * W]`` beams; then one decode step over every beam per new
    token (``_decode_step``: the decode kernel on the card). Each step
    extends every beam over the whole vocabulary, keeps the top W of
    ``W * V`` by summed log-probability (ties to the lower index, as
    ``lax.top_k``) and reorders the cache rows by the survivors'
    parents. With ``eos_id`` a finished beam is frozen: its only
    continuation is eos at zero added log-probability.

    The search ranks by the raw sum; with ``length_penalty`` alpha > 0
    the final ranking divides each beam's sum by ``len ** alpha`` (len
    counts the tokens up to and including the first eos), a stable sort
    keeping ties in the search's order. The returned score is the ranked
    quantity. ``device=None`` means ``cuda``; the model must live on the
    resolved device."""
    model = _plain_stack(model)
    dev = resolve_device(device)
    if model.device != dev:
        raise ValueError(f"model lives on {model.device}, asked for {dev}")
    cfg = model.config
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int32)
    b, tp = prompt.shape
    w = num_beams
    if max_new_tokens < 1:
        raise ValueError(
            f"max_new_tokens={max_new_tokens} < 1: the returned score is "
            "the sum log-prob of the emitted tokens, so at least one must "
            "be emitted"
        )
    if tp + max_new_tokens > cfg.seq_len:
        raise ValueError(
            f"prompt ({tp}) + max_new_tokens ({max_new_tokens}) exceeds the "
            f"model context ({cfg.seq_len}) — the KV cache is sized to it"
        )
    if w < 1 or w > cfg.vocab_size:
        raise ValueError(f"num_beams={w} not in [1, vocab={cfg.vocab_size}]")
    needed = tp + max_new_tokens
    if cache_len is None:
        cache_len = next_cache_bucket(cfg.seq_len, needed)
    if cache_len < needed:
        raise ValueError(
            f"cache_len={cache_len} cannot hold prompt+new={needed} tokens")
    if prompt_lengths is not None:
        prompt_lengths = torch.as_tensor(prompt_lengths, device=dev)

    logits, cache = _prefill(model, prompt, prompt_lengths,
                             cache_len=cache_len)
    scores, tok = _top_k(torch.log_softmax(logits.float(), dim=-1), w)
    cache = _repeat_cache_rows(cache, w, b)
    finished = (torch.zeros((b, w), dtype=torch.bool, device=dev)
                if eos_id is None else tok == eos_id)
    buf = torch.zeros((b, w, max_new_tokens), dtype=torch.int32, device=dev)
    buf[:, :, 0] = tok
    batch_idx = torch.arange(b, device=dev)[:, None]
    for t in range(1, max_new_tokens):
        logits, cache = _decode_step(model, cache, tok.reshape(b * w))
        lp = torch.log_softmax(logits.float(), dim=-1).reshape(b, w, -1)
        if eos_id is not None:
            # Frozen beams may only repeat eos, for free: their score
            # stays comparable while live beams keep extending.
            eos_only = torch.full_like(lp, torch.finfo(torch.float32).min)
            eos_only[..., eos_id] = 0.0
            lp = torch.where(finished[..., None], eos_only, lp)
        total = scores[..., None] + lp  # [B, W, V]
        v = total.shape[-1]
        scores, flat = _top_k(total.reshape(b, w * v), w)
        src = flat // v  # each survivor's parent beam [B, W]
        tok = (flat % v).to(torch.int32)
        cache = _gather_cache_rows(cache, (batch_idx * w + src).reshape(-1),
                                   b * w)
        buf = buf[batch_idx, src]
        buf[:, :, t] = tok
        finished = finished[batch_idx, src]
        if eos_id is not None:
            finished = finished | (tok == eos_id)
    if length_penalty > 0.0:
        # Re-rank by the length-normalised score; the search stays on the
        # raw sum (the normalisation is not monotone across prefixes of
        # different lengths).
        if eos_id is None:
            # Every beam has the same length: a constant division, no
            # reorder (a sort could swap beams tied in f32).
            scores = scores / float(max_new_tokens) ** length_penalty
        else:
            is_eos = buf == eos_id
            first = is_eos.int().argmax(dim=-1)
            lens = torch.where(is_eos.any(-1), first + 1,
                               torch.full_like(first, max_new_tokens)).float()
            ranked = scores / lens ** length_penalty
            order = torch.argsort(-ranked, dim=1, stable=True)
            buf = torch.gather(buf, 1, order[..., None].expand_as(buf))
            scores = torch.gather(ranked, 1, order)
    # Beams are sorted by (possibly re-ranked) score: beam 0 is the best.
    return torch.cat([prompt, buf[:, 0]], dim=1), scores[:, 0]


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of each row, largest first, ties to the lower
    index (``lax.top_k``'s order; ``torch.topk`` does not promise one)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def cache_batch_axis(leaf: torch.Tensor, batch_rows: int) -> int | None:
    """Which axis of a cache leaf carries the request rows: K/V stacks
    ``[L, B, S, H, hd]``, the quantized cache's scale stacks
    ``[L, B, S, H]`` and ``cache_index [L, B]`` on axis 1, ``pos_index
    [B]`` on axis 0. Every per-row cache transform (the serving engine's
    slot graft) routes through this."""
    if leaf.dim() >= 2 and leaf.shape[1] == batch_rows:
        return 1
    if leaf.dim() == 1 and leaf.shape[0] == batch_rows:
        return 0
    return None


def cache_capacity_axis(leaf: torch.Tensor, cache_len: int) -> int | None:
    """Which axis carries the cache capacity (the bucketed S the engine
    grows): axis 2 of the K/V stacks and of the scale stacks
    ``[L, B, S, H]``; bookkeeping leaves carry none."""
    if leaf.dim() >= 4 and leaf.shape[2] == cache_len:
        return 2
    return None


def _heads_scale(leaf: torch.Tensor, axis: int | None,
                 num_heads: int | None) -> float:
    """How many times the whole array holds ``leaf``'s heads: a leaf of
    this rank's ``leaf.shape[axis]`` heads counts ``num_heads`` of them
    (1 when not asked for, or for a leaf without heads)."""
    if num_heads is None or axis is None:
        return 1
    return num_heads / leaf.shape[axis]


def cache_bytes_per_slot(cache: dict, num_slots: int, *,
                         num_heads: int | None = None) -> int:
    """Per-slot device bytes of a decode cache, from its actual leaves
    (scale leaves and bookkeeping included). ``num_slots`` is the rows
    the leaves hold. With ``num_heads`` the count is the whole array's,
    as the JAX function counts it: leaves holding this rank's heads
    (axis 3 of the K/V ``[L, B, S, H, hd]`` and scale ``[L, B, S, H]``
    stacks) count every head."""
    total = 0
    for leaf in cache.values():
        ax = cache_batch_axis(leaf, num_slots)
        if ax is None:
            continue
        per_row = leaf.numel() // leaf.shape[ax] * leaf.element_size()
        heads = 3 if leaf.dim() >= 4 else None
        total += int(per_row * _heads_scale(leaf, heads, num_heads))
    return int(total)


def _kv_bytes_per_position(cfg, kv_dtype_bytes: int) -> int:
    """One layer's K + V bytes for one position, the bf16 scales per
    (position, head) included under ``cfg.kv_cache_quant``."""
    h = cfg.num_heads
    hd = cfg.hidden_dim // h
    if cfg.kv_cache_quant == "none":
        return 2 * h * hd * kv_dtype_bytes
    return 2 * h * hd + 2 * h * 2


def estimate_cache_bytes_per_slot(cfg, cache_len: int, *,
                                  kv_dtype_bytes: int = 2) -> int:
    """Analytic twin of ``cache_bytes_per_slot`` at bucket
    ``cache_len``: ``L x (K + V (+ scales) + cache_index) + pos_index``.
    ``kv_dtype_bytes`` is the unquantized element width (2 for bf16, 4
    for fp32); a quantized cache costs 1 byte per element plus its bf16
    scales whatever it is."""
    per_layer = cache_len * _kv_bytes_per_position(cfg, kv_dtype_bytes) + 4
    return cfg.num_layers * per_layer + 4


# ----------------------------------------------------- paged (block) pool
#
# The paged cache replaces per-slot [L, B, S, ...] stacks with per-layer
# pools of fixed-size blocks plus per-row block tables. Pool leaves carry
# no row axis and are told apart by NAME (a pool's [N, bs, H, hd] shape
# is a slot cache's [B, S, H, hd] by shape alone).

#: Slot-cache leaf name -> its pool counterpart.
POOL_LEAF_OF: dict[str, str] = {
    "cached_key": "key_pool",
    "cached_value": "value_pool",
    "key_scale": "key_pool_scale",
    "value_scale": "value_pool_scale",
}

#: Pool leaf name -> slot-cache leaf name.
SLOT_LEAF_OF: dict[str, str] = {v: k for k, v in POOL_LEAF_OF.items()}


def blocks_for_tokens(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` cache positions (ceil)."""
    if tokens <= 0:
        return 0
    return -(-int(tokens) // int(block_size))


@torch.no_grad()
def splice_pool_blocks(cache: dict, slot_cache: dict, blk_ids, m0: int,
                       slot: int, *, block_size: int) -> dict:
    """Write one prefilled (contiguous, one-row) slot cache's PRIVATE
    blocks into their pool homes, in place, and set the slot's cursors.
    ``blk_ids [n_priv]`` are the destination pool ids of the logical
    blocks starting at ``m0``; shared prefix blocks below ``m0`` are
    already in the pool and are not touched. Returns ``cache``."""
    bs = block_size
    ids = torch.as_tensor(blk_ids, dtype=torch.long)
    n_priv = int(ids.numel())
    for name, leaf in slot_cache.items():
        if name in POOL_LEAF_OF:
            pool = cache[POOL_LEAF_OF[name]]
            n_blk = leaf.shape[2] // bs
            chunks = leaf[:, 0].reshape(
                (leaf.shape[0], n_blk, bs) + tuple(leaf.shape[3:])
            )
            byte_view(pool)[:, ids.to(pool.device)] = byte_view(
                chunks[:, m0:m0 + n_priv].to(pool.dtype))
        elif name == "cache_index":
            cache[name][:, slot] = leaf[:, 0]
        elif name == "pos_index":
            cache[name][slot] = leaf[0]
    return cache


def pool_block_bytes(cache: dict, *, num_heads: int | None = None) -> int:
    """Device bytes of ONE pool block across all layers, from the actual
    pool leaves (the unit paged admission is priced in). With
    ``num_heads`` the whole pool's block, as the JAX function counts it:
    a leaf of this rank's heads (``pool_heads_axis``) counts every
    head."""
    total = 0
    for name, leaf in cache.items():
        if name in SLOT_LEAF_OF:
            # [L, N, bs, ...] stacked pool leaf: bytes per all-layer block.
            per = leaf.numel() // leaf.shape[1] * leaf.element_size()
            total += int(per * _heads_scale(leaf, pool_heads_axis(name, leaf),
                                            num_heads))
    return int(total)


def pool_cache_bytes(cache: dict, *, num_heads: int | None = None) -> int:
    """Device bytes of a whole paged cache (pools, tables, cursors); with
    ``num_heads`` the whole arrays' count, the pools at every head."""
    return int(sum(
        t.numel() * t.element_size()
        * _heads_scale(t, pool_heads_axis(name, t), num_heads)
        for name, t in cache.items()))


def pool_heads_axis(name: str, leaf: torch.Tensor) -> int | None:
    """Which axis of a POOL leaf carries the attention heads, the axis
    tensor-parallel serving splits over ``model``: K/V pools ``[..., N,
    bs, H, hd]`` at ``ndim - 2``, scale pools ``[..., N, bs, H]`` at
    ``ndim - 1``; tables and cursors carry none. Keyed by name like
    ``POOL_LEAF_OF`` (a pool's shape is a slot cache's by shape alone)."""
    if name in ("key_pool", "value_pool"):
        return leaf.dim() - 2
    if name in ("key_pool_scale", "value_pool_scale"):
        return leaf.dim() - 1
    return None


def pool_leaf_spec(name: str, leaf: torch.Tensor) -> tuple | None:
    """The spec of one paged-cache leaf under a ``model`` axis (one entry
    per dim, ``parallel/partition.py``'s form): a pool leaf splits its
    heads over ``model`` and is whole over every batch axis (blocks are
    shared by the slot rows); None for the bookkeeping leaves, which
    every rank holds whole."""
    ax = pool_heads_axis(name, leaf)
    if ax is None:
        return None
    entries = [None] * leaf.dim()
    entries[ax] = "model"
    return tuple(entries)


def estimate_pool_block_bytes(cfg, block_size: int, *,
                              kv_dtype_bytes: int = 2) -> int:
    """Analytic twin of ``pool_block_bytes``: one block of
    ``block_size`` positions costs ``L x 2 x bs x H x hd`` payload bytes
    (``kv_dtype_bytes`` each unquantized, 1 under ``cfg.kv_cache_quant``,
    plus the bf16 scale blocks)."""
    return (cfg.num_layers * block_size
            * _kv_bytes_per_position(cfg, kv_dtype_bytes))
