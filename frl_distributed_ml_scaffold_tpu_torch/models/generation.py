"""Autoregressive generation for the port's GPT: prefill + KV-cache decode.

The port of the JAX package's ``models/generation.py`` for the serving
slice. One prefill over the (left-padded, ragged) prompt fills every
layer's cache; then one single-token decode step per new token, in a
Python loop where the JAX package scans. The cache is bucketed to the
smallest power of two covering prompt + budget (``next_cache_bucket``).

Sampling: greedy (``temperature=0``), temperature, top-k and nucleus
(top-p), drawing from an explicit ``torch.Generator``. The draws differ
from ``jax.random``'s; greedy decoding is the same function in both.
"""

from __future__ import annotations

import torch

from frl_distributed_ml_scaffold_tpu_torch import resolve_device


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


def next_cache_bucket(seq_len: int, needed: int, floor: int = 8) -> int:
    """Smallest power of two >= ``needed`` (and >= ``floor``), with
    ``seq_len`` itself as the terminal bucket."""
    if needed > seq_len:
        raise ValueError(f"needed cache {needed} exceeds seq_len {seq_len}")
    b = 1 << max(needed, floor, 1).bit_length()
    if b // 2 >= max(needed, floor, 1):
        b //= 2
    return min(b, seq_len)


@torch.no_grad()
def _prefill(model, prompt, lengths, *, cache_len: int):
    """One pass over the (possibly left-padded ragged) prompt creates and
    fills a cache of capacity ``cache_len``; returns (last-position
    logits ``[B, V]``, cache). Prompts are right-aligned, so position -1
    is every row's real last token."""
    cache = model.init_cache(prompt.shape[0], cache_len)
    logits = model(prompt, cache, lengths)
    return logits[:, -1], cache


@torch.no_grad()
def _decode_step(model, cache: dict, tok: torch.Tensor):
    """One single-token decode step for every row: returns (logits
    ``[B, V]``, the cache, advanced in place)."""
    return model(tok[:, None], cache)[:, 0], cache


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


def cache_batch_axis(leaf: torch.Tensor, batch_rows: int) -> int | None:
    """Which axis of a cache leaf carries the request rows: K/V stacks
    ``[L, B, S, H, hd]`` and ``cache_index [L, B]`` on axis 1,
    ``pos_index [B]`` on axis 0. Every per-row cache transform (the
    serving engine's slot graft) routes through this."""
    if leaf.dim() >= 2 and leaf.shape[1] == batch_rows:
        return 1
    if leaf.dim() == 1 and leaf.shape[0] == batch_rows:
        return 0
    return None


def cache_capacity_axis(leaf: torch.Tensor, cache_len: int) -> int | None:
    """Which axis carries the cache capacity (the bucketed S the engine
    grows): axis 2 of the K/V stacks; bookkeeping leaves carry none."""
    if leaf.dim() >= 4 and leaf.shape[2] == cache_len:
        return 2
    return None


def cache_bytes_per_slot(cache: dict, num_slots: int) -> int:
    """Per-slot device bytes of a decode cache, from its actual leaves."""
    total = 0
    for leaf in cache.values():
        ax = cache_batch_axis(leaf, num_slots)
        if ax is None:
            continue
        total += leaf.numel() // leaf.shape[ax] * leaf.element_size()
    return int(total)
