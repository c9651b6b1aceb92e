"""GPT-2 transformer LM, decode mode: the port of the JAX package's
``models/gpt.py`` for the serving slice.

The non-pipelined, non-MoE stack over a contiguous KV cache. Numerics
follow the JAX model: LayerNorm in fp32 (eps from the config), every
projection in the policy's compute dtype, GELU in its tanh form (flax's
default; torch's default is the exact form), weight-tied LM head.

The decode cache is a dict of tensors with the JAX cache's leaf names and
shapes, so the two compare leaf by leaf:

- ``cached_key`` / ``cached_value`` ``[L, B, S, H, hd]`` (compute dtype);
- ``cache_index`` ``[L, B]`` int32, each row's next write position;
- ``pos_index`` ``[B]`` int32, each row's next absolute position.

``GPT.forward`` updates the cache IN PLACE (the JAX model returns a new
cache and the serving engine donates the old one; in place is what keeps
one cache live here). The capacity S is the tensors' own shape, so a
bucketed cache needs no model clone.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from frl_distributed_ml_scaffold_tpu_torch import resolve_device
from frl_distributed_ml_scaffold_tpu_torch.config.schema import GPTConfig
from frl_distributed_ml_scaffold_tpu_torch.ops.decode_attention import (
    decode_attention,
)
from frl_distributed_ml_scaffold_tpu_torch.precision import Policy


def _check_supported(cfg: GPTConfig) -> None:
    """Refuse the configurations this slice does not port yet, each with
    the ROADMAP item that brings it."""
    if cfg.attention != "dense":
        raise NotImplementedError(
            f"model.attention={cfg.attention!r} is a training-path mode, "
            "not ported yet (ROADMAP queue A item 5, training, with queue "
            "B items 1-3 for flash; item 12 for ring/ulysses)"
        )
    if cfg.kv_cache_quant != "none":
        raise NotImplementedError(
            "model.kv_cache_quant is not ported yet (ROADMAP queue B "
            "item 7, quantized KV cache)"
        )
    if cfg.moe.num_experts > 0 or cfg.pipeline_stages > 1:
        raise NotImplementedError(
            "MoE blocks and pipeline_stages > 1 are not ported yet "
            "(ROADMAP queue A item 12, pipelines and MoE)"
        )
    if cfg.hidden_dim % cfg.num_heads:
        raise ValueError(
            f"hidden_dim {cfg.hidden_dim} not divisible by "
            f"num_heads {cfg.num_heads}"
        )


def _masked_dense_attention(q, k, v, mask):
    """Dense attention with an explicit mask ([Tq, Tk] shared or
    [B, Tq, Tk] per row), fp32 scores and softmax, probabilities cast to
    q's dtype before the PV product. q ``[B, Tq, H, hd]``, k/v
    ``[B, Tk, H, hd]``."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(hd)
    mask = mask[:, None] if mask.dim() == 3 else mask[None, None]
    scores = scores.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhqk,bkhd->bqhd", probs.to(q.dtype).float(), v.float()
    )
    return out.to(q.dtype)


def _write_drop(cache_l, cols, vals):
    """``cache_l[b, cols[b, j]] = vals[b, j]`` with columns past the
    capacity DROPPED, not clipped (clipping would pile them onto the last
    position and clobber a real token's K/V). cache_l ``[B, S, H, hd]``,
    cols ``[B, t]``, vals ``[B, t, H, hd]``."""
    b, s = cache_l.shape[:2]
    rows = torch.arange(b, device=cols.device)
    if cols.shape[1] == 1:
        # One column per row: a dropped write rewrites the value already
        # at the clamped column, which keeps the step free of host syncs.
        c = cols[:, 0]
        keep = (c < s)[:, None, None]
        cc = c.clamp(max=s - 1)
        cache_l[rows, cc] = torch.where(keep, vals[:, 0], cache_l[rows, cc])
        return
    keep = cols < s
    r = rows[:, None].expand_as(cols)
    cache_l[r[keep], cols[keep]] = vals[keep]


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, policy: Policy, device):
        super().__init__()
        self.cfg, self.dtype = cfg, policy.compute_dtype
        d, pd = cfg.hidden_dim, policy.param_dtype
        self.query = nn.Linear(d, d, device=device, dtype=pd)
        self.key = nn.Linear(d, d, device=device, dtype=pd)
        self.value = nn.Linear(d, d, device=device, dtype=pd)
        self.out = nn.Linear(d, d, device=device, dtype=pd)

    def _dense(self, lin: nn.Linear, x):
        return F.linear(
            x.to(self.dtype), lin.weight.to(self.dtype),
            lin.bias.to(self.dtype),
        )

    def forward(self, x, cache: dict, layer: int, lens):
        cfg = self.cfg
        b, t, d = x.shape
        h = cfg.num_heads
        hd = d // h
        q = self._dense(self.query, x).view(b, t, h, hd)
        k_w = self._dense(self.key, x).view(b, t, h, hd)
        v_w = self._dense(self.value, x).view(b, t, h, hd)
        ck = cache["cached_key"][layer]  # [B, S, H, hd] view
        cv = cache["cached_value"][layer]
        idx = cache["cache_index"][layer]  # [B] view, advanced last
        s = ck.shape[1]
        pad = t - lens  # [B] left-pad widths (0 when not ragged)
        ar = torch.arange(t, device=x.device)
        if t > 1:
            # Ragged prefill: prompts arrive LEFT-padded. Roll each row so
            # its real tokens land at cache slots [0, len); the trailing
            # t-len slots hold wrapped pad garbage at positions >= len,
            # masked now and overwritten by later decode steps.
            roll = (ar[None, :] + pad[:, None]) % t
            gidx = roll[:, :, None, None].expand(b, t, h, hd)
            k_w = torch.gather(k_w, 1, gidx)
            v_w = torch.gather(v_w, 1, gidx)
        write_cols = idx[:, None] + ar[None, :]  # [B, t]
        _write_drop(ck, write_cols, k_w)
        _write_drop(cv, write_cols, v_w)
        if t == 1:
            y = decode_attention(
                q[:, 0], ck, cv, idx + 1, impl=cfg.decode_attention
            )[:, None]
        else:
            # Query column j sits at absolute position idx + j - pad
            # (pad columns clip to 0: never read, but kept finite).
            qpos = (idx[:, None] + ar[None, :] - pad[:, None]).clamp(min=0)
            kpos = torch.arange(s, device=x.device)
            mask = kpos[None, None, :] <= qpos[:, :, None]  # [B, t, S]
            y = _masked_dense_attention(q, ck, cv, mask)
        idx.add_(lens)
        return self._dense(self.out, y.reshape(b, t, d))


class GptMlp(nn.Module):
    def __init__(self, cfg: GPTConfig, policy: Policy, device):
        super().__init__()
        self.dtype = policy.compute_dtype
        d, pd = cfg.hidden_dim, policy.param_dtype
        self.fc_in = nn.Linear(d, d * cfg.mlp_ratio, device=device, dtype=pd)
        self.fc_out = nn.Linear(d * cfg.mlp_ratio, d, device=device, dtype=pd)

    def forward(self, x):
        cd = self.dtype
        y = F.linear(x.to(cd), self.fc_in.weight.to(cd), self.fc_in.bias.to(cd))
        y = F.gelu(y, approximate="tanh")
        return F.linear(y, self.fc_out.weight.to(cd), self.fc_out.bias.to(cd))


def _layer_norm(ln: nn.LayerNorm, x):
    """LayerNorm in fp32 whatever the stream's dtype (flax
    ``LayerNorm(dtype=float32)``)."""
    return F.layer_norm(
        x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
        ln.eps,
    )


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, policy: Policy, device):
        super().__init__()
        d, pd, eps = cfg.hidden_dim, policy.param_dtype, cfg.layer_norm_epsilon
        self.ln1 = nn.LayerNorm(d, eps=eps, device=device, dtype=pd)
        self.attn = CausalSelfAttention(cfg, policy, device)
        self.ln2 = nn.LayerNorm(d, eps=eps, device=device, dtype=pd)
        self.mlp = GptMlp(cfg, policy, device)

    def forward(self, x, cache: dict, layer: int, lens):
        x = x + self.attn(_layer_norm(self.ln1, x), cache, layer, lens)
        return x + self.mlp(_layer_norm(self.ln2, x))


class GPT(nn.Module):
    """GPT-2 LM in decode mode. ``device=None`` means ``cuda`` and raises
    without a card. Weights come from ``models/convert.py``
    (``params_from_jax`` or the seeded ``init_params``) through
    ``load_state_dict``."""

    def __init__(self, config: GPTConfig, policy: Policy, *, device=None):
        super().__init__()
        _check_supported(config)
        device = resolve_device(device)
        self.config, self.policy = config, policy
        cfg, pd = config, policy.param_dtype
        self.wte = nn.Embedding(
            cfg.vocab_size, cfg.hidden_dim, device=device, dtype=pd
        )
        self.wpe = nn.Parameter(
            torch.zeros(cfg.seq_len, cfg.hidden_dim, device=device, dtype=pd)
        )
        self.blocks = nn.ModuleList(
            Block(cfg, policy, device) for _ in range(cfg.num_layers)
        )
        self.ln_f = nn.LayerNorm(
            cfg.hidden_dim, eps=cfg.layer_norm_epsilon, device=device,
            dtype=pd,
        )

    @property
    def device(self) -> torch.device:
        return self.wpe.device

    def init_cache(self, batch: int, cache_len: int) -> dict:
        """An empty decode cache of capacity ``cache_len``."""
        cfg = self.config
        h = cfg.num_heads
        kv = (cfg.num_layers, batch, cache_len, h, cfg.hidden_dim // h)
        dev, cd = self.device, self.policy.compute_dtype
        return {
            "cached_key": torch.zeros(kv, dtype=cd, device=dev),
            "cached_value": torch.zeros(kv, dtype=cd, device=dev),
            "cache_index": torch.zeros(
                (cfg.num_layers, batch), dtype=torch.int32, device=dev
            ),
            "pos_index": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }

    def forward(self, tokens, cache: dict, lengths=None):
        """tokens ``[B, t]`` (LEFT-padded when ``lengths [B]`` is given)
        against ``cache``, which advances in place by each row's length.
        Returns logits ``[B, t, vocab]`` in the compute dtype."""
        cfg, cd = self.config, self.policy.compute_dtype
        b, t = tokens.shape
        lens = (
            torch.full((b,), t, dtype=torch.int32, device=tokens.device)
            if lengths is None
            else lengths.to(device=tokens.device, dtype=torch.int32)
        )
        # Absolute positions per row; left-pad columns clip to 0 (their
        # lanes are masked out and never read).
        pos = cache["pos_index"]
        ar = torch.arange(t, device=tokens.device)
        pos_ids = (pos[:, None] + ar[None, :] - (t - lens)[:, None]).clamp(
            0, cfg.seq_len - 1
        )
        x = self.wte.weight[tokens].to(cd) + self.wpe[pos_ids].to(cd)
        pos.add_(lens)
        for layer, block in enumerate(self.blocks):
            x = block(x, cache, layer, lens)
        x = _layer_norm(self.ln_f, x)
        return F.linear(x.to(cd), self.wte.weight.to(cd))  # weight-tied head
