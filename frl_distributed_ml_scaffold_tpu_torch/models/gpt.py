"""GPT-2 transformer LM: the port of the JAX package's ``models/gpt.py``,
in training/eval mode (no cache) and in decode mode (over a KV cache).

The non-pipelined stack. ``GPT(tokens)`` with no cache is the
training/eval forward: positions ``wpe[:t]``, causal attention through
``model.attention`` (``dense``: ``ops/ring_attention.py``
``dense_attention``; ``flash``: ``ops/flash_attention.py``, the
hand-written kernels on the card; ``ring`` and ``ulysses``: sequence
parallelism over the mesh's ``seq`` axis, ``ops/ring_attention.py``
``ring_attention`` and ``ops/ulysses.py``, on the same kernels), and
``return_features=True`` returns the compute-dtype ``ln_f`` output for
the chunked-vocab loss (``trainer/tasks.py``). Training dropout
(``model.dropout``) sits where the JAX model's does: after the embedding
and after each block's attention output projection and ``fc_out``
(``models/dropout.py``).

Under ``seq = n`` rank r holds every row's tokens ``[r T/n, (r+1) T/n)``
through the whole model: its positions start at ``r T/n``, and only the
attention (ring or Ulysses) sees the other ranks' tokens. With
``model.moe.num_experts > 0`` each block's MLP is the MoE MLP
(``models/moe.py``) and the model returns ``(logits, aux)`` (or
``(features, aux)``, and in decode mode too), ``aux`` the fp32 sum of
the blocks' auxiliary losses, as the JAX model does.
``model.block_remat`` checkpoints each block on its own. ``GPT(tokens,
cache)`` is decode mode, over a contiguous or paged KV cache; it ignores
``block_remat`` and dropout, and its prefill is dense whatever
``model.attention`` says.

Numerics follow the JAX model: LayerNorm in fp32 (eps from the config),
every projection in the policy's compute dtype, GELU in its tanh form
(flax's default; torch's default is the exact form), weight-tied LM
head.

The decode cache is a dict of tensors with the JAX cache's leaf names and
shapes, so the two compare leaf by leaf. Contiguous (``init_cache``):

- ``cached_key`` / ``cached_value`` ``[L, B, S, H, hd]`` (compute dtype);
- ``cache_index`` ``[L, B]`` int32, each row's next write position;
- ``pos_index`` ``[B]`` int32, each row's next absolute position.

Paged (``init_paged_cache``): ``key_pool`` / ``value_pool``
``[L, N, bs, H, hd]`` shared by every row, ``block_tables [B, M]`` int32
(row b's logical block j is pool block ``block_tables[b, j]``,
``M = ceil(seq_len / bs)``), and the same ``cache_index`` / ``pos_index``.

Quantized (``model.kv_cache_quant`` int8 / fp8_e4m3 / fp8_e5m2): K/V are
stored as 1-byte payloads (``ops/quantization.py``) with bf16 scales
beside them, ``key_scale`` / ``value_scale`` ``[L, B, S, H]`` or
``key_pool_scale`` / ``value_pool_scale`` ``[L, N, bs, H]``, whatever the
policy. Each written token is quantized ONCE, over its own head vector,
and never again, so a position contributes the same values at every
later step, in every bucket and in the pool. Prefill attends over the
bucket dequantized to the compute dtype; decode and verify hand the
scales to the kernels.

Block 0 is the trash block: tables point unallocated columns at it, and
writes past the table land there, so no row ever reads them. A paged
call takes one token per row (``paged_decode_attention``) or a verify
tile of t tokens (``paged_verify_attention``); prefill stays contiguous
and the serving engine splices it into the pool block by block.

Tensor-parallel decode (the params placed by ``parallel/partition.py``
``shard_params_for_serving``): each rank holds ``H / model`` heads of
q / k / v, ``out`` and ``fc_out`` row-parallel (one all-reduce each a
block), ``fc_in`` column-parallel, ``wte`` whole, so the logits come out
whole and the same on every rank. The cache and the pool hold the
rank's heads (``local_heads``); the contiguous cache's rows split over
the batch axes when they divide (``cache_rows``) and the logits are
gathered over them; the pool stays whole over them. Where the heads do
not divide over ``model`` the attention stays whole on every rank.

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
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from frl_distributed_ml_scaffold_tpu_torch import resolve_device
from frl_distributed_ml_scaffold_tpu_torch.config.schema import GPTConfig
from frl_distributed_ml_scaffold_tpu_torch.dist.collectives import all_gather
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
    BATCH_AXES,
    current_mesh_env,
)
from frl_distributed_ml_scaffold_tpu_torch.models.dropout import (
    check_seed,
    dropout,
)
from frl_distributed_ml_scaffold_tpu_torch.models.moe import MoEMlp
from frl_distributed_ml_scaffold_tpu_torch.ops.decode_attention import (
    decode_attention,
    paged_decode_attention,
    paged_verify_attention,
)
from frl_distributed_ml_scaffold_tpu_torch.ops.flash_attention import (
    flash_attention,
)
from frl_distributed_ml_scaffold_tpu_torch.ops.quantization import (
    byte_view,
    dequantize,
    lowp_dtype,
    quantize_kv,
    zeros,
)
from frl_distributed_ml_scaffold_tpu_torch.ops.ring_attention import (
    dense_attention,
    ring_attention,
)
from frl_distributed_ml_scaffold_tpu_torch.ops.ulysses import (
    ulysses_attention,
)
from frl_distributed_ml_scaffold_tpu_torch.parallel.partition import (
    PartitionRules,
)
from frl_distributed_ml_scaffold_tpu_torch.parallel.tensor_parallel import (
    copy_to_model,
    model_shard,
    reduce_from_model,
    seq_shard,
)
from frl_distributed_ml_scaffold_tpu_torch.precision import Policy

_TRAIN_ATTENTION = {"dense": dense_attention, "flash": flash_attention,
                    "ring": ring_attention, "ulysses": ulysses_attention}
# The attention modes that see the other ``seq`` ranks' tokens.
_SEQ_ATTENTION = ("ring", "ulysses")
_BLOCK_REMAT = ("none", "full", "save_attn")


def stacked_name(name: str) -> str:
    """The JAX leaf a port parameter belongs to: the JAX model scans its
    blocks, so ``blocks.<i>.<rest>`` of every layer i is one ``[L, ...]``
    leaf there (``blocks.<rest>``); other names are their own leaf. An
    optimizer that reduces over a whole leaf (Adafactor's block RMS)
    reduces over these groups."""
    head, _, rest = name.partition(".")
    if head == "blocks":
        return "blocks." + rest.partition(".")[2]
    return name


def gpt_pipe_stage(cfg: GPTConfig):
    """``name -> pipe rank`` of a pipelined GPT (the JAX pipelined
    rules' ``pipe`` entry): a block's parameters on the rank that holds
    its layer (``parallel/pipeline.py`` ``layer_stage``); the embedding
    and ``ln_f`` on every rank under the SPMD backend (None), under the
    MPMD backend the embedding on stage 0 and ``ln_f`` on the last."""
    from frl_distributed_ml_scaffold_tpu_torch.parallel.pipeline import (
        layer_stage,
    )

    mpmd = cfg.pipeline_impl == "mpmd"
    last = cfg.pipeline_stages - 1

    def stage(name: str) -> int | None:
        if name.startswith("blocks."):
            return layer_stage(cfg, int(name.split(".")[1]))
        if not mpmd:
            return None
        return last if name.startswith("ln_f.") else 0

    return stage


def gpt_tp_rules(pipeline: GPTConfig | None = None) -> PartitionRules:
    """Megatron column / row splits over ``model`` (the JAX package's
    non-pipelined ``gpt_tp_rules``), against the port's names and
    ``[out, in]`` weights: q / k / v and ``fc_in`` split their outputs
    (column-parallel), ``out`` and ``fc_out`` their inputs
    (row-parallel), and ``wte`` its vocabulary. The training forward
    reads ``wte`` whole (``TP_COMPUTE_WHOLE``): its split is storage,
    gathered for the step, and the tied head and the loss run on every
    rank along ``model`` over the whole vocabulary. The MoE experts
    ``wi [E, D, H]`` and ``wo [E, H, D]`` split their experts over
    ``expert`` (and their hidden dim over ``model``, which MoE refuses),
    and the router stays whole, as the JAX rules place them. With a
    pipelined ``pipeline`` config the rules also place each parameter on
    its ``pipe`` rank (``gpt_pipe_stage``)."""
    col, row = ("model", None), (None, "model")
    stage = (gpt_pipe_stage(pipeline) if pipeline is not None
             and pipeline.pipeline_stages > 1 else None)
    return PartitionRules(stage=stage, rules=(
        (r"^blocks\.\d+\.attn\.(query|key|value)\.weight$", col),
        (r"^blocks\.\d+\.attn\.(query|key|value)\.bias$", ("model",)),
        (r"^blocks\.\d+\.attn\.out\.weight$", row),
        (r"^blocks\.\d+\.mlp\.fc_in\.weight$", col),
        (r"^blocks\.\d+\.mlp\.fc_in\.bias$", ("model",)),
        (r"^blocks\.\d+\.mlp\.fc_out\.weight$", row),
        (r"^blocks\.\d+\.moe\.wi$", ("expert", None, "model")),
        (r"^blocks\.\d+\.moe\.wo$", ("expert", "model", None)),
        (r"^blocks\.\d+\.moe\.router\.weight$", (None, None)),
        (r"^wte\.weight$", ("model", None)),
    ))


# The parameters the training forward reads whole under tensor
# parallelism (their ``model`` split is storage only).
TP_COMPUTE_WHOLE = ("wte.weight",)


def _row_parallel(lin: nn.Linear, y, cd):
    """A row-parallel product: this rank's partial sums over its input
    slice, summed over ``model``, then the (replicated) bias."""
    out = reduce_from_model(F.linear(y.to(cd), lin.weight.to(cd)))
    return out + lin.bias.to(cd)


def _check_supported(cfg: GPTConfig) -> None:
    """Refuse the configurations the port does not have yet, each with
    the ROADMAP item that brings it."""
    if cfg.attention not in _TRAIN_ATTENTION:
        raise ValueError(
            f"unknown model.attention {cfg.attention!r} "
            f"(have {sorted(_TRAIN_ATTENTION)})"
        )
    if cfg.block_remat not in _BLOCK_REMAT:
        raise KeyError(
            f"unknown model.block_remat={cfg.block_remat!r} "
            "(none | full | save_attn)"
        )
    if cfg.kv_cache_quant != "none":
        lowp_dtype(cfg.kv_cache_quant)  # KeyError naming the formats
    if cfg.pipeline_stages > 1 and cfg.attention in _SEQ_ATTENTION:
        raise NotImplementedError(
            f"model.attention={cfg.attention!r} inside a pipeline "
            "(pipeline_stages > 1): sequence parallelism within a stage is "
            "not ported yet (ROADMAP A12)"
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


def _write_drop(cols, pairs):
    """``cache_l[b, cols[b, j]] = vals[b, j]`` for every ``(cache_l,
    vals)`` pair, with columns past the capacity DROPPED, not clipped
    (clipping would pile them onto the last position and clobber a real
    token's K/V). cache_l ``[B, S, ...]`` (K/V or scales), cols ``[B, t]``,
    vals ``[B, t, ...]``; the indices are computed once for all pairs, and
    fp8 is written as bytes."""
    b, s = pairs[0][0].shape[:2]
    rows = torch.arange(b, device=cols.device)
    if cols.shape[1] == 1:
        # One column per row: a dropped write rewrites the value already
        # at the clamped column, which keeps the step free of host syncs.
        c = cols[:, 0]
        keep = c < s
        cc = c.clamp(max=s - 1)
        for cache_l, vals in pairs:
            cache_l, vals = byte_view(cache_l), byte_view(vals)
            k = keep.view(b, *([1] * (vals.dim() - 2)))
            cache_l[rows, cc] = torch.where(k, vals[:, 0], cache_l[rows, cc])
        return
    keep = cols < s
    r, c = rows[:, None].expand_as(cols)[keep], cols[keep]
    for cache_l, vals in pairs:
        byte_view(cache_l)[r, c] = byte_view(vals)[keep]


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPTConfig, policy: Policy, device):
        super().__init__()
        self.cfg, self.dtype = cfg, policy.compute_dtype
        d, pd = cfg.hidden_dim, policy.param_dtype
        self.query = nn.Linear(d, d, device=device, dtype=pd)
        self.key = nn.Linear(d, d, device=device, dtype=pd)
        self.value = nn.Linear(d, d, device=device, dtype=pd)
        self.out = nn.Linear(d, d, device=device, dtype=pd)
        self.tp = None  # collective-matmul hooks (GPT.attach)

    def _dense(self, lin: nn.Linear, x):
        return F.linear(
            x.to(self.dtype), lin.weight.to(self.dtype),
            lin.bias.to(self.dtype),
        )

    def _train(self, x):
        """The training / eval forward, causal over this call's tokens;
        under tensor parallelism (a current mesh with ``model > 1``) over
        this rank's heads: column-parallel q / k / v, row-parallel
        ``out``, by the Megatron pair or, with ``tp`` hooks, on the
        collective-matmul rings over this rank's tokens."""
        cfg = self.cfg
        b, t, d = x.shape
        hd = d // cfg.num_heads
        h = self.query.weight.shape[0] // hd  # this rank's heads
        if self.tp is not None:
            # The collective-matmul rings: x is this rank's tokens; q / k /
            # v come out over every token, for this rank's heads.
            q, k, v = (y.view(b, -1, h, hd) for y in self.tp.qkv(
                x.to(self.dtype), (self.query, self.key, self.value),
                self.dtype))
            y = _TRAIN_ATTENTION[cfg.attention](q, k, v, causal=True)
            return self.tp.row(y.reshape(b, -1, h * hd),
                               self.out.weight.to(self.dtype),
                               self.out.bias.to(self.dtype))
        if model_shard()[1] > 1:
            x = copy_to_model(x)
        q, k, v = (self._dense(lin, x).view(b, t, h, hd)
                   for lin in (self.query, self.key, self.value))
        y = _TRAIN_ATTENTION[cfg.attention](q, k, v, causal=True)
        if model_shard()[1] > 1:
            return _row_parallel(self.out, y.reshape(b, t, h * hd),
                                 self.dtype)
        return self._dense(self.out, y.reshape(b, t, d))

    def forward(self, x, cache: dict | None, layer: int, lens):
        if cache is None:
            return self._train(x)
        cfg = self.cfg
        b, t, d = x.shape
        hd = d // cfg.num_heads
        # This rank's heads, from its weights: under tensor-parallel
        # serving q / k / v are column-parallel and ``out`` row-parallel
        # (``shard_params_for_serving``); whole weights attend every head.
        h = self.query.weight.shape[0] // hd
        tp = h < cfg.num_heads
        q = self._dense(self.query, x).view(b, t, h, hd)
        k_w = self._dense(self.key, x).view(b, t, h, hd)
        v_w = self._dense(self.value, x).view(b, t, h, hd)
        if "key_pool" in cache:
            y = self._paged(q, k_w, v_w, cache, layer)
            return self._out(y.reshape(b, t, h * hd), tp)
        ck = cache["cached_key"][layer]  # [B, S, H, hd] view
        cv = cache["cached_value"][layer]
        ks = vs = None
        if "key_scale" in cache:
            ks = cache["key_scale"][layer]  # [B, S, H] view
            vs = cache["value_scale"][layer]
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
        _write_drop(write_cols, self._to_store(ck, cv, ks, vs, k_w, v_w))
        if t == 1:
            y = decode_attention(
                q[:, 0], ck, cv, idx + 1, k_scale=ks, v_scale=vs,
                impl=cfg.decode_attention,
            )[:, None]
        else:
            # Query column j sits at absolute position idx + j - pad
            # (pad columns clip to 0: never read, but kept finite).
            qpos = (idx[:, None] + ar[None, :] - pad[:, None]).clamp(min=0)
            kpos = torch.arange(s, device=x.device)
            mask = kpos[None, None, :] <= qpos[:, :, None]  # [B, t, S]
            if ks is not None:
                # Prefill attends over the bucket dequantized to the
                # compute dtype, as the reference does.
                ck = dequantize(ck, ks[..., None], self.dtype)
                cv = dequantize(cv, vs[..., None], self.dtype)
            y = _masked_dense_attention(q, ck, cv, mask)
        idx.add_(lens)
        return self._out(y.reshape(b, t, h * hd), tp)

    def _out(self, y, tp: bool):
        """The output projection of decode mode: row-parallel over
        ``model`` (one all-reduce of the partial sums) when this rank
        holds a slice of the heads."""
        if tp:
            return _row_parallel(self.out, y, self.dtype)
        return self._dense(self.out, y)

    def _to_store(self, kc, vc, ks, vs, k_w, v_w):
        """``(leaf, values)`` pairs to write: K/V as they are, or, with
        scale leaves, quantized once (K and V in one call, each token over
        its own head vector) into payloads plus bf16 scales."""
        if ks is None:
            return [(kc, k_w), (vc, v_w)]
        q, s = quantize_kv(torch.stack((k_w, v_w)), self.cfg.kv_cache_quant)
        return [(kc, q[0]), (vc, q[1]), (ks, s[0]), (vs, s[1])]

    def _paged(self, q, k_w, v_w, cache: dict, layer: int):
        """The paged branch: column j of row b writes logical position
        ``idx + j``, i.e. pool block ``tbl[(idx + j) // bs]`` at offset
        ``(idx + j) % bs``. A column past the table (a retired row's
        cursor, or verify-tile padding at the end of the context) goes to
        the trash block 0 instead: dropped, where the JAX model clamps it
        onto the row's last table column. Then t == 1 attends through
        ``paged_decode_attention`` at occupancy ``idx + 1``, t > 1 through
        ``paged_verify_attention`` at ``idx + t``."""
        b, t = q.shape[:2]
        kp = cache["key_pool"][layer]  # [N, bs, H, hd] view
        vp = cache["value_pool"][layer]
        ks = vs = None
        if "key_pool_scale" in cache:
            ks = cache["key_pool_scale"][layer]  # [N, bs, H] view
            vs = cache["value_pool_scale"][layer]
        tbl = cache["block_tables"]  # [B, M] int32
        idx = cache["cache_index"][layer]  # [B] view, advanced last
        bs, m_tbl = kp.shape[1], tbl.shape[1]
        offs = idx[:, None].long() + torch.arange(t, device=q.device)
        col = offs // bs
        phys = torch.gather(tbl, 1, col.clamp(max=m_tbl - 1)).long()
        phys = torch.where(col < m_tbl, phys, torch.zeros_like(phys))
        off = offs % bs
        # Active rows never collide; duplicates land only in block 0.
        for pool, vals in self._to_store(kp, vp, ks, vs, k_w, v_w):
            byte_view(pool)[phys, off] = byte_view(vals)
        kw = dict(k_scale=ks, v_scale=vs, impl=self.cfg.decode_attention)
        if t == 1:
            y = paged_decode_attention(q[:, 0], kp, vp, idx + 1, tbl,
                                       **kw)[:, None]
        else:
            y = paged_verify_attention(q, kp, vp, idx + t, tbl, **kw)
        idx.add_(t)
        return y


class GptMlp(nn.Module):
    def __init__(self, cfg: GPTConfig, policy: Policy, device):
        super().__init__()
        self.dtype = policy.compute_dtype
        d, pd = cfg.hidden_dim, policy.param_dtype
        self.fc_in = nn.Linear(d, d * cfg.mlp_ratio, device=device, dtype=pd)
        self.fc_out = nn.Linear(d * cfg.mlp_ratio, d, device=device, dtype=pd)
        self.width = d * cfg.mlp_ratio
        self.tp = None  # collective-matmul hooks (GPT.attach)

    def forward(self, x):
        """Under tensor parallelism ``fc_in`` is column-parallel and
        ``fc_out`` row-parallel (``CausalSelfAttention._train``): this
        rank holds a slice of ``fc_in``'s outputs (the training step's
        compute spec, or ``shard_params_for_serving``)."""
        cd = self.dtype
        if self.tp is not None:
            y = self.tp.column(x.to(cd), self.fc_in.weight.to(cd),
                               self.fc_in.bias.to(cd))
            return self.tp.row(F.gelu(y, approximate="tanh"),
                               self.fc_out.weight.to(cd),
                               self.fc_out.bias.to(cd))
        tp = self.fc_in.weight.shape[0] < self.width
        if tp:
            x = copy_to_model(x)
        y = F.linear(x.to(cd), self.fc_in.weight.to(cd), self.fc_in.bias.to(cd))
        y = F.gelu(y, approximate="tanh")
        if tp:
            return _row_parallel(self.fc_out, y, cd)
        return F.linear(y, self.fc_out.weight.to(cd), self.fc_out.bias.to(cd))


def _layer_norm(ln: nn.LayerNorm, x):
    """LayerNorm in fp32 whatever the stream's dtype (flax
    ``LayerNorm(dtype=float32)``)."""
    return F.layer_norm(
        x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(),
        ln.eps,
    )


def _residual(x, out):
    """``x`` plus a sublayer's output; an MoE sublayer's ``(y, aux)``
    gives ``(x + y, aux)``."""
    if isinstance(out, tuple):
        return x + out[0], out[1]
    return x + out


class Block(nn.Module):
    def __init__(self, cfg: GPTConfig, policy: Policy, device):
        super().__init__()
        d, pd, eps = cfg.hidden_dim, policy.param_dtype, cfg.layer_norm_epsilon
        self.ln1 = nn.LayerNorm(d, eps=eps, device=device, dtype=pd)
        self.attn = CausalSelfAttention(cfg, policy, device)
        self.ln2 = nn.LayerNorm(d, eps=eps, device=device, dtype=pd)
        if cfg.moe.num_experts > 0:
            self.moe = MoEMlp(cfg, policy, device)
        else:
            self.mlp = GptMlp(cfg, policy, device)
        self.is_moe = cfg.moe.num_experts > 0
        self.rate = cfg.dropout

    def _stream_dim(self):
        """The dim of the stream split over ``model`` (the rings' tokens),
        or None."""
        return None if self.attn.tp is None else self.attn.tp.chunk_axis

    def attn_sublayer(self, x, layer: int, seed: int | None):
        """The training forward's attention sublayer, its dropout after
        the output projection (site 0 of ``layer``)."""
        y = self.attn(_layer_norm(self.ln1, x), None, layer, None)
        return dropout(y, self.rate, seed, layer, 0,
                       model_dim=self._stream_dim(), seq_dim=1)

    def mlp_sublayer(self, x, layer: int, seed: int | None, train: bool):
        """The MLP sublayer, its dropout after ``fc_out`` (site 1); the
        MoE MLP's ``(y, aux)`` (no dropout, as in the reference)."""
        if self.is_moe:
            return self.moe(_layer_norm(self.ln2, x), train=train,
                            sharded_rows=True)
        return dropout(self.mlp(_layer_norm(self.ln2, x)), self.rate, seed,
                       layer, 1, model_dim=self._stream_dim(), seq_dim=1)

    def forward(self, x, cache: dict | None, layer: int, lens,
                seed: int | None = None, part: str = "block",
                train: bool = False):
        """The block over ``x`` (an MoE block returns ``(x, aux)``); in
        training, ``part`` ``attn`` or ``mlp`` returns that sublayer's
        output alone (``GPT._block_train`` checkpoints them apart)."""
        if cache is not None:
            x = x + self.attn(_layer_norm(self.ln1, x), cache, layer, lens)
            if self.is_moe:
                return _residual(x, self.moe(_layer_norm(self.ln2, x),
                                             train=False))
            return x + self.mlp(_layer_norm(self.ln2, x))
        if part == "attn":
            return self.attn_sublayer(x, layer, seed)
        if part == "mlp":
            return self.mlp_sublayer(x, layer, seed, train)
        x = x + self.attn_sublayer(x, layer, seed)
        return _residual(x, self.mlp_sublayer(x, layer, seed, train))


class GPT(nn.Module):
    """GPT-2 LM, in training/eval mode (no cache) or decode mode.
    ``device=None`` means ``cuda`` and raises without a card. Weights
    come from ``models/convert.py`` (``params_from_jax`` or the seeded
    ``init_params``) through ``load_state_dict``; the training step runs
    the forward over its own compute-dtype parameters with
    ``torch.func.functional_call``."""

    # The parameters the forward reads whole under tensor parallelism.
    TP_COMPUTE_WHOLE = TP_COMPUTE_WHOLE

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

        # The overlap schedule's hooks (``attach``): the training and eval
        # forward read them, decode does not.
        self.param_hooks = None
        self.tp_overlap = None

    def attach(self, *, param_hooks=None, tp_overlap=None) -> None:
        """Hook the training / eval forward to the overlap schedule
        (``parallel/schedule.py`` ``hooked_model``): ``param_hooks``, the
        blockwise FSDP gathers (``parallel/fsdp_overlap.py``
        ``BlockGather``); ``tp_overlap``, the collective-matmul rings
        (``parallel/tp_overlap.py`` ``TpHooks``), the residual stream
        sharded over ``model`` along the tokens between them."""
        self.param_hooks, self.tp_overlap = param_hooks, tp_overlap
        for block in self.blocks:
            block.attn.tp = tp_overlap
            if not block.is_moe:  # the rings refuse MoE (tp_overlap.py)
                block.mlp.tp = tp_overlap

    @property
    def device(self) -> torch.device:
        return self.wpe.device

    def local_heads(self) -> int:
        """The attention heads this rank holds: all of them, or its slice
        when ``shard_params_for_serving`` split q / k / v over
        ``model``."""
        cfg = self.config
        return (self.blocks[0].attn.query.weight.shape[0]
                // (cfg.hidden_dim // cfg.num_heads))

    def cache_rows(self, batch: int) -> int:
        """This rank's rows of a ``batch``-row contiguous cache. With the
        heads split over ``model`` the rows split over the batch axes of
        the current mesh when they divide, as the JAX model pins the
        cache (``_constrain_kv_cache``); else every rank holds every
        row. An MoE model refuses the split: its heads split only under
        ``model > 1``, where MoE is not ported yet."""
        env = current_mesh_env()
        if env is None or self.local_heads() == self.config.num_heads:
            return batch
        if self.config.moe.num_experts > 0:
            raise NotImplementedError(
                "an MoE model's cache split over the batch axes (heads "
                "split over model): MoE under tensor parallelism is not "
                "ported yet (ROADMAP A12)")
        n = env.batch_axis_size
        return batch // n if batch % n == 0 else batch

    def _kv_leaves(self, scale_of: dict, shape) -> dict:
        """The K/V leaves named by ``scale_of``'s keys, ``[*shape, hd]``
        in the compute dtype; under a quantized cache 1-byte payloads,
        plus the bf16 scale leaves ``shape`` named by its values."""
        cfg, dev = self.config, self.device
        kv = (*shape, cfg.hidden_dim // cfg.num_heads)
        quant = cfg.kv_cache_quant != "none"
        dt = lowp_dtype(cfg.kv_cache_quant) if quant else self.policy.compute_dtype
        out = {name: zeros(kv, dt, dev) for name in scale_of}
        if quant:
            out.update({
                name: torch.zeros(shape, dtype=torch.bfloat16, device=dev)
                for name in scale_of.values()
            })
        return out

    def init_cache(self, batch: int, cache_len: int) -> dict:
        """An empty decode cache of capacity ``cache_len`` for ``batch``
        rows, over this rank's heads and rows (``cache_rows``)."""
        cfg = self.config
        dev = self.device
        batch = self.cache_rows(batch)
        return {
            **self._kv_leaves(
                {"cached_key": "key_scale", "cached_value": "value_scale"},
                (cfg.num_layers, batch, cache_len, self.local_heads()),
            ),
            "cache_index": torch.zeros(
                (cfg.num_layers, batch), dtype=torch.int32, device=dev
            ),
            "pos_index": torch.zeros((batch,), dtype=torch.int32, device=dev),
        }

    def init_paged_cache(
        self, num_slots: int, block_size: int, pool_blocks: int
    ) -> dict:
        """An empty paged decode cache: a pool of ``pool_blocks`` blocks of
        ``block_size`` positions per layer over this rank's heads, and
        all-zero tables (every row pointing at the trash block 0). The
        pool is shared by every row, so it is whole on every rank of a
        batch group, as the JAX model keeps it (``_constrain_kv_pool``),
        and every rank computes every row."""
        cfg = self.config
        dev = self.device
        m_blocks = -(-cfg.seq_len // block_size)
        return {
            **self._kv_leaves(
                {"key_pool": "key_pool_scale",
                 "value_pool": "value_pool_scale"},
                (cfg.num_layers, pool_blocks, block_size, self.local_heads()),
            ),
            "block_tables": torch.zeros(
                (num_slots, m_blocks), dtype=torch.int32, device=dev
            ),
            "cache_index": torch.zeros(
                (cfg.num_layers, num_slots), dtype=torch.int32, device=dev
            ),
            "pos_index": torch.zeros(
                (num_slots,), dtype=torch.int32, device=dev
            ),
        }

    def forward(self, tokens, cache: dict | None = None, lengths=None, *,
                train: bool = False, rng: int | None = None,
                return_features: bool = False):
        """With no ``cache``: the training/eval forward of tokens
        ``[B, t]`` (t <= seq_len), logits ``[B, t, vocab]`` in the compute
        dtype, or with ``return_features`` the ``ln_f`` output ``[B, t,
        d]`` cast to the compute dtype. With ``train`` and
        ``model.dropout > 0``, dropout after the embedding and after each
        block's attention output projection and ``fc_out``, its masks
        seeded by ``rng`` (an int: ``models/dropout.py``). Under
        ``model.block_remat`` each block is checkpointed on its own.

        With a ``cache``: tokens ``[B, t]`` (LEFT-padded when ``lengths
        [B]`` is given) against ``cache``, which advances in place by each
        row's length. Returns logits ``[B, t, vocab]`` in the compute
        dtype. An MoE model returns ``(output, aux)`` in every mode, aux
        the fp32 sum of its blocks' auxiliary losses."""
        if cache is None:
            if lengths is not None:
                raise ValueError(
                    "lengths (ragged left-padded prompts) is a decode-mode "
                    "argument; training/eval batches are dense"
                )
            seed = check_seed(self.config.dropout, train, rng)
            if self.config.pipeline_stages > 1:
                return self._forward_pipelined(tokens, seed,
                                               return_features, train)
            return self._forward_train(tokens, seed, return_features, train)
        if self.config.pipeline_stages > 1:
            raise NotImplementedError(
                "KV-cache decoding runs on the plain layer stack (pipeline "
                "parallelism is a training-throughput schedule). "
                "models.generation.generate/beam_search restack pipeline "
                "params automatically (unstack_pipeline_params); only a "
                "direct apply(decode=True) needs pipeline_stages=1"
            )
        cfg, cd = self.config, self.policy.compute_dtype
        b, t = tokens.shape
        if "key_pool" in cache and t > 1 and lengths is not None:
            raise NotImplementedError(
                "paged multi-token decode is the dense verify tile "
                "(speculative decoding): ragged lengths do not apply; "
                "prefill stays contiguous and the engine grafts it "
                "block-wise into the pool"
            )
        lens = (
            torch.full((b,), t, dtype=torch.int32, device=tokens.device)
            if lengths is None
            else lengths.to(device=tokens.device, dtype=torch.int32)
        )
        rows = cache["pos_index"].shape[0]
        if rows != b:
            # A cache split over the batch axes (``cache_rows``): this
            # rank decodes its rows, and every rank gets every row's
            # logits.
            env = current_mesh_env()
            n = 1 if env is None else env.batch_axis_size
            if rows * n != b:
                raise ValueError(
                    f"cache holds {rows} rows for a batch of {b} over "
                    f"{n} batch shards")
            lo = env.batch_index * rows
            logits = self.forward(tokens[lo:lo + rows], cache,
                                  lens[lo:lo + rows])
            return all_gather(logits, BATCH_AXES, env=env)
        # Absolute positions per row; left-pad columns clip to 0 (their
        # lanes are masked out and never read).
        pos = cache["pos_index"]
        ar = torch.arange(t, device=tokens.device)
        pos_ids = (pos[:, None] + ar[None, :] - (t - lens)[:, None]).clamp(
            0, cfg.seq_len - 1
        )
        x = self.wte.weight[tokens].to(cd) + self.wpe[pos_ids].to(cd)
        pos.add_(lens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer, block in enumerate(self.blocks):
            x, aux = self._carry(block(x, cache, layer, lens), aux)
        x = _layer_norm(self.ln_f, x)
        logits = F.linear(x.to(cd), self.wte.weight.to(cd))  # tied head
        return (logits, aux) if cfg.moe.num_experts > 0 else logits

    @staticmethod
    def _carry(out, aux):
        """(stream, aux so far) after a block: an MoE block's ``(x,
        aux)`` adds its auxiliary loss."""
        if isinstance(out, tuple):
            return out[0], aux + out[1]
        return out, aux

    def _positions(self, t: int) -> int:
        """The first position of this rank's ``t`` tokens: ``r t`` under
        ``seq`` ranks, which only the sequence-parallel attention modes
        take (each other mode attends over its own tokens alone)."""
        r, n = seq_shard()
        if n == 1:
            return 0
        if self.config.attention not in _SEQ_ATTENTION:
            raise NotImplementedError(
                f"mesh.seq={n} with model.attention="
                f"{self.config.attention!r}: the port splits the tokens "
                "over seq for ring and ulysses attention only (ROADMAP A12)")
        if n * t > self.config.seq_len:
            raise ValueError(f"{n} x {t} tokens exceed seq_len "
                             f"{self.config.seq_len}")
        return r * t

    def _forward_train(self, tokens, seed: int | None,
                       return_features: bool, train: bool = False):
        cfg, cd = self.config, self.policy.compute_dtype
        t = tokens.shape[1]
        x = F.embedding(tokens, self.wte.weight).to(cd)
        p0 = self._positions(t)
        x = x + self.wpe[p0:p0 + t].to(cd)
        # The embedding's site sits after every block's: (L, 0).
        x = dropout(x, cfg.dropout, seed, cfg.num_layers, 0, seq_dim=1)
        tp, hooks = self.tp_overlap, self.param_hooks
        if tp is not None:
            x = tp.scatter(x)
        if hooks is not None:
            hooks.start((f"blocks.{i}.", dict(b.named_parameters()))
                        for i, b in enumerate(self.blocks))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer, block in enumerate(self.blocks):
            if hooks is not None:
                out = self._block_gathered(block, x, layer, seed, train)
            else:
                out = self._block_train(block, x, layer, seed, train)
            x, aux = self._carry(out, aux)
        if tp is not None:
            x = tp.gather(x)
        x = _layer_norm(self.ln_f, x).to(cd)
        if not return_features:
            x = F.linear(x, self.wte.weight.to(cd))  # weight-tied head
        return (x, aux) if cfg.moe.num_experts > 0 else x

    def pipeline_block(self, i: int) -> Block:
        """Block ``i`` (a global layer index)."""
        return self.blocks[i]

    def _forward_pipelined(self, tokens, seed: int | None,
                           return_features: bool, train: bool):
        """The pipelined forward (``pipeline_stages > 1``) in one process:
        the batch splits into the M microbatches, each runs the embedding
        and every layer in order (what every schedule computes for it:
        the circular one too visits the layer groups in order), microbatch
        m's dropout with seed ``mix_seed(seed, m)``, and the MoE aux is
        the sum over the microbatches divided by M, as the JAX model's.
        The Trainer runs the schedule itself (``parallel/pipeline.py``,
        with ``trainer.remat`` and ``pipeline_stage_remat``);
        ``model.block_remat`` does not apply inside a pipeline, as in the
        reference."""
        from frl_distributed_ml_scaffold_tpu_torch.models.dropout import (
            mix_seed,
        )
        from frl_distributed_ml_scaffold_tpu_torch.parallel.pipeline import (
            check_schedule,
            effective_microbatches,
            embed,
            final_norm,
            run_layers,
        )

        cfg, cd = self.config, self.policy.compute_dtype
        check_schedule(cfg, tokens.shape[0])
        m = effective_microbatches(cfg)
        params = dict(self.named_parameters())
        outs, aux = [], None
        for i, chunk in enumerate(tokens.chunk(m)):
            s = None if seed is None else mix_seed(seed, i)
            x = embed(params, chunk, cfg, self.policy, s)
            x, a = run_layers(self, range(cfg.num_layers), x, s, train)
            outs.append(x)
            if a is not None:
                aux = a.float() if aux is None else aux + a.float()
        x = final_norm(params, torch.cat(outs), cfg).to(cd)
        if not return_features:
            x = F.linear(x, self.wte.weight.to(cd))  # weight-tied head
        if cfg.moe.num_experts > 0:
            zero = torch.zeros((), dtype=torch.float32, device=x.device)
            return x, (zero if aux is None else aux / m)
        return x

    def _block_train(self, block: Block, x, layer: int, seed: int | None,
                     train: bool = False):
        """One block of the training forward under ``model.block_remat``:
        ``none``; ``full``, the block under ``torch.utils.checkpoint``
        (non-reentrant), only its input kept, everything in it
        recomputed in the backward; ``save_attn``, the attention and MLP
        sublayers each checkpointed, so their inputs, the block's input
        and ``x + attn_out``, are kept: the attention sublayer's output
        is saved as JAX's ``save_only_these_names("attn_out")`` saves it,
        and the MLP's recompute does not rerun the attention. The
        attention's own backward still needs its internals, which both
        modes recompute (the flash forward included). Dropout masks are
        drawn at their sites, so a recompute draws the same ones.

        The recompute runs in the backward, after the train step's
        ``functional_call`` has put the module's own parameters back, so
        the block's parameters as this forward sees them are handed to
        the checkpoint and swapped in again around the recompute."""
        mode = self.config.block_remat
        if mode == "none" or not torch.is_grad_enabled():
            return block(x, None, layer, None, seed, train=train)
        names, tensors = zip(*block.named_parameters())

        def run(x, part, *tensors):
            return functional_call(block, dict(zip(names, tensors)),
                                   (x, None, layer, None, seed),
                                   {"part": part, "train": train})

        if mode == "full":
            return checkpoint(run, x, "block", *tensors, use_reentrant=False)
        x = x + checkpoint(run, x, "attn", *tensors, use_reentrant=False)
        return _residual(x, checkpoint(run, x, "mlp", *tensors,
                                       use_reentrant=False))

    def _block_gathered(self, block: Block, x, layer: int, seed: int | None,
                        train: bool = False):
        """One block under the blockwise FSDP gathers (``param_hooks``):
        its shards gathered whole for its compute, ``prefetch`` blocks
        ahead. Under ``block_remat=none`` every activation is saved but
        the gathered parameters, which the backward gathers again;
        ``full`` and ``save_attn`` checkpoint as ``_block_train`` does,
        with the gather inside, so the recompute gathers again."""
        hooks = self.param_hooks
        hooks.begin(layer)
        names, shards = zip(*block.named_parameters())
        parts = {"block": None,
                 "attn": {n for n in names if n.startswith(("ln1.", "attn."))},
                 "mlp": {n for n in names
                         if n.startswith(("ln2.", "mlp.", "moe."))}}

        def run(x, part, *shards):
            params = hooks.params(layer, dict(zip(names, shards)),
                                  parts[part])
            return functional_call(block, params,
                                   (x, None, layer, None, seed),
                                   {"part": part, "train": train})

        mode = self.config.block_remat
        if not torch.is_grad_enabled():
            return run(x, "block", *shards)
        if mode == "none":
            with hooks.no_save():
                return run(x, "block", *shards)
        if mode == "full":
            return checkpoint(run, x, "block", *shards, use_reentrant=False)
        x = x + checkpoint(run, x, "attn", *shards, use_reentrant=False)
        return _residual(x, checkpoint(run, x, "mlp", *shards,
                                       use_reentrant=False))


class GptStage(nn.Module):
    """The layers one ``pipe`` rank holds of a pipelined GPT (the JAX
    package's ``GptStage``): stage j's blocks (``parallel/pipeline.py``
    ``stage_layers``: its contiguous run under GPipe and MPMD, its ``v``
    layer groups under the circular schedule), with the plain GPT's
    names and global layer indices (``blocks.<i>.``), so a stage's state
    dict is a slice of the plain one. ``embed`` holds the embedding
    (``wte``, ``wpe``), ``final`` the final LayerNorm: the SPMD backend's
    ranks hold both (the JAX rules replicate them over ``pipe``), the
    MPMD backend's first stage the embedding and its last ``ln_f``; the
    weight-tied head reads ``wte``, which the MPMD last stage receives as
    a mirror each step. ``forward`` is the stage program: the embedding
    front on stage 0, the stage's layers, ``ln_f`` on the last stage,
    features out, no head."""

    def __init__(self, config: GPTConfig, policy: Policy, stage: int, *,
                 embed: bool = True, final: bool = True, device=None):
        super().__init__()
        _check_supported(config)
        from frl_distributed_ml_scaffold_tpu_torch.parallel.pipeline import (
            check_schedule,
            stage_layers,
        )

        check_schedule(config)
        device = resolve_device(device)
        self.config, self.policy, self.stage = config, policy, stage
        cfg, pd = config, policy.param_dtype
        self.layers = stage_layers(cfg, stage)
        if embed:
            self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_dim,
                                    device=device, dtype=pd)
            self.wpe = nn.Parameter(torch.zeros(
                cfg.seq_len, cfg.hidden_dim, device=device, dtype=pd))
        self.blocks = nn.ModuleDict(
            {str(i): Block(cfg, policy, device) for i in self.layers})
        if final:
            self.ln_f = nn.LayerNorm(cfg.hidden_dim,
                                     eps=cfg.layer_norm_epsilon,
                                     device=device, dtype=pd)

    def pipeline_block(self, i: int) -> Block:
        return self.blocks[str(i)]

    def forward(self, x, *, train: bool = False, rng: int | None = None):
        from frl_distributed_ml_scaffold_tpu_torch.parallel.pipeline import (
            embed,
            final_norm,
            run_layers,
        )

        cfg = self.config
        seed = check_seed(cfg.dropout, train, rng)
        params = dict(self.named_parameters())
        if self.stage == 0:
            x = embed(params, x, cfg, self.policy, seed)
        x, _ = run_layers(self, self.layers, x, seed, train)
        if self.stage == cfg.pipeline_stages - 1:
            x = final_norm(params, x, cfg)
        return x


def mpmd_stage_params(cfg: GPTConfig, params: dict, num_stages: int) -> dict:
    """A plain state dict sliced into the MPMD backend's per-stage dicts
    (the JAX ``mpmd_stage_params`` on the port's names): ``{"stage_j":
    ...}``, stage j owning its layers ``blocks.<i>.`` for i in ``[j L/S,
    (j+1) L/S)``, the first stage also everything outside the block stack
    but ``ln_f`` (the embedding, and with it the tied head's master
    copy), the last stage ``ln_f``. Inverse: ``mpmd_merge_params``."""
    if "stage_0" in params:
        raise ValueError(
            "mpmd_stage_params expects the PLAIN-layout params tree "
            "(blocks leaves [L, ...]); restack pipeline-trained params "
            "via unstack_pipeline_params first"
        )
    L, s = cfg.num_layers, num_stages
    if s < 2:
        raise ValueError(f"MPMD stage slicing needs >= 2 stages, got {s}")
    if L % s:
        raise ValueError(f"{L} layers not divisible by {s} stages")
    lps = L // s
    out: dict = {f"stage_{j}": {} for j in range(s)}
    for k, v in params.items():
        if k.startswith("blocks."):
            j = int(k.split(".")[1]) // lps
        elif k.startswith("ln_f."):
            j = s - 1
        else:
            j = 0
        out[f"stage_{j}"][k] = v
    return out


def mpmd_merge_params(cfg: GPTConfig, stage_params: dict) -> dict:
    """The per-stage dicts merged back into the plain state dict."""
    stages = sorted(
        (k for k in stage_params if k.startswith("stage_")),
        key=lambda k: int(k.split("_", 1)[1]),
    )
    if len(stages) < 2 or stages != [f"stage_{j}" for j in range(len(stages))]:
        raise ValueError(
            f"not an MPMD stage-params tree (keys: {sorted(stage_params)})"
        )
    out: dict = {}
    for k in stages:
        out.update(stage_params[k])
    return out


def unstack_pipeline_params(cfg: GPTConfig, params: dict) -> dict:
    """Pipeline-trained params as the plain state dict a
    ``pipeline_stages=1`` model of the same config loads: the port keeps
    the plain names under every backend, so a plain dict is returned as
    it is and the MPMD per-stage dicts are merged; restacking is a
    gather, never a reshape of the model."""
    if "stage_0" in params:
        return mpmd_merge_params(cfg, params)
    return params
