"""ViT-B/16 (BASELINE config 3: ImageNet, FSDP and full remat): the port
of the JAX package's ``models/vit.py``.

Pre-LN encoder blocks over patch tokens, learned position embeddings,
``cls`` or ``mean`` pooling and a Dense head; ``models/video.py`` reuses
``EncoderBlock`` and the classifier tail (``TokenClassifier``).

Numerics follow flax's modules under the policy:

- the patch embedding, a convolution whose stride equals its kernel, is
  computed as what it is: the non-overlapping patches flattened in
  ``(ph, pw, c)`` order (``patchify``), then one product with the
  kernel flattened the same way, in the compute dtype. The patches of an
  NHWC image come out row-major over the patch grid, the order of flax's
  ``reshape(b, h * w, c)`` of the convolution's output;
- the cls token is prepended before the position embedding is added;
- every LayerNorm runs in fp32 with epsilon 1e-6 (flax
  ``LayerNorm(dtype=float32)``); the residual stream stays in the
  compute dtype;
- attention is written out as flax's ``dot_product_attention``: q
  divided by sqrt(head_dim) in the compute dtype, the scores a product
  in the compute dtype, the softmax over those scores rounded to the
  compute dtype (flax's ``force_fp32_for_softmax=False``), then the
  weighted sum of v. ``scaled_dot_product_attention`` scales and
  normalises in other places, so it is not used;
- the MLP's GELU is the tanh form (flax ``nn.gelu``'s default);
- the head runs in the compute dtype and the logits are cast to the
  policy's ``output_dtype``.

The q, k, v and out projections are separate ``nn.Linear``s named as
flax names them (``query``, ``key``, ``value``, ``out``), over the heads
flattened: flax's ``(D, heads, head_dim)`` kernels become ``[heads *
head_dim, D]`` weights (``models/convert.py``).

Training dropout (``model.dropout``, ``models/dropout.py``) sits where
flax puts it: after the position embedding, on the attention
probabilities (flax's ``dropout_rate``: the probabilities times ``keep /
(1 - rate)`` in the compute dtype), after the MLP's GELU and after its
output projection.

Tensor parallelism (``vit_tp_rules``, a current mesh with ``model >
1``): each rank holds its heads of q / k / v (column-parallel) and
their rows of ``out`` (row-parallel), and its slice of ``fc_in``'s
outputs and ``fc_out``'s inputs; one all-reduce over ``model`` follows
``out`` and one ``fc_out``, before their biases
(``parallel/tensor_parallel.py``). With the collective-matmul hooks
(``tp_overlap``, ``parallel/tp_overlap.py``; ``attach``) the same
products run on the rings, and between them the residual stream is
split over ``model`` along the batch (the token count does not divide).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from frl_distributed_ml_scaffold_tpu_torch import resolve_device
from frl_distributed_ml_scaffold_tpu_torch.config.schema import ViTConfig
from frl_distributed_ml_scaffold_tpu_torch.models.dropout import (
    check_seed,
    dropout,
    keep_mask,
)
from frl_distributed_ml_scaffold_tpu_torch.models.gpt import (
    _layer_norm,
    _row_parallel,
)
from frl_distributed_ml_scaffold_tpu_torch.parallel.partition import (
    PartitionRules,
)
from frl_distributed_ml_scaffold_tpu_torch.parallel.tensor_parallel import (
    copy_to_model,
    model_shard,
)
from frl_distributed_ml_scaffold_tpu_torch.precision import Policy

LN_EPS = 1e-6  # flax LayerNorm's default


def vit_tp_rules() -> PartitionRules:
    """Megatron column / row splits over ``model`` for the encoder (the
    JAX package's ``vit_tp_rules``, also the video classifier's), against
    the port's names: the heads of q / k / v (the leading factor of their
    ``[heads * head_dim, D]`` weights) and of ``out``'s input, the outputs
    of ``fc_in`` and the inputs of ``fc_out``."""
    col, row = ("model", None), (None, "model")
    blk = r"^blocks\.\d+\."
    return PartitionRules(rules=(
        (blk + r"attn\.(query|key|value)\.weight$", col),
        (blk + r"attn\.(query|key|value)\.bias$", ("model",)),
        (blk + r"attn\.out\.weight$", row),
        (blk + r"mlp\.fc_in\.weight$", col),
        (blk + r"mlp\.fc_in\.bias$", ("model",)),
        (blk + r"mlp\.fc_out\.weight$", row),
    ))


def patchify(x: torch.Tensor, sizes: tuple[int, ...]) -> torch.Tensor:
    """``x`` [B, *dims, C] -> [B, prod(dims // sizes), prod(sizes) * C]:
    the non-overlapping patches of a ``VALID`` convolution whose stride is
    its kernel ``sizes`` (a remainder of a dim is dropped), row-major
    over the patch grid, each patch flattened in (``*sizes``, C) order."""
    b, *dims, c = x.shape
    grid = [d // s for d, s in zip(dims, sizes)]
    x = x[(slice(None),) + tuple(slice(0, g * s) for g, s in zip(grid, sizes))]
    x = x.reshape([b] + [v for gs in zip(grid, sizes) for v in gs] + [c])
    k = len(sizes)
    perm = [0, *range(1, 2 * k, 2), *range(2, 2 * k + 1, 2), 2 * k + 1]
    return x.permute(perm).reshape(b, math.prod(grid), math.prod(sizes) * c)


def _dense(lin: nn.Linear, x, cd):
    return F.linear(x.to(cd), lin.weight.to(cd), lin.bias.to(cd))


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` self-attention (no mask)."""

    def __init__(self, dim: int, num_heads: int, policy: Policy, device, *,
                 dropout: float = 0.0):
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"hidden_dim {dim} not divisible by num_heads "
                             f"{num_heads}")
        self.num_heads, self.dtype = num_heads, policy.compute_dtype
        self.rate = dropout
        pd = policy.param_dtype
        self.query, self.key, self.value, self.out = (
            nn.Linear(dim, dim, device=device, dtype=pd) for _ in range(4))
        self.tp = None  # collective-matmul hooks (TokenClassifier.attach)

    def forward(self, x, seed: int | None = None, layer: int = 0):
        cd = self.dtype
        b, n, d = x.shape
        hd = d // self.num_heads
        tp = model_shard()[1] > 1
        h = self.query.weight.shape[0] // hd  # this rank's heads
        if self.tp is not None:
            # The rings: x is this rank's rows; q / k / v come out over
            # every row of the batch shard, for this rank's heads.
            q, k, v = (y.view(-1, n, h, hd) for y in self.tp.qkv(
                x.to(cd), (self.query, self.key, self.value), cd))
        else:
            if tp:
                x = copy_to_model(x)
            q, k, v = (_dense(p, x, cd).view(b, n, h, hd)
                       for p in (self.query, self.key, self.value))
        q = q / torch.tensor(math.sqrt(hd), dtype=cd)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k)
        p = torch.softmax(s, dim=-1)
        if seed is not None and self.rate > 0.0:
            keep = keep_mask(p.shape, self.rate, seed, layer, 0,
                             device=p.device,
                             **({"model_dim": 1} if tp else {}))
            p = p * (keep.to(cd) / torch.tensor(1.0 - self.rate, dtype=cd))
        o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(-1, n, h * hd)
        if self.tp is not None:
            return self.tp.row(o, self.out.weight.to(cd),
                               self.out.bias.to(cd))
        if tp:
            return _row_parallel(self.out, o, cd)
        return _dense(self.out, o, cd)


class MlpBlock(nn.Module):
    def __init__(self, dim: int, mlp_ratio: int, policy: Policy, device, *,
                 dropout: float = 0.0):
        super().__init__()
        self.dtype, pd = policy.compute_dtype, policy.param_dtype
        self.rate = dropout
        self.fc_in = nn.Linear(dim, dim * mlp_ratio, device=device, dtype=pd)
        self.fc_out = nn.Linear(dim * mlp_ratio, dim, device=device, dtype=pd)
        self.tp = None  # collective-matmul hooks (TokenClassifier.attach)

    def forward(self, x, seed: int | None = None, layer: int = 0):
        cd = self.dtype
        if self.tp is not None:
            y = self.tp.column(x.to(cd), self.fc_in.weight.to(cd),
                               self.fc_in.bias.to(cd))
            y = F.gelu(y, approximate="tanh")
            y = dropout(y, self.rate, seed, layer, 1, model_dim=2)
            y = self.tp.row(y, self.fc_out.weight.to(cd),
                            self.fc_out.bias.to(cd))
            return dropout(y, self.rate, seed, layer, 2,
                           model_dim=self.tp.chunk_axis)
        tp = model_shard()[1] > 1
        if tp:
            x = copy_to_model(x)
        y = F.gelu(_dense(self.fc_in, x, self.dtype), approximate="tanh")
        y = dropout(y, self.rate, seed, layer, 1, model_dim=2)
        y = (_row_parallel(self.fc_out, y, self.dtype) if tp
             else _dense(self.fc_out, y, self.dtype))
        return dropout(y, self.rate, seed, layer, 2)


class EncoderBlock(nn.Module):
    """Pre-LN block: ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int,
                 policy: Policy, device, *, tp=None, dropout: float = 0.0):
        super().__init__()
        pd = policy.param_dtype
        self.ln1 = nn.LayerNorm(dim, eps=LN_EPS, device=device, dtype=pd)
        self.attn = MultiHeadAttention(dim, num_heads, policy, device,
                                       dropout=dropout)
        self.ln2 = nn.LayerNorm(dim, eps=LN_EPS, device=device, dtype=pd)
        self.mlp = MlpBlock(dim, mlp_ratio, policy, device, dropout=dropout)
        self.attn.tp = self.mlp.tp = tp

    def forward(self, x, seed: int | None = None, layer: int = 0):
        """``seed`` (None in eval) seeds this block's dropout sites, each
        named by ``(layer, site)``."""
        x = x + self.attn(_layer_norm(self.ln1, x), seed, layer)
        return x + self.mlp(_layer_norm(self.ln2, x), seed, layer)


class TokenClassifier(nn.Module):
    """What ViT and the video classifier share: a linear embedding of
    flattened patches, the position embedding, the encoder blocks, the
    final LayerNorm, pooling and the head. Subclasses give the patch
    sizes and whether a cls token leads."""

    def __init__(self, cfg, policy: Policy, *, patch_features: int,
                 tokens: int, cls_token: bool, device):
        super().__init__()
        dev = resolve_device(device)
        self.config, self.policy = cfg, policy
        d, pd = cfg.hidden_dim, policy.param_dtype
        self.embed = nn.Linear(patch_features, d, device=dev, dtype=pd)
        if cls_token:
            self.cls_token = nn.Parameter(
                torch.empty((1, 1, d), device=dev, dtype=pd))
        self.pos_embedding = nn.Parameter(torch.empty(
            (1, tokens + cls_token, d), device=dev, dtype=pd))
        self.blocks = nn.ModuleList(
            EncoderBlock(d, cfg.num_heads, cfg.mlp_ratio, policy, dev,
                         dropout=cfg.dropout)
            for _ in range(cfg.num_layers))
        self.ln = nn.LayerNorm(d, eps=LN_EPS, device=dev, dtype=pd)
        self.head = nn.Linear(d, cfg.num_classes, device=dev, dtype=pd)
        self.tp_overlap = None

    def attach(self, *, tp_overlap=None) -> None:
        """Hook the encoder to the collective-matmul rings
        (``parallel/tp_overlap.py`` ``TpHooks``, ``chunk_axis=0``): the
        residual stream split over ``model`` along the batch between
        them. Decode-free families: the forward always reads them."""
        self.tp_overlap = tp_overlap
        for block in self.blocks:
            block.attn.tp = block.mlp.tp = tp_overlap

    def classify(self, patches, *, pool: str, train: bool,
                 rng: int | None = None):
        """``patches`` [B, N, patch_features] -> logits [B, classes];
        ``rng`` seeds training dropout (``models/dropout.py``)."""
        seed = check_seed(self.config.dropout, train, rng)
        cd = self.policy.compute_dtype
        x = _dense(self.embed, patches, cd)
        if pool == "cls":
            cls = self.cls_token.to(cd).expand(x.shape[0], -1, -1)
            x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embedding.to(cd)
        # The embedding's site sits after every block's: (L, 0).
        x = dropout(x, self.config.dropout, seed, len(self.blocks), 0)
        tp = self.tp_overlap
        if tp is not None:
            x = tp.scatter(x)
        for layer, block in enumerate(self.blocks):
            x = block(x, seed, layer)
        if tp is not None:
            x = tp.gather(x)
        x = _layer_norm(self.ln, x)
        x = x[:, 0] if pool == "cls" else x.mean(dim=1)
        return _dense(self.head, x, cd).to(self.policy.output_dtype)


class ViT(TokenClassifier):
    """ViT over NHWC images of ``in_channels`` channels. Params in
    ``policy.param_dtype``, computed in ``policy.compute_dtype``.
    ``device=None`` means ``cuda`` and raises without a card. Weights are
    uninitialised: load them (``models/convert.py``)."""

    def __init__(self, config: ViTConfig, policy: Policy, *,
                 in_channels: int = 3, tp_overlap=None, device=None):
        if config.pool not in ("cls", "mean"):
            raise ValueError(f"unknown ViT pool {config.pool!r}; expected "
                             "'cls' or 'mean'")
        p = config.patch_size
        super().__init__(config, policy, patch_features=p * p * in_channels,
                         tokens=(config.image_size // p) ** 2,
                         cls_token=config.pool == "cls", device=device)
        self.attach(tp_overlap=tp_overlap)

    def forward(self, x, *, train: bool = False, rng: int | None = None):
        """``x`` [B, H, W, C] -> logits [B, classes]."""
        p = self.config.patch_size
        x = patchify(x.to(self.policy.compute_dtype), (p, p))
        return self.classify(x, pool=self.config.pool, train=train, rng=rng)
