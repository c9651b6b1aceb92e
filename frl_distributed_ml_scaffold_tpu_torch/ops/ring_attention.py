"""Dense training attention: the port of ``dense_attention`` from the
JAX package's ``ops/ring_attention.py``, the plain attention of
``model.attention=dense`` and the numerics every attention mode reduces
to. Ring hops (the rest of that module) come with ROADMAP A12.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1.0e30


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """(B, T, H, D) dense attention. The products take the input dtype's
    values with an fp32 accumulator (operands upcast, fp32 matmul), the
    softmax runs in fp32, and the probabilities are cast to q's dtype
    before the PV product; masked scores take -1e30."""
    t, d = q.shape[1], q.shape[3]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * (1.0 / math.sqrt(d))
    if causal:
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)
