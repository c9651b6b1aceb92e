"""Task losses: the port of the JAX package's ``trainer/tasks.py`` for
the LM task.

``make_lm_loss(model)`` returns the ``loss_fn(params, extras, batch,
rng, train) -> (loss, (metrics, extras))`` contract that
``train_step.py`` consumes. ``params`` is a dict of the model's
parameters by name (already in the compute dtype: the step casts them),
applied with ``torch.func.functional_call``; ``extras`` is ``{}`` for the
GPT (no BatchNorm statistics); ``rng`` is unused (training dropout is not
ported and raises in the model). The loss math runs in fp32 whatever the
compute dtype.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

_log = logging.getLogger(__name__)


def _chunk_ce(feats, emb, targets):
    """Summed next-token CE of one chunk: exactly the weight-tied head's
    math (a compute-dtype product, cast to fp32) with the fp32
    softmax-CE after it."""
    logits = (feats @ emb.T).float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long(), reduction="sum")


def make_lm_loss(model):
    """Next-token CE over ``batch["tokens"]`` ([B, L+1] int).

    With ``model.config.lm_loss_chunk > 0`` (dividing L) the weight-tied
    head and the CE run chunk by chunk over the sequence, each chunk
    under ``torch.utils.checkpoint``, so only ``[B, chunk, vocab]``
    logits ever exist (and are recomputed in the backward). A chunk that
    does not divide L falls back to the dense head, logged once.
    """
    chunk = int(getattr(getattr(model, "config", None), "lm_loss_chunk", 0)
                or 0)
    warned = []

    def chunked_ce(feats, emb, targets):
        b, t, _ = feats.shape
        n = t // chunk
        total = torch.zeros((), dtype=torch.float32, device=feats.device)
        for i in range(n):
            sl = slice(i * chunk, (i + 1) * chunk)
            total = total + checkpoint(_chunk_ce, feats[:, sl], emb,
                                       targets[:, sl], use_reentrant=False)
        return total / (b * t)

    def loss_fn(params, extras, batch, rng, train):
        del rng
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        use_chunks = chunk > 0 and inputs.shape[1] % chunk == 0
        if chunk > 0 and not use_chunks and not warned:
            _log.warning(
                "lm_loss_chunk=%d does not divide the sequence length %d: "
                "falling back to the dense [B, T, vocab] head (the memory "
                "saving is OFF)", chunk, inputs.shape[1],
            )
            warned.append(True)
        out = functional_call(model, params, (inputs,),
                              {"train": train,
                               "return_features": use_chunks})
        if use_chunks:
            emb = params["wte.weight"].to(out.dtype)
            ce = chunked_ce(out, emb, targets)
        else:
            ce = F.cross_entropy(out.float().reshape(-1, out.shape[-1]),
                                 targets.reshape(-1).long())
        metrics = {"ce_loss": ce.detach(), "perplexity": torch.exp(ce.detach())}
        return ce, (metrics, extras)

    return loss_fn


def example_input(data_cfg, model_cfg, batch_size: int = 1) -> dict[str, Any]:
    """A tiny batch of the task's shapes (zeros)."""
    del model_cfg
    if data_cfg.name in ("lm", "lm_synthetic"):
        return {"tokens": np.zeros((batch_size, data_cfg.seq_len + 1),
                                   np.int32)}
    raise KeyError(f"no example input for dataset {data_cfg.name!r}")
