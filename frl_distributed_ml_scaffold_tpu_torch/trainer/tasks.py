"""Task losses: the port of the JAX package's ``trainer/tasks.py`` for
the LM and classification tasks.

``make_lm_loss(model)`` and ``make_classification_loss(model)`` return
the ``loss_fn(params, extras, batch, rng, train) -> (loss, (metrics,
extras))`` contract that ``train_step.py`` consumes; ``make_loss_fn``
picks one by dataset name. ``params`` is a dict of the model's
parameters by name (already in the compute dtype: the step casts them),
applied with ``torch.func.functional_call``. ``extras`` holds the
non-parameter collections: ``{}`` for the GPT, ViT, video classifier and
MLP, whose forward returns the output alone; ``{"batch_stats": {buffer
name: tensor}}`` for the ResNet, whose forward returns ``(logits,
updates)``: in train mode the new running statistics, handed back as the
new ``extras`` (never written into the module), as the JAX ``_apply``
returns its mutated collections.
``rng`` is the int seed of the forward's training dropout
(``models/dropout.py``; the train step derives one per step and
microbatch), handed to the model. The loss math runs in fp32 whatever
the compute dtype.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from frl_distributed_ml_scaffold_tpu_torch.parallel.tensor_parallel import (
    seq_shard,
)

_log = logging.getLogger(__name__)


def _chunk_ce(feats, emb, targets):
    """Summed next-token CE of one chunk: exactly the weight-tied head's
    math (a compute-dtype product, cast to fp32) with the fp32
    softmax-CE after it."""
    logits = (feats @ emb.T).float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long(), reduction="sum")


def _chunked_ce(feats, emb, targets, chunk: int):
    """Mean next-token CE chunk by chunk over the sequence, each chunk
    under ``torch.utils.checkpoint`` (only ``[B, chunk, vocab]`` logits
    exist, recomputed in the backward)."""
    b, t, _ = feats.shape
    total = torch.zeros((), dtype=torch.float32, device=feats.device)
    for i in range(t // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(_chunk_ce, feats[:, sl], emb,
                                   targets[:, sl], use_reentrant=False)
    return total / (b * t)


def lm_head_ce(feats, emb, targets, policy, chunk: int = 0):
    """Mean next-token CE of ``ln_f`` output ``feats`` ([B, T, D], fp32)
    through the weight-tied head ``emb`` ([vocab, D]): the compute-dtype
    product, fp32 softmax-CE after it, chunk by chunk over T under
    ``torch.utils.checkpoint`` when ``chunk`` divides T (as
    ``make_lm_loss``). The pipelines' last stage runs it (``lm_head_loss``)
    on each microbatch as the microbatch emerges, so at most one
    microbatch's logits exist (``parallel/pipeline.py``,
    ``parallel/mpmd_pipeline.py``: the mean of the microbatch means is the
    batch's mean)."""
    cd = policy.compute_dtype
    feats, emb = feats.to(cd), emb.to(cd)
    if chunk > 0 and feats.shape[1] % chunk == 0:
        return _chunked_ce(feats, emb, targets, chunk)
    logits = (feats @ emb.T).float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1).long())


def lm_head_loss(policy, chunk: int = 0):
    """``lm_head_ce`` under ``policy`` and ``chunk`` as the pipelines'
    ``head_loss(feats, emb, targets)``."""

    def head_loss(feats, emb, targets):
        return lm_head_ce(feats, emb, targets, policy, chunk)

    return head_loss


def make_lm_loss(model):
    """Next-token CE over ``batch["tokens"]`` ([B, L+1] int), plus the MoE
    model's auxiliary loss (``metrics["aux_loss"]``) when it returns one.

    Under sequence parallelism (a current mesh with ``seq = n``) every
    rank holds the rows whole: they are split into inputs and targets
    first, then rank r keeps tokens ``[r L/n, (r+1) L/n)`` of both, and
    its CE is the mean over those (the step averages over ``seq``).

    With ``model.config.lm_loss_chunk > 0`` (dividing L) the weight-tied
    head and the CE run chunk by chunk over the sequence, each chunk
    under ``torch.utils.checkpoint``, so only ``[B, chunk, vocab]``
    logits ever exist (and are recomputed in the backward). A chunk that
    does not divide L falls back to the dense head, logged once.
    """
    chunk = int(getattr(getattr(model, "config", None), "lm_loss_chunk", 0)
                or 0)
    warned = []

    def loss_fn(params, extras, batch, rng, train):
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        r, n = seq_shard()
        if n > 1:
            if inputs.shape[1] % n:
                raise ValueError(f"sequence length {inputs.shape[1]} not "
                                 f"divisible by mesh.seq={n}")
            t = inputs.shape[1] // n
            inputs = inputs[:, r * t:(r + 1) * t]
            targets = targets[:, r * t:(r + 1) * t]
        use_chunks = chunk > 0 and inputs.shape[1] % chunk == 0
        if chunk > 0 and not use_chunks and not warned:
            _log.warning(
                "lm_loss_chunk=%d does not divide the sequence length %d: "
                "falling back to the dense [B, T, vocab] head (the memory "
                "saving is OFF)", chunk, inputs.shape[1],
            )
            warned.append(True)
        out = functional_call(model, params, (inputs,),
                              {"train": train, "rng": rng,
                               "return_features": use_chunks})
        aux = None
        if isinstance(out, tuple):  # MoE: (logits or features, aux)
            out, aux = out
        if use_chunks:
            emb = params["wte.weight"].to(out.dtype)
            ce = _chunked_ce(out, emb, targets, chunk)
        else:
            ce = F.cross_entropy(out.float().reshape(-1, out.shape[-1]),
                                 targets.reshape(-1).long())
        metrics = {"ce_loss": ce.detach(), "perplexity": torch.exp(ce.detach())}
        if aux is None:
            return ce, (metrics, extras)
        metrics["aux_loss"] = aux.detach()
        return ce + aux, (metrics, extras)

    return loss_fn


_IMAGE_DATA = ("mnist", "synthetic_mnist", "imagenet", "synthetic_imagenet")
_VIDEO_DATA = ("video", "video_synthetic")


def _apply(model, params, extras, x, train: bool, rng):
    """The model's output with its BatchNorm statistics read from
    ``extras`` -> (output, new extras): in train mode the statistics the
    forward returns replace the old ones. A model without statistics
    returns its output alone."""
    kw = {"train": train, "rng": rng}
    stats = extras.get("batch_stats")
    if stats is None:
        return functional_call(model, params, (x,), kw), extras
    out, updates = functional_call(model, {**params, **stats}, (x,), kw)
    if train:
        return out, {**extras, "batch_stats": updates}
    return out, extras


def make_classification_loss(model, input_key: str = "image"):
    """Softmax cross-entropy over ``batch[input_key]`` and integer
    ``batch["label"]``, in fp32; metrics ``accuracy`` and, with more than
    5 classes, ``accuracy_top5``."""

    def loss_fn(params, extras, batch, rng, train):
        logits, new_extras = _apply(model, params, extras, batch[input_key],
                                    train, rng)
        logits = logits.float()
        labels = batch["label"].long()
        loss = F.cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        metrics = {"accuracy": acc.detach()}
        if logits.shape[-1] > 5:
            top5 = logits.topk(5, dim=-1).indices
            metrics["accuracy_top5"] = (
                (top5 == labels[:, None]).any(-1).float().mean().detach())
        return loss, (metrics, new_extras)

    return loss_fn


def make_loss_fn(model, data_name: str):
    """The task's loss for dataset ``data_name``, as the JAX package
    picks it."""
    if data_name in _IMAGE_DATA:
        return make_classification_loss(model, "image")
    if data_name in _VIDEO_DATA:
        return make_classification_loss(model, "video")
    if data_name in ("lm", "lm_synthetic"):
        return make_lm_loss(model)
    raise KeyError(f"no task for dataset {data_name!r}")


def example_input(data_cfg, model_cfg, batch_size: int = 1) -> dict[str, Any]:
    """A tiny batch of the task's shapes (zeros)."""
    del model_cfg
    name, size, ch = data_cfg.name, data_cfg.image_size, data_cfg.channels
    if name in _IMAGE_DATA:
        return {"image": np.zeros((batch_size, size, size, ch), np.float32),
                "label": np.zeros((batch_size,), np.int32)}
    if name in _VIDEO_DATA:
        return {"video": np.zeros((batch_size, data_cfg.num_frames, size,
                                   size, ch), np.float32),
                "label": np.zeros((batch_size,), np.int32)}
    if name in ("lm", "lm_synthetic"):
        return {"tokens": np.zeros((batch_size, data_cfg.seq_len + 1),
                                   np.int32)}
    raise KeyError(f"no example input for dataset {name!r}")
