"""Model FLOPs of a train step, and the card's peak for MFU: the port of
the JAX package's ``utils/flops.py``.

The JAX package counts a step's FLOPs from XLA's cost analysis or its
jaxpr. The port has two counts (``flops_source``):

- ``analytic`` for the GPT: 6 per parameter per token, plus causal
  attention's QK^T and PV, forward and backward (``gpt_train_flops``).
  ``FlopCounterMode`` cannot see the flash kernels, which run through
  ``ctypes`` (``ops/_build.py``), so it would undercount attention on the
  card's path;
- ``flop_counter`` for the other families: ``FlopCounterMode`` over one
  forward and backward of the loss (``grad_flops``), no recompute
  counted.

One multiply-add is 2 FLOPs, as chip peaks count them.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM (its name reads "H100 80GB HBM3"): dense bf16 tensor-core
# peak from NVIDIA's data sheet, at the full 700 W power limit.
_PEAKS = (("H100", "HBM3", 989e12),)


def peak_flops_per_chip(device=None) -> float | None:
    """The card's dense bf16 peak in FLOP/s, for MFU: 989e12 for the
    H100 SXM. None off the card or on a card not in the table: an
    unknown card gets no MFU, not a guessed peak."""
    if not torch.cuda.is_available():
        return None
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return None
    name = torch.cuda.get_device_name(dev)
    for *parts, peak in _PEAKS:
        if all(p in name for p in parts):
            return peak
    return None


def gpt_train_flops(cfg, n_params: int) -> dict:
    """Model FLOPs of one GPT optimizer step of ``cfg`` (an
    ``ExperimentConfig``), no recomputation counted: 6 per parameter per
    token, plus causal attention's QK^T and PV, forward (4 D per admitted
    pair) and backward (twice that)."""
    m = cfg.model
    tokens = cfg.data.global_batch_size * m.seq_len
    hd = m.hidden_dim // m.num_heads
    pairs = m.seq_len * (m.seq_len + 1) // 2
    attn = (3 * 4 * hd * pairs * m.num_heads * cfg.data.global_batch_size
            * m.num_layers)
    return {"tokens": tokens, "params": n_params,
            "dense_flops": 6 * n_params * tokens, "attention_flops": attn,
            "flops": 6 * n_params * tokens + attn}


def grad_flops(loss_fn, policy, params: dict, extras: dict, batch,
               device) -> int:
    """FLOPs of one forward and backward of ``loss_fn`` on ``batch``
    (products and convolutions), counted by ``FlopCounterMode`` over one
    gradient pass without recompute."""
    from torch.utils.flop_counter import FlopCounterMode

    from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
        make_grad_fn,
    )

    grad_fn = make_grad_fn(loss_fn, policy, device=device)
    with FlopCounterMode(display=False) as counter:
        grad_fn(params, extras, batch)
    return counter.get_total_flops()
