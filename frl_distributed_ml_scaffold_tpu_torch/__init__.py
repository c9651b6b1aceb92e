"""PyTorch / CUDA port of the scaffold, for NVIDIA Hopper (H100).

A package of its own beside ``frl_distributed_ml_scaffold_tpu``, which
stays the reference. It imports ``torch`` and nothing of JAX or of the
JAX package. Module names mirror the JAX package's, so each port module
sits where its counterpart does. The first slice is GPT serving through
the continuous-batching engine (ROADMAP.md queue A).

Entry points run on the card: ``device=None`` means ``cuda`` and raises
when no card is present. The CPU is used only when asked for
(``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` -> ``cuda`` (with the current device's index); raise when
    the resolved device is CUDA and no card is present (never fall back
    to the CPU silently)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
