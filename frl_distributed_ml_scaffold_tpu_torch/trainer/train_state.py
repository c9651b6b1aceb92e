"""Train state: the port of the JAX package's ``trainer/train_state.py``.

The step, the fp32 master parameters (a dict by name, as
``GPT.named_parameters`` gives them), the optimizer state, the
non-parameter collections (``extras``: ``{}`` for the GPT) and an
optional EMA of the parameters. The step updates it in place
(``train_step.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from frl_distributed_ml_scaffold_tpu_torch import resolve_device


@dataclasses.dataclass
class TrainState:
    step: int
    params: dict[str, torch.Tensor]
    opt_state: Any
    extras: dict = dataclasses.field(default_factory=dict)
    # EMA of params when trainer.ema_decay > 0, else None.
    ema_params: dict[str, torch.Tensor] | None = None

    @classmethod
    def create(cls, params: dict, tx, extras: dict | None = None, *,
               with_ema: bool = False, device=None) -> "TrainState":
        """A state at step 0 holding COPIES of ``params`` on ``device``
        (``None`` means ``cuda`` and raises without a card), detached from
        any module, and ``tx.init`` of them."""
        dev = resolve_device(device)
        own = {k: p.detach().to(dev, copy=True) for k, p in params.items()}
        return cls(
            step=0,
            params=own,
            opt_state=tx.init(own),
            extras={} if extras is None else extras,
            ema_params=({k: p.clone() for k, p in own.items()}
                        if with_ema else None),
        )
