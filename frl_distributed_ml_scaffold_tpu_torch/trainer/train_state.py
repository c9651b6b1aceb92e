"""Train state: the port of the JAX package's ``trainer/train_state.py``.

The step, the fp32 master parameters (a dict by name, as
``GPT.named_parameters`` gives them), the optimizer state, the
non-parameter collections (``extras``: ``{}`` for the GPT,
``{"batch_stats": {name: tensor}}`` for the ResNet) and an optional EMA
of the parameters. The step updates it in place
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
               with_ema: bool = False, opt_template: dict | None = None,
               device=None) -> "TrainState":
        """A state at step 0 holding COPIES of ``params`` and ``extras``
        on ``device`` (``None`` means ``cuda`` and raises without a card),
        detached from any module, and ``tx.init`` of ``opt_template``:
        tensors by name whose shapes and dtypes the optimizer state takes
        (only those are read; default: the params). The ``Trainer`` hands
        fp32 templates, as the JAX trainer builds its optimizer state
        from its fp32 init whatever dtype a params file brings, and under
        sharding the templates have the state's per-rank shapes."""
        dev = resolve_device(device)
        own = {k: p.detach().to(dev, copy=True) for k, p in params.items()}
        if opt_template is None:
            opt_template = own
        return cls(
            step=0,
            params=own,
            opt_state=tx.init(opt_template),
            extras=_copy_to(extras or {}, dev),
            ema_params=({k: p.clone() for k, p in own.items()}
                        if with_ema else None),
        )


def _copy_to(tree: dict, dev: torch.device) -> dict:
    return {k: (_copy_to(v, dev) if isinstance(v, dict)
                else v.detach().to(dev, copy=True))
            for k, v in tree.items()}
