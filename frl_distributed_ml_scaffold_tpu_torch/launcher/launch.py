"""The launcher: the port of the JAX package's ``launcher/launch.py``.

Usage::

    python -m frl_distributed_ml_scaffold_tpu_torch.launcher.launch \\
        --config=mnist_mlp [--device=cuda|cpu] [--list-configs] \\
        [--describe] [--eval-only] [path.to.field=value ...]

One process trains on one card (``--device=cuda``, the default: it raises
without a card and never falls back to the CPU) or, when asked, on the
CPU (``--device=cpu``). Refused, each naming its ROADMAP item:
``--elastic`` (queue A item 13), ``--coordinator``,
``--num-processes``, ``--process-id`` and ``--sim-devices`` (item 7),
``--hlo-dump`` (the port runs no XLA) and ``FRL_TPU_SANITIZE`` in the
environment (item 13). ``FRL_FAULT_PLAN``, when set, arms that fault
plan for the length of each ``main()`` call (``faults/``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="FRL scaffold launcher (PyTorch port, one card)")
    p.add_argument("--config",
                   help="registered config name (see --list-configs)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--sim-devices", type=int, default=0,
                   help="refused: simulated devices (ROADMAP queue A item 7)")
    p.add_argument("--list-configs", action="store_true")
    p.add_argument("--elastic", action="store_true",
                   help="refused: the elastic supervisor (ROADMAP queue A "
                   "item 13)")
    p.add_argument("--eval-only", action="store_true",
                   help="restore the latest checkpoint and run the eval loop "
                   "only")
    p.add_argument("--describe", action="store_true",
                   help="print the resolved config, the parameters and the "
                   "train step's FLOPs, then exit without training (dry run)")
    p.add_argument("--coordinator", default=None,
                   help="refused: multi-process runs (ROADMAP queue A item 7)")
    p.add_argument("--hlo-dump", default=None, metavar="DIR",
                   help="refused: the port runs no XLA")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("overrides", nargs="*",
                   help="config overrides: path.to.field=value")
    return p.parse_intermixed_args(argv)


def _refuse_unported(args) -> None:
    if args.elastic:
        raise NotImplementedError(
            "--elastic (the checkpoint-restart supervisor) is not ported "
            "yet (ROADMAP queue A item 13)")
    for flag, value in (("--coordinator", args.coordinator),
                        ("--num-processes", args.num_processes),
                        ("--process-id", args.process_id),
                        ("--sim-devices", args.sim_devices or None)):
        if value is not None:
            raise NotImplementedError(
                f"{flag}: multi-process and simulated-device runs are not "
                "ported yet (ROADMAP queue A item 7); the port trains in "
                "one process on one card")
    if args.hlo_dump:
        raise NotImplementedError(
            "--hlo-dump writes XLA's optimized HLO; the port runs no XLA "
            "(torch.profiler windows: trainer.profile_steps)")
    if os.environ.get("FRL_TPU_SANITIZE"):
        raise NotImplementedError(
            f"FRL_TPU_SANITIZE={os.environ['FRL_TPU_SANITIZE']!r}: the "
            "NaN / Inf / leak sanitizer is not ported yet (ROADMAP queue A "
            "item 13); unset it")


@contextlib.contextmanager
def _env_fault_plan():
    """Arm ``FRL_FAULT_PLAN`` for this call, when it is set."""
    spec = os.environ.get("FRL_FAULT_PLAN")
    if not spec:
        yield
        return
    from frl_distributed_ml_scaffold_tpu_torch import faults

    with faults.active(faults.FaultPlan.from_env(spec)):
        yield


def run_experiment(cfg, *, device=None):
    """Train one config to completion on ``device``; returns
    ``(state, last_metrics)``."""
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

    trainer = Trainer(cfg, device=device)
    try:
        return trainer.fit()
    finally:
        if trainer.checkpointer is not None:
            trainer.checkpointer.close()


def run_eval(cfg, *, device=None) -> dict:
    """Restore the latest committed checkpoint, run the eval loop."""
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

    trainer = Trainer(cfg, device=device)
    if (trainer.checkpointer is None
            or trainer.checkpointer.latest_step() is None):
        raise RuntimeError(
            "--eval-only needs checkpoint.enabled=true and an existing "
            f"checkpoint under {cfg.workdir}/{cfg.name}/ckpt")
    state = trainer.checkpointer.restore_or_init(trainer)
    return trainer.evaluate(state)


def describe(cfg, *, device=None) -> int:
    """Dry run: the resolved config, every parameter's shape, the total
    and the train step's FLOPs at the global batch (counted on the meta
    device: nothing is allocated for them). Nothing trains and nothing is
    written (checkpoints and prefetch are forced off)."""
    import numpy as np
    import torch

    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        pretty_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer
    from frl_distributed_ml_scaffold_tpu_torch.trainer.tasks import (
        example_input,
    )

    print(pretty_config(cfg))
    cfg = apply_overrides(cfg, ["checkpoint.enabled=false", "data.prefetch=0"])
    trainer = Trainer(cfg, device=device)
    print(f"\ndevice: {trainer.device}")
    total = 0
    print(f"\n{'parameter':58s} {'shape':20s} dtype")
    for name, p in trainer.state_shapes.params.items():
        total += p.numel()
        print(f"{name:58s} {str(tuple(p.shape)):20s} {p.dtype}")
    print(f"\ntotal params: {total / 1e6:.2f}M")
    gb = cfg.data.global_batch_size
    batch = {k: torch.from_numpy(np.asarray(v)).to("meta")
             for k, v in example_input(cfg.data, cfg.model,
                                       batch_size=gb).items()}
    cost = trainer.step_cost_analysis(trainer.state_shapes, batch)
    if cost is None:
        print("train-step FLOPs: unavailable")
    else:
        print(f"train-step FLOPs (global batch): {cost['flops'] / 1e9:.2f} G "
              f"({cost['flops'] / gb / 1e9:.2f} G/sample, "
              f"{cost['flops_source']})")
    return 0


def main(argv=None) -> int:
    args = _parse_args(argv)
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
        list_configs,
        pretty_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.utils.logging import get_logger

    if args.list_configs:
        print("\n".join(list_configs()))
        return 0
    if not args.config:
        print("--config is required (see --list-configs)", file=sys.stderr)
        return 2
    _refuse_unported(args)
    cfg = apply_overrides(get_config(args.config), args.overrides)
    logger = get_logger()
    with _env_fault_plan():
        if args.describe:
            return describe(cfg, device=args.device)
        logger.info("launching %s on %s\n%s", cfg.name, args.device,
                    pretty_config(cfg))
        if args.eval_only:
            last = run_eval(cfg, device=args.device)
        else:
            _, last = run_experiment(cfg, device=args.device)
    logger.info("done: %s", json.dumps(last, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
