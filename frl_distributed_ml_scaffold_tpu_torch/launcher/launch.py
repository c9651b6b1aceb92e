"""The launcher: the port of the JAX package's ``launcher/launch.py``.

Usage::

    python -m frl_distributed_ml_scaffold_tpu_torch.launcher.launch \\
        --config=mnist_mlp [--device=cuda|cpu] [--list-configs] \\
        [--describe] [--eval-only] [--elastic] [--coordinator=HOST:PORT \\
        --num-processes=N --process-id=I] [--sim-devices=N] \\
        [path.to.field=value ...]

One process per rank. Without the distributed flags (or the
``FRL_TPU_COORDINATOR`` / ``FRL_TPU_NUM_PROCESSES`` /
``FRL_TPU_PROCESS_ID`` variables) one process trains on one card
(``--device=cuda``, the default: it raises without a card and never
falls back to the CPU) or, when asked, on the CPU (``--device=cpu``).
With ``--num-processes=N`` each of N processes, started with its own
``--process-id``, joins the process group at ``--coordinator``
(``host:port`` of rank 0, or a ``file://`` path): NCCL on the cards,
rank i on card ``i % device_count``; gloo on the CPU. The run's mesh is
``cfg.mesh`` over the N ranks. ``--device=cpu --sim-devices=N`` runs N
gloo ranks on this machine: this process is rank 0 and starts the other
N - 1 (the counterpart of the JAX package's N simulated devices).

``--elastic`` runs the training as a supervised child process
(``launcher/elastic.py``): restarted after a failure and resumed from
the last checkpoint, with ``FRL_FAULT_AT_STEP`` / ``FRL_FAULT_SIGNAL`` /
``FRL_STEP_DELAY_S`` for the drills. ``FRL_TPU_SANITIZE=nans,infs``
turns on the NaN / Inf sanitizer (``utils/debugging.py``) for the
length of the call, after the process group is up. ``FRL_FAULT_PLAN``,
when set, arms that fault plan for the length of each ``main()`` call
(``faults/``). ``--hlo-dump`` is refused: the port runs no XLA.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import tempfile

MODULE = "frl_distributed_ml_scaffold_tpu_torch.launcher.launch"


def _parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="FRL scaffold launcher (PyTorch port)")
    p.add_argument("--config",
                   help="registered config name (see --list-configs)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--sim-devices", type=int, default=0,
                   help="with --device=cpu: run N gloo ranks on this machine "
                   "(this process is rank 0 and starts the others)")
    p.add_argument("--list-configs", action="store_true")
    p.add_argument("--elastic", action="store_true",
                   help="run the training as a supervised child: restarted "
                   "on failure, resumed from the last checkpoint")
    p.add_argument("--eval-only", action="store_true",
                   help="restore the latest checkpoint and run the eval loop "
                   "only")
    p.add_argument("--describe", action="store_true",
                   help="print the resolved config, the parameters and the "
                   "train step's FLOPs, then exit without training (dry run)")
    p.add_argument("--coordinator", default=None,
                   help="rank 0's rendezvous, host:port or file://path")
    p.add_argument("--hlo-dump", default=None, metavar="DIR",
                   help="refused: the port runs no XLA")
    p.add_argument("--num-processes", type=int, default=None,
                   help="the run's process count (one rank each)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank")
    p.add_argument("overrides", nargs="*",
                   help="config overrides: path.to.field=value")
    return p.parse_intermixed_args(argv)


def _refuse_unported(args) -> None:
    if args.sim_devices and args.device != "cpu":
        raise ValueError(
            "--sim-devices runs gloo ranks on the CPU: pass --device=cpu "
            "(on the cards, start one process per rank with "
            "--num-processes / --process-id / --coordinator)")
    if args.sim_devices and args.num_processes is not None:
        raise ValueError("--sim-devices starts its own processes; do not "
                         "combine it with --num-processes")
    if args.hlo_dump:
        raise NotImplementedError(
            "--hlo-dump writes XLA's optimized HLO; the port runs no XLA "
            "(torch.profiler windows: trainer.profile_steps)")


def _spawn_sim_ranks(argv: list[str], n: int, rendezvous: str):
    """Start ranks 1..n-1 of a ``--sim-devices=n`` run: this launcher's
    own arguments, with the process flags in place of ``--sim-devices``."""
    rest = [a for a in argv if not a.startswith("--sim-devices")]
    return [subprocess.Popen(
        [sys.executable, "-m", MODULE, *rest, f"--num-processes={n}",
         f"--process-id={i}", f"--coordinator={rendezvous}"])
        for i in range(1, n)]


def _abandon_sim_ranks(children: list, rendezvous: str) -> None:
    """Kill the ``--sim-devices`` ranks and remove their rendezvous file:
    the fault hook's hard exit runs no ``finally``, and must not leave
    them holding the rendezvous."""
    for child in children:
        if child.poll() is None:
            child.kill()
            child.wait()
    if os.path.exists(rendezvous[7:]):
        os.remove(rendezvous[7:])


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


def run_experiment(cfg, *, device=None, before_hard_exit=None):
    """Train one config to completion on ``device``; returns
    ``(state, last_metrics)``. The elastic drills' fault hook
    (``FRL_FAULT_AT_STEP`` ...) runs after every step when set;
    ``before_hard_exit`` runs just before its hard exit."""
    from frl_distributed_ml_scaffold_tpu_torch.launcher.elastic import (
        fault_hook_from_env,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

    trainer = Trainer(cfg, device=device)
    try:
        return trainer.fit(on_step=fault_hook_from_env(
            cfg, before_hard_exit=before_hard_exit))
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
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parse_args(argv)
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
        list_configs,
        pretty_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.dist.initialize import (
        initialize_distributed,
        local_device,
        process_index,
        shutdown_distributed,
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
    if args.elastic:
        from frl_distributed_ml_scaffold_tpu_torch.launcher.elastic import (
            supervise,
        )

        return supervise(args, cfg)
    from frl_distributed_ml_scaffold_tpu_torch.utils import debugging

    children, rendezvous = [], None
    coordinator, n_proc, proc_id = (args.coordinator, args.num_processes,
                                    args.process_id)
    if args.sim_devices > 1:
        fd, path = tempfile.mkstemp(prefix="frl_sim_rendezvous_")
        os.close(fd)
        os.remove(path)  # the file store creates it
        rendezvous = f"file://{path}"
        coordinator, n_proc, proc_id = rendezvous, args.sim_devices, 0
        children = _spawn_sim_ranks(argv, args.sim_devices, rendezvous)
    rc = 0
    try:
        initialize_distributed(coordinator, n_proc, proc_id,
                               device=args.device)
        device = local_device(process_index(), args.device)
        logger = get_logger()  # after the process group: rank 0 logs
        debugging.sanitize_from_env()
        with _env_fault_plan():
            if args.describe:
                return describe(cfg, device=device)
            logger.info("launching %s on %s\n%s", cfg.name, device,
                        pretty_config(cfg))
            if args.eval_only:
                last = run_eval(cfg, device=device)
            else:
                _, last = run_experiment(
                    cfg, device=device,
                    before_hard_exit=(functools.partial(
                        _abandon_sim_ranks, children, rendezvous)
                        if children else None))
        logger.info("done: %s", json.dumps(last, default=str))
    finally:
        debugging.reset_process_sanitizers()
        shutdown_distributed()
        for child in children:
            rc = child.wait() or rc
        if rendezvous is not None and os.path.exists(rendezvous[7:]):
            os.remove(rendezvous[7:])
    if rc:
        get_logger().error("a simulated rank exited with code %d", rc)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
