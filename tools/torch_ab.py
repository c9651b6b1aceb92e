#!/usr/bin/env python
"""Time one path of the PyTorch port in several checkouts on one card,
each in a process of its own, in the order given.

    python tools/torch_ab.py PHASE TREE [TREE ...]

TREE is a checkout of this repository (for example a parent commit
unpacked with ``git archive`` into a git-ignored directory). For each, a
fresh process imports that tree's ``chip_smoke.py`` and runs one of its
phases from weights made with seed 0 (the same in every tree):

- ``train_path``: ``train_phase``, ``gpt2_medium_zero1`` with
  ``model.attention=flash`` at full width and depth, one warm-up, three
  timed steps and one profiled step;
- ``path`` / ``quant_path``: ``path_phase``, ``gpt2_medium_serve``
  serving 16 requests with 8 slots over the bucketed cache
  (``quant_path`` over an int8 cache, ``chip_smoke.INT8_OVERRIDES``),
  then a profiled window;
- ``paged_path`` / ``quant_paged_path``: ``paged_path_phase``, the same
  model with the paged pool, the prefix cache and n-gram speculation
  (``quant_paged_path`` over an fp8_e4m3 pool), 16 requests, then a
  profiled window.

Each tree builds its own kernels. One JSON line per tree: the card, the
step or token times, device busy time (in all and, serving, per step of
the profiled window) and idle share, and the kernels that take the most
device time (and the attention kernels' time in the profiled window).
Give the trees in the order parent, change, change, parent:
host time moves between hosts, so only turns within one call compare.
Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def _one(phase: str, tree: str) -> dict:
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke
    from frl_distributed_ml_scaffold_tpu_torch.config import get_config
    from frl_distributed_ml_scaffold_tpu_torch.models.convert import init_params

    if not torch.cuda.is_available():
        raise SystemExit("torch_ab: no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("gpt2_medium_serve")
    gen = torch.Generator(device="cuda").manual_seed(0)
    sd = init_params(cfg.model, gen)
    card = chip_smoke.nvidia_smi()
    out = {"tree": os.path.relpath(tree, os.path.dirname(__file__) + "/.."),
           "phase": phase, "card": card}
    if phase == "train_path":
        report, _, profile = chip_smoke.train_phase(sd, card)
        out.update(step_s_median=report["step_s_median"],
                   steps=[r["step_s"] for r in report["steps"]],
                   tokens_per_s=report["tokens_per_s"])
    else:
        from frl_distributed_ml_scaffold_tpu_torch.config import (
            apply_overrides,
        )

        if phase in ("path", "quant_path"):
            if phase == "quant_path":
                cfg = apply_overrides(cfg, chip_smoke.INT8_OVERRIDES)
            report, _, profile = chip_smoke.path_phase(cfg, sd, 0, card)
            steps = {"decode_steps": report["decode_steps"]}
        else:
            if phase == "quant_paged_path":
                cfg = apply_overrides(cfg, chip_smoke.FP8_OVERRIDES)
            report, _, profile = chip_smoke.paged_path_phase(cfg, sd, 0, card)
            steps = {k: report["stats"][k]
                     for k in ("decode_paged", "decode_verify")}
        out.update({k: report[k] for k in (
            "tokens_per_s", "ttft_mean_s", "ttft_p50_s", "tpot_mean_s",
            "tpot_p50_s")}, **steps)
        busy = profile["device_busy_s"]
        out["busy_per_step_s"] = (busy / profile["decode_steps"]
                                  if isinstance(busy, float) else busy)
    out.update(busy_s=profile["device_busy_s"],
               idle=profile["device_idle_share"],
               profiled_s=profile["wall_s"],
               top_device_s=profile["top_device_s"][:4],
               # Trees older than the profile's own attention entry: the
               # attention kernels among its top ten.
               attention_kernels_s=profile.get("attention_kernels_s") or {
                   n: t for n, t in profile["top_device_s"]
                   if "attention_kernel" in n or "paged_tc_kernel" in n})
    return out


PHASES = ("train_path", "path", "quant_path", "paged_path",
          "quant_paged_path")


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--one":
        print(json.dumps(_one(sys.argv[2], sys.argv[3])), flush=True)
        return 0
    if len(sys.argv) < 3 or sys.argv[1] not in PHASES:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in sys.argv[2:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        sys.argv[1], tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
