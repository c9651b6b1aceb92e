"""The port's overlap-scheduled FSDP (``parallel.fsdp_overlap``,
``parallel/fsdp_overlap.py``) over four gloo ranks (the harness:
``_torch_sharded.py``):

- ``gpt2_medium_fsdp_overlap`` cut to 2 layers at width 64 on
  ``fsdp=4``, with the recipe's ``block_remat=none`` and with ``full``;
  ``gpt2_medium_fsdp_tp_overlap`` on ``fsdp=2 model=2`` (both
  schedules in one forward); each against the JAX step on the same mesh
  and the port's one-rank step (losses, grad_norms and params after 2
  steps to rtol 2e-5 / atol 1e-6);
- its ``_int8`` twin against the JAX int8 step (``_torch_sharded.py``
  ``hold_int8``: the quantizers turn last-bit differences into whole
  quantization steps, in the JAX step too) and the fp32 composed ring
  within the reference's bands;
- every rank's blocks gathered in order, block k's gather posted
  once block k - 1 - prefetch has run.

The ResNet's hooks, and what the gathers save for the backward, are
``test_torch_fsdp_overlap_resnet.py``'s.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import numpy as np
import pytest

from _torch_sharded import (
    GPT,
    hold,
    hold_block_order,
    hold_draws,
    hold_int8,
    run_cases,
)

FSDP4 = ["mesh.data=1", "mesh.fsdp=4", "mesh.model=1"]
FSDP2_TP2 = ["mesh.data=1", "mesh.fsdp=2", "mesh.model=2"]
CASES = {
    "fsdp4": ("gpt2_medium_fsdp_overlap", GPT + FSDP4, True),
    "fsdp4_full": ("gpt2_medium_fsdp_overlap", GPT + FSDP4
                   + ["model.block_remat=full"], True),
    "fsdp2_tp2": ("gpt2_medium_fsdp_tp_overlap", GPT + FSDP2_TP2, True),
    "fsdp2_tp2_int8": ("gpt2_medium_fsdp_tp_overlap_int8", GPT + FSDP2_TP2,
                       True, 2),  # fsdp2_tp2's params
}
FP32 = [n for n in CASES if "int8" not in n]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("fsdpo"))


@pytest.mark.parametrize("name", FP32)
def test_overlap_step_matches_jax_step(runs, name):
    run = runs[name]
    hold_draws(run)
    hold(run, run["jax"]["metrics"], run["jax"]["params"], f"{name} vs jax")


@pytest.mark.parametrize("name", FP32)
def test_overlap_step_matches_one_rank_step(runs, name):
    run = runs[name]
    hold(run, run["one"]["metrics"], run["one"]["params"],
         f"{name} vs one rank")


def test_int8_composed_step_matches_jax_int8_step(runs, tmp_path):
    hold_int8(runs["fsdp2_tp2_int8"], tmp_path)


def test_int8_composed_ring_within_the_bands_of_the_fp32_ring(runs):
    ref = runs["fsdp2_tp2"]["ranks"][0]
    lp = runs["fsdp2_tp2_int8"]["ranks"][0]
    for a, b in zip(ref["metrics"], lp["metrics"]):
        assert abs(a["loss"] - b["loss"]) <= 5e-3 * max(1.0, abs(a["loss"]))
    for k, w in ref["params"].items():
        np.testing.assert_allclose(lp["params"][k], w, atol=1e-2, rtol=1e-3,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["fsdp4", "fsdp4_full", "fsdp2_tp2"])
def test_blocks_gather_their_own_shards(runs, name):
    hold_block_order(runs[name])
