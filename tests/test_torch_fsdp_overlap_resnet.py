"""The port's overlap-scheduled FSDP on the ResNet (``param_hooks``,
``parallel/fsdp_overlap.py``) and what the blockwise gathers save for
the backward, over four gloo ranks (the harness: ``_torch_sharded.py``;
the GPT cases are ``test_torch_fsdp_overlap.py``'s):

- a ResNet-10 (``imagenet_rn50_ddp`` at 64 px with FSDP, ``fsdp=4``,
  sync-BN over the four ranks) with ``fsdp_prefetch`` 1 and 2 equals
  the plain FSDP step of the same case (its params gathered at the start
  of the step) bit for bit: losses, grad_norms and params after 2
  steps; block k's gather posted only once block k - 1 - prefetch has
  run;
- the three against the JAX step on the same mesh and the port's
  one-rank step, to rtol 5e-5 / atol 2e-4: the case's sync-BN sums
  (64 values a channel in the last stage) and the stem's long gradient
  sums move it by more than the other sharded cases' 2e-5
  (test_torch_sharded_train.py's ResNet note; measured here: grad_norm
  3.3e-5 relative, 1.55e-4 on 5 of the 1179648 values of the last
  stage's first conv), the plain FSDP step exactly as much as the
  overlap ones;
- under ``block_remat=none`` no gathered parameter, whole, is among the
  tensors autograd saves (an outer
  ``torch.autograd.graph.saved_tensors_hooks`` records them; the plain
  FSDP step, which gathers at its start, saves them) and the backward
  gathers every one again.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import numpy as np
import pytest

from _torch_sharded import (
    GPT,
    hold,
    hold_block_order,
    hold_draws,
    run_cases,
)

# The ResNet case's bounds (module docstring).
RN_RTOL, RN_ATOL = 5e-5, 2e-4
FSDP4 = ["mesh.data=1", "mesh.fsdp=4", "mesh.model=1"]
RN = ["model.depth=10", "data.image_size=64", "model.num_classes=10",
      "data.num_classes=10", "data.global_batch_size=32",
      "trainer.grad_accum=2", "optimizer.learning_rate=0.02",
      "parallel.param_sharding=fsdp"] + FSDP4
OVERLAP = ["parallel.fsdp_overlap=true"]
# One params file for the three (seed 0).
CASES = {
    "rn_plain": ("imagenet_rn50_ddp", RN, True, 0),
    "rn_p1": ("imagenet_rn50_ddp", RN + OVERLAP
              + ["parallel.fsdp_prefetch=1"], True, 0),
    "rn_p2": ("imagenet_rn50_ddp", RN + OVERLAP
              + ["parallel.fsdp_prefetch=2"], True, 0),
}
HOOKED = ("rn_p1", "rn_p2")
SAVED = GPT + FSDP4 + ["trainer.remat=none"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    extra = [{"name": f"saved_{flag}", "kind": "saved_shapes",
              "args": {"config": "gpt2_medium_fsdp_overlap",
                       "overrides": SAVED + [f"parallel.fsdp_overlap={flag}"]}}
             for flag in ("true", "false")]
    return run_cases(CASES, tmp_path_factory.mktemp("fsdpo_rn"), extra)


@pytest.mark.parametrize("name", list(CASES))
def test_overlap_step_matches_jax_step(runs, name):
    run = runs[name]
    hold_draws(run)
    hold(run, run["jax"]["metrics"], run["jax"]["params"], f"{name} vs jax",
         RN_ATOL, RN_RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_overlap_step_matches_one_rank_step(runs, name):
    run = runs[name]
    hold(run, run["one"]["metrics"], run["one"]["params"],
         f"{name} vs one rank", RN_ATOL, RN_RTOL)


@pytest.mark.parametrize("name", HOOKED)
def test_overlap_step_is_the_plain_fsdp_step(runs, name):
    """The blockwise gathers change no number: the same sums in the same
    order as the plain FSDP step's, on every rank."""
    for got, want in zip(runs[name]["ranks"], runs["rn_plain"]["ranks"]):
        assert got["metrics"] == want["metrics"]
        for k, v in want["params"].items():
            np.testing.assert_array_equal(got["params"][k], v, err_msg=k)
        assert got["gathers"] is not None and want["gathers"] is None


@pytest.mark.parametrize("name", HOOKED)
def test_blocks_gather_their_own_shards(runs, name):
    hold_block_order(runs[name])


def test_no_gathered_param_is_saved_for_the_backward(runs):
    """Under ``block_remat=none`` every activation is saved but the
    gathered params: the backward gathers them again (``regathers``);
    the plain FSDP step saves them whole."""
    by = runs["extra"][0]
    hooked, plain = by["saved_true"], by["saved_false"]
    whole = set()
    for shape in hooked["gathered"].values():
        whole |= {tuple(shape), tuple(shape[::-1])}
    assert whole
    assert not [s for s in hooked["saved"] if s in whole]
    assert [s for s in plain["saved"] if s in whole]
    assert hooked["counts"]["regathers"] >= len(hooked["gathered"])
    assert len(hooked["saved"]) > len(hooked["gathered"])
