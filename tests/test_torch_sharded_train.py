"""The port's training step over four gloo ranks under data parallelism,
FSDP and ZeRO-1, against the JAX step on the same mesh and the port's
own one-rank step (the harness: ``_torch_sharded.py``):

- (a) ``imagenet_rn50_ddp`` (ResNet-10 at 64 px, SGD at the ResNet
  parity tests' lr 0.02; the recipe's 0.4 is its 1024-image batch's),
  ``data=4``, ``grad_accum=2``, sync-BN through the BatchNorm-backward
  passes (``model.fused_bn=true``) and through the plain BatchNorm (held
  against the one-rank step);
- (b) ``imagenet_vitb_fsdp``, ``data=2 fsdp=2`` (params split by the
  FSDP overlay, the accumulator in their spec), remat and the clip;
- (c) ``gpt2_medium_zero1``, ``fsdp=4`` ZeRO-1, with the clip;
- (e) ``mnist_mlp``, ``data=4``, ``fused_adamw`` (its plain path here):
  the params stay bit-identical across ranks.

Loss and grad_norm to rtol 2e-5; params to rtol 2e-5 / atol 1e-6, the
ResNets' to atol 2e-5: their stem's gradient sums 64 * 64 / 4 pixels of
32 images per element, and the order of that sum (four ranks against
one, torch against XLA) moves a param by up to 1e-5 over the two steps
(measured 9.9e-6 plain against one rank, 7.4e-6 fused against JAX). The
batch gives a BatchNorm at the 2x2 last stage 64 rows a microbatch: at 4
rows (2 a rank, 32 px) the fast variance of so few samples is
ill-conditioned enough that the order of the sums alone moves the
gradients by 1e-4. Per-rank bytes of params and optimizer moments equal
the JAX state's shard bytes at the same mesh coordinate.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import numpy as np
import pytest

from _torch_sharded import (
    ATOL,
    GPT,
    RTOL,
    VIT,
    hold,
    hold_draws,
    hold_state_bytes,
    run_cases,
)

ATOL_RESNET = 2e-5
RN = ["model.depth=10", "data.image_size=64", "model.num_classes=10",
      "data.num_classes=10", "data.global_batch_size=32",
      "trainer.grad_accum=2", "mesh.data=4", "optimizer.learning_rate=0.02"]
# name: (recipe, overrides, held against the JAX step too)
CASES = {
    "rn50": ("imagenet_rn50_ddp", RN + ["model.fused_bn=true"], True),
    "rn50_plain_bn": ("imagenet_rn50_ddp", RN, False),
    "vit_fsdp": ("imagenet_vitb_fsdp", VIT + [
        "mesh.data=2", "mesh.fsdp=2", "parallel.fsdp_min_size=256"], True),
    "gpt_zero1": ("gpt2_medium_zero1", GPT + [
        "mesh.data=1", "mesh.fsdp=4", "parallel.fsdp_min_size=256"], True),
    "mlp": ("mnist_mlp", ["mesh.data=4", "optimizer.name=fused_adamw",
                          "data.global_batch_size=32"], True),
}


def _atol(name: str) -> float:
    return ATOL_RESNET if name.startswith("rn50") else ATOL


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("sharded"))


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[2]])
def test_n_rank_step_matches_jax_step(runs, name):
    run = runs[name]
    hold_draws(run)
    hold(run, run["jax"]["metrics"], run["jax"]["params"], f"{name} vs jax",
         _atol(name))


@pytest.mark.parametrize("name", list(CASES))
def test_n_rank_step_matches_one_rank_step(runs, name):
    run = runs[name]
    hold(run, run["one"]["metrics"], run["one"]["params"],
         f"{name} vs one rank", _atol(name))


def test_sync_bn_running_stats_are_global(runs):
    """The BatchNorm running statistics after the steps are the one-rank
    step's (global-batch statistics) on every rank, both BatchNorms."""
    for name in ("rn50", "rn50_plain_bn"):
        want = runs[name]["one"]["extras"]["batch_stats"]
        for r in runs[name]["ranks"]:
            got = r["extras"]["batch_stats"]
            for k, w in want.items():
                np.testing.assert_allclose(got[k], w.numpy(), rtol=RTOL,
                                           atol=ATOL, err_msg=f"{name} {k}")


def test_fused_adamw_params_bit_identical_across_ranks(runs):
    ranks = runs["mlp"]["ranks"]
    for r in ranks[1:]:
        for k, v in ranks[0]["local_params"].items():
            np.testing.assert_array_equal(r["local_params"][k], v, err_msg=k)


def test_fsdp_accumulator_and_zero1_specs(runs):
    """Under FSDP the accumulator takes the params' spec (each rank keeps
    its shard of every split param, never a gathered fp32 copy), and the
    forward reads them whole; under ZeRO-1 the params stay whole while
    the moments split."""
    for r in runs["vit_fsdp"]["ranks"]:
        specs = r["specs"]
        assert specs["accum"] == specs["param"]
        split = [k for k, s in specs["param"].items() if "fsdp" in s]
        assert split  # the overlay split something
        for k in split:
            d = specs["param"][k].index("fsdp")
            full = runs["vit_fsdp"]["one"]["params"][k].shape
            assert r["accum_shapes"][k][d] == full[d] // 2, k
            assert specs["compute"][k] == (None,) * len(full)
    z = runs["gpt_zero1"]["ranks"][0]["specs"]
    assert all(all(e is None for e in s) for s in z["param"].values())
    assert any("fsdp" in s for s in z["opt"].values())


@pytest.mark.parametrize("name", ["vit_fsdp", "gpt_zero1"])
def test_state_bytes_per_rank_match_jax(runs, name):
    hold_state_bytes(runs[name])
