"""The port's tensor-parallel training step and dropout over four gloo
ranks (the harness: ``_torch_sharded.py``):

- (d) ``gpt2_tp``, ``data=2 model=2``: against the JAX step on the same
  mesh with an even vocabulary (the JAX package's jax refuses to place
  an uneven split), and with an odd one (509 rows, ``wte`` split 255 +
  254) against the port's one-rank step;
- dropout (``model.dropout=0.1``): rank r's masks are rows r of the
  one-rank masks at the same seed, and a ``model`` slice of them where
  the tensor is split over ``model``; so a GPT and a ViT over ``data=2
  model=2`` (the ViT's attention probabilities and GELU outputs split
  over ``model``) take the one-rank step's losses and params, and each
  rank's mask of a ``data=4`` site is its rows of the one-rank mask
  (exactly).

Loss and grad_norm to rtol 2e-5; params to rtol 2e-5 / atol 1e-6 (the
harness's ``hold``). Per-rank bytes of params and optimizer moments
equal the JAX state's shard bytes at the same mesh coordinate.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import numpy as np
import pytest

from _torch_sharded import (
    GPT,
    VIT,
    hold,
    hold_draws,
    hold_state_bytes,
    run_cases,
)
from frl_distributed_ml_scaffold_tpu_torch.models.dropout import keep_mask

DP2_TP2 = ["mesh.data=2", "mesh.fsdp=1", "mesh.model=2"]
ODD = ["model.vocab_size=509", "data.vocab_size=509"]
CASES = {
    "gpt_tp": ("gpt2_tp", GPT + DP2_TP2, True),
    "gpt_tp_odd": ("gpt2_tp", GPT + ODD + DP2_TP2, False),
    "gpt_dropout": ("gpt2_medium_zero1", GPT + DP2_TP2
                    + ["model.dropout=0.1"], False),
    "vit_tp_dropout": ("imagenet_vitb_fsdp", VIT + DP2_TP2 + [
        "parallel.param_sharding=replicated", "model.dropout=0.1"], False),
}
MASK = (3, 5, 7)  # each rank's rows of a data=4 site


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    extra = [{"name": "mask", "kind": "dropout_rows",
              "args": {"rate": 0.25, "seed": 11, "shape": MASK}}]
    return run_cases(CASES, tmp_path_factory.mktemp("tp"), extra)


def test_tp_step_matches_jax_step(runs):
    run = runs["gpt_tp"]
    hold_draws(run)
    hold(run, run["jax"]["metrics"], run["jax"]["params"], "gpt_tp vs jax")


@pytest.mark.parametrize("name", list(CASES))
def test_n_rank_step_matches_one_rank_step(runs, name):
    run = runs[name]
    hold(run, run["one"]["metrics"], run["one"]["params"],
         f"{name} vs one rank")


def test_tp_specs_and_uneven_vocab(runs):
    """Column / row splits over ``model``, ``wte`` split for storage and
    gathered whole for the forward, 255 + 254 rows of an odd vocab."""
    t = runs["gpt_tp"]["ranks"][0]["specs"]
    assert t["param"]["blocks.0.attn.query.weight"] == ("model", None)
    assert t["param"]["blocks.0.mlp.fc_out.weight"] == (None, "model")
    assert t["compute"]["blocks.0.attn.query.weight"] == ("model", None)
    assert t["param"]["wte.weight"] == ("model", None)
    assert t["compute"]["wte.weight"] == (None, None)
    rows = {r["coords"]["model"]: r["accum_shapes"]["wte.weight"][0]
            for r in runs["gpt_tp_odd"]["ranks"]}
    assert rows == {0: 509, 1: 509}  # the accumulator is the compute spec
    assert runs["gpt_tp_odd"]["one"]["params"]["wte.weight"].shape[0] == 509


def test_dropout_masks_are_rows_of_the_one_rank_masks(runs):
    full = keep_mask((4 * MASK[0], *MASK[1:]), 0.25, 11, 3, 1,
                     device="cpu").numpy()
    for r in runs["extra"]:
        i = r["mask"]["index"]
        np.testing.assert_array_equal(
            r["mask"]["mask"], full[i * MASK[0]:(i + 1) * MASK[0]])


def test_state_bytes_per_rank_match_jax(runs):
    hold_state_bytes(runs["gpt_tp"])
