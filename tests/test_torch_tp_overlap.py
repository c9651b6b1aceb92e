"""The port's tensor parallelism on the collective-matmul rings
(``parallel.tp_overlap``, ``parallel/tp_overlap.py``) over four gloo
ranks (the harness: ``_torch_sharded.py``):

- ``gpt2_medium_tp_overlap`` cut to 2 layers at width 64, on
  ``model=4`` and ``data=2 model=2``, against the JAX step on the same
  mesh and the port's one-rank step (losses, grad_norms and params
  after 2 steps to rtol 2e-5 / atol 1e-6);
- its ``_int8`` twin on ``model=4`` against the JAX int8 step
  (``_torch_sharded.py`` ``hold_int8``: the quantizers turn last-bit
  differences into whole quantization steps, in the JAX step too) and
  against the fp32 ring within the reference's bands (loss 5e-3
  relative, params 1e-2);
- a ViT (``imagenet_vitb_fsdp`` at ``TINY_VIT`` with
  ``parallel.tp_overlap=true``, the stream split over ``model`` along
  the batch) on ``fsdp=2 model=2`` against the JAX step and the
  one-rank step;
- training dropout (``model.dropout=0.1``) on the sharded stream, GPT
  on ``data=2 model=2`` and ViT on ``fsdp=2 model=2``, against the
  one-rank step: the masks do not depend on the mesh;
- the bytes the rings send per rank and step over ``model``, counted
  at the send by dtype, equal to the JAX step's census
  (``ring_ppermute_bytes(collective_census(jaxpr), "model")``: each
  ppermute's per-device payload times its trip count, which is what one
  rank sends in one step); the int8 ring moves at least 3x fewer bytes
  than the fp32 ring.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import jax
import numpy as np
import pytest

from _torch_sharded import (
    GPT,
    STEPS,
    VIT,
    hold,
    hold_draws,
    hold_int8,
    run_cases,
)
from frl_distributed_ml_scaffold_tpu.analysis.collectives import (
    collective_census,
)
from frl_distributed_ml_scaffold_tpu.analysis.schedule import (
    ring_ppermute_bytes,
)
from frl_distributed_ml_scaffold_tpu.dist.mesh import mesh_context

TP4 = ["mesh.data=1", "mesh.fsdp=1", "mesh.model=4"]
DP2_TP2 = ["mesh.data=2", "mesh.fsdp=1", "mesh.model=2"]
FSDP2_TP2 = ["mesh.data=1", "mesh.fsdp=2", "mesh.model=2"]
# remat none on model=4, so the rings run once each way (the census
# test); the recipe's dots remat on data=2 model=2.
NO_REMAT = ["trainer.remat=none"]
CASES = {
    "tp4": ("gpt2_medium_tp_overlap", GPT + TP4 + NO_REMAT, True),
    "tp4_int8": ("gpt2_medium_tp_overlap_int8", GPT + TP4 + NO_REMAT, True,
                 0),  # tp4's params
    "dp2_tp2": ("gpt2_medium_tp_overlap", GPT + DP2_TP2, True),
    "vit": ("imagenet_vitb_fsdp", VIT + FSDP2_TP2
            + ["parallel.tp_overlap=true"], True),
    # Training dropout on the sharded stream: each rank's masks are its
    # rows and tokens (its batch rows, for the ViT) of the one-rank masks.
    "gpt_dropout": ("gpt2_medium_tp_overlap", GPT + DP2_TP2 + NO_REMAT
                    + ["model.dropout=0.1"], False),
    "vit_dropout": ("imagenet_vitb_fsdp", VIT + FSDP2_TP2 + [
        "parallel.tp_overlap=true", "model.dropout=0.1"], False),
}
FP32 = ("tp4", "dp2_tp2", "vit")
DROPOUT = ("gpt_dropout", "vit_dropout")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("tpo"))


@pytest.mark.parametrize("name", FP32)
def test_overlap_step_matches_jax_step(runs, name):
    run = runs[name]
    hold_draws(run)
    hold(run, run["jax"]["metrics"], run["jax"]["params"], f"{name} vs jax")


def test_int8_step_matches_jax_int8_step(runs, tmp_path):
    hold_int8(runs["tp4_int8"], tmp_path)


@pytest.mark.parametrize("name", FP32 + DROPOUT)
def test_overlap_step_matches_one_rank_step(runs, name):
    run = runs[name]
    hold(run, run["one"]["metrics"], run["one"]["params"],
         f"{name} vs one rank")


def test_int8_ring_within_the_bands_of_the_fp32_ring(runs):
    """The reference's low-precision bands (tests/test_low_precision.py):
    losses within 5e-3 relative, params within 1e-2."""
    ref, lp = runs["tp4"]["ranks"][0], runs["tp4_int8"]["ranks"][0]
    for a, b in zip(ref["metrics"], lp["metrics"]):
        assert abs(a["loss"] - b["loss"]) <= 5e-3 * max(1.0, abs(a["loss"]))
    for k, w in ref["params"].items():
        np.testing.assert_allclose(lp["params"][k], w, atol=1e-2, rtol=1e-3,
                                   err_msg=k)
    assert ref["params"].keys() == lp["params"].keys()
    differ = any(not np.array_equal(lp["params"][k], w)
                 for k, w in ref["params"].items())
    assert differ  # the int8 ring is not the fp32 one


def _census_bytes(jt) -> int:
    state = jt.init_state()
    with mesh_context(jt.env):
        jaxpr = jax.make_jaxpr(jt._train_step_fn)(
            state, jt.pipeline.global_batch(0))
    return ring_ppermute_bytes(collective_census(jaxpr), "model")


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][2]])
def test_ring_bytes_equal_the_jax_census(runs, name):
    """Per rank and step: every rank sends the same bytes, the JAX
    census's ppermute bytes on ``model`` (the port counts the steps the
    test ran: divided by them). Under ``trainer.remat=dots`` (dp2_tp2)
    the reference saves the rings' products and replays their hops only,
    where the port's recompute replays every ring of the forward: one
    more gather ring a block and microbatch, ``fc_in``'s, whose outputs
    are all products (a stream pass: the microbatch's chunk of the
    stream, once a hop)."""
    run = runs[name]
    want = _census_bytes(run["jax"]["trainer"])
    sent = [sum(r["wire_bytes"]["model"].values()) for r in run["ranks"]]
    assert want > 0 and len(set(sent)) == 1
    if name == "dp2_tp2":
        cfg = run["one_cfg"]
        n, ga = 2, cfg.trainer.grad_accum
        rows = cfg.data.global_batch_size // (2 * ga)  # data=2
        chunk = rows * (cfg.model.seq_len // n) * cfg.model.hidden_dim * 4
        want += (n - 1) * chunk * cfg.model.num_layers * ga
    assert sent[0] == STEPS * want, (sent[0] / STEPS, want)


def test_int8_ring_moves_3x_fewer_bytes(runs):
    fp = runs["tp4"]["ranks"][0]["wire_bytes"]["model"]
    lp = runs["tp4_int8"]["ranks"][0]["wire_bytes"]["model"]
    assert set(fp) == {"float32"} and set(lp) == {"int8", "float32"}
    assert sum(fp.values()) >= 3 * sum(lp.values())
    # Only the scales travel wide: 4 bytes beside each int8 payload.
    assert lp["float32"] < lp["int8"] / 16
