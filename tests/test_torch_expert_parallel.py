"""The port's expert parallelism (``models/moe.py`` over the ``expert``
axis) on four gloo ranks (the harness: ``_torch_sharded.py``):
``gpt2_moe`` cut to 2 layers at width 64 (its 8 experts, top-2, kept),
fp32, on ``expert=4`` (einsum dispatch, auto groups), on ``data=2
expert=2`` (sort dispatch, two groups) and on ``fsdp=2 expert=2`` under
the blockwise FSDP gathers (``parallel.fsdp_overlap``), against the JAX step
on the same mesh and the port's one-rank step (losses, grad_norms and
params after 2 steps, rtol 2e-5 / atol 1e-6); each rank holds its
experts of ``wi`` / ``wo`` and its draws are its batch index's rows.

The gradients of step 0 at ``expert=4`` against JAX's of the same loss
on the same batch, every parameter to 2e-5: the router's kernel among
them pins what the aux loss must not do (its gradient, which every rank
computes whole, summed again over ``expert``).
"""

import _torch_threads  # noqa: F401  (before any torch op)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from _torch_sharded import GPT, hold, hold_draws, run_cases
from frl_distributed_ml_scaffold_tpu.dist.mesh import set_current_mesh
from frl_distributed_ml_scaffold_tpu.trainer import tasks as jtasks
from frl_distributed_ml_scaffold_tpu_torch.models import convert

EP4 = ["mesh.data=1", "mesh.fsdp=1", "mesh.expert=4"]
DP2_EP2 = ["mesh.data=2", "mesh.fsdp=1", "mesh.expert=2"]
FSDP2_EP2 = ["mesh.data=1", "mesh.fsdp=2", "mesh.expert=2"]
CASES = {
    "ep4": ("gpt2_moe", GPT + EP4, True),
    # Two explicit groups, one a batch shard (the one-rank step routes the
    # same two groups; auto groups would follow each mesh's batch shards).
    "dp2_ep2": ("gpt2_moe", GPT + DP2_EP2 + ["model.moe.dispatch=sort",
                                             "model.moe.num_groups=2"],
                True),
    # The experts split over expert and fsdp, gathered block by block by
    # the overlap schedule (the MoE leaves among each block's gathers).
    "fsdp2_ep2_overlap": ("gpt2_moe", GPT + FSDP2_EP2 + [
        "parallel.param_sharding=fsdp", "parallel.fsdp_overlap=true",
        "parallel.fsdp_min_size=1", "model.moe.num_groups=2"], True),
}
TOL = 2e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    extra = [{"name": "grads", "kind": "grads", "args": {
        "config": "gpt2_moe",
        "overrides": GPT + EP4 + ["precision.policy=fp32",
                                  f"trainer.init_params_path={tmp}/ep4.msgpack"]}}]
    return run_cases(CASES, tmp, extra_jobs=extra), tmp


@pytest.mark.parametrize("name", sorted(CASES))
def test_expert_parallel_step_matches_jax_and_one_rank(runs, name):
    run = runs[0][name]
    hold(run, run["jax"]["metrics"], run["jax"]["params"], f"{name} vs jax")
    hold(run, run["one"]["metrics"], run["one"]["params"], f"{name} vs one")
    hold_draws(run)
    for m in run["ranks"][0]["metrics"]:
        assert m["aux_loss"] > 0
    e = 4 if name == "ep4" else 2
    fsdp = "fsdp" if name.startswith("fsdp") else None
    for r in run["ranks"]:
        assert r["specs"]["param"]["blocks.0.moe.wi"] == ("expert", fsdp,
                                                           None)
        assert r["accum_shapes"]["blocks.0.moe.wi"] == (
            8 // e, 64 // (2 if fsdp else 1), 256)
        assert r["specs"]["param"]["blocks.0.moe.router.weight"][0] is None
    if fsdp:
        assert "blocks.0.moe.wi" in run["ranks"][0]["gathers"]["names"]


def test_router_gradient_at_expert4_matches_jax(runs):
    res, tmp = runs
    run = res["ep4"]
    jt = run["jax"]["trainer"]
    tcfg = run["one_cfg"]
    params = serialization.msgpack_restore(
        (tmp / "ep4.msgpack").read_bytes())
    batch = run["batches"][0]
    ga = tcfg.trainer.grad_accum
    loss_fn = jtasks.make_lm_loss(jt.model)
    set_current_mesh(jt.env)
    try:
        grad = jax.jit(jax.grad(lambda p, b: loss_fn(
            p, {}, b, jax.random.key(0), True)[0]))
        gs = [grad(params, {"tokens": jnp.asarray(mb)})
              for mb in np.array_split(batch["tokens"], ga)]
    finally:
        set_current_mesh(None)
    want = convert.params_from_jax(jax.device_get(
        jax.tree.map(lambda *g: sum(g) / ga, *gs)), tcfg.model)
    for r in res["extra"]:
        got = r["grads"]["grads"]
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w.numpy(), rtol=TOL,
                                       atol=1e-7, err_msg=k)
