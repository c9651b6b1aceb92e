"""The port's MoE MLP (``frl_distributed_ml_scaffold_tpu_torch/models/
moe.py``) and the MoE GPT against the JAX package's, on the CPU in fp32:

- ``MoEMlp`` against JAX ``MoEMlp`` on the same numpy input and the
  JAX init, both dispatches, at ample capacity (cf 8), at dropping
  capacity (cf 0.5) and grouped (``num_groups=2``): the seats and keep
  masks equal JAX's (its router's logits through ``lax.top_k`` and the
  slot-major cumsum), outputs, aux and the gradients of ``sum(y^2) +
  aux`` to 2e-5;
- top-k ties go to the lower expert, as ``lax.top_k`` puts them;
- the tiny MoE GPT through ``params_from_jax``: the LM loss with its
  ``aux_loss`` metric and the gradients of every parameter, under the
  dense head and ``lm_loss_chunk``, to 2e-5; ``params_to_jax`` gives
  the JAX tree back; ``init_params`` has the JAX shapes;
- ``generate`` and ``beam_search`` at ``num_groups=4`` with batch 2
  (the decode snap to ``gcd``) give the JAX tokens;
- the refusals: an unknown dispatch and a ``num_groups`` that does not
  divide the training batch (the JAX messages), a group across ranks,
  MoE under ``mesh.model > 1`` (in the partition rules and in a decode
  cache split over the batch axes, ROADMAP A12); MoE inside a pipeline
  builds and runs.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jit import jit_init
from _torch_parity import TINY

from frl_distributed_ml_scaffold_tpu.config.schema import GPTConfig as JGPTConfig
from frl_distributed_ml_scaffold_tpu.config.schema import MoEConfig as JMoEConfig
from frl_distributed_ml_scaffold_tpu.models import generation as jgen
from frl_distributed_ml_scaffold_tpu.models.gpt import GPT as JGPT
from frl_distributed_ml_scaffold_tpu.models.moe import MoEMlp as JMoEMlp
from frl_distributed_ml_scaffold_tpu.precision import get_policy as jpolicy
from frl_distributed_ml_scaffold_tpu.trainer import tasks as jtasks
from frl_distributed_ml_scaffold_tpu_torch.config import schema as tschema
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
    MeshEnv,
    mesh_context,
    rank_layout,
)
from frl_distributed_ml_scaffold_tpu_torch.models import convert
from frl_distributed_ml_scaffold_tpu_torch.models import generation as tgen
from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
from frl_distributed_ml_scaffold_tpu_torch.models.moe import (
    MoEMlp,
    local_groups,
    route,
)
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
from frl_distributed_ml_scaffold_tpu_torch.trainer import tasks as ttasks
from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import (
    model_partition_rules,
)

TOL = 2e-5
SMALL = dict(vocab_size=64, num_layers=1, num_heads=2, hidden_dim=32,
             seq_len=16)
CASES = {
    "ample": dict(num_experts=4, top_k=2, capacity_factor=8.0),
    "drops": dict(num_experts=4, top_k=2, capacity_factor=0.5),
    "grouped": dict(num_experts=4, top_k=2, capacity_factor=1.25,
                    num_groups=2),
}


def _cfgs(model: dict, moe: dict):
    return (JGPTConfig(**model, moe=JMoEConfig(**moe)),
            tschema.GPTConfig(**model, moe=tschema.MoEConfig(**moe)))


def _jax_seating(router_logits, k: int, capacity: int):
    """The reference's routing lines on its own router logits."""
    e = router_logits.shape[-1]
    probs = jax.nn.softmax(router_logits, axis=-1)
    _, gate_idx = jax.lax.top_k(probs, k)
    pos_toks, keeps = [], []
    prev = jnp.zeros((router_logits.shape[0], e), jnp.int32)
    for slot in range(k):
        onehot = jax.nn.one_hot(gate_idx[..., slot], e, dtype=jnp.int32)
        pos = jnp.cumsum(onehot, axis=1) - 1 + prev[:, None, :]
        prev = prev + onehot.sum(axis=1)
        pos_tok = (pos * onehot).sum(-1)
        pos_toks.append(np.asarray(pos_tok))
        keeps.append(np.asarray(pos_tok < capacity))
    return np.asarray(gate_idx), pos_toks, keeps


def _mlp_pair(case: str, dispatch: str, x):
    moe = dict(CASES[case], dispatch=dispatch)
    jcfg, tcfg = _cfgs(SMALL, moe)
    jm = JMoEMlp(jcfg, jnp.float32)
    variables = jax.jit(lambda v: jm.init(jax.random.key(1), v, train=True))(
        jnp.asarray(x))
    p = jax.device_get(variables["params"])
    tm = MoEMlp(tcfg, get_policy("fp32"), device="cpu")
    tm.load_state_dict({
        "router.weight": torch.from_numpy(np.asarray(p["router"]["kernel"]).T
                                          .copy()),
        "router.bias": torch.from_numpy(np.array(p["router"]["bias"])),
        "wi": torch.from_numpy(np.array(p["wi"])),
        "wo": torch.from_numpy(np.array(p["wo"]))})
    return jm, variables, tm, tcfg


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_mlp_matches_jax(case, dispatch):
    x = np.random.default_rng(0).standard_normal((2, 16, 32)).astype(
        np.float32)
    jm, variables, tm, tcfg = _mlp_pair(case, dispatch, x)

    def jloss(v, xx):
        y, aux = jm.apply(v, xx, train=True)
        return jnp.sum(y * y) + aux, (y, aux)

    (_, (jy, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(variables, jnp.asarray(x))
    _, inter = jax.jit(lambda v, xx: jm.apply(
        v, xx, train=True, capture_intermediates=True))(variables,
                                                        jnp.asarray(x))
    jlogits = inter["intermediates"]["router"]["__call__"][0]

    xt = torch.from_numpy(x).requires_grad_()
    ty, taux = tm(xt, train=True)
    (ty.square().sum() + taux).backward()
    np.testing.assert_allclose(ty.detach().numpy(), jy, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), rtol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), jgx, rtol=TOL, atol=TOL)
    jp = jg["params"]
    for name, want in (("router.weight", np.asarray(jp["router"]["kernel"]).T),
                       ("router.bias", jp["router"]["bias"]),
                       ("wi", jp["wi"]), ("wo", jp["wo"])):
        got = dict(tm.named_parameters())[name].grad.numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=name)

    # The seating: the port's routing of its own router logits against
    # the reference's of JAX's.
    moe = tcfg.moe
    g = local_groups(moe, 32, 2, True, 1)
    s = 32 // g
    capacity = max(1, int(moe.capacity_factor * s * moe.top_k
                          / moe.num_experts))
    with torch.no_grad():
        tlogits = torch.nn.functional.linear(
            xt.reshape(g, s, 32), tm.router.weight, tm.router.bias)
    np.testing.assert_allclose(tlogits.numpy(), jlogits, rtol=TOL, atol=TOL)
    _, _, tidx, tpos, tkeep, _ = route(tlogits, moe.top_k, capacity)
    jidx, jpos, jkeep = _jax_seating(jlogits, moe.top_k, capacity)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    for slot in range(moe.top_k):
        np.testing.assert_array_equal(tpos[slot].numpy(), jpos[slot])
        np.testing.assert_array_equal(tkeep[slot].numpy(), jkeep[slot])
    if case == "drops":
        assert not all(k.all() for k in jkeep)  # it really drops


def test_top_k_ties_go_to_the_lower_expert():
    logits = np.zeros((1, 4, 6), np.float32)
    logits[0, 1, [1, 4]] = 2.0
    logits[0, 2, [5, 0, 3]] = 1.0
    logits[0, 3] = [3, 1, 3, 1, 3, 0]
    probs = jax.nn.softmax(jnp.asarray(logits), -1)
    _, jidx = jax.lax.top_k(probs, 3)
    _, _, tidx, *_ = route(torch.from_numpy(logits), 3, 4)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


MOE_GPT = dict(num_experts=4, top_k=2, capacity_factor=1.25)


def _gpt_pair(moe: dict, policy: str = "fp32", **model):
    jcfg, tcfg = _cfgs({**TINY, **model}, moe)
    jmodel = JGPT(jcfg, jpolicy(policy))
    params = jax.device_get(jit_init(jmodel, jnp.zeros((1, 8), jnp.int32),
                                     train=False)["params"])
    tmodel = GPT(tcfg, get_policy(policy), device="cpu")
    tmodel.load_state_dict(convert.params_from_jax(params, tcfg))
    return jmodel, params, tmodel, tcfg


@pytest.mark.parametrize("dispatch,chunk", [("einsum", 0), ("sort", 32)])
def test_moe_gpt_loss_and_grads_match_jax(dispatch, chunk):
    jmodel, params, tmodel, tcfg = _gpt_pair(
        dict(MOE_GPT, dispatch=dispatch), lm_loss_chunk=chunk)
    tokens = np.random.default_rng(1).integers(
        0, TINY["vocab_size"], (4, 65)).astype(np.int32)
    jl = jtasks.make_lm_loss(jmodel)
    (jloss, (jm, _)), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jl(p, {}, b, None, False), has_aux=True))(
        params, {"tokens": jnp.asarray(tokens)})
    tparams = {k: v.detach().clone().requires_grad_()
               for k, v in tmodel.named_parameters()}
    tl = ttasks.make_lm_loss(tmodel)
    tloss, (tm, _) = tl(tparams, {}, {"tokens": torch.from_numpy(tokens)},
                        None, False)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=TOL)
    assert set(tm) == set(jm) == {"ce_loss", "perplexity", "aux_loss"}
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL)
    assert float(tm["aux_loss"]) > 0
    want = convert.params_from_jax(jax.device_get(jg), tcfg)
    for k, p in tparams.items():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=k)


def test_moe_params_convert_both_ways_and_init_has_jax_shapes():
    _, params, tmodel, tcfg = _gpt_pair(MOE_GPT)
    back = convert.params_to_jax(dict(tmodel.state_dict()), tcfg)
    flat_j = jax.tree_util.tree_leaves_with_path(params)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), back)))
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_t[path], leaf)
    sd = convert.init_params(tcfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    wi = sd["blocks.0.moe.wi"]
    assert abs(float(wi.std()) - 0.02) < 1e-3  # normal(0.02), as JAX


GROUPED = dict(MOE_GPT, num_groups=4)


def test_moe_generate_matches_jax_with_the_decode_snap():
    jmodel, params, tmodel, _ = _gpt_pair(GROUPED)
    prompt = np.random.default_rng(2).integers(
        1, TINY["vocab_size"], (2, 7)).astype(np.int32)
    jt = jgen.generate(jmodel, params, jnp.asarray(prompt), max_new_tokens=6,
                       temperature=0.0)
    tt = tgen.generate(tmodel, prompt, max_new_tokens=6, temperature=0.0,
                       device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_moe_beam_search_matches_jax():
    jmodel, params, tmodel, _ = _gpt_pair(GROUPED)
    prompt = np.random.default_rng(3).integers(
        1, TINY["vocab_size"], (2, 7)).astype(np.int32)
    jt, js = jgen.beam_search(jmodel, params, jnp.asarray(prompt),
                              max_new_tokens=5, num_beams=3)
    tt, ts = tgen.beam_search(tmodel, prompt, max_new_tokens=5, num_beams=3,
                              device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5)


def test_moe_refusals():
    x = torch.zeros((2, 16, 32))
    _, tcfg = _cfgs(SMALL, dict(MOE_GPT, dispatch="bogus"))
    with pytest.raises(ValueError, match="expected 'einsum' or 'sort'"):
        MoEMlp(tcfg, get_policy("fp32"), device="cpu")(x, train=True)
    _, tcfg = _cfgs(SMALL, dict(MOE_GPT, num_groups=3))
    with pytest.raises(ValueError, match="does not divide the training "
                       "batch dim b=2"):
        MoEMlp(tcfg, get_policy("fp32"), device="cpu")(x, train=True)
    # Decode snaps to gcd instead (n = 2 tokens, 3 groups -> 1).
    MoEMlp(tcfg, get_policy("fp32"), device="cpu")(x[:, :1], train=False)
    # Two batch shards with one explicit group: a group across ranks.
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        local_groups(tschema.MoEConfig(num_experts=4, num_groups=1), 32, 2,
                     True, 2)
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        local_groups(tcfg.moe, 32, 2, True, 1, seq_split=True)
    mesh = tschema.MeshConfig(data=1, model=2, expert=2)
    env = MeshEnv(config=mesh, ranks=rank_layout(mesh, 4), rank=0)
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        model_partition_rules(tcfg, env)
    # MoE inside a pipeline builds and runs (its aux averaged over the
    # microbatches, tests/test_torch_pp_model.py holds it against JAX).
    pp = GPT(dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, num_groups=0), pipeline_stages=2, num_layers=2),
        get_policy("fp32"), device="cpu")
    with torch.no_grad():
        logits, aux = pp(torch.zeros((2, 8), dtype=torch.long))
    assert logits.shape == (2, 8, tcfg.vocab_size)
    assert torch.isfinite(logits).all() and float(aux) > 0
    # Heads split over model would split the decode cache's rows over
    # data: refused before any rank decodes its rows.
    model = GPT(tcfg, get_policy("fp32"), device="cpu")
    model.local_heads = lambda: 1
    mesh = tschema.MeshConfig(data=2, model=2)
    env = MeshEnv(config=mesh, ranks=rank_layout(mesh, 4), rank=0)
    with mesh_context(env):
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            model.cache_rows(4)
