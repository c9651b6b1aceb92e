"""The port's pipelined GPT in one process (``mesh.pipe == 1``: every
stage here, the handoffs in memory) against the JAX ``GPT`` with
``pipeline_stages > 1`` on the same params, fp32, 4 layers at width 32,
T 16:

- logits and every gradient of ``sum(logits * w)``, through the model's
  forward and through the schedule's forward and reverse ticks (the
  Trainer's path), to rtol 1e-5 of each tensor's largest value, plus atol 1e-6 (``hold``: the wpe gradient sums
  every row's stream gradient, ~1e2, whose elements cancel, so the
  order of the sums moves single elements by 1e-4 of themselves; the
  exact-zero ``attn.key.bias`` gradients are rounding noise of ~1e-8
  in both, ROADMAP C.7) for GPipe (S=2, M in {2, 4}; S=4, M=4),
  the circular schedule (S=2, v=2, M in {2, 4}) and
  ``pipeline_stage_remat`` on both; the circular schedule's M < S
  refusal with the JAX message;
- the MoE aux: equal to JAX's pipelined aux, and of the plain model's
  scale whatever M (``test_pp_moe_aux_loss_batch_invariant``);
- ``params_from_jax`` and ``params_to_jax`` inverse on the plain, GPipe,
  circular and MPMD layouts; ``mpmd_stage_params`` and its inverses;
- ``bubble_fraction``, ``peak_live_activations``, ``stage_peak_live``,
  ``effective_microbatches``, ``circular_repeat`` and
  ``pipeline_summary`` equal to the JAX functions over a grid;
- ``generate`` on pipelined params (MPMD-staged and merged, circular)
  gives the plain model's tokens (``test_mpmd_params_generate_like_plain``),
  and a direct decode call on a pipelined model raises the JAX message;
- two steps of the one-process pipelined ``Trainer`` (GPipe under
  ``grad_accum=2`` and ``trainer.remat=full``; circular under stage
  remat) against the JAX Trainer, loss and grad_norm to rtol 2e-5 and
  params to rtol 2e-5 / atol 1e-6 (``_torch_sharded.py`` ``hold_params``:
  the exact-zero ``attn.key.bias`` gradients to Adam's bound).
"""

import _torch_threads  # noqa: F401  (before any torch op)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _jit import jit_init
from _torch_parity import recipe_pair
from _torch_pp import jax_devices
from _torch_sharded import _random_params, hold_params
from frl_distributed_ml_scaffold_tpu.config.schema import GPTConfig as JCfg
from frl_distributed_ml_scaffold_tpu.config.schema import MoEConfig as JMoE
from frl_distributed_ml_scaffold_tpu.dist.mesh import build_mesh as jbuild
from frl_distributed_ml_scaffold_tpu.models.gpt import GPT as JGPT
from frl_distributed_ml_scaffold_tpu.parallel import mpmd_pipeline as jmpmd
from frl_distributed_ml_scaffold_tpu.parallel import pipeline as jpipe
from frl_distributed_ml_scaffold_tpu.precision import get_policy as jpolicy
from frl_distributed_ml_scaffold_tpu.trainer.loop import Trainer as JaxTrainer
from frl_distributed_ml_scaffold_tpu_torch.config.schema import GPTConfig
from frl_distributed_ml_scaffold_tpu_torch.config.schema import MoEConfig
from frl_distributed_ml_scaffold_tpu_torch.models import convert
from frl_distributed_ml_scaffold_tpu_torch.models import generation as tgen
from frl_distributed_ml_scaffold_tpu_torch.models.gpt import (
    GPT,
    mpmd_merge_params,
    mpmd_stage_params,
    unstack_pipeline_params,
)
from frl_distributed_ml_scaffold_tpu_torch.parallel import mpmd_pipeline
from frl_distributed_ml_scaffold_tpu_torch.parallel import pipeline
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

TINY = dict(vocab_size=128, num_layers=4, num_heads=2, hidden_dim=32,
            seq_len=16)
RTOL, ATOL = 1e-5, 1e-6


def _pair(moe: int = 0, **pp):
    jcfg = JCfg(**TINY, **pp, **({"moe": JMoE(num_experts=moe)}
                                 if moe else {}))
    tcfg = GPTConfig(**TINY, **pp, **({"moe": MoEConfig(num_experts=moe)}
                                      if moe else {}))
    return jcfg, tcfg


def _tokens(seed=0, b=8):
    rng = np.random.default_rng(seed)
    return rng.integers(0, TINY["vocab_size"], (b, 16)).astype(np.int32)


def _jax_params(jcfg, tokens, seed=0):
    model = JGPT(jcfg, jpolicy("fp32"))
    return jax.device_get(jit_init(model, jnp.asarray(tokens),
                                   rng=jax.random.key(seed),
                                   train=False)["params"])


def hold(got, want, what: str):
    """``max |got - want| <= RTOL * max |want| + ATOL``."""
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    assert err <= RTOL * float(np.abs(want).max()) + ATOL, (what, err)


def _port(tcfg, params):
    model = GPT(tcfg, get_policy("fp32"), device="cpu")
    model.load_state_dict(convert.params_from_jax(params, tcfg))
    return model


SCHEDULES = {
    "gpipe_s2_m2": dict(pipeline_stages=2, pipeline_microbatches=2),
    "gpipe_s2_m4": dict(pipeline_stages=2, pipeline_microbatches=4),
    "gpipe_s4_m4": dict(pipeline_stages=4, pipeline_microbatches=4),
    "circular_m2": dict(pipeline_stages=2, pipeline_microbatches=2,
                        pipeline_circular_repeat=2),
    "circular_m4": dict(pipeline_stages=2, pipeline_microbatches=4,
                        pipeline_circular_repeat=2),
    "gpipe_stage_remat": dict(pipeline_stages=2, pipeline_microbatches=4,
                              pipeline_stage_remat=True),
    "circular_stage_remat": dict(pipeline_stages=2, pipeline_microbatches=4,
                                 pipeline_circular_repeat=2,
                                 pipeline_stage_remat=True),
}


def _schedule_grads(model, tokens, w):
    """Logits and gradients of ``sum(logits * w)`` through the schedule
    the Trainer runs (``SpmdSchedule`` with ``keep``: the forward ticks,
    each microbatch's head differentiated as it emerges, then the
    reverse ticks), every stage in this process."""
    cfg = model.config
    sched = pipeline.SpmdSchedule(model)
    m = sched.tl.m
    params = {k: p.detach().requires_grad_()
              for k, p in model.named_parameters()}
    acc = {k: torch.zeros_like(p) for k, p in params.items()}
    ws = torch.from_numpy(w).chunk(m)
    logits, cots = {}, {}

    def head(i, y):
        def loss(feats, emb, wm):
            out = feats @ emb.T
            logits[i] = out.detach()
            return (out * wm).sum()

        _, cots[i], _ = pipeline.head_grads(params, y, ws[i], cfg, loss, acc)

    sched.forward(params, list(torch.from_numpy(tokens).chunk(m)),
                  [None] * m, True, head, keep=True)
    sched.backward(params, cots, acc)
    return torch.cat([logits[i] for i in range(m)]), acc


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_logits_and_grads_match_jax(name):
    """The model's pipelined forward (differentiated whole) and the
    schedule's own forward and reverse ticks, each against JAX."""
    jcfg, tcfg = _pair(**SCHEDULES[name])
    tokens = _tokens()
    params = _jax_params(jcfg, tokens)
    w = np.random.default_rng(1).standard_normal(
        (8, 16, TINY["vocab_size"])).astype(np.float32)
    jm = JGPT(jcfg, jpolicy("fp32"))

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(tokens))
        return jnp.sum(out * w), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    model = _port(tcfg, params)
    out = model(torch.from_numpy(tokens))
    (out * torch.from_numpy(w)).sum().backward()
    hold(out.detach().numpy(), jout, "logits")
    want = convert.params_from_jax(jax.device_get(jg), tcfg)
    for k, p in model.named_parameters():
        hold(p.grad.numpy(), want[k].numpy(), k)
    logits, grads = _schedule_grads(model, tokens, w)
    hold(logits.numpy(), jout, "schedule logits")
    assert grads.keys() == want.keys()
    for k, g in grads.items():
        hold(g.numpy(), want[k].numpy(), f"schedule {k}")


def test_circular_needs_enough_microbatches():
    jcfg, tcfg = _pair(pipeline_stages=2, pipeline_microbatches=1,
                       pipeline_circular_repeat=2)
    tokens = _tokens()
    with pytest.raises(ValueError) as jerr:
        _jax_params(jcfg, tokens)
    plain = GPT(dataclasses.replace(tcfg, pipeline_stages=1),
                get_policy("fp32"), device="cpu")
    model = GPT(dataclasses.replace(tcfg, pipeline_microbatches=2),
                get_policy("fp32"), device="cpu")
    model.load_state_dict(plain.state_dict())
    model.config = tcfg
    with pytest.raises(ValueError) as terr:
        model(torch.from_numpy(tokens))
    assert str(terr.value) == str(jerr.value)
    assert "microbatches >= stages (1 < 2)" in str(terr.value)


def test_moe_aux_matches_jax_and_is_invariant_in_m():
    base_j, base_t = _pair(moe=4)
    tokens = _tokens(3)
    params = _jax_params(base_j, tokens)
    with torch.no_grad():
        _, aux_plain = _port(base_t, params)(torch.from_numpy(tokens))
    assert float(aux_plain) > 0
    for m in (2, 4):
        jcfg, tcfg = _pair(moe=4, pipeline_stages=2, pipeline_microbatches=m)
        jparams = convert.params_to_jax(convert.params_from_jax(
            params, base_t), tcfg)
        jparams = jax.tree.map(lambda t: t.numpy(), jparams)
        _, jaux = jax.jit(JGPT(jcfg, jpolicy("fp32")).apply)(
            {"params": jparams}, jnp.asarray(tokens))
        with torch.no_grad():
            _, aux = _port(tcfg, jparams)(torch.from_numpy(tokens))
        np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)
        ratio = float(aux) / float(aux_plain)
        assert 0.5 < ratio < 2.0, (m, ratio)


@pytest.mark.parametrize("layout", ["plain", "gpipe", "circular", "mpmd"])
def test_params_round_trip_every_layout(layout):
    pp = {"plain": {}, "gpipe": dict(pipeline_stages=2),
          "circular": dict(pipeline_stages=2, pipeline_circular_repeat=2),
          "mpmd": dict(pipeline_stages=2, pipeline_impl="mpmd")}[layout]
    jcfg, tcfg = _pair(**pp)
    if layout == "mpmd":  # the JAX MPMD state: the plain tree sliced
        from frl_distributed_ml_scaffold_tpu.models.gpt import (
            mpmd_stage_params as jstage,
        )

        plain = _jax_params(dataclasses.replace(jcfg, pipeline_stages=1),
                            _tokens())
        tree = jax.device_get(jstage(jcfg, plain, 2))
    else:
        tree = _jax_params(jcfg, _tokens())
    sd = convert.params_from_jax(tree, tcfg)
    assert sd.keys() == dict(GPT(tcfg, get_policy("fp32"),
                                 device="meta").named_parameters()).keys()
    back = convert.params_to_jax(sd, tcfg)
    assert jax.tree.structure(jax.tree.map(np.asarray, back)) == \
        jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    again = convert.params_from_jax(back, tcfg)
    for k, v in sd.items():
        torch.testing.assert_close(again[k], v, rtol=0, atol=0)


def test_stage_params_round_trip():
    _, tcfg = _pair(pipeline_stages=2, pipeline_impl="mpmd")
    sd = dict(GPT(dataclasses.replace(tcfg, pipeline_stages=1),
                  get_policy("fp32"), device="cpu").state_dict())
    staged = mpmd_stage_params(tcfg, sd, 2)
    assert {"wte.weight", "wpe"} <= staged["stage_0"].keys()
    assert "ln_f.weight" in staged["stage_1"]
    assert "wte.weight" not in staged["stage_1"]
    assert {int(k.split(".")[1]) for k in staged["stage_1"]
            if k.startswith("blocks.")} == {2, 3}
    for merged in (mpmd_merge_params(tcfg, staged),
                   unstack_pipeline_params(tcfg, staged)):
        assert merged.keys() == sd.keys()
        assert all(merged[k] is v for k, v in sd.items())
    with pytest.raises(ValueError, match="PLAIN"):
        mpmd_stage_params(tcfg, staged, 2)


def test_schedule_model_matches_jax():
    for s in (2, 3, 4):
        for m in (1, 2, 4, 8, 12):
            for sched in ("gpipe", "1f1b"):
                assert (mpmd_pipeline.bubble_fraction(sched, s, m)
                        == jmpmd.bubble_fraction(sched, s, m))
                assert (mpmd_pipeline.peak_live_activations(sched, s, m)
                        == jmpmd.peak_live_activations(sched, s, m))
            assert ([mpmd_pipeline.stage_peak_live(j, s, m)
                     for j in range(s)]
                    == [jmpmd.stage_peak_live(j, s, m) for j in range(s)])
            for v in (1, 2):
                for impl in ("spmd", "mpmd"):
                    for remat in (False, True):
                        kw = dict(pipeline_stages=s, pipeline_microbatches=m,
                                  pipeline_circular_repeat=v,
                                  pipeline_impl=impl,
                                  pipeline_stage_remat=remat)
                        jc, tc = _pair(**kw)
                        assert (pipeline.pipeline_summary(tc)
                                == jpipe.pipeline_summary(jc))
                        assert (pipeline.effective_microbatches(tc)
                                == jpipe.effective_microbatches(jc))
                        assert (pipeline.circular_repeat(tc)
                                == jpipe.circular_repeat(jc))
    _, plain = _pair()
    assert pipeline.pipeline_summary(plain) is None
    with pytest.raises(KeyError, match="schedule"):
        mpmd_pipeline.bubble_fraction("interleaved", 2, 4)


def test_timeline_is_the_jax_scan():
    """The ticks, the valid mask (JAX: ``(t - j >= 0) & (t - j < vM)``)
    and the parking FIFO's slots."""
    for s, m, v in ((2, 2, 1), (4, 8, 1), (2, 4, 2), (4, 4, 2)):
        tl = pipeline.Timeline(s, m, v)
        assert tl.ticks == v * m + s - 1
        t = np.arange(tl.ticks)[:, None]
        j = np.arange(s)[None, :]
        valid = [[tl.work(tt, jj) is not None for jj in range(s)]
                 for tt in range(tl.ticks)]
        assert np.array_equal(np.asarray(valid),
                              (t - j >= 0) & (t - j < v * m))
        assert tl.qlen == m - s + 1


def test_circular_parking_fifo_holds_m_minus_s_plus_1():
    _, tcfg = _pair(pipeline_stages=2, pipeline_microbatches=4,
                    pipeline_circular_repeat=2)
    model = GPT(tcfg, get_policy("fp32"), device="cpu")
    sched = pipeline.SpmdSchedule(model)
    with torch.no_grad():
        sched.forward(dict(model.named_parameters()),
                      list(torch.from_numpy(_tokens()).chunk(4)),
                      [None] * 4, False, lambda m, y: None)
    assert sched.peak_parked == 3


def test_generate_on_pipelined_params_is_the_plain_models():
    """(The plain model's tokens are the JAX package's:
    test_torch_gpt.py.)"""
    jcfg, tcfg = _pair()
    tokens = _tokens(1, b=2)
    plain = _port(tcfg, _jax_params(jcfg, tokens))
    prompt = tokens[:, :5]
    want = tgen.generate(plain, prompt, max_new_tokens=4, temperature=0.0,
                         device="cpu")
    for pp in (dict(pipeline_stages=2, pipeline_impl="mpmd"),
               dict(pipeline_stages=2, pipeline_circular_repeat=2)):
        model = GPT(dataclasses.replace(tcfg, **pp), get_policy("fp32"),
                    device="cpu")
        model.load_state_dict(mpmd_merge_params(tcfg, mpmd_stage_params(
            tcfg, plain.state_dict(), 2)))
        got = tgen.generate(model, prompt, max_new_tokens=4,
                            temperature=0.0, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        with pytest.raises(NotImplementedError, match="plain layer stack"):
            model(torch.from_numpy(prompt), model.init_cache(2, 16))


TRAIN = ["model.num_layers=4", "model.hidden_dim=32", "model.num_heads=2",
         "model.seq_len=16", "data.seq_len=16", "data.global_batch_size=8",
         "model.vocab_size=128", "data.vocab_size=128",
         "precision.policy=fp32", "optimizer.warmup_steps=1",
         "trainer.total_steps=10", "mesh.pipe=1", "mesh.data=1",
         "model.pipeline_stages=2"]


@pytest.mark.parametrize("recipe,extra", [
    ("gpt2_pp", ["model.pipeline_microbatches=2", "trainer.grad_accum=2",
                 "trainer.remat=full"]),
    ("gpt2_pp_circular", ["model.pipeline_microbatches=4",
                          "model.pipeline_stage_remat=true"]),
], ids=["gpipe_accum_remat", "circular_stage_remat"])
def test_one_process_trainer_matches_jax_trainer(tmp_path, recipe, extra):
    path = tmp_path / "params.msgpack"
    ov = TRAIN + extra + [f"trainer.init_params_path={path}"]
    jcfg, tcfg = recipe_pair(recipe, ov)
    jt = JaxTrainer(jcfg, mesh_env=jbuild(jcfg.mesh,
                                          devices=jax_devices(jcfg)))
    path.write_bytes(serialization.to_bytes(
        _random_params(jt.state_shapes.params, 0)))
    jstate = jt.init_state()
    trainer = Trainer(tcfg, device="cpu")
    state = trainer.init_state()
    for step in range(2):
        batch = {k: v.numpy() for k, v in
                 trainer.pipeline.global_batch(step).items()}
        jstate, jm = jt.train_step(jstate, batch)
        state, m = trainer.train_step(state, batch)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=2e-5,
                                       err_msg=f"step {step} {k}")
    want = convert.params_from_jax(jax.device_get(jstate.params), tcfg.model)
    hold_params({k: v.numpy() for k, v in state.params.items()},
                {k: v.numpy() for k, v in want.items()},
                sum(trainer.schedule(c) for c in range(2)), recipe)


@pytest.mark.parametrize("name", ["gpt2_pp", "gpt2_pp_circular",
                                  "gpt2_pipeline_mpmd"])
def test_pipeline_recipes_match_jax(name):
    """Each pipeline recipe, as published and under overrides, section by
    section the JAX recipe (``test_torch_gpt.py``
    ``test_recipes_and_overrides_match_jax`` holds the others)."""
    from frl_distributed_ml_scaffold_tpu_torch import config as tconfig

    for ov in ([], ["model.num_layers=8", "model.pipeline_microbatches=4",
                    "mesh.pipe=2", "model.pipeline_stages=2",
                    "precision.policy=fp32", "trainer.remat=full"]):
        j, t = recipe_pair(name, ov)
        assert t.name == j.name == name
        for section in ("model", "precision", "serving", "data", "trainer",
                        "optimizer", "mesh", "parallel", "checkpoint"):
            assert dataclasses.asdict(getattr(t, section)) == (
                dataclasses.asdict(getattr(j, section))), (name, section)
    assert name in tconfig.list_configs()


def test_stage_programs_chain_to_the_plain_features():
    """``GptStage`` as the MPMD stage program: stage 0 (the embedding
    and its layers), then each stage's layers, ``ln_f`` on the last,
    chained, give the plain model's ``ln_f`` features (no head), each
    stage loaded with its ``mpmd_stage_params`` slice."""
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GptStage

    jcfg, tcfg = _pair()
    tokens = _tokens()
    plain = _port(tcfg, _jax_params(jcfg, tokens))
    pp = dataclasses.replace(tcfg, pipeline_stages=2, pipeline_impl="mpmd")
    staged = mpmd_stage_params(pp, plain.state_dict(), 2)
    x = torch.from_numpy(tokens)
    with torch.no_grad():
        for j in range(2):
            stage = GptStage(pp, get_policy("fp32"), j, embed=j == 0,
                             final=j == 1, device="cpu")
            stage.load_state_dict(staged[f"stage_{j}"])
            x = stage(x)
        want = plain(torch.from_numpy(tokens), return_features=True)
    hold(x.numpy(), want.numpy(), "features")
