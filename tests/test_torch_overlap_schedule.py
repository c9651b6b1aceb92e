"""The port's overlap schedule (``parallel/schedule.py``) against the
JAX package's: the parser, ``render`` / ``short`` / ``describe``, the
derivation from the knobs, and every ``ScheduleError`` (its words and
its ``attribute``) and refusal of the schedule's checks
(``validate_schedule_config``, ``make_tp_hooks``'s mesh checks), word
for word; the hooks a knob spelling and the declared string build are
the same, and four gloo ranks train the composed int8 recipe to the
same bits under either spelling (program identity).
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import dataclasses
import importlib

import jax
import numpy as np
import pytest

from _torch_parity import recipe_pair
from _torch_ranks import spawn_ranks
from _torch_sharded import GPT, TINY_VIT
from frl_distributed_ml_scaffold_tpu.dist import mesh as jmesh
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
    MeshEnv,
    rank_layout,
)
from frl_distributed_ml_scaffold_tpu_torch.parallel import schedule as ts
from frl_distributed_ml_scaffold_tpu_torch.parallel import tp_overlap as ttpo

js = importlib.import_module("frl_distributed_ml_scaffold_tpu.parallel.schedule")
jtpo = importlib.import_module(
    "frl_distributed_ml_scaffold_tpu.parallel.tp_overlap")

COMPOSED = ("gather(fsdp,block,prefetch=1)+scatter(fsdp)"
            "+gather(model,ring_chunk,lowp=int8)+scatter(model,lowp=int8)")
DECLS = [
    "gather(fsdp, block, prefetch=2) + scatter(fsdp) "
    "+ gather(model, ring_chunk, lowp=int8) + scatter(model, lowp=int8)",
    "gather(fsdp,block,prefetch=0)+scatter(fsdp,reduce=sum)",
    "gather(model,ring_chunk)+scatter(model)",
    "gather(model,granularity=ring_chunk,lowp=fp8_e5m2)"
    "+scatter(model,lowp=fp8_e5m2)",
    "gather(fsdp)",
    COMPOSED,
]


@pytest.mark.parametrize("decl", DECLS)
def test_parse_render_short_describe_match_jax(decl):
    t, j = ts.parse_schedule(decl), js.parse_schedule(decl)
    assert t.render() == j.render()
    assert t.short() == j.short()
    assert t.describe() == j.describe()
    assert ts.parse_schedule(t.render()) == t
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def _errors(mod):
    """Each refusal case of the schedule's grammar and structure, as
    (exception type, message, attribute)."""
    cases = [
        lambda: mod.gather("fsdp", granularity="rings"),
        lambda: mod.gather("fsdp", prefetch=-1),
        lambda: mod.gather("fsdp", granularity="block", lowp="int8"),
        lambda: mod.gather("model", granularity="ring_chunk", prefetch=2),
        lambda: mod.scatter("fsdp", reduce="max"),
        lambda: mod.OverlapSchedule.build(
            mod.gather("model", granularity="block"), mod.scatter("model")),
        lambda: mod.OverlapSchedule.build(
            mod.gather("fsdp", granularity="ring_chunk")),
        lambda: mod.OverlapSchedule.build(mod.scatter("fsdp")),
        lambda: mod.OverlapSchedule.build(
            mod.gather("model", granularity="ring_chunk", lowp="int8"),
            mod.scatter("model")),
        lambda: mod.OverlapSchedule.build(mod.gather("fsdp"),
                                          mod.gather("fsdp")),
        lambda: mod.OverlapSchedule.build("gather(fsdp)"),
        lambda: mod.parse_schedule(""),
        lambda: mod.parse_schedule("gather[fsdp]"),
        lambda: mod.parse_schedule("gather()"),
        lambda: mod.parse_schedule("gather(fsdp,prefetch=1,block)"),
        lambda: mod.parse_schedule("gather(fsdp,block,extra)"),
        lambda: mod.parse_schedule("gather(fsdp,depth=2)"),
        lambda: mod.parse_schedule("gather(fsdp,prefetch=x)"),
        lambda: mod.parse_schedule("scatter(fsdp,block)"),
        lambda: mod.parse_schedule("gather(fsdp)+scatter(fsdp,depth=1)"),
        lambda: mod.parse_schedule(
            "gather(model,ring_chunk,lowp=int4)+scatter(model)"),
    ]
    out = []
    for case in cases:
        with pytest.raises(Exception) as e:
            case()
        out.append((type(e.value).__name__, str(e.value),
                    getattr(e.value, "attribute", None)))
    return out


def test_schedule_errors_match_jax_word_for_word():
    got, want = _errors(ts), _errors(js)
    assert got == want
    assert {a for _, _, a in got} >= {"granularity", "prefetch", "lowp",
                                      "reduce", "axis", "schedule"}


def _config_errors(pair):
    """Each knob / declaration contradiction and config refusal, by the
    package's own ``schedule_from_config`` / ``validate_schedule_config``."""
    cases = [
        ("gpt2_medium_zero1", ["parallel.low_precision=int8"]),
        ("gpt2_medium_tp_overlap",
         ["parallel.schedule=gather(fsdp,block)+scatter(fsdp)"]),
        ("gpt2_medium_fsdp_overlap",
         ["parallel.schedule=gather(model,ring_chunk)+scatter(model)"]),
        ("gpt2_medium_zero1", [
            "parallel.low_precision=int8",
            "parallel.schedule=gather(model,ring_chunk,lowp=fp8_e4m3)"
            "+scatter(model,lowp=fp8_e4m3)"]),
        ("gpt2_medium_zero1", [
            "parallel.low_precision=int8",
            "parallel.schedule=gather(fsdp,block)+scatter(fsdp)",
            "parallel.param_sharding=fsdp"]),
        ("gpt2_medium_fsdp_overlap", GPT + ["parallel.fsdp_prefetch=3"]),
        ("gpt2_medium_fsdp_overlap", ["parallel.param_sharding=replicated"]),
        ("gpt2_medium_fsdp_overlap", ["parallel.fsdp_prefetch=-1"]),
        ("imagenet_vitb_fsdp", TINY_VIT + ["parallel.fsdp_overlap=true"]),
        ("mnist_mlp", ["parallel.tp_overlap=true"]),
        ("gpt2_medium_tp_overlap", ["parallel.sequence=ring"]),
        ("gpt2_medium_tp_overlap", ["model.attention=ring"]),
        ("gpt2_medium_tp_overlap", ["model.pipeline_stages=2"]),
        ("gpt2_medium_tp_overlap", ["model.moe.num_experts=4"]),
        ("imagenet_rn50_ddp", ["parallel.param_sharding=fsdp",
                               "parallel.fsdp_overlap=true",
                               "model.depth=10",
                               "parallel.fsdp_prefetch=5"]),
    ]
    out = []
    for name, ov in cases:
        cfg = recipe_pair(name, ov)[pair]
        mod = js if pair == 0 else ts
        with pytest.raises(Exception) as e:
            sched = mod.schedule_from_config(cfg)
            mod.validate_schedule_config(sched, cfg)
        out.append((type(e.value).__name__, str(e.value),
                    getattr(e.value, "attribute", None)))
    return out


def test_config_refusals_match_jax_word_for_word():
    assert _config_errors(1) == _config_errors(0)


@pytest.mark.parametrize("name", [
    "gpt2_medium_fsdp_overlap", "gpt2_medium_tp_overlap",
    "gpt2_medium_tp_overlap_int8", "gpt2_medium_fsdp_tp_overlap",
    "gpt2_medium_fsdp_tp_overlap_int8", "gpt2_medium_zero1", "gpt2_tp"])
def test_recipes_derive_the_jax_schedule(name):
    jcfg, tcfg = recipe_pair(name, [])
    j, t = js.schedule_from_config(jcfg), ts.schedule_from_config(tcfg)
    assert (t is None) == (j is None)
    if t is not None:
        assert t.describe() == j.describe()
        ts.validate_schedule_config(t, tcfg)
    assert ts.model_block_count(tcfg.model) == js.model_block_count(jcfg.model)


def _envs(mesh: dict):
    from frl_distributed_ml_scaffold_tpu.config.schema import MeshConfig as JM
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
        MeshConfig as TM,
    )

    jenv = jmesh.build_mesh(JM(**mesh), devices=jax.devices()[:4])
    tenv = MeshEnv(config=TM(**mesh), ranks=rank_layout(TM(**mesh), 4))
    return jenv, tenv


MESH_CASES = [
    ("gpt2_medium_tp_overlap", GPT, {"data": 4, "model": 1}),
    ("gpt2_medium_tp_overlap", GPT + ["model.hidden_dim=66",
                                      "model.num_heads=6"],
     {"data": 1, "model": 4}),
    ("gpt2_medium_tp_overlap", GPT + ["model.seq_len=30", "data.seq_len=30"],
     {"data": 1, "model": 4}),
    ("imagenet_vitb_fsdp", TINY_VIT + ["parallel.tp_overlap=true",
                                       "data.global_batch_size=6"],
     {"data": 1, "fsdp": 2, "model": 2}),
]


def test_mesh_refusals_match_jax_word_for_word():
    for name, ov, mesh in MESH_CASES:
        jcfg, tcfg = recipe_pair(name, ov)
        jenv, tenv = _envs(mesh)
        with pytest.raises(ValueError) as je:
            jtpo.make_tp_hooks(jcfg, jenv)
        with pytest.raises(ValueError) as te:
            ttpo.make_tp_hooks(tcfg, tenv)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name,ov,mesh,chunk", [
    ("gpt2_medium_tp_overlap_int8", GPT, {"data": 1, "model": 4}, 1),
    ("imagenet_vitb_fsdp", TINY_VIT + ["parallel.tp_overlap=true",
                                       "data.global_batch_size=8"],
     {"data": 1, "fsdp": 2, "model": 2}, 0),
])
def test_tp_hooks_match_jax(name, ov, mesh, chunk):
    jcfg, tcfg = recipe_pair(name, ov)
    jenv, tenv = _envs(mesh)
    j, t = jtpo.make_tp_hooks(jcfg, jenv), ttpo.make_tp_hooks(tcfg, tenv)
    assert (t.axis, t.chunk_axis, t.lowp) == (j.axis, j.chunk_axis, j.lowp)
    assert t.chunk_axis == chunk


KNOBS = GPT + ["mesh.data=1", "mesh.fsdp=2", "mesh.model=2"]


def test_declared_string_is_program_identical_to_the_knobs(tmp_path):
    """The composed int8 recipe by its knobs and by ``parallel.schedule``
    (the knobs off): the same hooks, and on four gloo ranks the same
    losses, grad_norms and params, bit for bit."""
    knobs = recipe_pair("gpt2_medium_fsdp_tp_overlap_int8", KNOBS)[1]
    declared = ["parallel.fsdp_overlap=false", "parallel.tp_overlap=false",
                "parallel.low_precision=none",
                f"parallel.schedule={COMPOSED}"]
    decl = recipe_pair("gpt2_medium_fsdp_tp_overlap_int8",
                       KNOBS + declared)[1]
    assert ts.schedule_from_config(knobs) == ts.schedule_from_config(decl)
    tenv = _envs({"data": 1, "fsdp": 2, "model": 2})[1]
    assert ttpo.make_tp_hooks(knobs, tenv) == ttpo.make_tp_hooks(decl, tenv)
    steps = {"steps": 2}
    jobs = [{"name": "knobs", "kind": "train", "args": {
                "config": "gpt2_medium_fsdp_tp_overlap_int8",
                "overrides": KNOBS + ["precision.policy=fp32"], **steps}},
            {"name": "declared", "kind": "train", "args": {
                "config": "gpt2_medium_fsdp_tp_overlap_int8",
                "overrides": KNOBS + declared + ["precision.policy=fp32"],
                **steps}}]
    for r in spawn_ranks(4, jobs, tmp_path):
        a, b = r["knobs"], r["declared"]
        assert a["metrics"] == b["metrics"]
        for k, v in a["params"].items():
            np.testing.assert_array_equal(v, b["params"][k])
        assert a["wire_bytes"] == b["wire_bytes"]
        assert a["gathers"]["names"] == b["gathers"]["names"]
