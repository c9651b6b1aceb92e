"""The port's SPMD pipelines over four gloo ranks (``_torch_pp.py``'s
harness): ``gpt2_pp`` and ``gpt2_pp_circular`` cut to 4 layers at width
32 (T 16, vocab 128, fp32), one stage a pipe rank, against the JAX
Trainer on the same mesh (4 of the 8 simulated devices) and against the
port's one-rank step (the recipe at ``mesh.pipe=1``, every stage in one
process), on the same global batch and from one params file: loss and
grad_norm per step and the params after 2 steps to rtol 2e-5 / atol
1e-6.

- ``gpt2_pp`` on ``pipe=4`` (S=4, M=4) and on ``pipe=2 data=2`` (S=2,
  M=4); ``gpt2_pp_circular`` on ``pipe=2 data=2`` (v=2, M=2); each rank
  holds its stage and sends the timeline's bytes;
- dropout 0.1 (``gpt2_pp``, ``pipe=2 data=2``) against the plain
  one-rank step at ``grad_accum = M``, whose masks the pipeline draws;
- a checkpoint of ``gpt2_pp`` on ``pipe=2 data=2`` saved at step 2 and
  restored on the same mesh (each rank its stage) and on one rank;
- every pipeline refusal left (``test_torch_pp_mpmd.py`` holds the MPMD
  backend's), each with its message.

The MPMD cases are in ``test_torch_pp_mpmd.py``: the JAX MPMD trainer's
per-stage programs take most of the time, and each file stays under
~40 s alone.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import numpy as np
import pytest

from _torch_pp import PP2, PP4, TINY, run_pp
from _torch_sharded import COMMON, ONE_RANK, hold, hold_draws
from frl_distributed_ml_scaffold_tpu_torch import config as tconfig
from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

# name: (recipe, overrides, one-rank overrides: None = the recipe at
# mesh.pipe=1, else the plain model's)
CASES = {
    "pp4": ("gpt2_pp", TINY + PP4 + ["model.pipeline_microbatches=4"],
            None),
    "pp2_data2": ("gpt2_pp", TINY + PP2 + ["model.pipeline_microbatches=4"],
                  None),
    "circular": ("gpt2_pp_circular", TINY + PP2 + [
        "model.pipeline_microbatches=2"], None),
    "dropout": ("gpt2_pp", TINY + PP2 + ["model.pipeline_microbatches=4",
                                         "model.dropout=0.1"],
                ["model.pipeline_stages=1", "trainer.grad_accum=4"]),
}
JAX_CASES = ("pp4", "pp2_data2", "circular")
CKPT = ("gpt2_pp", TINY + PP2 + ["model.pipeline_microbatches=4"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_ranks")
    recipe, ov = CKPT
    # The checkpoint run starts from the pp2_data2 case's params file.
    path = tmp / "pp2_data2.msgpack"
    ov = ov + COMMON + [f"trainer.init_params_path={path}"]
    job = {"name": "ckpt", "kind": "checkpoint",
           "args": {"config": recipe, "overrides": ov,
                    "workdir": str(tmp / "ckpt"), "steps": 2}}
    out = run_pp(CASES, JAX_CASES, tmp, [job])
    out["ckpt"] = {"ranks": [r["ckpt"] for r in out["extra"]],
                   "cfg": tconfig.apply_overrides(
                       tconfig.get_config(recipe), ov),
                   "workdir": tmp / "ckpt"}
    return out


@pytest.mark.parametrize("name", JAX_CASES)
def test_pipeline_ranks_match_jax_trainer(runs, name):
    run = runs[name]
    hold_draws(run)
    hold(run, run["jax"]["metrics"], run["jax"]["params"], f"{name} vs jax")


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_ranks_match_one_rank_step(runs, name):
    run = runs[name]
    hold(run, run["one"]["metrics"], run["one"]["params"],
         f"{name} vs one rank")


@pytest.mark.parametrize("name", ["pp4", "pp2_data2", "circular"])
def test_each_rank_holds_its_stage(runs, name):
    """A pipe rank holds its stage's layers (GPipe and MPMD: contiguous;
    circular: its two non-adjacent groups) and nothing of the other
    stages'; the SPMD ranks also hold the embedding and ln_f, the MPMD
    ranks only stage 0 the embedding and the last stage ln_f."""
    run = runs[name]
    cfg = run["cfg"].model
    s, mpmd = cfg.pipeline_stages, cfg.pipeline_impl == "mpmd"
    for r in run["ranks"]:
        j = r["coords"]["pipe"]
        layers = {int(k.split(".")[1]) for k in r["local_names"]
                  if k.startswith("blocks.")}
        if name == "circular":
            want = {j, s + j}  # lg = 1: virtual stages j and S + j
        else:
            lps = cfg.num_layers // s
            want = set(range(j * lps, (j + 1) * lps))
        assert layers == want, (j, layers)
        other = {k for k in r["local_names"] if not k.startswith("blocks.")}
        if not mpmd:
            assert other == {"wte.weight", "wpe", "ln_f.weight", "ln_f.bias"}
        else:
            want_other = set()
            if j == 0:
                want_other |= {"wte.weight", "wpe"}
            if j == s - 1:
                want_other |= {"ln_f.weight", "ln_f.bias"}
            assert other == want_other, (j, other)


@pytest.mark.parametrize("name", ["pp4", "circular"])
def test_spmd_ranks_send_the_timeline_bytes(runs, name):
    """A step's bytes over pipe at the send: every (non-final) output and
    every cotangent of a received input, one [mb, T, D] block each, and
    nothing in a bubble. GPipe: stage j < S-1 sends M activations and
    stage j > 0 M cotangents; circular: v M less the last stage's final
    outputs and stage 0's first-repeat inputs (chip_smoke.py
    ``pp_bytes``, at the rank's rows)."""
    run = runs[name]
    cfg = run["cfg"]
    m = cfg.model
    s, mt, v = (m.pipeline_stages, m.pipeline_microbatches,
                m.pipeline_circular_repeat)
    blk = (cfg.data.global_batch_size // cfg.mesh.data // mt * m.seq_len
           * m.hidden_dim * 4)
    for r in run["ranks"]:
        j = r["coords"]["pipe"]
        blocks = ((v * mt if j < s - 1 else (v - 1) * mt)
                  + (v * mt if j > 0 else (v - 1) * mt))
        assert r["wire_bytes"]["pipe"] == {"float32": 2 * blocks * blk}


def test_checkpoint_restores_on_the_mesh_and_on_one_rank(runs):
    """Rank 0 writes every stage's layers into one file under the plain
    names; a restore on the same mesh gives each rank its stage (params
    and moments), a restore on one rank the whole model, both equal to
    the saved params."""
    ck = runs["ckpt"]
    saved = ck["ranks"][0]["fit"]
    for r in ck["ranks"]:
        assert r["fit_step"] == r["restored_step"] == 2
        assert r["restored_local"] == r["fit_local"]
        assert r["restored_opt_local"] == r["fit_local"]
        for k, v in saved.items():
            np.testing.assert_array_equal(r["restored"][k], v, err_msg=k)
    one = tconfig.apply_overrides(ck["cfg"], ONE_RANK + [
        f"workdir={ck['workdir']}", "checkpoint.enabled=true"])
    trainer = Trainer(one, device="cpu")
    state = trainer.checkpointer.restore_or_init(trainer)
    assert int(state.step) == 2
    assert state.params.keys() == saved.keys()
    for k, v in saved.items():
        np.testing.assert_array_equal(state.params[k].numpy(), v, err_msg=k)


def test_dropout_masks_are_the_one_rank_steps(runs):
    """At dropout 0.1 the pipelined ranks draw the masks of the plain
    one-rank step at grad_accum = M (their losses differ from the
    no-dropout run's, so the masks took part)."""
    run = runs["dropout"]
    hold(run, run["one"]["metrics"], run["one"]["params"], "dropout")
    plain = runs["pp2_data2"]["ranks"][0]["metrics"][0]["loss"]
    assert run["ranks"][0]["metrics"][0]["loss"] != plain


# ------------------------------------------------------------ refusals


def _cfg(recipe, ov):
    return tconfig.apply_overrides(tconfig.get_config(recipe),
                                   TINY + ov)


@pytest.mark.parametrize("ov,match", [
    (["mesh.pipe=2", "mesh.data=1"], r"mesh.pipe=2 with "
     r"model.pipeline_stages=4.*ROADMAP A12"),
    (["mesh.pipe=4", "mesh.data=1", "mesh.model=2"],
     r"mesh.model=2 inside a pipeline.*ROADMAP A12"),
    (["mesh.pipe=4", "mesh.data=1", "mesh.seq=2"],
     r"mesh.seq=2 inside a pipeline.*ROADMAP A12"),
    (["mesh.pipe=4", "mesh.data=1", "mesh.expert=2"],
     r"mesh.expert=2 inside a pipeline.*ROADMAP A12"),
    (["mesh.pipe=4", "mesh.data=1", "mesh.fsdp=2"],
     r"mesh.fsdp=2 inside a pipeline.*ROADMAP A12"),
    (["mesh.pipe=4", "mesh.data=1", "parallel.opt_sharding=zero1"],
     r"ZeRO-1 state inside a pipeline.*ROADMAP A12"),
    (["mesh.pipe=1", "model.attention=ring"],
     r"'ring' inside a pipeline.*ROADMAP A12"),
    (["mesh.pipe=1", "model.attention=ulysses"],
     r"'ulysses' inside a pipeline.*ROADMAP A12"),
], ids=["pipe_ne_stages", "model", "seq", "expert", "fsdp", "zero1",
        "ring", "ulysses"])
def test_pipeline_refusals_name_roadmap_a12(ov, match):
    with pytest.raises(NotImplementedError, match=match):
        Trainer(_cfg("gpt2_pp", ov), device="cpu")


def test_pipeline_impl_and_overlap_refusals():
    with pytest.raises(KeyError, match="unknown model.pipeline_impl='x' "
                       r"\(spmd \| mpmd\)"):
        Trainer(_cfg("gpt2_pp", ["mesh.pipe=1", "model.pipeline_impl=x"]),
                device="cpu")
    for knob in ("parallel.fsdp_overlap=true", "parallel.tp_overlap=true"):
        extra = ["parallel.param_sharding=fsdp"] if "fsdp" in knob else []
        with pytest.raises(NotImplementedError,
                           match="pipeline_impl='mpmd'.*ROADMAP A12"):
            Trainer(_cfg("gpt2_pipeline_mpmd", ["mesh.pipe=1", knob]
                         + extra), device="cpu")
    # The SPMD backend's refusal stays the reference's, word for word.
    with pytest.raises(ValueError, match="not with the SPMD pipeline "
                       "backend"):
        Trainer(_cfg("gpt2_pp", ["mesh.pipe=1", "parallel.tp_overlap=true"]),
                device="cpu")
