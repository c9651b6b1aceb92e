"""The port's MPMD pipeline (``parallel/mpmd_pipeline.py``, the 1F1B
loop) over four gloo ranks (``_torch_pp.py``'s harness):
``gpt2_pipeline_mpmd`` cut to 4 layers at width 32 (T 16, vocab 128,
fp32, global batch 16) on ``pipe=2 data=2`` (M=4, ``grad_accum=2``) and
on ``pipe=4`` (M=8), against the JAX Trainer on the same mesh and
against the port's one-rank step, the plain model at ``grad_accum = M x
grad_accum`` (the backend refuses ``mesh.pipe=1``, as the reference
does): loss and grad_norm per step and the params after 2 steps to rtol
2e-5 / atol 1e-6.

The 1F1B loop's peak in-flight activations are ``stage_peak_live`` stage by
stage, below GPipe's M, and each rank's boundary bytes are its share of
the JAX host loop's ``acts + grads + emb``
(``test_mpmd_peak_live_and_transfer_accounting``): stage j < S-1 sends
M activations, stage j > 0 M cotangents, stage 0 the compute-dtype
embedding mirror and the last stage the head's gradient back. The JAX
count's token term (``device_put`` of stage 0's inputs and the last
stage's targets) has no counterpart here: every pipe rank draws its
batch index's rows itself, so no token crosses ranks. The backend's
refusals are held word for word.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import numpy as np
import pytest

from _torch_pp import PP2, PP4, TINY, run_pp
from _torch_sharded import COMMON, hold, hold_draws
from frl_distributed_ml_scaffold_tpu_torch import config as tconfig
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
    MeshEnv,
    rank_layout,
)
from frl_distributed_ml_scaffold_tpu_torch.parallel.mpmd_pipeline import (
    bubble_fraction,
    check_mpmd,
    check_order,
    peak_live_activations,
    stage_ops,
    stage_peak_live,
)
from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

PLAIN = ["model.pipeline_stages=1", "model.pipeline_impl=spmd",
         "trainer.grad_accum=8"]
CASES = {
    "mpmd2_data2": ("gpt2_pipeline_mpmd", TINY + PP2 + [
        "data.global_batch_size=16", "model.pipeline_microbatches=4",
        "trainer.grad_accum=2"], PLAIN),
    "mpmd4": ("gpt2_pipeline_mpmd", TINY + PP4 + [
        "data.global_batch_size=16", "model.pipeline_microbatches=8"],
        PLAIN),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    recipe, ov, _ = CASES["mpmd4"]
    job = {"name": "telemetry", "kind": "mpmd_telemetry",
           "args": {"config": recipe, "overrides": ov + COMMON}}
    return run_pp(CASES, tuple(CASES), tmp_path_factory.mktemp("pp_mpmd"),
                  [job])


def test_mpmd_telemetry_gauges_spans_and_beats(runs):
    """The JAX host loop's telemetry: per-stage idle gauges, the analytic
    bubble gauge and the boundary-transfer counter in the registry; the
    stage's spans; watchdog beats from inside the schedule loop (one an op,
    and one after the update)."""
    s, mt = 4, 8
    for r in runs["extra"]:
        t = r["telemetry"]
        j = t["coords"]["pipe"]
        snap = t["snapshot"]
        assert snap["pipeline_bubble_fraction"] == pytest.approx(
            bubble_fraction("1f1b", s, mt))
        for k in range(s):
            assert snap[f"pipeline_stage{k}_idle_s"] >= 0.0
        assert snap["pipeline_boundary_transfer_bytes_total"] > 0
        want = {f"stage{j}_update"} | (
            {f"stage{j}_fwd_bwd"} if j == s - 1
            else {f"stage{j}_fwd", f"stage{j}_bwd"})
        assert set(t["spans"]) == want, (j, t["spans"])
        assert t["beats"] == t["ops"] + 1, (j, t["beats"], t["ops"])


@pytest.mark.parametrize("name", list(CASES))
def test_mpmd_ranks_match_jax_trainer(runs, name):
    run = runs[name]
    hold_draws(run)
    hold(run, run["jax"]["metrics"], run["jax"]["params"], f"{name} vs jax")


@pytest.mark.parametrize("name", list(CASES))
def test_mpmd_ranks_match_one_rank_step(runs, name):
    run = runs[name]
    hold(run, run["one"]["metrics"], run["one"]["params"],
         f"{name} vs one rank")


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_stage(runs, name):
    """Stage j holds its contiguous layers; stage 0 alone the embedding,
    the last stage alone ln_f."""
    run = runs[name]
    cfg = run["cfg"].model
    s = cfg.pipeline_stages
    lps = cfg.num_layers // s
    for r in run["ranks"]:
        j = r["coords"]["pipe"]
        layers = {int(k.split(".")[1]) for k in r["local_names"]
                  if k.startswith("blocks.")}
        assert layers == set(range(j * lps, (j + 1) * lps)), (j, layers)
        other = {k for k in r["local_names"] if not k.startswith("blocks.")}
        want = set()
        if j == 0:
            want |= {"wte.weight", "wpe"}
        if j == s - 1:
            want |= {"ln_f.weight", "ln_f.bias"}
        assert other == want, (j, other)


@pytest.mark.parametrize("name", list(CASES))
def test_mpmd_peak_live_and_boundary_bytes(runs, name):
    run = runs[name]
    cfg = run["cfg"]
    m = cfg.model
    s = m.pipeline_stages
    mt = m.pipeline_microbatches * cfg.trainer.grad_accum
    data = cfg.mesh.data
    mb = cfg.data.global_batch_size // mt // data  # a rank's microbatch
    act = mt * mb * m.seq_len * m.hidden_dim * 4
    emb = m.vocab_size * m.hidden_dim * 4
    for r in run["ranks"]:
        pl = r["pipeline"]["peak_live"]
        assert pl[:-1] == [stage_peak_live(j, s, mt) for j in range(s - 1)]
        assert pl[-1] == 0  # fused fwd+bwd: nothing held
        assert max(pl) == peak_live_activations("1f1b", s, mt) == s
        assert max(pl) < peak_live_activations("gpipe", s, mt)
        j = r["coords"]["pipe"]
        want = ((act if j < s - 1 else 0) + (act if j > 0 else 0)
                + (emb if j in (0, s - 1) else 0))
        assert r["pipeline"]["boundary_bytes"] == want, (j, want)
        # The same bytes at the send, counted by the P2P path (2 steps).
        assert r["wire_bytes"]["pipe"] == {"float32": 2 * want}
    # Summed over the ranks, the JAX host loop's acts + grads, and its emb
    # once per data replica (each mirrors its own table).
    jmb = cfg.data.global_batch_size // mt
    jax_acts = (s - 1) * mt * jmb * m.seq_len * m.hidden_dim * 4
    total = sum(r["pipeline"]["boundary_bytes"] for r in run["ranks"])
    assert total == 2 * jax_acts + data * 2 * emb


_MPMD_REFUSALS = [
    (["model.moe.num_experts=4"], "does not support MoE blocks"),
    (["model.pipeline_circular_repeat=2"], "runs the 1F1B schedule; the "
     "circular"),
    (["trainer.offload_opt_state=true"], "does not compose with "
     "trainer.offload_opt_state"),
    (["model.pipeline_stages=3"], "maps one stage per pipe-mesh slice: "
     "mesh.pipe=4 != pipeline_stages=3"),
    (["model.num_layers=6"], "6 layers not divisible by 4 stages"),
    (["data.global_batch_size=12"], "data.global_batch_size=12 not "
     r"divisible by pipeline_microbatches x grad_accum = 8"),
    (["data.global_batch_size=8", "mesh.pipe=2", "mesh.data=2",
      "model.pipeline_stages=2"], r"microbatch size 1 not divisible by "
     r"the stage submesh batch axes \(2\)"),
    (["data.name=synthetic_mnist"], "implements the LM task"),
]


@pytest.mark.parametrize("ov,match", _MPMD_REFUSALS,
                         ids=["moe", "circular", "offload", "pipe_ne_s",
                              "layers", "batch", "submesh", "data"])
def test_mpmd_refusals_word_for_word(ov, match):
    cfg = tconfig.apply_overrides(tconfig.get_config("gpt2_pipeline_mpmd"),
                                  TINY + ["mesh.pipe=4", "mesh.data=1"] + ov)
    env = MeshEnv(config=cfg.mesh, ranks=rank_layout(
        cfg.mesh, int(np.prod([v for v in cfg.mesh.axis_sizes().values()
                               if v > 0]))), rank=0)
    with pytest.raises(ValueError, match=match):
        check_mpmd(cfg, env)


def test_mpmd_one_process_refused_and_wedge_raises():
    """The MPMD backend needs one stage a pipe rank (the reference's
    refusal at mesh.pipe=1), and a schedule whose bookkeeping leaves no
    op ready raises the JAX error."""
    with pytest.raises(ValueError, match="mesh.pipe=1 != pipeline_stages=4"):
        Trainer(tconfig.apply_overrides(tconfig.get_config(
            "gpt2_pipeline_mpmd"), TINY + ["mesh.pipe=1"]), device="cpu")
    check_order(4, 8)
    ops = [stage_ops(j, 2, 2) for j in range(2)]
    ops[0] = ["B", "F", "B", "F"]  # a backward before its forward
    with pytest.raises(RuntimeError, match="1F1B schedule wedged"):
        check_order(2, 2, ops)
