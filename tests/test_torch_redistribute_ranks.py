"""The port's redistribution service on four gloo ranks against the JAX
package: the counterpart of ``tests/test_redistribute.py``'s executor
and seam tiers.

One four-rank run (``tests/_torch_ranks.py``: ``redist_grid``,
``redist_restore`` twice and ``redist_serve``) starts with the module
and each test reads its part:

- the executor on the JAX ``MESH_PAIRS`` cut to four ranks, in the four
  dtypes, there and back (donated), the JAX collective cases (move,
  drop, add, drop + add, and an atom against ``AXES`` order) against the
  naive reference, a scratch-limited plan and two uneven splits: every
  region bit-exact, the bytes sent (summed over the ranks) equal to
  ``bytes_moved``, the naive reference sending as much or more, the
  executed scratch within the planned;
- seam 1: a tiny ``gpt2_medium_zero1`` (fsdp layout) saved on fsdp=4 and
  restored on fsdp=2 model=2 through the service, bit-equal to the
  direct restore, each rank reading about a quarter of the payload; the
  plan's costs on the JAX leaves equal the JAX restore's plan on the
  same mesh (JAX :376); and ``mnist_mlp`` with a torn third save, saved
  on data=4 and restored on data=2 fsdp=2, falling back to step 4 both
  ways (JAX :425); and ``gpt2_pp`` over pipe ranks, each stage's
  names held by its own ranks; and, on two ranks of their own, a move
  that fails on one rank raising on both, with no fallback;
- seam 2: the fsdp=2 model=2 training layout handed to ``model=2`` over
  ranks 0-1 through ``build_engine(rules=, layout=)``, bit-equal to the
  host path, the bytes sent equal to the plan's, serving the JAX
  engine's tokens (JAX :464, :515, :552);
- seam 3: ``respread_pool`` growing model=2 to model=4 (ranks 2-3 join
  from dormant engines) over an fp32 and an int8 pool, and shrinking
  model=4 to model=2 (the int form; ranks 2-3 go dormant), mid-decode,
  and an engine built with no rules grown with its params whole,
  every request token-identical to the JAX engine's uninterrupted run
  (JAX :585, :651); and the refusals with JAX's messages (JAX :670).
"""

import _torch_threads  # noqa: F401  (before any torch op)

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding

from _torch_parity import TINY, build_pair, jax_params
from _torch_ranks import spawn_ranks, start_ranks
from frl_distributed_ml_scaffold_tpu import redistribute as jrd
from frl_distributed_ml_scaffold_tpu.config import (
    apply_overrides as japply,
)
from frl_distributed_ml_scaffold_tpu.config import get_config as jget
from frl_distributed_ml_scaffold_tpu.config.schema import (
    MeshConfig as JaxMeshConfig,
)
from frl_distributed_ml_scaffold_tpu.dist.mesh import build_mesh as jbuild
from frl_distributed_ml_scaffold_tpu.serving import (
    DisaggServingEngine as JaxDisagg,
)
from frl_distributed_ml_scaffold_tpu.serving import (
    ServingEngine as JaxEngine,
)
from frl_distributed_ml_scaffold_tpu_torch import redistribute as rd
from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
    GPTConfig,
    MeshConfig,
    ParallelConfig,
    ServingConfig,
)
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import MeshEnv, rank_layout
from frl_distributed_ml_scaffold_tpu_torch.models.gpt import (
    TP_COMPUTE_WHOLE,
    gpt_tp_rules,
)
from frl_distributed_ml_scaffold_tpu_torch.parallel.layout import StateLayout
from frl_distributed_ml_scaffold_tpu_torch.serving import ServingEngine

F32 = ("float32",)
DTYPES = ("float32", "bfloat16", "int8", "float8_e4m3fn")
M1, M2, M4 = dict(data=1), dict(data=1, model=2), dict(data=1, model=4)
FM = dict(data=1, fsdp=2, model=2)
DM = dict(data=2, model=2)
CASES = [
    dict(name="one_to_n", src=(1, M1, ()), dst=(4, M4, ("model", None)),
         shape=(64, 32), dtypes=DTYPES),
    dict(name="n_to_m_shrink", src=(4, M4, (None, "model")),
         dst=(2, M2, (None, "model")), shape=(64, 32), dtypes=DTYPES),
    dict(name="n_to_m_grow", src=(2, M2, ("model", None)),
         dst=(4, M4, ("model", None)), shape=(64, 32), dtypes=DTYPES),
    dict(name="fsdp_model_to_model_only", src=(4, FM, ("fsdp", "model")),
         dst=(2, M2, (None, "model")), shape=(64, 32), dtypes=DTYPES),
    dict(name="mpmd_stage_to_merged", src=(2, dict(data=2), ("data", None)),
         dst=(4, dict(data=2, fsdp=2), (("data", "fsdp"), None)),
         shape=(64, 32), dtypes=DTYPES),
    dict(name="limited", src=(4, FM, ("fsdp", "model")),
         dst=(2, M2, (None, "model")), shape=(64, 32), dtypes=F32,
         limit=1024),
    dict(name="move", src=(4, DM, ("data", None, None)),
         dst=(4, DM, (None, "data", None)), shape=(32, 16, 8), dtypes=F32,
         naive=True),
    dict(name="drop", src=(4, DM, (("data", "model"), None, None)),
         dst=(4, DM, (None, None, None)), shape=(32, 16, 8), dtypes=F32,
         naive=True),
    dict(name="drop_minor_first", src=(4, DM, (("model", "data"), None, None)),
         dst=(4, DM, (None, None, None)), shape=(32, 16, 8), dtypes=F32,
         naive=True),
    dict(name="add", src=(4, DM, (None, None, None)),
         dst=(4, DM, ("model", None, None)), shape=(32, 16, 8), dtypes=F32,
         naive=True),
    dict(name="drop_add", src=(4, DM, (None, "data", None)),
         dst=(4, DM, (None, None, "model")), shape=(32, 16, 8), dtypes=F32,
         naive=True),
    dict(name="uneven_rows", src=(2, M2, ("model", None)),
         dst=(4, FM, (None, "fsdp")), shape=(7, 6), dtypes=DTYPES),
    dict(name="uneven_both", src=(4, FM, ("fsdp", "model")),
         dst=(2, M2, ("model", None)), shape=(7, 5), dtypes=F32),
]
GPT_OV = ["model.vocab_size=128", "model.num_layers=2", "model.num_heads=4",
          "model.hidden_dim=64", "model.seq_len=32", "data.vocab_size=128",
          "data.seq_len=32", "data.global_batch_size=16",
          "trainer.grad_accum=1", "precision.policy=fp32",
          "parallel.param_sharding=fsdp", "parallel.fsdp_min_size=16"]
GPT_SAVE = ["mesh.data=1", "mesh.fsdp=4"]
GPT_RESTORE = ["mesh.data=1", "mesh.fsdp=2", "mesh.model=2"]
MLP_OV = ["model.hidden_sizes=64,32", "data.global_batch_size=64",
          "precision.policy=fp32"]
PP_OV = ["model.num_layers=4", "model.hidden_dim=32", "model.num_heads=2",
         "model.seq_len=16", "data.seq_len=16", "model.vocab_size=128",
         "data.vocab_size=128", "data.global_batch_size=8",
         "precision.policy=fp32", "mesh.pipe=2", "mesh.data=2",
         "model.pipeline_stages=2", "model.pipeline_microbatches=4"]
REQUESTS = [(list(range(3, 11)), 8), (list(range(40, 50)), 8),
            (list(range(100, 106)), 8)]
# Two prompts sharing a 2-block prefix (the second's seed moves out to
# the partition), then a third.
PARTITION_REQUESTS = [(list(range(16)) + [7, 9, 1], 4),
                      (list(range(16)) + [11, 3], 4),
                      (list(range(200, 209)), 5)]


def penv(n: int, **kw) -> MeshEnv:
    cfg = MeshConfig(**kw)
    return MeshEnv(config=cfg, ranks=rank_layout(cfg, n))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The four-rank run (started once) and the JAX tiny GPT's params."""
    tmp = tmp_path_factory.mktemp("redist")
    params = jax_params()
    _, tm = build_pair(params, "fp32")
    state = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    jobs = [
        dict(name="grid", kind="redist_grid", args=dict(cases=CASES)),
        dict(name="gpt", kind="redist_restore", args=dict(
            config="gpt2_medium_zero1", save=GPT_OV + GPT_SAVE,
            restore=GPT_OV + GPT_RESTORE, workdir=str(tmp / "gpt"),
            steps=2)),
        dict(name="torn", kind="redist_restore", args=dict(
            config="mnist_mlp", save=MLP_OV + ["mesh.data=4"],
            restore=MLP_OV + ["mesh.data=2", "mesh.fsdp=2",
                              "parallel.param_sharding=fsdp",
                              "parallel.fsdp_min_size=16"],
            workdir=str(tmp / "torn"), steps=6, torn_at=3)),
        dict(name="pp", kind="redist_restore", args=dict(
            config="gpt2_pp", save=PP_OV, restore=PP_OV,
            workdir=str(tmp / "pp"), steps=2)),
        dict(name="serve", kind="redist_serve", args=dict(
            model_cfg=dict(TINY), state=state, requests=REQUESTS)),
        dict(name="partition", kind="redist_partition", args=dict(
            model_cfg=dict(TINY), state=state, requests=PARTITION_REQUESTS)),
    ]
    wait = start_ranks(4, jobs, tmp, timeout=300)
    box = {}

    def results():
        if "r" not in box:
            box["r"] = wait()
        return box["r"]

    yield params, results
    results()


def _sum(res, key, i=None):
    return sum(r[key] if i is None else r[key][i] for r in res)


def test_executor_grid_there_and_back(run):
    _, results = run
    grid = [r["grid"] for r in results()]
    for case in CASES:
        name = case["name"]
        res = [g[name] for g in grid]
        kind = res[0]["kind"]
        for i, _ in enumerate(case["dtypes"]):
            assert all(r["ok"][i] for r in res), (name, i)
            assert all(r["donated"][i] for r in res), (name, i)
            moved = res[0]["moved"][i]
            assert _sum(res, "sent", i) == moved, (name, i)
            assert _sum(res, "back_sent", i) == res[0]["back_moved"][i]
            assert all(r["scratch"][i] <= max(r["peak"][i], 1) for r in res)
            assert moved == res[0]["lower"][i], name
        if case.get("naive"):
            assert kind == "collective", name
            assert all(r["naive_ok"] for r in res), name
            naive = _sum(res, "naive_sent")
            assert naive >= res[0]["moved"][0], name
            if name in ("move", "drop_add"):
                assert naive > res[0]["moved"][0], name
        elif name.startswith("uneven") or "to" in name or name == "limited":
            assert kind == "chunked", name


def _jax_restore_plan():
    """The JAX restore's plan on fsdp=2 model=2 (four of the simulated
    devices), as ``restore(via_redistribution=True)`` compiles it: the
    trainer's state at the even layout to its target shardings."""
    from frl_distributed_ml_scaffold_tpu.trainer.loop import Trainer

    cfg = japply(jget("gpt2_medium_zero1"), GPT_OV + GPT_RESTORE)
    env = jbuild(cfg.mesh, devices=jax.devices()[:4])
    t = Trainer(cfg, mesh_env=env)
    shapes, shardings = t.state_shapes, t.state_shardings
    even = jax.tree.map(
        lambda s, sh: jax.ShapeDtypeStruct(
            s.shape, s.dtype, sharding=NamedSharding(
                sh.mesh, jrd.restore_layout_spec(s.shape, sh.spec,
                                                 sh.mesh))),
        shapes, shardings)
    return jrd.compile_tree_plan(even, shardings), env


def test_restore_redistribute_bit_equal_on_another_mesh(run):
    _, results = run
    res = [r["gpt"] for r in results()]
    for r in res:
        d, v = r["direct"], r["via"]
        assert d["step"] == v["step"] == 2
        for part in ("params", "opt"):
            a, b = d[part], v[part]
            flat_a = jax.tree_util.tree_leaves(a)
            flat_b = jax.tree_util.tree_leaves(b)
            assert jax.tree_util.tree_structure(a) == \
                jax.tree_util.tree_structure(b)
            for x, y in zip(flat_a, flat_b):
                np.testing.assert_array_equal(x, y)
        assert v["scratch"] <= max(v["peak"], 1)
    total = res[0]["via"]["total"]
    reads = [r["via"]["read"] for r in res]
    assert max(reads) <= 0.3 * total, (reads, total)
    assert sum(reads) <= 1.1 * total, (reads, total)
    assert _sum([r["via"] for r in res], "sent") == res[0]["via"]["moved"]
    # The plan's costs on the JAX leaves equal the JAX restore's plan.
    jplan, jenv = _jax_restore_plan()
    tenv = penv(4, **dict(data=1, fsdp=2, model=2))
    leaves, dst = {}, {}
    for jl in jplan.leaves:
        def spec(sh, n=len(jl.shape)):
            e = list(sh.spec) + [None] * (n - len(sh.spec))
            return tuple(x if x is None or isinstance(x, str) else tuple(x)
                         for x in e)

        leaves[jl.path] = rd.Abstract.of(
            jl.shape, jl.dtype, rd.Placement(tenv, spec(jl.src_sharding)))
        dst[jl.path] = rd.Placement(tenv, spec(jl.dst_sharding))
    tplan = rd.compile_tree_plan(leaves, dst)
    for jl, tl in zip(jplan.leaves, tplan.leaves):
        assert (tl.kind, tl.bytes_moved, tl.bytes_lower_bound,
                tl.peak_scratch_bytes) == (jl.kind, jl.bytes_moved,
                                           jl.bytes_lower_bound,
                                           jl.peak_scratch_bytes), jl.path
    assert tplan.summary_lines() == jplan.summary_lines()


def test_restore_redistribute_over_pipe_ranks(run):
    """``gpt2_pp`` on pipe=2 data=2: each stage's names are held by its
    own pipe ranks (the placement's ``owner``), restored bit-equal to the
    direct restore, every rank keeping its stage's names only."""
    _, results = run
    names = []
    for r in results():
        d, v = r["pp"]["direct"], r["pp"]["via"]
        assert d["step"] == v["step"] == 2
        assert sorted(d["params"]) == sorted(v["params"])
        names.append(sorted(v["params"]))
        for part in ("params", "opt"):
            for x, y in zip(jax.tree_util.tree_leaves(d[part]),
                            jax.tree_util.tree_leaves(v[part])):
                np.testing.assert_array_equal(x, y)
    assert names[0] == names[1] != names[2] == names[3]


def test_restore_redistribute_falls_back_past_torn(run):
    _, results = run
    for r in results():
        d, v = r["torn"]["direct"], r["torn"]["via"]
        assert d["uncommitted"] == v["uncommitted"] == [6]
        assert d["step"] == v["step"] == 4
        for x, y in zip(jax.tree_util.tree_leaves(d["params"]),
                        jax.tree_util.tree_leaves(v["params"])):
            np.testing.assert_array_equal(x, y)


def test_restore_redistribute_failure_raises_on_every_rank(tmp_path):
    """A move that fails on one rank (the executor raises there as the
    first collective or chunked leaf starts) raises on every rank: the
    failing rank its own error, the other its failed send. No rank falls
    back to an older step or a fresh init, and no step is judged
    corrupt."""
    res = spawn_ranks(2, [dict(name="fails", kind="redist_restore_fails",
                               args=dict(
        config="mnist_mlp", save=MLP_OV + ["mesh.data=2"],
        restore=MLP_OV + ["mesh.data=1", "mesh.fsdp=2",
                          "parallel.param_sharding=fsdp",
                          "parallel.fsdp_min_size=16"],
        workdir=str(tmp_path / "w"), steps=4, fail_rank=1))], tmp_path,
        timeout=120)
    out = [r["fails"] for r in res]
    assert "injected failure of the move" in out[1].get("raised", "")
    assert "raised" in out[0], out[0]
    for r in out:
        assert "restored" not in r and r["corrupt"] == [], r


def _jax_tokens(params, **model) -> dict:
    jm, _ = build_pair(params, "fp32", **model)
    eng = JaxEngine(jm, params, num_slots=2, temperature=0.0,
                    kv_block_size=8)
    ids = [eng.submit(np.asarray(p, np.int32), n) for p, n in REQUESTS]
    done = {c.id: c for c in eng.run()}
    eng.close()
    return {i: np.asarray(done[i].tokens) for i in ids}


def _check(done: dict, want: dict):
    assert sorted(done) == sorted(want)
    for rid, (toks, reason) in done.items():
        assert reason == "length"
        np.testing.assert_array_equal(toks, want[rid])


def test_train_to_serve_places_and_serves(run):
    params, results = run
    want = _jax_tokens(params)
    res = [r["serve"] for r in results()]
    # The plan's bytes, priced in this process for the same layouts.
    _, tm = build_pair(params, "fp32")
    shapes = {k: tuple(p.shape) for k, p in tm.named_parameters()}
    layout = StateLayout.build(
        penv(4, data=1, fsdp=2, model=2), GPTConfig(**TINY),
        ParallelConfig(param_sharding="fsdp", fsdp_min_size=16), shapes,
        rules=gpt_tp_rules(), compute_whole=TP_COMPUTE_WHOLE)
    plan = rd.train_to_serve_plan(
        rd.layout_tree(layout, {k: p.dtype for k, p in tm.named_parameters()}),
        penv(2, data=1, model=2), gpt_tp_rules(), model=tm)
    assert plan.bytes_moved == plan.bytes_lower_bound > 0
    assert _sum(res, "handoff_sent") == plan.bytes_moved
    for rank, r in enumerate(res):
        assert r["handoff_equal"], rank
        if rank < 2:
            _check(r["handoff_done"], want)
        else:
            assert r["handoff_empty"] and r["handoff_done"] == {}


@pytest.mark.parametrize("quant", ["none", "int8", "whole"])
def test_respread_grow_inflight_token_identity(run, quant):
    """``whole``: an engine built with no rules on model=2, its params
    and pool whole on every rank, grows to model=4 whole: the plans
    place by the engine's rules, not by the GPT's TP rules."""
    params, results = run
    want = _jax_tokens(params, **({"kv_cache_quant": "int8"}
                                  if quant == "int8" else {}))
    res = [r["serve"][f"grow_{quant}"] for r in results()]
    for rank, r in enumerate(res):
        _check(r["done"], want)
        assert r["heads"] == (TINY["num_heads"] if quant == "whole" else 1)
        assert r["dormant_before"] is False
        assert r["stats"] == {"parked": 2, "resumed": 2, "respread": 1}
        n, moved = r["counters"]
        assert n == 1 and moved == sum(p[0] for p in r["plans"].values())
        for name, (mv, _, scratch, peak, _) in r["plans"].items():
            assert scratch <= max(peak, 1), name
    cache = res[0]["plans"]["cache"]
    assert cache[0] > 0
    assert sum(r["plans"]["cache"][1] for r in res) == cache[0]
    assert sum(r["plans"]["params"][1] for r in res) == \
        res[0]["plans"]["params"][0]
    if quant == "int8":
        assert any("key_pool_scale" in p for p in cache[4]), cache[4]


def test_respread_shrink_inflight_token_identity(run):
    params, results = run
    want = _jax_tokens(params)
    res = [r["serve"]["shrink"] for r in results()]
    for rank, r in enumerate(res):
        if rank < 2:
            _check(r["done"], want)
            assert not r["dormant"]
            assert r["stats"] == {"parked": 2, "resumed": 2}
        else:
            assert r["dormant"] and r["empty"] and r["done"] == {}
    for k in res[0]["moved"]:
        assert sum(r["moved"][k][1] for r in res) == res[0]["moved"][k][0]


def test_respread_refuses_bucketed_and_indivisible(run):
    """JAX's refusals, word for word, before any state is touched."""
    params, _ = run
    jm, tm = build_pair(params, "fp32")
    eng = ServingEngine(tm, num_slots=2, device="cpu")
    jeng = JaxEngine(jm, params, num_slots=2, temperature=0.0)
    with pytest.raises(ValueError) as want:
        jeng.respread_pool(2)
    with pytest.raises(ValueError) as got:
        eng.respread_pool(2)
    assert str(got.value) == str(want.value)
    assert "paged-engine" in str(got.value)
    jeng.close()
    paged = ServingConfig(kv_block_size=8)
    eng = ServingEngine(tm, num_slots=2, serving=paged, device="cpu")
    jeng = JaxEngine(jm, params, num_slots=2, temperature=0.0,
                     kv_block_size=8)
    with pytest.raises(ValueError) as want:
        jeng.respread_pool(jbuild(JaxMeshConfig(data=1, model=8)))
    with pytest.raises(ValueError) as got:
        eng.respread_pool(penv(8, data=1, model=8))
    assert str(got.value) == str(want.value)
    assert "num_heads" in str(got.value)
    jeng.close()


def test_prefill_partition_of_other_ranks(run):
    """Seam 4: the disaggregated engine's prefill partition made of other
    ranks (decode on ranks 0-1, prefill on 2-3) and one beside a live
    ``model`` axis (model=4, a device of each rank): the JAX engine's
    tokens with a one-device prefill submesh, its counted transfer bytes
    (the seed out and each window back, whole), every request handed off
    once; the replica moved by the service (bytes sent = its plan's)."""
    params, results = run
    jm, _ = build_pair(params, "fp32")
    jeng = JaxDisagg(jm, params, num_slots=2, temperature=0.0,
                     kv_block_size=8,
                     prefill_env=jbuild(JaxMeshConfig(data=1),
                                        devices=[jax.devices()[1]]))
    ids = [jeng.submit(np.asarray(p, np.int32), n)
           for p, n in PARTITION_REQUESTS]
    jdone = {c.id: c for c in jeng.run()}
    want = {i: np.asarray(jdone[i].tokens) for i in ids}
    jbytes = jeng.stats["handoff_transfer_bytes"]
    jeng.close()
    res = [r["partition"] for r in results()]
    for rank, r in enumerate(res):
        remote, beside = r["remote"], r["beside"]
        assert remote["remote"] and not beside["remote"]
        _check_ok(beside["done"], want)
        assert beside["bytes"] == jbytes and beside["handoffs"] == 3
        assert beside["prefix_hits"] == 1 and beside["replica_heads"] == 4
        if rank < 2:
            _check_ok(remote["done"], want)
            assert remote["bytes"] == jbytes and remote["handoffs"] == 3
            assert remote["prefix_hits"] == 1
            assert remote["replica_heads"] == 0
        else:
            assert remote["done"] == {} and remote["replica_heads"] == 4
    for name in ("remote", "beside"):
        moved = res[0][name]["replica"][0]
        assert moved > 0
        assert sum(r[name]["replica"][1] for r in res) == moved
    assert jbytes > 0


def _check_ok(done: dict, want: dict):
    assert sorted(done) == sorted(want)
    for rid, (toks, reason) in done.items():
        assert reason in ("length", "eos")
        np.testing.assert_array_equal(toks, want[rid])
