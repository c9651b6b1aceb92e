"""Tensor-parallel serving on four gloo ranks against the JAX package on
the same mesh (four of conftest's eight simulated devices), fp32.

The tiny GPT of ``_torch_parity`` (4 heads of 32) is placed by
``build_engine(rules=gpt_tp_rules())`` on ``model=4`` (a head a rank)
here and on ``data=2 model=2`` (two heads a rank; the contiguous cache's
rows split over ``data``, the pool whole over it) in
``test_torch_tp_serving_dp.py``, which imports this file's harness (each
file stays short). On each mesh the port's
``generate``, ``beam_search`` (3 beams; scores to rtol 1e-5), contiguous
engine, paged engine with n-gram speculation
(the verify tile), int8 contiguous engine and disaggregated engine give
the JAX package's tokens and finish reasons on the same mesh, every rank
the same ones; their cache and pool bytes equal the JAX engine's (the
whole arrays' bytes); the disaggregated engine's handoff splices make no
collective. Rank 1's clock runs a million times fast on both meshes, so
any deadline it judged on its own would pass at once. The JAX side
decodes through its plain reference on the CPU, as its own
sharded-serving tests do.

Here also: two heads over ``model=4`` do not divide, so each rank keeps
the attention whole (the JAX model leaves that cache unconstrained) and
the tokens still equal JAX's; and the engines stay in lock step under a
deadline and a queue bound, and when each rank samples from its own
generator: every rank ends with rank 0's completions.
On ``data=2 model=2``: an odd vocabulary (509) serves as the port's
one-rank engine does (ROADMAP C.13: the JAX package's jax refuses the
uneven split).
"""

import _torch_threads  # noqa: F401  (before any torch op)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY, jax_params
from _torch_ranks import start_ranks
from frl_distributed_ml_scaffold_tpu.config.schema import (
    GPTConfig as JaxGPTConfig,
)
from frl_distributed_ml_scaffold_tpu.config.schema import (
    MeshConfig as JaxMeshConfig,
)
from frl_distributed_ml_scaffold_tpu.config.schema import (
    ServingConfig as JaxServingConfig,
)
from frl_distributed_ml_scaffold_tpu.dist.mesh import build_mesh as jbuild
from frl_distributed_ml_scaffold_tpu.dist.mesh import mesh_context as jctx
from frl_distributed_ml_scaffold_tpu.models.generation import (
    beam_search as jbeam,
)
from frl_distributed_ml_scaffold_tpu.models.generation import (
    generate as jgenerate,
)
from frl_distributed_ml_scaffold_tpu.models.gpt import GPT as JaxGPT
from frl_distributed_ml_scaffold_tpu.models.gpt import gpt_tp_rules as jrules
from frl_distributed_ml_scaffold_tpu.parallel.partition import (
    shard_params_for_serving as jshard,
)
from frl_distributed_ml_scaffold_tpu.precision import get_policy as jpolicy
from frl_distributed_ml_scaffold_tpu.serving import (
    build_engine as jbuild_engine,
)
from frl_distributed_ml_scaffold_tpu_torch.config.schema import GPTConfig
from frl_distributed_ml_scaffold_tpu_torch.models import convert
from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
from frl_distributed_ml_scaffold_tpu_torch.serving import ServingEngine

V = TINY["vocab_size"]
MESHES = {"model4": dict(data=1, model=4), "dp2_tp2": dict(data=2, model=2)}
ODD = 509


def _requests(seed: int, n: int = 4, tenant: str = "default"):
    rng = np.random.default_rng(seed)
    # Prompts of 3-8 tokens and 3-7 new ones: one prompt bucket and one
    # cache bucket, so the JAX side compiles each program once.
    return [(rng.integers(0, V, int(rng.integers(3, 9))).astype(np.int32),
             int(rng.integers(3, 8)), None, tenant) for _ in range(n)]


PROMPT = np.random.default_rng(7).integers(0, V, (2, 8)).astype(np.int32)
CASES = [
    {"name": "generate", "kind": "generate", "prompt": PROMPT, "new": 5},
    {"name": "beam", "kind": "beam", "prompt": PROMPT, "new": 4,
     "beams": 3},
    {"name": "contiguous", "kind": "engine", "slots": 2,
     "requests": _requests(1)},
    {"name": "paged", "kind": "engine", "slots": 2,
     "serving": dict(kv_block_size=8, speculate="ngram", speculate_k=3),
     # Repeats give the n-gram proposer something to find.
     "requests": [(np.tile(r[0][:3], 3), r[1], None, "default")
                  for r in _requests(2)]},
    {"name": "int8", "kind": "engine", "slots": 2,
     "model": {"kv_cache_quant": "int8"}, "requests": _requests(3)},
    {"name": "disagg", "kind": "engine", "slots": 2,
     "serving": dict(kv_block_size=8, disaggregate=True),
     "requests": _requests(4)},
]
INDIVISIBLE = {"name": "indivisible", "kind": "generate",
               "model": {"num_heads": 2}, "prompt": PROMPT, "new": 5}
# Lock step: 2 slots, a queue bound of 2; request 1's deadline passes
# before its admission on every clock, requests 2 and 3 find the queue
# full, request 0 (60 s) ends by length unless a clock says otherwise.
LOCKSTEP = {"name": "lockstep", "kind": "engine", "slots": 1,
            "serving": dict(max_queue_depth=2),
            "requests": [(r[0], r[1], d, "default") for r, d in
                         zip(_requests(5), (60.0, 1e-9, 60.0, 60.0))]}


# Sampling at temperature 1 from a generator seeded by each rank's index.
SAMPLED = {"name": "sampled", "kind": "engine", "slots": 2,
           "temperature": 1.0, "requests": _requests(7)}


def _jax_side(params, mesh: dict) -> dict:
    """Each case of ``CASES`` (and the indivisible one on ``model=4``)
    through the JAX package on the same mesh."""
    env = jbuild(JaxMeshConfig(**mesh), devices=jax.devices()[:4])
    out = {}
    cases = CASES + ([INDIVISIBLE] if mesh["model"] == 4 else [])
    for case in cases:
        model = JaxGPT(JaxGPTConfig(**{**TINY, **case.get("model", {})}),
                       jpolicy("fp32"))
        with jctx(env):
            sharded = jshard(params, env, jrules())
            if case["kind"] == "generate":
                out[case["name"]] = np.asarray(jgenerate(
                    model, sharded, jnp.asarray(case["prompt"]),
                    max_new_tokens=case["new"], temperature=0.0))
                continue
            if case["kind"] == "beam":
                toks, scores = jbeam(
                    model, sharded, jnp.asarray(case["prompt"]),
                    max_new_tokens=case["new"], num_beams=case["beams"])
                out[case["name"]] = (np.asarray(toks), np.asarray(scores))
                continue
            eng = jbuild_engine(
                model, sharded, num_slots=case["slots"], temperature=0.0,
                serving=JaxServingConfig(**case.get("serving", {})))
            for prompt, new, _, _ in case["requests"]:
                eng.submit(prompt, new)
            done = {c.id: (np.asarray(c.tokens), c.finish_reason)
                    for c in eng.run()}
            out[case["name"]] = {"done": done,
                                 "bytes_per_slot": eng.bytes_per_slot(),
                                 "block_bytes": eng.block_bytes()}
            eng.close()
    return out


def run_mesh(tmp, mesh: str, extra: list, odd: bool = False) -> dict:
    """The port's ranks on ``mesh`` over ``CASES`` and ``extra`` (cases,
    rank 1's clock skewed), beside the JAX side on the same mesh; with
    ``odd``, also the odd vocabulary on the ranks and on one rank."""
    params = jax_params()
    state = {k: v.numpy() for k, v in
             convert.params_from_jax(params, GPTConfig(**TINY)).items()}
    jobs = [{"name": mesh, "kind": "serve",
             "args": {"model_cfg": TINY, "state": state,
                      "mesh": MESHES[mesh], "cases": CASES + extra,
                      "skew_rank": 1}}]
    odd_cfg = GPTConfig(**{**TINY, "vocab_size": ODD})
    odd_case = {"name": "odd", "kind": "engine", "slots": 2,
                "model": {"vocab_size": ODD}, "requests": _requests(6)}
    if odd:
        gen = torch.Generator().manual_seed(3)
        odd_state = {k: v.numpy() for k, v in
                     convert.init_params(odd_cfg, gen).items()}
        jobs.append({"name": "odd", "kind": "serve",
                     "args": {"model_cfg": TINY, "state": odd_state,
                              "mesh": MESHES[mesh], "cases": [odd_case]}})
    wait = start_ranks(4, jobs, tmp)
    out = {"jax": {mesh: _jax_side(params, MESHES[mesh])}}
    if odd:
        # The odd vocabulary against the port's one-rank engine.
        one = GPT(odd_cfg, get_policy("fp32"), device="cpu")
        one.load_state_dict({k: torch.from_numpy(v)
                             for k, v in odd_state.items()})
        eng = ServingEngine(one, num_slots=2, temperature=0.0, device="cpu")
        for prompt, new, _, _ in odd_case["requests"]:
            eng.submit(prompt, new)
        out["odd_one"] = {c.id: (c.tokens, c.finish_reason)
                          for c in eng.run()}
    out["ranks"] = wait()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_mesh(tmp_path_factory.mktemp("tp_serve"), "model4",
                    [INDIVISIBLE, LOCKSTEP, SAMPLED])


def _same_done(got: dict, want: dict, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for rid, (toks, reason) in want.items():
        np.testing.assert_array_equal(got[rid][0], toks,
                                      err_msg=f"{what} request {rid}")
        assert got[rid][1] == reason, (what, rid)


def hold_tokens(runs, mesh: str, case: str) -> None:
    want = runs["jax"][mesh][case]
    for r, rank in enumerate(runs["ranks"]):
        got = rank[mesh][case]
        what = f"{mesh} {case} rank {r}"
        if case == "generate":
            np.testing.assert_array_equal(got["tokens"], want, err_msg=what)
            continue
        if case == "beam":
            np.testing.assert_array_equal(got["tokens"], want[0],
                                          err_msg=what)
            np.testing.assert_allclose(got["scores"], want[1], rtol=1e-5,
                                       err_msg=what)
            continue
        _same_done(got["done"], want["done"], what)
        if case == "paged":
            assert got["stats"]["decode_verify"] > 0  # the verify tile ran


def hold_bytes(runs, mesh: str, case: str) -> None:
    """The whole arrays' bytes, as the JAX engine counts them; each rank
    holds its heads (and on ``data=2`` the contiguous cache's rows) of
    them."""
    want = runs["jax"][mesh][case]
    for rank in runs["ranks"]:
        got = rank[mesh][case]
        assert got["bytes_per_slot"] == want["bytes_per_slot"] > 0
        assert got["block_bytes"] == want["block_bytes"]


def hold_splices(runs, mesh: str) -> None:
    for r in runs["ranks"]:
        sp = r[mesh]["splices"]
        assert sp["n"] == len(CASES[-1]["requests"])
        assert sp["calls"] == 0


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_tokens_equal_jax_on_the_same_mesh(runs, case):
    hold_tokens(runs, "model4", case)


@pytest.mark.parametrize("case", [c["name"] for c in CASES[2:]])
def test_cache_and_pool_bytes_equal_jax(runs, case):
    hold_bytes(runs, "model4", case)


def test_heads_split_and_indivisible_heads_stay_whole(runs):
    assert {r["model4"]["generate"]["heads"] for r in runs["ranks"]} == {1}
    for r in runs["ranks"]:
        got = r["model4"]["indivisible"]
        assert got["heads"] == 2  # every head on every rank
        np.testing.assert_array_equal(got["tokens"],
                                      runs["jax"]["model4"]["indivisible"])


def test_handoff_splice_makes_no_collective(runs):
    hold_splices(runs, "model4")


def test_sampled_tokens_are_rank_zeros(runs):
    """Each rank draws from its own generator; the tokens every rank
    keeps are rank 0's."""
    done = [r["model4"]["sampled"]["done"] for r in runs["ranks"]]
    assert len(done[0]) == len(SAMPLED["requests"])
    for d in done[1:]:
        _same_done(d, done[0], "sampled lock step")


def test_skewed_clock_keeps_lock_step(runs):
    """Rank 1's clock would expire every request at once; the plan is
    rank 0's, so every rank ends with rank 0's completions."""
    done = [r["model4"]["lockstep"]["done"] for r in runs["ranks"]]
    reasons = {rid: reason for rid, (_, reason) in done[0].items()}
    assert reasons == {0: "length", 1: "deadline", 2: "shed", 3: "shed"}
    for d in done[1:]:
        _same_done(d, done[0], "lock step")


def test_pool_taxonomy_matches_jax():
    """``pool_heads_axis`` and ``pool_leaf_spec`` name the JAX package's
    axes and specs for every leaf of a paged cache, int8 scales too."""
    from frl_distributed_ml_scaffold_tpu.models import generation as jgen
    from frl_distributed_ml_scaffold_tpu_torch.models import generation as tgen

    model = GPT(GPTConfig(**{**TINY, "kv_cache_quant": "int8"}),
                get_policy("fp32"), device="cpu")
    cache = model.init_paged_cache(2, 8, 5)
    assert set(cache) >= {"key_pool", "value_pool", "key_pool_scale",
                          "value_pool_scale", "block_tables"}
    for name, leaf in cache.items():
        want = jgen.pool_leaf_spec(name, jnp.zeros(leaf.shape))
        assert tgen.pool_heads_axis(name, leaf) == jgen.pool_heads_axis(
            name, jnp.zeros(leaf.shape))
        got = tgen.pool_leaf_spec(name, leaf)
        assert got == (None if want is None else tuple(want)), name
