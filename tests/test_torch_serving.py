"""The whole serving slice on the CPU: the port's greedy ``generate()`` and
``ServingEngine`` are token-identical to the JAX package's under ``fp32``
on the same carried-across params, with the JAX side decoding through its
Pallas kernel in interpret mode. The engine refuses the same malformed
requests and options with the same messages, and the options not ported
yet by name.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY, build_pair, jax_params, pallas_interpret

from frl_distributed_ml_scaffold_tpu.models.generation import (
    generate as jax_generate,
)
from frl_distributed_ml_scaffold_tpu.serving import ServingEngine as JaxEngine
from frl_distributed_ml_scaffold_tpu_torch.config.schema import ServingConfig
from frl_distributed_ml_scaffold_tpu_torch.models.generation import generate
from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as tda
from frl_distributed_ml_scaffold_tpu_torch.serving import (
    ServingEngine,
    build_engine,
)

V = TINY["vocab_size"]


@pytest.fixture(scope="module")
def pair():
    params = jax_params()
    jm, tm = build_pair(params, "fp32")
    return jm, params, tm


def _requests(seed: int, n: int = 8):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        prompt = rng.integers(0, V, size=int(rng.integers(2, 40)))
        out.append((prompt.astype(np.int32), int(rng.integers(2, 20))))
    return out


def test_generate_token_identical_to_jax(pair):
    """Ragged left-padded batch, greedy, eos padding after emission."""
    jm, params, tm = pair
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, V, (3, 10)).astype(np.int32)
    lens = np.asarray([10, 4, 7], np.int32)
    with pallas_interpret():
        ref = np.asarray(jax_generate(
            jm, params, jnp.asarray(prompt), max_new_tokens=12,
            temperature=0.0, prompt_lengths=jnp.asarray(lens),
        ))
        eos = int(ref[1, 10 + 3])  # row 1 emits it at step 3
        ref_eos = np.asarray(jax_generate(
            jm, params, jnp.asarray(prompt), max_new_tokens=12,
            temperature=0.0, prompt_lengths=jnp.asarray(lens), eos_id=eos,
        ))
    got = generate(tm, prompt, max_new_tokens=12, temperature=0.0,
                   prompt_lengths=lens, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)
    got_eos = generate(tm, prompt, max_new_tokens=12, temperature=0.0,
                       prompt_lengths=lens, eos_id=eos, device="cpu")
    np.testing.assert_array_equal(got_eos.numpy(), ref_eos)


def test_engine_token_identical_to_jax(pair):
    """8 requests through 3 slots: slots are refilled, the cache bucket
    grows, one request retires on eos; every completion (tokens and
    finish reason) equals the JAX engine's."""
    jm, params, tm = pair
    reqs = _requests(1)
    with pallas_interpret():
        # eos = a token request 0 greedily emits mid-stream.
        first = np.asarray(jax_generate(
            jm, params, jnp.asarray(reqs[0][0])[None], max_new_tokens=4,
            temperature=0.0,
        ))[0]
        eos = int(first[-1])
        jeng = JaxEngine(jm, params, num_slots=3, eos_id=eos, temperature=0.0)
        for prompt, n in reqs:
            jeng.submit(prompt, n)
        jdone = {c.id: c for c in jeng.run()}
    eng = ServingEngine(tm, num_slots=3, eos_id=eos, temperature=0.0,
                        device="cpu")
    tda.decode_attention.launches = 0
    ids = [eng.submit(prompt, n) for prompt, n in reqs]
    done = {c.id: c for c in eng.run()}
    assert tda.decode_attention.launches == 0  # the CPU takes the plain version
    assert sorted(done) == sorted(jdone) == ids
    for rid in ids:
        np.testing.assert_array_equal(done[rid].tokens, jdone[rid].tokens)
        assert done[rid].finish_reason == jdone[rid].finish_reason
    assert eng.stats["finish_eos"] >= 1 and eng.stats["finish_length"] >= 1
    assert any(k.startswith("grow_") for k in eng.stats)
    assert eng.stats["completed"] == len(reqs)
    for c in done.values():
        n_new = len(c.tokens) - c.prompt_len
        assert len(c.token_latencies_s) == n_new
        assert c.ttft_s == c.token_latencies_s[0] > 0


@pytest.mark.parametrize(
    "case", ["empty", "zero_budget", "too_long", "duplicate_id"]
)
def test_engine_rejects_invalid_requests_like_jax(pair, case):
    jm, params, tm = pair
    jeng = JaxEngine(jm, params, num_slots=2, temperature=0.0)
    eng = ServingEngine(tm, num_slots=2, temperature=0.0, device="cpu")
    args = {
        "empty": ([], 4),
        "zero_budget": ([1, 2], 0),
        "too_long": (list(range(100)), TINY["seq_len"]),
        "duplicate_id": ([1, 2], 4),
    }[case]
    errors = []
    for e in (jeng, eng):
        if case == "duplicate_id":
            e.submit([3], 2, request_id=5)
        with pytest.raises(ValueError) as info:
            e.submit(*args, **({"request_id": 5} if case == "duplicate_id" else {}))
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_engine_refuses_zero_slots(pair):
    _, _, tm = pair
    with pytest.raises(ValueError, match="num_slots"):
        ServingEngine(tm, num_slots=0, device="cpu")


@pytest.mark.parametrize(
    "override",
    [
        # The draft tier needs its draft model, as in JAX.
        {"kv_block_size": 16, "speculate": "draft"},
        # Speculation without the paged cache is refused as JAX does.
        {"speculate": "ngram"},
        # Disaggregation without the paged cache, as JAX.
        {"disaggregate": True},
        {"max_queue_depth": -1},
        # Still to port (ROADMAP A7): the separate prefill partition and
        # the tensor-parallel serving layout.
        {"disaggregate": True, "kv_block_size": 16, "prefill_env": "mesh"},
        {"rules": "gpt_tp_rules"},
    ],
    ids=["paged", "speculate", "disaggregate", "queue_bound", "partition",
         "rules"],
)
def test_unported_serving_options_raise(pair, override):
    """The options the port refuses: those JAX refuses too, with JAX's
    message, and those still to port, naming their ROADMAP item."""
    jm, params, tm = pair
    override = dict(override)
    kw = {k: override.pop(k) for k in ("prefill_env", "rules")
          if k in override}
    if kw:
        with pytest.raises(NotImplementedError, match="ROADMAP queue A item 5"):
            build_engine(tm, serving=ServingConfig(**override), device="cpu",
                         **kw)
        return
    from frl_distributed_ml_scaffold_tpu.config.schema import (
        ServingConfig as JaxServingConfig,
    )
    from frl_distributed_ml_scaffold_tpu.serving import (
        build_engine as jax_build_engine,
    )

    with pytest.raises(ValueError) as jinfo:
        jax_build_engine(jm, params, serving=JaxServingConfig(**override))
    with pytest.raises(ValueError) as info:
        build_engine(tm, serving=ServingConfig(**override), device="cpu")
    if override.get("speculate") == "draft":
        # The port's draft is one module carrying its weights.
        assert "needs draft_model=" in str(jinfo.value)
        assert "needs draft_model=" in str(info.value)
        return
    assert str(info.value) == str(jinfo.value)


def test_build_engine_dispatches_to_the_colocated_engine(pair):
    _, _, tm = pair
    eng = build_engine(tm, serving=ServingConfig(), num_slots=2, device="cpu")
    assert isinstance(eng, ServingEngine) and eng.num_slots == 2
    eng.submit([1, 2, 3], 3)
    (c,) = eng.run()
    assert c.finish_reason == "length" and len(c.tokens) == 6
    with pytest.raises(ValueError, match="model lives on"):
        ServingEngine(tm, device="meta")
    assert torch.device("cpu") == tm.device
