"""The draft-model tier of speculative decoding (``serving.speculate=
draft``) on the CPU: the port's paged engine with a 1-layer draft GPT
against the JAX package's engine with the same draft, both models' params
initialised once in the JAX package and carried across (``fp32``, the JAX
side's Pallas kernels in interpret mode).

The draft is random, so most drafts are rejected; acceptance is exact, so
the output is token-identical to plain decode whatever the draft
proposes, and the engines agree on every proposal, acceptance and
rollback (equal ``stats``). Mirrors ``tests/test_serving.py``'s draft
test and ``tests/test_faults.py``'s draft-failure test.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _jit import jit_init
from _torch_parity import TINY, build_pair, jax_params, pallas_interpret

from frl_distributed_ml_scaffold_tpu import faults as jax_faults
from frl_distributed_ml_scaffold_tpu.config.schema import (
    GPTConfig as JaxGPTConfig,
)
from frl_distributed_ml_scaffold_tpu.config.schema import (
    ServingConfig as JaxServingConfig,
)
from frl_distributed_ml_scaffold_tpu.models.gpt import GPT as JaxGPT
from frl_distributed_ml_scaffold_tpu.precision import get_policy as jax_policy
from frl_distributed_ml_scaffold_tpu.serving import ServingEngine as JaxEngine
from frl_distributed_ml_scaffold_tpu_torch import faults
from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
    GPTConfig,
    ServingConfig,
)
from frl_distributed_ml_scaffold_tpu_torch.models.convert import params_from_jax
from frl_distributed_ml_scaffold_tpu_torch.models.generation import generate
from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as tda
from frl_distributed_ml_scaffold_tpu_torch.ops._build import KernelError
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
from frl_distributed_ml_scaffold_tpu_torch.serving import (
    DisaggServingEngine,
    ServingEngine,
    TenantSpec,
)

V = TINY["vocab_size"]
# The draft: one layer, 2 heads of 32 (so the JAX decode kernel runs).
DRAFT = dict(TINY, num_layers=1, num_heads=2, hidden_dim=64)


@pytest.fixture(scope="module")
def models():
    params = jax_params()
    jm, tm = build_pair(params, "fp32")
    jdraft = JaxGPT(JaxGPTConfig(**DRAFT), jax_policy("fp32"))
    tokens = jax.random.randint(jax.random.key(9), (2, 8), 0, V)
    dparams = jax.device_get(jit_init(jdraft, tokens, train=False)["params"])
    tdraft = GPT(GPTConfig(**DRAFT), get_policy("fp32"), device="cpu")
    tdraft.load_state_dict(params_from_jax(dparams, GPTConfig(**DRAFT)))
    return jm, params, tm, jdraft, dparams, tdraft


def _spec_reqs(rng, bs=8):
    """A repetitive prompt, a random one, and a short one whose budget
    crosses block boundaries mid-decode."""
    return [
        (np.tile(np.asarray([3, 9, 4, 7], np.int32), 5), bs + 6),
        (rng.integers(0, V, size=9).astype(np.int32), 6),
        (np.arange(2, dtype=np.int32), bs + 4),
    ]


def _both(models, script, *, k=3, window=32, num_slots=3):
    jm, params, tm, jdraft, dparams, tdraft = models
    serving = dict(kv_block_size=8, speculate="draft", speculate_k=k)
    with pallas_interpret():
        jeng = JaxEngine(jm, params, num_slots=num_slots, temperature=0.0,
                         serving=JaxServingConfig(**serving),
                         speculate_window=window, draft_model=jdraft,
                         draft_params=dparams)
        jdone = script(jeng, jax_faults)
    eng = ServingEngine(tm, num_slots=num_slots, temperature=0.0,
                        serving=ServingConfig(**serving),
                        speculate_window=window, draft_model=tdraft,
                        device="cpu")
    done = script(eng, faults)
    assert sorted(done) == sorted(jdone)
    for rid, c in done.items():
        np.testing.assert_array_equal(c.tokens, jdone[rid].tokens)
        assert c.spec_accept_rate == jdone[rid].spec_accept_rate
        assert c.finish_reason == jdone[rid].finish_reason
    assert dict(eng.stats) == dict(jeng.stats)
    snap = {k: v for k, v in eng.telemetry.snapshot().items()
            if not isinstance(v, dict)}
    jsnap = {k: v for k, v in jeng.telemetry.snapshot().items()
             if not isinstance(v, dict)}
    assert snap == jsnap
    assert eng.spec_window == jeng.spec_window
    jeng.close()
    return eng, done


def _submit_all(reqs):
    def script(eng, _):
        for p, n in reqs:
            eng.submit(p, n)
        return {c.id: c for c in eng.run()}
    return script


def _check_plain(eng, reqs, done):
    for rid, (p, n) in enumerate(reqs):
        ref = generate(eng.model, p[None], max_new_tokens=n, temperature=0.0,
                       device="cpu")[0].numpy()
        np.testing.assert_array_equal(done[rid].tokens, ref)


@pytest.mark.parametrize("window", [32, 4])
def test_draft_speculation_matches_jax_and_plain_decode(models, window):
    """Proposals from one batched draft ``generate`` over every slot's
    left-padded history window; every draft the JAX engine proposes the
    port proposes, the same prefixes are accepted, the rejected ones roll
    back across block boundaries, and the output is plain decode's."""
    reqs = _spec_reqs(np.random.default_rng(41))
    eng, done = _both(models, _submit_all(reqs), window=window)
    s = eng.stats
    assert s["decode_verify"] > 0 and s["spec_proposed"] > 0
    assert s["block_rollback"] > 0
    assert eng._reserved_future == 0 and all(not b for b in eng._slot_blocks)
    for c in done.values():
        assert 0.0 <= c.spec_accept_rate <= 1.0
    _check_plain(eng, reqs, done)
    # The CPU takes the plain decode attention: no kernel launched.
    assert tda.decode_attention.launches == 0


def test_draft_window_is_capped_by_the_draft_context(models):
    """The window shrinks to the draft's context less ``speculate_k``."""
    _, _, tm, _, _, _ = models
    short = GPT(GPTConfig(**dict(DRAFT, seq_len=16)), get_policy("fp32"),
                device="cpu")
    eng = ServingEngine(tm, temperature=0.0, device="cpu",
                        serving=ServingConfig(kv_block_size=8,
                                              speculate="draft",
                                              speculate_k=3),
                        draft_model=short)
    assert eng.spec_window == 13


def test_draft_failure_degrades_the_hit_slot_like_jax(models):
    """The ``serve.draft`` site fails one slot's proposal: that slot
    decodes plainly for the rest of its request, the others keep
    speculating, the output is unchanged and the failure is counted; a
    new request speculates again."""
    reqs = _spec_reqs(np.random.default_rng(43))

    def script(eng, fm):
        with fm.active(fm.FaultPlan([dict(site="serve.draft", at=2,
                                          times=1)])):
            for p, n in reqs:
                eng.submit(p, n)
            out = eng.run()
        before = eng.stats["spec_proposed"]
        eng.submit(reqs[0][0], 8)
        out += eng.run()
        assert eng.stats["spec_proposed"] > before
        return {c.id: c for c in out}

    eng, done = _both(models, script)
    assert eng.stats["spec_draft_failures"] == 1
    assert eng.telemetry.counter("serve_spec_draft_failures_total").value == 1
    _check_plain(eng, reqs, done)


def test_failed_draft_call_degrades_every_participating_slot(models):
    """When the batched draft call itself raises, every slot that asked
    for drafts in that round degrades (a crashing draft model would crash
    every later round too); nothing sheds and the output is plain
    decode's."""
    _, _, tm, _, _, tdraft = models
    reqs = _spec_reqs(np.random.default_rng(47))
    eng = ServingEngine(tm, num_slots=3, temperature=0.0, device="cpu",
                        serving=ServingConfig(kv_block_size=8,
                                              speculate="draft",
                                              speculate_k=3),
                        draft_model=tdraft)
    calls = []
    draft_fn = eng._draft_fn

    def flaky(windows, lens):
        calls.append(int((lens > 1).sum()))
        if len(calls) == 2:
            raise RuntimeError("draft model crashed")
        return draft_fn(windows, lens)

    eng._draft_fn = flaky
    for p, n in reqs:
        eng.submit(p, n)
    done = {c.id: c for c in eng.run()}
    assert all(c.ok for c in done.values())
    assert eng.stats["spec_draft_failures"] == calls[1] == 3
    assert len(calls) == 2  # every slot degraded: no third round
    _check_plain(eng, reqs, done)


@pytest.mark.parametrize("err", [
    KernelError("decode attention kernel launch failed: CUDA error 98"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
], ids=["kernel", "cuda"])
def test_kernel_failure_in_the_draft_call_propagates(models, err):
    """A kernel that failed to build or launch, or a CUDA error, inside
    the batched draft call is no draft failure: it propagates instead of
    quietly degrading every slot to plain decode."""
    _, _, tm, _, _, tdraft = models
    eng = ServingEngine(tm, num_slots=3, temperature=0.0, device="cpu",
                        serving=ServingConfig(kv_block_size=8,
                                              speculate="draft",
                                              speculate_k=3),
                        draft_model=tdraft)

    def broken(windows, lens):
        raise err

    eng._draft_fn = broken
    for p, n in _spec_reqs(np.random.default_rng(47)):
        eng.submit(p, n)
    with pytest.raises(type(err)) as info:
        eng.run()
    assert info.value is err
    assert eng.stats["spec_draft_failures"] == 0
    assert not eng._slot_spec_degraded.any()


def test_draft_rides_the_disaggregated_decode_worker(models):
    """The draft tier on the decode worker of the disaggregated engine
    is token-identical to plain decode."""
    _, _, tm, _, _, tdraft = models
    reqs = _spec_reqs(np.random.default_rng(53))
    eng = DisaggServingEngine(
        tm, num_slots=3, temperature=0.0, device="cpu", draft_model=tdraft,
        serving=ServingConfig(kv_block_size=8, speculate="draft",
                              speculate_k=3, disaggregate=True),
        tenants=[TenantSpec("fg", "latency")],
    )
    for p, n in reqs:
        eng.submit(p, n, tenant="fg")
    done = {c.id: c for c in eng.run()}
    assert eng.stats["decode_verify"] > 0
    assert eng.stats["handoffs"] == len(reqs)
    _check_plain(eng.decode, reqs, done)


@pytest.mark.parametrize("case", ["no_draft", "vocab", "context"])
def test_draft_refusals(models, case):
    jm, params, tm, jdraft, dparams, tdraft = models
    serving = ServingConfig(kv_block_size=8, speculate="draft",
                            speculate_k=3)
    if case == "no_draft":
        with pytest.raises(ValueError, match="needs draft_model="):
            ServingEngine(tm, serving=serving, device="cpu")
        return
    cfg = (dict(DRAFT, vocab_size=V // 2) if case == "vocab"
           else dict(DRAFT, seq_len=3))
    jbad = JaxGPT(JaxGPTConfig(**cfg), jax_policy("fp32"))
    bad = GPT(GPTConfig(**cfg), get_policy("fp32"), device="cpu")
    jbad_params = jax.device_get(jit_init(
        jbad, jnp.zeros((1, 2), jnp.int32), train=False)["params"])
    with pytest.raises(ValueError) as jinfo:
        JaxEngine(jm, params, serving=JaxServingConfig(
            kv_block_size=8, speculate="draft", speculate_k=3),
            draft_model=jbad, draft_params=jbad_params)
    with pytest.raises(ValueError) as info:
        ServingEngine(tm, serving=serving, draft_model=bad, device="cpu")
    assert str(info.value) == str(jinfo.value)
