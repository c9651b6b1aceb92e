"""The colocated engine's failure semantics and telemetry on the CPU,
against the JAX package's ``ServingEngine`` on the same carried-across
params (``fp32``, the JAX side's Pallas kernels in interpret mode).

Failures: queue overflow sheds typed, deadlines expire queued and
decoding requests, a poison request is quarantined with its pool
reservation and the sampling stream rolled back, a failed cache growth
(``CacheGrowError``) retires only the rows that need the room. These
mirror ``tests/test_faults.py``'s serving cases. Telemetry: the same
metric names, help strings and values as the JAX engine's registry, one
connected span tree per request in ``export_trace``, and ``reset_cache``
dropping the warm pass's spans (``tests/test_tracing.py``).
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import json
import time

import numpy as np
import pytest
import torch

from _torch_parity import TINY, build_pair, jax_params, pallas_interpret

from frl_distributed_ml_scaffold_tpu import faults as jax_faults
from frl_distributed_ml_scaffold_tpu.config.schema import (
    ServingConfig as JaxServingConfig,
)
from frl_distributed_ml_scaffold_tpu.serving import ServingEngine as JaxEngine
from frl_distributed_ml_scaffold_tpu_torch import faults
from frl_distributed_ml_scaffold_tpu_torch.config.schema import ServingConfig
from frl_distributed_ml_scaffold_tpu_torch.models.generation import generate
from frl_distributed_ml_scaffold_tpu_torch.ops._build import KernelError
from frl_distributed_ml_scaffold_tpu_torch.serving import (
    CacheGrowError,
    ServingEngine,
)
from frl_distributed_ml_scaffold_tpu_torch.telemetry import Tracer

V = TINY["vocab_size"]


@pytest.fixture(scope="module")
def pair():
    params = jax_params()
    jm, tm = build_pair(params, "fp32")
    return jm, params, tm


def _registry(eng) -> dict:
    """Counters and gauges by value, histograms by count."""
    return {k: (v["count"] if isinstance(v, dict) else v)
            for k, v in eng.telemetry.snapshot().items()}


def _both(pair, script, *, num_slots=2, **serving):
    """Run ``script(eng, faults_module) -> {id: Completion}`` on the JAX
    engine and on the port's; hold completions, stats and the registry
    equal; return the port's engine and completions."""
    jm, params, tm = pair
    with pallas_interpret():
        jeng = JaxEngine(jm, params, num_slots=num_slots, temperature=0.0,
                         serving=JaxServingConfig(**serving))
        jdone = script(jeng, jax_faults)
    eng = ServingEngine(tm, num_slots=num_slots, temperature=0.0,
                        serving=ServingConfig(**serving), device="cpu")
    done = script(eng, faults)
    assert sorted(done) == sorted(jdone)
    for rid, c in done.items():
        j = jdone[rid]
        np.testing.assert_array_equal(c.tokens, j.tokens, err_msg=str(rid))
        assert c.finish_reason == j.finish_reason, rid
        assert len(c.token_latencies_s) == len(j.token_latencies_s), rid
    assert dict(eng.stats) == dict(jeng.stats)
    assert _registry(eng) == _registry(jeng)
    jeng.close()
    return eng, done


def _solo(tm, prompt, n):
    return generate(tm, np.asarray(prompt)[None], max_new_tokens=n,
                    temperature=0.0, device="cpu")[0].numpy()


def test_queue_overflow_sheds_typed_completions_like_jax(pair):
    """Submits beyond max_queue_depth resolve at once as typed "shed"
    completions (prompt back, nothing generated), counted."""
    def script(eng, _):
        for i in range(5):
            eng.submit(np.arange(4, dtype=np.int32) + i, 3)
        return {c.id: c for c in eng.run()}

    eng, done = _both(pair, script, num_slots=1, max_queue_depth=2)
    assert [done[i].finish_reason for i in range(5)] == [
        "length", "length", "shed", "shed", "shed"]
    for i in range(2, 5):
        assert len(done[i].tokens) == done[i].prompt_len
        assert not done[i].ok and done[i].token_latencies_s == []
    assert eng.telemetry.counter("serve_shed_total").value == 3


@pytest.mark.parametrize("paged", [False, True], ids=["bucketed", "paged"])
def test_deadline_expired_in_queue_sheds_before_prefill_like_jax(pair, paged):
    def script(eng, _):
        eng.submit(np.arange(5, dtype=np.int32), 6, deadline_s=1e-6)
        eng.submit(np.arange(5, dtype=np.int32) + 2, 3)
        time.sleep(0.01)
        return {c.id: c for c in eng.run()}

    eng, done = _both(pair, script, num_slots=1,
                      kv_block_size=8 if paged else 0)
    assert done[0].finish_reason == "deadline"
    assert len(done[0].tokens) == done[0].prompt_len
    assert done[1].ok
    assert eng.telemetry.counter("serve_deadline_miss_total").value == 1
    assert eng.stats["prefill_8"] == 1  # only the second was prefilled


@pytest.mark.parametrize("spec", ["off", "ngram"])
def test_deadline_mid_decode_cancels_and_frees_slot_like_jax(pair, spec):
    """A decoding request past its deadline retires with the tokens so
    far; the freed slot serves the next request token-identically. Under
    speculation the check runs once after each emitted group."""
    def script(eng, _):
        eng.submit(np.tile(np.asarray([3, 9, 4, 7], np.int32), 2), 30,
                   deadline_s=60.0)
        eng.submit(np.arange(6, dtype=np.int32), 3)
        first = eng.step()
        eng._req[0].deadline_s = 1e-6
        return {c.id: c for c in first + eng.run()}

    serving = ({} if spec == "off"
               else dict(kv_block_size=8, speculate="ngram", speculate_k=4))
    eng, done = _both(pair, script, num_slots=1, **serving)
    assert done[0].finish_reason == "deadline"
    n_partial = len(done[0].tokens) - done[0].prompt_len
    assert n_partial >= 1 and len(done[0].token_latencies_s) == n_partial
    assert done[1].ok
    np.testing.assert_array_equal(
        done[1].tokens, _solo(eng.model, np.arange(6, dtype=np.int32), 3))
    assert eng.telemetry.counter("serve_deadline_miss_total").value == 1


@pytest.mark.parametrize("paged", [False, True], ids=["bucketed", "paged"])
def test_poison_request_quarantined_batch_survives_like_jax(pair, paged):
    """The ``serve.prefill`` site fails one admission: a typed "error"
    completion and the quarantine counter; the other request is served;
    the paged reservation is released; the engine keeps admitting."""
    def script(eng, fm):
        eng.submit(np.arange(5, dtype=np.int32), 4)
        eng.submit(np.arange(6, dtype=np.int32), 4)
        with fm.active(fm.FaultPlan([dict(site="serve.prefill", key="0")])):
            out = eng.run()
        eng.submit(np.arange(5, dtype=np.int32), 4)
        return {c.id: c for c in out + eng.run()}

    eng, done = _both(pair, script, kv_block_size=8 if paged else 0)
    assert [done[i].finish_reason for i in range(3)] == [
        "error", "length", "length"]
    assert eng.telemetry.counter("serve_quarantined_total").value == 1
    np.testing.assert_array_equal(
        done[2].tokens, _solo(eng.model, np.arange(5, dtype=np.int32), 4))
    if paged:
        assert eng._reserved_future == 0
        held = {b for ids in eng._prefix_cache.values() for b in ids}
        assert len(eng._free) + len(held) == eng.pool_blocks - 1


@pytest.mark.parametrize("paged", [False, True], ids=["bucketed", "paged"])
def test_kernel_failure_at_admission_is_not_quarantined(pair, paged,
                                                        monkeypatch):
    """A kernel that failed to launch in the prefill is no poison
    request: it propagates instead of ending the request typed "error"
    while the next admission fails the same way."""
    from frl_distributed_ml_scaffold_tpu_torch.serving import engine as tse

    _, _, tm = pair
    eng = ServingEngine(tm, num_slots=2, temperature=0.0, device="cpu",
                        serving=ServingConfig(kv_block_size=8 if paged
                                              else 0))
    err = KernelError("flash attention forward kernel launch failed: CUDA "
                      "error 98")

    def broken(*args, **kwargs):
        raise err

    monkeypatch.setattr(tse, "prefill_request", broken)
    eng.submit(np.arange(5, dtype=np.int32), 4)
    with pytest.raises(KernelError) as info:
        eng.run()
    assert info.value is err
    assert eng.stats["quarantined"] == 0
    assert eng.telemetry.counter("serve_quarantined_total").value == 0


@pytest.mark.parametrize("where", ["site", "after_draw"])
def test_quarantine_is_rng_neutral_for_sampled_decode(pair, where):
    """A quarantined admission puts the sampling generator back, so the
    healthy request draws exactly what it draws in a fault-free run:
    with the fault at the ``serve.prefill`` site (before the draw) and
    with the graft failing after the first token was drawn."""
    _, _, tm = pair
    prompt = np.arange(5, dtype=np.int32)

    def serve(poison: bool):
        eng = ServingEngine(tm, num_slots=2, temperature=0.7,
                            generator=torch.Generator().manual_seed(3),
                            serving=ServingConfig(kv_block_size=8),
                            device="cpu")
        if not poison:
            eng.submit(prompt, 6)
            return [c.tokens for c in eng.run()]
        eng.submit(np.arange(3, dtype=np.int32), 4)
        eng.submit(prompt, 6)
        if where == "site":
            with faults.active(faults.FaultPlan(
                    [dict(site="serve.prefill", key="0", times=0)])):
                done = {c.id: c for c in eng.run()}
        else:
            graft = eng._graft_package

            def failing(slot, req, *a, **kw):
                if req.id == 0:
                    raise RuntimeError("graft failed")
                return graft(slot, req, *a, **kw)

            eng._graft_package = failing
            done = {c.id: c for c in eng.run()}
        assert done[0].finish_reason == "error"
        assert eng._reserved_future == 0
        return [done[1].tokens]

    np.testing.assert_array_equal(serve(True)[0], serve(False)[0])


def test_grow_failure_degrades_not_dies_like_jax(pair):
    """A failed bucket growth retires only the rows that NEED the larger
    bucket (typed "error", partial tokens carried); a row at exactly
    ``_len == bucket`` still fits and finishes; once the fault clears the
    engine grows again."""
    def script(eng, fm):
        eng.submit(np.arange(4, dtype=np.int32), 30)
        eng.submit(np.arange(3, dtype=np.int32) + 1, 10)
        with fm.active(fm.FaultPlan([dict(site="serve.grow")])):
            out = eng.run()
        eng.submit(np.arange(4, dtype=np.int32), 30)
        return {c.id: c for c in out + eng.run()}

    eng, done = _both(pair, script)
    assert done[0].finish_reason == "error"
    assert len(done[0].tokens) > done[0].prompt_len
    assert done[1].ok and done[2].ok
    assert eng.telemetry.counter("serve_grow_failures_total").value == 1
    with pytest.raises(CacheGrowError, match="injected"):
        with faults.active(faults.FaultPlan([dict(site="serve.grow")])):
            eng._ensure_bucket(eng.bucket + 1)


def test_paged_block_append_failure_retires_the_row_like_jax(pair):
    """The paged engine's growth is a block append; the ``serve.grow``
    site there retires the crossing row typed "error" and the batch
    keeps decoding."""
    def script(eng, fm):
        eng.submit(np.arange(3, dtype=np.int32), 14)
        eng.submit(np.arange(9, dtype=np.int32) + 1, 4)
        with fm.active(fm.FaultPlan([dict(site="serve.grow")])):
            return {c.id: c for c in eng.run()}

    eng, done = _both(pair, script, kv_block_size=8)
    assert done[0].finish_reason == "error" and done[1].ok
    assert eng._reserved_future == 0


# ----------------------------------------------------------- telemetry


def _workload(n=4, seed=7):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, size=int(rng.integers(3, 20))).astype(
        np.int32), int(rng.integers(2, 9))) for _ in range(n)]


@pytest.mark.parametrize("serving", [
    {}, dict(kv_block_size=8, speculate="ngram", speculate_k=4)],
    ids=["bucketed", "paged_ngram"])
def test_registry_names_help_and_values_match_jax(pair, serving):
    """The engine registers the JAX engine's catalog (names, kinds and
    help strings) and moves every counter and gauge, and every
    histogram's count, as the JAX engine does."""
    work = _workload() + [(np.tile(np.asarray([3, 9, 4, 7], np.int32), 4), 9)]

    def script(eng, _):
        for p, n in work:
            eng.submit(p, n)
        return {c.id: c for c in eng.run()}

    jm, params, tm = pair
    eng, done = _both(pair, script, **serving)
    jeng = JaxEngine(jm, params, serving=JaxServingConfig(**serving))

    def catalog(reg):
        return {name: (type(m).__name__, m.help)
                for name, m in reg._metrics.items()}

    assert catalog(eng.telemetry) == catalog(jeng.telemetry)
    jeng.close()
    s = eng.telemetry.snapshot()
    assert s["serve_completed_total"] == len(work)
    assert s["serve_ttft_seconds"]["count"] == len(work)
    for c in done.values():
        assert 0.0 < c.ttft_s and c.tpot_p50_s <= c.tpot_p99_s
        n_new = len(c.tokens) - c.prompt_len
        assert len(c.token_times_s) == n_new
        assert c.token_times_s == sorted(c.token_times_s)


def test_export_trace_is_connected_per_request(pair, tmp_path):
    """Valid Chrome-trace JSON with one connected tree per request: a
    single parentless "request" root spanning enqueue to retire, with its
    queue_wait, prefill, graft, decode_tick and retire children; the
    decode programs on the engine lane."""
    _, _, tm = pair
    work = _workload()
    eng = ServingEngine(tm, num_slots=3, temperature=0.0, device="cpu")
    for p, n in work:
        eng.submit(p, n)
    done = {c.id: c for c in eng.run()}
    path = tmp_path / "serve_trace.json"
    eng.export_trace(str(path))
    trace = json.loads(path.read_text())
    assert set(trace) == {"traceEvents", "displayTimeUnit"}
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    lanes = {e["tid"]: e["args"]["name"] for e in trace["traceEvents"]
             if e["ph"] == "M" and e["name"] == "thread_name"}
    roots = [e for e in spans
             if e["name"] == "request" and "parent" not in e["args"]]
    assert len(roots) == len(work)
    for root in roots:
        rid = root["args"]["request"]
        assert lanes[root["tid"]] == f"request {rid}"
        kids = [e for e in spans if e["tid"] == root["tid"] and e is not root]
        assert kids and all(
            e["args"].get("parent") == root["args"]["span"] for e in kids)
        assert {"queue_wait", "prefill", "graft", "retire"} <= {
            e["name"] for e in kids}
        n_new = len(done[rid].tokens) - done[rid].prompt_len
        assert sum(e["name"] == "decode_tick" for e in kids) == n_new - 1
        t0, t1 = root["ts"], root["ts"] + root["dur"]
        for e in kids:
            assert t0 <= e["ts"] and e["ts"] + e["dur"] <= t1 + 1e-3
    (engine_lane,) = [t for t, n in lanes.items() if n == "engine"]
    assert any(e["name"] == "decode" and e["tid"] == engine_lane
               for e in spans)


def test_reset_cache_drops_warm_pass_spans_and_stats(pair):
    """After ``reset_cache`` the ring, the stats and the metrics carry
    only the measured pass; a caller's disabled tracer still leaves one
    retire phase per request on the timeline."""
    _, _, tm = pair
    work = _workload(n=2, seed=5)
    for tracer in (None, Tracer(enabled=False)):
        eng = ServingEngine(tm, num_slots=2, temperature=0.0,
                            serving=ServingConfig(kv_block_size=8),
                            tracer=tracer, device="cpu")
        for p, n in work:
            eng.submit(p, n)
        eng.run()
        if tracer is None:
            assert len(eng.tracing) > 0
        eng.reset_cache()
        assert len(eng.tracing) == 0 and not eng.stats
        assert eng.telemetry.counter("serve_completed_total").value == 0
        for p, n in work:
            eng.submit(p, n)
        eng.run()
        names = [r["name"] for r in eng.timeline.drain()]
        assert names.count("retire") == len(work)
        roots = [r for r in eng.tracing.spans() if r["name"] == "request"]
        assert len(roots) == (0 if tracer is not None else len(work))
        assert eng.stats["completed"] == len(work)
    with pytest.raises(RuntimeError, match="in flight"):
        eng.submit(work[0][0], 3)
        eng.step()
        eng.reset_cache()
