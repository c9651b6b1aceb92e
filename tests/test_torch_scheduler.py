"""The disaggregated prefill/decode engine and its SLO scheduler on the
CPU: the port's ``DisaggServingEngine`` against the JAX package's, under
``fp32`` on the same carried-across params, the JAX side running its
paged Pallas kernels in interpret mode.

Every case drives both engines through the same script (submits, steps,
fault plans) and holds them equal token for token, with the same
completion fields (tenant included), the same ``stats``, the same value
of every counter and gauge and the same count in every histogram of the
telemetry registry, and the same pool allocator state at the end. These
mirror the JAX package's disaggregation tests in ``tests/test_serving.py``
and ``tests/test_faults.py``.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import jax
import numpy as np
import pytest

from _torch_parity import TINY, build_pair, jax_params, pallas_interpret

from frl_distributed_ml_scaffold_tpu import faults as jax_faults
from frl_distributed_ml_scaffold_tpu.config.schema import (
    MeshConfig as JaxMeshConfig,
)
from frl_distributed_ml_scaffold_tpu.config.schema import (
    ServingConfig as JaxServingConfig,
)
from frl_distributed_ml_scaffold_tpu.dist.mesh import build_mesh as jbuild
from frl_distributed_ml_scaffold_tpu.serving import (
    DisaggServingEngine as JaxDisagg,
)
from frl_distributed_ml_scaffold_tpu.serving import TenantSpec as JaxTenant
from frl_distributed_ml_scaffold_tpu_torch import faults
from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
    MeshConfig,
    ServingConfig,
)
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import build_mesh
from frl_distributed_ml_scaffold_tpu_torch.models import generation as tgen
from frl_distributed_ml_scaffold_tpu_torch.ops._build import KernelError
from frl_distributed_ml_scaffold_tpu_torch.serving import (
    DisaggServingEngine,
    ServingEngine,
    TenantSpec,
    build_engine,
)

V = TINY["vocab_size"]
FG_BG = (("fg", "latency"), ("bg", "best_effort"))


@pytest.fixture(scope="module")
def params():
    return jax_params()


@pytest.fixture(scope="module")
def pair(params):
    jm, tm = build_pair(params, "fp32")
    return jm, params, tm


@pytest.fixture(scope="module")
def pair_int8(params):
    jm, tm = build_pair(params, "fp32", kv_cache_quant="int8")
    return jm, params, tm


class Side:
    """What a script needs of one package: its engine and fault plans."""

    def __init__(self, eng, faults_mod, plan_cls):
        self.eng = eng
        self._faults = faults_mod
        self._plan = plan_cls

    def faults(self, specs):
        return self._faults.active(self._plan(specs))


def _engines(pair, *, num_slots, tenants, **serving):
    jm, params, tm = pair
    jeng = JaxDisagg(
        jm, params, num_slots=num_slots, temperature=0.0,
        serving=JaxServingConfig(disaggregate=True, **serving),
        tenants=[JaxTenant(*t) for t in tenants],
    )
    teng = DisaggServingEngine(
        tm, num_slots=num_slots, temperature=0.0,
        serving=ServingConfig(disaggregate=True, **serving),
        tenants=[TenantSpec(*t) for t in tenants], device="cpu",
    )
    return jeng, teng


def _registry(eng) -> dict:
    """Counters and gauges by value, histograms by count."""
    return {k: (v["count"] if isinstance(v, dict) else v)
            for k, v in eng.telemetry.snapshot().items()}


def _check_same(jeng, jdone, teng, tdone):
    assert sorted(tdone) == sorted(jdone)
    for rid, c in tdone.items():
        j = jdone[rid]
        np.testing.assert_array_equal(c.tokens, j.tokens, err_msg=str(rid))
        for field in ("finish_reason", "prompt_len", "tenant",
                      "prefix_cache_hit", "prefill_tokens_saved",
                      "spec_accept_rate"):
            assert getattr(c, field) == getattr(j, field), (rid, field)
        assert len(c.token_latencies_s) == len(j.token_latencies_s)
        assert len(c.token_times_s) == len(j.token_times_s)
    assert dict(teng.stats) == dict(jeng.stats)
    assert _registry(teng) == _registry(jeng)
    assert teng.decode._free == jeng.decode._free
    np.testing.assert_array_equal(teng.decode._ref, jeng.decode._ref)
    assert teng.decode._reserved_future == jeng.decode._reserved_future


def _both(pair, script, *, num_slots=3, tenants=FG_BG, **serving):
    """Run ``script(side) -> {id: Completion}`` on the JAX engine and on
    the port's; hold them equal; return the port's engine and
    completions."""
    jeng, teng = _engines(pair, num_slots=num_slots, tenants=tenants,
                          **serving)
    with pallas_interpret():
        jdone = script(Side(jeng, jax_faults, jax_faults.FaultPlan))
    tdone = script(Side(teng, faults, faults.FaultPlan))
    _check_same(jeng, jdone, teng, tdone)
    jeng.close()
    return teng, tdone


def _submit_all(reqs):
    def script(side):
        for p, n, tenant in reqs:
            side.eng.submit(p, n, tenant=tenant)
        return {c.id: c for c in side.eng.run()}
    return script


def _mixed_tenant_reqs(rng, n=6):
    return [
        (rng.integers(0, V, size=int(rng.integers(2, 12))).astype(np.int32),
         int(rng.integers(2, 9)), ("fg", "bg")[i % 2])
        for i in range(n)
    ]


@pytest.mark.parametrize("pool,bs", [("fp32", 8), ("fp32", 16), ("int8", 8)])
def test_disagg_matches_jax(pair, pair_int8, pool, bs):
    """Two tenants of different classes through the prefill worker, the
    splice and the decode worker; every request crosses by handoff, the
    shared pool has no transfer path, and every reservation unwinds. The int8
    pool splices its scale blocks with the payloads."""
    rng = np.random.default_rng(41 + bs)
    teng, done = _both(pair if pool == "fp32" else pair_int8,
                       _submit_all(_mixed_tenant_reqs(rng)),
                       kv_block_size=bs)
    s = teng.stats
    assert s["handoffs"] == s["handoff_splices"] == len(done)
    # Shared-pool mode has no transfer path: the counter is registered
    # and reads 0 by construction; nothing enters the stats.
    assert teng.telemetry.snapshot()["serve_handoff_transfer_bytes_total"] == 0
    assert "handoff_transfer_bytes" not in s
    assert s["prefill_deferred"] > 0
    assert teng.decode._reserved_future == 0
    assert all(not b for b in teng.decode._slot_blocks)
    assert {c.tenant for c in done.values()} == {"fg", "bg"}
    # Token-identical to the port's own colocated engine, too.
    colo = ServingEngine(teng.decode.model, num_slots=3, temperature=0.0,
                         serving=ServingConfig(kv_block_size=bs),
                         device="cpu")
    for p, n, _ in _mixed_tenant_reqs(np.random.default_rng(41 + bs)):
        colo.submit(p, n)
    for c in colo.run():
        np.testing.assert_array_equal(c.tokens, done[c.id].tokens)


def test_disagg_spec_rides_decode_worker_like_jax(pair):
    """n-gram speculation rides the decode worker: verify steps accept
    drafts while admissions arrive by handoff."""
    rng = np.random.default_rng(0)
    pre = rng.integers(0, V, size=20).astype(np.int32)
    reqs = [
        (np.tile(np.asarray([3, 9, 4, 7], np.int32), 5), 14, "fg"),
        (np.concatenate([pre, rng.integers(0, V, 5).astype(np.int32)]), 6,
         "bg"),
        (np.arange(2, dtype=np.int32), 12, "bg"),
    ]
    teng, _ = _both(pair, _submit_all(reqs), kv_block_size=8,
                    speculate="ngram", speculate_k=4)
    s = teng.stats
    assert s["decode_verify"] > 0
    assert 0 < s["spec_accepted"] <= s["spec_proposed"]


def test_disagg_prefix_reuse_through_prefill_worker_like_jax(pair):
    """The seed gathers from the decode worker's pool, the prefill
    worker prefills only the suffix, and the splice writes only the
    private blocks."""
    bs = 8
    pre = np.arange(2 * bs, dtype=np.int32)
    reqs = [
        (np.concatenate([pre, np.asarray([7, 9], np.int32)]), 4, "fg"),
        (np.concatenate([pre, np.asarray([11, 3, 5], np.int32)]), 4, "fg"),
    ]
    teng, done = _both(pair, _submit_all(reqs), num_slots=2, kv_block_size=bs)
    assert teng.stats["prefix_hits"] == 1
    assert teng.stats["prefill_tokens_saved"] == 2 * bs
    assert sum(c.prefix_cache_hit for c in done.values()) == 1


def _preempt_script(side):
    """bg decodes alone in the only slot; fg arrives and preempts it."""
    eng = side.eng
    pb = np.arange(4, dtype=np.int32)
    eng.submit(pb, 14, tenant="bg")
    out = []
    for _ in range(4):
        out += eng.step()
    eng.submit((pb + 7) % V, 4, tenant="fg")
    return {c.id: c for c in out + eng.run()}


def test_disagg_preemption_park_resume_like_jax(pair):
    """A latency arrival with no free slot PARKS the best-effort slot,
    finishes first, and the parked request RESUMES token-identically to
    its solo generate()."""
    teng, done = _both(pair, _preempt_script, num_slots=1, kv_block_size=8)
    s = teng.stats
    assert s["preemptions"] == s["parked"] == s["resumed"] == 1
    assert teng.telemetry.counter("serve_preemption_total").value == 1
    ref = tgen.generate(teng.decode.model, np.arange(4, dtype=np.int32)[None],
                        max_new_tokens=14, temperature=0.0, device="cpu")
    np.testing.assert_array_equal(done[0].tokens, ref[0].numpy())
    assert done[0].tenant == "bg" and done[1].tenant == "fg"


def test_disagg_per_tenant_shed_ordering_like_jax(pair):
    """With the global queue bound hit, a latency arrival sheds the
    newest queued best-effort request instead of itself."""
    def script(side):
        eng = side.eng
        p = np.arange(4, dtype=np.int32)
        for i in range(2):
            eng.submit((p + i) % V, 2, tenant="bg")
        eng.submit((p + 9) % V, 2, tenant="fg")  # bound hit: bg pays
        eng.submit((p + 3) % V, 2, tenant="bg")  # self-sheds
        return {c.id: c for c in eng.run()}

    teng, done = _both(pair, script, num_slots=1, kv_block_size=8,
                       max_queue_depth=2)
    assert [done[i].finish_reason for i in range(4)] == [
        "length", "shed", "length", "shed"]
    assert teng.telemetry.counter("serve_shed_total_tenant_bg").value == 2
    assert teng.telemetry.counter("serve_shed_total_tenant_fg").value == 0


def test_disagg_deferred_head_keeps_its_turn(pair):
    """A head request whose launch defers keeps its round-robin turn:
    the cursor commits only when a request launches."""
    _, _, tm = pair
    eng = DisaggServingEngine(
        tm, num_slots=2, temperature=0.0, device="cpu",
        serving=ServingConfig(kv_block_size=8, disaggregate=True),
        tenants=[TenantSpec("a", "standard"), TenantSpec("b", "standard")],
    )
    ra = eng.submit(np.arange(9, dtype=np.int32), 4, tenant="a")
    eng.submit(np.arange(3, dtype=np.int32), 3, tenant="b")
    _, r1, s1, rr1 = eng._next_request()
    _, r2, _, _ = eng._next_request()
    assert r1.id == ra and r2.id == ra and s1.name == "a"
    eng._commit_rr(rr1)
    assert eng._next_request()[2].name == "b"
    assert all(c.ok for c in eng.run())


def test_disagg_expired_parked_request_retires_like_jax(pair):
    """A parked request past its deadline retires typed "deadline" in
    place, with the tokens before the park, and its blocks and
    reservation come back."""
    def script(side):
        eng = side.eng
        pb = np.arange(4, dtype=np.int32)
        eng.submit(pb, 14, tenant="bg")
        out = []
        for _ in range(4):
            out += eng.step()
        eng.submit((pb + 7) % V, 4, tenant="fg")
        for _ in range(6):
            out += eng.step()
            if eng.stats["parked"]:
                break
        eng._parked[0]["state"]["req"].deadline_s = 1e-6
        return {c.id: c for c in out + eng.run()}

    teng, done = _both(pair, script, num_slots=1, kv_block_size=8)
    assert done[0].finish_reason == "deadline" and done[1].ok
    n_partial = len(done[0].tokens) - done[0].prompt_len
    assert n_partial >= 1 and len(done[0].token_latencies_s) == n_partial
    assert teng.stats["resumed"] == 0
    d = teng.decode
    assert d._reserved_future == 0 and not d._parked_held
    cache_held = {b for ids in d._prefix_cache.values() for b in ids}
    assert len(d._free) + len(cache_held) == d.pool_blocks - 1


def test_disagg_latency_after_preemption_no_livelock_like_jax(pair):
    """A queued latency request and a parked best-effort victim do not
    wait on each other: every request completes."""
    def script(side):
        eng = side.eng
        pb = np.arange(4, dtype=np.int32)
        eng.submit(pb, 16, tenant="bg")
        out = []
        for _ in range(4):
            out += eng.step()
        rf1 = eng.submit((pb + 7) % V, 4, tenant="fg")
        for _ in range(30):
            out += eng.step()
            if any(c.id == rf1 for c in out):
                break
        eng.submit((pb + 23) % V, 4, tenant="fg")
        return {c.id: c for c in out + eng.run(max_steps=300)}

    _, done = _both(pair, script, num_slots=1, kv_block_size=8)
    assert sorted(done) == [0, 1, 2] and all(c.ok for c in done.values())


@pytest.mark.parametrize("site", ["prefill_worker", "handoff"])
def test_disagg_worker_faults_requeue_then_error_like_jax(pair, site):
    """A prefill-worker or handoff failure releases the reservation and
    re-queues the request at the head of its tenant queue; one failure
    recovers token-identically, a request failing every attempt ends
    typed "error" after ``handoff_retries`` retries, and no block
    leaks."""
    def script(side):
        eng = side.eng
        p = np.arange(5, dtype=np.int32)
        with side.faults([dict(site=f"serve.{site}", at=1, times=1)]):
            eng.submit(p, 4)
            eng.submit(p + 1, 3)
            out = eng.run()
        with side.faults([dict(site=f"serve.{site}", key="2", times=0)]):
            eng.submit(p + 2, 4)
            out += eng.run()
        eng.submit(p, 4)
        return {c.id: c for c in out + eng.run()}

    teng, done = _both(pair, script, num_slots=2, kv_block_size=8)
    assert [done[i].finish_reason for i in range(4)] == [
        "length", "length", "error", "length"]
    counter = {"prefill_worker": "serve_prefill_worker_failures_total",
               "handoff": "serve_handoff_failures_total"}[site]
    assert teng.telemetry.counter(counter).value == 1 + 1 + teng.handoff_retries
    assert teng.stats[f"{site}_requeued"] == 1 + teng.handoff_retries
    assert teng.telemetry.counter("serve_quarantined_total").value == 1
    assert teng.decode._reserved_future == 0


@pytest.mark.parametrize("site", ["prefill_worker", "handoff"])
def test_kernel_failure_across_the_worker_boundary_propagates(pair, site):
    """A kernel that failed to launch in the prefill or the splice is
    no worker failure: it propagates instead of re-queueing the request
    until it ends typed "error"."""
    _, _, tm = pair
    teng = DisaggServingEngine(
        tm, num_slots=2, temperature=0.0, device="cpu",
        serving=ServingConfig(kv_block_size=8, disaggregate=True),
        tenants=[TenantSpec("fg", "latency")],
    )
    err = KernelError("paged decode attention kernel launch failed: CUDA "
                      "error 98")

    def broken(*args, **kwargs):
        raise err

    if site == "prefill_worker":
        teng.prefill_worker.prefill = broken
    else:
        teng.decode.admit_handoff = broken
    teng.submit(np.arange(5, dtype=np.int32), 4, tenant="fg")
    with pytest.raises(KernelError) as info:
        teng.run()
    assert info.value is err
    assert teng.stats[f"{site}_failures"] == 0
    assert teng.stats[f"{site}_requeued"] == 0


def test_build_engine_dispatches_on_disaggregate(pair):
    _, _, tm = pair
    eng = build_engine(tm, serving=ServingConfig(kv_block_size=8,
                                                 disaggregate=True),
                       num_slots=2, device="cpu")
    assert isinstance(eng, DisaggServingEngine) and eng.num_slots == 2
    assert eng.prefill_max_per_tick == 1 and eng.handoff_retries == 2
    eng.submit([1, 2, 3], 3)
    (c,) = eng.run()
    assert c.ok and c.tenant == "default" and len(c.tokens) == 6


@pytest.mark.parametrize("case", ["partition", "rules", "respread",
                                  "bucketed", "zero_per_tick"])
def test_disagg_refusals(pair, case):
    """What stays refused, as in JAX: the bucketed cache and a zero
    launch budget. ``rules=`` with no current mesh places nothing and
    serves, as in JAX. A ``MeshEnv`` prefill partition serves (here over
    this process's one rank; other ranks are
    ``test_torch_redistribute_ranks.py``'s), token for token with the
    JAX engine on a one-device prefill submesh. The decode worker's pool
    re-spreads mid-decode onto a mesh of one rank (``respread_pool(1)``)
    as the JAX one does: the same tokens, the pool unmoved, every slot
    parked and resumed, the counter at one. (The JAX engine here holds
    host params, which its plan's ``host`` kind places whole; the port's
    are on their one rank already.)"""
    jm, params, tm = pair
    paged = ServingConfig(kv_block_size=8, disaggregate=True)
    if case == "rules":
        eng = build_engine(tm, serving=paged, rules=["tp"], device="cpu")
        eng.submit([1, 2, 3], 3)
        (c,) = eng.run()
        assert c.ok and len(c.tokens) == 6
        return
    if case == "respread":
        got = []
        for eng in (JaxDisagg(jm, params, serving=JaxServingConfig(
                        kv_block_size=8, disaggregate=True)),
                    build_engine(tm, serving=paged, device="cpu")):
            ids = [eng.submit(p, 6) for p in ([1, 2, 3, 4], [5, 6, 7])]
            eng.step()
            eng.step()
            plans = eng.decode.respread_pool(1)
            done = {c.id: c for c in eng.run()}
            snap = eng.telemetry.snapshot()
            got.append(([np.asarray(done[i].tokens) for i in ids],
                        plans["cache"].bytes_moved,
                        eng.decode.stats["parked"],
                        eng.decode.stats["resumed"],
                        snap["serve_pool_respread_total"]))
            moved = {k: p.bytes_moved for k, p in plans.items()}
        (jt, *jrest), (tt, *trest) = got
        for a, b in zip(jt, tt):
            np.testing.assert_array_equal(a, b)
        assert trest == jrest == [0, 2, 2, 1]
        assert moved == {"params": 0, "cache": 0}
        return
    if case == "partition":
        eng = DisaggServingEngine(
            tm, serving=paged, temperature=0.0,
            prefill_env=build_mesh(MeshConfig(data=1), 1), device="cpu")
        jeng = JaxDisagg(jm, params, temperature=0.0,
                         serving=JaxServingConfig(kv_block_size=8,
                                                  disaggregate=True),
                         prefill_env=jbuild(JaxMeshConfig(data=1),
                                            devices=[jax.devices()[1]]))
        got = []
        for e in (jeng, eng):
            ids = [e.submit(p, 5) for p in ([1, 2, 3, 4], [5, 6, 7])]
            done = {c.id: c for c in e.run()}
            got.append(([np.asarray(done[i].tokens) for i in ids],
                        e.stats["handoff_transfer_bytes"]))
        for a, b in zip(got[0][0], got[1][0]):
            np.testing.assert_array_equal(a, b)
        assert got[0][1] == got[1][1] > 0
        assert eng.prefill_worker.separate
        return
    kw = ({} if case == "bucketed"
          else {"kv_block_size": 8, "prefill_max_per_tick": 0})
    with pytest.raises(ValueError) as jinfo:
        JaxDisagg(jm, params,
                  serving=JaxServingConfig(disaggregate=True, **kw))
    with pytest.raises(ValueError) as info:
        DisaggServingEngine(tm, serving=ServingConfig(disaggregate=True, **kw),
                            device="cpu")
    assert str(info.value) == str(jinfo.value)
