"""Disaggregated prefill/decode serving and the multi-tenant SLO
scheduler: the port of the JAX package's ``serving/scheduler.py``.

Prefill is compute-bound (one big ragged forward over the prompt), decode
is bandwidth-bound (one small forward per token against the whole KV
pool). The colocated engine admits into EVERY free slot before each
decode tick, so a burst of prompt-heavy arrivals runs several full
prefills ahead of the next token. This module splits the two:

- **PrefillWorker** owns admission's prefill (the bucketed ragged
  prefill and the shared-prefix seeded suffix prefill, the recipe of
  ``engine.prefill_request``). It shares the decode worker's pool and
  runs on the engine's stream, as colocated admission does; fetching
  the first token completes the package.
- **The decode worker** is a paged ``ServingEngine`` driven with an
  empty queue: it runs the decode / verify steps (speculation rides it
  unchanged) and splices handoffs.
- **The handoff is a block-table splice** (``generation.
  splice_pool_blocks``, as colocated admission): the prefilled private
  blocks land in their pool homes and ownership moves as one table-row
  write. The partitions share the pool, so the blocks merely re-own and
  ``stats["handoff_transfer_bytes"]`` stays 0.

On top sits the SLO scheduler:

- **Per-tenant queues** (``TenantSpec``): strict class priority
  ``latency > standard > best_effort``, weighted round-robin within a
  class, per-tenant and global queue bounds. A full global queue sheds
  the newest request of the LOWEST queued class, not the arriving
  higher-class request.
- **Decoupled admission**: at most ``prefill_max_per_tick`` prefills
  start per decode tick, so a prefill burst defers in the queue while
  running decodes keep their cadence.
- **Preemption**: a latency-class handoff with no free slot PARKS a
  best-effort slot (``ServingEngine.park_slot``: no device work, the
  pool keeps the parked request's blocks) and takes it; the parked
  request resumes later (``resume_parked``) token-identically, or
  retires typed ``"deadline"`` in place once its deadline passes.

Failures across the worker boundary (sites ``serve.prefill_worker`` and
``serve.handoff``) release the pool reservation and re-queue the request
at the head of its tenant queue, at most ``handoff_retries`` times
before a typed ``"error"`` completion. A kernel that failed to build or
launch, or a CUDA error, is no worker failure: it propagates. The port
samples every request from one generator stream: a prefill-worker fault
fires before the draw, so it leaves sampled output as a fault-free run
would; a handoff fault fires after it, and its retry draws again.

Not ported (ROADMAP queue A item 5, A7): a prefill worker on its own
partition (``prefill_env``) with its own params replica and the counted
transfer of suffix blocks.
"""

from __future__ import annotations

import collections
import dataclasses
import re
import time
from typing import Any, Sequence

import numpy as np
import torch

from frl_distributed_ml_scaffold_tpu_torch import faults
from frl_distributed_ml_scaffold_tpu_torch.config.schema import ServingConfig
from frl_distributed_ml_scaffold_tpu_torch.models.generation import (
    next_cache_bucket,
)
from frl_distributed_ml_scaffold_tpu_torch.ops._build import is_device_failure
from frl_distributed_ml_scaffold_tpu_torch.serving.engine import (
    Completion,
    ServeRequest,
    ServingEngine,
    prefill_request,
)
from frl_distributed_ml_scaffold_tpu_torch.telemetry import (
    MetricsRegistry,
    Tracer,
)
from frl_distributed_ml_scaffold_tpu_torch.utils.logging import get_logger

#: SLO classes in strict priority order: a class admits (and, for
#: ``latency``, preempts) ahead of every class to its right.
SLO_CLASSES = ("latency", "standard", "best_effort")
_RANK = {c: i for i, c in enumerate(SLO_CLASSES)}

_PARTITION_TODO = (
    "a prefill worker on its own partition (prefill_env: its own params "
    "replica and the counted transfer of suffix blocks) is not ported "
    "yet (ROADMAP queue A item 5, A7); the port's workers share one pool"
)


def _sanitize(name: str) -> str:
    """Tenant name -> metric-name-safe suffix."""
    return re.sub(r"[^A-Za-z0-9_]", "_", name)


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's SLO contract.

    ``slo_class`` orders admission (and preemption rights: only
    ``latency`` tenants preempt, and only ``best_effort`` slots are
    preemptible); ``weight`` is the weighted-round-robin share WITHIN a
    class; ``max_queue_depth`` bounds this tenant's own queue (0 = only
    the scheduler's global bound applies); ``default_deadline_s`` stamps
    requests that pass no explicit deadline."""

    name: str
    slo_class: str = "standard"
    weight: int = 1
    max_queue_depth: int = 0
    default_deadline_s: float = 0.0

    def __post_init__(self):
        if self.slo_class not in SLO_CLASSES:
            raise ValueError(
                f"tenant {self.name!r}: slo_class={self.slo_class!r} "
                f"unknown (want one of {SLO_CLASSES})"
            )
        if self.weight < 1:
            raise ValueError(
                f"tenant {self.name!r}: weight={self.weight} < 1"
            )


@dataclasses.dataclass
class _Package:
    """One completed prefill awaiting its handoff: the request, its
    pool reservation, and the prefill's outputs (``tok`` the first
    token, already on the host)."""

    req: ServeRequest
    res: dict
    spec: TenantSpec
    t_launch: float
    seq: int
    tok: int
    slot_cache: dict
    m: int
    #: Stamped when the prefill completed: the end of prefill wall time
    #: (waiting for a slot in the ready list is queueing, not prefill).
    t_ready: float


class PrefillWorker:
    """The prefill half of the disaggregated engine. Stateless across
    requests: every package it emits is self-contained, which is what
    makes a worker failure recoverable by re-queueing. It shares the
    decode worker's model and pool."""

    def __init__(self, model, *, sample_kw: dict, min_bucket: int,
                 seq_len: int, generator: torch.Generator | None = None):
        self.model = model
        self.seq_len = seq_len
        self.min_bucket = int(min_bucket)
        self._sample_kw = dict(sample_kw)
        self._generator = generator

    def _bucket_for(self, needed: int) -> int:
        return next_cache_bucket(self.seq_len, needed, floor=self.min_bucket)

    def prefill(self, req: ServeRequest, res: dict, *, block_size: int,
                seed_cache: dict | None = None) -> tuple:
        """Run the request's prefill by the shared recipe
        (``engine.prefill_request``, the code colocated admission runs);
        returns ``(tok, slot_cache, s_p, m, l_suf)`` with ``tok`` on the
        device. Consults the ``serve.prefill_worker`` site."""
        faults.maybe_raise("serve.prefill_worker", key=req.id)
        return prefill_request(
            self.model, req, res, block_size=block_size,
            bucket_for=self._bucket_for, sample_kw=self._sample_kw,
            generator=self._generator, seed_cache=seed_cache,
        )


class DisaggServingEngine:
    """The disaggregated serving facade: ``ServingEngine``'s public face
    (submit / step / run, typed ``Completion``s) over a
    PrefillWorker + decode-worker pair coordinated by the multi-tenant
    SLO scheduler. Paged cache only: the handoff is a block-table
    splice.

    Usage::

        eng = DisaggServingEngine(
            model, num_slots=4,
            serving=ServingConfig(kv_block_size=16, disaggregate=True),
            tenants=[TenantSpec("fg", "latency"),
                     TenantSpec("bg", "best_effort")],
        )
        eng.submit(prompt, max_new_tokens=32, tenant="fg")
        done = eng.run()
    """

    def __init__(
        self,
        model,
        *,
        num_slots: int = 4,
        eos_id: int | None = None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        generator: torch.Generator | None = None,
        serving: ServingConfig | None = None,
        speculate_window: int = 32,
        draft_model=None,
        draft_params: dict | None = None,
        tenants: Sequence[TenantSpec] | None = None,
        prefill_env: Any = None,
        prefill_max_per_tick: int | None = None,
        handoff_retries: int | None = None,
        telemetry: MetricsRegistry | None = None,
        tracer: Tracer | None = None,
        device=None,
    ):
        serving = ServingConfig() if serving is None else serving
        if prefill_env is not None:
            raise NotImplementedError(_PARTITION_TODO)
        if serving.kv_block_size <= 0:
            raise ValueError(
                "disaggregated serving requires the paged cache "
                "(kv_block_size > 0): the prefill→decode handoff is a "
                "block-table splice — the bucketed cache would need a "
                "cache copy, which is exactly what this engine exists "
                "to avoid"
            )
        if prefill_max_per_tick is None:
            prefill_max_per_tick = serving.prefill_max_per_tick
        if handoff_retries is None:
            handoff_retries = serving.handoff_retries
        self.prefill_max_per_tick = int(prefill_max_per_tick)
        if self.prefill_max_per_tick < 1:
            raise ValueError(
                f"prefill_max_per_tick={self.prefill_max_per_tick} < 1: "
                "the scheduler could never admit"
            )
        self.handoff_retries = int(handoff_retries)
        self.max_queue_depth = int(serving.max_queue_depth)
        self.default_deadline_s = float(serving.default_deadline_s)

        # The decode worker never sheds or checks deadlines at its
        # (empty) queue: the scheduler owns admission policy.
        self.decode = ServingEngine(
            model, num_slots=num_slots, eos_id=eos_id,
            temperature=temperature, top_k=top_k, top_p=top_p,
            generator=generator,
            serving=dataclasses.replace(
                serving, max_queue_depth=0, default_deadline_s=0.0,
                disaggregate=False,
            ),
            speculate_window=speculate_window, draft_model=draft_model,
            draft_params=draft_params, telemetry=telemetry, tracer=tracer,
            device=device,
        )
        self.prefill_worker = PrefillWorker(
            self.decode.model, sample_kw=self.decode._sample_kw,
            min_bucket=self.decode.min_bucket, seq_len=self.decode.seq_len,
            generator=generator,
        )

        # Tenant registry and queues. Unknown tenants at submit() register
        # themselves with the default (standard, weight 1) contract.
        self._tenants: dict[str, TenantSpec] = {}
        self._queues: dict[str, collections.deque[ServeRequest]] = {}
        self._rr_cycle: dict[str, list[str]] = {c: [] for c in SLO_CLASSES}
        self._rr_pos: dict[str, int] = {c: 0 for c in SLO_CLASSES}
        self._tenant_of: dict[int, str] = {}
        self._retries: dict[int, int] = {}
        self._ready: list[_Package] = []
        self._parked: list[dict] = []  # {state, spec, seq}
        self._seq = 0
        self._stats = collections.Counter()

        t = self.telemetry
        self._m_t_ttft: dict[str, Any] = {}
        self._m_t_tpot: dict[str, Any] = {}
        self._m_t_shed: dict[str, Any] = {}
        self._m_handoff = t.histogram(
            "serve_handoff_seconds",
            help="prefill→decode handoff latency (transfer + splice; "
            "the block-table re-own — prefill wall time excluded)",
        )
        self._m_handoffs = t.counter(
            "serve_handoff_total", help="prefill→decode handoffs spliced"
        )
        self._m_handoff_failures = t.counter(
            "serve_handoff_failures_total",
            help="handoff splices that failed (request re-queued)",
        )
        self._m_pw_failures = t.counter(
            "serve_prefill_worker_failures_total",
            help="prefill-worker failures (request re-queued)",
        )
        self._m_preempt = t.counter(
            "serve_preemption_total",
            help="best-effort decode slots parked for latency-class "
            "handoffs",
        )
        self._m_resume = t.counter(
            "serve_resume_total", help="parked requests resumed"
        )
        self._m_parked_g = t.gauge(
            "serve_parked_requests", help="requests currently parked"
        )
        self._m_deferred = t.counter(
            "serve_prefill_deferred_total",
            help="scheduler ticks that deferred queued prefills "
            "(decoupled admission: the burst queues, decodes keep cadence)",
        )
        # Registered for the full catalog. Shared-pool handoffs have no
        # transfer path, so it reads 0 by construction (the separate
        # partition that counts its transfers is ROADMAP A7).
        t.counter(
            "serve_handoff_transfer_bytes_total",
            help="bytes moved across partitions at handoff (0 when the "
            "partitions share the pool — the blocks merely re-own)",
        )
        for spec in tenants or ():
            self.register_tenant(spec)

    # ------------------------------------------------------------- plumbing

    @property
    def telemetry(self) -> MetricsRegistry:
        return self.decode.telemetry

    @property
    def paged(self) -> bool:
        return True

    @property
    def num_slots(self) -> int:
        return self.decode.num_slots

    @property
    def eos_id(self):
        return self.decode.eos_id

    @property
    def bucket(self) -> int:
        return self.decode.bucket

    @property
    def block_size(self) -> int:
        return self.decode.block_size

    @property
    def pool_blocks(self) -> int:
        return self.decode.pool_blocks

    @property
    def stats(self) -> collections.Counter:
        merged = collections.Counter(self.decode.stats)
        merged.update(self._stats)
        return merged

    def block_bytes(self) -> int:
        return self.decode.block_bytes()

    def bytes_per_slot(self) -> int:
        return self.decode.bytes_per_slot()

    def pool_utilization(self) -> float:
        return self.decode.pool_utilization()

    def export_trace(self, path: str) -> None:
        self.decode.export_trace(path)

    def reset_cache(self) -> None:
        """The measurement loop's warm-up contract, facade-wide."""
        if self.pending:
            raise RuntimeError("reset_cache with requests in flight")
        self.decode.reset_cache()
        self._stats.clear()
        self._retries.clear()
        self._tenant_of.clear()

    @property
    def pending(self) -> int:
        return (
            sum(len(q) for q in self._queues.values())
            + len(self._ready)
            + len(self._parked)
            + int(self.decode._active.sum())
        )

    # ------------------------------------------------------------- frontend

    def register_tenant(self, spec: TenantSpec) -> None:
        if spec.name in self._tenants:
            raise ValueError(f"tenant {spec.name!r} already registered")
        clash = next(
            (n for n in self._tenants if _sanitize(n) == _sanitize(spec.name)),
            None,
        )
        if clash is not None:
            raise ValueError(
                f"tenant {spec.name!r} collides with {clash!r} after metric-"
                f"name sanitization ({_sanitize(spec.name)!r}) — their "
                "per-tenant histograms/counters would silently merge"
            )
        self._tenants[spec.name] = spec
        self._queues[spec.name] = collections.deque()
        # Weighted round-robin: the tenant appears ``weight`` times in
        # its class's cycle.
        self._rr_cycle[spec.slo_class].extend([spec.name] * spec.weight)
        t, s = self.telemetry, _sanitize(spec.name)
        self._m_t_ttft[spec.name] = t.histogram(
            f"serve_ttft_seconds_tenant_{s}",
            help=f"TTFT, tenant {spec.name} ({spec.slo_class})",
        )
        self._m_t_tpot[spec.name] = t.histogram(
            f"serve_tpot_seconds_tenant_{s}",
            help=f"inter-token gap, tenant {spec.name} ({spec.slo_class})",
        )
        self._m_t_shed[spec.name] = t.counter(
            f"serve_shed_total_tenant_{s}",
            help=f"requests shed, tenant {spec.name}",
        )

    def submit(self, prompt, max_new_tokens: int,
               request_id: int | None = None, *,
               deadline_s: float | None = None,
               tenant: str = "default") -> int:
        """Enqueue under ``tenant``'s SLO contract; returns the id. Sheds
        are typed and SLO-ordered: a full global queue sheds the newest
        request of the LOWEST queued class to make room for a
        higher-class arrival."""
        spec = self._tenants.get(tenant)
        if spec is None:
            spec = TenantSpec(name=tenant)
            self.register_tenant(spec)
        if deadline_s is None and spec.default_deadline_s:
            deadline_s = spec.default_deadline_s
        req = self.decode._new_request(
            prompt, max_new_tokens, request_id,
            deadline_s=(self.default_deadline_s if deadline_s is None
                        else deadline_s),
        )
        self._tenant_of[req.id] = tenant
        q = self._queues[tenant]
        if spec.max_queue_depth and len(q) >= spec.max_queue_depth:
            self._shed(req, spec)
            return req.id
        if self.max_queue_depth:
            total = sum(len(qq) for qq in self._queues.values())
            if total >= self.max_queue_depth:
                victim = self._shed_victim(than=spec)
                if victim is None:
                    self._shed(req, spec)
                    return req.id
                vq, vspec = victim
                self._shed(vq.pop(), vspec)
        q.append(req)
        return req.id

    def _shed(self, req: ServeRequest, spec: TenantSpec) -> None:
        self.decode._m_shed.inc()
        self._m_t_shed[spec.name].inc()
        self._stats[f"shed_{spec.name}"] += 1
        self.decode._complete_unadmitted(req, "shed")

    def _shed_victim(self, than: TenantSpec):
        """The newest queued request of the lowest class STRICTLY below
        ``than``: lowest class first; among same-class tenants, the one
        whose queue TAIL arrived last. None: nothing outranked (the
        arrival itself sheds)."""
        best = None  # (rank, tail t_submit, name)
        for name, q in self._queues.items():
            if not q:
                continue
            r = _RANK[self._tenants[name].slo_class]
            if r <= _RANK[than.slo_class]:
                continue
            key = (r, q[-1].t_submit)
            if best is None or key > (best[0], best[1]):
                best = (r, q[-1].t_submit, name)
        if best is None:
            return None
        name = best[2]
        return self._queues[name], self._tenants[name]

    # ----------------------------------------------------------- scheduling

    def _next_request(self):
        """Highest-class, weighted-round-robin queued request (queued
        past-deadline requests shed typed on the way). Returns ``(queue,
        req, spec, rr)`` WITHOUT popping or advancing the round-robin
        cursor: the caller commits ``rr`` only once the request launches,
        so a deferred head keeps its turn."""
        for cls in SLO_CLASSES:
            order = self._rr_cycle[cls]
            n = len(order)
            start = self._rr_pos[cls] % n if n else 0
            for i in range(n):
                name = order[(start + i) % n]
                q = self._queues[name]
                while q:
                    req = q[0]
                    if self.decode._expired(req):
                        q.popleft()
                        self.decode._m_deadline.inc()
                        self.decode._complete_unadmitted(req, "deadline")
                        continue
                    return (q, req, self._tenants[name],
                            (cls, (start + i + 1) % n))
        return None

    def _commit_rr(self, rr) -> None:
        cls, pos = rr
        self._rr_pos[cls] = pos

    def _preemptible_slots(self) -> list[int]:
        """Active decode slots owned by best-effort tenants (the only
        preemptible class), most-remaining-budget first."""
        out = []
        for slot in np.flatnonzero(self.decode._active):
            slot = int(slot)
            req = self.decode._req[slot]
            spec = self._tenants.get(self._tenant_of.get(req.id, ""), None)
            if spec is not None and spec.slo_class == "best_effort":
                remaining = req.max_new_tokens - len(self.decode._tokens[slot])
                out.append((remaining, slot))
        return [s for _, s in sorted(out, reverse=True)]

    def _launch_prefills(self) -> None:
        """Start up to ``prefill_max_per_tick`` prefills. A prefill
        launches only when a handoff target exists (a free slot net of
        packages in flight or, for a latency-class request, a preemptible
        best-effort slot); pool headroom defers the head request as
        colocated admission does."""
        launched = 0
        while launched < self.prefill_max_per_tick:
            pick = self._next_request()
            if pick is None:
                break
            q, req, spec, rr = pick
            free = int((~self.decode._active).sum())
            # Parked requests reserve no slot here: they outrank
            # non-latency handoffs at placement, and counting them would
            # deadlock a queued latency request against a parked victim.
            cap = free - len(self._ready)
            if cap <= 0 and spec.slo_class == "latency":
                n_lat_pending = sum(
                    1 for p in self._ready
                    if p.spec.slo_class == "latency"
                )
                cap += max(
                    0, len(self._preemptible_slots()) - n_lat_pending
                )
            if cap <= 0:
                self._stats["prefill_deferred"] += 1
                self._m_deferred.inc()
                break
            res = self.decode._pool_reserve(req)
            if res is None:
                self._stats["admission_deferred"] += 1
                self._m_deferred.inc()
                break
            q.popleft()
            self._commit_rr(rr)
            t_launch = time.perf_counter()
            self.decode._phase(
                "queue_wait", t0=req.t_submit,
                dur_s=t_launch - req.t_submit,
                trace=req.trace, parent=req.span, tenant=spec.name,
            )
            try:
                # The shared-prefix seed gathers from the decode pool.
                seed_cache = self.decode._seed_for(req, res)
                tok, slot_cache, _, m, _ = self.prefill_worker.prefill(
                    req, res, block_size=self.decode.block_size,
                    seed_cache=seed_cache,
                )
                # The prefill ran on the engine's stream: the token fetch
                # waits for it, as colocated admission's does, and a
                # prefill that failed on the device surfaces here, before
                # any preemption could park a victim for it.
                tok = int(tok[0])
            except Exception as e:
                if is_device_failure(e):
                    raise
                self._worker_failed(req, res, spec, e, site="prefill_worker")
                continue
            self._seq += 1
            self._ready.append(_Package(
                req=req, res=res, spec=spec, t_launch=t_launch,
                seq=self._seq, tok=tok, slot_cache=slot_cache, m=m,
                t_ready=time.perf_counter(),
            ))
            self._stats["prefills_launched"] += 1
            launched += 1
        if launched >= self.prefill_max_per_tick and any(
            self._queues.values()
        ):
            # Budget exhausted with work still queued: the deferral the
            # decoupling exists for.
            self._stats["prefill_deferred"] += 1
            self._m_deferred.inc()

    def _fill_slots(self) -> None:
        """Place ready handoffs and resume parked requests, SLO-ordered:
        expired parked requests retire typed first (their blocks come
        straight back), then latency handoffs (preempting best-effort
        slots when full), then parked resumes (they hold pool blocks),
        then the remaining handoffs."""
        self._expire_parked()
        self._ready.sort(key=lambda p: (_RANK[p.spec.slo_class], p.seq))
        self._place_ready(only_latency=True)
        self._resume_parked()
        self._place_ready(only_latency=False)
        self._m_parked_g.set(float(len(self._parked)))

    def _expire_parked(self) -> None:
        """A parked request past its deadline retires typed
        ``"deadline"`` in place (``ServingEngine.retire_parked``): the
        tokens before the park come back, its blocks and reservation
        release now."""
        still: list[dict] = []
        for entry in self._parked:
            req = entry["state"]["req"]
            if self.decode._expired(req):
                self.decode._m_deadline.inc()
                self.decode.retire_parked(entry["state"], "deadline")
            else:
                still.append(entry)
        self._parked = still

    def _free_slot(self) -> int | None:
        free = np.flatnonzero(~self.decode._active)
        return int(free[0]) if free.size else None

    def _place_ready(self, *, only_latency: bool) -> None:
        rest: list[_Package] = []
        for pkg in self._ready:
            if only_latency and pkg.spec.slo_class != "latency":
                rest.append(pkg)
                continue
            if self.decode._expired(pkg.req):
                # Expired while prefilling or waiting for a slot: resolve
                # typed now (the prefill output is discarded) instead of
                # parking a healthy victim for an unwanted answer.
                self.decode._pool_release(pkg.res)
                self.decode._m_deadline.inc()
                self._retries.pop(pkg.req.id, None)
                self.decode._complete_unadmitted(pkg.req, "deadline")
                continue
            slot = self._free_slot()
            if slot is None and pkg.spec.slo_class == "latency":
                victims = self._preemptible_slots()
                if victims:
                    slot = victims[0]
                    vreq = self.decode._req[slot]
                    vspec = self._tenants[self._tenant_of[vreq.id]]
                    state = self.decode.park_slot(slot)
                    self._parked.append(
                        {"state": state, "spec": vspec, "seq": self._seq}
                    )
                    self._seq += 1
                    self._m_preempt.inc()
                    self._stats["preemptions"] += 1
            if slot is None:
                rest.append(pkg)
                continue
            self._complete_handoff(pkg, slot)
        self._ready = rest

    def _resume_parked(self) -> None:
        """Resume parked requests into free slots, class-ordered. A
        best-effort parked request stays parked while a latency request
        waits for a slot (it would be preempted right back)."""
        latency_waiting = any(
            p.spec.slo_class == "latency"
            for p in self._ready
        ) or any(
            q and self._tenants[n].slo_class == "latency"
            for n, q in self._queues.items()
        )
        self._parked.sort(
            key=lambda e: (_RANK[e["spec"].slo_class], e["seq"])
        )
        still: list[dict] = []
        for entry in self._parked:
            slot = self._free_slot()
            if slot is None or (
                latency_waiting
                and entry["spec"].slo_class == "best_effort"
            ):
                still.append(entry)
                continue
            self.decode.resume_parked(entry["state"], slot)
            self._m_resume.inc()
        self._parked = still

    def _complete_handoff(self, pkg: _Package, slot: int) -> None:
        """Splice the package's private blocks into the pool (a table
        re-own: the pool is shared)."""
        req, res, spec = pkg.req, pkg.res, pkg.spec
        # Prefill wall = launch -> completion; slot-wait stays out of TTFT.
        prefill_s = pkg.t_ready - pkg.t_launch
        t_h0 = time.perf_counter()
        try:
            faults.maybe_raise("serve.handoff", key=req.id)
            self.decode.admit_handoff(
                slot, req, res, pkg.slot_cache, pkg.tok,
                m=pkg.m, prefill_s=prefill_s,
            )
        except Exception as e:
            if is_device_failure(e):
                raise
            self._worker_failed(req, res, spec, e, site="handoff")
            return
        dt = time.perf_counter() - t_h0
        self._m_handoff.observe(dt)
        self._m_handoffs.inc()
        self._stats["handoffs"] += 1
        self._retries.pop(req.id, None)
        self._m_t_ttft[spec.name].observe(prefill_s + dt)

    def _worker_failed(self, req: ServeRequest, res: dict, spec: TenantSpec,
                       err: Exception, *, site: str) -> None:
        """Release the reservation, count, and re-queue at the head of
        the tenant queue; past ``handoff_retries`` the request resolves
        as a typed ``"error"``: a worker failure can delay a request,
        never strand it."""
        self.decode._pool_release(res)
        counter = (
            self._m_pw_failures if site == "prefill_worker"
            else self._m_handoff_failures
        )
        counter.inc()
        self._stats[f"{site}_failures"] += 1
        n = self._retries.get(req.id, 0) + 1
        self._retries[req.id] = n
        if n > self.handoff_retries:
            get_logger().warning(
                "serving: %s failed for request %d (%s: %s) — retries "
                "exhausted (%d), resolving typed error",
                site, req.id, type(err).__name__, err, self.handoff_retries,
            )
            self._retries.pop(req.id, None)
            self.decode._m_quarantined.inc()
            self.decode.stats["quarantined"] += 1
            self.decode._complete_unadmitted(req, "error")
            return
        get_logger().warning(
            "serving: %s failed for request %d (%s: %s) — re-queueing "
            "(attempt %d/%d)",
            site, req.id, type(err).__name__, err, n, self.handoff_retries,
        )
        self._stats[f"{site}_requeued"] += 1
        self._queues[spec.name].appendleft(req)

    # ----------------------------------------------------------------- step

    def step(self) -> list[Completion]:
        """One scheduler tick: complete ready handoffs, resume parked
        requests, launch at most ``prefill_max_per_tick`` prefills, then
        run ONE decode iteration. Returns completions, tenant-annotated,
        typed resolutions included."""
        self._fill_slots()
        self._launch_prefills()
        self._fill_slots()
        out = self.decode.step()
        self.decode._m_queue.set(
            float(sum(len(q) for q in self._queues.values()))
        )
        for c in out:
            self._annotate(c)
        return out

    def run(self, max_steps: int | None = None) -> list[Completion]:
        """Drain everything: every submitted id resolves exactly once,
        typed resolutions included."""
        out: list[Completion] = []
        steps = 0
        while self.pending:
            out.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        tail = self.decode._drain_completed() + list(self.decode._early)
        self.decode._early.clear()
        for c in tail:
            self._annotate(c)
        out.extend(tail)
        return out

    def _annotate(self, c: Completion) -> None:
        """Tenant attribution and per-tenant SLO observations (TPOT as
        inter-token GAPS, what a tenant experiences, prefill stalls
        included)."""
        name = self._tenant_of.pop(c.id, "")
        self._retries.pop(c.id, None)
        c.tenant = name
        h = self._m_t_tpot.get(name)
        if h is not None and len(c.token_times_s) > 1:
            for gap in np.diff(np.asarray(c.token_times_s)):
                h.observe(float(gap))
