"""Disaggregated prefill/decode serving and the multi-tenant SLO
scheduler: the port of the JAX package's ``serving/scheduler.py``.

Prefill is compute-bound (one big ragged forward over the prompt), decode
is bandwidth-bound (one small forward per token against the whole KV
pool). The colocated engine admits into EVERY free slot before each
decode tick, so a burst of prompt-heavy arrivals runs several full
prefills ahead of the next token. This module splits the two:

- **PrefillWorker** owns admission's prefill (the bucketed ragged
  prefill and the shared-prefix seeded suffix prefill, the recipe of
  ``engine.prefill_request``). By default it shares the decode worker's
  model and pool and runs on the engine's stream, as colocated admission
  does; fetching the first token completes the package. With
  ``prefill_env`` it is a SEPARATE PARTITION holding its own whole params
  replica, moved from the decode model's placement by the redistribution
  service (``redistribute.to_mesh`` with a whole spec; ``replica_plan``
  keeps the plan): a ``torch.device`` of this process (beside a live
  ``model`` axis too: the replica gathers every head), a ``MeshEnv`` over
  the decode mesh's own ranks (each prefills on its replica), or a
  ``MeshEnv`` of OTHER ranks. The last is remote: every rank runs the
  engine in lock step, the decode mesh's ranks schedule, and the
  partition's ranks serve the prefills its first rank commands (one
  command a launch, one tick message a step, point to point), so they
  never need the decode side's state.
- **The decode worker** is a paged ``ServingEngine`` driven with an
  empty queue: it runs the decode / verify steps (speculation rides it
  unchanged) and splices handoffs.
- **The handoff is a block-table splice** (``generation.
  splice_pool_blocks``, as colocated admission): the prefilled private
  blocks land in their pool homes and ownership moves as one table-row
  write. When the partitions share the pool the blocks merely re-own and
  ``stats["handoff_transfer_bytes"]`` stays 0. A separate partition's
  handoff moves exactly the private blocks' window ``[m bs, n_g bs)`` of
  the slot cache to the decode side (``_capacity_slice``), and a prefix
  hit first moves the seed's occupied prefix out to the worker; both
  move by a redistribution plan (the decode side's heads split over
  ``model``, the worker's whole) and are counted in
  ``handoff_transfer_bytes`` and ``serve_handoff_transfer_bytes_total``
  at the one site ``_count_transfer``, as the JAX engine counts them
  (every leaf of what moves at its whole size, the window's K/V and
  scales and the cursors beside them). From a remote partition the
  window moves when the prefill ends and is counted at its handoff.
- **Over a mesh** (tensor-parallel serving, ``build_engine(rules=)``)
  every rank runs the scheduler in lock step with the decode worker
  (``serving/engine.py``): each tick starts with rank 0's plan of the
  deadlines, and the prefill worker's first tokens are rank 0's. The
  shared pool holds each rank's heads, so the splice moves no bytes
  between ranks.

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
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import re
import time
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from frl_distributed_ml_scaffold_tpu_torch import faults
from frl_distributed_ml_scaffold_tpu_torch import redistribute as rd
from frl_distributed_ml_scaffold_tpu_torch.config.schema import ServingConfig
from frl_distributed_ml_scaffold_tpu_torch.dist.initialize import (
    process_index,
)
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
    MeshEnv,
    mesh_context,
    one_rank_mesh,
)
from frl_distributed_ml_scaffold_tpu_torch.models.generation import (
    POOL_LEAF_OF,
    blocks_for_tokens,
    cache_capacity_axis,
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

def _capacity_slice(cache: dict, start_tok: int, stop_tok: int,
                    cap: int) -> dict:
    """A slot cache's capacity-bearing leaves (``cache_capacity_axis``:
    K/V and scale stacks at capacity ``cap``) cut to positions
    ``[start_tok, stop_tok)``; the bookkeeping leaves as they are. What a
    cross-partition handoff moves: the blocks that change owner, never
    the whole bucket."""
    out = {}
    for name, leaf in cache.items():
        ax = cache_capacity_axis(leaf, cap)
        out[name] = (leaf if ax is None
                     else leaf.narrow(ax, start_tok, stop_tok - start_tok))
    return out


def _capacity_pad(cache: dict, cap_from: int, cap_to: int) -> dict:
    """``_capacity_slice``'s inverse on the receiving side: the
    capacity-bearing leaves zero-padded from ``cap_from`` back to
    ``cap_to`` (the zeros the whole tree carried)."""
    out = {}
    for name, leaf in cache.items():
        ax = cache_capacity_axis(leaf, cap_from)
        if ax is None:
            out[name] = leaf
            continue
        shape = list(leaf.shape)
        shape[ax] = cap_to - cap_from
        out[name] = torch.cat([leaf, leaf.new_zeros(shape)], ax)
    return out


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


def _slot_heads_axis(name: str, ndim: int) -> int | None:
    """The heads axis of a slot-cache leaf: K/V ``[L, B, S, H, hd]`` at
    ``ndim - 2``, scales ``[L, B, S, H]`` at ``ndim - 1``; the cursors
    carry none."""
    if name not in POOL_LEAF_OF:
        return None
    return ndim - 2 if name in ("cached_key", "cached_value") else ndim - 1


def _ranks(env: MeshEnv) -> set[int]:
    return {int(r) for r in env.ranks.flat}


class PrefillWorker:
    """The prefill half of the disaggregated engine. Stateless across
    requests: every package it emits is self-contained, which is what
    makes a worker failure recoverable by re-queueing. It shares the
    decode worker's model and pool, or with ``partition`` (a
    ``torch.device`` of this process, or a ``MeshEnv``) holds its own
    whole params replica there, moved from the decode model's placement
    on ``decode_env`` by the redistribution service (``replica_plan``).
    ``place_env`` is the mesh its trees are whole on, ``device`` where it
    prefills; ``remote`` when the partition's ranks are not the decode
    mesh's."""

    def __init__(self, model, *, sample_kw: dict, min_bucket: int,
                 seq_len: int, generator: torch.Generator | None = None,
                 partition=None, decode_env: MeshEnv | None = None,
                 rules=None, device=None):
        self.partition = partition
        self.rules = rules
        self.replica_plan = None
        self.remote = False
        self.device = model.device
        self._no_decode_mesh = decode_env is None
        self.place_env = decode_env if decode_env is not None else (
            one_rank_mesh())
        if partition is not None:
            model = self._replica(model, partition, device)
        self.model = model
        self.seq_len = seq_len
        self.min_bucket = int(min_bucket)
        self._sample_kw = dict(sample_kw)
        self._generator = generator

    def _replica(self, model, partition, device):
        """The whole params replica: gathered from the decode placement
        (``serving_specs`` over the decode engine's ``rules``) onto
        ``place_env`` with a whole spec. A rank outside the partition
        keeps none."""
        from frl_distributed_ml_scaffold_tpu_torch.parallel.partition import (
            serving_specs,
        )

        decode_env = self.place_env
        if isinstance(partition, MeshEnv):
            mine, theirs = _ranks(partition), _ranks(decode_env)
            if mine != theirs and mine & theirs:
                raise ValueError(
                    f"prefill partition ranks {sorted(mine)} share some but "
                    f"not all of the decode mesh's {sorted(theirs)}: a "
                    "partition is the decode mesh's ranks or other ranks")
            self.remote = not (mine & theirs)
            if self.remote and self._no_decode_mesh:
                raise ValueError(
                    "a prefill partition of other ranks needs the decode "
                    "engine built inside its mesh (mesh_context)")
            self.place_env = partition
            self.device = torch.device(device if device is not None
                                       else model.device)
        else:
            self.device = torch.device(partition)
        replica = copy.deepcopy(model).to(self.device)
        specs = serving_specs(model, decode_env, self.rules)
        meta = type(model)(model.config, model.policy, device="meta")
        src = {k: rd.Abstract.of(p.shape, p.dtype,
                                 rd.Placement(decode_env, specs[k]))
               for k, p in meta.named_parameters()}
        params = dict(replica.named_parameters())
        placed, self.replica_plan = rd.to_mesh(
            {k: p.data for k, p in params.items()}, src, self.place_env,
            spec_of=lambda *_: (), donate=True, device=self.device)
        with torch.no_grad():
            for k, p in params.items():
                p.data = (placed[k].to(self.device) if k in placed
                          else p.data.new_empty(0))
        return replica

    @property
    def separate(self) -> bool:
        return self.partition is not None

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
        rules=None,
        device=None,
    ):
        serving = ServingConfig() if serving is None else serving
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
            rules=rules, device=device,
        )
        if prefill_env is not None and not isinstance(prefill_env, MeshEnv):
            prefill_env = torch.device(prefill_env)
        self.prefill_worker = PrefillWorker(
            self.decode.model, sample_kw=self.decode._sample_kw,
            min_bucket=self.decode.min_bucket, seq_len=self.decode.seq_len,
            generator=generator, partition=prefill_env,
            decode_env=self.decode._env, rules=rules, device=device,
        )
        # A remote partition's ranks (not the decode mesh's) serve
        # prefill commands; the last tick's pending count is theirs.
        self._serves_prefills = (self.prefill_worker.remote
                                 and self.decode._dormant)
        self._remote_pending: int | None = None

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
        # Shared-pool handoffs have no transfer path, so it reads 0 there
        # by construction; a separate partition counts its moves (_put).
        self._m_transfer = t.counter(
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
        if self._serves_prefills and self._remote_pending is not None:
            return self._remote_pending
        if self.decode._dormant and not self._serves_prefills:
            return 0
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
        self._remote_pending = None
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
            err = None
            try:
                # The shared-prefix seed gathers from the decode pool; a
                # separate partition takes only its occupied prefix.
                seed_cache = self.decode._seed_for(req, res)
                if self.prefill_worker.remote:
                    first, slot_cache, m = self._remote_prefill(
                        req, res, seed_cache)
                else:
                    if (seed_cache is not None
                            and self.prefill_worker.separate):
                        seed_cache = self._seed_out(req, res, seed_cache)
                    tok, slot_cache, _, m, _ = self.prefill_worker.prefill(
                        req, res, block_size=self.decode.block_size,
                        seed_cache=seed_cache,
                    )
                    # The prefill ran on the engine's stream: the token
                    # fetch waits for it, as colocated admission's does,
                    # and a prefill that failed on the device surfaces
                    # here, before any preemption could park a victim.
                    first = int(tok[0])
            except Exception as e:
                if is_device_failure(e):
                    raise
                err = e
            if self.decode._agree_failed(err is not None):
                self._worker_failed(
                    req, res, spec,
                    err or RuntimeError("prefill failed on another rank"),
                    site="prefill_worker")
                continue
            if self.decode._lockstep and not self.prefill_worker.remote:
                first = int(self.decode._agree(tok)[0])
            self._seq += 1
            self._ready.append(_Package(
                req=req, res=res, spec=spec, t_launch=t_launch,
                seq=self._seq, tok=first, slot_cache=slot_cache, m=m,
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

    def _count_transfer(self, moved: int) -> None:
        self._stats["handoff_transfer_bytes"] += moved
        self._m_transfer.inc(moved)

    def _heads_split(self) -> bool:
        """Whether the decode side's caches hold a slice of the heads."""
        env = self.decode._env
        m = 1 if env is None else env.axis_size("model")
        return m > 1 and self.decode.model.config.num_heads % m == 0

    def _abstract(self, tree: dict, *, split: bool) -> dict:
        """A slot-cache tree's leaves as (whole shape, dtype): every
        head where this rank holds a slice of them (``split``)."""
        heads = self.decode.model.config.num_heads
        out = {}
        for k, t in tree.items():
            shape = list(t.shape)
            ax = _slot_heads_axis(k, t.dim())
            if split and ax is not None and self._heads_split():
                shape[ax] = heads
            out[k] = (tuple(shape), rd.plan.dtype_name(t.dtype))
        return out

    def _move(self, tree: dict, abstract: dict, *, to_worker: bool) -> dict:
        """Move a slot-cache tree between the decode side (heads split
        over ``model`` where the pool splits them) and the worker (whole
        on ``place_env``) by a redistribution plan; every rank of both
        takes part. Returns this rank's tensors on its side's device."""
        dec = (self.decode._env if self.decode._env is not None
               else one_rank_mesh())
        worker = rd.Placement(self.prefill_worker.place_env, ())
        split = self._heads_split()
        src, dst = {}, {}
        for k, (shape, dtype) in abstract.items():
            ax = _slot_heads_axis(k, len(shape))
            spec = [None] * len(shape)
            if split and ax is not None:
                spec[ax] = "model"
            d = rd.Placement(dec, tuple(spec))
            src[k] = rd.Abstract.of(shape, dtype, d if to_worker else worker)
            dst[k] = worker if to_worker else d
        dev = (self.prefill_worker.device if to_worker
               else self.decode.model.device)
        out = rd.execute(rd.compile_tree_plan(src, dst), tree, donate=False,
                         device=dev)
        return {k: t.to(dev) for k, t in out.items()}

    def _whole_bytes(self, abstract: dict) -> int:
        return sum(int(np.prod(shape)) * rd.plan.itemsize(dtype)
                   for shape, dtype in abstract.values())

    def _seed_out(self, req: ServeRequest, res: dict, seed: dict | None,
                  abstract: dict | None = None) -> dict:
        """A prefix hit's seed, its occupied prefix moved out to the
        worker (counted) and padded back to its bucket there."""
        m_tok = res["m"] * self.decode.block_size
        s_c = self.decode._bucket_for(int(req.prompt.size))
        if abstract is None:
            seed = _capacity_slice(seed, 0, m_tok, s_c)
            abstract = self._abstract(seed, split=True)
        if not self._serves_prefills:
            self._count_transfer(self._whole_bytes(abstract))
        return _capacity_pad(self._move(seed or {}, abstract,
                                        to_worker=True), m_tok, s_c)

    # ------------------------------------------------- a remote partition

    def _decode_lead(self) -> int:
        return int(self.decode._env.ranks.flat[0])

    def _command(self, msg: dict) -> None:
        """The decode mesh's first rank's message to every rank of the
        remote partition."""
        if process_index() == self._decode_lead():
            for r in sorted(_ranks(self.prefill_worker.place_env)):
                dist.send_object_list([msg], dst=r)

    def _remote_prefill(self, req: ServeRequest, res: dict,
                        seed: dict | None) -> tuple:
        """The decode side of a remote prefill: command it, move the
        seed out, take the partition's answer and move its window in
        (counted at the handoff). Returns ``(first, window, m)``."""
        seed_abs = None
        if seed is not None:
            m_tok = res["m"] * self.decode.block_size
            s_c = self.decode._bucket_for(int(req.prompt.size))
            seed = _capacity_slice(seed, 0, m_tok, s_c)
            seed_abs = self._abstract(seed, split=True)
        self._command({"op": "prefill", "id": req.id, "prompt": req.prompt,
                       "new": req.max_new_tokens, "m": res["m"],
                       "seed": seed_abs})
        if seed is not None:
            self._seed_out(req, res, seed, seed_abs)
        box = [None]
        dist.recv_object_list(
            box, src=int(self.prefill_worker.place_env.ranks.flat[0]))
        ans = box[0]
        if ans["err"] is not None:
            raise RuntimeError(f"remote prefill failed: {ans['err']}")
        window = self._move({}, ans["window"], to_worker=False)
        return ans["tok"], window, ans["m"]

    def _serve_tick(self) -> list[Completion]:
        """A remote partition rank's step: serve the decode side's
        prefill commands until its tick message (which carries the
        decode side's pending count)."""
        pw, bs = self.prefill_worker, self.decode.block_size
        lead = int(pw.place_env.ranks.flat[0])
        decode_ranks = sorted(_ranks(self.decode._env))
        while True:
            box = [None]
            dist.recv_object_list(box, src=self._decode_lead())
            cmd = box[0]
            if cmd["op"] == "tick":
                self._remote_pending = cmd["pending"]
                return []
            req = ServeRequest(cmd["id"], np.asarray(cmd["prompt"]),
                               cmd["new"])
            res = {"m": cmd["m"]}
            seed = None
            if cmd["seed"] is not None:
                seed = self._seed_out(req, res, {}, cmd["seed"])
            window, ans = None, {"err": None}
            try:
                with mesh_context(None):
                    tok, slot_cache, _, m, _ = pw.prefill(
                        req, res, block_size=bs, seed_cache=seed)
                n_g = blocks_for_tokens(int(req.prompt.size), bs)
                cap = slot_cache["cached_key"].shape[2]
                window = _capacity_slice(slot_cache, m * bs, n_g * bs, cap)
                ans.update(tok=int(tok[0]), m=m,
                           window=self._abstract(window, split=False))
            except Exception as e:
                if is_device_failure(e):
                    raise
                ans["err"] = f"{type(e).__name__}: {e}"
            if process_index() == lead:
                for r in decode_ranks:
                    dist.send_object_list([ans], dst=r)
            if window is not None:
                self._move(window, ans["window"], to_worker=False)

    def _complete_handoff(self, pkg: _Package, slot: int) -> None:
        """Splice the package's private blocks into the pool (a table
        re-own when the pool is shared; from a separate partition, the
        blocks' window moves to the decode side first)."""
        req, res, spec = pkg.req, pkg.res, pkg.spec
        # Prefill wall = launch -> completion; slot-wait stays out of TTFT.
        prefill_s = pkg.t_ready - pkg.t_launch
        t_h0 = time.perf_counter()
        try:
            faults.maybe_raise("serve.handoff", key=req.id)
            slot_cache = pkg.slot_cache
            sliced = self.prefill_worker.separate
            if self.prefill_worker.remote:
                # The window moved when the prefill ended.
                self._count_transfer(self._whole_bytes(
                    self._abstract(slot_cache, split=True)))
            elif sliced:
                # Exactly the private blocks that change owner: the
                # [m bs, n_g bs) window (the shared prefix already lives
                # in the decode pool; the bucket's tail carries nothing).
                bs = self.decode.block_size
                n_g = blocks_for_tokens(int(req.prompt.size), bs)
                cap = slot_cache["cached_key"].shape[2]
                window = _capacity_slice(slot_cache, pkg.m * bs, n_g * bs,
                                         cap)
                abstract = self._abstract(window, split=False)
                self._count_transfer(self._whole_bytes(abstract))
                slot_cache = self._move(window, abstract, to_worker=False)
            self.decode.admit_handoff(
                slot, req, res, slot_cache, pkg.tok,
                m=pkg.m, prefill_s=prefill_s, sliced=sliced,
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
        if self._serves_prefills:
            return self._serve_tick()
        if self.decode._dormant:
            return []
        with self.decode._mesh():
            self.decode._plan_step(self._live_requests())
            self._fill_slots()
            self._launch_prefills()
            self._fill_slots()
            out = self.decode._step()
        if self.prefill_worker.remote:
            self._command({"op": "tick", "pending": self.pending})
        self.decode._m_queue.set(
            float(sum(len(q) for q in self._queues.values()))
        )
        for c in out:
            self._annotate(c)
        return out

    def _live_requests(self) -> list[ServeRequest]:
        """Every request the tick may judge: queued, prefilled, parked or
        decoding."""
        return ([r for q in self._queues.values() for r in q]
                + [p.req for p in self._ready]
                + [e["state"]["req"] for e in self._parked]
                + [r for r in self.decode._req if r is not None])

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
