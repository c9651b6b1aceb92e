"""Host-side continuous-batching decode engine over a fixed slot array.

The port of the JAX package's ``serving/engine.py``:

- **Slots**: the decode batch is a fixed ``[num_slots]`` row array; each
  row is an independent request with its own cache index and positions,
  so rows at different occupancies decode together in one step.
- **Continuous batching**: a row that emits eos or exhausts its budget
  retires (its completion is returned, the slot freed) and the next
  queued request is prefilled alone, at its own prompt bucket, and its
  cache rows are grafted into the freed row while the others keep
  decoding.
- **Cache buckets** (``serving.kv_block_size=0``): the engine cache
  starts at the smallest power-of-two bucket covering the live requests
  and grows bucket by bucket (a pad along the capacity axis) only when an
  active row needs the room; the decode kernel reads only each row's
  occupied prefix within it. Retired rows ride the decode step until
  refilled; their writes past the bucket are dropped (models/gpt.py).
- **Paged cache** (``serving.kv_block_size > 0``): a fixed POOL of
  fixed-size KV blocks plus per-slot block tables replaces the bucketed
  cache (ops/decode_attention.py paged kernels). Growth is appending one
  block to a table. Admission reserves a request's worst-case block count
  up front, so a mid-decode append never fails, and a full pool makes the
  queue head wait. Block 0 is the trash block: retired rows' tables point
  at it. Prefill stays contiguous; the graft splices exactly the blocks
  that change owner into the pool. A refcounted SHARED-PREFIX cache rides
  the same allocator: a prompt whose leading full blocks match a cached
  chain reuses those blocks (prefill runs on the suffix only, seeded with
  the shared prefix gathered from the pool), with copy-on-write at the
  first divergent or partial block.
- **Speculation** (paged engine, greedy only): ``serving.speculate=ngram``
  drafts from each slot's own history; ``speculate=draft`` proposes with
  a small draft GPT (one batched ``generate`` over every slot's
  left-padded ``speculate_window`` history). One verify forward of every
  slot's ``[k + 1]`` tile accepts the longest draft prefix matching the
  greedy predictions plus the target's own next token, then rolls back:
  tail blocks return to the pool and every cursor rewinds. Acceptance is
  exact, so the output is token-identical to plain decode. A proposer
  failure (the ``serve.draft`` site) degrades the slot to plain decode
  for the rest of its request.
- **Quantized cache** (``model.kv_cache_quant``): the bf16 scale leaves
  grow, graft, splice and seed with the K/V leaves they scale (by shape
  and by name, ``models/generation.py``); 1-byte fp8 leaves move as
  bytes. Pool accounting reads the actual leaves, scales included.
- **Typed failures**: every submitted request resolves to exactly one
  ``Completion``. Load sheds at the queue bound (``"shed"``), deadlines
  expire queued or mid-decode requests (``"deadline"``), and a request
  whose admission raises (the ``serve.prefill`` site, a poison prompt) is
  quarantined (``"error"``) with its pool reservation and sampling
  stream rolled back; a failed cache growth (``serve.grow``,
  ``CacheGrowError``) retires only the rows that need the room.
- **Telemetry and tracing**: the JAX engine's metric catalog on the
  port's ``MetricsRegistry``, one span tree per request from submit to
  retire on the port's ``Tracer`` (``export_trace``).
- **Handoff surface**: ``admit_handoff``, ``park_slot``,
  ``resume_parked`` and ``retire_parked``, which the disaggregated
  scheduler (``serving/scheduler.py``) drives.
- **Tensor-parallel serving**: built inside ``mesh_context(env)`` with
  the params placed by ``shard_params_for_serving``
  (``build_engine(rules=)``), the engine captures the mesh once and
  every rank of it runs the engine on the same requests: each attends
  its own heads through the same kernels, the cache and the pool hold
  its heads, and the contiguous cache's rows split over the batch axes
  when they divide (``GPT.cache_rows``; the pool stays whole over them,
  every rank computing every row). The host schedulers of the ranks stay
  in LOCK STEP: a rank that admitted, expired, quarantined or sampled
  differently would hang the next collective, so each step starts with
  one plan that the mesh's rank 0 broadcasts (the requests its clock
  finds past their deadlines; every deadline check of the step reads
  it), the sampled and verified tokens are rank 0's (one broadcast a
  step and one an admission), and an admission that failed on any rank
  fails on all (one all-reduce of the failure flag). Everything else
  the scheduler decides follows from state that is the same on every
  rank: the queue bounds, the pool and the fault plan (seeded draws
  taken in the same order).

- **Re-spread** (``respread_pool``): a live ``model``-axis grow or
  shrink moves the params, the draft params and the pool's K/V and scale
  leaves through the redistribution service around a park and resume of
  every active slot; block ids are logical, so the tables, cursors and
  allocator keep their values. The port's engines run one a rank, so a
  rank that leaves the mesh, or joins it, has no counterpart in the
  single-controller JAX engine. The port's answer: EVERY rank of the
  world holds an engine of the same config and calls ``respread_pool``
  with the same argument. An engine on a rank outside its mesh is
  DORMANT: it holds no parameters (empty tensors), no cache and no
  requests, and its ``step`` / ``run`` do nothing, while the mesh's
  engines keep their lock step among themselves (the plan and token
  broadcasts run over the mesh's group, from its first rank). On a
  re-spread the old mesh's first rank broadcasts its host state (queue,
  slots, allocator, prefix cache, stats) to the world before any slot
  parks; the plans move the device state (a leaving rank sends its
  shards and goes dormant, a joining rank receives its shards and the
  whole bookkeeping leaves); the staying ranks resume their parked
  slots, and a joining rank adopts the broadcast state (its own request
  objects where it knows the ids) with the same cursor rewind. Requests
  that finished while a rank was dormant are reported by the mesh's
  ranks only.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from frl_distributed_ml_scaffold_tpu_torch import faults, resolve_device
from frl_distributed_ml_scaffold_tpu_torch.config.schema import ServingConfig
from frl_distributed_ml_scaffold_tpu_torch.dist.initialize import (
    process_index,
)
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
    AXES,
    MeshEnv,
    current_mesh_env,
    mesh_context,
)
from frl_distributed_ml_scaffold_tpu_torch.models.generation import (
    SLOT_LEAF_OF,
    _decode_step,
    _prefill,
    _sample,
    _verify_step,
    blocks_for_tokens,
    cache_batch_axis,
    cache_bytes_per_slot,
    cache_capacity_axis,
    generate,
    next_cache_bucket,
    pool_block_bytes,
    pool_cache_bytes,
    rewind_cache_indices,
    splice_pool_blocks,
)
from frl_distributed_ml_scaffold_tpu_torch.ops._build import is_device_failure
from frl_distributed_ml_scaffold_tpu_torch.ops.quantization import (
    byte_view,
    zeros,
)
from frl_distributed_ml_scaffold_tpu_torch.telemetry import (
    Histogram,
    MetricsRegistry,
    Timeline,
    Tracer,
)
from frl_distributed_ml_scaffold_tpu_torch.utils.logging import get_logger


def _release_params(model) -> None:
    """Leave ``model`` holding no parameters (empty tensors): a dormant
    engine's."""
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.new_empty(0)


def ngram_propose(
    history: np.ndarray, k: int, max_ngram: int = 3
) -> np.ndarray:
    """Prompt-lookup / n-gram self-speculation: find the most recent
    EARLIER occurrence of the history's trailing n-gram (longest n first,
    n = max_ngram..1) and propose the up-to-``k`` tokens that followed
    it. Overlapping matches are allowed (a period-p cycle proposes its own
    continuation), but an older match that fills all ``k`` tokens wins
    over a newer one that runs into the end of the history. Returns an
    empty array when nothing matches."""
    h = np.asarray(history).reshape(-1)
    n_h = int(h.size)
    if k < 1 or n_h < 2:
        return h[:0]
    for n in range(min(max_ngram, n_h - 1), 0, -1):
        suffix = h[n_h - n:]
        wins = np.lib.stride_tricks.sliding_window_view(h[:-1], n)
        hits = np.flatnonzero((wins == suffix).all(axis=1))
        if hits.size == 0:
            continue
        full = hits[hits <= n_h - n - k]
        i = int(full[-1]) if full.size else int(hits[-1])
        return h[i + n:i + n + k].copy()
    return h[:0]


class CacheGrowError(RuntimeError):
    """Growing the KV cache to the next bucket failed (an allocation
    failure at high occupancy, or the ``serve.grow`` fault site). The
    engine degrades instead of dying: requests that NEED the larger
    bucket retire with ``finish_reason="error"``, the others keep
    decoding (``ServingEngine.step``)."""


@dataclasses.dataclass
class ServeRequest:
    """One queued generation request (prompt is an unpadded 1-D array).

    ``trace`` / ``span`` / ``t_submit`` are the tracing handles: every
    request gets its own trace id at enqueue, and the root ``request``
    span stays open from submit to retire. ``deadline_s`` is the
    submit-relative deadline (0 = none)."""

    id: int
    prompt: np.ndarray
    max_new_tokens: int
    trace: int = 0
    t_submit: float = 0.0
    span: Any = None
    deadline_s: float = 0.0


@dataclasses.dataclass
class Completion:
    """A finished request: prompt + generated tokens, the wall latency of
    each generated token (``[0]`` is the prefill, the rest the decode
    steps the request was live for), ``ttft_s`` (time to first token) and
    the p50 / p99 time per output token over the decode steps, through
    the telemetry histogram's log2-bucket quantile estimator.

    ``finish_reason`` is the typed contract: ``"eos"`` / ``"length"``
    (served in full), ``"shed"`` (queue bound hit at submit, nothing
    generated), ``"deadline"`` (queued requests expire before prefill,
    decoding ones are cancelled with the tokens so far) or ``"error"``
    (quarantined at admission, or a failed cache growth; tokens so far
    are carried).

    Paged engine only: ``prefix_cache_hit``, ``prefill_tokens_saved`` and
    ``spec_accept_rate`` (accepted / proposed drafts, 0.0 when none).
    ``token_times_s``: each generated token's arrival, seconds from
    submit (the gaps include whatever the engine did in between).
    ``tenant``: the tenant of a disaggregated engine ("" otherwise)."""

    id: int
    tokens: np.ndarray  # [prompt_len + n_generated]
    prompt_len: int
    finish_reason: str  # "eos" | "length" | "shed" | "deadline" | "error"
    token_latencies_s: list[float]
    ttft_s: float = 0.0
    tpot_p50_s: float = 0.0
    tpot_p99_s: float = 0.0
    prefix_cache_hit: bool = False
    prefill_tokens_saved: int = 0
    spec_accept_rate: float = 0.0
    token_times_s: list[float] = dataclasses.field(default_factory=list)
    tenant: str = ""

    @property
    def ok(self) -> bool:
        """Served in full (not shed, expired or quarantined)."""
        return self.finish_reason in ("eos", "length")


def _log2_quantiles(vals, qs) -> list[float]:
    """Quantiles of ``vals`` through a detached log2-bucket Histogram:
    the estimator of the engine's aggregate latency histograms."""
    h = Histogram(MetricsRegistry(), "q", help="")
    for v in vals:
        h.observe(v)
    return [h.quantile(q) for q in qs]


def _hbm_gib(device: torch.device) -> dict[str, float]:
    """In-use / peak device memory in GiB (empty on the CPU). One read
    of the allocator's nested stats: ``torch.cuda.memory_allocated`` and
    ``max_memory_allocated`` each flatten and sort all of them, and this
    runs every decode step."""
    if device.type != "cuda":
        return {}
    alloc = torch.cuda.memory_stats_as_nested_dict(device).get(
        "allocated_bytes", {}).get("all", {})
    return {
        "hbm_in_use_gib": alloc.get("current", 0) / 2**30,
        "hbm_peak_gib": alloc.get("peak", 0) / 2**30,
    }


def prefill_request(model, req: ServeRequest, res: dict | None, *,
                    block_size: int, bucket_for, sample_kw, generator,
                    seed_cache=None):
    """The admission prefill, shared by the colocated engine and the
    disaggregated ``PrefillWorker``: bucket the (possibly prefix-stripped)
    prompt, left-pad the suffix and prefill it, seeded with the shared
    prefix's cache when ``seed_cache`` is given. Returns ``(tok [1],
    slot_cache, s_p, m, l_suf)``: prompt bucket, shared blocks and suffix
    length (``l_suf >= 1``: ``_match_prefix``
    always leaves a token to prefill). ``tok`` stays on the device."""
    l = int(req.prompt.size)
    m = res["m"] if res is not None else 0
    l_suf = l - m * block_size
    s_p = bucket_for(l_suf)
    prompt = np.zeros((1, s_p), np.int32)
    prompt[0, s_p - l_suf:] = req.prompt[m * block_size:]  # left-pad
    dev = model.device
    logits, slot_cache = _prefill(
        model,
        torch.from_numpy(prompt).to(dev),
        torch.tensor([l_suf], dtype=torch.int32, device=dev),
        cache_len=s_p,
        cache=seed_cache,
    )
    tok = _sample(logits, generator, **sample_kw)
    return tok, slot_cache, s_p, m, l_suf


class ServingEngine:
    """Continuous-batching engine; see the module docstring.

    Usage::

        eng = ServingEngine(model, num_slots=4, eos_id=50256)
        eng.submit([5, 3, 8], max_new_tokens=32)
        done = eng.run()          # or step() for one decode iteration

    ``serving`` takes the ``serving.*`` section of a config: the queue
    bound and default deadline, the paged knobs (``kv_block_size``,
    ``kv_pool_blocks``, ``prefix_cache``) and speculation (``speculate``,
    ``speculate_k``). ``speculate=draft`` needs ``draft_model=``, a small
    port ``GPT`` sharing the target's vocabulary on the same device
    (``draft_params=``, a state dict, is loaded into it when given).
    ``device=None`` means ``cuda``; the model must live on the resolved
    device."""

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
        telemetry: MetricsRegistry | None = None,
        tracer: Tracer | None = None,
        rules=None,
        device=None,
    ):
        dev = resolve_device(device)
        if model.device != dev:
            raise ValueError(f"model lives on {model.device}, asked for {dev}")
        if num_slots < 1:
            raise ValueError(
                f"num_slots={num_slots} < 1: zero slots can never admit, "
                "so run() would spin on a non-empty queue forever"
            )
        serving = ServingConfig() if serving is None else serving
        self.model = model
        # The TP partition rules the params were placed by
        # (``build_engine(rules=)``; None: whole on every rank): a
        # re-spread places them by the same rules on the new mesh.
        self.rules = rules
        self.num_slots = int(num_slots)
        # The mesh, captured once: every step runs under it, and over
        # more than one rank the engines run in lock step.
        self._plan_expired: set[int] = set()
        self._set_env(current_mesh_env())
        if self._dormant:
            _release_params(model)
        self.eos_id = eos_id
        self._sample_kw = dict(
            temperature=temperature, top_k=top_k, top_p=top_p
        )
        self._generator = generator
        self.seq_len = model.config.seq_len
        self.min_bucket = 8
        n = self.num_slots
        if serving.max_queue_depth < 0:
            raise ValueError(f"max_queue_depth={serving.max_queue_depth} < 0")
        self.max_queue_depth = int(serving.max_queue_depth)
        self.default_deadline_s = float(serving.default_deadline_s)

        # Paged-cache knobs. Block sizes are powers of two so every
        # prompt bucket is a whole number of blocks (the splice reshapes
        # the prefilled cache into blocks).
        self.paged = serving.kv_block_size > 0
        if self.paged:
            bs = int(serving.kv_block_size)
            if bs & (bs - 1) or bs > self.seq_len:
                raise ValueError(
                    f"kv_block_size={bs} must be a power of two "
                    f"<= seq_len={self.seq_len}"
                )
            self.block_size = bs
            self.table_blocks = blocks_for_tokens(self.seq_len, bs)
            pool_blocks = serving.kv_pool_blocks
            if pool_blocks == 0:
                # Auto: the never-blocks-admission worst case (+1 trash).
                pool_blocks = n * self.table_blocks + 1
            if pool_blocks < 2:
                raise ValueError(
                    f"kv_pool_blocks={pool_blocks} < 2: block 0 is the "
                    "reserved trash block, so a usable pool needs >= 2"
                )
            self.pool_blocks = int(pool_blocks)
            self.min_bucket = max(self.min_bucket, bs)
            self.prefix_cache_enabled = bool(serving.prefix_cache)
            # Allocator: block 0 is TRASH (retired slots' tables point at
            # it, so their writes in the shared decode step land somewhere
            # harmless instead of a freed, possibly reallocated, block).
            self._free: list[int] = list(range(self.pool_blocks - 1, 0, -1))
            self._ref = np.zeros(self.pool_blocks, np.int64)
            self._reserved_future = 0
            self._slot_blocks: list[list[int]] = [[] for _ in range(n)]
            self._slot_future = np.zeros(n, np.int64)
            # Blocks owned by PARKED requests, keyed by request id: out of
            # any slot but still referenced, so pool demand keeps them.
            self._parked_held: dict[int, list[int]] = {}
            self._slot_prefix_hit = np.zeros(n, bool)
            self._slot_tokens_saved = np.zeros(n, np.int64)
            self._tables = np.zeros((n, self.table_blocks), np.int32)
            self._tables_dirty = True
            # prompt-prefix bytes -> physical block ids, in LRU order.
            self._prefix_cache: collections.OrderedDict[
                bytes, tuple[int, ...]
            ] = collections.OrderedDict()

        # Speculative decoding: greedy only, since acceptance is exact
        # argmax matching (token-identical to plain decode).
        self.spec_mode = str(serving.speculate)
        if self.spec_mode not in ("off", "ngram", "draft"):
            raise ValueError(
                f"speculate={self.spec_mode!r} unknown (off | ngram | draft)"
            )
        self.spec_k = int(serving.speculate_k)
        self.spec_window = int(speculate_window)
        self._draft = None
        if self.spec_mode != "off":
            if not self.paged:
                raise ValueError(
                    "speculative decoding runs on the PAGED engine "
                    "(serving.kv_block_size > 0): accept/rollback is "
                    "block-table pointer bookkeeping there — the "
                    "bucketed cache has no cheap rollback"
                )
            if self._sample_kw["temperature"] != 0.0:
                raise ValueError(
                    "speculate requires greedy decode (temperature=0): "
                    "acceptance is exact argmax matching; sampled "
                    "speculative decode needs rejection sampling, which "
                    "this engine does not implement"
                )
            if self.spec_k < 1:
                raise ValueError(
                    f"speculate_k={self.spec_k} < 1: a verify step must "
                    "carry at least one draft position"
                )
            if self.spec_mode == "draft":
                self._draft = self._check_draft(draft_model, draft_params,
                                                dev)
        # Per-slot speculation state (reset at admission): the sticky
        # degradation to plain decode and the accept accounting behind
        # Completion.spec_accept_rate.
        self._slot_spec_degraded = np.zeros(n, bool)
        self._slot_spec_proposed = np.zeros(n, np.int64)
        self._slot_spec_accepted = np.zeros(n, np.int64)

        self._queue: collections.deque[ServeRequest] = collections.deque()
        # Typed completions resolved OUTSIDE a slot (shed at submit,
        # expired while queued, quarantined at admission) wait here for
        # the next step() / run().
        self._early: list[Completion] = []
        # Completions retired since the last step() drain. Persistent:
        # the disaggregated scheduler's admit_handoff retires 1-token
        # budgets between steps.
        self._completed: list[Completion] = []
        self._next_id = 0
        self._issued_ids: set[int] = set()
        self._req: list[ServeRequest | None] = [None] * n
        self._tokens: list[list[int]] = [[] for _ in range(n)]
        self._len = np.zeros(n, np.int64)  # prompt + generated
        self._active = np.zeros(n, bool)
        self._latency: list[list[float]] = [[] for _ in range(n)]
        self._tok_times: list[list[float]] = [[] for _ in range(n)]
        self._last_tok = np.zeros(n, np.int32)
        self.cache: dict | None = None
        self.bucket = 0
        # How often each shape class ran (prefill_<bucket>, decode_paged,
        # decode_verify, grow_<a>-><b>, ...), with the JAX engine's keys.
        self.stats = collections.Counter()
        self._init_telemetry(telemetry, tracer)

    def _check_draft(self, draft_model, draft_params, dev):
        if draft_model is None:
            raise ValueError(
                "speculate='draft' needs draft_model= (a small GPT sharing "
                "the target's tokenizer; draft_params= loads a state dict "
                "into it); use speculate='ngram' for model-free "
                "self-speculation"
            )
        if draft_params is not None:
            draft_model.load_state_dict(draft_params)
        if draft_model.device != dev:
            raise ValueError(
                f"draft model lives on {draft_model.device}, the engine "
                f"on {dev}"
            )
        vocab = draft_model.config.vocab_size
        if vocab != self.model.config.vocab_size:
            raise ValueError(
                "draft model must share the target tokenizer "
                f"(vocab {vocab} != {self.model.config.vocab_size})"
            )
        # The draft proposes from a sliding WINDOW of each slot's history
        # (a ragged prefill + k greedy steps), its cache the window's
        # bucket, so draft memory never contends with the pool.
        self.spec_window = min(self.spec_window,
                               draft_model.config.seq_len - self.spec_k)
        if self.spec_window < 1:
            raise ValueError(
                f"draft context ({draft_model.config.seq_len}) cannot fit "
                f"a window + speculate_k={self.spec_k}"
            )
        return draft_model

    def _init_telemetry(self, telemetry, tracer) -> None:
        """The JAX engine's metric catalog (names and help strings),
        registered up front so every exporter carries all of it; the
        tracer (one trace per request plus the engine lane, teed into
        the timeline)."""
        self.telemetry = (telemetry if telemetry is not None
                          else MetricsRegistry())
        self.timeline = Timeline(enabled=self.telemetry.enabled)
        self.tracing = (
            tracer if tracer is not None
            else Tracer(enabled=self.telemetry.enabled, timeline=self.timeline)
        )
        # A caller-supplied tracer (its own timeline, or disabled) breaks
        # the tee into this engine's timeline: _phase then writes bare
        # timeline events too.
        self._phases_via_tee = (
            self.tracing.enabled and self.tracing.timeline is self.timeline
        )
        self._engine_trace = self.tracing.new_trace("engine")
        t = self.telemetry
        self._m_ttft = t.histogram(
            "serve_ttft_seconds", help="time to first token (prefill+graft)"
        )
        self._m_tpot = t.histogram(
            "serve_tpot_seconds",
            help="per-output-token latency over live slots (decode steps)",
        )
        self._m_queue = t.gauge("serve_queue_depth", help="requests waiting")
        self._m_occupancy = t.gauge(
            "serve_slot_occupancy", help="active slots / num_slots"
        )
        self._m_bytes_slot = t.gauge(
            "serve_bytes_per_slot",
            help="per-slot HBM of the live cache at its current bucket",
        )
        self._m_hbm_used = t.gauge(
            "serve_hbm_in_use_gib", help="device HBM in use (0 when the "
            "backend exposes no stats, e.g. CPU sim)"
        )
        self._m_hbm_peak = t.gauge(
            "serve_hbm_peak_gib", help="device HBM high-watermark"
        )
        self._m_prefills = t.counter("serve_prefill_total",
                                     help="prefills run")
        self._m_decodes = t.counter(
            "serve_decode_steps_total", help="slot-array decode iterations"
        )
        self._m_grows = t.counter(
            "serve_bucket_grow_total", help="cache bucket growths"
        )
        self._m_grafts = t.counter(
            "serve_cache_graft_total", help="prefill-cache grafts into slots"
        )
        self._m_completed = t.counter(
            "serve_completed_total", help="requests finished"
        )
        self._m_shed = t.counter(
            "serve_shed_total",
            help="requests load-shed at submit (queue bound)",
        )
        self._m_deadline = t.counter(
            "serve_deadline_miss_total",
            help="requests past deadline (shed queued / cancelled decoding)",
        )
        self._m_quarantined = t.counter(
            "serve_quarantined_total",
            help="poison requests whose prefill failed (batch kept alive)",
        )
        self._m_grow_failures = t.counter(
            "serve_grow_failures_total",
            help="cache bucket growths that failed (degraded, not fatal)",
        )
        self._m_pool_util = t.gauge(
            "serve_pool_utilization",
            help="allocated KV pool blocks / usable pool blocks "
            "(trash block excluded; 0 on a bucketed engine)",
        )
        self._m_block_appends = t.counter(
            "serve_block_append_total",
            help="mid-decode KV blocks appended to slot tables "
            "(the paged engine's 'grow': one block, never a cache clone)",
        )
        self._m_prefix_hits = t.counter(
            "serve_prefix_hits_total",
            help="admissions that reused cached prefix blocks",
        )
        self._m_prefix_saved = t.counter(
            "serve_prefix_tokens_saved_total",
            help="prompt tokens never prefilled thanks to prefix reuse",
        )
        self._m_prefix_hit_rate = t.gauge(
            "serve_prefix_hit_rate",
            help="prefix hits / admissions since engine start",
        )
        # The live re-spreads and their moved bytes (respread_pool).
        self._m_respread = t.counter(
            "serve_pool_respread_total",
            help="live model-axis re-spreads of the paged pool "
            "(redistribution service; in-flight slots park/resume)",
        )
        self._m_respread_bytes = t.counter(
            "serve_pool_respread_bytes_total",
            help="bytes the re-spread plans actually moved across "
            "devices (the shard delta, not the pool size)",
        )
        self._m_spec_proposed = t.counter(
            "serve_spec_proposed_total",
            help="draft tokens proposed to verify steps",
        )
        self._m_spec_accepted = t.counter(
            "serve_spec_accepted_total",
            help="draft tokens accepted by verify steps (bonus/corrected "
            "tokens not counted — they are free either way)",
        )
        self._m_spec_verifies = t.counter(
            "serve_spec_verify_total",
            help="batched verify-step program invocations",
        )
        self._m_spec_draft_failures = t.counter(
            "serve_spec_draft_failures_total",
            help="draft-proposer failures (slot degraded to plain "
            "single-token decode for the rest of its request)",
        )
        self._m_spec_per_verify = t.histogram(
            "serve_spec_accepted_per_verify",
            help="tokens emitted per SPECULATING slot per verify step "
            "(accepted drafts + the corrected/bonus token; 1 = nothing "
            "accepted; zero-draft slots riding the tile are excluded)",
        )
        # The JAX engine's stall watchdog registers this; the port
        # serves without one, so it stays 0.
        t.counter("stalls_total",
                  help="watchdog firings: no progress within the deadline")

    def _phase(self, name, *, t0, dur_s, trace=None, parent=None, **attrs):
        """Span plus guaranteed phase record: the engine-built tracer tees
        finished spans into ``self.timeline``; with any other tracer emit
        a bare timeline event too."""
        self.tracing.emit(
            name, t0=t0, dur_s=dur_s, trace=trace, parent=parent,
            cat="serve", **attrs,
        )
        if not self._phases_via_tee:
            self.timeline.event(
                name, dur_s=round(max(float(dur_s), 0.0), 9), **attrs
            )

    def _note_hbm(self) -> None:
        if self.telemetry.enabled:
            for name, v in _hbm_gib(self.model.device).items():
                (self._m_hbm_used if name == "hbm_in_use_gib"
                 else self._m_hbm_peak).set(v)

    # ----------------------------------------------------------- frontend

    def submit(
        self,
        prompt,
        max_new_tokens: int,
        request_id: int | None = None,
        *,
        deadline_s: float | None = None,
    ) -> int:
        """Enqueue a request; returns its id. ``deadline_s`` (seconds
        from now; ``None`` = the engine's ``default_deadline_s``, 0 = no
        deadline) bounds the request's total latency. Malformed requests
        raise; a full queue (``max_queue_depth`` queued requests) comes
        back as a typed ``"shed"`` completion."""
        req = self._new_request(prompt, max_new_tokens, request_id,
                                deadline_s=deadline_s)
        if self.max_queue_depth and len(self._queue) >= self.max_queue_depth:
            self._m_shed.inc()
            self._complete_unadmitted(req, "shed")
            return req.id
        self._queue.append(req)
        return req.id

    def _new_request(
        self,
        prompt,
        max_new_tokens: int,
        request_id: int | None = None,
        *,
        deadline_s: float | None = None,
    ) -> ServeRequest:
        """Validate and build a traced ``ServeRequest`` (id issued, trace
        born, root span opened) without enqueueing it: the part of
        ``submit`` the disaggregated scheduler shares, its tenant queues
        owning the enqueue and shed policy."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} < 1: prefill always "
                "samples the first token, so a request must want at least "
                "one (this also keeps prompt_len + 1 within the cache)"
            )
        if prompt.size + max_new_tokens > self.seq_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the model context ({self.seq_len})"
            )
        if self.paged:
            _, total = self._request_blocks(int(prompt.size), max_new_tokens)
            if total > self.pool_blocks - 1:
                raise ValueError(
                    f"request needs {total} KV blocks but the pool holds "
                    f"{self.pool_blocks - 1} usable — it could never admit "
                    "(raise serving.kv_pool_blocks or shrink the request)"
                )
        rid = self._next_id if request_id is None else request_id
        if rid in self._issued_ids:
            raise ValueError(
                f"request_id {rid} already used — completions are keyed "
                "by id, so a duplicate would silently shadow a result"
            )
        self._issued_ids.add(rid)
        self._next_id = max(self._next_id, rid) + 1
        req = ServeRequest(rid, prompt, int(max_new_tokens))
        req.deadline_s = (self.default_deadline_s if deadline_s is None
                          else float(deadline_s))
        req.trace = self.tracing.new_trace(f"request {rid}")
        req.span = self.tracing.begin(
            "request", trace=req.trace, cat="serve", request=rid,
            prompt_len=int(prompt.size),
        )
        # queue_wait is emitted later from t_submit: it must start where
        # the root does, or the tree's containment breaks.
        req.t_submit = getattr(req.span, "t0", None) or time.perf_counter()
        return req

    def _complete_unadmitted(self, req: ServeRequest, reason: str) -> None:
        """Resolve a request that never held a slot (shed, expired in the
        queue, quarantined at admission): the prompt comes back, nothing
        generated, and the root span closes."""
        self._early.append(Completion(
            id=req.id,
            tokens=req.prompt.copy(),
            prompt_len=int(req.prompt.size),
            finish_reason=reason,
            token_latencies_s=[],
        ))
        self.stats["completed"] += 1
        self.stats[f"finish_{reason}"] += 1
        self._m_completed.inc()
        self._phase(
            "retire", t0=time.perf_counter(), dur_s=0.0,
            trace=req.trace, parent=req.span,
            request=req.id, reason=reason, n_tokens=0,
        )
        req.span.end(finish_reason=reason, n_tokens=0)

    def _expired(self, req: ServeRequest, now: float | None = None) -> bool:
        """Whether ``req`` is past its deadline: by this process's clock,
        or in lock step by the step's plan (``_plan_step``)."""
        if self._lockstep:
            return req.id in self._plan_expired
        return self._clock_expired(req, now)

    @staticmethod
    def _clock_expired(req: ServeRequest, now: float | None = None) -> bool:
        if not req.deadline_s:
            return False
        now = time.perf_counter() if now is None else now
        return now - req.t_submit > req.deadline_s

    # ----------------------------------------------------------- lock step

    def _mesh(self):
        return mesh_context(self._env)

    def _set_env(self, env: MeshEnv | None) -> None:
        """Adopt ``env`` as the engine's mesh: its lock step, whether this
        rank is in it (``_dormant`` when not) and this rank's rows of the
        contiguous cache (all of them unless they split over the batch
        axes) and the first one's slot."""
        self._env = env
        self._lockstep = env is not None and env.num_devices > 1
        self._dormant = env is not None and not env.member
        if self._dormant:
            self._rows, self._row0 = self.num_slots, 0
            return
        with mesh_context(env):
            self._rows = self.model.cache_rows(self.num_slots)
        self._row0 = (0 if self._rows == self.num_slots
                      else env.batch_index * self._rows)

    def _lead(self) -> tuple[Any, int]:
        """The mesh's group over all its axes and its first rank: the
        lock step's broadcasts run there, so ranks outside the mesh
        (dormant engines) take no part."""
        return self._env.group(AXES), int(self._env.ranks.flat[0])

    def _live_requests(self) -> list[ServeRequest]:
        return list(self._queue) + [r for r in self._req if r is not None]

    def _plan_step(self, reqs=None) -> None:
        """The step's plan, in lock step: the ids of the live requests
        (``reqs``, default the queue and the slots) that rank 0's clock
        finds past their deadlines, broadcast from rank 0 once."""
        if not self._lockstep:
            return
        reqs = self._live_requests() if reqs is None else reqs
        now = time.perf_counter()
        group, lead = self._lead()
        box = [{r.id for r in reqs if self._clock_expired(r, now)}]
        dist.broadcast_object_list(box, src=lead, group=group)
        self._plan_expired = box[0]

    def _agree(self, toks: torch.Tensor) -> torch.Tensor:
        """The mesh's first rank's sampled (or verified) tokens on every
        rank, in lock step."""
        if not self._lockstep:
            return toks
        toks = toks.contiguous()
        group, lead = self._lead()
        dist.broadcast(toks, src=lead, group=group)
        return toks

    def _agree_failed(self, failed: bool) -> bool:
        """Whether an admission failed on any rank, in lock step."""
        if not self._lockstep:
            return failed
        flag = torch.tensor([int(failed)], device=self.model.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._lead()[0])
        return bool(flag.item())

    @property
    def pending(self) -> int:
        if self._dormant:
            return 0
        return len(self._queue) + int(self._active.sum())

    def reset_cache(self) -> None:
        """Drop the device cache, the pool's bookkeeping, the stats, the
        metrics and the recorded spans, for a measured pass after a warm
        one. Refuses while requests are in flight."""
        if self._active.any():
            raise RuntimeError("reset_cache with active slots in flight")
        self.cache = None
        self.bucket = 0
        if self.paged:
            self._free = list(range(self.pool_blocks - 1, 0, -1))
            self._ref[:] = 0
            self._reserved_future = 0
            self._slot_blocks = [[] for _ in range(self.num_slots)]
            self._slot_future[:] = 0
            self._parked_held.clear()
            self._slot_prefix_hit[:] = False
            self._slot_tokens_saved[:] = 0
            self._tables[:] = 0
            self._tables_dirty = True
            self._prefix_cache.clear()
        self._slot_spec_degraded[:] = False
        self._slot_spec_proposed[:] = 0
        self._slot_spec_accepted[:] = 0
        self.stats.clear()
        self.telemetry.reset()
        self.timeline.drain()
        self.tracing.drain()

    def bytes_per_slot(self) -> int:
        """Per-slot device bytes of the live cache: bucketed, one row's
        share at the current bucket; paged, the whole cache (pool, tables,
        cursors) over ``num_slots``. 0 before the first admission."""
        if self.cache is None:
            return 0
        heads = self.model.config.num_heads
        if self.paged:
            return pool_cache_bytes(self.cache, num_heads=heads) // self.num_slots
        return cache_bytes_per_slot(self.cache, self._rows, num_heads=heads)

    def export_trace(self, path: str) -> None:
        """Write the span ring as Chrome-trace-event JSON (Perfetto /
        chrome://tracing): one lane per request plus the engine lane;
        non-consuming."""
        self.tracing.write_chrome_trace(path)

    def respread_pool(self, new_env, *, scratch_limit_bytes=None) -> dict:
        """Live ``model``-axis RE-SPREAD: move the engine (params, draft
        params, the paged pool with its scale leaves, and the bookkeeping
        leaves) onto ``new_env`` when the model axis grows or shrinks,
        without dropping in-flight work (module docstring, "Re-spread"):

        1. every plan is compiled before any state is touched;
        2. every active slot PARKS (its blocks stay owned);
        3. the redistribution service moves the params and the cache
           (pool leaves over heads, ``generation.pool_leaf_spec``; the
           tables, cursors and allocator keep their values);
        4. every parked slot RESUMES on the new mesh.

        Every rank of the world calls it with the same ``new_env``: a
        ``MeshEnv``, or an int n for a model-only mesh over the first n
        ranks. Returns the executed plans (``{"params", "cache",
        "draft_params"}``); ``bytes_moved`` is the shard delta, not the
        pool size. The move is donated: each source leaf is released as
        its destination exists."""
        if not self.paged:
            raise ValueError(
                "respread_pool is a paged-engine contract "
                "(serving.kv_block_size > 0): the bucketed cache has no "
                "shared pool to re-spread"
            )
        from frl_distributed_ml_scaffold_tpu_torch import redistribute as rd
        from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
            MeshConfig,
        )
        from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
            build_mesh,
            one_rank_mesh,
        )
        from frl_distributed_ml_scaffold_tpu_torch.models.generation import (
            pool_leaf_spec,
        )
        from frl_distributed_ml_scaffold_tpu_torch.parallel.partition import (
            serving_specs,
        )

        if isinstance(new_env, int):
            new_env = build_mesh(MeshConfig(data=1, model=new_env), new_env)
        heads = self.model.config.num_heads
        n_model = new_env.axis_size("model")
        if n_model > 1 and heads % n_model != 0:
            raise ValueError(
                f"model axis {n_model} does not divide num_heads="
                f"{heads} — the pool shards heads"
            )
        old_env = self._env if self._env is not None else one_rank_mesh()
        t0 = time.perf_counter()
        was, will = old_env.member, new_env.member
        # The old mesh's first rank's host state, to every rank: a rank
        # that joins adopts it. Sent before any slot parks.
        box = [self._host_state() if process_index() == int(
            old_env.ranks.flat[0]) else None]
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.broadcast_object_list(box, src=int(old_env.ranks.flat[0]))
        lead_state = box[0]

        # COMPILE every plan before touching any engine state: the params
        # sit where the engine's rules placed them on the old mesh and go
        # where the same rules place them on the new one.
        meta = type(self.model)(self.model.config, self.model.policy,
                                device="meta")
        src_specs = serving_specs(self.model, old_env, self.rules)
        dst_specs = serving_specs(self.model, new_env, self.rules)
        plans: dict[str, Any] = {}
        plans["params"] = rd.compile_tree_plan(
            {k: rd.Abstract.of(p.shape, p.dtype,
                               rd.Placement(old_env, src_specs[k]))
             for k, p in meta.named_parameters()},
            {k: rd.Placement(new_env, dst_specs[k]) for k in src_specs},
            scratch_limit_bytes=scratch_limit_bytes)
        if self._draft is not None:
            plans["draft_params"] = rd.compile_tree_plan(
                {k: rd.Abstract.of(p.shape, p.dtype,
                                   rd.Placement(old_env, ()))
                 for k, p in self._draft.named_parameters()},
                {k: rd.Placement(new_env, ())
                 for k, _ in self._draft.named_parameters()},
                scratch_limit_bytes=scratch_limit_bytes)
        if lead_state["has_cache"]:
            template = meta.init_paged_cache(
                self.num_slots, self.block_size, self.pool_blocks)

            def cache_spec(specs, name, leaf):
                # The pool splits its heads where the attention's
                # params split them (GPT.local_heads).
                spec = pool_leaf_spec(name, leaf)
                split = any("model" in s for k, s in specs.items()
                            if ".attn." in k)
                return spec if spec is not None and split else ()

            plans["cache"] = rd.compile_tree_plan(
                {k: rd.Abstract.of(v.shape, v.dtype, rd.Placement(
                    old_env, cache_spec(src_specs, k, v)))
                 for k, v in template.items()},
                {k: rd.Placement(new_env, cache_spec(dst_specs, k, v))
                 for k, v in template.items()},
                scratch_limit_bytes=scratch_limit_bytes)
        # Every plan fits the tensors it moves, or this raises while
        # nothing has moved yet.
        rd.check_sources(plans["params"], {
            k: p.data for k, p in self.model.named_parameters()})
        if "cache" in plans:
            rd.check_sources(plans["cache"], dict(self.cache or {}))
        parked = ([(int(s), self.park_slot(int(s)))
                   for s in np.flatnonzero(self._active)] if was else [])
        dev = self.model.device
        params = dict(self.model.named_parameters())
        placed = rd.execute(plans["params"],
                            {k: p.data for k, p in params.items()},
                            donate=True, device=dev)
        with torch.no_grad():
            for k, p in params.items():
                p.data = placed.get(k, p.data.new_empty(0))
        if self._draft is not None:
            dparams = dict(self._draft.named_parameters())
            dplaced = rd.execute(plans["draft_params"],
                                 {k: p.data for k, p in dparams.items()},
                                 donate=True, device=dev)
            with torch.no_grad():
                for k, p in dparams.items():
                    p.data = dplaced.get(k, p.data.new_empty(0))
        if "cache" in plans:
            cache = rd.execute(plans["cache"], dict(self.cache or {}),
                               donate=True, device=dev)
            self.cache = cache if will else None
        self._set_env(new_env)
        self._tables_dirty = True
        if was and will:
            for slot, p in parked:
                self.resume_parked(p, slot)
        elif will:
            self._adopt(lead_state)
        elif was:
            self._go_dormant()
        moved = sum(p.bytes_moved for p in plans.values())
        self.stats["respread"] += 1
        self._m_respread.inc()
        self._m_respread_bytes.inc(moved)
        self._phase(
            "respread", t0=t0, dur_s=time.perf_counter() - t0,
            trace=self._engine_trace, model_axis=n_model,
            bytes_moved=moved, parked=len(parked),
        )
        return plans

    def _host_state(self) -> dict:
        """What a rank joining the mesh adopts (``respread_pool``): the
        queue, the slots, the allocator, the prefix cache and the stats,
        as plain values."""
        def req(r):
            return (r.id, r.prompt, r.max_new_tokens, r.deadline_s)

        state = {"has_cache": self.cache is not None,
                 "queue": [req(r) for r in self._queue],
                 "next_id": self._next_id,
                 "issued": set(self._issued_ids),
                 "stats": dict(self.stats), "slots": []}
        for slot in range(self.num_slots):
            if not self._active[slot]:
                state["slots"].append(None)
                continue
            state["slots"].append({
                "req": req(self._req[slot]),
                "tokens": list(self._tokens[slot]),
                "len": int(self._len[slot]),
                "last_tok": int(self._last_tok[slot]),
                "blocks": list(self._slot_blocks[slot]),
                "future": int(self._slot_future[slot]),
                "prefix_hit": bool(self._slot_prefix_hit[slot]),
                "tokens_saved": int(self._slot_tokens_saved[slot]),
                "spec": (bool(self._slot_spec_degraded[slot]),
                         int(self._slot_spec_proposed[slot]),
                         int(self._slot_spec_accepted[slot])),
            })
        state.update(free=list(self._free), ref=self._ref.copy(),
                     reserved=self._reserved_future,
                     prefix=list(self._prefix_cache.items()))
        return state

    def _adopt(self, state: dict) -> None:
        """Join the mesh with the host state of its first rank
        (``_host_state``): this rank's own request objects where it knows
        the ids, new traced ones where it does not; then the cursor
        rewind a resume makes."""
        own = {r.id: r for r in self._live_requests()}

        def req(t):
            rid, prompt, new, deadline = t
            r = own.get(rid)
            if r is None:
                r = ServeRequest(rid, np.asarray(prompt), int(new))
                r.deadline_s = deadline
                r.trace = self.tracing.new_trace(f"request {rid}")
                r.span = self.tracing.begin(
                    "request", trace=r.trace, cat="serve", request=rid,
                    prompt_len=int(r.prompt.size))
                r.t_submit = (getattr(r.span, "t0", None)
                              or time.perf_counter())
            return r

        self._go_dormant()
        self._queue.extend(req(t) for t in state["queue"])
        self._next_id = state["next_id"]
        self._issued_ids = set(state["issued"])
        self.stats = collections.Counter(state["stats"])
        for slot, st in enumerate(state["slots"]):
            if st is None:
                continue
            self._req[slot] = req(st["req"])
            self._tokens[slot] = st["tokens"]
            self._len[slot] = st["len"]
            self._last_tok[slot] = st["last_tok"]
            self._slot_blocks[slot] = st["blocks"]
            self._slot_future[slot] = st["future"]
            self._slot_prefix_hit[slot] = st["prefix_hit"]
            self._slot_tokens_saved[slot] = st["tokens_saved"]
            (self._slot_spec_degraded[slot], self._slot_spec_proposed[slot],
             self._slot_spec_accepted[slot]) = st["spec"]
            self._active[slot] = True
            self._tables[slot, : len(st["blocks"])] = st["blocks"]
        self._free = list(state["free"])
        self._ref = np.asarray(state["ref"]).copy()
        self._reserved_future = state["reserved"]
        self._prefix_cache = collections.OrderedDict(state["prefix"])
        n_active = int(self._active.sum())
        self.stats["parked"] += n_active
        self.stats["resumed"] += n_active
        if self.cache is not None:
            new_idx = np.where(self._active, self._len - 1, 0).astype(
                np.int32)
            rewind_cache_indices(self.cache, torch.from_numpy(new_idx))

    def _go_dormant(self) -> None:
        """Leave the mesh: no cache, no requests, an empty allocator (the
        parameters were released by the move)."""
        n = self.num_slots
        self._queue.clear()
        self._req = [None] * n
        self._tokens = [[] for _ in range(n)]
        self._latency = [[] for _ in range(n)]
        self._tok_times = [[] for _ in range(n)]
        self._len[:] = 0
        self._active[:] = False
        self._last_tok[:] = 0
        self._free = list(range(self.pool_blocks - 1, 0, -1))
        self._ref[:] = 0
        self._reserved_future = 0
        self._slot_blocks = [[] for _ in range(n)]
        self._slot_future[:] = 0
        self._parked_held.clear()
        self._slot_prefix_hit[:] = False
        self._slot_tokens_saved[:] = 0
        self._tables[:] = 0
        self._tables_dirty = True
        self._prefix_cache.clear()

    def run(self, max_steps: int | None = None) -> list[Completion]:
        """Drain the queue; returns completions in finish order (typed
        shed / deadline / error completions included: every submitted id
        resolves exactly once)."""
        out: list[Completion] = []
        steps = 0
        while self.pending:
            out.extend(self.step())
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        # Requests resolved without entering a slot (every submit shed
        # on a full queue) never pass through step().
        out.extend(self._early)
        self._early.clear()
        return out

    # ------------------------------------------------ speculative decoding

    def _draft_fn(self, windows: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """The draft proposer: ONE batched ``generate`` of the draft
        model over every slot's left-padded ``spec_window`` history (a
        ragged prefill, then ``spec_k`` greedy steps through the
        contiguous decode kernel). Its cache is made anew each round:
        nothing to keep consistent or roll back."""
        dev = self._draft.device
        out = generate(
            self._draft, torch.from_numpy(windows).to(dev),
            max_new_tokens=self.spec_k, temperature=0.0,
            prompt_lengths=torch.from_numpy(lens).to(dev), device=dev,
        )
        return out[:, self.spec_window:].cpu().numpy()

    def _propose(self) -> dict[int, np.ndarray]:
        """Draft tokens per active slot for this step's verify tile:
        ``{slot: [n_j] tokens}``, ``1 <= n_j <= min(spec_k, budget left -
        1)`` (more than the budget is wasted and would write past the
        admission reservation). A slot missing here single-steps inside
        the verify tile, or in the plain decode step when nobody
        proposed. A proposer exception (the ``serve.draft`` site
        included) degrades that slot to plain decode for the rest of its
        request; a failed batched draft call degrades every slot in it,
        unless a kernel failed to build or launch or CUDA raised: that
        propagates (``ops._build.is_device_failure``)."""
        out: dict[int, np.ndarray] = {}
        want: list[int] = []
        for slot in np.flatnonzero(self._active):
            slot = int(slot)
            req = self._req[slot]
            r = req.max_new_tokens - len(self._tokens[slot])
            if r < 2 or self._slot_spec_degraded[slot]:
                continue
            try:
                faults.maybe_raise("serve.draft", key=req.id)
            except Exception as e:
                self._spec_degrade(slot, e)
                continue
            want.append(slot)
        if not want:
            return out
        if self.spec_mode == "ngram":
            for slot in want:
                req = self._req[slot]
                r = req.max_new_tokens - len(self._tokens[slot])
                try:
                    hist = np.concatenate(
                        [req.prompt, np.asarray(self._tokens[slot], np.int32)]
                    )
                    d = ngram_propose(hist, min(self.spec_k, r - 1))
                except Exception as e:
                    self._spec_degrade(slot, e)
                    continue
                if d.size:
                    out[slot] = d.astype(np.int64)
            return out
        w = self.spec_window
        windows = np.zeros((self.num_slots, w), np.int32)
        lens = np.ones(self.num_slots, np.int32)
        for slot in want:
            req = self._req[slot]
            hist = np.concatenate(
                [req.prompt, np.asarray(self._tokens[slot], np.int32)]
            )[-w:]
            windows[slot, w - hist.size:] = hist
            lens[slot] = hist.size
        try:
            drafts = self._draft_fn(windows, lens)
        except Exception as e:
            if is_device_failure(e):
                raise
            # A crashing draft model would crash every later round too.
            for slot in want:
                self._spec_degrade(slot, e)
            return out
        for slot in want:
            req = self._req[slot]
            r = req.max_new_tokens - len(self._tokens[slot])
            d = drafts[slot, :min(self.spec_k, r - 1)]
            if d.size:
                out[slot] = d.astype(np.int64)
        return out

    def _spec_degrade(self, slot: int, err: Exception) -> None:
        """Sticky per-request degradation to plain single-token decode."""
        self._slot_spec_degraded[slot] = True
        self._m_spec_draft_failures.inc()
        self.stats["spec_draft_failures"] += 1
        get_logger().warning(
            "serving: draft proposer failed for slot %d (%s: %s) — "
            "degrading to plain single-token decode for this request",
            slot, type(err).__name__, err,
        )

    def _spec_verify(self, drafts: dict[int, np.ndarray]) -> None:
        """One speculative step over the slot array: build the
        ``[B, k + 1]`` tile (each row's last token + its drafts,
        zero-padded: pad columns write past the row's occupancy or into
        the trash block), run the verify forward, accept each row's
        longest draft prefix matching the greedy predictions plus the
        target's own next token, then roll back: tail blocks appended for
        rejected drafts return to the pool and every cursor rewinds to the
        accepted length. eos and the budget retire mid-group; the
        deadline check runs once after the group."""
        k = self.spec_k
        tile = np.zeros((self.num_slots, k + 1), np.int32)
        tile[:, 0] = self._last_tok
        n_prop = 0
        for slot, d in drafts.items():
            tile[slot, 1: 1 + d.size] = d
            self._slot_spec_proposed[slot] += d.size
            n_prop += int(d.size)
        self._m_spec_proposed.inc(n_prop)
        self.stats["spec_proposed"] += n_prop
        t0 = time.perf_counter()
        logits, self.cache = _verify_step(
            self.model, self.cache, torch.from_numpy(tile).to(self.model.device)
        )
        preds = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        preds = self._agree(preds).cpu().numpy()
        dt = time.perf_counter() - t0
        n_active = int(self._active.sum())
        self.stats["decode_verify"] += 1
        self.stats["decode_steps"] += 1
        self.stats["slot_steps"] += n_active
        self._m_decodes.inc()
        self._m_spec_verifies.inc()
        self._phase(
            "verify", t0=t0, dur_s=dt, trace=self._engine_trace,
            active=n_active, proposed=n_prop, k=k,
        )
        self._note_hbm()

        bs = self.block_size
        for slot in range(self.num_slots):
            if not self._active[slot]:
                continue
            req = self._req[slot]
            d = drafts.get(slot)
            n_j = int(d.size) if d is not None else 0
            # Draft j survives iff it equals the prediction at j - 1.
            a = 0
            while a < n_j and tile[slot, a + 1] == preds[slot, a]:
                a += 1
            group = [int(x) for x in tile[slot, 1: a + 1]]
            group.append(int(preds[slot, a]))
            per_tok = dt / len(group)
            emitted = 0
            retired = False
            # The group lands together, so its tokens share one arrival.
            t_group = time.perf_counter() - req.t_submit
            for i, tok in enumerate(group):
                self._tokens[slot].append(tok)
                self._len[slot] += 1
                self._latency[slot].append(per_tok)
                self._tok_times[slot].append(t_group)
                self._m_tpot.observe(per_tok)
                self._last_tok[slot] = tok
                emitted += 1
                if i < a:
                    self._slot_spec_accepted[slot] += 1
                    self._m_spec_accepted.inc()
                    self.stats["spec_accepted"] += 1
                if self._finishes(slot, tok):
                    retired = True
                    break
            self.stats["step_tokens"] += emitted
            if n_j > 0:
                self.stats["spec_emitted"] += emitted
                self.stats["spec_slot_verifies"] += 1
                self._m_spec_per_verify.observe(float(emitted))
            self._phase(
                "decode_tick", t0=t0, dur_s=dt, trace=req.trace,
                parent=req.span, slot=slot,
                token=len(self._tokens[slot]) - 1, spec_emitted=emitted,
            )
            if retired:
                continue
            # Mid-decode deadline cancellation, atomic over the group.
            if self._expired(req):
                self._m_deadline.inc()
                self._retire(slot, "deadline")
                continue
            # Blocks appended for rejected positions go back to the pool
            # and are re-counted as future reservations.
            need = (int(self._len[slot]) - 1) // bs + 1
            while len(self._slot_blocks[slot]) > need:
                bid = self._slot_blocks[slot].pop()
                self._tables[slot, len(self._slot_blocks[slot])] = 0
                self._tables_dirty = True
                self._deref(bid)
                self._slot_future[slot] += 1
                self._reserved_future += 1
                self.stats["block_rollback"] += 1
        # The verify advanced every cursor by k + 1; an active row's true
        # occupancy is _len - 1. Inactive rows park at 0 (trash block).
        new_idx = np.where(self._active, self._len - 1, 0).astype(np.int32)
        rewind_cache_indices(self.cache, torch.from_numpy(new_idx))
        self._m_pool_util.set(self.pool_utilization())

    # ------------------------------------------------- paged block allocator

    def _deref(self, bid: int) -> None:
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)

    def _evict_one(self) -> bool:
        """Drop the least-recently-used prefix-cache entry; its blocks
        free once no slot (and no other entry) references them."""
        if not self._prefix_cache:
            return False
        _, ids = self._prefix_cache.popitem(last=False)
        for bid in ids:
            self._deref(bid)
        self.stats["prefix_evictions"] += 1
        return True

    def _match_prefix(self, prompt: np.ndarray) -> tuple[int, tuple[int, ...]]:
        """Longest cached full-block chain matching the prompt's leading
        tokens, capped so at least one token remains to prefill. Sharing
        is full-block granular: the block holding the first divergent (or
        final partial) position is re-derived privately (copy-on-write),
        so shared blocks stay immutable. Keys are the exact token bytes,
        never hashes: a collision would serve one prompt's K/V to
        another."""
        if not self.prefix_cache_enabled:
            return 0, ()
        bs = self.block_size
        for i in range((int(prompt.size) - 1) // bs, 0, -1):
            key = prompt[: i * bs].tobytes()
            entry = self._prefix_cache.get(key)
            if entry is not None:
                self._prefix_cache.move_to_end(key)
                return i, entry
        return 0, ()

    def _register_prefix(self, prompt: np.ndarray, blocks: list[int]) -> None:
        """Publish every full-block chain of this prompt (each entry
        holds one reference per block, released at eviction)."""
        if not self.prefix_cache_enabled:
            return
        bs = self.block_size
        for i in range(1, int(prompt.size) // bs + 1):
            key = prompt[: i * bs].tobytes()
            if key in self._prefix_cache:
                self._prefix_cache.move_to_end(key)
                continue
            ids = tuple(blocks[:i])
            for bid in ids:
                self._ref[bid] += 1
            self._prefix_cache[key] = ids

    def _request_blocks(self, l: int, n_new: int) -> tuple[int, int]:
        """(blocks allocated at admission, worst-case total): positions
        cached over the request's life are [0, l + n_new - 1) (the final
        sampled token is never written back), and admission allocates
        through position ``l``, the first decode write."""
        bs = self.block_size
        highest = l + n_new - 2 if n_new >= 2 else l - 1
        total = highest // bs + 1
        return min(total, l // bs + 1), total

    def _pool_reserve(self, req: ServeRequest) -> dict | None:
        """Match the prefix, then reserve every block the request can ever
        need (private now + future appends), evicting idle prefix entries
        LRU if that can make the room. ``None``: the pool cannot host the
        request yet, and the queue head waits."""
        l, n_new = int(req.prompt.size), req.max_new_tokens
        m, shared = self._match_prefix(req.prompt)
        n_now, n_total = self._request_blocks(l, n_new)
        need = (n_now - m) + (n_total - n_now)
        # Pin the shared chain first so eviction can never free it.
        for bid in shared:
            self._ref[bid] += 1
        if len(self._free) - self._reserved_future < need:
            # Evict only if eviction can satisfy the request (blocks held
            # by cache entries alone); otherwise a deferred head would
            # strip the prefix cache every step for nothing.
            cache_refs = collections.Counter(
                bid for ids in self._prefix_cache.values() for bid in ids
            )
            freeable = sum(
                1 for bid, c in cache_refs.items() if self._ref[bid] == c
            )
            if len(self._free) + freeable - self._reserved_future < need:
                for bid in shared:
                    self._deref(bid)
                return None
            while (len(self._free) - self._reserved_future < need
                   and self._evict_one()):
                pass
        priv = [self._free.pop() for _ in range(n_now - m)]
        for bid in priv:
            self._ref[bid] += 1
        self._reserved_future += n_total - n_now
        return {"m": m, "shared": list(shared), "priv": priv,
                "future": n_total - n_now}

    def _pool_release(self, res: dict) -> None:
        """Roll back the reservation of an admission that failed."""
        for bid in res["priv"] + res["shared"]:
            self._deref(bid)
        self._reserved_future -= res["future"]

    def _note_pool_peak(self) -> None:
        """High-watermark of pool DEMAND: blocks held by slots and by
        parked requests plus worst-case reservations, shared blocks
        counted once. Blocks held only by the prefix cache are excluded
        (evicted on demand)."""
        held = {bid for blks in self._slot_blocks for bid in blks}
        held.update(
            bid for blks in self._parked_held.values() for bid in blks
        )
        demand = len(held) + self._reserved_future
        if demand > self.stats["pool_peak_blocks"]:
            self.stats["pool_peak_blocks"] = demand

    def pool_utilization(self) -> float:
        """Allocated blocks / usable blocks (trash excluded)."""
        if not self.paged:
            return 0.0
        usable = self.pool_blocks - 1
        return (usable - len(self._free)) / max(usable, 1)

    def block_bytes(self) -> int:
        """Device bytes of one pool block (all layers): the unit paged
        admission is priced in. 0 before the pool exists."""
        if not self.paged or self.cache is None:
            return 0
        return pool_block_bytes(self.cache,
                                num_heads=self.model.config.num_heads)

    # --------------------------------------------------------- scheduling

    def _bucket_for(self, needed: int) -> int:
        return next_cache_bucket(self.seq_len, needed, floor=self.min_bucket)

    def _ensure_bucket(self, needed: int) -> None:
        """Grow the cache to the bucket covering ``needed`` tokens: every
        capacity-bearing leaf is zero-padded along its capacity axis.
        Raises ``CacheGrowError`` (counted) when the growth fails; the
        callers degrade per request."""
        target = self._bucket_for(needed)
        if target <= self.bucket:
            return
        t0 = time.perf_counter()
        try:
            faults.maybe_raise(
                "serve.grow", CacheGrowError,
                msg=f"injected grow failure {self.bucket}->{target}",
            )
            grown = {}
            for name, e in self.cache.items():
                ax = cache_capacity_axis(e, self.bucket)
                if ax is None:
                    grown[name] = e
                    continue
                pad = [0, 0] * (e.dim() - ax - 1) + [0, target - self.bucket]
                grown[name] = F.pad(byte_view(e), pad).view(e.dtype)
        except Exception as e:
            self._m_grow_failures.inc()
            self.stats["grow_failures"] += 1
            if isinstance(e, CacheGrowError):
                raise
            raise CacheGrowError(
                f"cache grow {self.bucket}->{target} failed: {e}"
            ) from e
        self.cache = grown
        self.stats[f"grow_{self.bucket}->{target}"] += 1
        self._m_grows.inc()
        self._phase(
            "bucket_grow", t0=t0, dur_s=time.perf_counter() - t0,
            trace=self._engine_trace, frm=self.bucket, to=target,
        )
        self.bucket = target
        self._m_bytes_slot.set(self.bytes_per_slot())

    def _graft(self, slot_cache: dict, slot: int, s_p: int) -> None:
        """Write one prefilled request's cache rows (capacity ``s_p``)
        into the engine cache at ``slot``; positions past ``s_p`` keep
        what the row held before, masked by the new row's occupancy. A
        cache split over the batch axes takes the slot on the rank that
        holds its row."""
        row = slot - self._row0
        if not 0 <= row < self._rows:
            return
        for name, e in self.cache.items():
            p = slot_cache[name]
            ax = cache_batch_axis(e, self._rows)
            if ax is None:
                raise ValueError(
                    f"cache leaf {name} {tuple(e.shape)} carries no slot rows"
                )
            dst = e.narrow(ax, row, 1)
            cap = cache_capacity_axis(p, s_p)
            if cap is not None:
                dst = dst.narrow(cap, 0, s_p)
            byte_view(dst).copy_(byte_view(p))

    def _init_paged_cache(self) -> None:
        self.cache = self.model.init_paged_cache(
            self.num_slots, self.block_size, self.pool_blocks
        )
        self._tables_dirty = True

    def _seed_for(self, req: ServeRequest, res: dict | None) -> dict | None:
        """The seed of a shared-prefix admission (both admission paths):
        the ``m`` matched pool blocks gathered into the leading positions
        of a fresh one-row contiguous cache of capacity
        ``bucket_for(len(prompt))``, its cursors at ``m * bs``. Only the
        shared blocks move. ``None`` when there is no prefix hit."""
        m = res["m"] if res is not None else 0
        if m == 0:
            return None
        bs = self.block_size
        s_c = self._bucket_for(int(req.prompt.size))
        dev = self.model.device
        ids = torch.tensor(res["shared"], dtype=torch.long, device=dev)
        seed = {}
        for name, leaf in self.cache.items():
            if name in SLOT_LEAF_OF:
                # Pools [L, N, bs, ...]: K/V [.., H, hd], scales [.., H].
                l_, tail = leaf.shape[0], tuple(leaf.shape[3:])
                contig = zeros((l_, 1, s_c) + tail, leaf.dtype, dev)
                byte_view(contig)[:, 0, : m * bs] = byte_view(leaf)[
                    :, ids].reshape((l_, m * bs) + tail)
                seed[SLOT_LEAF_OF[name]] = contig
            elif name == "cache_index":
                seed[name] = torch.full((leaf.shape[0], 1), m * bs,
                                        dtype=torch.int32, device=dev)
            elif name == "pos_index":
                seed[name] = torch.full((1,), m * bs, dtype=torch.int32,
                                        device=dev)
        return seed

    def _graft_package(self, slot: int, req: ServeRequest, res: dict | None,
                       slot_cache: dict, s_p: int, m: int,
                       sliced: bool = False) -> None:
        """Move the prefilled cache into the engine cache. Paged: splice
        only the private blocks that change owner into the pool, then
        write the slot's table row (``sliced``: the slot cache holds only
        those blocks' window, from its position 0). Bucketed: the
        slot-row graft."""
        l = int(req.prompt.size)
        if self.paged:
            n_g = blocks_for_tokens(l, self.block_size)
            splice_pool_blocks(
                self.cache, slot_cache, res["priv"][: n_g - m],
                0 if sliced else m, slot, block_size=self.block_size,
            )
            blocks = res["shared"] + res["priv"]
            self._tables[slot, :] = 0
            self._tables[slot, : len(blocks)] = blocks
            self._tables_dirty = True
            return
        if self.cache is None:
            self.cache = self.model.init_cache(self.num_slots, s_p)
            self.bucket = s_p
        self._ensure_bucket(max(s_p, l + 1))
        self._graft(slot_cache, slot, s_p)

    def _admit(self) -> None:
        for slot in range(self.num_slots):
            if self._active[slot]:
                continue
            # One free slot keeps consuming the queue until a request
            # admits: expired and poison requests resolve typed and must
            # not burn the slot's admission for this step.
            while self._queue:
                req = self._queue[0]
                if self._expired(req):
                    # Past deadline while queued: shed before any prefill.
                    self._queue.popleft()
                    self._m_deadline.inc()
                    self._complete_unadmitted(req, "deadline")
                    continue
                res = None
                if self.paged:
                    res = self._pool_reserve(req)
                    if res is None:
                        # Pool headroom exhausted: the head request WAITS
                        # (FIFO: no smaller request jumps it) for retiring
                        # slots to release blocks.
                        self.stats["admission_deferred"] += 1
                        return
                self._queue.popleft()
                if self._try_admit(slot, req, res):
                    break

    def _rng_generator(self) -> torch.Generator | None:
        """The generator the sampled draws come from (None when greedy:
        nothing is drawn)."""
        if self._sample_kw["temperature"] == 0.0:
            return None
        if self._generator is not None:
            return self._generator
        dev = self.model.device
        if dev.type == "cuda":
            return torch.cuda.default_generators[dev.index]
        return torch.default_generator

    def _try_admit(self, slot: int, req: ServeRequest,
                   res: dict | None = None) -> bool:
        """Prefill + graft ``req`` into ``slot``. A failure anywhere in
        the request's own admission (a poison prompt crashing the
        prefill, the ``serve.prefill`` site, a failed growth) quarantines
        THIS request with a typed ``"error"`` completion and leaves the
        engine serving; its pool reservation is released and the
        sampling generator is put back where it was, so later requests
        draw exactly what a fault-free run would give them. A kernel that
        failed to build or launch, or a CUDA error, is no poison request:
        it propagates."""
        l = int(req.prompt.size)
        gen = self._rng_generator()
        rng_state = gen.get_state() if gen is not None else None
        t0 = time.perf_counter()
        # Queue wait is only known now: emitted retrospectively, from
        # submit to admission, as the request tree's first leaf.
        self._phase(
            "queue_wait", t0=req.t_submit, dur_s=t0 - req.t_submit,
            trace=req.trace, parent=req.span, slot=slot,
        )
        try:
            faults.maybe_raise("serve.prefill", key=req.id)
            if self.paged and self.cache is None:
                self._init_paged_cache()
            tok, slot_cache, s_p, m, l_suf = prefill_request(
                self.model, req, res,
                block_size=self.block_size if self.paged else 0,
                bucket_for=self._bucket_for, sample_kw=self._sample_kw,
                generator=self._generator,
                seed_cache=self._seed_for(req, res) if self.paged else None,
            )
            t_graft = time.perf_counter()
            self._graft_package(slot, req, res, slot_cache, s_p, m)
            self._phase(
                "graft", t0=t_graft, dur_s=time.perf_counter() - t_graft,
                trace=req.trace, parent=req.span, slot=slot,
                bucket=self.bucket,
                **({"blocks": blocks_for_tokens(l, self.block_size) - m,
                    "shared": m} if self.paged else {}),
            )
            first = int(tok[0])
            err = None
        except Exception as e:
            if is_device_failure(e):
                raise
            err = e
        if self._agree_failed(err is not None):
            e = err or RuntimeError("admission failed on another rank")
            if self.paged:
                self._tables[slot, :] = 0
                self._tables_dirty = True
            if rng_state is not None:
                gen.set_state(rng_state)
            if res is not None:
                self._pool_release(res)
            self._m_quarantined.inc()
            self.stats["quarantined"] += 1
            get_logger().warning(
                "serving: request %d quarantined at admission "
                "(%s: %s) — slot %d stays free, batch keeps decoding",
                req.id, type(e).__name__, e, slot,
            )
            self._complete_unadmitted(req, "error")
            return False
        if self._lockstep:
            first = int(self._agree(tok)[0])
        self._finish_admit(slot, req, res, first, t0=t0,
                           dt=time.perf_counter() - t0, s_p=s_p, m=m,
                           l_suf=l_suf)
        return True

    def _finish_admit(self, slot: int, req: ServeRequest, res: dict | None,
                      tok: int, *, t0: float, dt: float, s_p: int, m: int,
                      l_suf: int) -> None:
        """Admission bookkeeping shared by the colocated path and the
        disaggregated handoff: stats, SLO observations, prefix
        publication, slot activation. ``dt`` is the request's TTFT
        (prefill + graft + the first-token fetch)."""
        bs = self.block_size if self.paged else 0
        self.stats[f"prefill_{s_p}"] += 1
        self.stats["admitted"] += 1
        self.stats["prefill_tokens"] += l_suf
        self._m_ttft.observe(dt)
        self._m_prefills.inc()
        self._m_grafts.inc()
        self._m_bytes_slot.set(self.bytes_per_slot())
        if self.paged:
            self._slot_blocks[slot] = res["shared"] + res["priv"]
            self._slot_future[slot] = res["future"]
            self._note_pool_peak()
            self._slot_prefix_hit[slot] = m > 0
            self._slot_tokens_saved[slot] = m * bs
            if m > 0:
                self.stats["prefix_hits"] += 1
                self.stats["prefill_tokens_saved"] += m * bs
                self._m_prefix_hits.inc()
                self._m_prefix_saved.inc(m * bs)
            self._m_prefix_hit_rate.set(
                self.stats["prefix_hits"] / self.stats["admitted"]
            )
            self._m_pool_util.set(self.pool_utilization())
            self._register_prefix(req.prompt, self._slot_blocks[slot])
        self._phase(
            "prefill", t0=t0, dur_s=dt, trace=req.trace, parent=req.span,
            slot=slot, bucket=s_p, request=req.id,
            **({"prefix_hit": m > 0, "tokens_saved": m * bs}
               if self.paged else {}),
        )
        self._req[slot] = req
        self._tokens[slot] = [tok]
        self._len[slot] = int(req.prompt.size) + 1
        self._active[slot] = True
        self._latency[slot] = [dt]
        self._tok_times[slot] = [time.perf_counter() - req.t_submit]
        self._last_tok[slot] = tok
        self._slot_spec_degraded[slot] = False
        self._slot_spec_proposed[slot] = 0
        self._slot_spec_accepted[slot] = 0
        # The first sampled token can already finish the request.
        self._finishes(slot, tok)

    # ------------------------------------------- disaggregated entry points

    def admit_handoff(self, slot: int, req: ServeRequest, res: dict,
                      slot_cache: dict, tok: int, *, m: int,
                      prefill_s: float, sliced: bool = False) -> None:
        """Decode-worker admission of a prefill-worker package: splice its
        private blocks into the pool (``splice_pool_blocks``, as colocated
        admission does) and activate the slot. ``prefill_s`` is the
        prefill worker's wall time, folded into the request's TTFT;
        ``sliced``: the package carries only the private blocks' window
        (a separate prefill partition's transfer). The splice writes this
        rank's heads of the pool from this rank's heads of the slot cache:
        no collective. Raises on a splice failure (the
        scheduler re-queues the request); the slot's bookkeeping runs
        only after the splice."""
        assert self.paged, "handoff admission is a paged-engine contract"
        assert not self._active[slot], f"slot {slot} is occupied"
        l = int(req.prompt.size)
        bs = self.block_size
        t0 = time.perf_counter()
        if self.cache is None:
            self._init_paged_cache()
        s_p = self._bucket_for(l - m * bs)
        self._graft_package(slot, req, res, slot_cache, s_p, m, sliced)
        dt_splice = time.perf_counter() - t0
        self.stats["handoff_splices"] += 1
        self._phase(
            "handoff", t0=t0, dur_s=dt_splice, trace=req.trace,
            parent=req.span, slot=slot,
            blocks=blocks_for_tokens(l, bs) - m, shared=m,
        )
        # The prefill ran on the worker before the splice: its span is
        # [splice start - prefill_s, now].
        self._finish_admit(slot, req, res, tok, t0=t0 - prefill_s,
                           dt=prefill_s + dt_splice, s_p=s_p, m=m,
                           l_suf=l - m * bs)

    def park_slot(self, slot: int) -> dict:
        """Preemption PARK: deactivate ``slot`` while its request keeps
        owning its KV blocks, with no device work (the row's table points
        back at the trash block, the blocks stay referenced by the parked
        request, and the worst-case reservation stays accounted). Returns
        the parked state ``resume_parked`` restores."""
        assert self.paged, "parking is a paged-engine contract"
        assert self._active[slot], f"slot {slot} has nothing to park"
        parked = {
            "req": self._req[slot],
            "tokens": self._tokens[slot],
            "len": int(self._len[slot]),
            "last_tok": int(self._last_tok[slot]),
            "latency": self._latency[slot],
            "tok_times": self._tok_times[slot],
            "blocks": self._slot_blocks[slot],
            "future": int(self._slot_future[slot]),
            "prefix_hit": bool(self._slot_prefix_hit[slot]),
            "tokens_saved": int(self._slot_tokens_saved[slot]),
            "spec": (
                bool(self._slot_spec_degraded[slot]),
                int(self._slot_spec_proposed[slot]),
                int(self._slot_spec_accepted[slot]),
            ),
        }
        self._req[slot] = None
        self._active[slot] = False
        self._tokens[slot] = []
        self._latency[slot] = []
        self._tok_times[slot] = []
        self._len[slot] = 0
        self._slot_blocks[slot] = []
        self._slot_future[slot] = 0
        self._parked_held[parked["req"].id] = parked["blocks"]
        self._tables[slot, :] = 0
        self._tables_dirty = True
        self.stats["parked"] += 1
        req = parked["req"]
        self._phase(
            "park", t0=time.perf_counter(), dur_s=0.0,
            trace=req.trace, parent=req.span, slot=slot,
            n_tokens=len(parked["tokens"]),
        )
        return parked

    def resume_parked(self, parked: dict, slot: int) -> None:
        """Preemption RESUME: re-own the parked block table into ``slot``
        (a table-row write) and restore the row's device cursors (the
        speculation rollback's ``rewind_cache_indices``; active rows
        already sit at ``len - 1``). The request continues from its
        parked ``last_tok``: nothing about its K/V moved."""
        assert self.paged and not self._active[slot]
        req = parked["req"]
        self._req[slot] = req
        self._tokens[slot] = parked["tokens"]
        self._len[slot] = parked["len"]
        self._last_tok[slot] = parked["last_tok"]
        self._latency[slot] = parked["latency"]
        self._tok_times[slot] = parked["tok_times"]
        self._slot_blocks[slot] = parked["blocks"]
        self._slot_future[slot] = parked["future"]
        self._slot_prefix_hit[slot] = parked["prefix_hit"]
        self._slot_tokens_saved[slot] = parked["tokens_saved"]
        (self._slot_spec_degraded[slot], self._slot_spec_proposed[slot],
         self._slot_spec_accepted[slot]) = parked["spec"]
        self._parked_held.pop(req.id, None)
        self._active[slot] = True
        self._tables[slot, :] = 0
        self._tables[slot, : len(parked["blocks"])] = parked["blocks"]
        self._tables_dirty = True
        new_idx = np.where(self._active, self._len - 1, 0).astype(np.int32)
        rewind_cache_indices(self.cache, torch.from_numpy(new_idx))
        self.stats["resumed"] += 1
        self._phase(
            "resume", t0=time.perf_counter(), dur_s=0.0,
            trace=req.trace, parent=req.span, slot=slot,
            n_tokens=len(parked["tokens"]),
        )

    def retire_parked(self, parked: dict, reason: str) -> None:
        """Resolve a PARKED request without resuming it (the scheduler's
        parked-deadline sweep): the typed completion carries the tokens
        generated before the park, the blocks and reservation are
        released and the span closes. No slot and no device work."""
        assert self.paged, "parking is a paged-engine contract"
        req = parked["req"]
        lat = parked["latency"]
        tpot = _log2_quantiles(lat[1:], (0.50, 0.99))
        self._completed.append(Completion(
            id=req.id,
            tokens=np.concatenate(
                [req.prompt, np.asarray(parked["tokens"], np.int32)]
            ),
            prompt_len=int(req.prompt.size),
            finish_reason=reason,
            token_latencies_s=lat,
            ttft_s=lat[0] if lat else 0.0,
            tpot_p50_s=tpot[0],
            tpot_p99_s=tpot[1],
            prefix_cache_hit=parked["prefix_hit"],
            prefill_tokens_saved=parked["tokens_saved"],
            spec_accept_rate=(
                parked["spec"][2] / parked["spec"][1]
                if parked["spec"][1] else 0.0
            ),
            token_times_s=parked["tok_times"],
        ))
        for bid in parked["blocks"]:
            self._deref(bid)
        self._reserved_future -= parked["future"]
        self._parked_held.pop(req.id, None)
        self._m_pool_util.set(self.pool_utilization())
        self.stats["completed"] += 1
        self.stats[f"finish_{reason}"] += 1
        self._m_completed.inc()
        self._phase(
            "retire", t0=time.perf_counter(), dur_s=0.0,
            trace=req.trace, parent=req.span,
            request=req.id, reason=reason, n_tokens=len(parked["tokens"]),
        )
        req.span.end(finish_reason=reason, n_tokens=len(parked["tokens"]))

    def _finishes(self, slot: int, tok: int) -> bool:
        """Retire ``slot`` if ``tok`` ends its request."""
        if self.eos_id is not None and tok == self.eos_id:
            self._retire(slot, "eos")
            return True
        if len(self._tokens[slot]) >= self._req[slot].max_new_tokens:
            self._retire(slot, "length")
            return True
        return False

    def _retire(self, slot: int, reason: str) -> None:
        req = self._req[slot]
        lat = self._latency[slot]
        # ttft is the prefill (lat[0]); tpot covers the decode steps.
        tpot = _log2_quantiles(lat[1:], (0.50, 0.99))
        proposed = int(self._slot_spec_proposed[slot])
        self._completed.append(Completion(
            id=req.id,
            tokens=np.concatenate(
                [req.prompt, np.asarray(self._tokens[slot], np.int32)]
            ),
            prompt_len=int(req.prompt.size),
            finish_reason=reason,
            token_latencies_s=lat,
            ttft_s=lat[0] if lat else 0.0,
            tpot_p50_s=tpot[0],
            tpot_p99_s=tpot[1],
            prefix_cache_hit=(
                bool(self._slot_prefix_hit[slot]) if self.paged else False
            ),
            prefill_tokens_saved=(
                int(self._slot_tokens_saved[slot]) if self.paged else 0
            ),
            spec_accept_rate=(
                float(self._slot_spec_accepted[slot]) / proposed
                if proposed else 0.0
            ),
            token_times_s=self._tok_times[slot],
        ))
        self._req[slot] = None
        self._active[slot] = False
        if self.paged:
            # Release the slot's references (prefix-cache entries keep
            # shared chains alive), drop the unexercised reservation, and
            # point the table row at the trash block.
            for bid in self._slot_blocks[slot]:
                self._deref(bid)
            self._reserved_future -= int(self._slot_future[slot])
            self._slot_blocks[slot] = []
            self._slot_future[slot] = 0
            self._tables[slot, :] = 0
            self._tables_dirty = True
            self._m_pool_util.set(self.pool_utilization())
        self.stats["completed"] += 1
        self.stats[f"finish_{reason}"] += 1
        self._m_completed.inc()
        self._phase(
            "retire", t0=time.perf_counter(), dur_s=0.0,
            trace=req.trace, parent=req.span,
            slot=slot, request=req.id, reason=reason,
            n_tokens=len(self._tokens[slot]),
        )
        req.span.end(finish_reason=reason, n_tokens=len(self._tokens[slot]))

    # --------------------------------------------------------------- step

    def _drain_completed(self) -> list[Completion]:
        out, self._completed = self._completed, []
        return out

    def _append_blocks(self, drafts: dict[int, np.ndarray]) -> None:
        """Paged growth: a row crossing a block boundary (with its draft
        positions) takes one reserved block per crossing onto its table;
        the admission reservation guarantees a free one, so the only
        failure left is the ``serve.grow`` site, which retires the
        crossing row typed ``"error"`` while the batch keeps decoding."""
        for slot in np.flatnonzero(self._active):
            slot = int(slot)
            extra = len(drafts.get(slot, ()))
            need = (int(self._len[slot]) - 1 + extra) // self.block_size + 1
            while len(self._slot_blocks[slot]) < need:
                try:
                    faults.maybe_raise(
                        "serve.grow", CacheGrowError,
                        msg=f"injected block-append failure slot {slot}",
                    )
                    bid = self._free.pop()
                except Exception as e:
                    self._m_grow_failures.inc()
                    self.stats["grow_failures"] += 1
                    get_logger().warning(
                        "serving: block append failed for slot %d "
                        "(%s: %s); retiring it, batch keeps decoding",
                        slot, type(e).__name__, e,
                    )
                    drafts.pop(slot, None)
                    self._retire(slot, "error")
                    break
                self._reserved_future -= 1
                self._slot_future[slot] -= 1
                self._ref[bid] += 1
                self._slot_blocks[slot].append(bid)
                self._tables[slot, len(self._slot_blocks[slot]) - 1] = bid
                self._tables_dirty = True
                self.stats["block_append"] += 1
                self._m_block_appends.inc()
                self._phase(
                    "block_append", t0=time.perf_counter(), dur_s=0.0,
                    trace=self._engine_trace, slot=slot, block=bid,
                )
        self._m_pool_util.set(self.pool_utilization())

    def step(self) -> list[Completion]:
        """Admit into free slots, run ONE decode (or verify) iteration
        over the slot array, retire finished rows. Returns the requests
        completed during this step (possibly at admission, for 1-token
        budgets; typed shed / deadline / error resolutions ride along)."""
        if self._dormant:
            return []
        with self._mesh():
            self._plan_step()
            return self._step()

    def _step(self) -> list[Completion]:
        """``step`` after its plan (the disaggregated scheduler plans its
        own tick and then runs this)."""
        self._m_queue.set(len(self._queue))
        self._admit()
        self._completed.extend(self._early)
        self._early.clear()
        self._m_occupancy.set(float(self._active.sum()) / self.num_slots)
        if not self._active.any():
            return self._drain_completed()
        drafts: dict[int, np.ndarray] = {}
        if self.paged:
            if self.spec_mode != "off":
                drafts = self._propose()
            self._append_blocks(drafts)
            if not self._active.any():
                return self._drain_completed()
            if self._tables_dirty:
                self.cache["block_tables"].copy_(
                    torch.from_numpy(self._tables))
                self._tables_dirty = False
            if drafts:
                # At least one slot speculates: the whole batch rides the
                # verify tile (slots without drafts single-step in it).
                self._spec_verify(drafts)
                return self._drain_completed()
        else:
            # The bucket must hold every active row's next write
            # position (_len - 1), so it needs capacity _len.
            try:
                self._ensure_bucket(int(self._len[self._active].max()))
            except CacheGrowError as e:
                # Rows that NEED the larger bucket retire typed; rows
                # still inside it keep decoding.
                victims = [int(s) for s in np.flatnonzero(self._active)
                           if self._len[s] > self.bucket]
                get_logger().warning(
                    "serving: cache grow failed (%s); retiring %d slot(s) "
                    "needing the larger bucket, %d keep decoding",
                    e, len(victims), int(self._active.sum()) - len(victims),
                )
                for s in victims:
                    self._retire(s, "error")
                if not self._active.any():
                    return self._drain_completed()
        self._decode()
        return self._drain_completed()

    def _decode(self) -> None:
        t0 = time.perf_counter()
        tok = torch.from_numpy(self._last_tok).to(self.model.device)
        logits, self.cache = _decode_step(self.model, self.cache, tok)
        nxt = _sample(logits, self._generator, **self._sample_kw)
        nxt = self._agree(nxt).cpu().numpy()
        dt = time.perf_counter() - t0
        n_active = int(self._active.sum())
        self.stats["decode_paged" if self.paged
                   else f"decode_{self.bucket}"] += 1
        self.stats["decode_steps"] += 1
        self.stats["slot_steps"] += n_active
        self.stats["step_tokens"] += n_active
        self._m_decodes.inc()
        self._phase(
            "decode", t0=t0, dur_s=dt, trace=self._engine_trace,
            bucket=self.bucket, active=n_active,
        )
        self._note_hbm()
        for slot in range(self.num_slots):
            if not self._active[slot]:
                continue
            req = self._req[slot]
            tok = int(nxt[slot])
            self._tokens[slot].append(tok)
            self._len[slot] += 1
            self._latency[slot].append(dt)
            self._tok_times[slot].append(time.perf_counter() - req.t_submit)
            self._m_tpot.observe(dt)
            self._last_tok[slot] = tok
            self._phase(
                "decode_tick", t0=t0, dur_s=dt, trace=req.trace,
                parent=req.span, slot=slot,
                token=len(self._tokens[slot]) - 1,
            )
            if self._finishes(slot, tok):
                continue
            # Mid-decode deadline cancellation: a natural finish wins;
            # otherwise a request past its deadline retires now with the
            # tokens it has.
            if self._expired(req):
                self._m_deadline.inc()
                self._retire(slot, "deadline")
