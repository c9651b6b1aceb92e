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
- **Speculation** (``serving.speculate=ngram``, paged engine, greedy
  only): n-gram drafts from each slot's own history, one verify forward
  of every slot's ``[k + 1]`` tile, the longest draft prefix matching the
  greedy predictions accepted, then rollback: tail blocks return to the
  pool and every cursor rewinds. Acceptance is exact, so the output is
  token-identical to plain decode.
- **Quantized cache** (``model.kv_cache_quant``): the bf16 scale leaves
  grow, graft, splice and seed with the K/V leaves they scale (by shape
  and by name, ``models/generation.py``); 1-byte fp8 leaves move as
  bytes. Pool accounting reads the actual leaves, scales included.

Waiting for later slices (ROADMAP queue A): the draft-model proposer
(``speculate=draft``), disaggregation and the SLO scheduler, telemetry and
tracing, the fault sites with the admission quarantine, deadlines and
load shedding, mesh sharding. An exception during admission propagates
(after a paged reservation is released).
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from frl_distributed_ml_scaffold_tpu_torch import resolve_device
from frl_distributed_ml_scaffold_tpu_torch.config.schema import ServingConfig
from frl_distributed_ml_scaffold_tpu_torch.models.generation import (
    SLOT_LEAF_OF,
    _decode_step,
    _prefill,
    _sample,
    _verify_step,
    blocks_for_tokens,
    cache_batch_axis,
    cache_capacity_axis,
    next_cache_bucket,
    pool_block_bytes,
    rewind_cache_indices,
    splice_pool_blocks,
)
from frl_distributed_ml_scaffold_tpu_torch.ops.quantization import (
    byte_view,
    zeros,
)


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


@dataclasses.dataclass
class ServeRequest:
    """One queued generation request (prompt is an unpadded 1-D array)."""

    id: int
    prompt: np.ndarray
    max_new_tokens: int


@dataclasses.dataclass
class Completion:
    """A finished request: prompt + generated tokens, the wall latency of
    each generated token (``[0]`` is the prefill, the rest the decode
    steps the request was live for) and ``ttft_s``, time to first
    token. ``finish_reason`` is ``"eos"`` or ``"length"``.

    Paged engine only: ``prefix_cache_hit`` (the prompt reused cached
    prefix blocks), ``prefill_tokens_saved`` (prompt tokens never
    prefilled because of it) and ``spec_accept_rate`` (accepted / proposed
    draft tokens over the request's verify steps, 0.0 when none were
    proposed)."""

    id: int
    tokens: np.ndarray  # [prompt_len + n_generated]
    prompt_len: int
    finish_reason: str
    token_latencies_s: list[float]
    ttft_s: float = 0.0
    prefix_cache_hit: bool = False
    prefill_tokens_saved: int = 0
    spec_accept_rate: float = 0.0


def _check_serving(serving: ServingConfig) -> None:
    """Refuse the serving knobs this slice does not port yet."""
    todo = {
        "disaggregate": (
            serving.disaggregate, False,
            "queue A item 3, disaggregation and the SLO scheduler",
        ),
        "max_queue_depth": (
            serving.max_queue_depth, 0, "queue A item 3, load shedding"
        ),
        "default_deadline_s": (
            serving.default_deadline_s, 0.0, "queue A item 3, deadlines"
        ),
    }
    for name, (value, default, item) in todo.items():
        if value != default:
            raise NotImplementedError(
                f"serving.{name}={value!r} is not ported yet (ROADMAP {item})"
            )


def prefill_request(model, req: ServeRequest, res: dict | None, *,
                    block_size: int, bucket_for, sample_kw, generator,
                    seed_cache=None):
    """The admission prefill: bucket the (possibly prefix-stripped)
    prompt, left-pad the suffix and prefill it, seeded with the shared
    prefix's cache when ``seed_cache`` is given. Returns ``(tok [1],
    slot_cache, s_p, m, l_suf)``: prompt bucket, shared blocks and suffix
    length (``l_suf >= 1``: ``_match_prefix`` always leaves a token to
    prefill)."""
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

    ``serving`` takes the ``serving.*`` section of a config: the paged
    knobs (``kv_block_size``, ``kv_pool_blocks``, ``prefix_cache``) and
    speculation (``speculate``, ``speculate_k``). ``device=None`` means
    ``cuda``; the model must live on the resolved device."""

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
        _check_serving(serving)
        self.model = model
        self.num_slots = int(num_slots)
        self.eos_id = eos_id
        self._sample_kw = dict(
            temperature=temperature, top_k=top_k, top_p=top_p
        )
        self._generator = generator
        self.seq_len = model.config.seq_len
        self.min_bucket = 8
        n = self.num_slots

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
                raise NotImplementedError(
                    "serving.speculate='draft' (the draft-model proposer) "
                    "is not ported yet (ROADMAP queue A item 2, draft "
                    "tier); use speculate='ngram'"
                )
        self._slot_spec_proposed = np.zeros(n, np.int64)
        self._slot_spec_accepted = np.zeros(n, np.int64)

        self._queue: collections.deque[ServeRequest] = collections.deque()
        self._completed: list[Completion] = []
        self._next_id = 0
        self._issued_ids: set[int] = set()
        self._req: list[ServeRequest | None] = [None] * n
        self._tokens: list[list[int]] = [[] for _ in range(n)]
        self._len = np.zeros(n, np.int64)  # prompt + generated
        self._active = np.zeros(n, bool)
        self._latency: list[list[float]] = [[] for _ in range(n)]
        self._last_tok = np.zeros(n, np.int32)
        self.cache: dict | None = None
        self.bucket = 0
        # How often each shape class ran (prefill_<bucket>, decode_paged,
        # decode_verify, grow_<a>-><b>, ...), with the JAX engine's keys.
        self.stats = collections.Counter()

    # ----------------------------------------------------------- frontend

    def submit(
        self, prompt, max_new_tokens: int, request_id: int | None = None
    ) -> int:
        """Enqueue a request; returns its id. Malformed requests raise."""
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
        self._queue.append(ServeRequest(rid, prompt, int(max_new_tokens)))
        return rid

    @property
    def pending(self) -> int:
        return len(self._queue) + int(self._active.sum())

    def run(self) -> list[Completion]:
        """Drain the queue; returns completions in finish order."""
        out: list[Completion] = []
        while self.pending:
            out.extend(self.step())
        return out

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
        """Roll back the reservation of an admission that raised."""
        for bid in res["priv"] + res["shared"]:
            self._deref(bid)
        self._reserved_future -= res["future"]

    def _note_pool_peak(self) -> None:
        """High-watermark of pool DEMAND: blocks held by slots plus
        worst-case reservations, shared blocks counted once. Blocks held
        only by the prefix cache are excluded (evicted on demand)."""
        held = {bid for blks in self._slot_blocks for bid in blks}
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
        return pool_block_bytes(self.cache)

    # --------------------------------------------------------- scheduling

    def _bucket_for(self, needed: int) -> int:
        return next_cache_bucket(self.seq_len, needed, floor=self.min_bucket)

    def _ensure_bucket(self, needed: int) -> None:
        """Grow the cache to the bucket covering ``needed`` tokens: every
        capacity-bearing leaf is zero-padded along its capacity axis."""
        target = self._bucket_for(needed)
        if target <= self.bucket:
            return
        grown = {}
        for name, e in self.cache.items():
            ax = cache_capacity_axis(e, self.bucket)
            if ax is None:
                grown[name] = e
                continue
            pad = [0, 0] * (e.dim() - ax - 1) + [0, target - self.bucket]
            grown[name] = F.pad(byte_view(e), pad).view(e.dtype)
        self.cache = grown
        self.stats[f"grow_{self.bucket}->{target}"] += 1
        self.bucket = target

    def _graft(self, slot_cache: dict, slot: int, s_p: int) -> None:
        """Write one prefilled request's cache rows (capacity ``s_p``)
        into the engine cache at ``slot``; positions past ``s_p`` keep
        what the row held before, masked by the new row's occupancy."""
        for name, e in self.cache.items():
            p = slot_cache[name]
            ax = cache_batch_axis(e, self.num_slots)
            if ax is None:
                raise ValueError(
                    f"cache leaf {name} {tuple(e.shape)} carries no slot rows"
                )
            dst = e.narrow(ax, slot, 1)
            cap = cache_capacity_axis(p, s_p)
            if cap is not None:
                dst = dst.narrow(cap, 0, s_p)
            byte_view(dst).copy_(byte_view(p))

    def _seed_for(self, req: ServeRequest, res: dict | None) -> dict | None:
        """The seed of a shared-prefix admission: the ``m`` matched pool
        blocks gathered into the leading positions of a fresh one-row
        contiguous cache of capacity ``bucket_for(len(prompt))``, its
        cursors at ``m * bs``. Only the shared blocks move. ``None`` when
        there is no prefix hit."""
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
                       slot_cache: dict, s_p: int, m: int) -> None:
        """Move the prefilled cache into the engine cache. Paged: splice
        only the private blocks that change owner into the pool, then
        write the slot's table row. Bucketed: the slot-row graft."""
        l = int(req.prompt.size)
        if self.paged:
            n_g = blocks_for_tokens(l, self.block_size)
            splice_pool_blocks(
                self.cache, slot_cache, res["priv"][: n_g - m], m, slot,
                block_size=self.block_size,
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
            if not self._queue:
                return
            res = None
            if self.paged:
                res = self._pool_reserve(self._queue[0])
                if res is None:
                    # Pool headroom exhausted: the head request WAITS
                    # (FIFO: no smaller request jumps it) for retiring
                    # slots to release blocks.
                    self.stats["admission_deferred"] += 1
                    return
            self._admit_into(slot, self._queue.popleft(), res)

    def _admit_into(self, slot: int, req: ServeRequest,
                    res: dict | None) -> None:
        """Prefill + graft ``req`` into ``slot``."""
        t0 = time.perf_counter()
        try:
            if self.paged and self.cache is None:
                self.cache = self.model.init_paged_cache(
                    self.num_slots, self.block_size, self.pool_blocks
                )
                self._tables_dirty = True
            tok, slot_cache, s_p, m, l_suf = prefill_request(
                self.model, req, res,
                block_size=self.block_size if self.paged else 0,
                bucket_for=self._bucket_for, sample_kw=self._sample_kw,
                generator=self._generator,
                seed_cache=self._seed_for(req, res) if self.paged else None,
            )
            self._graft_package(slot, req, res, slot_cache, s_p, m)
            tok = int(tok[0])
        except BaseException:
            if res is not None:
                self._pool_release(res)
            raise
        self._finish_admit(slot, req, res, tok,
                           dt=time.perf_counter() - t0, s_p=s_p, m=m,
                           l_suf=l_suf)

    def _finish_admit(self, slot: int, req: ServeRequest, res: dict | None,
                      tok: int, *, dt: float, s_p: int, m: int,
                      l_suf: int) -> None:
        """Admission bookkeeping: stats, prefix publication, slot
        activation. ``dt`` is the request's TTFT (prefill + graft + the
        first-token fetch)."""
        self.stats[f"prefill_{s_p}"] += 1
        self.stats["admitted"] += 1
        self.stats["prefill_tokens"] += l_suf
        if self.paged:
            bs = self.block_size
            self._slot_blocks[slot] = res["shared"] + res["priv"]
            self._slot_future[slot] = res["future"]
            self._note_pool_peak()
            self._slot_prefix_hit[slot] = m > 0
            self._slot_tokens_saved[slot] = m * bs
            if m > 0:
                self.stats["prefix_hits"] += 1
                self.stats["prefill_tokens_saved"] += m * bs
            self._register_prefix(req.prompt, self._slot_blocks[slot])
        self._req[slot] = req
        self._tokens[slot] = [tok]
        self._len[slot] = int(req.prompt.size) + 1
        self._active[slot] = True
        self._latency[slot] = [dt]
        self._last_tok[slot] = tok
        self._slot_spec_proposed[slot] = 0
        self._slot_spec_accepted[slot] = 0
        # The first sampled token can already finish the request.
        self._finishes(slot, tok)

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
        proposed = int(self._slot_spec_proposed[slot])
        self._completed.append(
            Completion(
                id=req.id,
                tokens=np.concatenate(
                    [req.prompt, np.asarray(self._tokens[slot], np.int32)]
                ),
                prompt_len=int(req.prompt.size),
                finish_reason=reason,
                token_latencies_s=lat,
                ttft_s=lat[0],
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
            )
        )
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
        self.stats["completed"] += 1
        self.stats[f"finish_{reason}"] += 1

    # ------------------------------------------------ speculative decoding

    def _propose(self) -> dict[int, np.ndarray]:
        """N-gram drafts per active slot for this step's verify tile:
        ``{slot: [n_j] tokens}``, ``1 <= n_j <= min(spec_k, budget left -
        1)`` (more than the budget is wasted and would write past the
        admission reservation). A slot missing here single-steps inside
        the verify tile, or in the plain decode step when nobody
        proposed."""
        out: dict[int, np.ndarray] = {}
        for slot in np.flatnonzero(self._active):
            slot = int(slot)
            req = self._req[slot]
            r = req.max_new_tokens - len(self._tokens[slot])
            if r < 2:
                continue
            hist = np.concatenate(
                [req.prompt, np.asarray(self._tokens[slot], np.int32)]
            )
            d = ngram_propose(hist, min(self.spec_k, r - 1))
            if d.size:
                out[slot] = d.astype(np.int64)
        return out

    def _spec_verify(self, drafts: dict[int, np.ndarray]) -> None:
        """One speculative step over the slot array: build the
        ``[B, k + 1]`` tile (each row's last token + its drafts,
        zero-padded: pad columns write past the row's occupancy or into
        the trash block), run the verify forward, accept each row's
        longest draft prefix matching the greedy predictions plus the
        target's own next token, then roll back: tail blocks appended for
        rejected drafts return to the pool and every cursor rewinds to the
        accepted length."""
        k = self.spec_k
        tile = np.zeros((self.num_slots, k + 1), np.int32)
        tile[:, 0] = self._last_tok
        n_prop = 0
        for slot, d in drafts.items():
            tile[slot, 1: 1 + d.size] = d
            self._slot_spec_proposed[slot] += d.size
            n_prop += int(d.size)
        self.stats["spec_proposed"] += n_prop
        t0 = time.perf_counter()
        logits, self.cache = _verify_step(
            self.model, self.cache, torch.from_numpy(tile).to(self.model.device)
        )
        preds = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        preds = preds.cpu().numpy()
        dt = time.perf_counter() - t0
        self.stats["decode_verify"] += 1
        self.stats["decode_steps"] += 1
        self.stats["slot_steps"] += int(self._active.sum())

        bs = self.block_size
        for slot in range(self.num_slots):
            if not self._active[slot]:
                continue
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
            for i, tok in enumerate(group):
                self._tokens[slot].append(tok)
                self._len[slot] += 1
                self._latency[slot].append(per_tok)
                self._last_tok[slot] = tok
                emitted += 1
                if i < a:
                    self._slot_spec_accepted[slot] += 1
                    self.stats["spec_accepted"] += 1
                if self._finishes(slot, tok):
                    retired = True
                    break
            self.stats["step_tokens"] += emitted
            if n_j > 0:
                self.stats["spec_emitted"] += emitted
                self.stats["spec_slot_verifies"] += 1
            if retired:
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

    # --------------------------------------------------------------- step

    def _append_blocks(self, drafts: dict[int, np.ndarray]) -> None:
        """Paged growth: a row crossing a block boundary (with its draft
        positions) takes one reserved block per crossing onto its table;
        the admission reservation guarantees a free one."""
        for slot in np.flatnonzero(self._active):
            extra = len(drafts.get(int(slot), ()))
            need = (int(self._len[slot]) - 1 + extra) // self.block_size + 1
            while len(self._slot_blocks[slot]) < need:
                bid = self._free.pop()
                self._reserved_future -= 1
                self._slot_future[slot] -= 1
                self._ref[bid] += 1
                self._slot_blocks[slot].append(bid)
                self._tables[slot, len(self._slot_blocks[slot]) - 1] = bid
                self._tables_dirty = True
                self.stats["block_append"] += 1
        if self._tables_dirty:
            self.cache["block_tables"].copy_(torch.from_numpy(self._tables))
            self._tables_dirty = False

    def step(self) -> list[Completion]:
        """Admit into free slots, run ONE decode (or verify) iteration
        over the slot array, retire finished rows. Returns the requests
        completed during this step (possibly at admission, for 1-token
        budgets)."""
        self._admit()
        if self._active.any():
            drafts = {}
            if self.paged:
                if self.spec_mode != "off":
                    drafts = self._propose()
                self._append_blocks(drafts)
            else:
                # The bucket must hold every active row's next write
                # position (_len - 1), so it needs capacity _len.
                self._ensure_bucket(int(self._len[self._active].max()))
            if drafts:
                # At least one slot speculates: the whole batch rides the
                # verify tile (slots without drafts single-step in it).
                self._spec_verify(drafts)
            else:
                self._decode()
        out, self._completed = self._completed, []
        return out

    def _decode(self) -> None:
        t0 = time.perf_counter()
        tok = torch.from_numpy(self._last_tok).to(self.model.device)
        logits, self.cache = _decode_step(self.model, self.cache, tok)
        nxt = _sample(logits, self._generator, **self._sample_kw)
        nxt = nxt.cpu().numpy()
        dt = time.perf_counter() - t0
        n_active = int(self._active.sum())
        self.stats["decode_paged" if self.paged
                   else f"decode_{self.bucket}"] += 1
        self.stats["decode_steps"] += 1
        self.stats["slot_steps"] += n_active
        self.stats["step_tokens"] += n_active
        for slot in np.flatnonzero(self._active):
            tok = int(nxt[slot])
            self._tokens[slot].append(tok)
            self._len[slot] += 1
            self._latency[slot].append(dt)
            self._last_tok[slot] = tok
            self._finishes(slot, tok)
