"""Host-side continuous-batching decode engine over a fixed slot array.

The port of the JAX package's ``serving/engine.py`` for the bucketed
contiguous cache:

- **Slots**: the decode batch is a fixed ``[num_slots]`` row array; each
  row is an independent request with its own cache index and positions,
  so rows at different occupancies decode together in one step.
- **Continuous batching**: a row that emits eos or exhausts its budget
  retires (its completion is returned, the slot freed) and the next
  queued request is prefilled alone, at its own prompt bucket, and its
  cache rows are grafted into the freed row while the others keep
  decoding. Retired rows ride the decode step until refilled; their
  writes past the bucket are dropped (models/gpt.py).
- **Cache buckets**: the engine cache starts at the smallest power-of-two
  bucket covering the live requests and grows bucket by bucket (a pad
  along the capacity axis) only when an active row needs the room; the
  decode kernel reads only each row's occupied prefix within it.

Waiting for later slices (ROADMAP queue A): the paged pool and prefix
cache, speculation, disaggregation and the SLO scheduler, telemetry and
tracing, the fault sites with the admission quarantine, deadlines and
load shedding, mesh sharding. An exception during admission propagates.
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
    _decode_step,
    _prefill,
    _sample,
    cache_batch_axis,
    cache_capacity_axis,
    next_cache_bucket,
)


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
    token. ``finish_reason`` is ``"eos"`` or ``"length"``."""

    id: int
    tokens: np.ndarray  # [prompt_len + n_generated]
    prompt_len: int
    finish_reason: str
    token_latencies_s: list[float]
    ttft_s: float = 0.0


def _check_serving(serving: ServingConfig) -> None:
    """Refuse the serving knobs this slice does not port yet."""
    todo = {
        "kv_block_size": (
            serving.kv_block_size, 0, "queue A item 2, paged pool"
        ),
        "speculate": (serving.speculate, "off", "queue A item 2, speculation"),
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


def prefill_request(model, req: ServeRequest, *, bucket, sample_kw, generator):
    """Admission prefill: left-pad the prompt into its bucket ``bucket``,
    prefill a one-row cache of that capacity and sample the first token.
    Returns ``(tok [1], slot_cache)``."""
    l = int(req.prompt.size)
    prompt = np.zeros((1, bucket), np.int32)
    prompt[0, bucket - l:] = req.prompt  # left-pad
    dev = model.device
    logits, slot_cache = _prefill(
        model,
        torch.from_numpy(prompt).to(dev),
        torch.tensor([l], dtype=torch.int32, device=dev),
        cache_len=bucket,
    )
    return _sample(logits, generator, **sample_kw), slot_cache


class ServingEngine:
    """Continuous-batching engine; see the module docstring.

    Usage::

        eng = ServingEngine(model, num_slots=4, eos_id=50256)
        eng.submit([5, 3, 8], max_new_tokens=32)
        done = eng.run()          # or step() for one decode iteration

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
        if serving is not None:
            _check_serving(serving)
        self.model = model
        self.num_slots = int(num_slots)
        self.eos_id = eos_id
        self._sample_kw = dict(
            temperature=temperature, top_k=top_k, top_p=top_p
        )
        self._generator = generator
        self.seq_len = model.config.seq_len

        self._queue: collections.deque[ServeRequest] = collections.deque()
        self._completed: list[Completion] = []
        self._next_id = 0
        self._issued_ids: set[int] = set()
        n = self.num_slots
        self._req: list[ServeRequest | None] = [None] * n
        self._tokens: list[list[int]] = [[] for _ in range(n)]
        self._len = np.zeros(n, np.int64)  # prompt + generated
        self._active = np.zeros(n, bool)
        self._latency: list[list[float]] = [[] for _ in range(n)]
        self._last_tok = np.zeros(n, np.int32)
        self.cache: dict | None = None
        self.bucket = 0
        # How often each shape class ran (prefill_<bucket>,
        # decode_<bucket>, grow_<a>-><b>, ...).
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

    # --------------------------------------------------------- scheduling

    def _bucket_for(self, needed: int) -> int:
        return next_cache_bucket(self.seq_len, needed)

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
            grown[name] = F.pad(e, pad)
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
            dst.copy_(p)

    def _admit(self) -> None:
        for slot in range(self.num_slots):
            if self._active[slot]:
                continue
            if not self._queue:
                return
            self._admit_into(slot, self._queue.popleft())

    def _admit_into(self, slot: int, req: ServeRequest) -> None:
        """Prefill + graft ``req`` into ``slot``."""
        l = int(req.prompt.size)
        t0 = time.perf_counter()
        s_p = self._bucket_for(l)
        tok, slot_cache = prefill_request(
            self.model, req, bucket=s_p, sample_kw=self._sample_kw,
            generator=self._generator,
        )
        if self.cache is None:
            self.cache = self.model.init_cache(self.num_slots, s_p)
            self.bucket = s_p
        self._ensure_bucket(max(s_p, l + 1))
        self._graft(slot_cache, slot, s_p)
        tok = int(tok[0])
        dt = time.perf_counter() - t0
        self.stats[f"prefill_{s_p}"] += 1
        self.stats["admitted"] += 1
        self._req[slot] = req
        self._tokens[slot] = [tok]
        self._len[slot] = l + 1
        self._active[slot] = True
        self._latency[slot] = [dt]
        self._last_tok[slot] = tok
        # The first sampled token can already finish the request.
        self._finishes(slot, tok)

    def _finishes(self, slot: int, tok: int) -> None:
        """Retire ``slot`` if ``tok`` ends its request."""
        if self.eos_id is not None and tok == self.eos_id:
            self._retire(slot, "eos")
        elif len(self._tokens[slot]) >= self._req[slot].max_new_tokens:
            self._retire(slot, "length")

    def _retire(self, slot: int, reason: str) -> None:
        req = self._req[slot]
        lat = self._latency[slot]
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
            )
        )
        self._req[slot] = None
        self._active[slot] = False
        self.stats["completed"] += 1
        self.stats[f"finish_{reason}"] += 1

    # --------------------------------------------------------------- step

    def step(self) -> list[Completion]:
        """Admit into free slots, run ONE decode iteration over the slot
        array, retire finished rows. Returns the requests completed
        during this step (possibly at admission, for 1-token budgets)."""
        self._admit()
        if self._active.any():
            # The bucket must hold every active row's next write position
            # (_len - 1), so it needs capacity _len.
            self._ensure_bucket(int(self._len[self._active].max()))
            t0 = time.perf_counter()
            tok = torch.from_numpy(self._last_tok).to(self.model.device)
            logits, self.cache = _decode_step(self.model, self.cache, tok)
            nxt = _sample(logits, self._generator, **self._sample_kw)
            nxt = nxt.cpu().numpy()
            dt = time.perf_counter() - t0
            self.stats[f"decode_{self.bucket}"] += 1
            self.stats["decode_steps"] += 1
            for slot in np.flatnonzero(self._active):
                tok = int(nxt[slot])
                self._tokens[slot].append(tok)
                self._len[slot] += 1
                self._latency[slot].append(dt)
                self._last_tok[slot] = tok
                self._finishes(slot, tok)
        out, self._completed = self._completed, []
        return out
