"""Deterministic fault injection: the ``FaultPlan`` registry, the port
of the JAX package's ``faults/plan.py``.

- **Sites, not callbacks.** Every injectable failure is a named site
  (``KNOWN_SITES``, the JAX package's names); a tier consults its site
  with a cheap host-side hook (``faults.fire(site)``: a dict lookup and a
  ``None`` check when unarmed). Unknown site names are refused when a
  plan is built, so a misspelt spec fails loudly instead of injecting
  nothing.
- **Deterministic.** A spec fires on the ``at``-th matching consultation
  (1-based) for ``times`` consecutive consultations (``times=0``: every
  one from ``at`` on); ``p < 1`` draws from a ``random.Random(seed)``
  the plan owns. Wall clock never takes part.
- **Counted.** Every injection increments ``fault_injected_total`` and a
  per-site counter on the plan's registry (when given) and the plan's
  own ``injected`` tally.

The ambient plan lives in ``faults/__init__.py``; this module is the
mechanism. The port's training loop, data pipeline and checkpointer
consult ``trainer.*``, ``data.loader`` and ``checkpoint.torn_write``;
the serving engine and the disaggregated scheduler the ``serve.*``
sites; the elastic supervisor's membership heartbeat
``elastic.heartbeat_write`` (``launcher/elastic.py``).
"""

from __future__ import annotations

import dataclasses
import json
import random
import threading
from typing import Any, Iterable, Optional

#: The injectable sites, the JAX package's names (one per failure class).
KNOWN_SITES = frozenset(
    {
        # checkpoint/manager.py: save completes on disk but the write is
        # torn (a file truncated, no commit marker): the crash-mid-write
        # shape restore must skip.
        "checkpoint.torn_write",
        # data/pipeline.py: the host-side batch build raises (decode
        # error, bad shard, transient FS): retried under faults/retry.py.
        "data.loader",
        # trainer/loop.py: one step's host loop hangs for ``arg`` seconds
        # (a wedged collective or data loader): the stall watchdog's prey.
        "trainer.hung_step",
        # trainer/loop.py: deliver SIGTERM to ourselves (a preemption):
        # drives the checkpoint-and-exit-clean path.
        "trainer.preempt",
        # The elastic supervisor's child: hard os._exit after a step (the
        # SIGKILL equivalent), driving the supervisor's restart path.
        "child.hard_exit",
        # The serving engine: a request's prefill raises (a poison
        # request).
        "serve.prefill",
        # The serving engine: growing the KV cache to the next bucket
        # fails (allocation failure at high occupancy).
        "serve.grow",
        # The serving engine: the speculative draft proposer raises
        # mid-decode; the slot degrades to plain single-token decode for
        # the rest of its request.
        "serve.draft",
        # The disaggregated scheduler: the prefill worker dies
        # mid-request; the request is re-queued and retried (bounded by
        # serving.handoff_retries).
        "serve.prefill_worker",
        # The disaggregated scheduler: the prefill-to-decode handoff
        # fails; the same recovery as a prefill-worker death.
        "serve.handoff",
        # The elastic supervisor: a membership heartbeat write raises
        # OSError (a shared-FS outage).
        "elastic.heartbeat_write",
    }
)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed injection: fire at the ``at``-th matching consultation.

    ``key`` narrows matching to consultations carrying the same key (the
    sites define what a key is — the serving engine passes the request
    id, the data pipeline the step); ``""`` matches every consultation.
    ``arg`` is the site-specific payload (hang seconds for
    ``trainer.hung_step``; unused elsewhere).
    """

    site: str
    at: int = 1
    times: int = 1  # 0 = every consultation from ``at`` on
    p: float = 1.0
    arg: float = 0.0
    key: str = ""

    def __post_init__(self):
        if self.site not in KNOWN_SITES:
            raise ValueError(
                f"unknown fault site {self.site!r} (known: "
                f"{sorted(KNOWN_SITES)}) — a typo'd chaos spec would "
                "otherwise silently inject nothing"
            )
        if self.at < 1:
            raise ValueError(f"fault {self.site}: at={self.at} < 1 (1-based)")
        if self.times < 0:
            raise ValueError(f"fault {self.site}: times={self.times} < 0")
        if not 0.0 < self.p <= 1.0:
            raise ValueError(f"fault {self.site}: p={self.p} outside (0, 1]")


def _counter_name(site: str) -> str:
    return f"fault_injected_{site.replace('.', '_')}_total"


class FaultPlan:
    """A seeded set of ``FaultSpec``s consulted via ``fire``.

    Thread-safe (the engine's watchdog thread, the prefetch worker, and
    the elastic heartbeat thread all consult concurrently); cheap when a
    site has no specs (one lock-free dict lookup).
    """

    def __init__(
        self,
        specs: Iterable[FaultSpec | dict],
        *,
        seed: int = 0,
        registry: Any | None = None,
    ):
        parsed = [
            s if isinstance(s, FaultSpec) else FaultSpec(**s) for s in specs
        ]
        self._by_site: dict[str, list[FaultSpec]] = {}
        for s in parsed:
            self._by_site.setdefault(s.site, []).append(s)
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        # Per-spec count of MATCHING consultations (the occurrence index
        # ``at`` indexes into) — keyed by spec identity, not site, so two
        # specs on one site count independently.
        self._matches: dict[int, int] = {}
        #: site -> injections fired (the plan's own ledger; always kept,
        #: registry or not, so chaos tests can assert without telemetry).
        self.injected: dict[str, int] = {}
        self._registry = registry
        self._m_total = (
            registry.counter(
                "fault_injected_total",
                help="fault-plan injections fired, all sites",
            )
            if registry is not None
            else None
        )
        self._m_site: dict[str, Any] = {}
        if registry is not None:
            # Register every armed site's counter up front: the catalog
            # contract (a site that never fired scrapes as 0 — itself a
            # signal that the drill did not reach it).
            for site in self._by_site:
                self._m_site[site] = registry.counter(
                    _counter_name(site),
                    help=f"injections fired at fault site {site}",
                )

    @classmethod
    def from_env(
        cls, value: str, *, registry: Any | None = None
    ) -> "FaultPlan":
        """Parse the ``FRL_FAULT_PLAN`` JSON: either a list of spec
        objects or ``{"seed": ..., "specs": [...]}``."""
        try:
            data = json.loads(value)
        except ValueError as e:
            raise ValueError(
                f"FRL_FAULT_PLAN is not valid JSON ({e}): {value!r}"
            ) from None
        if isinstance(data, dict):
            seed = int(data.get("seed", 0))
            specs = data.get("specs", [])
        else:
            seed, specs = 0, data
        if not isinstance(specs, list):
            raise ValueError(
                f"FRL_FAULT_PLAN specs must be a list, got {type(specs).__name__}"
            )
        return cls(specs, seed=seed, registry=registry)

    @property
    def sites(self) -> list[str]:
        return sorted(self._by_site)

    def fire(self, site: str, key: str = "") -> Optional[FaultSpec]:
        """Consult ``site``; returns the firing spec (the caller applies
        its effect) or ``None``. The no-spec path is one dict lookup."""
        specs = self._by_site.get(site)
        if not specs:
            return None
        with self._lock:
            # EVERY matching spec observes this consultation (the
            # independent-counting contract above) — an early return
            # would make a stacked plan's later windows fire late.
            fired: Optional[FaultSpec] = None
            for spec in specs:
                if spec.key and spec.key != str(key):
                    continue
                sid = id(spec)
                n = self._matches.get(sid, 0) + 1
                self._matches[sid] = n
                if n < spec.at:
                    continue
                if spec.times and n >= spec.at + spec.times:
                    continue
                if spec.p < 1.0 and self._rng.random() >= spec.p:
                    continue
                if fired is None:
                    fired = spec
            if fired is None:
                return None
            self.injected[site] = self.injected.get(site, 0) + 1
            if self._m_total is not None:
                self._m_total.inc()
                self._m_site[site].inc()
            return fired
