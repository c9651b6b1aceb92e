"""Fault injection and the retry policy: the port of the JAX package's
``faults/`` (``locks.py`` aside).

``plan.py`` holds the mechanism (``FaultPlan`` / ``FaultSpec``, the named
sites); ``retry.py`` the one backoff policy the retrying tiers use. This
package root holds the AMBIENT plan: the tiers consult module-level
hooks (``fire`` / ``maybe_raise`` / ``maybe_hang``), so deep call stacks
(a ``Checkpointer`` inside a ``Trainer``) need no plumbing, and the
unarmed path is one ``None`` check.

Arming:

- in-process (tests): ``with faults.active(plan): ...`` or
  ``faults.install(plan)`` / ``faults.install(None)``;
- across processes: the ``FRL_FAULT_PLAN`` variable (JSON, see
  ``FaultPlan.from_env``), read on the first consultation. The
  launcher's ``main`` also arms it for the length of each call
  (``launcher/launch.py``). Occurrence counters (``at``) are per
  process.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Iterator, Optional

from frl_distributed_ml_scaffold_tpu_torch.faults.plan import (
    KNOWN_SITES,
    FaultPlan,
    FaultSpec,
)
from frl_distributed_ml_scaffold_tpu_torch.faults.retry import RetryPolicy

__all__ = [
    "KNOWN_SITES",
    "FaultPlan",
    "FaultSpec",
    "RetryPolicy",
    "active",
    "current_plan",
    "fire",
    "install",
    "maybe_hang",
    "maybe_raise",
]

_PLAN: Optional[FaultPlan] = None
_ENV_READ = False


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``plan`` as the ambient plan (``None`` disarms); returns
    the previous plan so callers can restore it."""
    global _PLAN, _ENV_READ
    prev = _PLAN
    _PLAN = plan
    # An explicit install (disarm included) overrides the env path for the
    # rest of the process: tests must never inherit a stray env plan.
    _ENV_READ = True
    return prev


@contextlib.contextmanager
def active(plan: FaultPlan) -> Iterator[FaultPlan]:
    """Scoped arming: ``with faults.active(plan): ...``."""
    prev = install(plan)
    try:
        yield plan
    finally:
        install(prev)


def current_plan() -> Optional[FaultPlan]:
    global _ENV_READ, _PLAN
    if not _ENV_READ:
        _ENV_READ = True
        spec = os.environ.get("FRL_FAULT_PLAN")
        if spec:
            _PLAN = FaultPlan.from_env(spec)
    return _PLAN


def fire(site: str, key: Any = "") -> Optional[FaultSpec]:
    """Consult the ambient plan at ``site``; ``None`` when unarmed (the
    path every production step takes)."""
    plan = _PLAN if _ENV_READ else current_plan()
    if plan is None:
        return None
    return plan.fire(site, str(key))


def maybe_raise(site: str, exc: type = RuntimeError, *, key: Any = "",
                msg: str | None = None) -> None:
    """Raise ``exc`` when the site fires (sites whose real failure is an
    exception: loader errors)."""
    spec = fire(site, key)
    if spec is not None:
        raise exc(msg or f"injected fault: {site}"
                  + (f" key={key}" if str(key) else ""))


def maybe_hang(site: str, *, key: Any = "") -> bool:
    """Sleep ``spec.arg`` seconds when the site fires (a hung or slow
    step); returns whether it fired."""
    spec = fire(site, key)
    if spec is None:
        return False
    if spec.arg > 0:
        time.sleep(spec.arg)
    return True
