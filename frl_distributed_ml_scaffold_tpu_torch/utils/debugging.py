"""Runtime sanitizers: the port of the JAX package's ``utils/debugging.py``
(``sanitize``, ``sanitize_from_env``), specified by its own test.

- ``nans`` / ``infs``: a ``TorchDispatchMode`` looks at every floating
  output of every operator the dispatcher runs, forward and backward (the
  autograd engine carries the mode into its threads), and raises
  ``FloatingPointError`` naming the operator that produced the first NaN
  or Inf, the counterpart of ``jax_debug_nans`` / ``jax_debug_infs``. Two
  kinds of operator are not looked at: the ``empty`` family, whose
  outputs are uninitialised memory, and views, which compute nothing.
  The port's hand-written kernels launch through ``ctypes``
  (``ops/_build.py``): the dispatcher sees only the ``empty`` that
  allocates their output, so a NaN a kernel writes is trapped at the
  first operator that reads it. Every check reads its result back to
  the host: a debug mode, slow on the card.
- ``leaks`` (``jax_check_tracer_leaks``) has no counterpart: the port
  traces nothing, so no tracer can escape. ``sanitize("leaks")`` raises
  ``ValueError``; ``sanitize_from_env`` warns and skips it.
- The JAX package's ``strict_donation`` has no counterpart either: torch
  has no buffer donation to escalate.

Usage: ``with sanitize():`` (nans and infs) around a suspect run, or
``sanitize_from_env()`` at process start honouring
``FRL_TPU_SANITIZE=nans,infs`` (the launcher calls it after the process
group is up, and ``reset_process_sanitizers`` when it returns).
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)

from frl_distributed_ml_scaffold_tpu_torch.utils.logging import get_logger

#: The checks the port has.
CHECKS = ("nans", "infs")
#: The JAX package's names without a counterpart here, and why.
UNPORTED = {
    "leaks": "the port traces nothing (no jit, no tracers), so there is "
             "no tracer to leak; jax_check_tracer_leaks has no "
             "counterpart",
}
_SKIP = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                   "new_empty_strided", "empty_permuted"})


class _SanitizeMode(TorchDispatchMode):
    """Checks every floating output of every operator against NaN and /
    or Inf; raises ``FloatingPointError`` naming the operator."""

    def __init__(self, checks: frozenset[str]):
        super().__init__()
        self.checks = checks

    def _bad(self, t: torch.Tensor) -> str | None:
        if "nans" in self.checks and bool(torch.isnan(t).any()):
            return "NaN"
        if "infs" in self.checks and bool(torch.isinf(t).any()):
            return "Inf"
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket.__name__ in _SKIP:
            return out
        for t in _pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.numel() and t.device.type != "meta"):
                bad = self._bad(t)
                if bad is not None:
                    raise FloatingPointError(
                        f"sanitize: {bad} in the output of {func} "
                        f"(shape {tuple(t.shape)}, {t.dtype}, {t.device})")
        return out


def _check_names(names) -> frozenset[str]:
    for name in names:
        if name in UNPORTED:
            raise ValueError(f"sanitize({name!r}): {UNPORTED[name]}")
        if name not in CHECKS:
            raise KeyError(name)  # a typo'd sanitizer name: surface it
    return frozenset(names)


def active_checks() -> frozenset[str]:
    """The checks on in this thread (the union of the active scopes)."""
    return frozenset().union(*(m.checks for m in
                               _get_current_dispatch_mode_stack()
                               if isinstance(m, _SanitizeMode)))


@contextlib.contextmanager
def sanitize(*checks: str) -> Iterator[None]:
    """Turn the sanitizers on for the scope; default all of them
    (``nans``, ``infs``). An unknown name raises ``KeyError``,
    ``leaks`` raises ``ValueError``. The previous state is back on exit,
    on error too."""
    with _SanitizeMode(_check_names(checks or CHECKS)):
        yield


_PROCESS_MODES: list[_SanitizeMode] = []


def sanitize_from_env(var: str = "FRL_TPU_SANITIZE") -> bool:
    """Turn sanitizers on from the environment, with no scope: on until
    ``reset_process_sanitizers``. ``=1``, ``=true`` or ``=all`` turn on
    every check; ``=nans,infs`` selects. An unknown name, or ``leaks``,
    warns and is skipped (a typo must not kill a multi-host launch).
    ``0``, ``false`` or empty mean off. Returns whether anything was
    turned on."""
    val = os.environ.get(var, "").strip().lower()
    if not val or val in ("0", "false"):
        return False
    names = CHECKS if val in ("1", "true", "all") else tuple(
        n.strip() for n in val.split(",") if n.strip())
    enabled = []
    for name in names:
        if name in UNPORTED:
            get_logger().warning("%s: sanitizer %r skipped: %s", var, name,
                                 UNPORTED[name])
        elif name not in CHECKS:
            get_logger().warning("%s: unknown sanitizer %r (valid: %s) — "
                                 "skipped", var, name, ", ".join(CHECKS))
        elif name not in enabled:
            enabled.append(name)
    if not enabled:
        return False
    mode = _SanitizeMode(frozenset(enabled))
    mode.__enter__()
    _PROCESS_MODES.append(mode)
    get_logger().info("sanitizers enabled: %s", ", ".join(enabled))
    return True


def reset_process_sanitizers() -> None:
    """Turn off what ``sanitize_from_env`` turned on, newest first."""
    while _PROCESS_MODES:
        _PROCESS_MODES.pop().__exit__(None, None, None)
