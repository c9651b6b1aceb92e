"""The port's sanitizer (``utils/debugging.py``), specified by its own
test (the JAX flags have no PyTorch counterpart to compare with):

- ``sanitize("nans")`` traps a NaN at the operator that makes it, forward
  and backward, naming it (``FloatingPointError``); ``infs`` the same for
  Inf; a NaN under ``infs`` alone, or outside the scope, passes;
- the state (``active_checks``) is restored on exit and on error;
- an unknown name raises ``KeyError``; ``leaks`` raises ``ValueError``
  (the port traces nothing);
- ``FRL_TPU_SANITIZE``: ``1`` / ``all`` turn on nans and infs, a comma
  list selects, a typo or ``leaks`` warns and is skipped, ``0`` /
  ``false`` / empty mean off;
- ``mnist_mlp`` through ``launch.main`` on the CPU under
  ``FRL_TPU_SANITIZE=nans,infs`` gives losses bit-equal to the run
  without it, and the launcher turns the checks off when it returns.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import json
import logging

import pytest
import torch

from frl_distributed_ml_scaffold_tpu_torch.launcher import launch
from frl_distributed_ml_scaffold_tpu_torch.utils import debugging
from frl_distributed_ml_scaffold_tpu_torch.utils.logging import get_logger


def test_trap_names_the_op_forward_and_backward():
    x = torch.zeros(4)
    with debugging.sanitize("nans"):
        with pytest.raises(FloatingPointError, match=r"NaN .*aten\.div\.Tensor"):
            x / x  # 0/0
        # An Inf is not a NaN: passes under nans alone.
        assert torch.isinf(torch.ones(2) / 0).all()
    with debugging.sanitize("infs"):
        with pytest.raises(FloatingPointError, match=r"Inf .*aten\.div\.Tensor"):
            torch.ones(2) / 0
    z = torch.zeros(3, requires_grad=True)
    with debugging.sanitize():
        loss = z.sqrt().sum()  # sqrt(0) = 0: the forward is clean
        # d sqrt(z) / dz = 1 / (2 sqrt(z)): Inf in the backward's div.
        with pytest.raises(FloatingPointError, match=r"Inf .*aten\.div"):
            loss.backward()
    # Outside the scope nothing is checked.
    assert torch.isnan(x / x).all()


def test_state_is_restored_on_exit_and_on_error():
    assert debugging.active_checks() == frozenset()
    with debugging.sanitize("nans"):
        assert debugging.active_checks() == {"nans"}
        with debugging.sanitize("infs"):
            assert debugging.active_checks() == {"nans", "infs"}
        assert debugging.active_checks() == {"nans"}
    assert debugging.active_checks() == frozenset()
    with pytest.raises(RuntimeError, match="boom"):
        with debugging.sanitize():
            assert debugging.active_checks() == {"nans", "infs"}
            raise RuntimeError("boom")
    assert debugging.active_checks() == frozenset()
    with pytest.raises(FloatingPointError):
        with debugging.sanitize("nans"):
            torch.zeros(1) / torch.zeros(1)
    assert debugging.active_checks() == frozenset()


def test_unknown_and_unported_names():
    with pytest.raises(KeyError):
        with debugging.sanitize("racez"):
            pass
    with pytest.raises(ValueError, match="traces nothing"):
        with debugging.sanitize("leaks"):
            pass
    assert debugging.active_checks() == frozenset()


@pytest.fixture
def port_log():
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = get_logger()
    logger.addHandler(handler)
    try:
        yield records
    finally:
        logger.removeHandler(handler)
        debugging.reset_process_sanitizers()


@pytest.mark.parametrize("value,want,warned", [
    ("1", {"nans", "infs"}, []),
    ("all", {"nans", "infs"}, []),
    ("TRUE", {"nans", "infs"}, []),
    ("nans", {"nans"}, []),
    (" infs , nans ", {"nans", "infs"}, []),
    ("nans,racez", {"nans"}, ["racez"]),
    ("leaks,infs", {"infs"}, ["leaks"]),
    ("leaks", set(), ["leaks"]),
    ("0", set(), []),
    ("false", set(), []),
    ("", set(), []),
])
def test_env_parsing(monkeypatch, port_log, value, want, warned):
    monkeypatch.setenv("FRL_TPU_SANITIZE", value)
    assert debugging.sanitize_from_env() == bool(want)
    assert debugging.active_checks() == want
    warnings = [r.getMessage() for r in port_log
                if r.levelno == logging.WARNING]
    assert len(warnings) == len(warned)
    for name, msg in zip(warned, warnings):
        assert repr(name) in msg and "skipped" in msg
    debugging.reset_process_sanitizers()
    assert debugging.active_checks() == frozenset()


def test_mnist_under_the_variable_is_bit_equal(tmp_path, monkeypatch):
    args = ["--config=mnist_mlp", "--device=cpu", "model.hidden_sizes=32",
            "data.global_batch_size=16", "trainer.eval_every=0",
            "trainer.total_steps=12", "trainer.log_every=1"]
    checked = []
    bad = debugging._SanitizeMode._bad
    monkeypatch.setattr(debugging._SanitizeMode, "_bad",
                        lambda self, t: checked.append(1) or bad(self, t))
    losses, checks = {}, {}
    for value in ("", "nans,infs"):
        monkeypatch.setenv("FRL_TPU_SANITIZE", value)
        work = tmp_path / (value or "off")
        checked.clear()
        assert launch.main(args + [f"workdir={work}"]) == 0
        checks[value] = len(checked)
        assert debugging.active_checks() == frozenset()
        with open(work / "mnist_mlp" / "metrics.jsonl") as fh:
            losses[value] = [json.loads(line)["loss"] for line in fh]
    # Every step's forward, backward and update went through the checks.
    assert checks[""] == 0 and checks["nans,infs"] > 12 * 20
    assert len(losses[""]) == 12
    assert losses["nans,infs"] == losses[""]
