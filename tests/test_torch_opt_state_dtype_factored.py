"""ROADMAP C.11 for ``lion`` and ``adafactor``: the cases of
``test_torch_opt_state_dtype.py`` (its docstring), in a file of their
own so that each file's run stays short.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import pytest

from test_torch_opt_state_dtype import hold_fp32_state


@pytest.mark.parametrize("opt", ["lion", "adafactor"])
def test_bf16_file_keeps_fp32_optimizer_state(tmp_path, opt):
    hold_fp32_state(tmp_path, opt)
