"""Tensor-parallel serving over ``data=2 model=2`` on four gloo ranks:
the cases of ``test_torch_tp_serving.py`` (its docstring) on that mesh,
the contiguous cache's rows split over ``data``, the pool whole over it;
and an odd vocabulary against the port's one-rank engine (ROADMAP
C.13).
"""

import _torch_threads  # noqa: F401  (before any torch op)

import pytest

from test_torch_tp_serving import (
    CASES,
    _same_done,
    hold_bytes,
    hold_splices,
    hold_tokens,
    run_mesh,
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_mesh(tmp_path_factory.mktemp("tp_serve_dp"), "dp2_tp2", [],
                    odd=True)


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_tokens_equal_jax_on_the_same_mesh(runs, case):
    hold_tokens(runs, "dp2_tp2", case)


@pytest.mark.parametrize("case", [c["name"] for c in CASES[2:]])
def test_cache_and_pool_bytes_equal_jax(runs, case):
    hold_bytes(runs, "dp2_tp2", case)


def test_heads_and_rows_split(runs):
    for r in runs["ranks"]:
        assert r["dp2_tp2"]["generate"]["heads"] == 2


def test_handoff_splice_makes_no_collective(runs):
    hold_splices(runs, "dp2_tp2")


def test_odd_vocabulary_serves_as_one_rank(runs):
    for r in runs["ranks"]:
        _same_done(r["odd"]["odd"]["done"], runs["odd_one"], "odd vocab")
