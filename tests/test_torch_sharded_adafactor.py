"""Adafactor over split state on four gloo ranks (the harness:
``_torch_sharded.py``), three steps (the first at the warmup's lr 0)
of ``gpt2_medium_adafactor`` cut to two layers at width 128, so the
matrices keep factored moments:

- ``fsdp``: ``mesh.fsdp=4`` with ``parallel.param_sharding=fsdp``, the
  params and the param-shaped moments split over ``fsdp``;
- ``zero1``: ``mesh.fsdp=4`` with replicated params and
  ``parallel.opt_sharding=zero1``, the param-shaped moments split.

The factored row and column moments are whole on every rank, as the JAX
state keeps them (no param-shaped leaf to take a spec from); the
factored means over d0 and d1 sum over the split axes and gather the
split dims they keep, and the block-RMS clip and the parameter scale sum
each shard's squares over its split axes, so every reduction runs over
the whole JAX leaf. Each case is held against the JAX step on the same
mesh and against the port's one-rank step, to PR 16's sharded-step
tolerance (the harness's ``hold``: loss and grad_norm to rtol 2e-5,
params to rtol 2e-5 / atol 1e-6, the key bias to Adam's bound).
"""

import _torch_threads  # noqa: F401  (before any torch op)

import pytest

from _torch_sharded import GPT, hold, run_cases

FSDP4 = ["mesh.data=1", "mesh.fsdp=4", "mesh.model=1"]
WIDE = GPT + ["model.hidden_dim=128"]
CASES = {
    "fsdp": ("gpt2_medium_adafactor", WIDE + FSDP4 + [
        "parallel.param_sharding=fsdp", "parallel.opt_sharding=like_params",
        "parallel.fsdp_min_size=1024"], True),
    "zero1": ("gpt2_medium_adafactor", WIDE + FSDP4 + [
        "parallel.param_sharding=replicated", "parallel.opt_sharding=zero1",
        "parallel.fsdp_min_size=1024"], True),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("adafactor"), steps=3)


@pytest.mark.parametrize("name", list(CASES))
def test_split_adafactor_matches_jax_step(runs, name):
    run = runs[name]
    hold(run, run["jax"]["metrics"], run["jax"]["params"], f"{name} vs jax")


@pytest.mark.parametrize("name", list(CASES))
def test_split_adafactor_matches_one_rank_step(runs, name):
    run = runs[name]
    hold(run, run["one"]["metrics"], run["one"]["params"],
         f"{name} vs one rank")


@pytest.mark.parametrize("name", list(CASES))
def test_moments_are_split_like_params(runs, name):
    """The param-shaped moments take the optimizer spec's split; the
    factored ones are whole."""
    specs = runs[name]["ranks"][0]["specs"]
    assert any("fsdp" in s for s in specs["opt"].values())
