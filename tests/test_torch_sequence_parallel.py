"""The port's sequence parallelism through the training step on four
gloo ranks (the harness: ``_torch_sharded.py``): ``gpt2_ring`` cut to 2
layers at width 64 and 32 tokens, fp32, in 2 microbatches, against the
JAX step on the same mesh and the port's one-rank step (losses,
grad_norms and params after 2 steps, rtol 2e-5 / atol 1e-6):

- ring attention on ``seq=4`` and on ``seq=2 data=2``;
- ring attention under ``model.lm_loss_chunk`` (the chunks cut each
  rank's 8 tokens);
- Ulysses (``model.attention=ulysses``) on ``seq=4``;
- training dropout (``model.dropout=0.1``) on ``seq=4`` against the
  one-rank step alone (its masks are the port's own): each rank keeps
  its tokens of the whole masks.

Each rank draws its batch index's rows whole (33 tokens) and keeps its
block of the inputs and targets; the ranks along ``seq`` draw the same
rows. The bytes each rank sends over ``seq`` a step: under the recipe's
``trainer.remat=dots`` the port replays the ring's forward, hops
included (rank r of n: ``r+1`` K/V blocks a forward, twice, then ``r+1``
blocks with their dK/dV in the backward, and rank n-1 the others' dK/dV
home), and Ulysses' four exchanges a forward, twice, and four backward.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import pytest

from _torch_sharded import GPT, STEPS, hold, hold_draws, run_cases

SEQ4 = ["mesh.data=1", "mesh.fsdp=1", "mesh.seq=4"]
DP2_SEQ2 = ["mesh.data=2", "mesh.fsdp=1", "mesh.seq=2"]
ULYSSES = ["model.attention=ulysses", "parallel.sequence=ulysses"]
CASES = {
    "ring4": ("gpt2_ring", GPT + SEQ4, True),
    "ring_dp2_seq2": ("gpt2_ring", GPT + DP2_SEQ2, True),
    "ring4_chunk": ("gpt2_ring", GPT + SEQ4 + ["model.lm_loss_chunk=4"],
                    True, 0),  # ring4's params
    "ulysses4": ("gpt2_ring", GPT + SEQ4 + ULYSSES, True, 0),
    # Training dropout: each rank keeps its tokens of the one-rank masks.
    "ring4_dropout": ("gpt2_ring", GPT + SEQ4 + ["model.dropout=0.1"],
                      False, 0),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(CASES, tmp_path_factory.mktemp("sp"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_sequence_parallel_step_matches_jax_and_one_rank(runs, name):
    run = runs[name]
    if CASES[name][2]:
        hold(run, run["jax"]["metrics"], run["jax"]["params"],
             f"{name} vs jax")
    hold(run, run["one"]["metrics"], run["one"]["params"], f"{name} vs one")
    hold_draws(run)
    for r in run["ranks"]:
        for b in r["batches"]:
            assert b["tokens"].shape[1] == 33  # rows drawn whole


def _seq_bytes(name: str, r: int, n: int) -> int:
    """What rank r of n sends over seq in STEPS steps (fp32 K/V blocks of
    a microbatch's rows x 32/n tokens x 4 heads x 16, 2 layers, 2
    microbatches of 8 rows over the data axis)."""
    rows = 8 // (4 // n) // 2
    block = rows * (32 // n) * 4 * 16 * 4
    per = 2 * 2 * STEPS  # layers x microbatches x steps
    if name.startswith("ulysses"):
        return per * 12 * block * (n - 1) // n
    hops = r + 1 if r < n - 1 else 0
    home = n - 1 if r == n - 1 else 0
    kv = 2 * block
    return per * (2 * hops * kv + hops * 2 * kv + home * kv)


@pytest.mark.parametrize("name", ["ring4", "ring_dp2_seq2", "ulysses4"])
def test_sequence_parallel_bytes_replay_the_forward(runs, name):
    n = 4 if name.endswith("4") else 2
    for r in runs[name]["ranks"]:
        got = r["wire_bytes"].get("seq", {})
        want = _seq_bytes(name, r["coords"]["seq"], n)
        assert got == ({"float32": want} if want else {}), (r["coords"], got)
