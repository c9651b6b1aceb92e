"""The port's ``beam_search`` (frl_distributed_ml_scaffold_tpu_torch/
models/generation.py) against the JAX package's on the same carried-
across tiny GPT (fp32) and the same numpy prompts: ragged left-padded
prompts, ``eos_id`` freezing, ``length_penalty`` with its stable
re-rank; one beam against greedy ``generate``; JAX's three errors.

Tolerances: tokens equal; scores (sums of fp32 log-probabilities over
at most 6 tokens) to 1e-5 absolute, as the port's decode matches JAX's
logits to ~1e-6 (``test_torch_gpt.py``).
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY, build_pair, jax_params

from frl_distributed_ml_scaffold_tpu.models import generation as jgen
from frl_distributed_ml_scaffold_tpu_torch.models import generation as tgen

NEW, BEAMS = 6, 3


@pytest.fixture(scope="module")
def pair():
    params = jax_params()
    jmodel, tmodel = build_pair(params, "fp32")
    return jmodel, params, tmodel


def _prompts(seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, TINY["vocab_size"], (2, 8)).astype(np.int32)


def _both(pair, prompt, **kw):
    jmodel, params, tmodel = pair
    jkw = dict(kw)
    if "prompt_lengths" in jkw:
        jkw["prompt_lengths"] = jnp.asarray(jkw["prompt_lengths"])
    jt, js = jgen.beam_search(jmodel, params, jnp.asarray(prompt), **jkw)
    tt, ts = tgen.beam_search(tmodel, prompt, device="cpu", **kw)
    return (np.asarray(jt), np.asarray(js)), (tt.numpy(), ts.numpy())


def _eos(pair, prompt) -> int:
    """Row 0's greedy first token: a beam finishes at the first step."""
    _, _, tmodel = pair
    return int(tgen.generate(tmodel, prompt, max_new_tokens=1,
                             temperature=0.0, device="cpu")[0, -1])


CASES = {
    "plain": {},
    "ragged": {"prompt_lengths": [5, 8]},
    "eos": {"eos": True},
    "length_penalty": {"length_penalty": 0.7},
    "eos_length_penalty": {"eos": True, "length_penalty": 1.0},
    "ragged_eos": {"eos": True, "prompt_lengths": [3, 8]},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_beam_search_matches_jax(pair, case):
    kw = dict(CASES[case])
    prompt = _prompts()
    if kw.pop("eos", False):
        kw["eos_id"] = _eos(pair, prompt)
    if "prompt_lengths" in kw:
        for row, n in enumerate(kw["prompt_lengths"]):
            prompt[row, :8 - n] = 0  # left padding
    (jt, js), (tt, ts) = _both(pair, prompt, max_new_tokens=NEW,
                               num_beams=BEAMS, **kw)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_allclose(ts, js, atol=1e-5, rtol=0)
    assert tt.shape == (2, 8 + NEW) and tt.dtype == np.int32
    if "eos_id" in kw:
        eos = kw["eos_id"]
        for row in tt[:, 8:]:
            hit = np.flatnonzero(row == eos)
            if hit.size:  # frozen: eos to the end
                assert (row[hit[0]:] == eos).all()


def test_one_beam_is_greedy(pair):
    """W = 1 keeps the argmax at every step: greedy ``generate``, and its
    score is the sum of the chosen tokens' log-probabilities."""
    _, _, tmodel = pair
    prompt = _prompts(1)
    toks, score = tgen.beam_search(tmodel, prompt, max_new_tokens=NEW,
                                   num_beams=1, device="cpu")
    greedy = tgen.generate(tmodel, prompt, max_new_tokens=NEW,
                           temperature=0.0, device="cpu")
    assert torch.equal(toks, greedy)
    with torch.no_grad():
        logits = tmodel(toks[:, :-1].long()).float()
    lp = torch.log_softmax(logits, dim=-1)
    picked = torch.gather(lp[:, 7:], 2, toks[:, 8:, None].long())[..., 0]
    np.testing.assert_allclose(score.numpy(), picked.sum(1).numpy(),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(max_new_tokens=0), dict(max_new_tokens=TINY["seq_len"]),
    dict(max_new_tokens=2, num_beams=0),
    dict(max_new_tokens=2, num_beams=TINY["vocab_size"] + 1)],
    ids=["no_tokens", "past_context", "no_beams", "beams_past_vocab"])
def test_errors_are_jax_errors(pair, kw):
    jmodel, params, tmodel = pair
    prompt = _prompts()
    with pytest.raises(ValueError) as jerr:
        jgen.beam_search(jmodel, params, jnp.asarray(prompt), **kw)
    with pytest.raises(ValueError) as terr:
        tgen.beam_search(tmodel, prompt, device="cpu", **kw)
    assert str(terr.value) == str(jerr.value)


def test_cache_rows_follow_their_beam(pair):
    """``_repeat_cache_rows`` then ``_gather_cache_rows`` move every
    per-row leaf (K/V, ``cache_index``, ``pos_index``) with its beam,
    as the JAX helpers do on the same cache."""
    jmodel, params, tmodel = pair
    prompt = _prompts()
    lens = np.asarray([5, 8], np.int32)
    _, cache = tgen._prefill(tmodel, torch.from_numpy(prompt),
                             torch.from_numpy(lens), cache_len=16)
    rep = tgen._repeat_cache_rows(cache, 3, 2)
    rows = torch.tensor([5, 0, 3, 1, 4, 2])
    got = tgen._gather_cache_rows(rep, rows, 6)
    jcache = {"x": {k: jnp.asarray(v.numpy()) for k, v in cache.items()}}
    jrep = jgen._repeat_cache_rows(jcache, 3, 2)
    want = jgen._gather_cache_rows(jrep, jnp.asarray(rows.numpy()), 6)["x"]
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
