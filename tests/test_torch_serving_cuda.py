"""The disaggregated engine and the draft tier on the card, held to the
port's own colocated paged engine (which ``test_torch_paged_serving.py``
holds to the JAX package on the CPU): the same seeded tiny GPT serves the
same requests through both, greedy, and must give the same tokens, with
the paged kernels (and, for the draft, the contiguous decode kernel)
launched.

Marked ``cuda`` and skipped without a card. This file imports no JAX, so
it runs on a machine that has none; there, skip the repository conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_serving_cuda.py
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import numpy as np
import pytest
import torch

from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
    GPTConfig,
    ServingConfig,
)
from frl_distributed_ml_scaffold_tpu_torch.models.convert import init_params
from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT
from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as tda
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
from frl_distributed_ml_scaffold_tpu_torch.serving import (
    ServingEngine,
    TenantSpec,
    build_engine,
)

TINY = dict(vocab_size=512, num_layers=2, num_heads=4, hidden_dim=256,
            seq_len=256)


def _model(cfg: dict, policy: str, seed: int):
    g = GPTConfig(**cfg)
    model = GPT(g, get_policy(policy), device="cuda")
    model.load_state_dict(init_params(g, torch.Generator("cuda").manual_seed(
        seed)))
    return model


def _requests(seed: int):
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(0, 512, size=int(rng.integers(3, 9))).astype(
        np.int32), 24, "fg") for _ in range(2)]
    reqs += [(rng.integers(0, 512, size=int(rng.integers(100, 128))).astype(
        np.int32), 1 + i % 3, "bg") for i in range(6)]
    return reqs


def _serve(eng, reqs, tenants: bool):
    for p, n, t in reqs:
        eng.submit(p, n, **({"tenant": t} if tenants else {}))
    return {c.id: c for c in eng.run()}


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["fp32", "bf16_mixed"])
def test_disagg_on_the_card_matches_colocated(policy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = _model(TINY, policy, 0)
    reqs = _requests(1)
    colo = ServingEngine(model, num_slots=4, temperature=0.0,
                         serving=ServingConfig(kv_block_size=16))
    want = _serve(colo, reqs, tenants=False)
    tda.paged_decode_attention.launches = 0
    eng = build_engine(
        model, num_slots=4, temperature=0.0,
        serving=ServingConfig(kv_block_size=16, disaggregate=True),
        tenants=[TenantSpec("fg", "latency"),
                 TenantSpec("bg", "best_effort")],
    )
    got = _serve(eng, reqs, tenants=True)
    assert sorted(got) == sorted(want)
    for rid, c in got.items():
        np.testing.assert_array_equal(c.tokens, want[rid].tokens)
        assert c.ok and c.tenant == reqs[rid][2]
    s = eng.stats
    assert s["handoffs"] == len(reqs) and "handoff_transfer_bytes" not in s
    assert eng.telemetry.snapshot()["serve_handoff_transfer_bytes_total"] == 0
    assert s["prefill_deferred"] > 0
    assert tda.paged_decode_attention.launches == (
        s["decode_paged"] * TINY["num_layers"]) > 0
    assert eng.decode._reserved_future == 0
    # The HBM gauges read the allocator once a decode step.
    snap = eng.telemetry.snapshot()
    gib = torch.cuda.max_memory_allocated() / 2**30
    assert 0 < snap["serve_hbm_in_use_gib"] <= snap["serve_hbm_peak_gib"]
    assert snap["serve_hbm_peak_gib"] <= gib


@pytest.mark.cuda
def test_draft_on_the_card_matches_plain_decode():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model = _model(TINY, "bf16_mixed", 0)
    draft = _model(dict(TINY, num_layers=1, num_heads=2, hidden_dim=128),
                   "fp32", 7)
    reqs = [(p, 24, t) for p, _, t in _requests(2)[:4]]
    plain = ServingEngine(model, num_slots=4, temperature=0.0,
                          serving=ServingConfig(kv_block_size=16))
    want = _serve(plain, reqs, tenants=False)
    tda.decode_attention.launches = 0
    eng = ServingEngine(model, num_slots=4, temperature=0.0,
                        serving=ServingConfig(kv_block_size=16,
                                              speculate="draft",
                                              speculate_k=4),
                        draft_model=draft)
    got = _serve(eng, reqs, tenants=False)
    for rid, c in got.items():
        np.testing.assert_array_equal(c.tokens, want[rid].tokens)
    assert eng.stats["decode_verify"] > 0 and eng.stats["spec_proposed"] > 0
    # The draft's proposals decode through the contiguous kernel.
    assert tda.decode_attention.launches > 0
