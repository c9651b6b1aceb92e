"""The disaggregated engine's separate prefill partition on the CPU: the
prefill worker holds its own params replica on ``prefill_env`` (a
``torch.device``; the JAX tests' one-device submesh), and the handoff
moves only the private blocks' window to the decode side, counted; a
prefix hit first moves the seed's occupied prefix out. Held against the
JAX engine with a one-device prefill submesh on the same workload (fp32,
the tiny GPT of ``_torch_parity``):

- the handoff moves only blocks: every completion equals its own
  ``generate()``, every request hands off once, the bytes moved are
  counted in ``stats["handoff_transfer_bytes"]`` and the
  ``serve_handoff_transfer_bytes_total`` counter alike, and are fewer
  than the pool's;
- the transfer is windowed: a 19-token prompt with no prefix hit moves
  its 3-block window back (not its 32-token bucket), and an 18-token
  prompt sharing a 2-block prefix moves the 2-block seed out and one
  private block back: the analytic window bytes, and the JAX engine's
  count, exactly;
- a ``MeshEnv`` partition (here over the decode side's own one rank)
  holds a whole replica moved by the redistribution service
  (``replica_plan``) and serves the same tokens, its transfers counted
  as the JAX engine counts them; a partition made of other ranks is
  ``tests/test_torch_redistribute_ranks.py``'s.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import jax
import numpy as np
import pytest
import torch

from _torch_parity import TINY, build_pair, jax_params
from frl_distributed_ml_scaffold_tpu.config.schema import (
    MeshConfig as JaxMeshConfig,
)
from frl_distributed_ml_scaffold_tpu.dist.mesh import build_mesh as jbuild
from frl_distributed_ml_scaffold_tpu.serving import (
    DisaggServingEngine as JaxDisagg,
)
from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
    MeshConfig,
    ServingConfig,
)
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import build_mesh
from frl_distributed_ml_scaffold_tpu_torch.models.generation import generate
from frl_distributed_ml_scaffold_tpu_torch.serving import (
    DisaggServingEngine,
    build_engine,
)

V = TINY["vocab_size"]
BS = 8


@pytest.fixture(scope="module")
def pair():
    params = jax_params()
    jm, tm = build_pair(params, "fp32")
    return jm, params, tm


def _engine(tm):
    return build_engine(
        tm, serving=ServingConfig(kv_block_size=BS, disaggregate=True),
        num_slots=2, temperature=0.0, prefill_env=torch.device("cpu"),
        device="cpu")


def _jax_engine(jm, params):
    penv = jbuild(JaxMeshConfig(data=1), devices=[jax.devices()[1]])
    return JaxDisagg(jm, params, num_slots=2, temperature=0.0,
                     kv_block_size=BS, prefill_env=penv)


def _window_bytes(tok: int) -> int:
    """K/V fp32 of ``tok`` positions plus the cursors, per transfer."""
    d, layers = TINY["hidden_dim"], TINY["num_layers"]
    return layers * 2 * tok * d * 4 + layers * 4 + 4


def _solo(tm, prompt, new):
    return generate(tm, prompt[None], max_new_tokens=new, temperature=0.0,
                    device="cpu").numpy()[0]


def test_handoff_moves_only_blocks(pair):
    jm, params, tm = pair
    rng = np.random.default_rng(53)
    reqs = [(rng.integers(0, V, int(rng.integers(2, 10))).astype(np.int32),
             int(rng.integers(2, 7))) for _ in range(4)]
    eng = _engine(tm)
    assert eng.prefill_worker.separate
    assert eng.prefill_worker.model is not eng.decode.model  # a replica
    jeng = _jax_engine(jm, params)
    for p, n in reqs:
        eng.submit(p, n)
        jeng.submit(p, n)
    done = {c.id: c for c in eng.run()}
    jeng.run()
    for rid, (p, n) in enumerate(reqs):
        np.testing.assert_array_equal(done[rid].tokens, _solo(tm, p, n))
    assert eng.stats["handoffs"] == len(done)
    moved = eng.stats["handoff_transfer_bytes"]
    assert moved > 0
    assert (eng.telemetry.counter("serve_handoff_transfer_bytes_total").value
            == moved)
    assert moved == jeng.stats["handoff_transfer_bytes"]
    pool = sum(t.numel() * t.element_size()
               for t in eng.decode.cache.values())
    assert moved < pool
    jeng.close()


def test_prefix_transfer_is_windowed(pair):
    jm, params, tm = pair
    eng, jeng = _engine(tm), _jax_engine(jm, params)
    pre = np.arange(2 * BS, dtype=np.int32) % V
    p1 = np.concatenate([pre, np.asarray([7, 9, 1], np.int32)])  # 19 tok
    p2 = np.concatenate([pre, np.asarray([11, 3], np.int32)])  # 18 tok
    moved = []
    for p in (p1, p2):
        rid = eng.submit(p, 4)
        jeng.submit(p, 4)
        done = {c.id: c for c in eng.run()}
        jeng.run()
        np.testing.assert_array_equal(done[rid].tokens, _solo(tm, p, 4))
        moved.append((eng.stats["handoff_transfer_bytes"],
                      jeng.stats["handoff_transfer_bytes"]))
    # No hit: the 3-block window (24 positions) back, not the 32 bucket.
    assert moved[0] == (_window_bytes(3 * BS),) * 2
    assert done[rid].prefix_cache_hit
    # Hit: the 2-block seed out, one private block back.
    second = moved[1][0] - moved[0][0]
    assert second == _window_bytes(2 * BS) + _window_bytes(BS)
    assert moved[1][1] - moved[0][1] == second
    jeng.close()


def test_partition_of_other_ranks_raises(pair):
    """A ``MeshEnv`` partition serves (ROADMAP A13c's last seam, lifted):
    the workload of ``test_prefix_transfer_is_windowed`` through a
    partition over this process's one rank, against the JAX engine."""
    jm, params, tm = pair
    eng = DisaggServingEngine(
        tm, serving=ServingConfig(kv_block_size=BS, disaggregate=True),
        num_slots=2, temperature=0.0,
        prefill_env=build_mesh(MeshConfig(data=1), 1), device="cpu")
    pw = eng.prefill_worker
    assert pw.separate and not pw.remote and pw.model is not tm
    assert pw.replica_plan.bytes_moved == 0  # one rank: nothing moves
    assert {l.kind for l in pw.replica_plan.leaves} == {"identity"}
    jeng = _jax_engine(jm, params)
    pre = np.arange(2 * BS, dtype=np.int32) % V
    for p in (np.concatenate([pre, np.asarray([7, 9, 1], np.int32)]),
              np.concatenate([pre, np.asarray([11, 3], np.int32)])):
        rid = eng.submit(p, 4)
        jeng.submit(p, 4)
        done = {c.id: c for c in eng.run()}
        jeng.run()
        np.testing.assert_array_equal(done[rid].tokens, _solo(tm, p, 4))
    assert done[rid].prefix_cache_hit
    assert (eng.stats["handoff_transfer_bytes"]
            == jeng.stats["handoff_transfer_bytes"]
            == _window_bytes(3 * BS) + _window_bytes(2 * BS)
            + _window_bytes(BS))
    jeng.close()
