"""The port's sequence-parallel attention (``ops/ring_attention.py``
``ring_attention``, ``ops/ulysses.py`` ``ulysses_attention``) on four
gloo ranks (``_torch_ranks.py`` ``seq_attention``) against JAX
``ring_attention`` / ``ulysses_attention`` on the same mesh (4 of the 8
simulated devices) and against dense attention on the whole problem, in
fp32:

- ``seq=4``: ring and Ulysses, causal and not, each rank's block of the
  output and of dQ, dK and dV (the backward of ``sum(o * do)``) to
  2e-5;
- ``seq=2, model=2``: each rank its tokens and its heads; Ulysses and
  the ring;
- the bytes each rank sends over ``seq``, counted at the send: the
  causal ring's blocks go only to the ranks after their own (rank r
  sends ``r+1`` K/V blocks forward and again with their fp32 dK/dV
  backward, rank n-1 sends the others' dK/dV home), the full ring ``n``
  hops of each, Ulysses ``(n-1)/n`` of each of its eight exchanges;
- Ulysses' head-divisibility message, word for word the reference's,
  counting the heads left after the ``model`` split.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_ranks import start_ranks
from frl_distributed_ml_scaffold_tpu.config.schema import MeshConfig
from frl_distributed_ml_scaffold_tpu.dist.mesh import build_mesh as jbuild
from frl_distributed_ml_scaffold_tpu.dist.mesh import set_current_mesh
from frl_distributed_ml_scaffold_tpu.ops.ring_attention import (
    dense_attention as jdense,
)
from frl_distributed_ml_scaffold_tpu.ops.ring_attention import (
    ring_attention as jring,
)
from frl_distributed_ml_scaffold_tpu.ops.ulysses import (
    ulysses_attention as julysses,
)

TOL = 2e-5
B, T, H, D = 2, 64, 4, 32
MESHES = {"seq4": {"data": 1, "seq": 4},
          "seq2_model2": {"data": 1, "seq": 2, "model": 2}}


def _problem(seed: int, h: int = H):
    rng = np.random.default_rng(seed)
    return {x: rng.standard_normal((B, T, h, D)).astype(np.float32)
            for x in ("q", "k", "v", "do")}


CASES = {
    "seq4": [dict(name=f"{op}_{'causal' if c else 'full'}", op=op, causal=c,
                  **_problem(i)) for i, (op, c) in enumerate(
        [("ring", True), ("ring", False), ("ulysses", True),
         ("ulysses", False)])],
    "seq2_model2": [
        dict(name="ulysses_causal", op="ulysses", causal=True,
             **_problem(7)),
        dict(name="ring_causal", op="ring", causal=True, **_problem(8)),
        # 2 heads, 1 a rank after the model split: not over seq=2.
        dict(name="ulysses_heads", op="ulysses", causal=True,
             **_problem(9, h=2)),
    ],
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("seqattn")
    jobs = [{"name": name, "kind": "seq_attention",
             "args": {"mesh": MESHES[name], "cases": CASES[name]}}
            for name in MESHES]
    return start_ranks(4, jobs, tmp)()


def _jax(mesh: dict, case: dict):
    """JAX's output and gradients of ``sum(o * do)`` on the same mesh."""
    env = jbuild(MeshConfig(**mesh), devices=jax.devices()[:4])
    fn = jring if case["op"] == "ring" else julysses
    set_current_mesh(env)
    try:
        def loss(q, k, v):
            o = fn(q, k, v, causal=case["causal"])
            return (o * case["do"]).sum(), o

        (_, o), g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
            *(jnp.asarray(case[x]) for x in "qkv"))
    finally:
        set_current_mesh(None)
    return np.asarray(o), [np.asarray(x) for x in g]


def _assemble(ranks: list, name: str, case: str, key: str, mesh: dict):
    """The whole (B, T, H, D) tensor from the ranks' blocks."""
    n, m = mesh.get("seq", 1), mesh.get("model", 1)
    full = np.zeros((B, T, H, D), np.float32)
    t, h = T // n, H // m
    for rank in ranks:
        c = rank[name]["coords"]
        full[:, c["seq"] * t:(c["seq"] + 1) * t,
             c["model"] * h:(c["model"] + 1) * h] = rank[name][case][key]
    return full


@pytest.mark.parametrize("name,case", [
    (name, c["name"]) for name in MESHES for c in CASES[name]
    if c["name"] != "ulysses_heads"])
def test_seq_attention_matches_jax_and_dense(runs, name, case):
    spec = next(c for c in CASES[name] if c["name"] == case)
    jo, jg = _jax(MESHES[name], spec)
    got = {key: _assemble(runs, name, case, key, MESHES[name])
           for key in ("o", "dq", "dk", "dv")}
    np.testing.assert_allclose(got["o"], jo, rtol=TOL, atol=TOL)
    for key, want in zip(("dq", "dk", "dv"), jg):
        np.testing.assert_allclose(got[key], want, rtol=TOL, atol=TOL,
                                   err_msg=key)
    # And the dense attention of the whole problem.
    dense = np.asarray(jdense(*(jnp.asarray(spec[x]) for x in "qkv"),
                              causal=spec["causal"]))
    np.testing.assert_allclose(got["o"], dense, rtol=TOL, atol=TOL)
    for rank in runs:
        assert rank[name][case]["fallbacks"] == 0


def _block_bytes(t: int, h: int, itemsize: int) -> int:
    return B * t * h * D * itemsize


@pytest.mark.parametrize("case", ["ring_causal", "ring_full",
                                  "ulysses_causal"])
def test_bytes_counted_at_the_send(runs, case):
    n, t = 4, T // 4
    kv = 2 * _block_bytes(t, H, 4)  # K and V of one block, fp32
    for rank in runs:
        r = rank["seq4"]["coords"]["seq"]
        got = rank["seq4"][case]["wire"].get("seq", {})
        if case == "ring_causal":
            hops = r + 1 if r < n - 1 else 0
            home = (n - 1) if r == n - 1 else 0
            # Forward K/V, backward K/V + dK/dV, then the dK/dV home.
            want = hops * kv + hops * 2 * kv + home * kv
        elif case == "ring_full":
            want = (n - 1) * kv + (n - 1) * 2 * kv + kv
        else:
            want = 8 * _block_bytes(t, H, 4) * (n - 1) // n
        assert got == ({"float32": want} if want else {}), (r, got)


def test_ulysses_head_divisibility_message(runs):
    spec = next(c for c in CASES["seq2_model2"]
                if c["name"] == "ulysses_heads")
    env = jbuild(MeshConfig(**MESHES["seq2_model2"]),
                 devices=jax.devices()[:4])
    set_current_mesh(env)
    try:
        with pytest.raises(ValueError) as e:
            julysses(*(jnp.asarray(spec[x]) for x in "qkv"))
    finally:
        set_current_mesh(None)
    for rank in runs:
        assert rank["seq2_model2"]["ulysses_heads"]["error"] == str(e.value)
