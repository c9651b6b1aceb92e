"""The port's collective-matmul rings (``ops/collective_matmul.py``)
on four gloo ranks against the JAX package's rings under ``shard_map``
on 4 of the 8 simulated devices, ``model=4``, on the same numpy inputs
from a seed:

- ``all_gather_matmul`` (the bidirectional gather ring, with and
  without ``return_full``, chunked along the tokens and along the
  batch, and the one-way ring where the chunk is odd) and
  ``matmul_reduce_scatter`` (the rotating ring, and its one-way form
  over an odd output width), forward and backward through their
  autograd functions with explicit cotangents, fp32 and under ``lowp``
  int8 / fp8_e4m3 / fp8_e5m2: fp32 to rtol 1e-5; int8 to 1e-5 (its
  products are exact integers, summed in the reference's order); fp8
  (fp32 products, whose order of summation differs, requantized at every
  hop with the compiled reference's scales) to 2e-2 of the largest
  value, under one quantization step;
- the first hop's payload and scale bit-equal to the reference's
  compiled ``quantize`` of the same chunk (every format for the gather ring; int8
  for the rotating ring, whose first payload is a product);
- the bytes each rank sends, per dtype, equal to the hops times the
  payloads and scales.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import zlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from _torch_ranks import spawn_ranks
from frl_distributed_ml_scaffold_tpu.config.schema import MeshConfig as JMesh
from frl_distributed_ml_scaffold_tpu.dist import mesh as jmesh
from frl_distributed_ml_scaffold_tpu.ops import collective_matmul as jcm
from frl_distributed_ml_scaffold_tpu.ops import quantization as jq

N = 4
FORMATS = (None, "int8", "fp8_e4m3", "fp8_e5m2")
# name: (op, x shape (global), w shape (global), chunk_axis, return_full)
SHAPES = {
    "agm_tokens": ("agm", (2, 32, 16), (16, 24), 1, False),
    "agm_full": ("agm", (2, 32, 16), (16, 24), 1, True),
    "agm_batch": ("agm", (8, 6, 16), (16, 8), 0, False),
    "agm_oneway": ("agm", (2, 12, 16), (16, 8), 1, False),  # chunk 3
    "mrs_tokens": ("mrs", (2, 32, 24), (24, 16), 1, False),
    "mrs_batch": ("mrs", (8, 6, 16), (16, 8), 0, False),
    "mrs_oneway": ("mrs", (2, 32, 24), (24, 5 * 4), 1, False),
}
CASES = [(name, lowp) for name in SHAPES for lowp in FORMATS
         if name not in ("agm_oneway", "mrs_oneway", "agm_batch")
         or lowp in (None, "int8")]


def _spec(ndim, dim):
    return P(*[("model" if i == dim else None) for i in range(ndim)])


# The JAX package's ``quantize`` compiled, as its rings run it: XLA takes
# ``max|x| / qmax`` as a product with qmax's fp32 reciprocal (ROADMAP
# C.15).
jq_quantize = jax.jit(jq.quantize, static_argnums=(1, 2))


def _inputs(name):
    """The case's inputs, drawn from a seed that is a function of its name
    alone: ``zlib.crc32``, where ``hash(name)`` changed with every
    process's string-hash salt (``PYTHONHASHSEED``), so each run drew
    other inputs."""
    op, xs, ws, ca, full = SHAPES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    x = rng.standard_normal(xs).astype(np.float32)
    w = (0.3 * rng.standard_normal(ws)).astype(np.float32)
    if op == "agm":
        ys = xs[:-1] + (ws[1],)
    else:
        ys = xs[:-1] + (ws[1],)
    dy = rng.standard_normal(ys).astype(np.float32)
    dfull = rng.standard_normal(xs).astype(np.float32)
    return x, w, dy, dfull


def _shards(name, x, w, dy, dfull, i):
    op, _, _, ca, full = SHAPES[name]
    if op == "agm":
        return {"x": np.split(x, N, ca)[i], "w": np.split(w, N, 1)[i],
                "dy": np.split(dy, N, -1)[i], "dfull": dfull}
    return {"x": np.split(x, N, -1)[i], "w": np.split(w, N, 0)[i],
            "dy": np.split(dy, N, ca)[i], "dfull": dfull}


def _jax(name, lowp, x, w, dy, dfull):
    """Outputs and gradients of the JAX ring, per shard under
    ``shard_map``, assembled whole."""
    op, xs, ws, ca, full = SHAPES[name]
    env = jmesh.build_mesh(JMesh(data=1, model=-1), devices=jax.devices()[:N])
    nd = len(xs)
    if op == "agm":
        fn = partial(jcm.all_gather_matmul, axis_name="model", chunk_axis=ca,
                     return_full=full, precision=None, lowp=lowp)
        ins = (_spec(nd, ca), P(None, "model"), _spec(nd, nd - 1), P())
        outs = ((_spec(nd, nd - 1), P()) if full else (_spec(nd, nd - 1),))
        grads = (_spec(nd, ca), P(None, "model"))
    else:
        fn = partial(jcm.matmul_reduce_scatter, axis_name="model",
                     chunk_axis=ca, precision=None, lowp=lowp)
        ins = (_spec(nd, nd - 1), P("model", None), _spec(nd, ca), P())
        outs = (_spec(nd, ca),)
        grads = (_spec(nd, nd - 1), P("model", None))

    def per_shard(x, w, dy, dfull):
        out, vjp = jax.vjp(lambda a, b: fn(a, b), x, w)
        ct = (dy, dfull) if full else dy
        dx, dw = vjp(ct)
        out = out if full else (out,)
        return (*out, dx, dw)

    f = jmesh.shard_map_compat(per_shard, mesh=env.mesh, in_specs=ins,
                               out_specs=(*outs, *grads))
    res = jax.jit(f)(x, w, dy, dfull)
    return [np.asarray(r, np.float32) for r in res]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = {name: _inputs(name) for name in SHAPES}
    jobs = []
    for r in range(N):
        cases = []
        for name, lowp in CASES:
            op, _, _, ca, full = SHAPES[name]
            cases.append({"name": f"{name}:{lowp}", "op": op,
                          "chunk_axis": ca, "return_full": full,
                          "lowp": lowp,
                          **_shards(name, *inputs[name], r)})
        jobs.append(cases)
    # Every rank takes its own shards: one job list per rank, by index.
    tmp = tmp_path_factory.mktemp("rings")
    out = spawn_ranks(N, [{"name": "rings", "kind": "rings_by_rank",
                           "args": {"by_rank": jobs}}], tmp)
    return inputs, [o["rings"] for o in out]


def _assemble(name, ranks, key):
    op, _, _, ca, full = SHAPES[name]
    parts = [p for _, p in sorted(ranks, key=lambda r: r[0])]
    if key == "outs":
        y = [p[key][0] for p in parts]
        dim = -1 if op == "agm" else ca
        got = [np.concatenate(y, dim)]
        if full:
            got.append(parts[0][key][1])
            for p in parts:
                np.testing.assert_array_equal(p[key][1], got[1])
        return got
    vals = [p[key] for p in parts]
    if key == "dx":
        return np.concatenate(vals, ca if op == "agm" else -1)
    return np.concatenate(vals, 1 if op == "agm" else 0)


def _tol(lowp, ref):
    if lowp is None or lowp == "int8":
        return dict(rtol=1e-5, atol=1e-5 * float(np.abs(ref).max()))
    return dict(rtol=0, atol=2e-2 * float(np.abs(ref).max()))


@pytest.mark.parametrize("name,lowp", CASES)
def test_ring_matches_jax(ranks, name, lowp):
    inputs, res = ranks
    key = f"{name}:{lowp}"
    per = [(r["index"], r[key]) for r in res]
    want = _jax(name, lowp, *inputs[name])
    got = _assemble(name, per, "outs") + [_assemble(name, per, "dx"),
                                          _assemble(name, per, "dw")]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **_tol(lowp, w), err_msg=key)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint8 if a.dtype.itemsize == 1 else np.uint32)


@pytest.mark.parametrize("name,lowp", [(n, f) for n, f in CASES
                                       if f is not None])
def test_first_hop_payload_is_the_references(ranks, name, lowp):
    """The first forward hop's sends, bit for bit: the gather ring sends
    ``quantize`` (compiled, as the reference ring runs it) of its chunk's
    two halves (every format); the rotating
    ring sends its first accumulators, a ``qdot`` of quantized operands
    requantized (bit-equal in int8, whose products are exact)."""
    inputs, res = ranks
    op, _, _, ca, _ = SHAPES[name]
    for r in res:
        i = r["index"]
        sh = _shards(name, *inputs[name], i)
        sent = r[f"{name}:{lowp}"]["first_fwd"]
        x = jnp.asarray(sh["x"])
        if op == "agm":
            tc = x.shape[ca]
            if tc % 2:
                want = [*jq_quantize(x, lowp, None)]
            else:
                h = tc // 2
                lo = jax.lax.slice_in_dim(x, 0, h, axis=ca)
                hi = jax.lax.slice_in_dim(x, h, tc, axis=ca)
                want = [*jq_quantize(lo, lowp, None),
                        *jq_quantize(hi, lowp, None)]
        else:
            if lowp != "int8":
                continue
            w = jnp.asarray(sh["w"])
            q_w, s_w = jq_quantize(w, lowp, (1,))
            tc = x.shape[ca] // N
            d = w.shape[1]
            halves = ([(0, d // 2, (i - 1) % N), (d // 2, d, (i + 1) % N)]
                      if d % 2 == 0 else [(0, d, (i - 1) % N)])
            want = []
            for c0, c1, c in halves:
                y_c = jax.lax.slice_in_dim(x, c * tc, (c + 1) * tc, axis=ca)
                q_c, s_c = jq_quantize(y_c, lowp, None)
                part = jq.qdot(q_c, s_c, q_w[:, c0:c1], s_w[0, c0:c1],
                               (((q_c.ndim - 1,), (0,)), ((), ())))
                want += [*jq_quantize(part, lowp, None)]
        assert len(sent) == len(want)
        for g, w in zip(sent, want):
            w = np.asarray(w.astype(jnp.float32) if w.dtype != jnp.int8
                           else w)
            assert g.shape == w.shape
            np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("name,lowp", CASES)
def test_bytes_sent_are_the_hops_payloads(ranks, name, lowp):
    """Forward and backward: each ring of n ranks makes n - 1 hops, each
    sending this rank's payloads (both halves) and, under ``lowp``, one
    fp32 scale beside each."""
    inputs, res = ranks
    op, xs, ws, ca, full = SHAPES[name]
    item = 4 if lowp is None else 1
    x_chunk = int(np.prod(xs)) // N
    if op == "agm":
        y_chunk = int(np.prod(xs[:-1])) // N * ws[1]
        # forward gather ring; backward: the gather ring again (dw) and
        # the rotating ring over dy @ w^T (accumulators of x's chunk).
        payload = [x_chunk, x_chunk, x_chunk]
        split = [xs[ca] // N % 2 == 0, xs[ca] // N % 2 == 0, xs[-1] % 2 == 0]
    else:
        z_chunk = int(np.prod(xs[:-1])) // N * ws[1]
        y_chunk = z_chunk
        payload = [z_chunk, z_chunk]
        split = [ws[1] % 2 == 0, xs[ca] // N % 2 == 0]
    del y_chunk
    want = {("float32" if lowp is None else jq.lowp_dtype(lowp).__name__):
            (N - 1) * sum(payload) * item}
    if lowp is not None:
        want["float32"] = (N - 1) * 4 * sum(2 if s else 1 for s in split)
    for r in res:
        got = r[f"{name}:{lowp}"]["wire"]
        assert {k.replace("float8_e4m3fn", "float8_e4m3fn"): v
                for k, v in got.items()} == want, (got, want)
