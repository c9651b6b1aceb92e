"""The collective-matmul pair over a mesh axis: the port of the JAX
package's ``ops/collective_matmul.py``, per rank, on point-to-point
sends over the axis's group (``dist/collectives.py``
``exchange_start``).

- ``all_gather_matmul``: ``x``, this rank's chunk along ``chunk_axis``
  (tokens for the GPT stack, the batch for ViT), times this rank's
  column split ``w [K, M_local]``. A bidirectional ring: the chunk is
  halved along ``chunk_axis``, one half travelling to the next rank and
  one to the previous, and every visiting half is multiplied as it
  arrives, so ``gather(x) @ w`` is built without a gathered ``x`` as the
  output of one collective. ``return_full`` also returns the gathered
  ``x`` (the q / k / v trio shares one ring).
- ``matmul_reduce_scatter``: its transpose. ``y`` gathered along
  ``chunk_axis`` with this rank's feature slice, times the row split
  ``w [M_local, K]``: partial products accumulate into chunk
  accumulators that rotate around the ring (split in half along the
  output features, one half each way) and end on the rank that owns the
  chunk.

Each hop is posted before the visit's product and waited on after it,
so the transfer and the product overlap in the structure. The visit
order is the reference's: after s hops the gather ring holds chunks
``idx - s`` and ``idx + s``, and the rotating accumulators add chunk
``(idx - 1 - s) % n`` (and its mirror) at step s, so the fp32 sums
follow the reference's order.

Each op is a ``torch.autograd.Function`` whose backward is the other's
schedule: the gather's ``dx`` is the rotating ring over ``dy @ w^T``
(with the gathered copy's gradient added to the same accumulators) and
its ``dw`` accumulates blockwise while ``x`` streams again; the
reduce-scatter's backward is one gather ring of ``dz`` that gives ``dy``
and ``dw`` together. No gathered activation is saved.

``lowp`` (``int8`` / ``fp8_e4m3`` / ``fp8_e5m2``): the streamed chunks
are quantized per-tensor once, before they enter the ring, and travel
as 1-byte payloads beside their fp32 scale; the rotating accumulators
are requantized at every hop; every visit's product is ``qdot`` against
the per-output-channel quantized resident ``w``; the gathered copy and
the weight gradients read the dequantized chunks. The backward rings
quantize their transfers the same way (straight-through: the residuals
stay full precision). ``ring_stats`` counts the hops this process made.
"""

from __future__ import annotations

import torch

from frl_distributed_ml_scaffold_tpu_torch.dist import collectives
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
    MeshEnv,
    current_mesh_env,
)
from frl_distributed_ml_scaffold_tpu_torch.ops.quantization import (
    dequantize,
    qdot,
    quantize,
    resolve_lowp,
)

#: Hops this process made, over every ring.
ring_stats = {"hops": 0}


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., K] x [K, M] -> [..., M] in the operands' promoted dtype."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [R, K] @ b [K, M]`` with an fp32 result: bf16 operands on a
    card contract on the tensor cores into fp32, others upcast first."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _wgrad(chunk: torch.Tensor, stat: torch.Tensor, order: str
           ) -> torch.Tensor:
    """Blockwise weight-gradient contribution, every non-feature dim
    contracted, in fp32: ``chunk^T @ stat`` (``lhs``, [K, M]) or
    ``stat^T @ chunk`` (``rhs``, [M, K])."""
    a, b = (chunk, stat) if order == "lhs" else (stat, chunk)
    return mm_f32(a.reshape(-1, a.shape[-1]).t(), b.reshape(-1, b.shape[-1]))


def _hop(payloads: list, dsts: list[int], srcs: list[int], axis: str,
         env: MeshEnv) -> collectives.Pending:
    """Post one hop: each payload (a tensor, or a (payload, scale) pair)
    to its destination coordinate, the same shapes back from the
    sources."""
    sends, recvs = [], []
    for p, dst, src in zip(payloads, dsts, srcs):
        for t in (p if isinstance(p, tuple) else (p,)):
            sends.append((t, dst))
            recvs.append((t, src))
    ring_stats["hops"] += 1
    return collectives.exchange_start(sends, recvs, axis, env=env)


def _regroup(payloads: list, got: list) -> list:
    """The received tensors grouped like ``payloads``."""
    out, i = [], 0
    for p in payloads:
        if isinstance(p, tuple):
            out.append(tuple(got[i:i + len(p)]))
            i += len(p)
        else:
            out.append(got[i])
            i += 1
    return out


def _stream_ring(x, axis: str, chunk_axis: int, env: MeshEnv, *, w=None,
                 stationary=None, wgrad_order: str = "lhs",
                 return_full: bool = False, lowp=None):
    """The bidirectional gather ring over ``x``'s shards (module
    docstring). Per visiting chunk c: ``y[rows c] = chunk @ w``,
    ``full[rows c] = chunk``, ``dw += wgrad(chunk, stationary[rows
    c])``, each where asked for. Returns ``(y, full, dw)``."""
    lowp = resolve_lowp(lowp)
    n, idx = env.axis_size(axis), env.axis_index(axis)
    tc = x.shape[chunk_axis]
    gathered = list(x.shape)
    gathered[chunk_axis] = n * tc
    y = full = dw = None
    if w is not None:
        y = x.new_zeros(gathered[:-1] + [w.shape[-1]],
                        dtype=torch.promote_types(x.dtype, w.dtype))
    if return_full:
        full = x.new_zeros(gathered)
    if stationary is not None:
        k, m = x.shape[-1], stationary.shape[-1]
        dw = torch.zeros((k, m) if wgrad_order == "lhs" else (m, k),
                         dtype=torch.float32, device=x.device)
    q_w = s_w = None
    if lowp is not None and w is not None:
        q_w, s_w = quantize(w, lowp, channel_axes=w.dim() - 1)

    def pack(chunk):
        return chunk if lowp is None else quantize(chunk, lowp)

    def visit(payload, c, off):
        nonlocal dw
        if lowp is None:
            chunk = payload
        else:
            q_c, s_c = payload
            chunk = dequantize(q_c, s_c, x.dtype)
        start = c * tc + off
        rows = chunk.shape[chunk_axis]
        if w is not None:
            prod = (_mm(chunk, w) if lowp is None
                    else qdot(q_c, s_c, q_w, s_w[0]))
            y.narrow(chunk_axis, start, rows).copy_(prod)
        if return_full:
            full.narrow(chunk_axis, start, rows).copy_(chunk)
        if stationary is not None:
            dw += _wgrad(chunk, stationary.narrow(chunk_axis, start, rows),
                         wgrad_order)

    nxt, prv = (idx + 1) % n, (idx - 1) % n
    half = tc // 2
    if n > 1 and tc % 2 == 0 and tc >= 2:
        lo = pack(x.narrow(chunk_axis, 0, half))
        hi = pack(x.narrow(chunk_axis, half, tc - half))
        c_lo = c_hi = idx
        for step in range(n):
            # lo travels to the next rank, hi to the previous one: after s
            # hops this rank holds chunks idx - s and idx + s.
            pend = (_hop([lo, hi], [nxt, prv], [prv, nxt], axis, env)
                    if step < n - 1 else None)
            visit(lo, c_lo, 0)
            visit(hi, c_hi, half)
            if pend is not None:
                lo, hi = _regroup([lo, hi], pend.wait())
                c_lo, c_hi = (c_lo - 1) % n, (c_hi + 1) % n
    else:
        payload, c = pack(x), idx
        for step in range(n):
            pend = (_hop([payload], [nxt], [prv], axis, env)
                    if step < n - 1 else None)
            visit(payload, c, 0)
            if pend is not None:
                payload = _regroup([payload], pend.wait())[0]
                c = (c - 1) % n
    if dw is not None:
        dw = dw.to(torch.promote_types(x.dtype, stationary.dtype))
    return y, full, dw


def _rotating_ring(y, w, axis: str, chunk_axis: int, env: MeshEnv, *,
                   extra=None, lowp=None):
    """``z`` chunk c = the sum over ranks j of ``y_j[rows c] @ w_j`` (+
    ``extra_j[rows c]``), ending on rank c (module docstring)."""
    lowp = resolve_lowp(lowp)
    n, idx = env.axis_size(axis), env.axis_index(axis)
    tc = y.shape[chunk_axis] // n
    d = w.shape[-1]
    out_dtype = torch.promote_types(y.dtype, w.dtype)
    q_w = s_w = None
    if lowp is not None:
        q_w, s_w = quantize(w, lowp, channel_axes=w.dim() - 1)

    def contrib(c, col0, cols):
        y_c = y.narrow(chunk_axis, c * tc, tc)
        if lowp is None:
            part = _mm(y_c, w[:, col0:col0 + cols])
        else:
            q_c, s_c = quantize(y_c, lowp)
            part = qdot(q_c, s_c, q_w[:, col0:col0 + cols],
                        s_w[0, col0:col0 + cols])
        if extra is not None:
            part = part + extra.narrow(chunk_axis, c * tc, tc)[
                ..., col0:col0 + cols].to(part.dtype)
        return part

    def wire(acc):
        return acc if lowp is None else quantize(acc, lowp)

    def unwire(got, like):
        return got if lowp is None else dequantize(*got, like.dtype)

    nxt, prv = (idx + 1) % n, (idx - 1) % n
    if n > 1 and d % 2 == 0 and d >= 2:
        dh = d // 2
        acc_lo = contrib((idx - 1) % n, 0, dh)
        acc_hi = contrib((idx + 1) % n, dh, d - dh)
        for step in range(1, n):
            # The accumulator of chunk c walks c+1, c+2, ... and ends home
            # at c (the other half mirrored); the next contributions are
            # computed while it travels.
            sent = [wire(acc_lo), wire(acc_hi)]
            pend = _hop(sent, [nxt, prv], [prv, nxt], axis, env)
            p_lo = contrib((idx - 1 - step) % n, 0, dh)
            p_hi = contrib((idx + 1 + step) % n, dh, d - dh)
            got = _regroup(sent, pend.wait())
            acc_lo = unwire(got[0], acc_lo) + p_lo
            acc_hi = unwire(got[1], acc_hi) + p_hi
        z = torch.cat([acc_lo, acc_hi], dim=-1)
    else:
        acc = contrib((idx - 1) % n, 0, d)
        for step in range(1, n):
            sent = [wire(acc)]
            pend = _hop(sent, [nxt], [prv], axis, env)
            p = contrib((idx - 1 - step) % n, 0, d)
            acc = unwire(_regroup(sent, pend.wait())[0], acc) + p
        z = acc
    return z.to(out_dtype)


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, axis, chunk_axis, return_full, lowp, env):
        y, full, _ = _stream_ring(x, axis, chunk_axis, env, w=w,
                                  return_full=return_full, lowp=lowp)
        ctx.save_for_backward(x, w)
        ctx.meta = (axis, chunk_axis, return_full, lowp, env)
        ctx.set_materialize_grads(False)
        return (y, full) if return_full else y

    @staticmethod
    def backward(ctx, dy, dfull=None):
        x, w = ctx.saved_tensors
        axis, chunk_axis, _, lowp, env = ctx.meta
        if dy is None:
            gathered = list(x.shape)
            gathered[chunk_axis] *= env.axis_size(axis)
            dy = x.new_zeros(gathered[:-1] + [w.shape[-1]])
        _, _, dw = _stream_ring(x, axis, chunk_axis, env, stationary=dy,
                                wgrad_order="lhs", lowp=lowp)
        dx = _rotating_ring(dy, w.t(), axis, chunk_axis, env, extra=dfull,
                            lowp=lowp)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None, None, None


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, w, axis, chunk_axis, lowp, env):
        ctx.save_for_backward(y, w)
        ctx.meta = (axis, chunk_axis, lowp, env)
        return _rotating_ring(y, w, axis, chunk_axis, env, lowp=lowp)

    @staticmethod
    def backward(ctx, dz):
        y, w = ctx.saved_tensors
        axis, chunk_axis, lowp, env = ctx.meta
        dy, _, dw = _stream_ring(dz, axis, chunk_axis, env, w=w.t(),
                                 stationary=y, wgrad_order="rhs", lowp=lowp)
        return dy.to(y.dtype), dw.to(w.dtype), None, None, None, None


def _mesh(env: MeshEnv | None) -> MeshEnv:
    env = env or current_mesh_env()
    if env is None:
        raise RuntimeError("the collective-matmul rings need a mesh: pass "
                           "env= or enter mesh_context(env)")
    return env


def all_gather_matmul(x: torch.Tensor, w: torch.Tensor, axis: str,
                      chunk_axis: int, return_full: bool = False,
                      lowp=None, *, env: MeshEnv | None = None):
    """``gather(x) @ w`` over ``axis`` (module docstring): ``x`` this
    rank's chunk along ``chunk_axis``, ``w [K, M_local]`` its column
    split. Returns ``y``, or ``(y, full)`` with ``return_full``."""
    return _AllGatherMatmul.apply(x, w, axis, chunk_axis, return_full,
                                  resolve_lowp(lowp), _mesh(env))


def matmul_reduce_scatter(y: torch.Tensor, w: torch.Tensor, axis: str,
                          chunk_axis: int, lowp=None, *,
                          env: MeshEnv | None = None) -> torch.Tensor:
    """This rank's chunk along ``chunk_axis`` of the sum over ``axis`` of
    ``y @ w`` (module docstring): ``y`` gathered with this rank's
    feature slice, ``w [M_local, K]`` its row split."""
    return _MatmulReduceScatter.apply(y, w, axis, chunk_axis,
                                      resolve_lowp(lowp), _mesh(env))
