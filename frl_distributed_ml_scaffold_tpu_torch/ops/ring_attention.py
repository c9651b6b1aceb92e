"""Training attention over the tokens: the port of the JAX package's
``ops/ring_attention.py``.

``dense_attention`` is the plain attention of ``model.attention=dense``
and the numerics every attention mode reduces to.

``ring_attention`` is causal attention with the tokens split over the
mesh's ``seq`` axis (``dist/mesh.py``): rank r of n holds every row's
tokens ``[r T/n, (r+1) T/n)`` and keeps its queries while the K/V blocks
move around the ring. Each hop is one block of flash attention
(``ops/flash_attention.py`` ``block_attention_fwd`` /
``block_attention_bwd``: the hand-written kernels on the card, the plain
lse versions on the CPU), merged exactly by the rows' logsumexp in fp32:

- hop 0 is the diagonal block, ``causal=True``;
- hop s brings the block of rank ``r - s``: ``causal=False`` where that
  block lies before rank r's own, and nothing where it lies after. Under
  the causal mask a block is of use only to the ranks after its own, so
  it travels ``r+1, ..., n-1`` and stops: rank r sends at hops ``1 ..
  r+1`` (none from rank n-1) and receives at hops ``1 .. r``. Each hop's
  exchange (``dist/collectives.py`` ``exchange_start``, its bytes counted
  at the send) is posted before the previous hop's product and waited on
  after it.

The backward saves only the local ``(q, k, v, o, lse)``. It sends the
K/V blocks around again, each with its fp32 dK/dV accumulators, and
calls ``block_attention_bwd`` with the rows' global lse and output on
each live hop (rank r: the diagonal and ``r`` more); rank n-1 then sends
each block's accumulators home. Without the causal mask every hop is
live and the blocks go the whole ring, then one hop more home, as the
reference's do.

So on the card rank r launches the forward kernel ``r+1`` times per
layer per forward, and the dQ and dK/dV kernels ``r+1`` times each per
backward. Over a ``seq`` axis of size 1, or without a mesh, it is
``dense_attention``, as in the reference.
"""

from __future__ import annotations

import math

import torch

from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import current_mesh_env

_NEG_INF = -1.0e30


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """(B, T, H, D) dense attention. The products take the input dtype's
    values with an fp32 accumulator (operands upcast, fp32 matmul), the
    softmax runs in fp32, and the probabilities are cast to q's dtype
    before the PV product; masked scores take -1e30."""
    t, d = q.shape[1], q.shape[3]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits * (1.0 / math.sqrt(d))
    if causal:
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
    return out.to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis_name: str = "seq", causal: bool = True
                   ) -> torch.Tensor:
    """(B, T/n, H, D) attention over this rank's block of the tokens, the
    tokens split over ``axis_name`` of the current mesh (module
    docstring); differentiable."""
    env = current_mesh_env()
    if env is None or env.axis_size(axis_name) == 1:
        return dense_attention(q, k, v, causal=causal)
    return _Ring.apply(q, k, v, axis_name, causal)


def _bhtd(x):
    return x.transpose(1, 2)


def _merge(o_run, lse_run, o_blk, lse_blk):
    """Exact combine of two self-normalised partial attentions (fp32)."""
    lse_new = torch.logaddexp(lse_run, lse_blk)
    o_new = (o_run * torch.exp(lse_run - lse_new)
             + o_blk.float() * torch.exp(lse_blk - lse_new))
    return o_new, lse_new


def _plan(r: int, n: int, s: int, causal: bool) -> tuple[bool, bool]:
    """(send, receive) of rank r at hop s (1 <= s < n): the causal ring
    carries a block only to the ranks after its own."""
    if not causal:
        return True, True
    return r < n - 1 and s <= r + 1, s <= r


def _exchange(sends, recv_like, send: bool, recv: bool, axis: str, env):
    """Post this rank's part of one hop: ``sends`` to the next rank,
    tensors like ``recv_like`` from the previous one."""
    from frl_distributed_ml_scaffold_tpu_torch.dist.collectives import (
        exchange_start,
    )

    n, r = env.axis_size(axis), env.axis_index(axis)
    return exchange_start(
        [(t, (r + 1) % n) for t in sends] if send else [],
        [(t, (r - 1) % n) for t in recv_like] if recv else [],
        axis, env=env)


class _Ring(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, axis, causal):
        from frl_distributed_ml_scaffold_tpu_torch.ops.flash_attention import (
            block_attention_fwd,
        )

        env = current_mesh_env()
        n, r = env.axis_size(axis), env.axis_index(axis)
        qT, kT, vT = _bhtd(q), _bhtd(k), _bhtd(v)
        pend = _exchange((kT, vT), (kT, vT), *_plan(r, n, 1, causal),
                         axis, env)
        o, lse = block_attention_fwd(qT, kT, vT, causal=causal)
        o = o.float()
        for s in range(1, n):
            send, recv = _plan(r, n, s, causal)
            got = pend.wait()
            if s + 1 < n:
                # The next hop's exchange runs under this hop's product.
                pend = _exchange(got, (kT, vT), *_plan(r, n, s + 1, causal),
                                 axis, env)
            if recv:
                o_s, lse_s = block_attention_fwd(qT, got[0], got[1],
                                                 causal=False)
                o, lse = _merge(o, lse, o_s, lse_s)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.axis, ctx.causal = axis, causal
        return _bhtd(o)

    @staticmethod
    def backward(ctx, do):
        from frl_distributed_ml_scaffold_tpu_torch.ops.flash_attention import (
            block_attention_bwd,
        )

        q, k, v, o, lse = ctx.saved_tensors
        axis, causal = ctx.axis, ctx.causal
        env = current_mesh_env()
        n, r = env.axis_size(axis), env.axis_index(axis)
        if do.stride(-1) != 1:
            do = do.contiguous()
        qT, kT, vT, doT = _bhtd(q), _bhtd(k), _bhtd(v), _bhtd(do)
        dq, dk, dv = block_attention_bwd(qT, kT, vT, o, lse, doT,
                                         causal=causal)
        dq = dq.float()
        # The block this rank holds: K, V and their travelling fp32 dK/dV.
        cur = (kT, vT, dk.float(), dv.float())
        home = cur[2:]
        kept = []  # causal, rank n-1: (source, dK, dV) of each block
        for s in range(1, n):
            send, recv = _plan(r, n, s, causal)
            got = _exchange(cur, cur, send, recv, axis, env).wait()
            if not recv:
                continue
            kb, vb, dkb, dvb = got
            dq_s, dk_s, dv_s = block_attention_bwd(qT, kb, vb, o, lse, doT,
                                                   causal=False)
            dq = dq + dq_s.float()
            cur = (kb, vb, dkb + dk_s.float(), dvb + dv_s.float())
            if causal and r == n - 1:
                kept.append(((r - s) % n, cur[2], cur[3]))
        if causal:
            # Rank n-1 holds every other block's complete dK/dV.
            from frl_distributed_ml_scaffold_tpu_torch.dist.collectives import (
                exchange_start,
            )

            sends = [(t, src) for src, dkb, dvb in kept for t in (dkb, dvb)]
            recvs = [] if r == n - 1 else [(home[0], n - 1),
                                           (home[1], n - 1)]
            got = exchange_start(sends, recvs, axis, env=env).wait()
            if r < n - 1:
                home = got
        else:
            # n - 1 hops happened; one more brings each block's dK/dV home.
            home = _exchange(cur[2:], cur[2:], True, True, axis, env).wait()
        return (_bhtd(dq.to(q.dtype)), _bhtd(home[0].to(k.dtype)),
                _bhtd(home[1].to(v.dtype)), None, None)
