"""The mixture-of-experts MLP: the port of the JAX package's
``models/moe.py`` (GShard-style top-k routing with per-group capacity).

The router runs in fp32 (its weights cast up from the compute dtype, as
flax's ``Dense(dtype=float32)`` promotes them): softmax, top-k and gates
renormalised over the k picks. Ties in top-k go to the lower expert
index, as ``lax.top_k`` orders them (a stable descending sort; torch's
``topk`` promises no order). Seats are handed out slot-major by
cumulative counts per group (every token's first choice before any
second choice), and a seat at or past the group's capacity ``max(1,
int(cf * s * k / e))`` drops the assignment (the residual carries the
token). Both dispatches share that seating, so their routing and drops
are the same:

- ``einsum``: one-hot ``[G, S, E, C]`` dispatch and combine tensors and
  four einsums (GShard);
- ``sort``: seat indices scattered into an ``[E * C]`` slot table one
  slot longer than the seats (the sentinel slot ``E * C`` takes the
  dropped assignments, where JAX's ``mode="drop"`` writes land nowhere,
  and is cut), tokens gathered by index against a zero row ``s``.

The experts run in the compute dtype with tanh-approximated GELU. The
auxiliary loss is GShard's load-balance term over all k slots plus the
ST-MoE router z-loss.

**Groups** (``_num_groups``, word for word the reference's): the
explicit ``moe.num_groups`` must divide the training batch; decode snaps
it to ``gcd``; auto follows the mesh's batch shards. The port computes
on a rank's rows (``row_shards`` ranks split the global rows), so a
rank routes ``global groups / row_shards`` whole groups of its own; a
count that would put one group across ranks raises
``NotImplementedError`` (ROADMAP A12), as does sequence parallelism,
whose ranks split every group's rows. The load-balance statistics are
the global batch's: the per-expert counts and probability sums are
summed over the batch axes (sum forward and backward, as sync-BN sums
its statistics).

**Expert parallelism**: under ``mesh.expert = n`` (``gpt_tp_rules``)
a rank holds experts ``[r E/n, (r+1) E/n)`` of ``wi`` and ``wo``. Every
rank along ``expert`` sees the same rows, routes every token and runs
its own experts; the outputs are summed over ``expert`` (the sum
forward, identity backward of ``reduce_from``). The tokens and the gate
values enter the local experts through ``copy_to`` (identity forward,
sum backward): their gradients through the experts are partial on each
rank. The auxiliary loss reads the router's probabilities outside that
pair, so its gradient, which every rank computes whole, is not summed
again.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from frl_distributed_ml_scaffold_tpu_torch.config.schema import GPTConfig
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
    BATCH_AXES,
    current_mesh_env,
)
from frl_distributed_ml_scaffold_tpu_torch.parallel.tensor_parallel import (
    all_reduce_batch,
    batch_shard,
    copy_to,
    reduce_from,
    seq_shard,
    shard_of,
)
from frl_distributed_ml_scaffold_tpu_torch.precision import Policy

DISPATCHES = ("einsum", "sort")


def _num_groups(moe, n: int, b: int, train: bool) -> int:
    """Routing-group count for ``n`` tokens (batch dim ``b``) of the
    global batch, as the reference computes it: an explicit count must
    divide the training batch (a silent snap would move the drop
    boundaries) and snaps to ``gcd`` in decode; auto is ``gcd(b,
    shards)`` over the mesh's batch shards."""
    if moe.num_groups > 0:
        if train and b % moe.num_groups != 0:
            raise ValueError(
                f"moe.num_groups={moe.num_groups} does not divide the "
                f"training batch dim b={b} (token count n={n}); a silent "
                "snap would change per-group capacity/drop semantics, and "
                "groups must align with the batch dim to stay "
                "batch-sharded. Pick a divisor of the batch size or use "
                "num_groups=0 (auto)."
            )
        # The gcd snap only serves decode (train=False, tiny n).
        return moe.num_groups if train else math.gcd(n, moe.num_groups)
    env = current_mesh_env()
    if env is None:
        return 1
    shards = 1
    for a in BATCH_AXES:
        shards *= env.shape.get(a, 1)
    return math.gcd(b, shards)


def local_groups(moe, n: int, b: int, train: bool, row_shards: int,
                 seq_split: bool = False) -> int:
    """The groups this rank routes: ``n`` tokens in ``b`` rows, its part
    of a global batch whose rows ``row_shards`` ranks split (and whose
    tokens the ``seq`` ranks split, with ``seq_split``)."""
    if seq_split:
        raise NotImplementedError(
            "MoE under sequence parallelism: the seq ranks split every "
            "routing group's rows (ROADMAP A12)")
    g = _num_groups(moe, n * row_shards, b * row_shards, train)
    if g % row_shards:
        raise NotImplementedError(
            f"{g} routing groups over {row_shards} batch shards put one "
            "group across ranks; the port routes whole groups on each rank "
            "(ROADMAP A12)")
    return g // row_shards


def topk_stable(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: the k largest, ties to the lower
    index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router_logits: torch.Tensor, k: int, capacity: int):
    """The routing of ``router_logits [G, S, E]`` (fp32): ``(probs,
    gate_vals, gate_idx, pos_toks, keeps, counts)``; ``pos_toks`` and
    ``keeps`` one ``[G, S]`` tensor per slot (the seat in its expert, and
    whether it is under capacity), ``counts [G, E]`` the assignments per
    expert over every slot."""
    e = router_logits.shape[-1]
    probs = torch.softmax(router_logits, dim=-1)
    gate_vals, gate_idx = topk_stable(probs, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    g = router_logits.shape[0]
    counts = torch.zeros((g, e), dtype=torch.int64, device=probs.device)
    pos_toks, keeps = [], []
    for slot in range(k):
        onehot = F.one_hot(gate_idx[..., slot], e)
        pos = torch.cumsum(onehot, dim=1) - 1 + counts[:, None, :]
        counts = counts + onehot.sum(dim=1)
        pos_tok = (pos * onehot).sum(-1)
        pos_toks.append(pos_tok)
        keeps.append(pos_tok < capacity)
    return probs, gate_vals, gate_idx, pos_toks, keeps, counts


def _gelu(x):
    return F.gelu(x, approximate="tanh")


class MoEMlp(nn.Module):
    """The MoE MLP of one block: ``router`` (``Linear(D, E)``), ``wi``
    ``[E, D, H]`` and ``wo`` ``[E, H, D]`` (this rank's experts under
    expert parallelism)."""

    def __init__(self, cfg: GPTConfig, policy: Policy, device):
        super().__init__()
        self.cfg, self.dtype = cfg, policy.compute_dtype
        moe, d, pd = cfg.moe, cfg.hidden_dim, policy.param_dtype
        hidden = d * cfg.mlp_ratio
        e = moe.num_experts
        self.router = nn.Linear(d, e, device=device, dtype=pd)
        self.wi = nn.Parameter(torch.zeros(e, d, hidden, device=device,
                                           dtype=pd))
        self.wo = nn.Parameter(torch.zeros(e, hidden, d, device=device,
                                           dtype=pd))

    def _experts(self):
        """(first expert index, expert count) of this rank's ``wi``."""
        e = self.cfg.moe.num_experts
        el = self.wi.shape[0]
        if el == e:
            return 0, e
        r, n = shard_of("expert")
        if el * n != e:
            raise ValueError(
                f"wi holds {el} of {e} experts over an expert axis of {n}")
        return r * el, el

    def forward(self, x: torch.Tensor, *, train: bool,
                sharded_rows: bool = False
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """``x [b, t, d]`` -> (``y [b, t, d]`` in the compute dtype, the
        fp32 auxiliary loss). ``sharded_rows``: ``x`` is this rank's part
        of the global batch under the current mesh (the training and eval
        forward: its rows over the batch axes, its tokens over ``seq``);
        in decode every rank holds every row."""
        cfg, cd = self.cfg, self.dtype
        moe = cfg.moe
        d = cfg.hidden_dim
        e, k = moe.num_experts, moe.top_k
        if moe.dispatch not in DISPATCHES:
            raise ValueError(
                f"moe.dispatch={moe.dispatch!r}: expected 'einsum' or 'sort'"
            )
        if shard_of("model")[1] > 1:
            raise NotImplementedError(
                "MoE under tensor parallelism (mesh.model > 1) is not "
                "ported yet (ROADMAP A12)")
        b, t, _ = x.shape
        n = b * t
        row_shards = batch_shard()[1] if sharded_rows else 1
        g = local_groups(moe, n, b, train, row_shards,
                         sharded_rows and seq_shard()[1] > 1)
        s = n // g
        capacity = max(1, int(moe.capacity_factor * s * k / e))
        xf = x.reshape(g, s, d).to(cd)
        router_logits = F.linear(xf.float(), self.router.weight.float(),
                                 self.router.bias.float())
        probs, gate_vals, gate_idx, pos_toks, keeps, counts = route(
            router_logits, k, capacity)

        lo, el = self._experts()
        ep = el < e
        xin = copy_to(xf, "expert") if ep else xf
        gates = copy_to(gate_vals, "expert") if ep else gate_vals
        wi, wo = self.wi.to(cd), self.wo.to(cd)
        if moe.dispatch == "sort":
            y = self._sort(xin, gates, gate_idx, pos_toks, keeps, capacity,
                           lo, el, wi, wo)
        else:
            y = self._einsum(xin, gates, gate_idx, pos_toks, keeps,
                             capacity, lo, el, wi, wo)
        if ep:
            y = reduce_from(y, "expert")

        # Load balance over every slot: frac counts assignments (no
        # gradient), the gradient flows through mean_prob.
        tokens = g * s * k
        frac_num = counts.sum(0).float()
        prob_sum = probs.sum(dim=(0, 1))
        if row_shards > 1:
            frac_num = all_reduce_batch(frac_num)
            prob_sum = all_reduce_batch(prob_sum)
        frac = frac_num / (tokens * row_shards)
        mean_prob = prob_sum / (g * s * row_shards)
        aux = moe.router_aux_loss * e * torch.sum(frac * mean_prob)
        if moe.router_z_loss > 0.0:
            z = torch.logsumexp(router_logits, dim=-1)
            zz = (z * z).sum()
            if row_shards > 1:
                zz = all_reduce_batch(zz)
            aux = aux + moe.router_z_loss * (zz / (g * s * row_shards))
        return y.reshape(b, t, d), aux

    def _einsum(self, xf, gates, gate_idx, pos_toks, keeps, capacity, lo,
                el, wi, wo):
        cd = self.dtype
        g, s, _ = xf.shape
        experts = torch.arange(lo, lo + el, device=xf.device)
        seats = torch.arange(capacity, device=xf.device)
        dispatch = torch.zeros((g, s, el, capacity), dtype=cd,
                               device=xf.device)
        combine = torch.zeros((g, s, el, capacity), dtype=torch.float32,
                              device=xf.device)
        for slot, (pos, keep) in enumerate(zip(pos_toks, keeps)):
            onehot = gate_idx[..., slot, None] == experts  # [G, S, El]
            pos_oh = pos[..., None] == seats  # [G, S, C]; none when dropped
            slot_dispatch = (onehot.to(cd)[..., None]
                             * pos_oh.to(cd)[..., None, :]
                             * keep.to(cd)[..., None, None])
            dispatch = dispatch + slot_dispatch
            combine = combine + (slot_dispatch.float()
                                 * gates[..., slot].float()[..., None, None])
        expert_in = torch.einsum("gsec,gsd->egcd", dispatch, xf)
        h = _gelu(torch.einsum("egcd,edh->egch", expert_in, wi))
        expert_out = torch.einsum("egch,ehd->egcd", h, wo)
        return torch.einsum("gsec,egcd->gsd", combine.to(cd), expert_out)

    def _sort(self, xf, gates, gate_idx, pos_toks, keeps, capacity, lo, el,
              wi, wo):
        cd = self.dtype
        g, s, d = xf.shape
        e = self.cfg.moe.num_experts
        dev = xf.device
        gi = torch.arange(g, device=dev)[:, None]
        token_idx = torch.arange(s, device=dev)[None, :].expand(g, s)
        seats = e * capacity
        # One slot longer than the seats: dropped assignments land in the
        # sentinel slot, which is cut.
        src = torch.full((g, seats + 1), s, dtype=torch.int64, device=dev)
        idx = []
        for slot, (pos, keep) in enumerate(zip(pos_toks, keeps)):
            dest = torch.where(keep, gate_idx[..., slot] * capacity + pos,
                               seats)
            src[gi, dest] = token_idx
            idx.append(dest)
        src = src[:, lo * capacity:(lo + el) * capacity]
        x_pad = torch.cat([xf, xf.new_zeros((g, 1, d))], dim=1)
        expert_in = (x_pad[gi, src].reshape(g, el, capacity, d)
                     .permute(1, 0, 2, 3))  # (El, G, C, D)
        h = _gelu(torch.einsum("egcd,edh->egch", expert_in, wi))
        expert_out = torch.einsum("egch,ehd->egcd", h, wo)
        out_pad = torch.cat([
            expert_out.permute(1, 0, 2, 3).reshape(g, el * capacity, d),
            expert_out.new_zeros((g, 1, d))], dim=1)
        y = torch.zeros((g, s, d), dtype=cd, device=dev)
        for slot, (dest, keep) in enumerate(zip(idx, keeps)):
            local = dest - lo * capacity
            mine = (local >= 0) & (local < el * capacity)
            local = torch.where(mine, local, el * capacity)
            w = torch.where(keep, gates[..., slot],
                            torch.zeros_like(gates[..., slot])).to(cd)
            y = y + out_pad[gi, local] * w[..., None]
        return y
