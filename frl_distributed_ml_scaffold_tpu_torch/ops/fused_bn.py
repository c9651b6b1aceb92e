"""Train-mode BatchNorm with a two-pass backward: the port of the JAX
package's ``ops/fused_bn.py``.

The forward is flax ``nn.BatchNorm``'s, op for op (``bn_train_forward``):
fp32 statistics with the fast variance ``E[x^2] - E[x]^2`` clipped at 0,
the normalize in promoted (fp32) arithmetic, one cast at the end. The
backward recomputes x̂ from ``(x, mean, var)`` instead of saving it and
runs two passes over ``(x, dy)`` viewed as a row-major (M, C) matrix
(channels last, M = every other axis):

1. ``bn_sums``: per channel ``dβ = Σ dy`` and ``dγ = Σ dy·x̂``;
2. ``bn_dx``: ``dx = (γ/σ)·(dy − dβ/M − x̂·dγ/M)``.

Two versions of each pass:

- the plain PyTorch version (``sums_plain`` / ``dx_plain``; both
  together are ``fallback_bwd``, the counterpart of ``_fallback_bwd``),
  which the CPU takes and which the card holds the kernels against
  (``chip_smoke.py``);
- the hand-written CUDA kernels of ``csrc/fused_bn.cu``, replacing the
  TPU's ``_sums_kernel`` and ``_dx_kernel``: ``frl_bn_bwd_sums`` (row
  splits reduced into a ``[splits, 2, C]`` workspace, then summed in a
  fixed order: deterministic, no atomics) and ``frl_bn_bwd_dx``. Each
  call of an entry adds one to ``bn_sums.launches`` / ``bn_dx.launches``.

Routing is by the tensor's device only: a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises; nothing falls back.
The kernels read x and dy in place, so on the card both must be
row-major (M, C) views (an NHWC tensor, contiguous); any other layout
raises rather than being copied.

``fused_bn_train`` ties the forward to this backward in an autograd
Function that saves ``(x, scale, mean, var)`` and never x̂, as
``_bn_train_fwd`` does. ``BatchNorm`` is flax ``nn.BatchNorm`` (train
mode differentiated by autograd through ``bn_train_forward``; eval mode
the running-stat normalize) and ``FusedBatchNorm`` the same module with
its train-mode backward through ``fused_bn_train``. Both return the new
running averages instead of writing them (``ra = 0.9 ra + 0.1 batch``,
with the biased batch variance), so a forward that runs twice cannot
apply the update twice.

Sync-BN, the JAX module's semantics under a batch-sharded mesh: with a
current mesh (``dist/mesh.py`` ``mesh_context``) whose batch axes span
more than one rank, the forward's statistics are the global batch's
(one all-reduce of ``(Σx, Σx²)`` over the batch axes, whose backward is
the same sum: ``parallel/tensor_parallel.py`` ``all_reduce_batch``), and
the backward runs the sums pass on the local rows, ONE all-reduce of
``(Σdy, Σdy·x̂)``, then the dx pass over the local rows with the global
sums and the global row count. The scale and bias get this rank's own
sums as their gradient: the step sums the gradients over the batch axes.
The running statistics, made from the global batch's, stay identical on
every rank.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist
from torch import nn

from frl_distributed_ml_scaffold_tpu_torch.ops import _build
from frl_distributed_ml_scaffold_tpu_torch.parallel.tensor_parallel import (
    all_reduce_batch,
    batch_group,
)

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Row splits of the sums pass: enough blocks to fill the card (about
# eight per SM across the channel tiles), each at least 128 rows.
_SPLIT_BLOCKS, _SPLIT_ROWS, _TILE = 1024, 128, 256


# ------------------------------------------------------------------ plain


def normalize(x, mean, var, scale, bias, eps, out_dtype):
    """flax ``_normalize``: ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias`` in promoted fp32, cast once to ``out_dtype``."""
    y = x.float() - mean
    mul = torch.rsqrt(var + eps) * scale.float()
    return (y * mul + bias.float()).to(out_dtype)


def bn_train_forward(x, scale, bias, eps, out_dtype):
    """Train-mode forward over the last axis -> (y, mean, var), the
    statistics fp32 (C,): flax ``_compute_stats`` (fast variance, clipped
    at 0) and ``_normalize``."""
    x32 = x.float()
    axes = tuple(range(x.dim() - 1))
    group = batch_group()
    if group is None:
        mean = x32.mean(axes)
        mean2 = x32.square().mean(axes)
    else:  # sync-BN: the global batch's statistics
        m = x32[..., 0].numel() * dist.get_world_size(group)
        sums = all_reduce_batch(torch.stack((x32.sum(axes),
                                             x32.square().sum(axes))))
        mean, mean2 = sums[0] / m, sums[1] / m
    var = torch.clamp_min(mean2 - mean.square(), 0.0)
    return normalize(x32, mean, var, scale, bias, eps, out_dtype), mean, var


def sums_plain(x2d, dy2d, mean, var, eps):
    """(Σdy, Σdy·x̂) per channel of (M, C) inputs, fp32."""
    dy32 = dy2d.float()
    xhat = (x2d.float() - mean) * torch.rsqrt(var + eps)
    return dy32.sum(0), (dy32 * xhat).sum(0)


def dx_plain(x2d, dy2d, scale, mean, var, dgamma, dbeta, eps, m):
    """``dx = (γ/σ)·(dy − dβ/M − x̂·dγ/M)`` of (M, C) inputs, in x's
    dtype; ``m`` is the row count the statistics were taken over."""
    inv = torch.rsqrt(var + eps)
    xhat = (x2d.float() - mean) * inv
    gi = scale.float() * inv
    dx = gi * (dy2d.float() - dbeta * (1.0 / m) - xhat * (dgamma * (1.0 / m)))
    return dx.to(x2d.dtype)


def fallback_bwd(x, dy, scale, mean, var, eps):
    """The whole backward as plain PyTorch -> (dx, dγ, dβ): the plain
    version of both kernels (``_fallback_bwd``)."""
    c = x.shape[-1]
    x2d, dy2d = x.reshape(-1, c), dy.reshape(-1, c)
    dbeta, dgamma = sums_plain(x2d, dy2d, mean, var, eps)
    dx = dx_plain(x2d, dy2d, scale, mean, var, dgamma, dbeta, eps,
                  x2d.shape[0])
    return dx.reshape(x.shape), dgamma, dbeta


# ------------------------------------------------------------------ kernels


def _on_card(t: torch.Tensor) -> bool:
    """True to launch the kernels (CUDA), False for the plain version
    (CPU); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"fused BatchNorm runs on cpu or cuda, not {t.device}")


def _check_rows(x2d, dy2d, *vectors):
    """What the kernels take; anything else raises before a pointer is
    handed over."""
    if x2d.dim() != 2 or x2d.shape != dy2d.shape:
        raise ValueError(
            f"BN kernels take x and dy as one (M, C) shape, got "
            f"{tuple(x2d.shape)} and {tuple(dy2d.shape)}")
    if x2d.dtype not in _KERNEL_DTYPES or dy2d.dtype != x2d.dtype:
        raise TypeError(f"BN kernels take x and dy of one dtype, float32 or "
                        f"bfloat16, got {x2d.dtype} and {dy2d.dtype}")
    if not (x2d.is_contiguous() and dy2d.is_contiguous()):
        raise ValueError(
            "BN kernels read x and dy in place as row-major (M, C): channels "
            "last (NHWC, or NCHW in torch.channels_last), contiguous; got "
            f"strides {x2d.stride()} and {dy2d.stride()}")
    m, c = x2d.shape
    if m == 0 or c == 0:
        raise ValueError(f"BN kernels need M, C > 0, got {(m, c)}")
    for v in vectors:
        if v.shape != (c,) or not v.is_contiguous():
            raise ValueError(f"per-channel vectors must be contiguous ({c},), "
                             f"got {tuple(v.shape)}")
        if v.device != x2d.device or dy2d.device != x2d.device:
            raise ValueError(f"tensors on {v.device}, {dy2d.device} and "
                             f"{x2d.device}")


def _fp32(*vectors):
    for v in vectors:
        if v.dtype != torch.float32:
            raise TypeError(f"statistics and sums must be float32, got {v.dtype}")


def _bind(name: str, argtypes: list):
    fn = getattr(_build.load("fused_bn"), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise _build.KernelError(
            f"BN backward {what} kernel launch failed: CUDA error {err}")


def _splits(m: int, c: int) -> int:
    tiles = -(-c // _TILE)
    return max(1, min(-(-m // _SPLIT_ROWS), _SPLIT_BLOCKS // tiles))


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def bn_sums(x2d, dy2d, mean, var, eps):
    """(dβ, dγ) = (Σdy, Σdy·x̂) per channel of (M, C) inputs, fp32 (C,)
    each: the kernel on a CUDA tensor, ``sums_plain`` on a CPU one."""
    if not _on_card(x2d):
        return sums_plain(x2d, dy2d, mean, var, eps)
    _check_rows(x2d, dy2d, mean, var)
    _fp32(mean, var)
    m, c = x2d.shape
    splits = _splits(m, c)
    work = torch.empty((splits, 2, c), dtype=torch.float32, device=x2d.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x2d.device)
    dgamma = torch.empty_like(dbeta)
    fn = _bind("frl_bn_bwd_sums", [_P, _P, _P, _P, _F, _L, _I, _I, _I, _P,
                                   _P, _P, _P])
    err = fn(x2d.data_ptr(), dy2d.data_ptr(), mean.data_ptr(), var.data_ptr(),
             eps, m, c, _KERNEL_DTYPES[x2d.dtype], splits, work.data_ptr(),
             dbeta.data_ptr(), dgamma.data_ptr(),
             torch.cuda.current_stream(x2d.device).cuda_stream)
    _raise_on(err, "sums")
    bn_sums.launches += 1
    return dbeta, dgamma


def bn_dx(x2d, dy2d, scale, mean, var, dgamma, dbeta, eps, m):
    """dx of (M, C) inputs in x's dtype (``m``: the statistics' row
    count): the kernel on a CUDA tensor, ``dx_plain`` on a CPU one."""
    if not _on_card(x2d):
        return dx_plain(x2d, dy2d, scale, mean, var, dgamma, dbeta, eps, m)
    _check_rows(x2d, dy2d, scale, mean, var, dgamma, dbeta)
    _fp32(mean, var, dgamma, dbeta)
    if scale.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"scale must be float32 or bfloat16, got {scale.dtype}")
    rows, c = x2d.shape
    dx = torch.empty_like(x2d)
    fn = _bind("frl_bn_bwd_dx", [_P, _P, _P, _I, _P, _P, _P, _P, _F, _F, _L,
                                 _I, _I, _P, _P])
    err = fn(x2d.data_ptr(), dy2d.data_ptr(), scale.data_ptr(),
             _KERNEL_DTYPES[scale.dtype], mean.data_ptr(), var.data_ptr(),
             dbeta.data_ptr(), dgamma.data_ptr(), eps, 1.0 / m, rows, c,
             _KERNEL_DTYPES[x2d.dtype], dx.data_ptr(),
             torch.cuda.current_stream(x2d.device).cuda_stream)
    _raise_on(err, "dx")
    bn_dx.launches += 1
    return dx


bn_sums.launches = 0
bn_dx.launches = 0


# ----------------------------------------------------------- autograd tie


def _rows(t: torch.Tensor) -> torch.Tensor:
    """The (M, C) view of a channels-last tensor. On the card a view or
    an error: a layout the kernels cannot read is never copied."""
    c = t.shape[-1]
    if t.device.type == "cuda" and not t.is_contiguous():
        raise ValueError(
            "BN kernels read x and dy in place as row-major (M, C): channels "
            f"last and contiguous; got shape {tuple(t.shape)} with strides "
            f"{t.stride()}")
    return t.reshape(-1, c)


class _FusedBNTrain(torch.autograd.Function):
    """(y, mean, var) of the train-mode forward; the backward runs the
    sums pass, then the dx pass, from the saved ``(x, scale, mean, var)``.
    ``mean`` and ``var`` feed only the running averages and are not
    differentiable."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, out_dtype):
        y, mean, var = bn_train_forward(x, scale, bias, eps, out_dtype)
        ctx.save_for_backward(x, scale, mean, var)
        ctx.eps, ctx.bias_dtype = eps, bias.dtype
        ctx.group = batch_group()
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, var = ctx.saved_tensors
        eps = ctx.eps
        x2d, dy2d = _rows(x), _rows(dy)
        dbeta, dgamma = bn_sums(x2d, dy2d, mean, var, eps)
        g_beta, g_gamma, m = dbeta, dgamma, x2d.shape[0]
        if ctx.group is not None:  # sync-BN: one all-reduce between passes
            sums = torch.stack((dbeta, dgamma))
            dist.all_reduce(sums, group=ctx.group)
            g_beta, g_gamma = sums.unbind()
            m *= dist.get_world_size(ctx.group)
        dx = bn_dx(x2d, dy2d, scale, mean, var, g_gamma, g_beta, eps, m)
        return (dx.view(x.shape), dgamma.to(scale.dtype),
                dbeta.to(ctx.bias_dtype), None, None)


def fused_bn_train(x, scale, bias, *, eps: float = 1e-5, out_dtype=None):
    """Train-mode BatchNorm over the last axis with the two-pass backward
    -> ``(y, mean, var)``; ``mean``/``var`` are the fp32 batch statistics
    for the running averages. ``out_dtype=None`` promotes the dtypes of
    x, scale and bias, as flax does."""
    if out_dtype is None:
        out_dtype = torch.promote_types(
            torch.promote_types(x.dtype, scale.dtype), bias.dtype)
    return _FusedBNTrain.apply(x, scale, bias, eps, out_dtype)


# ------------------------------------------------------------------ modules


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the last axis with ``momentum`` 0.9 and
    ``epsilon`` 1e-5: params ``scale`` (ones) and ``bias`` (zeros), fp32
    running statistics as the buffers ``mean`` (zeros) and ``var``
    (ones). ``dtype`` is the output dtype (flax's ``dtype``; None
    promotes x, scale and bias).

    ``forward(x, train=..., updates=...)``: in train mode the batch
    statistics normalize, and the new running averages are written into
    ``updates`` under ``stats_name + "mean"`` / ``"var"`` (the owning model
    sets ``stats_name`` to the module's qualified name and a dot); the
    buffers are left as they are. In eval mode the running statistics
    normalize."""

    def __init__(self, features: int, *, momentum: float = 0.9,
                 epsilon: float = 1e-5, dtype=None, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.momentum, self.epsilon, self.out_dtype = momentum, epsilon, dtype
        self.scale = nn.Parameter(torch.ones(features, dtype=param_dtype,
                                             device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype,
                                             device=device))
        self.register_buffer("mean", torch.zeros(features, device=device))
        self.register_buffer("var", torch.ones(features, device=device))
        self.stats_name = ""

    def _dtype(self, x):
        if self.out_dtype is not None:
            return self.out_dtype
        return torch.promote_types(
            torch.promote_types(x.dtype, self.scale.dtype), self.bias.dtype)

    def _train(self, x, out_dtype):
        return bn_train_forward(x, self.scale, self.bias, self.epsilon,
                                out_dtype)

    def forward(self, x, *, train: bool, updates: dict):
        out_dtype = self._dtype(x)
        if not train:
            return normalize(x, self.mean, self.var, self.scale, self.bias,
                             self.epsilon, out_dtype)
        y, mean, var = self._train(x, out_dtype)
        mom = self.momentum
        updates[self.stats_name + "mean"] = (
            mom * self.mean + (1 - mom) * mean.detach())
        updates[self.stats_name + "var"] = (
            mom * self.var + (1 - mom) * var.detach())
        return y


class FusedBatchNorm(BatchNorm):
    """``BatchNorm`` whose train-mode backward runs the two passes of
    ``fused_bn_train`` (the kernels on the card); the same params,
    buffers, forward and eval mode."""

    def _train(self, x, out_dtype):
        return fused_bn_train(x, self.scale, self.bias, eps=self.epsilon,
                              out_dtype=out_dtype)
