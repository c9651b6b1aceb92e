"""ResNet family (BASELINE config 2: ResNet-50 on ImageNet): the port of
the JAX package's ``models/resnet.py``.

v1.5 bottlenecks (the stride in the 3x3) for depths 50 / 101 / 152,
basic blocks for 10 / 18 / 34, the 7x7/s2 ``conv7`` stem and the 3x3/s2
max pool, global average pooling and a Dense head; the last BatchNorm of
every block starts at scale 0 (``models/convert.py``).

Layout: activations are NHWC, the JAX package's layout, held as
contiguous tensors. A convolution or the pool reads them as NCHW
through ``permute`` (an NCHW tensor in ``torch.channels_last`` memory,
the same storage), which cuDNN's Hopper convolutions prefer, and its
channels-last output permutes back without a copy. So every BatchNorm
sees its input and gradient as a row-major (M, C) matrix, which the
fused backward kernels read in place (``ops/fused_bn.py``).

Padding is flax's ``SAME``: ``total = max((ceil(n/s) - 1) s + k - n, 0)``
split as ``(total // 2, total - total // 2)``. That is asymmetric
wherever the total is odd: (2, 3) for the 7x7/s2 stem on 224, (0, 1) for
a 3x3/s2 convolution or the pool on an even input (the pool pads with
-inf). PyTorch's ``padding=`` pads both sides equally, which gives the
same output shape with every window shifted by a pixel, so odd totals
are padded explicitly and the convolution or pool then runs unpadded.

BatchNorm (``ops/fused_bn.py``): ``BatchNorm`` when ``fused_bn=false``
(autograd through the plain forward), ``FusedBatchNorm`` when true (the
two-pass backward: the kernels on the card). ``forward(x, train=...)``
returns ``(logits, updates)``: in train mode ``updates`` holds the new
running averages by buffer name (``"<module>.mean"`` / ``".var"``), which
the loss function returns as the new ``extras["batch_stats"]``; the
buffers are never written by a forward.

``stem="s2d"`` is the space-to-depth stem: ``space_to_depth(x, 2)``
(channels packed ``(di, dj, c)``) and a 4x4 stride-1 convolution over
4C channels (``stem_s2d``; ``models/convert.py`` ``s2d_stem_weights``
rewrites a 7x7/s2 kernel into it exactly). ``pool_grad="mask"`` is the
stem pool whose backward is the reference's two compare-and-sum passes
in place of autodiff's route-to-the-first-maximum: tied maxima split the
gradient equally (``max_pool_mask_grad``). Both are plain PyTorch: XLA
fused them in the reference; neither was a Pallas kernel.

``param_hooks`` (``parallel/fsdp_overlap.py`` ``BlockGather``, set by
the overlap schedule): each residual block gathers its ``fsdp`` shards
just before its compute, block k's gather posted once block
k - 1 - prefetch has run, and the backward gathers them again rather
than keeping them saved (the reference's policy for the ResNet).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from frl_distributed_ml_scaffold_tpu_torch import resolve_device
from frl_distributed_ml_scaffold_tpu_torch.config.schema import ResNetConfig
from frl_distributed_ml_scaffold_tpu_torch.ops.fused_bn import (
    BatchNorm,
    FusedBatchNorm,
)
from frl_distributed_ml_scaffold_tpu_torch.precision import Policy

STAGE_SIZES = {
    10: (1, 1, 1, 1),
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}
BOTTLENECK = {10: False, 18: False, 34: False, 50: True, 101: True, 152: True}


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """flax ``SAME`` padding (low, high) of one spatial axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _pad_nhwc(x, ph, pw, value=0.0):
    return F.pad(x, (0, 0, pw[0], pw[1], ph[0], ph[1]), value=value)


class Conv(nn.Module):
    """flax ``nn.Conv(features, (k, k), strides, padding="SAME",
    use_bias=False)`` over NHWC; the weight is OIHW (the flax kernel is
    HWIO)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, *,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.empty(
            (cout, cin, k, k), dtype=param_dtype, device=device))

    def forward(self, x):
        ph = same_pads(x.shape[1], self.k, self.stride)
        pw = same_pads(x.shape[2], self.k, self.stride)
        pad = 0
        if ph[0] == ph[1] and pw[0] == pw[1]:
            pad = (ph[0], pw[0])
        else:
            x = _pad_nhwc(x, ph, pw)
        y = F.conv2d(_nchw(x), self.weight.to(x.dtype), stride=self.stride,
                     padding=pad)
        return _nhwc(y)


def max_pool_same(x):
    """flax ``max_pool(x, (3, 3), strides=(2, 2), padding="SAME")`` over
    NHWC: -inf padding, then an unpadded pool; its autodiff routes each
    window's gradient to the first maximum, as XLA's select_and_scatter
    does."""
    ph = same_pads(x.shape[1], 3, 2)
    pw = same_pads(x.shape[2], 3, 2)
    x = _pad_nhwc(x, ph, pw, value=float("-inf"))
    return _nhwc(F.max_pool2d(_nchw(x), 3, 2))


def space_to_depth(x, block: int = 2):
    """NHWC (B, H, W, C) -> (B, H/b, W/b, b*b*C), channels packed
    ``(di, dj, c)`` row-major (the order ``s2d_stem_weights`` assumes)."""
    b, h, w, c = x.shape
    if h % block or w % block:
        raise ValueError(
            f"space_to_depth stem needs spatial dims divisible by {block}; "
            f"got {h}x{w} — use stem='conv7' for odd input sizes")
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, h // block, w // block, block * block * c)


def _check_mask_pool_shape(x) -> None:
    h, w = x.shape[1], x.shape[2]
    if h % 2 or w % 2:
        raise ValueError(
            "pool_grad='mask' needs even pool-INPUT spatial dims (its "
            f"dilation math assumes exact stride-2 coverage); got {h}x{w} "
            "into the stem pool — use pool_grad='scatter' for odd sizes")


def mask_pool_grad(x, y, dy):
    """The gradient of ``max_pool_same`` at ``x`` (output ``y``) for the
    output gradient ``dy``, as the reference's two passes. SAME on even
    dims pads (0, 1), so window p reads inputs 2p + t, t in {0, 1, 2}.
    Pass 1 counts, per window, the entries equal to its max. Pass 2 gives
    each input the sum of ``dy / count`` over the covering windows whose
    max equals it, tap by tap in the reference's order; each tap touches
    the stride-2 grid of its offset only (where the reference dilates
    onto the whole input grid)."""
    ho, wo = y.shape[1], y.shape[2]
    xp = F.pad(x, (0, 0, 0, 2, 0, 2), value=float("-inf"))
    count = torch.zeros(y.shape, dtype=dy.dtype, device=dy.device)
    for th in range(3):
        for tw in range(3):
            patch = xp[:, th: th + 2 * ho - 1: 2, tw: tw + 2 * wo - 1: 2]
            count = count + (patch == y).to(dy.dtype)
    scaled = dy / count  # >= 1: the max is always in its window
    dx = torch.zeros_like(x)
    for th in range(3):
        nh = ho - th // 2  # the last window's third row is padding
        for tw in range(3):
            nw = wo - tw // 2
            at = (slice(None), slice(th, th + 2 * nh - 1, 2),
                  slice(tw, tw + 2 * nw - 1, 2))
            hit = x[at] == y[:, :nh, :nw]
            dx[at] += torch.where(hit, scaled[:, :nh, :nw], 0.0).to(x.dtype)
    return dx


class _MaxPoolMaskGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = max_pool_same(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        return mask_pool_grad(x, y, dy)


def max_pool_mask_grad(x):
    """``max_pool_same`` whose backward is ``mask_pool_grad``: without
    ties it equals autodiff's; tied maxima split the gradient equally
    where autodiff routes it all to the first. Odd dims raise."""
    _check_mask_pool_shape(x)
    return _MaxPoolMaskGrad.apply(x)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (4x filters), each with BatchNorm, the
    last one zero-initialised; a projection (1x1 with the stride, and its
    BatchNorm) where the shape changes."""

    def __init__(self, cin: int, filters: int, strides: int, norm, conv):
        super().__init__()
        out = filters * 4
        self.conv0, self.bn0 = conv(cin, filters, 1), norm(filters)
        self.conv1, self.bn1 = conv(filters, filters, 3, strides), norm(filters)
        self.conv2, self.bn2 = conv(filters, out, 1), norm(out)
        self.proj = cin != out or strides != 1
        if self.proj:
            self.proj_conv = conv(cin, out, 1, strides)
            self.proj_bn = norm(out)

    def forward(self, x, train: bool, updates: dict):
        y = F.relu(self.bn0(self.conv0(x), train=train, updates=updates))
        y = F.relu(self.bn1(self.conv1(y), train=train, updates=updates))
        y = self.bn2(self.conv2(y), train=train, updates=updates)
        if self.proj:
            x = self.proj_bn(self.proj_conv(x), train=train, updates=updates)
        return F.relu(x + y)


class BasicBlock(nn.Module):
    """3x3 (stride) -> 3x3, each with BatchNorm, the last one
    zero-initialised; a projection where the shape changes."""

    def __init__(self, cin: int, filters: int, strides: int, norm, conv):
        super().__init__()
        self.conv0, self.bn0 = conv(cin, filters, 3, strides), norm(filters)
        self.conv1, self.bn1 = conv(filters, filters, 3), norm(filters)
        self.proj = cin != filters or strides != 1
        if self.proj:
            self.proj_conv = conv(cin, filters, 1, strides)
            self.proj_bn = norm(filters)

    def forward(self, x, train: bool, updates: dict):
        y = F.relu(self.bn0(self.conv0(x), train=train, updates=updates))
        y = self.bn1(self.conv1(y), train=train, updates=updates)
        if self.proj:
            x = self.proj_bn(self.proj_conv(x), train=train, updates=updates)
        return F.relu(x + y)


class ResNet(nn.Module):
    """ResNet of ``config.depth`` over NHWC images of ``in_channels``
    channels. Params in ``policy.param_dtype``; the images, and the
    params where they are used, in ``policy.compute_dtype``; logits in
    ``policy.output_dtype``. ``device=None`` means ``cuda`` and raises
    without a card. Weights are uninitialised: load them
    (``models/convert.py``)."""

    def __init__(self, config: ResNetConfig, policy: Policy, *,
                 in_channels: int = 3, param_hooks=None, device=None):
        super().__init__()
        if config.stem not in ("conv7", "s2d"):
            raise ValueError(f"unknown ResNet stem {config.stem!r}; expected "
                             "'conv7' or 's2d'")
        if config.pool_grad not in ("scatter", "mask"):
            raise ValueError(f"unknown pool_grad {config.pool_grad!r}; "
                             "expected 'scatter' or 'mask'")
        if config.depth not in STAGE_SIZES:
            raise KeyError(f"unknown ResNet depth {config.depth}; have "
                           f"{sorted(STAGE_SIZES)}")
        dev = resolve_device(device)
        self.config, self.policy = config, policy
        cd, pd = policy.compute_dtype, policy.param_dtype
        bn_cls = FusedBatchNorm if config.fused_bn else BatchNorm

        def norm(c):
            return bn_cls(c, momentum=0.9, epsilon=1e-5, dtype=cd,
                          param_dtype=pd, device=dev)

        def conv(cin, cout, k, stride=1):
            return Conv(cin, cout, k, stride, param_dtype=pd, device=dev)

        width = 64 * config.width_multiplier
        if config.stem == "s2d":
            self.stem_s2d = conv(4 * in_channels, width, 4, 1)
        else:
            self.stem_conv = conv(in_channels, width, 7, 2)
        self.stem_bn = norm(width)
        block_cls = BottleneckBlock if BOTTLENECK[config.depth] else BasicBlock
        blocks, cin = [], width
        for stage, n_blocks in enumerate(STAGE_SIZES[config.depth]):
            filters = width * 2 ** stage
            for b in range(n_blocks):
                strides = 2 if (b == 0 and stage > 0) else 1
                blocks.append(block_cls(cin, filters, strides, norm, conv))
                cin = filters * (4 if block_cls is BottleneckBlock else 1)
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, config.num_classes, device=dev, dtype=pd)
        for name, mod in self.named_modules():
            if isinstance(mod, BatchNorm):
                mod.stats_name = name + "."
        self.param_hooks = param_hooks

    def attach(self, *, param_hooks=None) -> None:
        """Hook the blocks to the blockwise FSDP gathers (module
        docstring)."""
        self.param_hooks = param_hooks

    def batch_norms(self) -> list[BatchNorm]:
        return [m for m in self.modules() if isinstance(m, BatchNorm)]

    def forward(self, x, *, train: bool = False, rng: int | None = None):
        """``x`` [B, H, W, C] -> ``(logits [B, classes], updates)``. The
        ResNet has no dropout: ``rng`` is taken, as every family's
        forward takes it, and not read."""
        del rng
        cd = self.policy.compute_dtype
        updates: dict[str, torch.Tensor] = {}
        x = x.to(cd)
        if self.config.stem == "s2d":
            x = self.stem_s2d(space_to_depth(x, 2))
        else:
            x = self.stem_conv(x)
        x = F.relu(self.stem_bn(x, train=train, updates=updates))
        if self.config.pool_grad == "mask":
            x = max_pool_mask_grad(x)
        else:
            x = max_pool_same(x)
        hooks = self.param_hooks
        if hooks is None:
            for block in self.blocks:
                x = block(x, train, updates)
        else:
            hooks.start((f"blocks.{i}.", dict(b.named_parameters()))
                        for i, b in enumerate(self.blocks))
            for k, block in enumerate(self.blocks):
                hooks.begin(k)
                with (hooks.no_save() if torch.is_grad_enabled()
                      else contextlib.nullcontext()):
                    x = functional_call(block, hooks.params(
                        k, dict(block.named_parameters())), (x, train, updates))
        x = x.mean(dim=(1, 2))  # global average pool
        x = F.linear(x, self.head.weight.to(cd), self.head.bias.to(cd))
        return x.to(self.policy.output_dtype), updates
