"""Fused AdamW: the port of the JAX package's ``ops/fused_adamw.py``.

One optimizer step of AdamW on one parameter leaf in one pass: read g,
m, v and p, write p', m' and v' (fp32). g may be bf16 (the step's cast
under ``precision.policy=bf16``): it is widened to fp32 as it is read,
as the JAX ``_update_leaf`` upcasts it. ``FusedAdamW`` runs it over a dict
of leaves with the JAX package's schedule rules: the learning rate is
read at the count BEFORE it increments, the bias correction uses the
incremented count, as ``optax.adamw`` does.

Two versions of the per-leaf update:

- ``adamw_math``, the plain PyTorch version (the counterpart of
  ``_adamw_math``): the CPU takes it, and the card holds the kernel
  against it (``chip_smoke.py``);
- the hand-written CUDA kernel of ``csrc/fused_adamw.cu``
  (``frl_fused_adamw``, replacing the TPU's ``_kernel``), launched by
  ``adamw_kernel``, which counts its launches in
  ``adamw_kernel.launches``.

``update_leaf`` routes as the JAX package does: a leaf on the card with
at least 65536 elements (the TPU kernel's one 512 x 128 block) takes the
kernel; every other leaf (BatchNorm scales, biases) takes
``adamw_math``, by design and not as a fallback. A leaf on the CPU
always takes ``adamw_math``. A failed build or launch raises.
"""

from __future__ import annotations

import ctypes

import torch

from frl_distributed_ml_scaffold_tpu_torch.ops import _build

# The smallest leaf that takes the kernel (the JAX package's _BLOCK_ROWS x
# _LANES, its one-block minimum; a routing rule, not a tile size).
MIN_KERNEL_ELEMENTS = 512 * 128


def adamw_math(g, m, v, p, lr, bc1, bc2, *, b1, b2, eps, wd):
    """The update formula -> (p', m', v'), fp32; ``optax.adamw`` exactly:
    scale_by_adam (bias-corrected), add_decayed_weights, the learning
    rate."""
    g = g.float()
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * (g * g)
    mhat = m / bc1
    vhat = v / bc2
    p_new = p - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * p)
    return p_new, m, v


def _check_leaf(p, g, m, v):
    """What the kernel takes: fp32 p, m and v, 16-byte aligned; g fp32
    (16-byte aligned) or bf16 (8-byte aligned), read in place; all of
    p's shape and device, contiguous."""
    for name, t in (("p", p), ("m", m), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(
                f"the AdamW kernel takes float32 p, m and v, {name} is "
                f"{t.dtype} (a bf16 p comes only from a bf16 init: "
                "trainer.init_params_path, ROADMAP queue A item 15, which "
                "the port's loop refuses)")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the AdamW kernel takes a float32 or bfloat16 g, "
                        f"got {g.dtype}")
    for name, t in (("p", p), ("g", g), ("m", m), ("v", v)):
        if t.shape != p.shape or t.device != p.device:
            raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}, p is "
                             f"{tuple(p.shape)} on {p.device}")
        align = 8 if t.dtype == torch.bfloat16 else 16
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"the AdamW kernel needs contiguous leaves, "
                             f"{align}-byte aligned; {name} is not")


def adamw_kernel(p, g, m, v, lr, bc1, bc2, *, b1, b2, eps, wd) -> None:
    """Launch the kernel on CUDA leaves (fp32 p, m, v; fp32 or bf16 g):
    p, m and v updated in place."""
    _check_leaf(p, g, m, v)
    fn = _build.load("fused_adamw").frl_fused_adamw
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
                       + [ctypes.c_float] * 9 + [ctypes.c_void_p])
    err = fn(p.data_ptr(), g.data_ptr(), int(g.dtype == torch.bfloat16),
             m.data_ptr(), v.data_ptr(), p.numel(), lr, bc1, bc2, b1, 1.0 - b1,
             b2, 1.0 - b2, eps, wd,
             torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise _build.KernelError(
            f"fused AdamW kernel launch failed: CUDA error {err}")
    adamw_kernel.launches += 1


adamw_kernel.launches = 0


def update_leaf(g, m, v, p, lr, bc1, bc2, *, b1, b2, eps, wd) -> None:
    """One leaf's update, in place on p, m and v: the kernel for a leaf
    on the card of at least ``MIN_KERNEL_ELEMENTS``, else
    ``adamw_math``."""
    if p.device.type == "cuda" and p.numel() >= MIN_KERNEL_ELEMENTS:
        adamw_kernel(p, g, m, v, lr, bc1, bc2, b1=b1, b2=b2, eps=eps, wd=wd)
        return
    if p.device.type not in ("cuda", "cpu"):
        raise ValueError(f"fused AdamW runs on cpu or cuda, not {p.device}")
    pn, mn, vn = adamw_math(g, m, v, p.float(), lr, bc1, bc2, b1=b1, b2=b2,
                            eps=eps, wd=wd)
    p.copy_(pn)
    m.copy_(mn)
    v.copy_(vn)


class FusedAdamW:
    """AdamW as one pass per leaf over a dict of fp32 parameters, updated
    in place; the interface of ``trainer.optimizers.AdamW`` (no clip: the
    global-norm clip is a separate pass over every leaf, so the optimizer
    factory refuses the combination).

    State: ``{"count": int, "mu": {name: tensor}, "nu": {name: tensor}}``
    (fp32). ``count`` is a host integer, so lr and the bias corrections
    are host floats and no step reads the card back."""

    def __init__(self, schedule, *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params: dict) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()},
            "nu": {k: torch.zeros_like(p, dtype=torch.float32)
                   for k, p in params.items()},
        }

    def scalars(self, count: int) -> tuple[float, float, float]:
        """(lr, bc1, bc2) of the step taken at ``count``."""
        t = count + 1
        return (float(self.schedule(count)), 1.0 - self.b1 ** t,
                1.0 - self.b2 ** t)

    def update(self, grads: dict, state: dict, params: dict,
               norm: torch.Tensor | None = None) -> dict:
        """One step into ``params`` and the moments, in place; ``norm``
        is accepted for the step's interface and unused. Returns the
        state (the same dicts, count advanced)."""
        del norm
        lr, bc1, bc2 = self.scalars(state["count"])
        for k, p in params.items():
            update_leaf(grads[k], state["mu"][k], state["nu"][k], p, lr, bc1,
                        bc2, b1=self.b1, b2=self.b2, eps=self.eps,
                        wd=self.weight_decay)
        state["count"] += 1
        return state
