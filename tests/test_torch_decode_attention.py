"""The port's decode attention (frl_distributed_ml_scaffold_tpu_torch/ops/
decode_attention.py) held against the JAX package's split-KV Pallas
kernel, run in interpret mode on the CPU.

Inputs are made from a numpy seed and handed to both packages. On the CPU
the port's wrapper takes its plain version (the CUDA kernel runs only on
the card: tests/test_torch_kernels_cuda.py and ``chip_smoke.py``).

Tolerances: fp32 1e-5 (summation order and exp only); bf16 2e-2 (both
round the output to bf16, ulp 2^-7 relative at |o| <= 4, and the Pallas
kernel rounds unnormalised probabilities where the plain version rounds
normalised ones).
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frl_distributed_ml_scaffold_tpu_torch.ops import _build
from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as tda

# The JAX package's ops/__init__ re-exports the decode_attention FUNCTION,
# which shadows the submodule attribute on every ``import ... as`` form.
jda = importlib.import_module(
    "frl_distributed_ml_scaffold_tpu.ops.decode_attention"
)

B, S, H, D = 4, 64, 4, 32
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
OCCUPANCY = {
    "one": [1, 1, 1, 1],
    "mid": [17, 40, 5, 63],
    "full": [S, S, S, S],
    "past_capacity": [S + 9, 3, S, S + 100],
    "mixed": [1, 33, S, S + 1],
}


def _inputs(seed: int, kv_len):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, H, D)).astype(np.float32)
    v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    return q, k, v, np.asarray(kv_len, np.int32)


def _jax(q, k, v, kv_len, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    out = jda._local_decode(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(kv_len), impl="flash", interpret=True,
    )
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, kv_len, dtype, **kw):
    tdt = getattr(torch, dtype)
    out = tda.decode_attention(
        torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt),
        torch.from_numpy(v).to(tdt), torch.from_numpy(kv_len), **kw,
    )
    assert out.dtype == tdt and out.shape == (B, H, D)
    return out.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("occupancy", sorted(OCCUPANCY))
def test_decode_attention_matches_pallas_kernel(dtype, occupancy):
    q, k, v, kv_len = _inputs(0, OCCUPANCY[occupancy])
    np.testing.assert_allclose(
        _port(q, k, v, kv_len, dtype), _jax(q, k, v, kv_len, dtype),
        atol=TOL[dtype], rtol=0,
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_garbage_past_occupancy_does_not_change_the_output(dtype):
    """Positions >= kv_len contribute exactly zero: fill them with large
    garbage and the port's output is bit-identical, and still agrees with
    the Pallas kernel on the clean cache."""
    q, k, v, kv_len = _inputs(1, OCCUPANCY["mixed"])
    clean = _port(q, k, v, kv_len, dtype)
    kd, vd = k.copy(), v.copy()
    for row, n in enumerate(kv_len):
        kd[row, min(n, S):] = 1e4
        vd[row, min(n, S):] = -1e4
    np.testing.assert_array_equal(_port(q, kd, vd, kv_len, dtype), clean)
    np.testing.assert_allclose(
        clean, _jax(q, k, v, kv_len, dtype), atol=TOL[dtype], rtol=0
    )


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    q, k, v, kv_len = _inputs(2, OCCUPANCY["mid"])
    tda.decode_attention.launches = 0
    flash = _port(q, k, v, kv_len, "float32")
    dense = _port(q, k, v, kv_len, "float32", impl="dense")
    assert tda.decode_attention.launches == 0
    np.testing.assert_array_equal(flash, dense)


def test_flash_clamps_zero_occupancy_to_one():
    """kv_len 0 attends position 0 (the JAX router's clamp), i.e. returns
    v[:, 0]; the explicit dense impl does not clamp."""
    q, k, v, _ = _inputs(3, OCCUPANCY["one"])
    zero = np.zeros(B, np.int32)
    np.testing.assert_allclose(
        _port(q, k, v, zero, "float32"), v[:, 0], atol=1e-6, rtol=0
    )


def test_refusals():
    q, k, v, kv_len = (
        torch.from_numpy(a) for a in _inputs(4, OCCUPANCY["mid"])
    )
    with pytest.raises(ValueError, match="must be passed together"):
        tda.decode_attention(q, k, v, kv_len, k_scale=kv_len)
    with pytest.raises(KeyError, match="unknown decode_attention impl"):
        tda.decode_attention(q, k, v, kv_len, impl="paged")


@pytest.mark.parametrize(
    "case",
    ["head_dim", "dtype", "kv_mismatch", "kv_len_dtype", "head_stride"],
)
def test_kernel_argument_checks(case):
    """What the CUDA kernel does not take is refused in Python before any
    pointer is handed over (checked here on CPU tensors)."""
    q = torch.zeros(B, H, D)
    k = torch.zeros(B, S, H, D)
    v = torch.zeros(B, S, H, D)
    kv_len = torch.ones(B, dtype=torch.int32)
    if case == "head_dim":
        q, k, v = q[..., :16], k[..., :16], v[..., :16]
        err = ValueError
    elif case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
        err = TypeError
    elif case == "kv_mismatch":
        v = torch.zeros(B, 2 * S, H, D)[:, :S]
        err = ValueError
    elif case == "kv_len_dtype":
        kv_len = kv_len.long()
        err = ValueError
    else:
        k = torch.zeros(B, S, D, H).transpose(2, 3)
        v = torch.zeros(B, S, D, H).transpose(2, 3)
        err = ValueError
    with pytest.raises(err):
        tda._check_kernel_args(q, k, v, kv_len)


def test_kernel_sources_are_found_and_named_by_content():
    assert "decode_attention" in _build.sources()
    path = _build.library_path("decode_attention")
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path("decode_attention")


def test_a_build_without_a_toolkit_raises_a_kernel_error(monkeypatch,
                                                         tmp_path):
    """No nvcc: the build raises ``KernelError``, which
    ``is_device_failure`` tells from other errors (a CUDA runtime
    error's text included)."""
    from torch.utils import cpp_extension

    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(_build.KernelError, match="no CUDA toolkit") as info:
        _build.build_all(["decode_attention"])
    assert _build.is_device_failure(info.value)
    assert _build.is_device_failure(
        RuntimeError("CUDA error: an illegal memory access was encountered"))
    assert not _build.is_device_failure(RuntimeError("draft model crashed"))
    assert not _build.is_device_failure(ValueError("bad window"))


@pytest.mark.parametrize(
    "bh, s, sms, want",
    [
        (128, 1024, 132, 1),  # the serving path: 8 slots x 16 heads
        (264, 4096, 132, 1),  # B*H >= 2 x SMs
        (32, 1024, 132, 4),   # 2 slots
        (32, 512, 132, 2),    # capped at one split per 256 positions
        (16, 4096, 132, 8),   # one slot: capped at the cluster size
        (16, 128, 132, 1),    # one bucket of 128: no split
        (66, 4096, 132, 2),
        (1, 1, 132, 1),
    ],
)
def test_decode_split_count_rule(bh, s, sms, want):
    """The contiguous kernel's split count: about one CTA per SM in all,
    1 from B*H >= SMs, at most 8 (one cluster), one per 256 positions."""
    got = tda.decode_splits(bh, s, sms)
    assert got == want
    assert 1 <= got <= tda.MAX_DECODE_SPLITS


@pytest.mark.parametrize("case", ["misaligned_base", "position_stride"])
def test_kernel_refuses_caches_it_cannot_read_16_bytes_at_a_time(case):
    """k and v must be 16-byte aligned with strides in multiples of 16
    bytes: the kernel reads 8 bf16 (4 fp32) per load. The wrapper raises
    rather than copying the cache; q may be any unit-stride view."""
    q = torch.zeros(B, H, 3 * D, dtype=torch.bfloat16)[..., D: 2 * D]
    kv_len = torch.ones(B, dtype=torch.int32)
    n = B * S * H * D
    if case == "misaligned_base":
        flat = torch.zeros(n + 8, dtype=torch.bfloat16)
        off = next(i for i in range(1, 8) if flat[i:].data_ptr() % 16)
        k = flat[off: off + n].view(B, S, H, D)
    else:
        # Each position's [H, D] followed by 4 bf16 (8 bytes) of padding.
        k = torch.zeros(B, S, H * D + 4, dtype=torch.bfloat16)[..., : H * D]
        k = k.unflatten(2, (H, D))
    with pytest.raises(ValueError, match="16 bytes at a time"):
        tda._check_kernel_args(q, k, k, kv_len)
    aligned = torch.zeros(B, S, H, D, dtype=torch.bfloat16)
    tda._check_kernel_args(q, aligned, aligned.clone(), kv_len)
