"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda`` and skipped without a card (a CUDA kernel has no CPU
mode). This file imports no JAX, so it also runs on a machine that has
none; there, skip the repository conftest (which sets up JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py

Tolerances as in test_torch_decode_attention.py: fp32 1e-5, bf16 2e-2.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention as tda

B, S, H, D = 4, 64, 4, 32
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    """On the card: the CUDA kernel against the plain version, including
    occupancy past capacity and a strided cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, D), (B, S, H, D), (B, S, H, D)))
    kv_len = np.asarray([1, 33, S, S + 1], np.int32)
    q = torch.from_numpy(q).to("cuda", tdt)
    big = torch.zeros(B, 2 * S, H, D, device="cuda", dtype=tdt)
    k_, v_ = big.clone(), big.clone()
    k_[:, :S] = torch.from_numpy(k).to("cuda", tdt)
    v_[:, :S] = torch.from_numpy(v).to("cuda", tdt)
    k_, v_ = k_[:, :S], v_[:, :S]
    lens = torch.from_numpy(kv_len).cuda()
    before = tda.decode_attention.launches
    got = tda.decode_attention(q, k_, v_, lens)
    want = tda.dense_decode_attention(q, k_, v_, lens)
    torch.cuda.synchronize()
    assert tda.decode_attention.launches == before + 1
    torch.testing.assert_close(
        got.float(), want.float(), atol=TOL[dtype], rtol=0
    )
