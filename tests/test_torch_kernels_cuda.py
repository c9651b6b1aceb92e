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


def _paged_inputs(dtype, t=None, bs=16, m=8):
    """q, pools [B*m + 1, bs, H, D] (block 0 trash), shuffled tables,
    occupancies 1, a block edge + 1, m*bs and past m*bs (a retired
    row)."""
    rng = np.random.default_rng(6)
    n = B * m + 1
    qshape = (B, H, D) if t is None else (B, t, H, D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to("cuda", dtype)
               for s in (qshape, (n, bs, H, D), (n, bs, H, D)))
    tables = torch.from_numpy(
        (rng.permutation(n - 1) + 1).reshape(B, m).astype(np.int32)).cuda()
    kv_len = torch.tensor([1 if t is None else t, bs + 1, m * bs,
                           m * bs + 7], dtype=torch.int32, device="cuda")
    return q, k, v, kv_len, tables


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["decode", "verify"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_kernels_match_plain_versions(op, dtype):
    """On the card: the paged decode and verify kernels against their
    plain versions, with occupancy past the table; unreferenced blocks
    full of NaN leave the output bit-identical; verify query 0 is the
    decode kernel's output bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    tdt = getattr(torch, dtype)
    t = 5 if op == "verify" else None
    router = getattr(tda, f"paged_{op}_attention")
    plain = getattr(tda, f"dense_paged_{op}_attention")
    q, k, v, kv_len, tables = _paged_inputs(tdt, t)
    before = router.launches
    got = router(q, k, v, kv_len, tables)
    want = plain(q, k, v, kv_len, tables)
    torch.cuda.synchronize()
    assert router.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=0)
    # NaN in every block no row's occupancy reaches.
    bs = k.shape[1]
    used = torch.zeros(k.shape[0], dtype=torch.bool, device="cuda")
    for row, n in enumerate(kv_len.clamp(max=tables.shape[1] * bs).tolist()):
        used[tables[row, : (n - 1) // bs + 1].long()] = True
    kd, vd = k.clone(), v.clone()
    kd[~used], vd[~used] = float("nan"), float("nan")
    assert torch.equal(router(q, kd, vd, kv_len, tables), got)
    if op == "verify":
        dec = tda.paged_decode_attention(q[:, 0].contiguous(), k, v,
                                         kv_len - 4, tables)
        assert torch.equal(got[:, 0], dec)
