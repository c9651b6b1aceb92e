"""The shard loaders and the s2d stem / mask pool on the card against the
port's CPU path, which test_torch_native.py, test_torch_shards.py and
test_torch_resnet_s2d.py hold to the JAX package:

- ImageNet shards through the prefetching pipeline onto the card (the
  pinned side-stream copy) equal the host batches bit for bit;
- the mask pool's gradient on the card equals the CPU's bit for bit
  (elementwise passes in a fixed order), ties included;
- a depth-10 ResNet with ``stem=s2d pool_grad=mask`` (fp32, TF32 off):
  train-mode logits and every parameter's gradient on the card against
  the CPU, from the same seeded weights and input.

Marked ``cuda`` and skipped without a card. This file imports no JAX, so
it runs on a machine that has none; there, skip the repository conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_data_cuda.py

Tolerances: logits and gradients within 1e-4 of each tensor's largest
CPU entry (cuDNN and the CPU sum the convolutions in other orders, 10
layers of train-mode BatchNorm deep).
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import numpy as np
import pytest
import torch

from frl_distributed_ml_scaffold_tpu_torch.config import schema
from frl_distributed_ml_scaffold_tpu_torch.data import pipeline
from frl_distributed_ml_scaffold_tpu_torch.data.shards import sealed_save
from frl_distributed_ml_scaffold_tpu_torch.models import resnet
from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
    init_resnet_params,
)
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

TOL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card against the CPU)")


@pytest.mark.cuda
def test_shard_batches_on_the_card_equal_the_host_batches(tmp_path):
    _card()
    rng = np.random.default_rng(0)
    for i in range(2):
        sealed_save(str(tmp_path / f"train_images_{i:03d}.npy"),
                    rng.integers(0, 256, (16, 40, 40, 3), dtype=np.uint8))
        sealed_save(str(tmp_path / f"train_labels_{i:03d}.npy"),
                    rng.integers(0, 10, 16).astype(np.int32))
    cfg = schema.DataConfig(name="imagenet", image_size=32, channels=3,
                            num_classes=10, global_batch_size=8, prefetch=2,
                            data_dir=str(tmp_path))
    card = pipeline.build_pipeline(cfg, device="cuda")
    host = pipeline.DataPipeline(cfg, device="cpu")
    assert isinstance(card, pipeline.PrefetchingPipeline)
    assert not card.source.is_synthetic
    try:
        for step in (0, 1, 2, 5):
            got = card.global_batch(step)
            want = host.local_batch(step)
            for k, v in want.items():
                assert got[k].device.type == "cuda"
                np.testing.assert_array_equal(got[k].cpu().numpy(), v)
    finally:
        card.close()


@pytest.mark.cuda
def test_mask_pool_gradient_on_the_card_equals_the_cpu():
    _card()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.integers(0, 3, (4, 16, 12, 8)).astype(
        np.float32))  # many ties
    dy = torch.from_numpy(rng.standard_normal((4, 8, 6, 8)).astype(
        np.float32))
    grads = []
    for dev in ("cpu", "cuda"):
        xd = x.to(dev).requires_grad_()
        g, = torch.autograd.grad(resnet.max_pool_mask_grad(xd), xd,
                                 dy.to(dev))
        grads.append(g.cpu())
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
def test_s2d_mask_resnet_on_the_card_matches_the_cpu():
    _card()
    cfg = schema.ResNetConfig(depth=10, num_classes=10, stem="s2d",
                              pool_grad="mask")
    params, extras = init_resnet_params(cfg,
                                        torch.Generator().manual_seed(0))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((8, 32, 32, 3)).astype(
        np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 10)).astype(np.float32))
    backends = torch.backends.cudnn, torch.backends.cuda.matmul
    tf32 = [b.allow_tf32 for b in backends]
    for b in backends:
        b.allow_tf32 = False
    weights = {**params, **extras["batch_stats"]}
    out = []
    try:
        for dev in ("cpu", "cuda"):
            model = resnet.ResNet(cfg, get_policy("fp32"), device=dev)
            model.load_state_dict({k: v.to(dev) for k, v in weights.items()})
            logits, _ = model(x.to(dev), train=True)
            (logits * w.to(dev)).sum().backward()
            out.append((logits.detach().cpu(), {
                k: p.grad.cpu() for k, p in model.named_parameters()}))
    finally:
        for b, v in zip(backends, tf32):
            b.allow_tf32 = v
    (cpu_logits, cpu_grads), (card_logits, card_grads) = out
    scale = cpu_logits.abs().max().clamp(min=1.0)
    assert (card_logits - cpu_logits).abs().max() <= TOL * scale
    assert card_grads.keys() == cpu_grads.keys()
    for name, g in cpu_grads.items():
        err = (card_grads[name] - g).abs().max().item()
        assert err <= TOL * g.abs().max().item() + 1e-7, (name, err)
