"""The ViT, the video classifier and the MLP on the card against the
port's CPU path, which test_torch_vit.py and test_torch_video_mlp.py hold
to the JAX package: one ``make_grad_fn`` pass and one AdamW update of
each, from the same seeded weights and batch, fp32 and bf16_mixed, at the
CPU tests' tiny sizes (the MLP as published).

Marked ``cuda`` and skipped without a card. This file imports no JAX, so
it runs on a machine that has none; there, skip the repository conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_models_cuda.py

Tolerances are chip_smoke.py's ``VIT_CHECK_TOL`` (its fp32_vit_check
holds ViT-B at full width to the CPU the same way): the loss relative,
each gradient within ``grad`` of its tensor's largest |g| plus ``floor``
of the largest |g| of any tensor, each param after the update within
twice the lr (Adam's first step is about lr sign(g)).
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import pytest
import torch

from chip_smoke import VIT_CHECK_TOL
from frl_distributed_ml_scaffold_tpu_torch.config import (
    apply_overrides,
    get_config,
)
from frl_distributed_ml_scaffold_tpu_torch.data.imagenet import ImageNet
from frl_distributed_ml_scaffold_tpu_torch.data.mnist import MNIST
from frl_distributed_ml_scaffold_tpu_torch.data.video import VideoClips
from frl_distributed_ml_scaffold_tpu_torch.models import convert, create_model
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
from frl_distributed_ml_scaffold_tpu_torch.trainer.optimizers import (
    global_norm,
    make_optimizer,
)
from frl_distributed_ml_scaffold_tpu_torch.trainer.tasks import make_loss_fn
from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
    make_grad_fn,
)

WARMUP_OFF = ["optimizer.warmup_steps=0", "data.global_batch_size=4"]
CASES = {
    "vit": ("imagenet_vitb_fsdp", ImageNet, {"in_channels": 3}, [
        "model.image_size=32", "model.patch_size=8", "model.hidden_dim=64",
        "model.num_layers=2", "model.num_heads=4", "model.num_classes=10",
        "data.image_size=32", "data.num_classes=10"]),
    "video": ("ego4d_video_elastic", VideoClips, {"in_channels": 3}, [
        "model.image_size=32", "model.num_frames=4",
        "model.tubelet_size=2,8,8", "model.hidden_dim=64",
        "model.num_layers=2", "model.num_heads=4", "model.num_classes=10",
        "data.image_size=32", "data.num_frames=4", "data.num_classes=10"]),
    "mlp": ("mnist_mlp", MNIST, {"in_features": 784}, []),
}


def _step(cfg, weights, batch, kw, device):
    """Loss, gradients and params after one update, on ``device``, as
    CPU tensors."""
    policy = get_policy(cfg.precision)
    model = create_model(cfg.model, policy, device=device, **kw)
    params = {k: v.to(device) for k, v in weights.items()}
    tx, schedule = make_optimizer(cfg.optimizer, cfg.trainer, cfg.model)
    grad_fn = make_grad_fn(make_loss_fn(model, cfg.data.name), policy,
                           remat=cfg.trainer.remat, device=device)
    loss, _, _, grads = grad_fn(params, {}, batch)
    tx.update(grads, tx.init(params), params,
              norm=global_norm(grads.values()))
    return (float(loss), {k: g.cpu() for k, g in grads.items()},
            {k: p.cpu() for k, p in params.items()}, schedule(0))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["fp32", "bf16_mixed"])
@pytest.mark.parametrize("family", sorted(CASES))
def test_card_step_matches_the_cpu_step(family, policy):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the card against the CPU)")
    name, source, kw, overrides = CASES[family]
    cfg = apply_overrides(get_config(name), overrides + WARMUP_OFF + [
        f"precision.policy={policy}"])
    init = getattr(convert, f"init_{family}_params")
    weights = init(cfg.model, torch.Generator().manual_seed(0), **kw)
    batch = source(cfg.data, split="train").batch(0, 4)
    tol = VIT_CHECK_TOL[policy]
    loss_c, grads_c, params_c, lr = _step(cfg, weights, batch, kw, "cuda")
    loss, grads, params, _ = _step(cfg, weights, batch, kw, "cpu")
    assert abs(loss_c - loss) <= tol["loss"] * abs(loss)
    floor = tol["floor"] * max(g.abs().max().item() for g in grads.values())
    for k, g in grads.items():
        err = (grads_c[k] - g).abs().max().item()
        assert err <= tol["grad"] * g.abs().max().item() + floor, (k, err)
    for k, p in params.items():
        assert (params_c[k] - p).abs().max().item() <= 2 * lr + 1e-6, k


@pytest.mark.cuda
def test_beam_search_on_the_card_is_greedy_at_one_beam():
    """``beam_search`` on the card (its decode steps through the decode
    kernel) with one beam is greedy ``generate``, fp32, on a tiny seeded
    GPT with ragged prompts: each decode step launches the kernel once a
    layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import GPTConfig
    from frl_distributed_ml_scaffold_tpu_torch.models.generation import (
        beam_search,
        generate,
    )
    from frl_distributed_ml_scaffold_tpu_torch.ops import decode_attention

    cfg = GPTConfig(vocab_size=512, num_layers=2, num_heads=4, hidden_dim=128,
                    seq_len=128, decode_attention="flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = create_model(cfg, get_policy("fp32"), device="cuda")
    model.load_state_dict(convert.init_params(cfg, gen))
    prompt = torch.randint(1, 512, (3, 12), generator=gen, device="cuda")
    prompt[0, :4] = 0
    lens = torch.tensor([8, 12, 12], device="cuda")
    before = decode_attention.decode_attention.launches
    toks, score = beam_search(model, prompt, max_new_tokens=9, num_beams=1,
                              prompt_lengths=lens)
    assert decode_attention.decode_attention.launches - before == 2 * 8
    greedy = generate(model, prompt, max_new_tokens=9, temperature=0.0,
                      prompt_lengths=lens)
    assert torch.equal(toks, greedy)
    assert score.shape == (3,) and torch.isfinite(score).all()
