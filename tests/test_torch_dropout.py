"""Training dropout in the port (frl_distributed_ml_scaffold_tpu_torch/
models/dropout.py, at the sites of models/gpt.py, vit.py, video.py and
mlp.py; the seeds from trainer/train_step.py).

The masks come from torch generators and cannot be JAX's, so they are
held to their distribution and to flax's formula, not to JAX's bits:

- ``dropout`` is flax's ``where(keep, x / (1 - rate), 0)`` bit for bit
  on the same mask (fp32 and bf16); the ViT's attention-probability site
  is flax's ``p * (keep / (1 - rate))`` in the compute dtype;
- every site of each family's training forward draws a mask whose kept
  share lies within 6 binomial standard deviations of ``1 - rate``
  (``sqrt(rate (1 - rate) / n)``; a false alarm has odds below 1e-8);
- eval, and ``rate`` 0, are the forward without dropout, bit for bit,
  with no generator made;
- the same seed gives the same masks, another seed others; the train
  step seeds each step and microbatch apart;
- gradients under remat (``trainer.remat`` full / dots, the GPT's
  ``model.block_remat`` full / save_attn) equal the gradients without
  remat at the same seed, bit for bit on the CPU: each site's generator
  is made inside the recomputed region.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY, TINY_VIDEO, TINY_VIT, recipe_pair

from frl_distributed_ml_scaffold_tpu_torch.config import schema as tschema
from frl_distributed_ml_scaffold_tpu_torch.models import convert, create_model
from frl_distributed_ml_scaffold_tpu_torch.models import dropout as tdrop
from frl_distributed_ml_scaffold_tpu_torch.models import vit as tvit
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
from frl_distributed_ml_scaffold_tpu_torch.trainer import tasks as ttasks
from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
    make_grad_fn,
)

RATE = 0.25
SIGMAS = 6


def _within_binomial(mask: torch.Tensor, rate: float) -> bool:
    n = mask.numel()
    share = mask.float().mean().item()
    return abs(share - (1 - rate)) <= SIGMAS * math.sqrt(rate * (1 - rate)
                                                         / n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_is_flax_formula(dtype):
    """The site's output is ``where(keep, x / keep_prob, 0)`` computed
    by JAX on the same mask and input; the kept values are x scaled by
    ``1 / (1 - rate)``, the dropped ones 0."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 300)).astype(np.float32))
    x = x.to(dtype)
    got = tdrop.dropout(x, RATE, 7, 3, 1)
    keep = tdrop.keep_mask(x.shape, RATE, 7, 3, 1, device="cpu")
    assert _within_binomial(keep, RATE)
    jx = jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = jnp.where(jnp.asarray(keep.numpy()), jx / (1.0 - RATE), 0)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert got.dtype == dtype
    assert torch.equal(got[~keep], torch.zeros_like(got[~keep]))


def test_attention_probability_site_is_flax_formula():
    """The ViT's attention-probability site multiplies by ``keep /
    keep_prob`` in the compute dtype, as flax's ``dot_product_attention``
    does: the attention output equals that product on the recorded
    mask."""
    torch.manual_seed(0)
    attn = tvit.MultiHeadAttention(32, 4, get_policy("bf16_mixed"), "cpu",
                                   dropout=RATE)
    x = torch.randn(2, 9, 32)
    got = attn(x, seed=5, layer=1)
    keep = tdrop.keep_mask((2, 4, 9, 9), RATE, 5, 1, 0, device="cpu")
    cd = torch.bfloat16
    b, n, d = x.shape
    q, k, v = (tvit._dense(p, x, cd).view(b, n, 4, 8)
               for p in (attn.query, attn.key, attn.value))
    q = q / torch.tensor(math.sqrt(8), dtype=cd)
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
    p = p * (keep.to(cd) / torch.tensor(1 - RATE, dtype=cd))
    o = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, n, d)
    assert torch.equal(got, tvit._dense(attn.out, o, cd))


def _family(name: str, rate: float):
    """(port model on the CPU with seeded weights, a batch, its loss)."""
    gen = torch.Generator().manual_seed(0)
    pol = get_policy("fp32")
    if name == "gpt":
        cfg = tschema.GPTConfig(**TINY, dropout=rate)
        model = create_model(cfg, pol, device="cpu")
        model.load_state_dict(convert.init_params(cfg, gen))
        toks = torch.randint(0, TINY["vocab_size"], (2, 33), generator=gen)
        return model, {"tokens": toks}, ttasks.make_lm_loss(model)
    recipe, ov = {"vit": ("imagenet_vitb_fsdp", TINY_VIT),
                  "video": ("ego4d_video_elastic", TINY_VIDEO),
                  "mlp": ("mnist_mlp", ["model.hidden_sizes=64,32"])}[name]
    _, tcfg = recipe_pair(recipe, ov + [f"model.dropout={rate}"])
    kw = {"in_features": 784} if name == "mlp" else {}
    model = create_model(tcfg.model, pol, device="cpu", **kw)
    init = getattr(convert, f"init_{name}_params")
    model.load_state_dict(init(tcfg.model, gen, **kw))
    shape = {"vit": (2, 32, 32, 3), "video": (2, 4, 32, 32, 3),
             "mlp": (2, 28, 28, 1)}[name]
    key = "video" if name == "video" else "image"
    batch = {key: torch.randn(shape, generator=gen),
             "label": torch.tensor([1, 3])}
    return model, batch, ttasks.make_classification_loss(model, key)


# Sites per family: (layer, site) keys of one training forward.
def _expected_sites(name: str) -> set:
    if name == "gpt":
        n = TINY["num_layers"]
        return {(n, 0)} | {(i, s) for i in range(n) for s in (0, 1)}
    if name == "mlp":
        return {(0, 0), (1, 0)}
    return {(2, 0)} | {(i, s) for i in range(2) for s in (0, 1, 2)}


FAMILIES = ["gpt", "vit", "video", "mlp"]


@pytest.fixture
def recorded(monkeypatch):
    """Every mask drawn, by its site ``(layer, site)``, with its seed."""
    masks = []
    real = tdrop.keep_mask

    def spy(shape, rate, seed, *site, device):
        m = real(shape, rate, seed, *site, device=device)
        masks.append((seed, site, m))
        return m

    monkeypatch.setattr(tdrop, "keep_mask", spy)
    monkeypatch.setattr(tvit, "keep_mask", spy)
    return masks


@pytest.mark.parametrize("name", FAMILIES)
def test_each_site_keeps_its_share(name, recorded):
    """One training forward draws one mask at every site of the JAX
    model (GPT: the embedding, each block's attention output and
    ``fc_out``; ViT / video: the embedding, the attention probabilities,
    after the GELU and after the MLP; MLP: after each hidden ReLU), each
    within the binomial bound; the output differs from eval's."""
    model, batch, loss_fn = _family(name, RATE)
    params = dict(model.named_parameters())
    with torch.no_grad():
        loss, _ = loss_fn(params, {}, batch, 11, True)
        ref, _ = loss_fn(params, {}, batch, None, False)
    assert {site for _, site, _ in recorded} == _expected_sites(name)
    assert len(recorded) == len(_expected_sites(name))
    for seed, site, m in recorded:
        assert seed == 11
        assert _within_binomial(m, RATE), (site, m.float().mean())
    assert float(loss) != float(ref)


@pytest.mark.parametrize("name", FAMILIES)
def test_eval_and_rate_zero_are_the_plain_forward(name, recorded):
    """Eval with dropout configured, and training with dropout 0 (seed
    given or not), are the forward without dropout bit for bit, and no
    mask is drawn."""
    model, batch, loss_fn = _family(name, RATE)
    plain, _, plain_loss = _family(name, 0.0)
    params = dict(model.named_parameters())
    with torch.no_grad():
        want, _ = plain_loss(params, {}, batch, None, False)
        for fn, rng, train in ((loss_fn, None, False),
                               (plain_loss, 5, True),
                               (plain_loss, None, True)):
            got, _ = fn(params, {}, batch, rng, train)
            assert torch.equal(got, want)
    assert recorded == []


@pytest.mark.parametrize("name", FAMILIES)
def test_same_seed_same_masks(name):
    model, batch, loss_fn = _family(name, RATE)
    params = dict(model.named_parameters())
    with torch.no_grad():
        a, _ = loss_fn(params, {}, batch, 3, True)
        b, _ = loss_fn(params, {}, batch, 3, True)
        c, _ = loss_fn(params, {}, batch, 4, True)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_train_step_seeds_each_step_and_microbatch(recorded):
    """``make_grad_fn`` hands microbatch i of step s the seed
    ``mix_seed(seed, s, i)``: every (step, microbatch) draws other
    masks, and the same (seed, step) the same ones."""
    model, batch, loss_fn = _family("mlp", RATE)
    params = {k: p.detach() for k, p in model.named_parameters()}
    batch = {k: torch.cat([v, v]) for k, v in batch.items()}
    grad_fn = make_grad_fn(loss_fn, get_policy("fp32"), grad_accum=2,
                           seed=9, device="cpu")
    for step in (0, 1, 0):
        grad_fn(params, {}, batch, step)
    seeds = [s for s, site, _ in recorded if site == (0, 0)]
    want = [tdrop.mix_seed(9, s, i) for s in (0, 1, 0) for i in (0, 1)]
    assert seeds == want
    assert len(set(seeds)) == 4


def _grads(name: str, remat: str, block_remat: str = "none"):
    model, batch, loss_fn = _family(name, RATE)
    if block_remat != "none":
        model.config = dataclasses.replace(model.config,
                                           block_remat=block_remat)
    params = {k: p.detach() for k, p in model.named_parameters()}
    grad_fn = make_grad_fn(loss_fn, get_policy("fp32"), remat=remat,
                           seed=1, device="cpu")
    loss, _, _, grads = grad_fn(params, {}, batch, 2)
    return loss, grads


@pytest.mark.parametrize("name,remat,block_remat", [
    ("gpt", "full", "none"), ("gpt", "dots", "none"),
    ("gpt", "none", "full"), ("gpt", "none", "save_attn"),
    ("gpt", "full", "save_attn"),
    ("vit", "full", "none"), ("video", "full", "none"),
    ("mlp", "full", "none")])
def test_remat_grads_equal_plain_grads_under_dropout(name, remat,
                                                     block_remat):
    """The recompute draws the masks the forward drew: loss and every
    gradient equal the run without remat, bit for bit."""
    want_loss, want = _grads(name, "none")
    got_loss, got = _grads(name, remat, block_remat)
    assert torch.equal(got_loss, want_loss)
    for k, g in want.items():
        assert torch.equal(got[k], g), k
