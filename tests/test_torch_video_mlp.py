"""The port's video classifier and MLP (frl_distributed_ml_scaffold_tpu_
torch/models/video.py, mlp.py), their weights, recipes and data (data/
synthetic.py ``SyntheticVideo``, data/video.py, data/mnist.py) against
the JAX package, on the CPU, inputs from a numpy seed.

- Video: a tiny classifier cut from ``ego4d_video_elastic`` by the same
  overrides in both packages (4 frames of 32 px, tubelet (2, 8, 8), D =
  64, 2 layers, 4 heads, 10 classes), the JAX init's params (biases and
  LayerNorm scales moved by 0.1 N(0, 1)) carried across with
  ``video_params_from_jax``; logits and three ``make_train_step`` steps
  (the recipe's AdamW, clip, warmup into a cosine, ``remat=full``) on
  ``SyntheticVideo`` clips, fp32 and bf16_mixed.
- MLP: ``mnist_mlp`` as published (784 -> 512 -> 256 -> 10), logits and
  three steps on synthetic MNIST under fp32 (the recipe's) and
  bf16_mixed; its ``FlopCounterMode`` count.
- The converters fill every parameter, the inits follow the JAX inits'
  distributions, ``SyntheticVideo``, ``VideoClips`` and ``MNIST``
  batches (synthetic, ``mnist.npz``, IDX gzipped and raw, files the test
  writes) equal the JAX package's bit for bit, and streaming clip
  shards are refused.

Tolerances (``_torch_parity.LOGIT_TOL`` / ``TRAIN_TOL``, shared with
test_torch_vit.py, whose docstring says why bf16 differs and why Adam's
bound holds some leaves), set from the largest difference measured here:
- logits, relative to max(1, max|ref|): fp32 1e-5 (measured: video
  2.8e-7, MLP 3.8e-7); bf16_mixed 3e-2 (video 7.4e-3, MLP 3.5e-3).
- train steps, fp32: loss and grad_norm 3e-5 relative (video 1.9e-7 and
  7.4e-7, MLP 5.6e-6 and 2.4e-6), accuracies equal; params 1e-5
  absolute (video 2.4e-7, MLP 4.7e-7), their mean 1e-6 (1.8e-8); the
  video's key bias (exact gradient 0) to Adam's bound, twice the summed
  lr (measured 1.3 % of it). bf16_mixed: loss and grad_norm 2e-2
  relative (video 3.5e-4 and 8.3e-4, MLP 8.4e-4 and 1.1e-3); params
  within Adam's bound (video 50 %, its key bias 95 %, MLP 79 % of it),
  their mean within 5 % of it (video 0.4 %, MLP 0.7 %).
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import dataclasses
import functools
import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _jit import jit_init
from _torch_parity import (
    LOGIT_TOL,
    TRAIN_TOL,
    TINY_TRAIN,
    TINY_VIDEO,
    hold_train,
    jax_init_perturbed,
    jax_train,
    port_train,
    recipe_pair,
)

from frl_distributed_ml_scaffold_tpu.config import schema as jschema
from frl_distributed_ml_scaffold_tpu.data.mnist import MNIST as JaxMNIST
from frl_distributed_ml_scaffold_tpu.data.synthetic import (
    SyntheticVideo as JaxSyntheticVideo,
)
from frl_distributed_ml_scaffold_tpu.models.mlp import MLP as JaxMLP
from frl_distributed_ml_scaffold_tpu.models.video import (
    VideoClassifier as JaxVideo,
)
from frl_distributed_ml_scaffold_tpu.precision import get_policy as jax_policy
from frl_distributed_ml_scaffold_tpu_torch.config import schema as tschema
from frl_distributed_ml_scaffold_tpu_torch.data.mnist import MNIST
from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticVideo
from frl_distributed_ml_scaffold_tpu_torch.data.video import VideoClips
from frl_distributed_ml_scaffold_tpu_torch.models import create_model
from frl_distributed_ml_scaffold_tpu_torch.models import video as tvideo
from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
    init_mlp_params,
    init_video_params,
    mlp_params_from_jax,
    video_params_from_jax,
)
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
from frl_distributed_ml_scaffold_tpu_torch.trainer import tasks as ttasks
from frl_distributed_ml_scaffold_tpu_torch.trainer.train_step import (
    make_grad_fn,
)

VIDEO_BATCH, MLP_BATCH, STEPS = 4, 16, 3
VIDEO_SHAPE = (1, 4, 32, 32, 3)


def _video_configs(policy: str = "bf16_mixed"):
    return recipe_pair("ego4d_video_elastic", TINY_VIDEO + TINY_TRAIN + [
        f"data.global_batch_size={VIDEO_BATCH}",
        f"precision.policy={policy}"])


def _mlp_configs(policy: str = "fp32"):
    return recipe_pair("mnist_mlp", TINY_TRAIN + [
        f"data.global_batch_size={MLP_BATCH}", f"precision.policy={policy}"])


@functools.lru_cache(maxsize=None)
def _video_params() -> dict:
    j, _ = _video_configs()
    return jax_init_perturbed(JaxVideo(j.model, jax_policy("fp32")),
                              np.zeros(VIDEO_SHAPE, np.float32))


@functools.lru_cache(maxsize=None)
def _mlp_params() -> dict:
    j, _ = _mlp_configs()
    return jax_init_perturbed(JaxMLP(j.model, jax_policy("fp32")),
                              np.zeros((1, 28, 28, 1), np.float32))


def _clips(cfg, n: int = STEPS) -> list:
    data = VideoClips(cfg.data, split="train")
    return [data.batch(s, VIDEO_BATCH) for s in range(n)]


def _digits(cfg, n: int = STEPS) -> list:
    data = MNIST(cfg.data, split="train")
    return [data.batch(s, MLP_BATCH) for s in range(n)]


FAMILIES = {
    # family: (configs, JAX model, params, converter, batches, input key)
    "video": (_video_configs, JaxVideo, _video_params, video_params_from_jax,
              _clips, "video"),
    "mlp": (_mlp_configs, JaxMLP, _mlp_params, mlp_params_from_jax, _digits,
            "image"),
}


@pytest.mark.parametrize("policy", ["fp32", "bf16_mixed"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_match_jax(family, policy):
    configs, jcls, params_fn, convert, batches, key = FAMILIES[family]
    j, t = configs(policy)
    params = params_fn()
    x = batches(t, 1)[0][key]
    jmodel = jcls(j.model, jax_policy(policy))
    want = np.asarray(jax.jit(
        lambda p, x: jmodel.apply({"params": p}, x))(params, x))
    model = create_model(t.model, get_policy(policy), device="cpu")
    model.load_state_dict(convert(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = float(np.abs(got.numpy() - want).max())
    assert err <= LOGIT_TOL[policy] * max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("policy", ["fp32", "bf16_mixed"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_steps_match_jax(family, policy):
    """Three steps of the recipe's optimizer (and, for video, its
    ``remat=full``): loss, accuracy, grad_norm and lr per step, every
    param after the last."""
    configs, jcls, params_fn, convert, batches, _ = FAMILIES[family]
    j, t = configs(policy)
    params, data = params_fn(), batches(t)
    ref = jax_train(j, jcls(j.model, jax_policy(policy)), params, data)
    ref["params"] = convert(ref["params"])
    model = create_model(t.model, get_policy(policy), device="cpu")
    got = port_train(t, model, convert(params), data)
    assert ref["lr"][0] == 0.0 and got["state"].step == STEPS
    hold_train(got, ref, **TRAIN_TOL[policy])


def test_converters_fill_every_parameter():
    for family, (configs, _, params_fn, convert, _, _) in FAMILIES.items():
        _, t = configs()
        params = params_fn()
        sd = convert(params)
        model = create_model(t.model, get_policy("fp32"), device="cpu")
        assert sd.keys() == model.state_dict().keys(), family
        model.load_state_dict(sd)
        assert sum(v.numel() for v in sd.values()) == sum(
            np.size(v) for v in jax.tree.leaves(params)), family
    conv = _video_params()["Conv_0"]["kernel"]  # (t, h, w, C, D)
    np.testing.assert_array_equal(
        video_params_from_jax(_video_params())["embed.weight"].view(
            64, 2, 8, 8, 3).numpy(), conv.transpose(4, 0, 1, 2, 3))


def test_inits_follow_the_jax_inits():
    """``init_video_params`` / ``init_mlp_params``: the JAX init's shapes
    in the port's names, zero biases, unit LayerNorm scales, normal(0.02)
    position embeddings, truncated lecun-normal kernels whose spread
    matches the JAX init's."""
    jv, tv = _video_configs()
    jm, tm = _mlp_configs()
    cases = [
        (init_video_params(tv.model, torch.Generator().manual_seed(0)),
         video_params_from_jax(jax.device_get(jit_init(
             JaxVideo(jv.model, jax_policy("fp32")),
             jnp.zeros(VIDEO_SHAPE))["params"]))),
        (init_mlp_params(tm.model, torch.Generator().manual_seed(0)),
         mlp_params_from_jax(jax.device_get(jit_init(
             JaxMLP(jm.model, jax_policy("fp32")),
             jnp.zeros((1, 28, 28, 1)))["params"]))),
    ]
    for sd, ref in cases:
        assert {k: v.shape for k, v in sd.items()} == {
            k: v.shape for k, v in ref.items()}
        for name, v in sd.items():
            if name == "pos_embedding":
                assert abs(float(v.std()) / 0.02 - 1) < 0.1
            elif name.endswith(".bias"):
                assert torch.equal(v, torch.zeros_like(v)), name
            elif v.dim() == 1:
                assert torch.equal(v, torch.ones_like(v)), name
            else:
                std = (1.0 / v.shape[1]) ** 0.5
                assert float(v.abs().max()) <= 2 * std / 0.8796256610342398
                if v.numel() >= 4096:
                    assert abs(float(v.std()) / std - 1) < 0.1, name
                    assert abs(float(v.std()) / float(ref[name].std())
                               - 1) < 0.1, name


def test_mlp_flops():
    """``FlopCounterMode`` over one forward and backward of ``mnist_mlp``
    at batch B: 6 B (784 512 + 512 256 + 256 10), less the first layer's
    input gradient (2 B 784 512), which no one asks for: the input is
    data."""
    _, t = _mlp_configs()
    model = create_model(t.model, get_policy("fp32"), device="cpu")
    sd = init_mlp_params(t.model, torch.Generator().manual_seed(0))
    grad_fn = make_grad_fn(ttasks.make_loss_fn(model, t.data.name),
                           get_policy("fp32"), device="cpu")
    with FlopCounterMode(display=False) as counter:
        grad_fn(sd, {}, _digits(t, 1)[0])
    b = MLP_BATCH
    assert counter.get_total_flops() == (
        6 * b * (784 * 512 + 512 * 256 + 256 * 10) - 2 * b * 784 * 512)


def test_synthetic_video_matches_jax():
    """``SyntheticVideo`` batches (and ``VideoClips``' without a
    ``data_dir``) are the JAX ones, bit for bit."""
    for split in ("train", "eval"):
        cfg = dict(name="video_synthetic", image_size=8, channels=3,
                   num_frames=3, num_classes=5, shuffle_seed=2)
        j = JaxSyntheticVideo(jschema.DataConfig(**cfg), split=split)
        t = SyntheticVideo(tschema.DataConfig(**cfg), split=split)
        clips = VideoClips(tschema.DataConfig(**cfg), split=split)
        np.testing.assert_array_equal(t.prototypes, j.prototypes)
        for step, off in ((0, 0), (4, 0), (1, 2)):
            want = j.batch(step, 3, off)
            for got in (t.batch(step, 3, off), clips.batch(step, 3, off)):
                assert got.keys() == want.keys() == {"video", "label"}
                assert got["video"].dtype == np.float32
                assert got["label"].dtype == np.int32
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])
    # A streaming corpus with no sealed pair: the JAX loader's refusal.
    from frl_distributed_ml_scaffold_tpu.data.video import (
        VideoClips as JaxVideoClips,
    )

    empty = dict(name="video", data_dir="/data", streaming=True)
    with pytest.raises(ValueError, match="no sealed") as terr:
        VideoClips(tschema.DataConfig(**empty), split="train")
    with pytest.raises(ValueError) as jerr:
        JaxVideoClips(jschema.DataConfig(**empty), split="train")
    assert str(terr.value) == str(jerr.value)


def _idx(path, arr: np.ndarray, opener=open):
    header = bytes([0, 0, 8, arr.ndim]) + b"".join(
        int(n).to_bytes(4, "big") for n in arr.shape)
    with opener(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


@pytest.mark.parametrize("source", ["synthetic", "npz", "idx_gz", "idx_raw"])
def test_mnist_matches_jax(tmp_path, source):
    """``MNIST`` batches equal the JAX package's bit for bit: the
    synthetic fallback, and real files the test writes (``mnist.npz``;
    the four IDX files gzipped, and raw), both splits."""
    rng = np.random.default_rng(7)
    data = {split: (rng.integers(0, 256, (n, 28, 28), dtype=np.uint8),
                    rng.integers(0, 10, n, dtype=np.uint8))
            for split, n in (("train", 50), ("t10k", 20))}
    if source == "npz":
        np.savez(tmp_path / "mnist.npz", x_train=data["train"][0],
                 y_train=data["train"][1], x_test=data["t10k"][0],
                 y_test=data["t10k"][1])
    elif source.startswith("idx"):
        gz = source == "idx_gz"
        for prefix, (x, y) in data.items():
            ext = ".gz" if gz else ""
            _idx(tmp_path / f"{prefix}-images-idx3-ubyte{ext}", x,
                 gzip.open if gz else open)
            _idx(tmp_path / f"{prefix}-labels-idx1-ubyte{ext}", y,
                 gzip.open if gz else open)
    cfg = dict(name="mnist", shuffle_seed=3,
               data_dir=None if source == "synthetic" else str(tmp_path))
    for split in ("train", "eval"):
        j = JaxMNIST(jschema.DataConfig(**cfg), split=split)
        t = MNIST(tschema.DataConfig(**cfg), split=split)
        assert t.is_synthetic == j.is_synthetic == (source == "synthetic")
        for step, off in ((0, 0), (3, 1)):
            want, got = j.batch(step, 6, off), t.batch(step, 6, off)
            assert got.keys() == want.keys() == {"image", "label"}
            assert got["image"].shape == (6, 28, 28, 1)
            assert got["image"].dtype == np.float32
            assert got["label"].dtype == np.int32
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


def test_refusals():
    """The video classifier builds and runs with the collective-matmul
    hooks. Training dropout, in it and in the MLP, runs with a seed and
    raises without one."""
    _, tv = _video_configs()
    _, tm = _mlp_configs()
    pol = get_policy("fp32")
    # The collective-matmul hooks build and run: out of a mesh the rings
    # are this rank's local products, so the hooked model is the plain.
    from frl_distributed_ml_scaffold_tpu_torch.parallel.tp_overlap import (
        TpHooks,
    )

    plain = tvideo.VideoClassifier(tv.model, pol, device="cpu")
    plain.load_state_dict(init_video_params(tv.model, torch.Generator()))
    hooked = tvideo.VideoClassifier(tv.model, pol,
                                    tp_overlap=TpHooks(chunk_axis=0),
                                    device="cpu")
    hooked.load_state_dict(plain.state_dict())
    clip = torch.randn(VIDEO_SHAPE, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(hooked(clip), plain(clip), rtol=1e-6,
                               atol=1e-6)
    for cfg, x in ((tv.model, torch.zeros(VIDEO_SHAPE)),
                   (tm.model, torch.zeros(1, 28, 28, 1))):
        model = create_model(dataclasses.replace(cfg, dropout=0.1), pol,
                             device="cpu")
        with pytest.raises(ValueError, match="needs a seed"):
            model(x, train=True)
        # The weights are left uninitialised: only the shape is read.
        assert model(x, train=True, rng=0).shape == (1, cfg.num_classes)
