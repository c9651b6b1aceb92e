"""``trainer.init_params_path`` in the port: the flax msgpack reader and
writer (frl_distributed_ml_scaffold_tpu_torch/checkpoint/
flax_msgpack.py) against flax's ``serialization``, the inverse
converters (models/convert.py), the ``Trainer``'s checks and load
against the JAX ``Trainer`` from the same file, and a bf16 p through
``FusedAdamW`` against JAX ``fused_adamw``'s plain path.

Tolerances:
- the bytes and the restored arrays: equal, bit for bit;
- the port ``Trainer`` from a file against the JAX ``Trainer`` from the
  same file, fp32: the first loss and the params after 3 steps as
  ``test_torch_loop.py`` holds the two loops (``TRAIN_TOL["fp32"]``:
  3e-5 relative on the loss, 1e-5 absolute on the params, measured
  below 1e-6), the key bias (no gradient but noise, ROADMAP C.7) to
  twice the Adam bound as ``test_torch_train_step.py`` holds it;
- bf16 params through ``fused_adamw``: the first loss to 2e-2 relative
  (``TRAIN_TOL["bf16_mixed"]``: the frameworks round bf16 at different
  places in the forward); each param after 3 steps within 2 bf16 ulps
  plus twice the sum of the learning rates applied, the most a
  disagreeing Adam direction can move it (as ``test_torch_train_step.py``
  holds bf16);
- ``FusedAdamW`` on bf16 p against JAX's plain path on the same inputs:
  p' within one bf16 ulp (both round an fp32 result to nearest even;
  the fp32 results differ by ~1e-7, which moves a rounding boundary
  rarely), m' and v' to 1e-6 absolute.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from _jit import jit_init
from _torch_parity import (
    TINY,
    TINY_VIT,
    TRAIN_TOL,
    jax_params,
    jax_resnet_variables,
    recipe_pair,
)

from frl_distributed_ml_scaffold_tpu.config import schema as jschema
from frl_distributed_ml_scaffold_tpu.models.mlp import MLP as JaxMLP
from frl_distributed_ml_scaffold_tpu.models.vit import ViT as JaxViT
from frl_distributed_ml_scaffold_tpu.ops import fused_adamw as jfa
from frl_distributed_ml_scaffold_tpu.precision import get_policy as jax_policy
from frl_distributed_ml_scaffold_tpu.trainer.loop import Trainer as JaxTrainer
from frl_distributed_ml_scaffold_tpu_torch.checkpoint import flax_msgpack
from frl_distributed_ml_scaffold_tpu_torch.config import schema as tschema
from frl_distributed_ml_scaffold_tpu_torch.models import convert
from frl_distributed_ml_scaffold_tpu_torch.ops import fused_adamw as tfa
from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _to_bf16(tree):
    return jax.tree.map(lambda x: np.asarray(x).astype(ml_dtypes.bfloat16),
                        tree)


def _trees() -> dict:
    """Real flax params trees of each family the port trains."""
    resnet = jax_resnet_variables(10, 10, 32)["params"]
    vcfg = jschema.ViTConfig(image_size=32, patch_size=8, hidden_dim=64,
                             num_layers=2, num_heads=4, num_classes=10)
    vit = jit_init(JaxViT(vcfg, jax_policy("fp32")),
                   jnp.zeros((1, 32, 32, 3)), train=False)["params"]
    mlp = jit_init(JaxMLP(jschema.MLPConfig(hidden_sizes=(32, 16)),
                          jax_policy("fp32")), jnp.zeros((1, 784)),
                   train=False)["params"]
    return {"gpt": _np_tree(jax_params()), "resnet": _np_tree(resnet),
            "vit": _np_tree(vit), "mlp": _np_tree(mlp)}


TREES = _trees()


def _assert_same_tree(got, want, path=""):
    """``got`` (the port's tensors) equals ``want`` (flax's numpy
    restore): the same keys in the same order, dtypes, shapes, bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
        return
    want = np.asarray(want)
    assert isinstance(got, torch.Tensor), path
    name = str(got.dtype).replace("torch.", "")
    assert name == want.dtype.name, (path, name, want.dtype)
    assert tuple(got.shape) == want.shape, path
    raw = got.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    assert raw == want.tobytes(), path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", sorted(TREES))
def test_bytes_match_flax_both_ways(family, dtype):
    """flax's ``to_bytes`` read by the port equals flax's own restore;
    the port's ``dumps`` of the same tree (as numpy, and as tensors) is
    ``to_bytes``'s bytes exactly."""
    tree = TREES[family] if dtype == "float32" else _to_bf16(TREES[family])
    data = serialization.to_bytes(tree)
    _assert_same_tree(flax_msgpack.loads(data),
                      serialization.msgpack_restore(data))
    assert flax_msgpack.dumps(tree) == data
    assert flax_msgpack.dumps(flax_msgpack.loads(data)) == data


def test_edge_leaves_and_the_chunked_form(monkeypatch, tmp_path):
    """0-d arrays, numpy scalars, empty arrays and maps, int32, long
    keys; and arrays over the chunk size, stored as flax's chunked map
    (the chunk size lowered in both packages): bytes equal both ways,
    and ``load`` from a file as ``loads``."""
    rng = np.random.default_rng(0)
    tree = {"a": {"kernel": rng.standard_normal((3, 40)).astype(np.float32),
                  "empty": np.zeros((0, 4), np.float32)},
            "scalar": np.asarray(3.5, np.float32), "np_scalar": np.int32(7),
            "bf": rng.standard_normal((50,)).astype(ml_dtypes.bfloat16),
            "ints": np.arange(300, dtype=np.int32).reshape(3, 100),
            "nothing": {}, "k" * 40: np.ones((2,), np.int8)}
    for size in (serialization.MAX_CHUNK_SIZE, 64):
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", size)
        monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", size)
        data = serialization.to_bytes(tree)
        assert (b"__msgpack_chunked_array__" in data) == (size == 64)
        assert flax_msgpack.dumps(tree) == data
        restored = serialization.msgpack_restore(data)
        _assert_same_tree(flax_msgpack.loads(data), restored)
        path = tmp_path / f"p{size}.msgpack"
        with open(path, "wb") as fh:
            flax_msgpack.dump(tree, fh)
        assert path.read_bytes() == data
        _assert_same_tree(flax_msgpack.load(str(path)), restored)
    with pytest.raises(TypeError, match="tuple"):
        flax_msgpack.dumps({"t": (1, 2)})


def test_load_aliases_one_buffer(tmp_path):
    """Every leaf is a view of the one buffer the bytes were read into,
    not a copy: zeroing the buffer zeroes the leaves; ``load`` keeps the
    leaves of a file inside one allocation of the file's size."""
    data = serialization.to_bytes(TREES["gpt"])
    buf = bytearray(data)
    tree = flax_msgpack.loads(buf)
    wte = tree["wte"]["embedding"]
    assert wte.abs().sum() > 0
    buf[:] = bytes(len(buf))
    assert wte.abs().sum() == 0 and tree["wpe"].abs().sum() == 0
    path = tmp_path / "p.msgpack"
    path.write_bytes(data)
    leaves = [x for x in jax.tree.leaves(flax_msgpack.load(str(path)))]
    lo = min(x.data_ptr() for x in leaves)
    hi = max(x.data_ptr() + x.numel() * x.element_size() for x in leaves)
    assert hi - lo <= len(data)


@pytest.mark.parametrize("family", sorted(TREES))
def test_inverse_converters_round_trip(family):
    """``*_params_to_jax`` of the port's state dict is the flax tree it
    came from, leaf for leaf (the shapes the Trainer checks a file
    against)."""
    tree = TREES[family]
    flat = dict(_paths(tree))
    if family == "gpt":
        cfg = tschema.GPTConfig(**TINY)
        back = convert.params_to_jax(convert.params_from_jax(tree, cfg), cfg)
    elif family == "resnet":
        stats = jax_resnet_variables(10, 10, 32)["batch_stats"]
        params, extras = convert.resnet_params_from_jax(tree, stats)
        back, back_stats = convert.resnet_params_to_jax(
            params, extras, tschema.ResNetConfig(depth=10, num_classes=10))
        assert dict(_paths(back_stats)).keys() == dict(_paths(stats)).keys()
    elif family == "vit":
        vcfg = tschema.ViTConfig(image_size=32, patch_size=8, hidden_dim=64,
                                 num_layers=2, num_heads=4, num_classes=10)
        back = convert.vit_params_to_jax(convert.vit_params_from_jax(tree),
                                         vcfg)
    else:
        back = convert.mlp_params_to_jax(convert.mlp_params_from_jax(tree))
    got = dict(_paths(back))
    assert got.keys() == flat.keys()
    for k, v in flat.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def _paths(tree, path=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


MLP_OV = ["model.hidden_sizes=32,16", "data.global_batch_size=8",
          "trainer.total_steps=3", "trainer.log_every=1",
          "trainer.eval_every=0"]


@pytest.mark.parametrize("case", ["tree", "shape"])
def test_mismatched_file_raises_jax_message(tmp_path, case):
    """A file whose tree or shapes differ from the model's raises the JAX
    trainer's ``ValueError``, word for word (its key paths too), before
    anything is converted."""
    tree = jax.tree.map(np.copy, TREES["mlp"])
    if case == "tree":
        tree["Dense_9"] = tree.pop("Dense_2")
    else:
        tree["Dense_1"]["kernel"] = np.zeros((32, 17), np.float32)
    path = tmp_path / "bad.msgpack"
    path.write_bytes(serialization.to_bytes(tree))
    jcfg, tcfg = recipe_pair("mnist_mlp", MLP_OV + [
        f"trainer.init_params_path={path}", f"workdir={tmp_path}"])
    with pytest.raises(ValueError) as jerr:
        JaxTrainer(jcfg).init_state()
    with pytest.raises(ValueError) as terr:
        Trainer(tcfg, device="cpu").init_state()
    assert str(terr.value) == str(jerr.value)
    assert "Dense_" in str(terr.value)


@pytest.mark.parametrize("family", ["resnet", "vit", "mlp"])
def test_trainer_loads_each_family(tmp_path, family):
    """The port's ``Trainer`` starts from the file's params, cast to the
    policy's param dtype (bf16 under ``precision.policy=bf16``): equal to
    the file's leaves converted, the EMA too."""
    name, ov = {
        "resnet": ("imagenet_rn50_ddp", [
            "model.depth=10", "model.num_classes=10", "data.image_size=32",
            "data.num_classes=10", "data.global_batch_size=4"]),
        "vit": ("imagenet_vitb_fsdp", TINY_VIT + [
            "data.global_batch_size=4"]),
        "mlp": ("mnist_mlp", MLP_OV),
    }[family]
    path = tmp_path / "p.msgpack"
    path.write_bytes(serialization.to_bytes(TREES[family]))
    _, tcfg = recipe_pair(name, ov + [
        f"trainer.init_params_path={path}", "precision.policy=bf16",
        "trainer.ema_decay=0.5", f"workdir={tmp_path}"])
    state = Trainer(tcfg, device="cpu").init_state()
    tree = TREES[family]
    if family == "resnet":
        want = convert.resnet_params_from_jax(
            tree, jax_resnet_variables(10, 10, 32)["batch_stats"])[0]
    elif family == "vit":
        want = convert.vit_params_from_jax(tree)
    else:
        want = convert.mlp_params_from_jax(tree)
    assert state.params.keys() == want.keys()
    for k, w in want.items():
        assert state.params[k].dtype == torch.bfloat16, k
        assert torch.equal(state.params[k], w.bfloat16()), k
        assert torch.equal(state.ema_params[k], w.bfloat16()), k


GPT_OV = ["model.num_layers=2", "model.hidden_dim=128", "model.num_heads=4",
          "model.vocab_size=512", "model.seq_len=128", "data.seq_len=128",
          "data.vocab_size=512", "data.global_batch_size=8",
          "trainer.grad_accum=2", "model.attention=dense",
          "trainer.total_steps=3", "trainer.log_every=1",
          "trainer.eval_every=0", "optimizer.warmup_steps=1",
          "optimizer.learning_rate=1e-3"]
BF16_FUSED = ["precision.policy=bf16", "optimizer.name=fused_adamw",
              "optimizer.grad_clip_norm=null",
              "parallel.opt_sharding=like_params"]


def _records(run_dir):
    with open(run_dir / "metrics.jsonl") as fh:
        return [json.loads(line) for line in fh]


@pytest.mark.parametrize("policy", ["fp32", "bf16_fused_adamw"])
def test_trainer_from_file_matches_jax_trainer(tmp_path, policy):
    """A tiny ``gpt2_medium_zero1`` from the same params file in both
    packages: the first step's loss, and every param after 3 steps. Under
    ``precision.policy=bf16`` with ``fused_adamw`` the params load as
    bf16 and take the AdamW kernel's bf16-p path (its plain version
    here; JAX's plain path, as on every backend but the TPU): p stays
    bf16, m and v fp32."""
    path = tmp_path / "gpt.msgpack"
    path.write_bytes(serialization.to_bytes(TREES["gpt"]))
    ov = GPT_OV + [f"trainer.init_params_path={path}"]
    if policy == "fp32":
        ov += ["precision.policy=fp32"]
    else:
        ov += BF16_FUSED
    jcfg, _ = recipe_pair("gpt2_medium_zero1", ov + [
        f"workdir={tmp_path / 'jax'}"])
    _, tcfg = recipe_pair("gpt2_medium_zero1", ov + [
        f"workdir={tmp_path / 'port'}"])
    jt = JaxTrainer(jcfg)
    jstate, _ = jt.fit()
    tt = Trainer(tcfg, device="cpu")
    tstate, _ = tt.fit()
    jrec = _records(tmp_path / "jax" / jcfg.name)
    trec = _records(tmp_path / "port" / tcfg.name)
    want = convert.params_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32),
                     jax.device_get(jstate.params)), tcfg.model)
    lr_sum = sum(tt.schedule(c) for c in range(3))
    if policy == "fp32":
        tol = TRAIN_TOL["fp32"]
        np.testing.assert_allclose(trec[0]["loss"], jrec[0]["loss"],
                                   rtol=tol["loss"])
        for k, w in want.items():
            # The key bias gets no gradient but noise (ROADMAP C.7):
            # twice the Adam bound, as test_torch_train_step.py holds it.
            atol = (4 * lr_sum if k.endswith("attn.key.bias")
                    else tol["param_max"])
            np.testing.assert_allclose(tstate.params[k].numpy(), w.numpy(),
                                       atol=atol, rtol=0, err_msg=k)
        return
    np.testing.assert_allclose(trec[0]["loss"], jrec[0]["loss"],
                               rtol=TRAIN_TOL["bf16_mixed"]["loss"])
    assert isinstance(tt.tx, tfa.FusedAdamW)
    for k, w in want.items():
        p = tstate.params[k]
        assert p.dtype == torch.bfloat16, k
        assert tstate.opt_state["mu"][k].dtype == torch.float32, k
        assert tstate.opt_state["nu"][k].dtype == torch.float32, k
        bound = 2 * _bf16_ulp(w.numpy()) + 2 * lr_sum
        assert (np.abs(p.float().numpy() - w.numpy()) <= bound).all(), k


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def test_fused_adamw_bf16_params_match_jax_plain_path():
    """``FusedAdamW`` over bf16 params (leaves above and below the
    kernel's 65536-element minimum) against JAX ``fused_adamw`` on the
    CPU, its plain path, over 3 steps of bf16 gradients: p' bf16, m' and
    v' fp32 in both."""
    shapes = {"bias": (64,), "min": (512, 128), "ragged": (3, 5, 4373)}
    sched = lambda c: 1e-2 * (c + 1)  # noqa: E731
    jtx = jfa.fused_adamw(sched, b2=0.95, weight_decay=0.1)
    ttx = tfa.FusedAdamW(sched, b2=0.95, weight_decay=0.1)
    rng = np.random.default_rng(5)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in params.items()}
    jst = jtx.init(jp)
    tp = {k: torch.from_numpy(v).bfloat16() for k, v in params.items()}
    tst = ttx.init(tp)
    for _ in range(3):
        g = {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
             for k, s in shapes.items()}
        jp, jst = jtx.fused_apply(
            {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in g.items()},
            jst, jp)
        ttx.update({k: torch.from_numpy(v).bfloat16() for k, v in g.items()},
                   tst, tp)
    for k in shapes:
        assert jp[k].dtype == jnp.bfloat16 and tp[k].dtype == torch.bfloat16
        assert jst.mu[k].dtype == jnp.float32
        assert tst["mu"][k].dtype == tst["nu"][k].dtype == torch.float32
        want = np.asarray(jp[k].astype(jnp.float32))
        diff = np.abs(tp[k].float().numpy() - want)
        assert (diff <= _bf16_ulp(want)).all(), k
        for got, ref in ((tst["mu"][k], jst.mu[k]), (tst["nu"][k], jst.nu[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       atol=1e-6, rtol=0, err_msg=k)
