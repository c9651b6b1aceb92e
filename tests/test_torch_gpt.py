"""The port's GPT decode path (frl_distributed_ml_scaffold_tpu_torch/models/
gpt.py, generation.py, convert.py, config/, precision.py) held against the
JAX package on the same carried-across params.

Tolerances: 1e-4 under ``fp32`` (summation order only). Under
``bf16_mixed`` the two frameworks round bf16 at different places (fused
bias adds, GELU, the Pallas kernel's unnormalised probabilities), so the
bound is the JAX package's own flash-vs-dense bf16 bound: 8 bf16 ulps of
the largest logit, ``8 * eps_bf16 * max(1, max|logit|)``.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import TINY, build_pair, jax_params, pallas_interpret

from frl_distributed_ml_scaffold_tpu.config import recipes as jax_recipes
from frl_distributed_ml_scaffold_tpu.config import schema as jax_schema
from frl_distributed_ml_scaffold_tpu.config.core import (
    apply_overrides as jax_overrides,
)
from frl_distributed_ml_scaffold_tpu.models import generation as jgen
from frl_distributed_ml_scaffold_tpu_torch import config as tconfig
from frl_distributed_ml_scaffold_tpu_torch.config import schema as tschema
from frl_distributed_ml_scaffold_tpu_torch.models import generation as tgen
from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
    init_params,
    params_from_jax,
)
from frl_distributed_ml_scaffold_tpu_torch.models.gpt import GPT, _write_drop
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

BF16_EPS = float(jnp.finfo(jnp.bfloat16).eps)


@pytest.fixture(scope="module")
def params():
    return jax_params()


def _tol(policy, ref):
    if policy == "fp32":
        return 1e-4
    return 8 * BF16_EPS * max(1.0, float(np.abs(ref).max()))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ragged(seed, b=3, t=12, lens=(12, 5, 9)):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, TINY["vocab_size"], (b, t)).astype(np.int32)
    return prompt, np.asarray(lens, np.int32)


@pytest.mark.parametrize("policy", ["fp32", "bf16_mixed"])
def test_prefill_and_decode_match_jax(params, policy):
    """Ragged left-padded prefill, the cache it writes, and three decode
    steps through the decode kernel (Pallas interpret mode on the JAX
    side, the plain version on the port's CPU side)."""
    jm, tm = build_pair(params, policy)
    jm = jm.clone(cache_len=32)
    prompt, lens = _ragged(0)
    with pallas_interpret():
        jl, jc = jgen._prefill(jm, params, jnp.asarray(prompt), jnp.asarray(lens))
        tl, tc = tgen._prefill(
            tm, torch.from_numpy(prompt), torch.from_numpy(lens), cache_len=32
        )
        ref = _f32(jl)
        np.testing.assert_allclose(_f32(tl), ref, atol=_tol(policy, ref), rtol=0)
        # Cache leaves, same names and shapes; K/V compared where occupied.
        jattn = jc["blocks"]["attn"]
        for name in ("cached_key", "cached_value"):
            assert tuple(tc[name].shape) == jattn[name].shape
            j, t = _f32(jattn[name]), _f32(tc[name])
            for row, n in enumerate(lens):
                np.testing.assert_allclose(
                    t[:, row, :n], j[:, row, :n], atol=1e-4 if policy == "fp32"
                    else 4 * BF16_EPS * max(1.0, float(np.abs(j).max())),
                    rtol=0,
                )
        np.testing.assert_array_equal(
            tc["cache_index"].numpy(), np.asarray(jattn["cache_index"])
        )
        np.testing.assert_array_equal(
            tc["pos_index"].numpy(), np.asarray(jc["pos_index"])
        )
        rng = np.random.default_rng(1)
        for _ in range(3):
            tok = rng.integers(0, TINY["vocab_size"], (3,)).astype(np.int32)
            jl, jc = jgen._decode_step(jm, params, jc, jnp.asarray(tok))
            tl, tc = tgen._decode_step(tm, tc, torch.from_numpy(tok))
            ref = _f32(jl)
            np.testing.assert_allclose(
                _f32(tl), ref, atol=_tol(policy, ref), rtol=0
            )


def test_decode_past_capacity_matches_jax(params):
    """Rows decoding past the cache capacity (retired serving slots do):
    writes past S are dropped and attention reads the whole cache, as in
    the JAX model; logits and every cache leaf agree step by step."""
    jm, tm = build_pair(params, "fp32")
    jm = jm.clone(cache_len=16)
    prompt, lens = _ragged(2, lens=(12, 7, 10))
    with pallas_interpret():
        _, jc = jgen._prefill(jm, params, jnp.asarray(prompt), jnp.asarray(lens))
        _, tc = tgen._prefill(
            tm, torch.from_numpy(prompt), torch.from_numpy(lens), cache_len=16
        )
        rng = np.random.default_rng(3)
        for _ in range(7):  # row 0 reaches index 19 > S = 16
            tok = rng.integers(0, TINY["vocab_size"], (3,)).astype(np.int32)
            jl, jc = jgen._decode_step(jm, params, jc, jnp.asarray(tok))
            tl, tc = tgen._decode_step(tm, tc, torch.from_numpy(tok))
            np.testing.assert_allclose(_f32(tl), _f32(jl), atol=1e-4, rtol=0)
    assert int(tc["cache_index"][0, 0]) > 16
    for name in ("cached_key", "cached_value"):
        np.testing.assert_allclose(
            _f32(tc[name]), _f32(jc["blocks"]["attn"][name]), atol=1e-4,
            rtol=0,
        )


@pytest.mark.parametrize("width", [1, 4])
def test_writes_past_capacity_are_dropped_not_clipped(width):
    cache = torch.zeros(2, 8, 1, 1)
    cols = torch.tensor([[6 + j for j in range(width)], [2 + j for j in range(width)]])
    vals = torch.arange(1, 2 * width + 1, dtype=torch.float32).view(2, width, 1, 1)
    _write_drop(cols, [(cache, vals)])
    want = torch.zeros(2, 8)
    for b in range(2):
        for j in range(width):
            c = int(cols[b, j])
            if c < 8:
                want[b, c] = vals[b, j, 0, 0]
    torch.testing.assert_close(cache[..., 0, 0], want, atol=0, rtol=0)


@pytest.mark.parametrize(
    "override",
    [
        {"attention": "ulysses", "pipeline_stages": 2},
        {"attention": "ring", "pipeline_stages": 2},
    ],
    ids=["ulysses", "ring"],
)
def test_unported_model_options_raise(override):
    """Ring and Ulysses run (tests/test_torch_ring_attention.py); inside
    a pipeline they stay refused."""
    cfg = dataclasses.replace(tschema.GPTConfig(**TINY), **override)
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        GPT(cfg, get_policy("fp32"), device="cpu")


@pytest.mark.parametrize(
    "override",
    [
        {"moe": tschema.MoEConfig(num_experts=4), "pipeline_stages": 2},
        {"pipeline_stages": 2},
    ],
    ids=["moe", "pipeline"],
)
def test_pipeline_model_options_build_and_run(params, override):
    """A pipeline (and MoE inside one) builds and runs: the pipelined
    model on the plain model's weights gives the plain model's logits,
    and the MoE one its aux (tests/test_torch_pp_model.py holds both
    against the JAX pipelined GPT)."""
    cfg = dataclasses.replace(tschema.GPTConfig(**TINY), **override)
    model = GPT(cfg, get_policy("fp32"), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, TINY["vocab_size"], (4, 16)).astype(np.int64))
    if "moe" in override:
        logits, aux = model(tokens)
        assert torch.isfinite(logits).all() and float(aux.detach()) > 0
        return
    model.load_state_dict(params_from_jax(params, cfg))
    plain = GPT(tschema.GPTConfig(**TINY), get_policy("fp32"), device="cpu")
    plain.load_state_dict(params_from_jax(params, plain.config))
    with torch.no_grad():
        torch.testing.assert_close(model(tokens), plain(tokens), rtol=1e-5,
                                   atol=1e-5)


def test_params_from_jax_fills_every_parameter(params):
    cfg = tschema.GPTConfig(**TINY)
    model = GPT(cfg, get_policy("fp32"), device="cpu")
    sd = params_from_jax(params, cfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()
    }
    model.load_state_dict(sd, strict=True)
    k0 = params["blocks"]["attn"]["query"]["kernel"][1]  # [in, out]
    np.testing.assert_array_equal(
        model.blocks[1].attn.query.weight.detach().numpy(), k0.T
    )


def test_init_params_follows_jax_init_distributions(params):
    """Same keys, shapes and distributions as the JAX init: LayerNorm
    scales one, biases zero (exactly), normal(0.02) embeddings and
    LeCun-normal kernels truncated at two standard deviations."""
    cfg = tschema.GPTConfig(**TINY)
    sd = init_params(cfg, torch.Generator().manual_seed(0))
    ref = params_from_jax(params, cfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in ref.items()
    }
    for name, w in sd.items():
        r = ref[name]
        if w.dim() == 1:  # LayerNorm scales and biases, Dense biases
            torch.testing.assert_close(w, r, atol=0, rtol=0)
            continue
        assert abs(float(w.std()) / float(r.std()) - 1) < 0.1, name
        if name not in ("wte.weight", "wpe"):
            std = (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978
            assert float(w.abs().max()) <= 2 * std * (1 + 1e-6), name
            assert float(r.abs().max()) <= 2 * std * (1 + 1e-6), name


def test_greedy_sample_and_filters_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((5, 64)).astype(np.float32)
    j = np.asarray(jgen._sample(jnp.asarray(logits), None, temperature=0.0, top_k=0))
    t = tgen._sample(torch.from_numpy(logits), None, temperature=0.0, top_k=0)
    np.testing.assert_array_equal(t.numpy(), j)
    g = torch.Generator().manual_seed(0)
    for kw in ({"top_k": 1}, {"top_k": 0, "top_p": 1e-6}):
        t = tgen._sample(torch.from_numpy(logits), g, temperature=0.7, **kw)
        np.testing.assert_array_equal(t.numpy(), j)
    draws = [
        tgen._sample(torch.from_numpy(logits), torch.Generator().manual_seed(s),
                     temperature=1.0, top_k=3)
        for s in range(50)
    ]
    top3 = np.argsort(-logits, axis=-1)[:, :3]
    for d in draws:
        assert all(int(d[i]) in top3[i] for i in range(5))
    again = tgen._sample(torch.from_numpy(logits), torch.Generator().manual_seed(7),
                         temperature=1.0, top_k=0, top_p=0.9)
    once = tgen._sample(torch.from_numpy(logits), torch.Generator().manual_seed(7),
                        temperature=1.0, top_k=0, top_p=0.9)
    torch.testing.assert_close(again, once)


def test_cache_buckets_and_taxonomy_match_jax(params):
    for seq_len in (64, 128, 1024):
        for needed in (1, 7, 8, 9, 33, 64, seq_len):
            for floor in (1, 8, 16):
                assert tgen.next_cache_bucket(seq_len, needed, floor) == (
                    jgen.next_cache_bucket(seq_len, needed, floor)
                )
    jm, tm = build_pair(params, "fp32")
    prompt, lens = _ragged(5)
    _, jc = jgen._prefill(jm.clone(cache_len=16), params, jnp.asarray(prompt),
                          jnp.asarray(lens))
    _, tc = tgen._prefill(tm, torch.from_numpy(prompt), torch.from_numpy(lens),
                          cache_len=16)
    assert tgen.cache_bytes_per_slot(tc, 3) == jgen.cache_bytes_per_slot(jc, 3)
    jleaves = {
        "cached_key": jc["blocks"]["attn"]["cached_key"],
        "cache_index": jc["blocks"]["attn"]["cache_index"],
        "pos_index": jc["pos_index"],
    }
    for name, leaf in jleaves.items():
        assert tgen.cache_batch_axis(tc[name], 3) == jgen.cache_batch_axis(leaf, 3)
        assert tgen.cache_capacity_axis(tc[name], 16) == (
            jgen.cache_capacity_axis(leaf, 16)
        )


@pytest.mark.parametrize(
    "cls", ["GPTConfig", "MoEConfig", "ServingConfig", "PrecisionConfig",
            "OptimizerConfig", "TrainerConfig", "DataConfig", "MeshConfig",
            "ParallelConfig", "ResNetConfig", "ViTConfig", "VideoConfig",
            "MLPConfig", "CheckpointConfig", "ElasticConfig"]
)
def test_config_copies_match_the_jax_schema(cls):
    """The port's own copies keep every field and default of the JAX
    schema, so one override string means the same in both packages."""
    j, t = getattr(jax_schema, cls)(), getattr(tschema, cls)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_experiment_config_sections_match_the_jax_schema():
    """The run config has the JAX schema's sections, in its order, and
    its default ``workdir``; a recipe's checkpoint section is the JAX
    recipe's."""
    names = [f.name for f in dataclasses.fields(tschema.ExperimentConfig)]
    assert names == [f.name for f in
                     dataclasses.fields(jax_schema.ExperimentConfig)]
    assert tschema.ExperimentConfig().workdir == (
        jax_schema.ExperimentConfig().workdir)
    for name in tconfig.list_configs():
        assert dataclasses.asdict(tconfig.get_config(name).checkpoint) == (
            dataclasses.asdict(jax_recipes.__dict__[name]().checkpoint))


def test_recipes_and_overrides_match_jax():
    ov = ["model.num_layers=2", "model.decode_attention=dense",
          "precision.policy=fp32", "serving.kv_block_size=0",
          "model.attention=flash", "optimizer.b2=none",
          "optimizer.grad_clip_norm=0.5", "trainer.remat=full",
          "data.data_dir=null", "mesh.fsdp=1"]
    for name in ("gpt2_medium_zero1", "gpt2_medium_serve", "gpt2_long"):
        j = jax_overrides(jax_recipes.__dict__[name](), ov)
        t = tconfig.apply_overrides(tconfig.get_config(name), ov)
        assert t.name == j.name
        for section in ("model", "precision", "serving", "data", "trainer",
                        "optimizer", "mesh", "parallel"):
            assert dataclasses.asdict(getattr(t, section)) == (
                dataclasses.asdict(getattr(j, section))
            )
    cfg = tconfig.get_config("gpt2_medium_serve")
    with pytest.raises(KeyError, match="no field"):
        tconfig.apply_overrides(cfg, ["model.nope=1"])
    with pytest.raises(ValueError, match="path.to.field=value"):
        tconfig.apply_overrides(cfg, ["model.num_layers"])
    with pytest.raises(KeyError, match="unknown config"):
        tconfig.get_config("nope")


def test_policies_match_jax():
    from frl_distributed_ml_scaffold_tpu.precision import get_policy as jp

    for name in ("fp32", "bf16", "bf16_mixed"):
        j, t = jp(name), get_policy(name)
        for field in ("param_dtype", "compute_dtype", "output_dtype",
                      "reduce_dtype"):
            assert str(getattr(t, field)).replace("torch.", "") == (
                jnp.dtype(getattr(j, field)).name
            )
    with pytest.raises(KeyError):
        get_policy("fp8")
