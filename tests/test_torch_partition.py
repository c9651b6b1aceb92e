"""The port's partition specs (``parallel/partition.py``,
``parallel/layout.py``) against the JAX package's
``parallel/partition.py``, as the JAX trainer derives them.

For tiny GPT, ViT, ResNet and MLP configs cut from the recipes, under
``replicated`` / ``fsdp`` / ``zero1`` over ``data=4``, ``data=2 fsdp=2``,
``fsdp=4`` and ``data=2 model=2`` (4 of the 8 simulated devices), every
port parameter's spec, read on its JAX leaf (``jax_spec_of``), equals
the JAX spec of that leaf, for the params and for the optimizer state
(the ``mu`` mirror); and the bytes of params and optimizer moments each
rank holds equal the sum of ``addressable_shards[i].data.nbytes`` of the
JAX arrays on the device at the same mesh coordinate. The JAX GPT
stacks its blocks: where its overlay picks the layer dim (a test width),
the port splits the best other dim, and the bytes still agree. All
exact.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from _torch_parity import TINY_VIT, recipe_pair
from frl_distributed_ml_scaffold_tpu.dist.mesh import build_mesh as jbuild
from frl_distributed_ml_scaffold_tpu.parallel import partition as jpart
from frl_distributed_ml_scaffold_tpu.trainer.loop import Trainer as JaxTrainer
from frl_distributed_ml_scaffold_tpu.utils.trees import tree_path_names
from frl_distributed_ml_scaffold_tpu_torch import config as tconfig
from frl_distributed_ml_scaffold_tpu_torch.config.recipes import list_configs
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
    MeshEnv,
    rank_layout,
)
from frl_distributed_ml_scaffold_tpu_torch.models import create_model
from frl_distributed_ml_scaffold_tpu_torch.parallel.layout import StateLayout
from frl_distributed_ml_scaffold_tpu_torch.parallel.partition import (
    jax_leaves,
    jax_spec_of,
)
from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy
from frl_distributed_ml_scaffold_tpu_torch.trainer import loop as tloop

GPT = ["model.num_layers=2", "model.hidden_dim=64", "model.num_heads=4",
       "model.vocab_size=512", "data.vocab_size=512", "model.seq_len=32",
       "data.seq_len=32", "data.global_batch_size=8"]
FAMILIES = {
    "gpt": ("gpt2_medium_zero1", GPT),
    "vit": ("imagenet_vitb_fsdp", TINY_VIT),
    "resnet": ("imagenet_rn50_ddp", ["model.depth=18", "data.image_size=32",
                                     "model.num_classes=10",
                                     "data.num_classes=10"]),
    "mlp": ("mnist_mlp", []),
}
LAYOUTS = {
    "replicated": ["parallel.param_sharding=replicated",
                   "parallel.opt_sharding=like_params"],
    "fsdp": ["parallel.param_sharding=fsdp",
             "parallel.opt_sharding=like_params",
             "parallel.fsdp_min_size=256"],
    "zero1": ["parallel.param_sharding=replicated",
              "parallel.opt_sharding=zero1", "parallel.fsdp_min_size=256"],
}
MESHES = {
    "data4": ["mesh.data=4", "mesh.fsdp=1", "mesh.model=1"],
    "data2_fsdp2": ["mesh.data=2", "mesh.fsdp=2", "mesh.model=1"],
    "fsdp4": ["mesh.data=1", "mesh.fsdp=4", "mesh.model=1"],
    "data2_model2": ["mesh.data=2", "mesh.fsdp=1", "mesh.model=2"],
}


def _named(tree) -> dict:
    leaves = jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, P))
    return dict(zip(tree_path_names(tree), leaves))


def _norm(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _jax_device_bytes(shapes: dict, specs: dict, mesh) -> dict:
    """Per device, the sum of ``addressable_shards[i].data.nbytes`` of
    zero arrays of ``shapes`` placed by ``specs``."""
    out: dict = {}
    for name, sds in shapes.items():
        arr = jax.device_put(np.zeros(sds.shape, sds.dtype),
                             NamedSharding(mesh, specs[name]))
        for shard in arr.addressable_shards:
            out[shard.device.id] = (out.get(shard.device.id, 0)
                                    + shard.data.nbytes)
    return out


def _port_layouts(tcfg) -> list[StateLayout]:
    """The port's layout on each of 4 ranks (no process group: the
    specs and shard shapes need none)."""
    pol = get_policy(tcfg.precision)
    meta = create_model(tcfg.model, pol, device="meta",
                        **tloop._model_kwargs(tcfg))
    shapes = {k: tuple(p.shape) for k, p in meta.named_parameters()}
    ranks = rank_layout(tcfg.mesh, 4)
    out = []
    for r in range(4):
        env = MeshEnv(config=tcfg.mesh, ranks=ranks, rank=r)
        whole = ("wte.weight",) if tcfg.model.family == "gpt" else ()
        out.append(StateLayout.build(
            env, tcfg.model, tcfg.parallel, shapes,
            rules=tloop.model_partition_rules(tcfg.model, env),
            compute_whole=whole))
    return out


def _hold(family: str, layout: str, mesh: str, extra=()):
    name, ov = FAMILIES[family]
    jcfg, tcfg = recipe_pair(name, ov + LAYOUTS[layout] + MESHES[mesh]
                             + ["precision.policy=fp32", *extra])
    jenv = jbuild(jcfg.mesh, devices=jax.devices()[:4])
    if family in ("resnet", "mlp") and mesh == "data2_model2":
        with pytest.raises(ValueError, match="mesh.model must be 1"):
            JaxTrainer(jcfg, mesh_env=jenv)
        with pytest.raises(ValueError, match="mesh.model must be 1"):
            _port_layouts(tcfg)
        return
    jt = JaxTrainer(jcfg, mesh_env=jenv)
    p_shapes = jt.state_shapes.params
    j_p = _named(jt.state_specs.params)
    j_o = _named(jpart.opt_state_specs({"mu": p_shapes}, p_shapes,
                                       jt.state_specs.params, jcfg.parallel,
                                       jenv.mesh)["mu"])
    shapes = dict(zip(tree_path_names(p_shapes), jax.tree.leaves(p_shapes)))
    lays = _port_layouts(tcfg)
    leaves = jax_leaves(tcfg.model, lays[0].shapes)
    assert {lf.name for lf in leaves.values()} == set(shapes)
    for k, leaf in leaves.items():
        assert leaf.shape == shapes[leaf.name].shape, k
        nd = len(leaf.shape)
        for port, jax_specs in ((lays[0].param, j_p), (lays[0].opt, j_o)):
            want = _norm(jax_specs[leaf.name], nd)
            got = jax_spec_of(port[k], leaf)
            layer = [i for i, e in enumerate(want)
                     if e is not None and leaf.dims[i] is None]
            if layer:  # the JAX overlay split the stacked layer dim
                assert got.count("fsdp") == 1, (k, got, want)
                continue
            assert got == want, (k, got, want)
    # Bytes per rank == JAX bytes per device at the same coordinate.
    j_pb = _jax_device_bytes(shapes, j_p, jenv.mesh)
    j_ob = _jax_device_bytes(shapes, j_o, jenv.mesh)
    ids = np.vectorize(lambda d: d.id)(np.asarray(jenv.mesh.devices))
    for lay in lays:
        dev = int(ids[tuple(lay.env.coords.values())])
        p_bytes = sum(4 * int(np.prod(lay.local_shape(k, s)))
                      for k, s in lay.param.items())
        o_bytes = sum(4 * int(np.prod(lay.local_shape(k, s)))
                      for k, s in lay.opt.items())
        assert p_bytes == j_pb[dev], (lay.env.rank, p_bytes, j_pb[dev])
        assert o_bytes == j_ob[dev], (lay.env.rank, o_bytes, j_ob[dev])


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_specs_and_bytes_match_jax(family, layout, mesh):
    _hold(family, layout, mesh)


def test_stacked_layer_dim_rule():
    """A GPT whose stacked leaves' largest dim is the layer dim (16
    layers at width 8): JAX splits the layers, the port the best other
    dim, and every rank's bytes are still JAX's."""
    _hold("gpt", "fsdp", "fsdp4", extra=["model.num_layers=16",
                                         "model.hidden_dim=8",
                                         "model.num_heads=2",
                                         "parallel.fsdp_min_size=64"])


def test_odd_vocab_splits_unevenly():
    """``wte`` of an odd vocabulary over ``model=2`` (the gpt2_tp recipe's
    50257): the JAX package's jax refuses to place the uneven split; the
    port gives rank 0 the ceil half and rank 1 the rest, and gathers it
    whole for the forward (the tied head and the loss see every row)."""
    jcfg, tcfg = recipe_pair("gpt2_tp", [*GPT[:3], "model.vocab_size=509",
                                         "data.vocab_size=509",
                                         *MESHES["data2_model2"]])
    jenv = jbuild(jcfg.mesh, devices=jax.devices()[:4])
    with pytest.raises(ValueError, match="divisible by 2"):
        jax.device_put(np.zeros((509, 64), np.float32),
                       NamedSharding(jenv.mesh, P("model", None)))
    lays = _port_layouts(tcfg)
    rows = [lay.local_shape("wte.weight", lay.param["wte.weight"])[0]
            for lay in lays]
    assert rows == [255, 254, 255, 254]
    assert lays[0].compute["wte.weight"] == (None, None)
    assert lays[0].param["wte.weight"] == ("model", None)


def test_new_recipes_match_jax():
    """The recipes this port adds are the JAX package's, section for
    section."""
    for name in ("gpt2_tp", "imagenet_rn101_ddp", "imagenet_vitl_fsdp"):
        assert name in list_configs()
        jcfg, tcfg = recipe_pair(name, [])
        assert tcfg.name == jcfg.name == name
        for section in ("model", "data", "trainer", "optimizer", "mesh",
                        "parallel", "precision", "checkpoint", "serving"):
            assert dataclasses.asdict(getattr(tcfg, section)) == (
                dataclasses.asdict(getattr(jcfg, section))), (name, section)
    assert tconfig.get_config("gpt2_tp").mesh.model == 2
