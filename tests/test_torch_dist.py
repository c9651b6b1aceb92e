"""The port's mesh and collectives (``dist/``) against the JAX package's
``dist/mesh.py`` and ``dist/collectives.py``.

The mesh: ``resolve_axis_sizes``, the axis order, the rank at every
coordinate (the JAX mesh's device ids on the simulated CPU devices,
row-major, and the ``dcn_data`` layout) and ``local_batch_size``
(against the JAX function with one device per process, the port's
layout), all exact. The collectives: four gloo ranks of the port on a
``data=4`` mesh against the JAX functions under ``shard_map`` on 4 of
the 8 simulated devices, on the cases of ``tests/test_dist.py``, exact
(small integers in fp32).
"""

import _torch_threads  # noqa: F401  (before any torch op)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from _torch_ranks import spawn_ranks
from frl_distributed_ml_scaffold_tpu.config.schema import MeshConfig as JMesh
from frl_distributed_ml_scaffold_tpu.dist import collectives as jc
from frl_distributed_ml_scaffold_tpu.dist import mesh as jmesh
from frl_distributed_ml_scaffold_tpu_torch.config.schema import MeshConfig
from frl_distributed_ml_scaffold_tpu_torch.dist import mesh as tmesh

MESHES = [dict(data=-1), dict(data=2, fsdp=2, model=2), dict(data=1, fsdp=-1),
          dict(data=4, model=2, dcn_data=2), dict(data=2, model=-1),
          dict(data=1, fsdp=2, model=4), dict(data=4, fsdp=2, dcn_data=2)]


@pytest.mark.parametrize("kw", MESHES)
def test_mesh_layout_matches_jax(kw):
    """Axis sizes, order and the rank at every coordinate, exactly."""
    assert tmesh.AXES == jmesh.AXES and tmesh.BATCH_AXES == jmesh.BATCH_AXES
    assert tmesh.resolve_axis_sizes(MeshConfig(**kw), 8) == (
        jmesh.resolve_axis_sizes(JMesh(**kw), 8))
    env = jmesh.build_mesh(JMesh(**kw))
    ids = np.vectorize(lambda d: d.id)(np.asarray(env.mesh.devices))
    np.testing.assert_array_equal(tmesh.rank_layout(MeshConfig(**kw), 8),
                                  ids)


def test_mesh_refusals_match_jax():
    for kw in (dict(data=3, model=2), dict(data=-1, model=-1)):
        with pytest.raises(ValueError):
            jmesh.resolve_axis_sizes(JMesh(**kw), 8)
        with pytest.raises(ValueError):
            tmesh.resolve_axis_sizes(MeshConfig(**kw), 8)
    with pytest.raises(ValueError, match="dcn_data"):
        tmesh.rank_layout(MeshConfig(data=2, model=4, dcn_data=4), 8)
    # Without a process group a mesh spans one rank.
    env = tmesh.build_mesh(MeshConfig(data=1, fsdp=-1))
    assert env.num_devices == 1 and env.group(("data", "fsdp")) is None
    with pytest.raises(ValueError, match="needs 2 devices"):
        tmesh.build_mesh(MeshConfig(data=2))


@pytest.mark.parametrize("kw,batch", [(dict(data=-1), 64),
                                      (dict(data=2, fsdp=2), 16),
                                      (dict(data=1, fsdp=-1), 12)])
def test_local_batch_size_matches_jax(kw, batch, monkeypatch):
    """With one device per process (the port's layout) the port's rows
    per rank are the JAX package's rows per process; indivisible batches
    raise in both."""
    jenv = jmesh.build_mesh(JMesh(**kw), devices=jax.devices()[:4])
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    lay = tmesh.rank_layout(MeshConfig(**kw), 4)
    tenv = tmesh.MeshEnv(config=MeshConfig(**kw), ranks=lay)
    assert tenv.batch_axis_size == jenv.batch_axis_size
    if batch % 4:
        with pytest.raises(ValueError):
            jmesh.local_batch_size(batch, jenv)
        with pytest.raises(ValueError):
            tmesh.local_batch_size(batch, tenv)
        return
    assert tmesh.local_batch_size(batch, tenv) == (
        jmesh.local_batch_size(batch, jenv))


def _shmap(fn, mesh, in_specs, out_specs):
    return jax.jit(jmesh.shard_map_compat(fn, mesh=mesh, in_specs=in_specs,
                                          out_specs=out_specs))


def _jax_cases() -> dict:
    """The JAX collectives on a data=4 mesh of 4 simulated devices, as
    the global arrays their shards form."""
    env = jmesh.build_mesh(JMesh(data=-1), devices=jax.devices()[:4])
    m = env.mesh
    x = jnp.arange(4.0)
    d = (P("data"),)
    out = {
        "all_reduce": _shmap(lambda a: jc.all_reduce(a, "data"), m, d,
                             P("data"))(x),
        "all_mean": _shmap(lambda a: jc.all_mean(a, "data"), m, d,
                           P("data"))(x),
        "broadcast": _shmap(lambda a: jc.broadcast(a, "data", source=3), m,
                            d, P("data"))(x),
        "ring_shift": _shmap(lambda a: jc.ring_shift(a, "data", shift=1), m,
                             d, P("data"))(x),
        "axis": _shmap(lambda a: jnp.stack([a[0] * 0 + jc.axis_index("data"),
                                            a[0] * 0 + jc.axis_size("data")]),
                       m, d, P("data"))(x),
    }
    mat = jnp.arange(8.0).reshape(4, 2)

    def gather_scatter(a):
        full = jc.all_gather(a, "data")
        return full, jc.reduce_scatter(full, "data")

    full, rs = _shmap(gather_scatter, m, (P("data", None),),
                      (P("data", None), P("data", None)))(mat)
    out["all_gather"], out["reduce_scatter"] = full, rs
    sq = jnp.arange(16.0).reshape(4, 4)
    out["all_to_all"] = _shmap(
        lambda a: jc.all_to_all(a, "data", split_axis=1, concat_axis=0), m,
        (P("data", None),), P("data", None))(sq)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(4, [{"name": "c", "kind": "collectives",
                            "args": {"env_cfg": {"data": -1}}}],
                       tmp_path_factory.mktemp("dist"))


def test_collectives_match_jax_on_four_ranks(ranks):
    """Rank r's result is shard r of the JAX function's output (the
    gathered ``[4, 2]`` of all_gather on every shard): exact."""
    want = _jax_cases()
    for r, res in enumerate(ranks):
        got = res["c"]
        for k in ("all_reduce", "all_mean", "broadcast", "ring_shift"):
            np.testing.assert_array_equal(got[k], want[k][r:r + 1], err_msg=k)
        np.testing.assert_array_equal(got["axis"], want["axis"][2 * r:2 * r + 2])
        np.testing.assert_array_equal(got["all_gather"],
                                      want["all_gather"][4 * r:4 * r + 4])
        np.testing.assert_array_equal(got["reduce_scatter"],
                                      want["reduce_scatter"][r:r + 1])
        np.testing.assert_array_equal(got["all_to_all"],
                                      want["all_to_all"][4 * r:4 * r + 4])
        np.testing.assert_array_equal(got["tree"]["a"], want["all_reduce"][:1])
        np.testing.assert_array_equal(got["tree"]["b"]["c"],
                                      2 * want["all_reduce"][:1])
        np.testing.assert_array_equal(got["host_all_gather"],
                                      np.arange(4.0)[:, None])
        assert got["host_broadcast"] == {"rank": 0}


def test_one_rank_mesh_step_is_the_plain_step(tmp_path):
    """The card's mesh path on the CPU: one gloo rank, the mesh's data /
    fsdp / model groups kept at size 1 (``unit_groups``), a tiny
    ``gpt2_medium_zero1`` through ``chip_smoke.py``'s ``mesh_setup``: two
    steps' losses, grad_norms and params equal the plain step's bit for
    bit (every collective over one rank is a copy, every sum in the plain
    step's order), and the step did call the collectives."""
    import sys

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parents[1]))
    import chip_smoke
    from frl_distributed_ml_scaffold_tpu_torch import config as tconfig
    from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import (
        SyntheticLM,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.convert import (
        init_params,
    )

    cfg = tconfig.apply_overrides(tconfig.get_config("gpt2_medium_zero1"), [
        "model.num_layers=2", "model.hidden_dim=64", "model.num_heads=4",
        "model.vocab_size=256", "data.vocab_size=256", "model.seq_len=32",
        "data.seq_len=32", "data.global_batch_size=4",
        "trainer.grad_accum=2", "precision.policy=fp32",
        "optimizer.warmup_steps=1"])
    sd = init_params(cfg.model, torch.Generator().manual_seed(0))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        env = tmesh.build_mesh(cfg.mesh, unit_groups=True)
        assert env.group(("data", "fsdp")) is not None
        runs = []
        for mesh in (False, True):
            model, policy, tx, _, state, loss_fn = chip_smoke._train_setup(
                cfg, sd, device="cpu")
            if mesh:
                state, step, lay = chip_smoke.mesh_setup(
                    cfg, env, tx, policy, loss_fn, state, device="cpu")
                assert lay.trivial
            else:
                step = chip_smoke._step_fn(cfg, loss_fn, tx, policy,
                                           device="cpu")
            data = SyntheticLM(cfg.data, split="train")
            metrics = []
            with chip_smoke.CountCollectives() as cc:
                for s in range(2):
                    state, m = step(state, data.batch(s, 4))
                    metrics.append((float(m["loss"]), float(m["grad_norm"])))
            runs.append((metrics, state.params, cc.counts))
    finally:
        dist.destroy_process_group()
    (plain, p_plain, c_plain), (mesh, p_mesh, c_mesh) = runs
    assert plain == mesh
    assert all(torch.equal(p_mesh[k], v) for k, v in p_plain.items())
    assert sum(c_plain.values()) == 0
    # Per step: the loss, and one all-reduce a gradient leaf.
    assert c_mesh["all_reduce"] == 2 * (1 + len(p_plain))
