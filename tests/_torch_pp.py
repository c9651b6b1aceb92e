"""The harness of the port's pipeline tests over four gloo ranks
(``test_torch_pp_ranks.py``, ``test_torch_pp_mpmd.py``), on
``_torch_sharded.py``'s: ``gpt2_pp``, ``gpt2_pp_circular`` and
``gpt2_pipeline_mpmd`` cut to 4 layers at width 32 (T 16, vocab 128,
fp32), one stage a pipe rank, beside the JAX Trainer on the same mesh
(the first devices of the 8 simulated ones) and the port's one-rank step,
on the same global batch and from one params file. The SPMD cases' file
holds the JAX trainer's own stacked tree, the MPMD cases' the plain one
(as each JAX backend reads); a case's one-rank step is the recipe at
``mesh.pipe=1``, or, given its overrides, the plain model from the plain
file.
"""

import dataclasses

import jax
import numpy as np
from flax import serialization

from _torch_parity import recipe_pair
from _torch_ranks import start_ranks
from _torch_sharded import (
    COMMON,
    ONE_RANK,
    _global_batches,
    _port_params,
    _random_params,
    _run_port,
)
from frl_distributed_ml_scaffold_tpu.dist.mesh import build_mesh as jbuild
from frl_distributed_ml_scaffold_tpu.trainer.loop import Trainer as JaxTrainer
from frl_distributed_ml_scaffold_tpu_torch import config as tconfig
from frl_distributed_ml_scaffold_tpu_torch.models import convert

TINY = ["model.num_layers=4", "model.hidden_dim=32", "model.num_heads=2",
        "model.seq_len=16", "data.seq_len=16", "model.vocab_size=128",
        "data.vocab_size=128", "data.global_batch_size=8"]
PP4 = ["mesh.pipe=4", "mesh.data=1"]
PP2 = ["mesh.pipe=2", "mesh.data=2", "model.pipeline_stages=2"]


def jax_devices(jcfg):
    """The simulated devices a JAX config's mesh takes."""
    n = int(np.prod([v for v in jcfg.mesh.axis_sizes().values() if v > 0]))
    return jax.devices()[:n]


def _plain_file(tree_path, tcfg, path):
    """A plain-layout params file of the params in ``tree_path`` (any
    layout ``tcfg`` reads)."""
    tree = serialization.msgpack_restore(tree_path.read_bytes())
    sd = convert.params_from_jax(tree, tcfg.model)
    plain = dataclasses.replace(tcfg.model, pipeline_stages=1)
    jt = convert.params_to_jax(sd, plain)

    def np_tree(t):
        if isinstance(t, dict):
            return {k: np_tree(v) for k, v in t.items()}
        return t.numpy()

    path.write_bytes(serialization.to_bytes(np_tree(jt)))
    return path


def params_file(recipe: str, ov: list, path, seed: int):
    """Write the seeded params file a case's trainers read; returns its
    (JAX config, port config) with ``init_params_path`` set."""
    jcfg, tcfg = recipe_pair(recipe, ov)
    mpmd = tcfg.model.pipeline_impl == "mpmd"
    shape_cfg = (recipe_pair(recipe, ov + ["model.pipeline_stages=1",
                                           "model.pipeline_impl=spmd",
                                           "mesh.pipe=1"])[0]
                 if mpmd else jcfg)
    shapes = JaxTrainer(shape_cfg, mesh_env=jbuild(
        shape_cfg.mesh, devices=jax_devices(shape_cfg))).state_shapes
    path.write_bytes(serialization.to_bytes(_random_params(shapes.params,
                                                           seed)))
    return recipe_pair(recipe, ov + [f"trainer.init_params_path={path}"])


def run_pp(cases: dict, jax_cases, tmp, extra_jobs=()) -> dict:
    """Each case (``name: (recipe, overrides, one-rank overrides or
    None)``): the ranks' results, the one-rank step's and, for
    ``jax_cases``, the JAX Trainer's, over 2 steps (``_torch_sharded.py``
    ``run_cases``'s layout of results)."""
    jobs, side = [], {}
    for i, (name, (recipe, ov, one_ov)) in enumerate(cases.items()):
        ov = ov + COMMON
        path = tmp / f"{name}.msgpack"
        jcfg, tcfg = params_file(recipe, ov, path, i)
        if one_ov is None:
            one = tconfig.apply_overrides(tcfg, ONE_RANK)
        else:
            plain = (path if tcfg.model.pipeline_impl == "mpmd" else
                     _plain_file(path, tcfg, tmp / f"{name}_plain.msgpack"))
            one = tconfig.apply_overrides(tcfg, ONE_RANK + one_ov + [
                f"trainer.init_params_path={plain}"])
        side[name] = (jcfg, tcfg, one)
        jobs.append({"name": name, "kind": "train",
                     "args": {"config": recipe,
                              "overrides": ov + [
                                  f"trainer.init_params_path={path}"],
                              "steps": 2}})
    wait = start_ranks(4, jobs + list(extra_jobs), tmp)
    out = {}
    for name, (jcfg, tcfg, one) in side.items():
        batches, nb = _global_batches(tcfg)
        res = {"batches": batches, "nb": nb, "one_cfg": one,
               "one": _run_port(one, batches), "cfg": tcfg}
        if name in jax_cases:
            jt = JaxTrainer(jcfg, mesh_env=jbuild(jcfg.mesh,
                                                  devices=jax_devices(jcfg)))
            state, jm = jt.init_state(), []
            for b in batches:
                state, m = jt.train_step(state, b)
                jm.append({k: float(v) for k, v in m.items()})
            res["jax"] = {"metrics": jm, "params": _port_params(
                tcfg, jax.device_get(state.params))}
        out[name] = res
    ranks = wait()
    for name in cases:
        out[name]["ranks"] = [r[name] for r in ranks]
    out["extra"] = [{j["name"]: r[j["name"]] for j in extra_jobs}
                    for r in ranks]
    return out
