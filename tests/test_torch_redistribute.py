"""The port's redistribution plans against the JAX package's, in one
process and without communication.

The plan is computed from placements alone, so the port prices the
JAX tests' meshes (the 8-device sim) with no process group: every pair
of ``tests/test_redistribute.py``'s ``MESH_PAIRS`` in each of its four
dtypes, there and back, the JAX collective cases, ``restore_layout_spec``'s
cases, the scratch limit's chunking, and the perf ledger's
``redistribute:*`` rows (``analysis/runner.py`` ``RESHARD_PROGRAMS`` and
``build_train_to_serve_plan``, fed to the port leaf by leaf). A rank
plays the part of the JAX device at the same mesh coordinate. Kinds,
per-leaf ``bytes_moved`` / ``bytes_lower_bound`` / ``peak_scratch_bytes``
and every chunk must be equal. An uneven split (odd rows over 2), which
the JAX package cannot express, is held to a numpy reference by playing
the plan's chunks.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from frl_distributed_ml_scaffold_tpu import redistribute as jrd
from frl_distributed_ml_scaffold_tpu.config.schema import (
    MeshConfig as JaxMeshConfig,
)
from frl_distributed_ml_scaffold_tpu.dist.mesh import build_mesh as jbuild
from frl_distributed_ml_scaffold_tpu_torch import redistribute as rd
from frl_distributed_ml_scaffold_tpu_torch.config.schema import MeshConfig
from frl_distributed_ml_scaffold_tpu_torch.dist.mesh import (
    AXES,
    MeshEnv,
    rank_layout,
)


def penv(n: int, **kw) -> MeshEnv:
    """A port mesh over the first ``n`` ranks, without process groups
    (all a plan needs)."""
    cfg = MeshConfig(**kw)
    return MeshEnv(config=cfg, ranks=rank_layout(cfg, n))


def jenv(n: int, **kw):
    return jbuild(JaxMeshConfig(**kw), devices=jax.devices()[:n])


def pspec(spec, ndim: int) -> tuple:
    entries = list(spec) + [None] * (ndim - len(spec))
    return tuple(None if e is None else (e if isinstance(e, str)
                                         else tuple(e)) for e in entries)


def rank_of(jmesh, port: MeshEnv) -> dict[int, int]:
    """JAX device id -> the port rank at the same mesh coordinate."""
    return {int(d.id): int(port.ranks[idx])
            for idx, d in np.ndenumerate(jmesh.devices)}


def assert_same(jp, tp, maps):
    """A JAX LeafPlan and a port LeafPlan are the same plan."""
    assert tp.kind == jp.kind, (tp.path, tp.kind, jp.kind)
    assert tp.bytes_moved == jp.bytes_moved, tp.path
    assert tp.bytes_lower_bound == jp.bytes_lower_bound, tp.path
    assert tp.peak_scratch_bytes == jp.peak_scratch_bytes, tp.path
    dev = {}
    for m in maps:
        for d, r in m.items():
            assert dev.setdefault(d, r) == r
    jchunks = [(dev[c.src_device], dev[c.dst_device], c.index, c.nbytes)
               for c in jp.chunks]
    tchunks = [(c.src_rank, c.dst_rank, c.index, c.nbytes)
               for c in tp.chunks]
    assert tchunks == jchunks, tp.path
    if jp.transition is not None:
        jt, tt = jp.transition, tp.transition
        assert (tt.adds, tt.moves, tt.drops) == (jt.adds, jt.moves,
                                                 jt.drops)


# The JAX MESH_PAIRS (tests/test_redistribute.py:178): (n, mesh, spec)
# for the source and the destination.
MESH_PAIRS = {
    "one_to_n": ((1, dict(data=1), ()),
                 (8, dict(data=1, model=8), ("model", None))),
    "n_to_m_shrink": ((4, dict(data=1, model=4), (None, "model")),
                      (2, dict(data=1, model=2), (None, "model"))),
    "n_to_m_grow": ((2, dict(data=1, model=2), ("model", None)),
                    (8, dict(data=1, model=8), ("model", None))),
    "fsdp_model_to_model_only": (
        (8, dict(data=1, fsdp=4, model=2), ("fsdp", "model")),
        (2, dict(data=1, model=2), (None, "model"))),
    "mpmd_stage_to_merged": (
        (2, dict(data=2), ("data", None)),
        (8, dict(data=2, fsdp=4), (("data", "fsdp"), None))),
}
DTYPES = {"f32": (np.float32, "float32"), "bf16": (jnp.bfloat16, "bfloat16"),
          "int8": (np.int8, "int8"),
          "fp8_e4m3": (jnp.float8_e4m3fn, "float8_e4m3fn")}


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("pair", list(MESH_PAIRS))
def test_plans_equal_jax_on_mesh_pairs(pair, dtype_name):
    """Each pair there and back: the same kind, bytes and chunks."""
    (ns, ks, ss), (nd, kd, sd) = MESH_PAIRS[pair]
    jdt, tdt = DTYPES[dtype_name]
    js, jd = jenv(ns, **ks), jenv(nd, **kd)
    ts, td = penv(ns, **ks), penv(nd, **kd)
    maps = (rank_of(js.mesh, ts), rank_of(jd.mesh, td))
    shape = (64, 32)
    for (ja, jb, sa, sb, ta, tb) in ((js, jd, ss, sd, ts, td),
                                     (jd, js, sd, ss, td, ts)):
        jp = jrd.compile_leaf_plan(
            shape, jdt, NamedSharding(ja.mesh, P(*sa)),
            NamedSharding(jb.mesh, P(*sb)))
        tp = rd.compile_leaf_plan(
            shape, tdt, rd.Placement(ta, pspec(sa, 2)),
            rd.Placement(tb, pspec(sb, 2)))
        assert_same(jp, tp, maps)
        assert tp.bytes_moved == tp.bytes_lower_bound


def test_collective_cases_equal_jax():
    """The JAX executor test's four same-mesh classes (move, drop, add,
    drop + add) compile to the same collective transitions; an identity
    and a scratch-limited chunking too."""
    j = jenv(8, data=2, fsdp=2, model=2)
    t = penv(8, data=2, fsdp=2, model=2)
    maps = (rank_of(j.mesh, t),)
    cases = [
        (("fsdp", None, None), (None, "fsdp", None)),
        ((("data", "fsdp"), None, None), (None, None, None)),
        ((None, None, None), ("model", None, None)),
        (("fsdp", "data", None), ("fsdp", None, "model")),
        (("fsdp", None, None), ("fsdp", None, None)),
    ]
    for s, d in cases:
        jp = jrd.compile_leaf_plan(
            (32, 16, 8), np.float32, NamedSharding(j.mesh, P(*s)),
            NamedSharding(j.mesh, P(*d)))
        tp = rd.compile_leaf_plan((32, 16, 8), "float32",
                                  rd.Placement(t, pspec(s, 3)),
                                  rd.Placement(t, pspec(d, 3)))
        assert_same(jp, tp, maps)
    assert tp.kind == "identity" and tp.bytes_moved == 0
    # The scratch limit cuts chunks, never what moves.
    js, jd = jenv(8, data=1, fsdp=4, model=2), jenv(2, data=1, model=2)
    ts, td = penv(8, data=1, fsdp=4, model=2), penv(2, data=1, model=2)
    for limit in (None, 1024):
        jp = jrd.compile_leaf_plan(
            (64, 64), np.float32, NamedSharding(js.mesh, P("fsdp", None)),
            NamedSharding(jd.mesh, P(None, "model")),
            scratch_limit_bytes=limit)
        tp = rd.compile_leaf_plan(
            (64, 64), "float32", rd.Placement(ts, ("fsdp", None)),
            rd.Placement(td, (None, "model")), scratch_limit_bytes=limit)
        assert_same(jp, tp, (rank_of(js.mesh, ts), rank_of(jd.mesh, td)))
    assert max(c.nbytes for c in tp.chunks) <= 1024


def test_restore_layout_spec_equals_jax():
    """``restore_layout_spec``'s cases (tests/test_redistribute.py:159)
    and its drop program."""
    j, t = jenv(8, data=2, fsdp=4), penv(8, data=2, fsdp=4)
    for shape, target in (((64, 48), ("fsdp", None)), ((64,), ("fsdp",)),
                          ((7, 5), ()), ((64, 64), ()),
                          ((6, 64, 8), (None, "data", None))):
        js = jrd.restore_layout_spec(shape, P(*target), j.mesh)
        ts = rd.restore_layout_spec(shape, target, t)
        assert ts == pspec(tuple(js), len(shape)), (shape, target)
    assert rd.restore_layout_spec((64, 48), ("fsdp", None), t) == \
        ("fsdp", "data")
    plan = rd.compile_leaf_plan(
        (64, 48), "float32", rd.Placement(t, ("fsdp", "data")),
        rd.Placement(t, ("fsdp", None)))
    assert plan.kind == "collective"
    assert plan.transition.drops and not (plan.transition.moves
                                          or plan.transition.adds)


def test_ledger_rows_exact():
    """The perf ledger's ``redistribute:*`` rows come out exactly: the
    three program classes of ``RESHARD_PROGRAMS`` (JAX
    analysis/runner.py:1222-1236) and the tiny GPT's train-to-serve plan
    (``build_train_to_serve_plan``), leaf by leaf through the port."""
    from frl_distributed_ml_scaffold_tpu.analysis.runner import (
        RESHARD_PROGRAMS,
        build_train_to_serve_plan,
    )

    want = {"reshard:fsdp_to_tp": 49152, "reshard:restore_even_to_fsdp":
            16384, "reshard:tp_row_to_col": 14336}
    for name, cfg in RESHARD_PROGRAMS.items():
        t = penv(8, **cfg["mesh"])
        j = jbuild(JaxMeshConfig(**cfg["mesh"]))
        dst = pspec(cfg["dst"], 2)
        src = (rd.restore_layout_spec(cfg["shape"], dst, t)
               if cfg.get("even_src") else pspec(cfg["src"], 2))
        tp = rd.compile_leaf_plan(cfg["shape"], "float32",
                                  rd.Placement(t, src),
                                  rd.Placement(t, dst), path=name)
        jp = jrd.compile_leaf_plan(
            cfg["shape"], np.float32, NamedSharding(j.mesh, P(*src)),
            NamedSharding(j.mesh, P(*dst)))
        assert_same(jp, tp, (rank_of(j.mesh, t),))
        assert tp.kind == "collective"
        assert tp.bytes_moved == want[name]

    jplan, jtrain, jserve = build_train_to_serve_plan()
    ttrain = penv(8, data=1, fsdp=4, model=2)
    tserve = penv(2, data=1, model=2)
    maps = (rank_of(jtrain.mesh, ttrain), rank_of(jserve.mesh, tserve))
    leaves, dst = {}, {}
    for jl in jplan.leaves:
        nd = len(jl.shape)
        leaves[jl.path] = rd.Abstract.of(
            jl.shape, jl.dtype,
            rd.Placement(ttrain, pspec(jl.src_sharding.spec, nd)))
        dst[jl.path] = rd.Placement(tserve,
                                    pspec(jl.dst_sharding.spec, nd))
    tplan = rd.compile_tree_plan(leaves, dst)
    for jl, tl in zip(jplan.leaves, tplan.leaves):
        assert_same(jl, tl, maps)
    assert tplan.bytes_moved == jplan.bytes_moved == 337152
    assert tplan.bytes_lower_bound == 337152
    assert tplan.peak_scratch_bytes == jplan.peak_scratch_bytes == 81920
    assert tplan.summary_lines() == jplan.summary_lines()


def test_port_train_to_serve_plan_on_its_own_tree():
    """The same handoff over the port's own tiny GPT (a tensor a layer,
    ``[out, in]`` weights) under the trainer's fsdp=4 model=2 layout: it
    moves the JAX row's bytes but for the tied embedding, which the
    port's serving keeps whole on every rank (``TP_COMPUTE_WHOLE``) where
    the JAX serving splits it: 57344 bytes in place of 24576."""
    from frl_distributed_ml_scaffold_tpu_torch.config.schema import (
        GPTConfig,
        ParallelConfig,
        PrecisionConfig,
    )
    from frl_distributed_ml_scaffold_tpu_torch.models.gpt import (
        GPT,
        TP_COMPUTE_WHOLE,
        gpt_tp_rules,
    )
    from frl_distributed_ml_scaffold_tpu_torch.parallel.layout import (
        StateLayout,
    )
    from frl_distributed_ml_scaffold_tpu_torch.precision import get_policy

    cfg = GPTConfig(vocab_size=128, num_layers=2, num_heads=4,
                    hidden_dim=64, seq_len=32, dropout=0.0)
    model = GPT(cfg, get_policy(PrecisionConfig(policy="fp32")),
                device="meta")
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    layout = StateLayout.build(
        penv(8, data=1, fsdp=4, model=2), cfg,
        ParallelConfig(param_sharding="fsdp", fsdp_min_size=16), shapes,
        rules=gpt_tp_rules(), compute_whole=TP_COMPUTE_WHOLE)
    src = rd.layout_tree(layout, {k: p.dtype
                                  for k, p in model.named_parameters()})
    plan = rd.train_to_serve_plan(src, penv(2, data=1, model=2),
                                  gpt_tp_rules(), model=model)
    assert {l.kind for l in plan.leaves} == {"chunked"}
    assert plan.bytes_moved == plan.bytes_lower_bound
    wte = next(l for l in plan.leaves if l.path == "wte.weight")
    assert wte.bytes_moved == 57344
    assert plan.bytes_moved == 337152 - 24576 + 57344


def _play(plan, whole: np.ndarray) -> dict[int, np.ndarray]:
    """The plan's chunks played in numpy: every destination rank's
    region assembled from the source ranks' regions."""
    src_map = plan.src.regions(plan.shape)
    dst_map = plan.dst.regions(plan.shape)
    local = {r: whole[tuple(slice(a, b) for a, b in reg)]
             for r, reg in src_map.items()}
    out = {r: np.full(tuple(b - a for a, b in reg), -1, whole.dtype)
           for r, reg in dst_map.items()}
    for c in plan.chunks:
        s = tuple(slice(a - b0, b - b0)
                  for (a, b), (b0, _) in zip(c.index, src_map[c.src_rank]))
        d = tuple(slice(a - b0, b - b0)
                  for (a, b), (b0, _) in zip(c.index, dst_map[c.dst_rank]))
        out[c.dst_rank][d] = local[c.src_rank][s]
    return out


@pytest.mark.parametrize("limit", [None, 24])
def test_uneven_split_against_numpy(limit):
    """Odd rows over 2 (7 = 4 + 3, the port's ``chunk_bounds``), which
    the JAX package cannot place: the plan's chunks rebuild every
    destination region of a numpy array, there and back, and each
    destination rank receives exactly what it lacked."""
    whole = np.arange(7 * 6, dtype=np.int32).reshape(7, 6)
    a = rd.Placement(penv(2, data=1, model=2), ("model", None))
    b = rd.Placement(penv(4, data=1, fsdp=2, model=2), (None, "fsdp"))
    c = rd.Placement(penv(4, data=1, fsdp=2, model=2), ("fsdp", "model"))
    assert a.regions((7, 6)) == {0: ((0, 4), (0, 6)), 1: ((4, 7), (0, 6))}
    for src, dst in ((a, b), (b, a), (b, c), (c, b), (a, c)):
        plan = rd.compile_leaf_plan((7, 6), "int32", src, dst,
                                    scratch_limit_bytes=limit)
        assert plan.kind == "chunked"
        got = _play(plan, whole)
        for r, reg in dst.regions((7, 6)).items():
            np.testing.assert_array_equal(
                got[r], whole[tuple(slice(x, y) for x, y in reg)])
        held = src.regions((7, 6))
        lack = 0
        for r, reg in dst.regions((7, 6)).items():
            have = 0
            if r in held:
                inter = rd.plan._intersect(reg, held[r])
                have = 0 if inter is None else rd.plan._region_size(inter)
            lack += (rd.plan._region_size(reg) - have) * 4
        assert plan.bytes_lower_bound == plan.bytes_moved == lack
        if limit:
            assert max(ch.nbytes for ch in plan.chunks) <= limit


def test_mesh_shardings_and_to_mesh():
    """``mesh_shardings`` carries each leaf's spec onto another mesh
    (degraded where it no longer divides; ``spec_of`` overrides; a host
    leaf whole) as JAX's does; ``to_mesh`` runs the plan, here a host
    leaf narrowed onto a mesh of this one process."""
    import torch

    t2, t4 = penv(2, data=1, model=2), penv(4, data=1, model=4)
    tree = {"w": rd.Abstract.of((8, 6), "float32",
                                rd.Placement(t2, ("model", "model"))),
            "b": rd.Abstract.of((6,), "float32", rd.Placement(t2, ())),
            "h": rd.Abstract.of((4, 4), "int8", None)}
    dst = rd.mesh_shardings(tree, t4)
    assert {k: v.spec for k, v in dst.items()} == {
        "w": ("model", None), "b": (None,), "h": (None, None)}
    assert all(v.env is t4 for v in dst.values())
    dst = rd.mesh_shardings(tree, t4, spec_of=lambda p, _: (
        ("model",) if p == "b" else None))
    assert dst["b"].spec == (None,) and dst["w"].spec == ("model", None)
    one = penv(1, data=1, model=1)
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    out, plan = rd.to_mesh(
        {"w": x}, {"w": rd.Abstract.of((8, 6), "float32", None)}, one,
        spec_of=lambda *_: ("model", None))
    assert plan.leaves[0].kind == "host"
    assert torch.equal(out["w"], x) and out["w"].data_ptr() != x.data_ptr()


def test_placement_and_spec_rules():
    """``spec_on`` degrades an indivisible entry to whole as JAX's does;
    ``owner`` restricts the holders to one pipe coordinate; a host
    source compiles to the ``host`` kind."""
    t4 = penv(4, data=1, model=4)
    assert rd.spec_on(t4, (8, 6), ("model", "model")) == ("model", None)
    j4 = jenv(4, data=1, model=4)
    js = jrd.spec_on(j4.mesh, jax.ShapeDtypeStruct((8, 6), np.float32),
                     P("model", "model"))
    assert pspec(tuple(js.spec), 2) == ("model", None)
    pp = penv(4, pipe=2, data=2)
    held = rd.Placement(pp, ("data", None), owner=1)
    assert held.ranks == [2, 3]
    assert rd.restore_layout_spec((8, 4), (None, None), pp, owner=1) == \
        ("data", None)
    plan = rd.compile_leaf_plan((8, 4), "float32", None,
                                rd.Placement(t4, ("model", None)))
    assert plan.kind == "host" and plan.bytes_moved == 8 * 4 * 4
    assert set(AXES) == set(pp.shape)
