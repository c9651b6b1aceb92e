"""The port's data pipeline (frl_distributed_ml_scaffold_tpu_torch/data/
pipeline.py) against the JAX package's: ``local_batch(step)`` bit for bit
for every synthetic source, prefetched batches equal to unprefetched
ones (after a seek too), the same retry count under an armed
``data.loader`` fault, and the refusal of streaming token bins."""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import numpy as np
import pytest
import torch

from frl_distributed_ml_scaffold_tpu import faults as jfaults
from frl_distributed_ml_scaffold_tpu.config import schema as jschema
from frl_distributed_ml_scaffold_tpu.data import pipeline as jpipeline
from frl_distributed_ml_scaffold_tpu.dist.mesh import build_mesh
from frl_distributed_ml_scaffold_tpu_torch import faults as tfaults
from frl_distributed_ml_scaffold_tpu_torch.config import schema as tschema
from frl_distributed_ml_scaffold_tpu_torch.data import pipeline as tpipeline

SOURCES = {
    "mnist": dict(),
    "synthetic_mnist": dict(),
    "imagenet": dict(image_size=16, channels=3, num_classes=10),
    "synthetic_imagenet": dict(image_size=16, channels=3, num_classes=10),
    "lm_synthetic": dict(seq_len=32, vocab_size=100),
    "video": dict(image_size=8, channels=3, num_frames=4, num_classes=5),
    "video_synthetic": dict(image_size=8, channels=3, num_frames=4,
                            num_classes=5),
}


def _pair(name, **kw):
    fields = dict(name=name, global_batch_size=8, shuffle_seed=3, **kw)
    env = build_mesh(jschema.MeshConfig(data=-1))
    return (jpipeline.DataPipeline(jschema.DataConfig(**fields), env,
                                   split="train"),
            tpipeline.DataPipeline(tschema.DataConfig(**fields),
                                   device="cpu"))


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_local_batches_match_jax_bit_for_bit(name):
    jp, tp = _pair(name, **SOURCES[name])
    for step in (0, 1, 5):
        want, got = jp.local_batch(step), tp.local_batch(step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        on_cpu = tp.global_batch(step)
        for k in want:
            np.testing.assert_array_equal(on_cpu[k].numpy(), want[k])


def test_prefetched_batches_equal_the_unprefetched():
    cfg = tschema.DataConfig(name="lm_synthetic", global_batch_size=4,
                             seq_len=16, vocab_size=50, prefetch=2)
    pre = tpipeline.build_pipeline(cfg, device="cpu")
    plain = tpipeline.build_pipeline(
        tschema.DataConfig(**{**cfg.__dict__, "prefetch": 0}), device="cpu")
    assert isinstance(pre, tpipeline.PrefetchingPipeline)
    assert isinstance(plain, tpipeline.DataPipeline)
    try:
        for step in (0, 1, 2, 3, 7, 8, 2, 3):  # 7 and 2: seeks
            got, want = pre.global_batch(step), plain.global_batch(step)
            assert torch.equal(got["tokens"], want["tokens"])
    finally:
        pre.close()
    # Re-opens after close(), as a second fit() needs.
    assert torch.equal(pre.global_batch(4)["tokens"],
                       plain.global_batch(4)["tokens"])
    pre.close()
    eval_split = tpipeline.build_pipeline(cfg, split="eval", device="cpu")
    assert isinstance(eval_split, tpipeline.DataPipeline)


@pytest.mark.parametrize("times", [1, 2])
def test_loader_retries_match_jax(times):
    extra = dict(loader_retry_backoff_s=0.0)
    jp, tp = _pair("lm_synthetic", seq_len=8, vocab_size=20, **extra)
    spec = [dict(site="data.loader", key="2", times=times)]
    with jfaults.active(jfaults.FaultPlan(spec)):
        want = [jp.local_batch(s) for s in range(4)]
    with tfaults.active(tfaults.FaultPlan(spec)):
        got = [tp.local_batch(s) for s in range(4)]
    assert tp.loader_retries == jp.loader_retries == times
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"], w["tokens"])


def test_loader_budget_exhaustion_raises_alike():
    extra = dict(loader_retry_backoff_s=0.0, loader_max_retries=1)
    jp, tp = _pair("lm_synthetic", seq_len=8, vocab_size=20, **extra)
    spec = [dict(site="data.loader", key="1", times=0)]
    errors = []
    for faults_mod, p in ((jfaults, jp), (tfaults, tp)):
        with faults_mod.active(faults_mod.FaultPlan(spec)):
            with pytest.raises(RuntimeError) as err:
                p.local_batch(1)
        errors.append(str(err.value))
    assert errors[0] == errors[1] == "injected fault: data.loader key=1"
    assert tp.loader_retries == jp.loader_retries == 1


def test_lm_shards_and_unknown_sources_are_refused(tmp_path):
    """Streaming token bins are refused, naming their item; an unknown
    dataset raises."""
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        tpipeline.build_pipeline(
            tschema.DataConfig(name="lm", data_dir=str(tmp_path),
                               streaming=True), device="cpu")
    with pytest.raises(KeyError, match="unknown dataset"):
        tpipeline.build_pipeline(tschema.DataConfig(name="nope"),
                                 device="cpu")
