"""The port's shard loaders (frl_distributed_ml_scaffold_tpu_torch/data/
shards.py, imagenet.py, video.py, lm.py) against the JAX package's, on
files the test writes from a numpy seed.

- ``ImageNet`` over uint8 and float32 shards stored at 40 px and cropped
  to 32, ``VideoClips`` over clip shards and ``TokenBinLM`` over uint16
  and uint32 token bins: batches equal the JAX package's bit for bit for
  a few steps, both splits, ``host_offset`` 0 and 1.
- ``ShardedNpyCorpus.gather`` over several shards gives each index's
  row and label, and refuses unsorted indices.
- The pairing, shape, vocab, length and dtype errors raise with the JAX
  package's messages; a ``data_dir`` without files warns and takes the
  synthetic source in both; streaming is refused, naming A13.
- The port's ``DataPipeline`` with ``data.name=lm`` equals the JAX
  pipeline's batches, and two ``Trainer`` steps of a tiny GPT read a
  token bin through it on the CPU.
"""

from __future__ import annotations

import _torch_threads  # noqa: F401  (before any torch op)

import logging

import numpy as np
import pytest

from frl_distributed_ml_scaffold_tpu.config import schema as jschema
from frl_distributed_ml_scaffold_tpu.data import imagenet as jimagenet
from frl_distributed_ml_scaffold_tpu.data import lm as jlm
from frl_distributed_ml_scaffold_tpu.data import pipeline as jpipeline
from frl_distributed_ml_scaffold_tpu.data import shards as jshards
from frl_distributed_ml_scaffold_tpu.data import video as jvideo
from frl_distributed_ml_scaffold_tpu.dist.mesh import build_mesh
from frl_distributed_ml_scaffold_tpu_torch.config import schema as tschema
from frl_distributed_ml_scaffold_tpu_torch.data import imagenet as timagenet
from frl_distributed_ml_scaffold_tpu_torch.data import lm as tlm
from frl_distributed_ml_scaffold_tpu_torch.data import pipeline as tpipeline
from frl_distributed_ml_scaffold_tpu_torch.data import shards as tshards
from frl_distributed_ml_scaffold_tpu_torch.data import video as tvideo
from frl_distributed_ml_scaffold_tpu_torch.utils.logging import get_logger

IMAGE = dict(name="imagenet", image_size=32, channels=3, num_classes=10,
             shuffle_seed=4)
VIDEO = dict(name="video", image_size=8, channels=3, num_frames=3,
             num_classes=5, shuffle_seed=2)
LM = dict(name="lm", seq_len=32, vocab_size=1000, shuffle_seed=1)
STEPS = ((0, 0), (1, 0), (3, 1))


def _image_shards(root, dtype, split="train", sizes=(20, 20, 9), px=40):
    rng = np.random.default_rng(11)
    for i, n in enumerate(sizes):
        x = rng.integers(0, 256, (n, px, px, 3), dtype=np.uint8)
        if dtype == np.float32:
            x = (x / np.float32(255)).astype(np.float32)
        tshards.sealed_save(str(root / f"{split}_images_{i:03d}.npy"), x)
        tshards.sealed_save(str(root / f"{split}_labels_{i:03d}.npy"),
                            rng.integers(0, 10, n).astype(np.int64))


def _equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
def test_imagenet_shards_match_jax(tmp_path, dtype):
    for split in ("train", "eval"):
        _image_shards(tmp_path, dtype, split)
    for split in ("train", "eval"):
        cfg = dict(IMAGE, data_dir=str(tmp_path))
        t = timagenet.ImageNet(tschema.DataConfig(**cfg), split=split)
        j = jimagenet.ImageNet(jschema.DataConfig(**cfg), split=split)
        assert not t.is_synthetic and not j.is_synthetic
        for step, off in STEPS:
            got = t.batch(step, 6, off)
            _equal(got, j.batch(step, 6, off))
            assert got["image"].shape == (6, 32, 32, 3)
    # A later step draws other indices and crops.
    assert not np.array_equal(t.batch(0, 6)["image"], t.batch(1, 6)["image"])


@pytest.mark.parametrize("dtype", [np.uint8, np.float32], ids=["u8", "f32"])
def test_corpus_gather_across_shards(tmp_path, dtype):
    _image_shards(tmp_path, dtype)
    t = tshards.ShardedNpyCorpus(str(tmp_path), "train", "images")
    j = jshards.ShardedNpyCorpus(str(tmp_path), "train", "images")
    assert list(t.offsets) == [0, 20, 40, 49]
    # Every shard, a shard skipped, repeats, both ends.
    for idx in ([0, 0, 19, 20, 39, 40, 48], [3, 45, 45], [41], []):
        idx = np.array(idx, np.int64)
        x, y = t.gather(idx)
        assert x.shape == (len(idx), 40, 40, 3) and x.dtype == np.float32
        jx, jy = j.gather(idx)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(y, jy)
        want = np.concatenate(t.shards)[idx].astype(np.float32)
        if dtype == np.uint8:
            want *= np.float32(1) / np.float32(255)
        np.testing.assert_array_equal(x, want)
    with pytest.raises(ValueError, match="sorted indices"):
        t.gather(np.array([5, 2]))


def test_video_clip_shards_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    clips = rng.random((30, 3, 8, 8, 3), dtype=np.float32)
    labels = rng.integers(0, 5, 30)
    for split in ("train", "eval"):
        assert tvideo.write_clip_shards(str(tmp_path / "t"), clips, labels,
                                        split=split, shard_size=12) == 3
        jvideo.write_clip_shards(str(tmp_path / "j"), clips, labels,
                                 split=split, shard_size=12)
    for name in sorted(p.name for p in (tmp_path / "j").iterdir()):
        assert (tmp_path / "t" / name).read_bytes() == (
            tmp_path / "j" / name).read_bytes()
    for split in ("train", "eval"):
        cfg = dict(VIDEO, data_dir=str(tmp_path / "t"))
        t = tvideo.VideoClips(tschema.DataConfig(**cfg), split=split)
        j = jvideo.VideoClips(jschema.DataConfig(**cfg), split=split)
        assert not t.is_synthetic
        for step, off in STEPS:
            _equal(t.batch(step, 5, off), j.batch(step, 5, off))
    with pytest.raises(ValueError) as te:
        tvideo.VideoClips(tschema.DataConfig(
            **dict(VIDEO, num_frames=4, data_dir=str(tmp_path / "t"))),
            split="train")
    with pytest.raises(ValueError) as je:
        jvideo.VideoClips(jschema.DataConfig(
            **dict(VIDEO, num_frames=4, data_dir=str(tmp_path / "t"))),
            split="train")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("vocab", [1000, 70000], ids=["u16", "u32"])
def test_token_bins_match_jax(tmp_path, vocab):
    toks = np.random.default_rng(3).integers(0, vocab, 5000)
    tlm.write_token_bin(str(tmp_path / "t" / "train.bin"), toks,
                        vocab_size=vocab)
    jlm.write_token_bin(str(tmp_path / "j" / "train.bin"), toks,
                        vocab_size=vocab)
    tlm.append_token_bin(str(tmp_path / "t" / "train.bin"), toks[:100])
    jlm.append_token_bin(str(tmp_path / "j" / "train.bin"), toks[:100])
    for name in ("train.bin", "train.bin.json"):
        assert (tmp_path / "t" / name).read_bytes() == (
            tmp_path / "j" / name).read_bytes()
    # The eval split has no bin: it samples train.bin with a salted seed.
    for split in ("train", "eval"):
        cfg = dict(LM, vocab_size=vocab, data_dir=str(tmp_path / "t"))
        t = tlm.TokenBinLM(tschema.DataConfig(**cfg), split=split)
        j = jlm.TokenBinLM(jschema.DataConfig(**cfg), split=split)
        assert not t.is_synthetic
        for step, off in STEPS:
            got = t.batch(step, 4, off)
            _equal(got, j.batch(step, 4, off))
            assert got["tokens"].shape == (4, 33)


def _raises_alike(tfn, jfn, exc=ValueError):
    with pytest.raises(exc) as te:
        tfn()
    with pytest.raises(exc) as je:
        jfn()
    assert str(te.value) == str(je.value)
    return str(te.value)


def test_errors_raise_as_in_jax(tmp_path):
    def both(cls_t, cls_j, **cfg):
        return (lambda: cls_t(tschema.DataConfig(**cfg), split="train"),
                lambda: cls_j(jschema.DataConfig(**cfg), split="train"))

    # A labels shard missing: the halves do not pair up.
    unpaired = tmp_path / "unpaired"
    unpaired.mkdir()
    _image_shards(unpaired, np.uint8)
    (unpaired / "train_labels_001.npy").unlink()
    msg = _raises_alike(*both(timagenet.ImageNet, jimagenet.ImageNet,
                              **dict(IMAGE, data_dir=str(unpaired))))
    assert "do not pair up" in msg
    # Shards of different shapes.
    mixed = tmp_path / "mixed"
    mixed.mkdir()
    _image_shards(mixed, np.uint8, sizes=(4,))
    tshards.sealed_save(str(mixed / "train_images_001.npy"),
                        np.zeros((2, 44, 40, 3), np.uint8))
    tshards.sealed_save(str(mixed / "train_labels_001.npy"),
                        np.zeros(2, np.int64))
    assert "inconsistent images shard shapes" in _raises_alike(
        *both(timagenet.ImageNet, jimagenet.ImageNet,
              **dict(IMAGE, data_dir=str(mixed))))
    # More labels than images.
    counts = tmp_path / "counts"
    counts.mkdir()
    _image_shards(counts, np.uint8, sizes=(4,))
    tshards.sealed_save(str(counts / "train_labels_000.npy"),
                        np.zeros(5, np.int64))
    assert "4 images items but 5 labels" in _raises_alike(
        *both(timagenet.ImageNet, jimagenet.ImageNet,
              **dict(IMAGE, data_dir=str(counts))))
    # Stored below the input size.
    small = tmp_path / "small"
    small.mkdir()
    _image_shards(small, np.uint8, sizes=(3,), px=24)
    assert "stored at >= the model input size" in _raises_alike(
        *both(timagenet.ImageNet, jimagenet.ImageNet,
              **dict(IMAGE, data_dir=str(small))))
    # Token bins: a vocab above the config's, too few tokens, a bad dtype.
    lmdir = tmp_path / "lm"
    tlm.write_token_bin(str(lmdir / "train.bin"), np.arange(20),
                        vocab_size=2000)
    assert "vocab_size 2000" in _raises_alike(
        *both(tlm.TokenBinLM, jlm.TokenBinLM,
              **dict(LM, data_dir=str(lmdir))))
    assert "too short" in _raises_alike(
        *both(tlm.TokenBinLM, jlm.TokenBinLM,
              **dict(LM, vocab_size=2000, data_dir=str(lmdir))))
    (lmdir / "train.bin.json").write_text('{"dtype": "int8"}')
    assert "unsupported dtype" in _raises_alike(
        *both(tlm.TokenBinLM, jlm.TokenBinLM,
              **dict(LM, data_dir=str(lmdir))))
    # The producers' checks.
    for args in ((np.zeros((2, 2)),), (np.array([-1]),)):
        _raises_alike(lambda: tlm.write_token_bin(str(lmdir / "x.bin"),
                                                  *args),
                      lambda: jlm.write_token_bin(str(lmdir / "x.bin"),
                                                  *args))
    _raises_alike(lambda: tlm.append_token_bin(str(lmdir / "none.bin"), [1]),
                  lambda: jlm.append_token_bin(str(lmdir / "none.bin"), [1]))
    _raises_alike(
        lambda: tvideo.write_clip_shards(str(tmp_path), np.zeros((2, 3)),
                                         np.zeros(2)),
        lambda: jvideo.write_clip_shards(str(tmp_path), np.zeros((2, 3)),
                                         np.zeros(2)))


def test_missing_files_warn_and_go_synthetic(tmp_path):
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    logger = get_logger()
    logger.addHandler(handler)
    try:
        for cls, jcls, cfg in (
                (timagenet.ImageNet, jimagenet.ImageNet, IMAGE),
                (tvideo.VideoClips, jvideo.VideoClips, VIDEO),
                (tlm.TokenBinLM, jlm.TokenBinLM, LM)):
            cfg = dict(cfg, data_dir=str(tmp_path))
            records.clear()
            t = cls(tschema.DataConfig(**cfg), split="train")
            assert t.is_synthetic
            assert ["SYNTHETIC" in r.getMessage() for r in records] == [True]
            _equal(t.batch(2, 3, 1), jcls(jschema.DataConfig(**cfg),
                                          split="train").batch(2, 3, 1))
    finally:
        logger.removeHandler(handler)


def test_streaming_is_refused_naming_a13(tmp_path):
    _image_shards(tmp_path, np.uint8)
    for cls, cfg in ((timagenet.ImageNet, IMAGE), (tvideo.VideoClips, VIDEO),
                     (tlm.TokenBinLM, LM)):
        with pytest.raises(NotImplementedError, match="ROADMAP A13"):
            cls(tschema.DataConfig(**dict(cfg, data_dir=str(tmp_path),
                                          streaming=True)), split="train")
    # The eval split keeps the frozen view, as in the JAX package.
    _image_shards(tmp_path, np.uint8, split="eval")
    cfg = dict(IMAGE, data_dir=str(tmp_path), streaming=True)
    _equal(timagenet.ImageNet(tschema.DataConfig(**cfg),
                              split="eval").batch(0, 4),
           jimagenet.ImageNet(jschema.DataConfig(**cfg),
                              split="eval").batch(0, 4))


def test_aligned_pairs_and_label_classes_match_jax(tmp_path):
    for name in ("train_images_000.npy", "train_labels_000.npy",
                 "train_images_001.npy", "train_labels_002.npy",
                 "train_images_002.npy", "train_images_003.npy"):
        np.save(tmp_path / name, np.zeros(1))
    got = tshards.aligned_pair_paths(str(tmp_path), "train", "images")
    assert got == jshards.aligned_pair_paths(str(tmp_path), "train", "images")
    assert [p[0].rsplit("_", 1)[1] for p in got] == ["000.npy"]
    raw = tmp_path / "raw"
    for split, classes in (("train", "abc"), ("val", "bd")):
        for c in classes:
            (raw / split / c).mkdir(parents=True)
    assert tshards.derive_label_classes(str(raw), "val") == (
        jshards.derive_label_classes(str(raw), "val")) == (
        ["a", "b", "c", "d"], ["train", "val"])


def test_lm_pipeline_matches_jax_and_trains(tmp_path):
    from frl_distributed_ml_scaffold_tpu_torch.config import (
        apply_overrides,
        get_config,
    )
    from frl_distributed_ml_scaffold_tpu_torch.trainer.loop import Trainer

    toks = np.random.default_rng(8).integers(0, 512, 20000)
    tlm.write_token_bin(str(tmp_path / "train.bin"), toks, vocab_size=512)
    fields = dict(name="lm", global_batch_size=8, seq_len=64, vocab_size=512,
                  shuffle_seed=3, data_dir=str(tmp_path))
    jp = jpipeline.DataPipeline(jschema.DataConfig(**fields),
                                build_mesh(jschema.MeshConfig(data=-1)),
                                split="train")
    tp = tpipeline.DataPipeline(tschema.DataConfig(**fields), device="cpu")
    for step in (0, 1, 6):
        _equal(tp.local_batch(step), jp.local_batch(step))
        np.testing.assert_array_equal(tp.global_batch(step)["tokens"].numpy(),
                                      jp.local_batch(step)["tokens"])
    cfg = apply_overrides(get_config("gpt2_medium_zero1"), [
        "model.num_layers=1", "model.hidden_dim=64", "model.num_heads=2",
        "model.vocab_size=512", "model.seq_len=64", "data.seq_len=64",
        "data.vocab_size=512", "data.global_batch_size=4",
        "trainer.grad_accum=1", "model.attention=flash", "data.name=lm",
        f"data.data_dir={tmp_path}", "trainer.total_steps=2",
        "trainer.log_every=1", "trainer.eval_every=0",
        f"workdir={tmp_path / 'run'}"])
    trainer = Trainer(cfg, device="cpu")
    assert not trainer.pipeline.source.is_synthetic
    state, last = trainer.fit()
    assert state.step == 2 and np.isfinite(last["loss"])
