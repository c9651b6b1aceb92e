"""Video clips: the port of the JAX package's ``data/video.py``.
Pre-decoded ``.npy`` clip shards when ``data.data_dir`` holds them, else
the synthetic drifting prototypes.

The shards are ``{split}_clips_XXX.npy`` ``(N, T, H, W, C)`` (float32,
or uint8 scaled to [0, 1] by the gather) and ``{split}_labels_XXX.npy``
``(N,)``, memmapped per shard and gathered through the native core
(``data/shards.py``); ``write_clip_shards`` is the producer side. A
batch draws sorted indices from a generator seeded with ``(seed, step,
host_offset)``, the eval split's seed salted by 7919, so a batch equals
the JAX package's bit for bit. A ``data_dir`` without shards warns and
takes the synthetic source.

``data.streaming=true`` reads the train split through a
``StreamingShardCorpus`` (``data/streaming.py``), as ``data/imagenet.py``
does.
"""

from __future__ import annotations

import os

import numpy as np

from frl_distributed_ml_scaffold_tpu_torch.config.schema import DataConfig
from frl_distributed_ml_scaffold_tpu_torch.data.shards import (
    ShardedNpyCorpus,
    warn_missing,
)
from frl_distributed_ml_scaffold_tpu_torch.data.streaming import (
    StreamingShardCorpus,
)
from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticVideo


def write_clip_shards(out_dir: str, clips: np.ndarray, labels: np.ndarray,
                      *, split: str = "train", shard_size: int = 256) -> int:
    """Write ``(N, T, H, W, C)`` clips (as float32) and ``(N,)`` labels
    as memmappable shards; returns the shard count."""
    clips = np.asarray(clips, np.float32)
    labels = np.asarray(labels, np.int32)
    if clips.ndim != 5 or labels.ndim != 1 or len(clips) != len(labels):
        raise ValueError(
            f"clips must be (N,T,H,W,C) with matching (N,) labels; got "
            f"{clips.shape} / {labels.shape}")
    os.makedirs(out_dir, exist_ok=True)
    n_shards = 0
    for i in range(0, len(clips), shard_size):
        np.save(os.path.join(out_dir, f"{split}_clips_{n_shards:03d}.npy"),
                clips[i: i + shard_size])
        np.save(os.path.join(out_dir, f"{split}_labels_{n_shards:03d}.npy"),
                labels[i: i + shard_size])
        n_shards += 1
    return n_shards


class VideoClips:
    def __init__(self, cfg: DataConfig, *, split: str):
        self.cfg = cfg
        self._fallback = None
        self._corpus = None
        if cfg.data_dir:
            if cfg.streaming and split == "train":
                # Train split only, as data/imagenet.py.
                corpus = StreamingShardCorpus(
                    cfg.data_dir, split, "clips",
                    refresh_every=cfg.streaming_refresh_every)
            else:
                corpus = ShardedNpyCorpus(cfg.data_dir, split, "clips")
            if corpus.found:
                want = (cfg.num_frames, cfg.image_size, cfg.image_size,
                        cfg.channels)
                if corpus.item_shape != want:
                    raise ValueError(
                        f"stored clips are {corpus.item_shape} but the config "
                        f"wants {want}; re-shard or fix data.num_frames/"
                        "image_size")
                self._corpus = corpus
            else:
                warn_missing(cfg.data_dir, "clips", split)
        if self._corpus is None:
            self._fallback = SyntheticVideo(cfg, split=split)
        self._seed = cfg.shuffle_seed + (0 if split == "train" else 7919)

    @property
    def is_synthetic(self) -> bool:
        return self._fallback is not None

    def batch(self, step: int, batch_size: int, host_offset: int = 0) -> dict:
        """``{"video": float32 [B, T, H, W, C], "label": int32 [B]}``."""
        if self._fallback is not None:
            return self._fallback.batch(step, batch_size, host_offset)
        if hasattr(self._corpus, "maybe_refresh"):
            self._corpus.maybe_refresh(step)  # see data/streaming.py
        rng = np.random.default_rng((self._seed, step, host_offset))
        idx = np.sort(rng.integers(0, self._corpus.n, size=batch_size))
        x, y = self._corpus.gather(idx)
        return {"video": x, "label": y}
