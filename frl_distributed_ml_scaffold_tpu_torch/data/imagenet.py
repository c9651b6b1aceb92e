"""ImageNet-shaped batches: the port of the JAX package's
``data/imagenet.py``. Pre-decoded ``.npy`` shards when ``data.data_dir``
holds them, else the synthetic class-prototype images.

The shards are ``{split}_images_XXX.npy`` (float32 in [0, 1] or uint8
0-255, stored at a size >= ``data.image_size``) and
``{split}_labels_XXX.npy``, memmapped per shard (``data/shards.py``).
A batch draws sorted indices from a generator seeded with ``(seed, step,
host_offset)``, gathers them through the native core (uint8 scaled to
[0, 1] in the same pass) and augments them there: random crop, flip and
normalize for train, center crop and normalize for eval, seeded with
``hash((seed, step, host_offset))``. CPython hashes a tuple of ints the
same in every process, so a batch equals the JAX package's bit for bit.
A ``data_dir`` without shards warns and takes the synthetic source.

``data.streaming=true`` on the train split raises: the streaming reader
is ROADMAP A13 (``data/streaming.py``).
"""

from __future__ import annotations

import numpy as np

from frl_distributed_ml_scaffold_tpu_torch.config.schema import DataConfig
from frl_distributed_ml_scaffold_tpu_torch.data import native
from frl_distributed_ml_scaffold_tpu_torch.data.shards import (
    ShardedNpyCorpus,
    refuse_streaming,
    warn_missing,
)
from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticImages


class ImageNet:
    def __init__(self, cfg: DataConfig, *, split: str):
        refuse_streaming(cfg, split)
        self.cfg = cfg
        self._fallback = None
        self._corpus = None
        self._train = split == "train"
        if cfg.data_dir:
            corpus = ShardedNpyCorpus(cfg.data_dir, split, "images")
            if corpus.found:
                shape = corpus.item_shape
                if min(shape[0], shape[1]) < cfg.image_size:
                    raise ValueError(
                        f"stored shards are {shape[0]}x{shape[1]} but "
                        f"data.image_size={cfg.image_size}; shards must be "
                        "stored at >= the model input size")
                self._corpus = corpus
                self._seed = cfg.shuffle_seed
            else:
                warn_missing(cfg.data_dir, "images", split)
        if self._corpus is None:
            self._fallback = SyntheticImages(cfg, split=split)

    @property
    def is_synthetic(self) -> bool:
        return self._fallback is not None

    def batch(self, step: int, batch_size: int, host_offset: int = 0) -> dict:
        """``{"image": float32 [B, S, S, C], "label": int32 [B]}``."""
        if self._fallback is not None:
            return self._fallback.batch(step, batch_size, host_offset)
        rng = np.random.default_rng((self._seed, step, host_offset))
        idx = np.sort(rng.integers(0, self._corpus.n, size=batch_size))
        x, labels = self._corpus.gather(idx)
        # Always through the augment: normalize (and flip) apply even when
        # the stored size is the input size.
        x = native.augment_batch(
            x, self.cfg.image_size,
            seed=hash((self._seed, step, host_offset)) & (2**63 - 1),
            train=self._train)
        return {"image": x, "label": labels}
