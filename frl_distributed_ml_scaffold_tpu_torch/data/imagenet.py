"""ImageNet-shaped batches: the port's ``ImageNet`` with the synthetic
source only.

The JAX package's ``ImageNet`` memmaps pre-decoded ``.npy`` shards from
``data.data_dir`` and augments them with its native kernel, and falls
back to ``SyntheticImages`` when no directory is given. The port has the
fallback: with no ``data_dir`` a batch is the JAX package's synthetic
batch, bit for bit. A ``data_dir`` raises: the shard loader and the
native augment are ROADMAP queue A item 9, and reading synthetic images
in place of a user's shards would be a silent change of the data.
"""

from __future__ import annotations

from frl_distributed_ml_scaffold_tpu_torch.config.schema import DataConfig
from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticImages


class ImageNet:
    def __init__(self, cfg: DataConfig, *, split: str):
        if cfg.data_dir:
            raise NotImplementedError(
                f"data.data_dir={cfg.data_dir!r}: the ImageNet shard loader "
                "and its native augment are not ported yet (ROADMAP queue A "
                "item 9); leave data_dir unset for the synthetic images"
            )
        self._source = SyntheticImages(cfg, split=split)

    def batch(self, step: int, batch_size: int, host_offset: int = 0) -> dict:
        return self._source.batch(step, batch_size, host_offset)
