"""Video clips: the port's ``VideoClips`` with the synthetic source only.

The JAX package's ``VideoClips`` memmaps pre-decoded clip shards from
``data.data_dir`` and gathers them with its native kernel, and falls back
to ``SyntheticVideo`` when no directory is given. The port has the
fallback: with no ``data_dir`` a batch is the JAX package's synthetic
batch, bit for bit. A ``data_dir`` raises: the shard corpus and the
native gather come with the ImageNet shard loader (ROADMAP queue A item
9), and reading synthetic clips in place of a user's shards would be a
silent change of the data.
"""

from __future__ import annotations

from frl_distributed_ml_scaffold_tpu_torch.config.schema import DataConfig
from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticVideo


class VideoClips:
    def __init__(self, cfg: DataConfig, *, split: str):
        if cfg.data_dir:
            raise NotImplementedError(
                f"data.data_dir={cfg.data_dir!r}: the video clip-shard "
                "loader and its native gather are not ported yet (ROADMAP "
                "queue A item 9); leave data_dir unset for the synthetic "
                "clips"
            )
        self._source = SyntheticVideo(cfg, split=split)

    def batch(self, step: int, batch_size: int, host_offset: int = 0) -> dict:
        return self._source.batch(step, batch_size, host_offset)
