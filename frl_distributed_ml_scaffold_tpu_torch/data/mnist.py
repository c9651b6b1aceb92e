"""MNIST: the port of the JAX package's ``data/mnist.py``.

Real files when ``data.data_dir`` holds them (``mnist.npz``, or the IDX
files, gzipped or raw), else the class-prototype ``SyntheticImages``
(same shapes and dtypes, also learnable). No download path. Images are
normalised as ``(x / 255 - 0.1307) / 0.3081`` to [N, 28, 28, 1] float32;
a batch is drawn with replacement by a generator seeded with
``(shuffle_seed, step, host_offset)``. Batches equal the JAX package's
bit for bit.
"""

from __future__ import annotations

import gzip
import os

import numpy as np

from frl_distributed_ml_scaffold_tpu_torch.config.schema import DataConfig
from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticImages


def _load_idx(path: str) -> np.ndarray:
    """An IDX file (``.gz`` or raw) of unsigned bytes as an array of its
    header's dims."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    ndim = data[3]
    dims = [int.from_bytes(data[4 + 4 * i: 8 + 4 * i], "big")
            for i in range(ndim)]
    return np.frombuffer(data, dtype=np.uint8,
                         offset=4 + 4 * ndim).reshape(dims)


def _find_real_mnist(data_dir: str, split: str):
    """``(images, labels)`` of ``split`` from ``data_dir``, or None."""
    npz = os.path.join(data_dir, "mnist.npz")
    if os.path.exists(npz):
        with np.load(npz) as z:
            if split == "train":
                return z["x_train"], z["y_train"]
            return z["x_test"], z["y_test"]
    prefix = "train" if split == "train" else "t10k"
    for ext in (".gz", ""):
        xi = os.path.join(data_dir, f"{prefix}-images-idx3-ubyte{ext}")
        yi = os.path.join(data_dir, f"{prefix}-labels-idx1-ubyte{ext}")
        if os.path.exists(xi) and os.path.exists(yi):
            return _load_idx(xi), _load_idx(yi)
    return None


class MNIST:
    """Batches of real MNIST, or of the synthetic fallback."""

    def __init__(self, cfg: DataConfig, *, split: str):
        self.cfg = cfg
        self._fallback = None
        found = _find_real_mnist(cfg.data_dir, split) if cfg.data_dir else None
        if found is not None:
            x, y = found
            x = (x.astype(np.float32) / 255.0 - 0.1307) / 0.3081
            self._x = x.reshape(len(x), 28, 28, 1)
            self._y = y.astype(np.int32)
            self._seed = cfg.shuffle_seed
        else:
            self._fallback = SyntheticImages(cfg, split=split)

    @property
    def is_synthetic(self) -> bool:
        return self._fallback is not None

    def batch(self, step: int, batch_size: int, host_offset: int = 0) -> dict:
        """``{"image": float32 [B, 28, 28, 1], "label": int32 [B]}``."""
        if self._fallback is not None:
            return self._fallback.batch(step, batch_size, host_offset)
        rng = np.random.default_rng((self._seed, step, host_offset))
        idx = rng.integers(0, len(self._x), size=batch_size)
        return {"image": self._x[idx], "label": self._y[idx]}
