"""Deterministic, learnable synthetic data: the port's copies of the
JAX package's ``SyntheticImages`` and ``SyntheticLM``
(``data/synthetic.py``).

- images: per-class prototype patterns plus Gaussian noise, so a
  classifier can learn the label from the image;
- LM: tokens follow a noisy affine rule ``t+1 = (a*t + b) mod V``, so
  the next-token loss falls well below ``log(V)`` once a model learns it.

A batch is a pure function of ``(seed, step, host_offset)``, made with
numpy, and equals the JAX package's batch bit for bit.
"""

from __future__ import annotations

import numpy as np

from frl_distributed_ml_scaffold_tpu_torch.config.schema import DataConfig


class SyntheticImages:
    """Class-prototype images: ``x = prototype[label] + sigma * noise``,
    NHWC float32."""

    def __init__(self, cfg: DataConfig, *, split: str, sigma: float = 0.35):
        self.cfg = cfg
        self.sigma = sigma
        self._seed = cfg.shuffle_seed + (0 if split == "train" else 7919)
        proto_rng = np.random.default_rng(1234)  # shared by the splits
        shape = (cfg.num_classes, cfg.image_size, cfg.image_size,
                 cfg.channels)
        self.prototypes = proto_rng.standard_normal(shape, dtype=np.float32)

    def batch(self, step: int, batch_size: int, host_offset: int = 0) -> dict:
        """``{"image": float32 [B, H, W, C], "label": int32 [B]}``."""
        rng = np.random.default_rng((self._seed, step, host_offset))
        labels = rng.integers(0, self.cfg.num_classes, size=batch_size)
        noise = rng.standard_normal(
            (batch_size,) + self.prototypes.shape[1:], dtype=np.float32
        )
        images = self.prototypes[labels] + self.sigma * noise
        return {"image": images, "label": labels.astype(np.int32)}


class SyntheticLM:
    """Noisy affine next-token rule over the vocab."""

    A = 31
    B = 17
    NOISE_P = 0.05

    def __init__(self, cfg: DataConfig, *, split: str):
        self.cfg = cfg
        self._seed = cfg.shuffle_seed + (0 if split == "train" else 7919)

    def batch(self, step: int, batch_size: int, host_offset: int = 0) -> dict:
        """``{"tokens": int32 [batch_size, seq_len + 1]}``."""
        cfg = self.cfg
        rng = np.random.default_rng((self._seed, step, host_offset))
        toks = np.empty((batch_size, cfg.seq_len + 1), dtype=np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=batch_size)
        for t in range(cfg.seq_len):
            nxt = (self.A * toks[:, t] + self.B) % cfg.vocab_size
            flip = rng.random(batch_size) < self.NOISE_P
            nxt = np.where(
                flip, rng.integers(0, cfg.vocab_size, batch_size), nxt
            )
            toks[:, t + 1] = nxt
        return {"tokens": toks.astype(np.int32)}
