"""LM corpus: the port of the JAX package's ``data/lm.py``. A memmapped
token bin when ``data.data_dir`` holds one, else ``SyntheticLM``.

The format is the flat token binary: one ``{split}.bin`` of little-endian
uint16 (uint32 for vocabs above 65536) token ids, with a
``{split}.bin.json`` sidecar (``{"dtype": "uint16", "vocab_size": N}``).
``write_token_bin`` and ``append_token_bin`` are the producer side.

A batch draws ``batch_size`` window starts from a generator seeded with
``(seed, step, host_offset)`` (the eval split's seed salted by 7919) and
reads each ``seq_len + 1`` window (input and shifted target) through the
native core's ``gather_windows``; a batch equals the JAX package's bit
for bit. An eval split without its bin samples ``train.bin`` and says
so; a ``data_dir`` without the bin warns and takes the synthetic source.

``data.streaming=true`` reads the train split's bin through a
``StreamingTokenBin`` (``data/streaming.py``): its window widens to the
tokens a producer appends, checked once a batch; a missing bin, or one
under ``TOKEN_BLOCK`` tokens, raises. Other splits under it read a frozen
view cut to whole ``TOKEN_BLOCK``-token blocks, as the JAX package does.
"""

from __future__ import annotations

import json
import os

import numpy as np

from frl_distributed_ml_scaffold_tpu_torch.config.schema import DataConfig
from frl_distributed_ml_scaffold_tpu_torch.data import native
from frl_distributed_ml_scaffold_tpu_torch.data.streaming import (
    TOKEN_BLOCK,
    StreamingTokenBin,
)
from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import SyntheticLM
from frl_distributed_ml_scaffold_tpu_torch.utils.logging import get_logger

_BIN_DTYPES = {"uint16": np.uint16, "uint32": np.uint32}


def write_token_bin(path: str, tokens, *,
                    vocab_size: int | None = None) -> None:
    """Write a token stream as ``<path>`` and its sidecar: uint16 when the
    vocab (or, undeclared, the largest id) fits, else uint32."""
    tokens = np.asarray(tokens)
    if tokens.ndim != 1:
        raise ValueError(f"token stream must be 1-D, got shape {tokens.shape}")
    if tokens.size and int(tokens.min()) < 0:
        raise ValueError("token ids must be non-negative")
    hi = int(tokens.max()) if tokens.size else 0
    if vocab_size is not None and hi >= vocab_size:
        raise ValueError(
            f"token id {hi} out of range for vocab_size {vocab_size}")
    # The sidecar pins the dtype for every later append: size it from the
    # declared vocab, not from this chunk's largest id.
    limit = vocab_size - 1 if vocab_size is not None else hi
    dtype = np.uint16 if limit < 2**16 else np.uint32
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tokens.astype(dtype).tofile(path)
    sidecar = {"dtype": dtype.__name__}
    if vocab_size is not None:
        sidecar["vocab_size"] = int(vocab_size)
    with open(path + ".json", "w") as fh:
        json.dump(sidecar, fh)


def _read_sidecar(path: str) -> dict:
    sidecar_path = path + ".json"
    if os.path.exists(sidecar_path):
        with open(sidecar_path) as fh:
            return json.load(fh)
    return {}


def append_token_bin(path: str, tokens) -> None:
    """Grow a bin made by ``write_token_bin`` in place, in the dtype its
    sidecar pins."""
    sidecar = _read_sidecar(path)
    dtype = _BIN_DTYPES.get(sidecar.get("dtype"))
    if dtype is None:
        raise ValueError(
            f"{path} has no sidecar dtype; create the bin with "
            "write_token_bin first")
    tokens = np.asarray(tokens)
    if tokens.ndim != 1:
        raise ValueError(f"token stream must be 1-D, got shape {tokens.shape}")
    if tokens.size:
        hi, lo = int(tokens.max()), int(tokens.min())
        if lo < 0 or hi >= np.iinfo(dtype).max + 1:
            raise ValueError(
                f"token ids [{lo}, {hi}] do not fit the bin's pinned "
                f"dtype {dtype.__name__}")
        vocab = sidecar.get("vocab_size")
        if vocab is not None and hi >= vocab:
            raise ValueError(
                f"token id {hi} out of range for vocab_size {vocab}")
    with open(path, "ab") as fh:
        tokens.astype(dtype).tofile(fh)


def _bin_path(cfg: DataConfig, split: str) -> str | None:
    """The bin ``split`` reads, or None (with a warning) for none."""
    path = os.path.join(cfg.data_dir, f"{split}.bin")
    if not os.path.exists(path) and split != "train":
        train_path = os.path.join(cfg.data_dir, "train.bin")
        if os.path.exists(train_path):
            get_logger().warning(
                "lm data: no %s in %s; the %r split is sampling from "
                "train.bin (split-salted RNG) — these metrics are computed "
                "on TRAINING data", f"{split}.bin", cfg.data_dir, split)
        path = train_path
    if not os.path.exists(path):
        if cfg.streaming and split == "train":
            # A missing bin refuses like the shard view: the synthetic
            # fallback, decided once, would train on noise forever.
            raise ValueError(
                f"data.streaming=true but {path} does not exist. "
                "Start the tokenizer/producer first (write_token_"
                "bin creates the bin + sidecar) — the streaming "
                "loader refuses to guess.")
        get_logger().warning(
            "lm data: data_dir=%s has no %s.bin — falling back to SYNTHETIC "
            "random tokens; fix data.data_dir if a real corpus was intended",
            cfg.data_dir, split)
        return None
    return path


class TokenBinLM:
    """Memmapped token-bin corpus with step-indexed window sampling."""

    def __init__(self, cfg: DataConfig, *, split: str):
        self.cfg = cfg
        self._fallback = None
        self._mm = None
        self._stream = None
        path = _bin_path(cfg, split) if cfg.data_dir else None
        if path is not None:
            sidecar = _read_sidecar(path)
            dtype = _BIN_DTYPES.get(sidecar.get("dtype", "uint16"))
            if dtype is None:
                raise ValueError(
                    f"{path}.json names unsupported dtype "
                    f"{sidecar.get('dtype')!r}; expected uint16/uint32")
            if cfg.streaming and split == "train":
                self._stream = StreamingTokenBin(
                    path, dtype, refresh_every=cfg.streaming_refresh_every)
                self._mm = self._stream.tokens
            elif cfg.streaming:
                n_tok = os.path.getsize(path) // np.dtype(dtype).itemsize
                if n_tok >= TOKEN_BLOCK:
                    n_tok = (n_tok // TOKEN_BLOCK) * TOKEN_BLOCK
                self._mm = np.memmap(path, dtype=dtype, mode="r",
                                     shape=(n_tok,))
            else:
                self._mm = np.memmap(path, dtype=dtype, mode="r")
            vocab = sidecar.get("vocab_size")
            if vocab is not None and vocab > cfg.vocab_size:
                raise ValueError(
                    f"corpus {path} has vocab_size {vocab} but "
                    f"data.vocab_size={cfg.vocab_size}; the model would "
                    "see out-of-range ids")
            if len(self._mm) < cfg.seq_len + 2:
                raise ValueError(
                    f"corpus {path} has {len(self._mm)} tokens, too short "
                    f"for seq_len={cfg.seq_len}")
        if self._mm is None:
            self._fallback = SyntheticLM(cfg, split=split)
        self._seed = cfg.shuffle_seed + (0 if split == "train" else 7919)

    @property
    def is_synthetic(self) -> bool:
        return self._fallback is not None

    def batch(self, step: int, batch_size: int, host_offset: int = 0) -> dict:
        """``{"tokens": int32 [batch_size, seq_len + 1]}``."""
        if self._fallback is not None:
            return self._fallback.batch(step, batch_size, host_offset)
        if self._stream is not None:
            self._stream.maybe_refresh(step)  # see data/streaming.py
            self._mm = self._stream.tokens
        window = self.cfg.seq_len + 1
        rng = np.random.default_rng((self._seed, step, host_offset))
        starts = rng.integers(0, len(self._mm) - window, size=batch_size)
        return {"tokens": native.gather_windows(self._mm, starts, window)}
