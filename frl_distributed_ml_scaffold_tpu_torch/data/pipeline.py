"""Pipeline assembly: dataset -> step-indexed batches -> tensors on the
trainer's device. The port of the JAX package's ``data/pipeline.py``.

The pull model (``batch(step)``) makes the stream a pure function of the
step: a resume at step k reproduces the batch the failed run would have
seen. The port runs one process, so the local batch is the global one.
"""

from __future__ import annotations

import concurrent.futures

import numpy as np
import torch

from frl_distributed_ml_scaffold_tpu_torch import faults, resolve_device
from frl_distributed_ml_scaffold_tpu_torch.config.schema import DataConfig
from frl_distributed_ml_scaffold_tpu_torch.faults import RetryPolicy

Batch = dict[str, np.ndarray]


def _build_source(cfg: DataConfig, split: str):
    name = cfg.name
    if name in ("mnist", "synthetic_mnist"):
        from frl_distributed_ml_scaffold_tpu_torch.data.mnist import MNIST

        return MNIST(cfg, split=split)
    if name in ("imagenet", "synthetic_imagenet"):
        from frl_distributed_ml_scaffold_tpu_torch.data.imagenet import (
            ImageNet,
        )

        return ImageNet(cfg, split=split)
    if name == "lm":
        from frl_distributed_ml_scaffold_tpu_torch.data.lm import TokenBinLM

        return TokenBinLM(cfg, split=split)
    if name == "lm_synthetic":
        from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import (
            SyntheticLM,
        )

        return SyntheticLM(cfg, split=split)
    if name == "video":
        from frl_distributed_ml_scaffold_tpu_torch.data.video import VideoClips

        return VideoClips(cfg, split=split)
    if name == "video_synthetic":
        from frl_distributed_ml_scaffold_tpu_torch.data.synthetic import (
            SyntheticVideo,
        )

        return SyntheticVideo(cfg, split=split)
    raise KeyError(f"unknown dataset {name!r}")


class DataPipeline:
    """Step-indexed batches on one device.

    ``local_batch(step)`` is the host batch (numpy), built under the
    ``RetryPolicy`` and the ``data.loader`` fault site; ``global_batch``
    returns it as tensors on ``device`` (``None`` means ``cuda`` and
    raises without a card)."""

    def __init__(self, cfg: DataConfig, *, split: str = "train",
                 device=None):
        self.cfg = cfg
        self.split = split
        self.device = resolve_device(device)
        self.source = _build_source(cfg, split)
        self.local_batch_size = cfg.global_batch_size
        # The batch is a pure function of step, so a transient failure is
        # safely rebuilt; the budget's last exception propagates.
        self._retry = RetryPolicy(
            max_retries=cfg.loader_max_retries,
            backoff_s=cfg.loader_retry_backoff_s,
            max_backoff_s=max(cfg.loader_retry_backoff_s * 8, 1e-9),
        )
        #: Batch-build retries this pipeline performed.
        self.loader_retries = 0

    def _count_retry(self, attempt: int, exc: BaseException) -> None:
        self.loader_retries += 1

    def local_batch(self, step: int) -> Batch:
        def build() -> Batch:
            faults.maybe_raise("data.loader", key=step)
            return self.source.batch(step, self.local_batch_size,
                                     host_offset=0)

        return self._retry.call(build,
                                describe=f"{self.split} batch(step={step})",
                                on_retry=self._count_retry)

    def global_batch(self, step: int) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in self.local_batch(step).items()}


class PrefetchingPipeline:
    """Builds batches ahead of the consumer on one worker thread.

    Batches stay pure functions of step (a prefetched batch that is never
    consumed is rebuilt after a restart). On the card the worker copies
    each host batch into pinned memory and from there to the device on a
    side stream, and records an event; the consumer makes its current
    stream wait on that event and marks each tensor as used on it
    (``record_stream``), so the step never reads a half-copied batch and
    the allocator never hands the memory out while the step reads it."""

    def __init__(self, pipeline: DataPipeline, depth: int = 2):
        self._p = pipeline
        self._depth = max(1, depth)
        self._futures: dict[int, concurrent.futures.Future] = {}
        self._ex: concurrent.futures.ThreadPoolExecutor | None = None
        self._stream = (torch.cuda.Stream(pipeline.device)
                        if pipeline.device.type == "cuda" else None)

    @property
    def loader_retries(self):
        return self._p.loader_retries

    @property
    def source(self):
        return self._p.source

    def global_batch(self, step: int) -> dict[str, torch.Tensor]:
        if self._ex is None:  # re-open after close() (fit re-entry)
            self._ex = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="frl-data-prefetch")
        # A resume or seek: drop prefetches of another step range.
        stale = [s for s in self._futures
                 if s < step or s > step + self._depth]
        for s in stale:
            self._futures.pop(s).cancel()
        fut = self._futures.pop(step, None)
        for s in range(step + 1, step + 1 + self._depth):
            if s not in self._futures:
                self._futures[s] = self._ex.submit(self._build, s)
        batch, event = fut.result() if fut is not None else self._build(step)
        if event is not None:
            current = torch.cuda.current_stream(self._p.device)
            current.wait_event(event)
            for t in batch.values():
                t.record_stream(current)
        return batch

    def _build(self, step: int):
        """(batch on the device, the copy's event or None). Runs on the
        worker, or on the consumer after a cache miss."""
        host = self._p.local_batch(step)
        dev = self._p.device
        if self._stream is None:
            return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    for k, v in host.items()}, None
        with torch.cuda.stream(self._stream):
            batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                     .pin_memory().to(dev, non_blocking=True)
                     for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return batch, event

    def close(self) -> None:
        """Cancel in-flight work and release the worker thread (the loop
        calls this on exit; the pipeline re-opens if used again)."""
        for fut in self._futures.values():
            fut.cancel()
        self._futures.clear()
        if self._ex is not None:
            self._ex.shutdown(wait=True, cancel_futures=True)
            self._ex = None


def build_pipeline(cfg: DataConfig, split: str = "train", *, device=None):
    """A ``DataPipeline`` on ``device``, behind a ``PrefetchingPipeline``
    for the train split when ``cfg.prefetch > 0``."""
    pipeline = DataPipeline(cfg, split=split, device=device)
    if split == "train" and cfg.prefetch > 0:
        return PrefetchingPipeline(pipeline, depth=cfg.prefetch)
    return pipeline
