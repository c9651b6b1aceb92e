"""Streaming views over growing corpora: the port of the JAX package's
``data/streaming.py``.

The frozen loaders read the corpus as it stood at construction. These
views let it grow, append-only, in two shapes:

- ``StreamingShardCorpus``: a producer keeps sealing
  ``{split}_{kind}_XXX.npy`` + ``{split}_labels_XXX.npy`` pairs into
  ``data.data_dir`` (``data/shards.py`` ``sealed_save``: ``*.tmp`` then
  ``os.replace``); the loader widens its sampling window to the new
  pairs.
- ``StreamingTokenBin``: a tokenizer keeps appending to ``{split}.bin``
  (``data/lm.py`` ``append_token_bin``); the loader widens its token
  window to the grown file.

Three decisions, the JAX package's:

1. **Sealing.** A scan never sees a torn shard: the labels shard is the
   pair's commit marker, and visibility is the longest index-contiguous
   prefix of sealed pairs (``aligned_pair_paths``, robust to
   out-of-order delivery). A token bin's visible count is its length
   rounded down to ``TOKEN_BLOCK`` tokens, so a half-flushed tail is
   never sampled.

2. **Hosts agree on the view over the filesystem, never a collective.**
   Each process publishes its visible ``(count, anchor)`` to
   ``.stream_sync/`` in the corpus directory (sealed writes); process 0
   alone computes the target window (the least count, anchors required
   equal) and publishes it with ``activate_at_bucket = bucket + 1``;
   every process, the leader included, adopts a published window at its
   own refresh of that bucket. Refresh buckets are ``step //
   refresh_every``, so every process widens at the same step to the same
   unit set (anchor and count). A process that cannot serve the window
   yet retries on the next batch (``_defer_adoption``). A collective
   here would deadlock: ``maybe_refresh`` runs on the prefetch worker
   thread (``data/pipeline.py``), unordered against the train step's
   collectives. The file names and JSON keys are the JAX package's, so
   a process of either package reads the other's. When re-pointing a
   ``data_dir`` at a new corpus, clear ``.stream_sync/`` first.

3. **Determinism is a watermark.** Between refreshes the view is frozen
   (the same (seed, step) gives the same batch), every widening is
   logged with its step and unit count, and ``state()`` exposes the
   watermark. Reproducing a run exactly needs the same directory growth.

The process count and index are the port's (``dist/initialize.py``).
"""

from __future__ import annotations

import json
import os
import re
import time
from typing import Callable, Optional

import numpy as np

from frl_distributed_ml_scaffold_tpu_torch.data.shards import (
    ShardedNpyCorpus,
    aligned_pair_paths,
)
from frl_distributed_ml_scaffold_tpu_torch.dist import initialize
from frl_distributed_ml_scaffold_tpu_torch.utils.logging import get_logger


def _sealed_pair_count(data_dir: str, split: str, kind: str) -> int:
    """Shard pairs eligible for reading: both halves sealed and every
    lower index sealed too (``aligned_pair_paths``)."""
    return len(aligned_pair_paths(data_dir, split, kind))


class _WindowProtocol:
    """The leader-published window agreement (module docstring, decision
    2), generic over what a unit is: shard pairs or token blocks.

    ``scan`` returns this process's local ``(count, anchor)``;
    ``self.visible`` is the adopted count (the owner updates it when it
    adopts a view)."""

    def __init__(self, data_dir: str, tag: str,
                 scan: Callable[[], tuple[int, int]]):
        self.data_dir = data_dir
        self.tag = tag
        self.scan = scan
        self.visible = 0

    def _sync_path(self, name: str) -> str:
        sync_dir = os.path.join(self.data_dir, ".stream_sync")
        os.makedirs(sync_dir, exist_ok=True)
        return os.path.join(sync_dir, f"{self.tag}_{name}.json")

    def _publish(self, count: int, anchor: int, pidx: int) -> None:
        path = self._sync_path(f"host_{pidx}")
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"count": count, "anchor": anchor}, fh)
        os.replace(tmp, path)

    def _read_json(self, name: str):
        try:
            with open(self._sync_path(name)) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            return None

    def _leader_propose(self, n_proc: int, bucket: int,
                        my_anchor: int) -> None:
        """Process 0 only: publish a bigger window once every process's
        publish is visible and the anchors agree, active from the next
        bucket so every process adopts it at the same refresh."""
        counts = []
        for p in range(n_proc):
            rec = self._read_json(f"host_{p}")
            if rec is None or rec.get("anchor") != my_anchor:
                return  # an unpublished peer or another anchor: wait
            counts.append(int(rec["count"]))
        target = min(counts)
        win = self._read_json("window")
        # A window left by an earlier corpus in this directory names
        # another anchor: its count says nothing of the current units,
        # and every live process has just published the new anchor, so
        # the leader repairs it.
        stale_anchor = (win is not None
                        and int(win.get("anchor", -1)) != my_anchor)
        current = 0 if (win is None or stale_anchor) else int(win["count"])
        # The first window is written even at target 0, so a start with
        # no data fails fast with the caller's refusal instead of every
        # follower timing out on an absent file.
        if win is None or stale_anchor or target > max(current, self.visible):
            tmp = self._sync_path("window") + ".tmp"
            with open(tmp, "w") as fh:
                json.dump({"count": target, "anchor": my_anchor,
                           "activate_at_bucket": bucket + 1}, fh)
            os.replace(tmp, self._sync_path("window"))

    def initial(self, deadline_s: float = 60.0) -> int:
        """The agreement at construction: every process publishes, the
        leader publishes the initial window, every process waits for it
        (bounded). Returns the agreed count, possibly 0: the caller
        decides whether 0 is a refusal."""
        deadline = time.monotonic() + deadline_s
        while True:
            count, anchor = self.scan()
            n_proc = initialize.process_count()
            if n_proc <= 1:
                return count
            pidx = initialize.process_index()
            self._publish(count, anchor, pidx)
            if pidx == 0:
                self._leader_propose(n_proc, bucket=-1, my_anchor=anchor)
            win = self._read_json("window")
            if win is not None:
                agreed = int(win["count"])
                if agreed > 0 and int(win.get("anchor", -1)) != anchor:
                    # The window names another unit set than this process
                    # sees (a stale .stream_sync file, or a view lagging a
                    # prefix rotation): adopting it would map indices onto
                    # the wrong units. Wait for one that matches, and fail
                    # loudly at the deadline.
                    win = None
                elif agreed <= 0 or count >= agreed:
                    # A same-anchor window from an earlier run is
                    # servable: the corpus is append-only.
                    return agreed
                # else: this process does not see the agreed prefix yet.
            if time.monotonic() >= deadline:
                raise ValueError(
                    f"data.streaming=true: no agreed initial window for "
                    f"{self.tag} under {self.data_dir}/.stream_sync within "
                    f"{deadline_s:.0f}s — are all hosts pointing at the "
                    "same shared data_dir?")
            time.sleep(1.0)

    def agree(self, bucket: int) -> Optional[tuple[int, int]]:
        """One refresh round: publish, the leader proposes; returns the
        active window ``(count, anchor)`` when it is bigger than
        ``visible``, else None."""
        count, anchor = self.scan()
        n_proc = initialize.process_count()
        if n_proc <= 1:
            return (count, anchor) if count > self.visible else None
        pidx = initialize.process_index()
        self._publish(count, anchor, pidx)
        if pidx == 0:
            self._leader_propose(n_proc, bucket, anchor)
        win = self._read_json("window")
        if (win is not None
                and int(win.get("activate_at_bucket", 0)) <= bucket
                and int(win["count"]) > self.visible):
            return int(win["count"]), int(win["anchor"])
        return None


#: Adoption retries within one refresh bucket before falling back to the
#: bucket boundary: a transient lag clears within a batch or two, but a
#: window this process can never serve must not cost a scan, a publish
#: and a warning on every batch. A bare budget, not a ``RetryPolicy``:
#: the next batch is the backoff.
RETRY_BUDGET_PER_BUCKET = 8


def _defer_adoption(view, step: int, bucket: int, why: str, *args) -> None:
    """The retry rule of both views: an agreed window ``view`` cannot
    serve yet is retried on the very next batch (peers already sample
    it), ``RETRY_BUDGET_PER_BUCKET`` times a bucket, then at the next
    bucket boundary. ``skew_deferrals`` in ``state()`` counts them."""
    view._skew_deferrals += 1
    view._bucket_retries += 1
    if view._bucket_retries <= RETRY_BUDGET_PER_BUCKET:
        view._next_refresh = step + 1
        suffix = " — retrying next batch"
    else:
        view._next_refresh = (bucket + 1) * view.refresh_every
        suffix = (" — retry budget exhausted this bucket, deferring to "
                  "the next refresh bucket")
    get_logger().warning("streaming: " + why + suffix, *args)


class StreamingShardCorpus:
    """A ``ShardedNpyCorpus`` whose shard window can widen.

    ``found`` / ``n`` / ``item_shape`` / ``gather`` are the current
    view's; the loader calls ``maybe_refresh(step)`` once a batch and the
    view re-scans every ``refresh_every`` steps. Shards already in the
    view are never re-opened: append-only keeps their memmaps valid."""

    def __init__(self, data_dir: str, split: str, kind: str,
                 refresh_every: int):
        self.data_dir, self.split, self.kind = data_dir, split, kind
        self.refresh_every = max(1, refresh_every)
        self._proto = _WindowProtocol(data_dir, f"{split}_{kind}",
                                      self._local_scan)
        agreed = self._proto.initial()
        if agreed == 0:
            # No sealed pair on some process (the count is the least over
            # processes, so all of them take this branch). An uncapped
            # view could crash on a half-sealed pair, and a synthetic
            # fallback, decided once, would train on fake data forever.
            raise ValueError(
                f"data.streaming=true but {data_dir} has no sealed "
                f"{split} {kind}+labels shard pair yet (on every host). "
                "Start the producer first, or wait for its first flush — "
                "the streaming loader refuses to guess.")
        self._proto.visible = agreed
        self._view = ShardedNpyCorpus(data_dir, split, kind,
                                      max_shards=agreed)
        self._next_refresh = self.refresh_every
        self._skew_deferrals = 0
        self._bucket_retries = 0
        self._bucket = -1
        get_logger().info("streaming: %s/%s view starts at %d shards "
                          "(%d items)", split, kind, agreed, self._view.n)

    def _local_scan(self) -> tuple[int, int]:
        """(count, anchor) of this process's sealed contiguous prefix;
        the anchor is the first pair's index, -1 when there is none."""
        pairs = aligned_pair_paths(self.data_dir, self.split, self.kind)
        if not pairs:
            return 0, -1
        m = re.search(r"_(\d+)\.npy$", os.path.basename(pairs[0][0]))
        return len(pairs), int(m.group(1)) if m else -1

    @property
    def found(self) -> bool:
        return self._view.found

    @property
    def n(self) -> int:
        return self._view.n

    @property
    def item_shape(self):
        return self._view.item_shape

    def gather(self, idx):
        return self._view.gather(idx)

    def maybe_refresh(self, step: int) -> None:
        if step < self._next_refresh:
            return
        bucket = step // self.refresh_every
        if bucket != self._bucket:
            self._bucket, self._bucket_retries = bucket, 0
        adopt = self._proto.agree(bucket)
        if adopt is None:
            self._next_refresh = (bucket + 1) * self.refresh_every
            return
        count, anchor = adopt
        my_count, my_anchor = self._local_scan()
        if my_anchor != anchor or my_count < count:
            _defer_adoption(
                self, step, bucket,
                "cannot serve agreed window (anchor %d/%d, count %d/%d)",
                my_anchor, anchor, my_count, count)
            return
        try:
            new_view = ShardedNpyCorpus(self.data_dir, self.split,
                                        self.kind, max_shards=count)
        except ValueError as e:
            # A transiently inconsistent directory must not kill a run.
            _defer_adoption(self, step, bucket,
                            "inconsistent shard view: %s", e)
            return
        if not new_view.found:
            _defer_adoption(self, step, bucket, "agreed window not readable")
            return
        get_logger().info(
            "streaming: widened %s/%s view %d -> %d shards "
            "(%d items) at step %d",
            self.split, self.kind, self._proto.visible, count,
            new_view.n, step)
        self._proto.visible = count
        self._view = new_view
        self._next_refresh = (bucket + 1) * self.refresh_every

    def state(self) -> dict:
        """The watermark (decision 3)."""
        return {"shards": self._proto.visible, "items": self.n,
                "skew_deferrals": self._skew_deferrals}


#: Token-bin visibility granularity: the visible count rounds down to
#: this many tokens, so a half-flushed tail is never sampled and proposals
#: stay coarse.
TOKEN_BLOCK = 8192


class StreamingTokenBin:
    """A growing flat token binary (``{split}.bin``, ``data/lm.py``'s
    format) whose visible token count widens.

    The producer appends in the sidecar's dtype; the visible window is
    the file length rounded down to ``TOKEN_BLOCK`` tokens, agreed by the
    shard view's protocol (the anchor is always 0: a flat file has one
    prefix). ``tokens`` re-memmaps on a widening; the old map stays valid
    because the file only grows."""

    def __init__(self, path: str, dtype, refresh_every: int):
        self.path = path
        self.dtype = np.dtype(dtype)
        self.refresh_every = max(1, refresh_every)
        self._proto = _WindowProtocol(
            os.path.dirname(path) or ".",
            os.path.basename(path).replace(".", "_"),
            self._local_scan)
        agreed = self._proto.initial()
        if agreed == 0:
            raise ValueError(
                f"data.streaming=true but {path} holds fewer than "
                f"{TOKEN_BLOCK} tokens (on every host). Start the "
                "tokenizer/producer first — the streaming loader "
                "refuses to guess.")
        self._proto.visible = agreed
        self._mm = np.memmap(path, dtype=self.dtype, mode="r",
                             shape=(agreed,))
        self._next_refresh = self.refresh_every
        self._skew_deferrals = 0
        self._bucket_retries = 0
        self._bucket = -1

    def _local_scan(self) -> tuple[int, int]:
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return 0, 0
        tokens = size // self.dtype.itemsize
        return (tokens // TOKEN_BLOCK) * TOKEN_BLOCK, 0

    def __len__(self) -> int:
        return int(self._proto.visible)

    @property
    def tokens(self) -> np.ndarray:
        return self._mm

    def maybe_refresh(self, step: int) -> None:
        if step < self._next_refresh:
            return
        bucket = step // self.refresh_every
        if bucket != self._bucket:
            self._bucket, self._bucket_retries = bucket, 0
        adopt = self._proto.agree(bucket)
        if adopt is None:
            self._next_refresh = (bucket + 1) * self.refresh_every
            return
        count, _ = adopt
        my_count, _ = self._local_scan()
        if my_count < count:
            _defer_adoption(
                self, step, bucket,
                "cannot serve agreed token window (%d local < %d agreed)",
                my_count, count)
            return
        get_logger().info("streaming: widened %s view %d -> %d tokens at "
                          "step %d", self.path, self._proto.visible, count,
                          step)
        self._proto.visible = count
        self._mm = np.memmap(self.path, dtype=self.dtype, mode="r",
                             shape=(count,))
        self._next_refresh = (bucket + 1) * self.refresh_every

    def state(self) -> dict:
        return {"tokens": int(self._proto.visible),
                "skew_deferrals": self._skew_deferrals}
