"""Shared sharded-.npy corpus machinery (ImageNet images, video clips):
the port of the JAX package's ``data/shards.py``.

One implementation of shard discovery, data/label pairing validation,
memmapping, offset bookkeeping, and the native per-shard gather — so the
per-dataset loaders hold only their format specifics (augmentation, shape
contracts). Validation happens at construction: a missing labels shard or a
shape-divergent data shard fails here with a clear error, never mid-run.
"""

from __future__ import annotations

import glob
import os
import re
import sys

import numpy as np


def derive_label_classes(
    raw_dir: str, split: str, splits_arg: str = "", out_dir: str = ""
) -> tuple[list[str], list[str]]:
    """Class list for label ids, consistent ACROSS splits (producer tier).

    Ids come from the sorted UNION of class directories over the split
    set — a class present in train but absent in val would otherwise
    shift every later id and silently mislabel eval. ``splits_arg``
    (comma-separated) pins the split set; default is every
    conventionally-named split dir under ``raw_dir`` (train/val/test...),
    falling back to all subdirs for unconventional layouts — so a stray
    non-split directory can't inject fake classes when the convention
    holds. When ``out_dir`` holds a ``*_meta.json`` from an earlier
    split run, its class list must match — mismatch raises rather than
    shipping shards whose train/val ids disagree.

    Returns ``(classes, split_names)``; raises ValueError with an
    operator-actionable message on any inconsistency.
    """
    import json as _json

    split_dir = os.path.join(raw_dir, split)
    if not os.path.isdir(split_dir):
        raise ValueError(f"split directory does not exist: {split_dir}")
    if splits_arg:
        split_names = [s for s in splits_arg.split(",") if s]
        if split not in split_names:
            raise ValueError(
                f"--split {split} not in --splits {split_names}"
            )
    else:
        subdirs = sorted(
            d for d in os.listdir(raw_dir)
            if os.path.isdir(os.path.join(raw_dir, d))
        )
        known = {"train", "val", "valid", "validation", "test", "eval"}
        if split in known and any(d in known for d in subdirs):
            split_names = [d for d in subdirs if d in known]
        else:
            split_names = subdirs
        print(
            f"deriving label ids from splits {split_names} "
            f"(pin with --splits if this is wrong)",
            file=sys.stderr,
        )
    union: set[str] = set()
    for sd in split_names:
        sdir = os.path.join(raw_dir, sd)
        if not os.path.isdir(sdir):
            raise ValueError(f"--splits names missing directory: {sdir}")
        union.update(
            d for d in os.listdir(sdir)
            if os.path.isdir(os.path.join(sdir, d))
        )
    classes = sorted(union)
    if not classes:
        raise ValueError(f"no class directories under {raw_dir}")
    if out_dir:
        for mp in sorted(glob.glob(os.path.join(out_dir, "*_meta.json"))):
            try:
                with open(mp) as fh:
                    prev = _json.load(fh).get("class_names")
            except (OSError, ValueError):
                continue
            if prev is not None and prev != classes:
                raise ValueError(
                    f"class list mismatch vs {mp}: existing {prev} != "
                    f"derived {classes}; re-run all splits against one "
                    "raw_dir"
                )
    return classes, split_names


def aligned_pair_paths(
    data_dir: str, split: str, kind: str
) -> list[tuple[str, str]]:
    """Sealed, index-contiguous (data, labels) shard pairs — the streaming
    tier's unit of visibility.

    A pair is eligible only when BOTH halves are sealed (renamed into
    place) AND every lower-indexed pair is too: producers append in index
    order, but an rsync from a decode farm delivers files in arbitrary
    order, so ``images_002`` may land before ``images_001`` — pairing by
    sorted-list position would then mislabel or crash. Indices are parsed
    and the walk stops at the first gap in EITHER half.
    """
    def by_index(tag: str) -> dict[int, str]:
        out = {}
        for p in glob.glob(
            os.path.join(data_dir, f"{split}_{tag}_*.npy")
        ):
            m = re.search(rf"{tag}_(\d+)\.npy$", os.path.basename(p))
            if m:
                out[int(m.group(1))] = p
        return out

    xs, ys = by_index(kind), by_index("labels")
    common = sorted(set(xs) & set(ys))
    pairs = []
    for j, idx in enumerate(common):
        if idx != common[0] + j:
            break  # gap: a lower-indexed shard is still in flight
        pairs.append((xs[idx], ys[idx]))
    return pairs


def sealed_save(path: str, arr: np.ndarray) -> None:
    """Write a shard ATOMICALLY: ``*.tmp`` then ``os.replace``.

    The streaming tier (``data/streaming.py``) re-scans the directory while
    producers write; a plain ``np.save`` exposes a torn half-written file
    under the final name. The open-file form keeps np.save from appending
    a second ``.npy`` to the tmp name.
    """
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.save(fh, arr)
    os.replace(tmp, path)


class ShardedNpyCorpus:
    """``{split}_{kind}_XXX.npy`` data shards + ``{split}_labels_XXX.npy``.

    ``found`` is False when ``data_dir`` holds no complete shard set (the
    caller decides how to fall back); any *inconsistent* shard set raises.
    """

    def __init__(self, data_dir: str, split: str, kind: str,
                 max_shards: int = 0):
        """``max_shards > 0`` caps the view to the first N index-contiguous
        sealed PAIRS (``aligned_pair_paths``): the streaming tier holds
        every host to the same agreed shard count this way while
        producers keep appending in any file order. The default (0, the
        frozen tier) keeps the strict all-shards view, whose pairing
        check RAISES on any inconsistency: a partially-copied frozen
        corpus is an error, not a window."""
        self.found = False
        if max_shards > 0:
            pairs = aligned_pair_paths(data_dir, split, kind)[:max_shards]
            xs = [x for x, _ in pairs]
            ys = [y for _, y in pairs]
        else:
            xs = sorted(
                glob.glob(os.path.join(data_dir, f"{split}_{kind}_*.npy")))
            ys = sorted(
                glob.glob(os.path.join(data_dir, f"{split}_labels_*.npy")))
        if not xs and not ys:
            return
        def _idx(paths, tag):
            out = []
            for p in paths:
                m = re.search(rf"{tag}_(\d+)\.npy$", os.path.basename(p))
                out.append(m.group(1) if m else os.path.basename(p))
            return out

        if _idx(xs, kind) != _idx(ys, "labels"):
            # A partially-copied corpus must not silently misalign labels.
            raise ValueError(
                f"{data_dir}: {kind}/labels shards do not pair up — "
                f"{[os.path.basename(p) for p in xs]} vs "
                f"{[os.path.basename(p) for p in ys]}"
            )
        # Memmap per shard — real corpora dwarf host RAM.
        self.shards = [np.load(p, mmap_mode="r") for p in xs]
        shapes = {s.shape[1:] for s in self.shards}
        if len(shapes) != 1:
            raise ValueError(
                f"{data_dir}: inconsistent {kind} shard shapes {shapes}; "
                "re-shard the corpus"
            )
        self.item_shape = self.shards[0].shape[1:]
        self.y = np.concatenate([np.load(p) for p in ys]).astype(np.int32)
        self.offsets = np.cumsum([0] + [len(s) for s in self.shards])
        self.n = int(self.offsets[-1])
        if len(self.y) != self.n:
            raise ValueError(
                f"{data_dir}: {self.n} {kind} items but {len(self.y)} labels"
            )
        self.found = True

    def gather(self, idx: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(items, labels) for sorted indices, via the native parallel
        gather (the memmap page faults happen inside the C++ kernel).
        Sorted indices of one shard are one slice of the batch, which the
        gather writes in place."""
        from frl_distributed_ml_scaffold_tpu_torch.data import native

        if np.any(idx[1:] < idx[:-1]):
            raise ValueError("ShardedNpyCorpus.gather takes sorted indices")
        bounds = np.searchsorted(idx, self.offsets)
        x = np.empty((len(idx),) + self.item_shape, np.float32)
        for s, shard in enumerate(self.shards):
            lo, hi = bounds[s], bounds[s + 1]
            if hi > lo:
                native.gather_rows(shard, idx[lo:hi] - self.offsets[s],
                                   out=x[lo:hi])
        return x, self.y[idx]


def warn_missing(data_dir: str, what: str, split: str) -> None:
    """A configured-but-absent corpus must be loud: training silently on
    synthetic data is the classic wasted-run trap."""
    from frl_distributed_ml_scaffold_tpu_torch.utils.logging import get_logger

    get_logger().warning(
        "%s: data_dir=%s has no %s shards for split %r — falling back to "
        "SYNTHETIC data; fix data.data_dir if a real corpus was intended",
        what,
        data_dir,
        what,
        split,
    )
