"""The port's streaming views (``data/streaming.py``) against the JAX
package's on the same growing directories, files written from a numpy
seed. The counterpart of the JAX package's
``tests/test_streaming_data.py``; every comparison is exact.

- The sealed-prefix rule and the capped view equal JAX's as pairs land
  out of order; an empty or half-sealed corpus is refused with JAX's
  ``ValueError``.
- Widen, then freeze: ``ImageNet``, ``VideoClips`` and ``TokenBinLM``
  with ``data.streaming=true`` give batches bit-equal to the JAX
  loaders' at every step while a producer seals pairs (appends tokens)
  between refreshes; the window widens at the refresh boundary, never
  between.
- The retry budget, the stale-anchor refusal, the leader's repair and a
  same-anchor window from an earlier run, as in the JAX tests.
- The window protocol over several processes (process index and count
  monkeypatched): leader and follower adopt the same window at the same
  bucket, and a JAX leader (process 0) with a port follower (process 1)
  over one ``.stream_sync/`` do too, with the same file contents.
"""

import _torch_threads  # noqa: F401  (before any torch op)

import json
import os

import jax
import numpy as np
import pytest

from frl_distributed_ml_scaffold_tpu.config import schema as jschema
from frl_distributed_ml_scaffold_tpu.data import imagenet as jimagenet
from frl_distributed_ml_scaffold_tpu.data import lm as jlm
from frl_distributed_ml_scaffold_tpu.data import shards as jshards
from frl_distributed_ml_scaffold_tpu.data import streaming as jstreaming
from frl_distributed_ml_scaffold_tpu.data import video as jvideo
from frl_distributed_ml_scaffold_tpu_torch.config import schema as tschema
from frl_distributed_ml_scaffold_tpu_torch.data import imagenet as timagenet
from frl_distributed_ml_scaffold_tpu_torch.data import lm as tlm
from frl_distributed_ml_scaffold_tpu_torch.data import shards as tshards
from frl_distributed_ml_scaffold_tpu_torch.data import streaming as tstreaming
from frl_distributed_ml_scaffold_tpu_torch.data import video as tvideo
from frl_distributed_ml_scaffold_tpu_torch.dist import initialize

SYNC = ".stream_sync"


def _write_pair(d, idx, *, kind="images", shape=(8, 8, 3), n=8,
                labels=True, data=True):
    rng = np.random.default_rng(idx)
    if data:
        tshards.sealed_save(os.path.join(d, f"train_{kind}_{idx:03d}.npy"),
                            rng.integers(0, 256, (n, *shape), dtype=np.uint8))
    if labels:
        tshards.sealed_save(os.path.join(d, f"train_labels_{idx:03d}.npy"),
                            np.full(n, idx, np.int32))


def _equal(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


def test_sealed_prefix_and_capped_view_match_jax(tmp_path):
    d = str(tmp_path)

    def same():
        n = tstreaming._sealed_pair_count(d, "train", "images")
        assert n == jstreaming._sealed_pair_count(d, "train", "images")
        for cap in range(1, 4):
            t = tshards.ShardedNpyCorpus(d, "train", "images", max_shards=cap)
            j = jshards.ShardedNpyCorpus(d, "train", "images", max_shards=cap)
            assert t.found == j.found == (n > 0)
            if n:
                assert t.n == j.n == 8 * min(cap, n)
                np.testing.assert_array_equal(t.y, j.y)
        return n

    assert same() == 0
    _write_pair(d, 0)
    _write_pair(d, 1, labels=False)  # labels still in flight
    _write_pair(d, 2)  # sealed, but after the incomplete pair
    assert same() == 1
    _write_pair(d, 1, data=False)
    assert same() == 3


def test_empty_or_half_sealed_corpus_is_refused(tmp_path):
    d = str(tmp_path)
    for mod in (tstreaming, jstreaming):
        with pytest.raises(ValueError, match="no sealed"):
            mod.StreamingShardCorpus(d, "train", "images", refresh_every=4)
    _write_pair(d, 0, labels=False)
    errors = []
    for mod in (tstreaming, jstreaming):
        with pytest.raises(ValueError, match="no sealed") as err:
            mod.StreamingShardCorpus(d, "train", "images", refresh_every=4)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
    # Through the loaders, as the JAX loaders refuse.
    for tcls, jcls, kind, shape, extra in (
            (timagenet.ImageNet, jimagenet.ImageNet, "images", (8, 8, 3),
             dict(name="imagenet", image_size=8, channels=3)),
            (tvideo.VideoClips, jvideo.VideoClips, "clips", (2, 8, 8, 3),
             dict(name="video", image_size=8, channels=3, num_frames=2))):
        cfg = dict(extra, data_dir=str(tmp_path / kind), streaming=True)
        os.makedirs(cfg["data_dir"])
        _write_pair(cfg["data_dir"], 0, kind=kind, shape=shape, labels=False)
        msgs = []
        for cls, schema in ((tcls, tschema), (jcls, jschema)):
            with pytest.raises(ValueError, match="no sealed") as err:
                cls(schema.DataConfig(**cfg), split="train")
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    cfg = dict(name="lm", seq_len=16, vocab_size=50,
               data_dir=str(tmp_path / "lm"), streaming=True)
    msgs = []
    for cls, schema in ((tlm.TokenBinLM, tschema), (jlm.TokenBinLM, jschema)):
        with pytest.raises(ValueError, match="does not exist") as err:
            cls(schema.DataConfig(**cfg), split="train")
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kind", ["images", "clips"])
def test_shard_loaders_widen_then_freeze_as_jax(tmp_path, kind):
    d = str(tmp_path)
    if kind == "images":
        cfg = dict(name="imagenet", image_size=8, channels=3, num_classes=4,
                   shuffle_seed=3)
        shape, pair = (10, 10, 3), (timagenet.ImageNet, jimagenet.ImageNet)
    else:
        cfg = dict(name="video", image_size=8, channels=3, num_frames=2,
                   num_classes=4, shuffle_seed=3)
        shape, pair = (2, 8, 8, 3), (tvideo.VideoClips, jvideo.VideoClips)
    cfg = dict(cfg, data_dir=d, streaming=True, streaming_refresh_every=4,
               prefetch=0)
    _write_pair(d, 0, kind=kind, shape=shape)
    t = pair[0](tschema.DataConfig(**cfg), split="train")
    j = pair[1](jschema.DataConfig(**cfg), split="train")
    assert not t.is_synthetic and not j.is_synthetic
    labels = set()
    for step in range(20):
        if step == 2:
            _write_pair(d, 1, kind=kind, shape=shape)
        if step == 9:
            _write_pair(d, 3, kind=kind, shape=shape)  # after a gap
        if step == 10:
            _write_pair(d, 2, kind=kind, shape=shape)
        got, want = t.batch(step, 6), j.batch(step, 6)
        _equal(got, want)
        seen = set(got["label"].tolist())
        # Frozen until the refresh boundary after each seal.
        assert seen <= ({0} if step < 4 else {0, 1} if step < 12
                        else {0, 1, 2, 3}), (step, seen)
        labels |= seen
        assert t._corpus.state() == j._corpus.state()
    assert labels == {0, 1, 2, 3}
    assert t._corpus.state() == {"shards": 4, "items": 32,
                                 "skew_deferrals": 0}


def test_token_bin_grows_and_lm_loader_matches_jax(tmp_path):
    block = tstreaming.TOKEN_BLOCK
    assert block == jstreaming.TOKEN_BLOCK
    path = os.path.join(str(tmp_path), "train.bin")
    rng = np.random.default_rng(0)
    tlm.write_token_bin(path, rng.integers(0, 100, block + 100),
                        vocab_size=100)
    tb = tstreaming.StreamingTokenBin(path, np.uint16, refresh_every=10)
    jb = jstreaming.StreamingTokenBin(path, np.uint16, refresh_every=10)
    assert len(tb) == len(jb) == block  # the tail under a block: invisible
    tlm.append_token_bin(path, rng.integers(0, 100, 2 * block))
    for step, n in ((5, block), (10, 3 * block)):
        tb.maybe_refresh(step)
        jb.maybe_refresh(step)
        assert len(tb) == len(jb) == n
    assert tb.state() == jb.state() == {"tokens": 3 * block,
                                        "skew_deferrals": 0}
    np.testing.assert_array_equal(tb.tokens, jb.tokens)

    d = tmp_path / "lm"
    d.mkdir()
    path = str(d / "train.bin")
    # The first block all 0, appended blocks all 1: a batch shows which
    # window it came from.
    tlm.write_token_bin(path, np.zeros(block, np.int64), vocab_size=4)
    cfg = dict(name="lm", seq_len=64, vocab_size=4, data_dir=str(d),
               streaming=True, streaming_refresh_every=4, prefetch=0)
    t = tlm.TokenBinLM(tschema.DataConfig(**cfg), split="train")
    j = jlm.TokenBinLM(jschema.DataConfig(**cfg), split="train")
    ones = False
    for step in range(12):
        if step == 1:
            tlm.append_token_bin(path, np.ones(block, np.int64))
        got, want = t.batch(step, 4), j.batch(step, 4)
        _equal(got, want)
        if step < 4:
            assert int(got["tokens"].max()) == 0
        ones |= int(got["tokens"].max()) == 1
    assert ones


def test_retry_within_bucket_and_budget(tmp_path):
    d = str(tmp_path)
    _write_pair(d, 0)
    corpora = [mod.StreamingShardCorpus(d, "train", "images",
                                        refresh_every=10)
               for mod in (tstreaming, jstreaming)]
    for c in corpora:
        # A 2-shard window active on peers that this view cannot serve.
        c._proto.agree = lambda bucket: (2, 0)
        c.maybe_refresh(10)
        assert c.n == 8 and c.state()["skew_deferrals"] == 1
        assert c._next_refresh == 11  # retried on the next batch
        c.maybe_refresh(11)
        assert c.state()["skew_deferrals"] == 2
    _write_pair(d, 1)
    for c in corpora:
        c.maybe_refresh(12)  # the shard landed: adopted at once
        assert c.n == 16 and c._next_refresh == 20
        assert c.state()["skew_deferrals"] == 2

    budget = tstreaming.RETRY_BUDGET_PER_BUCKET
    assert budget == jstreaming.RETRY_BUDGET_PER_BUCKET
    for mod in (tstreaming, jstreaming):
        c = mod.StreamingShardCorpus(d, "train", "images", refresh_every=100)
        c._proto.agree = lambda bucket: (5, 0)  # never servable here
        step = 100
        for _ in range(budget):
            c.maybe_refresh(step)
            assert c._next_refresh == step + 1
            step = c._next_refresh
        c.maybe_refresh(step)
        assert c._next_refresh == 200  # budget spent: the boundary
        assert c.state()["skew_deferrals"] == budget + 1
        c.maybe_refresh(200)  # a fresh bucket, a fresh budget
        assert c._next_refresh == 201


def _two_processes(monkeypatch, index: int):
    monkeypatch.setattr(initialize, "process_count", lambda: 2)
    monkeypatch.setattr(initialize, "process_index", lambda: index)


def _write_json(d, name, rec):
    os.makedirs(os.path.join(d, SYNC), exist_ok=True)
    with open(os.path.join(d, SYNC, f"train_images_{name}.json"), "w") as fh:
        json.dump(rec, fh)


def _read_json(d, name):
    with open(os.path.join(d, SYNC, f"train_images_{name}.json")) as fh:
        return json.load(fh)


def test_stale_anchor_cases(tmp_path, monkeypatch):
    # A follower refuses a window left by an earlier corpus (anchor 0;
    # this one anchors at 3) and fails at the deadline.
    d = str(tmp_path / "stale")
    os.makedirs(d)
    _write_pair(d, 3)
    _write_pair(d, 4)
    _two_processes(monkeypatch, 1)
    _write_json(d, "window", {"count": 9, "anchor": 0,
                              "activate_at_bucket": 0})
    corpus = tstreaming.StreamingShardCorpus.__new__(
        tstreaming.StreamingShardCorpus)
    corpus.data_dir, corpus.split, corpus.kind = d, "train", "images"
    proto = tstreaming._WindowProtocol(d, "train_images", corpus._local_scan)
    with pytest.raises(ValueError, match="no agreed initial window"):
        proto.initial(deadline_s=1.0)

    # The leader repairs it once every live process published the anchor.
    d = str(tmp_path / "repair")
    os.makedirs(d)
    _write_pair(d, 3)
    _write_json(d, "window", {"count": 9, "anchor": 0,
                              "activate_at_bucket": 0})
    _write_json(d, "host_1", {"count": 1, "anchor": 3})
    _two_processes(monkeypatch, 0)
    leader = tstreaming.StreamingShardCorpus(d, "train", "images",
                                             refresh_every=4)
    assert leader.n == 8
    assert _read_json(d, "window") == {"count": 1, "anchor": 3,
                                       "activate_at_bucket": 0}

    # A same-anchor window from an earlier run is servable.
    d = str(tmp_path / "same")
    os.makedirs(d)
    _write_pair(d, 0)
    _write_pair(d, 1)
    _two_processes(monkeypatch, 1)
    _write_json(d, "window", {"count": 1, "anchor": 0,
                              "activate_at_bucket": 0})
    assert tstreaming.StreamingShardCorpus(d, "train", "images",
                                           refresh_every=4).n == 8


def _as(monkeypatch, who: str, index: int):
    """Make ``who`` (``port`` or ``jax``) process ``index`` of two."""
    if who == "port":
        _two_processes(monkeypatch, index)
    else:
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        monkeypatch.setattr(jax, "process_index", lambda: index)


@pytest.mark.parametrize("leader,follower", [("port", "port"),
                                             ("jax", "port")])
def test_window_protocol_over_two_processes(tmp_path, monkeypatch, leader,
                                            follower):
    """The leader-published window with deferred activation: both
    processes adopt the same shard set at the same bucket. Two processes
    in one, one after the other (each sees its own index)."""
    mods = {"port": tstreaming, "jax": jstreaming}
    d = str(tmp_path)
    _write_pair(d, 0)
    # Process 1's construction-time publish, then the leader (which
    # proposes the initial window), then the follower (which adopts it).
    _write_json(d, "host_1", {"count": 1, "anchor": 0})
    _as(monkeypatch, leader, 0)
    lead = mods[leader].StreamingShardCorpus(d, "train", "images",
                                             refresh_every=10)
    _as(monkeypatch, follower, 1)
    foll = mods[follower].StreamingShardCorpus(d, "train", "images",
                                               refresh_every=10)
    assert lead.n == foll.n == 8

    _write_pair(d, 1)
    _as(monkeypatch, follower, 1)
    foll.maybe_refresh(10)  # publishes count 2; the window is still 1
    assert foll.n == 8
    _as(monkeypatch, leader, 0)
    lead.maybe_refresh(10)  # bucket 1: proposes for bucket 2, adopts not
    assert lead.n == 8
    assert _read_json(d, "window") == {"count": 2, "anchor": 0,
                                       "activate_at_bucket": 2}
    assert _read_json(d, "host_1") == {"count": 2, "anchor": 0}
    _as(monkeypatch, follower, 1)
    foll.maybe_refresh(20)  # bucket 2: both adopt
    _as(monkeypatch, leader, 0)
    lead.maybe_refresh(20)
    assert lead.n == foll.n == 16
    assert lead.state() == foll.state()
    _as(monkeypatch, follower, 1)
    np.testing.assert_array_equal(foll.gather(np.arange(16))[1],
                                  lead.gather(np.arange(16))[1])
