"""The port's match-graph driver writes an image's match shard as soon as
the last pair of that image is verified, whatever order the candidate
pairs come in, and a run cut short resumes without verifying those pairs
again.  (The JAX package writes a shard only once all of an image's pairs
are done in the caller's order, so with shuffled pairs an interrupted run
kept almost nothing; the port groups the pairs by first image first.)

`verify_pairs` is replaced by a stub that keeps the first 30 keypoints of
every pair: these tests are about batching, shards and resume, not about
matching.
"""
import itertools

import numpy as np
import pytest
import torch

from metricsfm_tpu_torch.config import GraphOptions
from metricsfm_tpu_torch.io import store as fstore
from metricsfm_tpu_torch.models import match_graph as tmg
from metricsfm_tpu_torch.models.incremental import ImageFeatures
from tests.torch_threads import torch_threads  # noqa: F401

N_IMAGES, N_KP, B = 6, 128, 2


class _Stop(Exception):
    pass


def _features(rng):
    return {i: ImageFeatures(
        xy=rng.uniform(0, 100, (N_KP, 2)).astype(np.float32),
        desc=rng.normal(size=(N_KP, 128)).astype(np.float32),
        mask=np.ones(N_KP, bool), width=100, height=100)
        for i in range(N_IMAGES)}


def _run(monkeypatch, out, feats, pairs, stop_after=None):
    """Build the graph in batches of B pairs; the stub raises _Stop before
    batch `stop_after`.  Returns (verified pairs in order, [(image,
    batches done) per shard write], result or None)."""
    verified, writes = [], []

    def fake_verify(opts, desc, xy, mask, ii, jj, gen, draw_rows=None):
        if stop_after is not None and len(verified) // B == stop_after:
            raise _Stop
        # the store's row r holds the image whose keypoints it carries
        img = [next(i for i, f in feats.items()
                    if np.array_equal(xy[r].numpy(), f.xy))
               for r in range(xy.shape[0])]
        verified.extend((img[a], img[b]) for a, b in
                        zip(ii.tolist(), jj.tolist()))
        keep = torch.zeros((len(ii), desc.shape[1]), dtype=torch.bool)
        keep[:, :30] = True
        idx2 = torch.arange(desc.shape[1]).expand(len(ii), -1)
        return keep, idx2, torch.ones(len(ii), dtype=torch.bool)

    write = fstore.write_image_matches

    def spy_write(o, i, matches):
        writes.append((i, -(-len(verified) // B)))
        write(o, i, matches)

    monkeypatch.setattr(tmg, "verify_pairs", fake_verify)
    monkeypatch.setattr(fstore, "write_image_matches", spy_write)
    builder = tmg.MatchGraphBuilder(GraphOptions(), out_fold=str(out),
                                    batch_pairs=B, device="cpu")
    try:
        return verified, writes, builder.build(feats, pairs)
    except _Stop:
        return verified, writes, None


def test_shuffled_pairs_flush_per_image_and_resume(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    feats = _features(rng)
    pairs = list(itertools.combinations(range(N_IMAGES), 2))
    shuffled = [pairs[k] for k in rng.permutation(len(pairs))]
    assert shuffled != pairs
    # cut after 3 batches (6 pairs): image 0's 5 pairs are done
    verified, writes, res = _run(monkeypatch, tmp_path, feats, shuffled,
                                 stop_after=3)
    assert res is None and len(verified) == 3 * B
    assert sorted(verified[:5]) == [(0, j) for j in range(1, N_IMAGES)]
    assert verified[5][0] == 1
    assert writes == [(0, 3)]       # written in the batch of its last pair
    shard = fstore.read_image_matches(str(tmp_path), 0)
    assert shard["processed"] == set(range(1, N_IMAGES))
    # resume: image 0's pairs are not verified again; image 1's pair,
    # verified before the cut but not written, is
    verified2, writes2, res = _run(monkeypatch, tmp_path, feats, shuffled)
    assert sorted(verified2) == [p for p in pairs if p[0] != 0]
    assert [i for i, _ in writes2] == list(range(1, N_IMAGES - 1))
    # each shard goes out in the batch that verifies its image's last pair
    last = np.cumsum([N_IMAGES - 1 - i for i in range(1, N_IMAGES - 1)])
    assert [n for _, n in writes2] == [-(-int(k) // B) for k in last]
    assert sorted(res) == pairs
    for i in range(N_IMAGES - 1):
        r = fstore.read_image_matches(str(tmp_path), i)
        assert r["processed"] == set(range(i + 1, N_IMAGES))
        for j in range(i + 1, N_IMAGES):
            np.testing.assert_array_equal(res[(i, j)].kp_i, np.arange(30))
            np.testing.assert_array_equal(r["pairs"][j][0], np.arange(30))


@pytest.mark.parametrize("order", ["all", "gps"])
def test_sorted_pairs_keep_their_order_and_batches(tmp_path, monkeypatch,
                                                   order):
    """Callers pass sorted candidates (candidates_all, candidates_gps): the
    grouping leaves their order, and so their batches, as they were."""
    rng = np.random.default_rng(1)
    feats = _features(rng)
    if order == "all":
        pairs = tmg.candidates_all(N_IMAGES)
    else:
        pairs = tmg.candidates_gps(rng.uniform(0, 50, (N_IMAGES, 2)), 3)
    verified, writes, res = _run(monkeypatch, tmp_path, feats, pairs)
    assert verified == pairs
    assert [i for i, _ in writes] == sorted({i for i, _ in pairs})
    assert sorted(res) == pairs
