"""The port's retrieval layer against the JAX package: the k-means
vocabulary, the BoW transform, the inverted-file similarity (dense and
chunked), candidate selection with the word-seed gate, the Database word
stage with resume (across packages too), and the BoW-selected matching
path on 50 images.

Inputs are made with numpy from a seed; the vocabularies trained by JAX
are carried across with `Vocabulary.from_numpy`, and the JAX k-means++
init is injected into the port's k-means (the RNG streams differ).
Tolerances: word ids >= 99.9 % equal, centroids within 1e-4, similarity
within 1e-5, intersections and candidate lists exact.
"""
import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metricsfm_tpu.config import PRESETS as JPRESETS
from metricsfm_tpu.config import DatabaseOptions as JDatabaseOptions
from metricsfm_tpu.models import match_graph as jmg
from metricsfm_tpu.models.database import Database as JDatabase
from metricsfm_tpu.ops import kmeans as jkm
from metricsfm_tpu_torch.config import PRESETS, DatabaseOptions, GraphOptions
from metricsfm_tpu_torch.models import match_graph as tmg
from metricsfm_tpu_torch.models.database import Database
from metricsfm_tpu_torch.models.incremental import ImageFeatures
from metricsfm_tpu_torch.ops import kmeans as km
from tests.test_retrieval import (_clustered_descs, _fake_db, _geometric_db,
                                  _synthetic_word_lists)
from tests.torch_threads import torch_threads  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit_rows(rng, n, d=128):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


# -- k-means, assignment, transform -----------------------------------------

def test_assign_and_transform_match_jax_vocabulary(rng, key):
    """With a vocabulary trained by JAX, the port's coarse assignment and
    its word ids agree with JAX's on >= 99.9 % of the rows; the counts
    differ only by the rows whose word flipped."""
    train = _unit_rows(rng, 3000)
    jvoc = jkm.train_vocabulary(jnp.asarray(train), key, branch1=6,
                                branch2=24)
    voc = km.Vocabulary.from_numpy(np.asarray(jvoc.coarse),
                                   np.asarray(jvoc.fine), "cpu")
    assert voc.n_words == jvoc.n_words == 144
    desc = _unit_rows(rng, 2000)
    mask = rng.random(2000) > 0.1
    a_j = np.asarray(jkm._assign(jnp.asarray(desc), jvoc.coarse))
    a_t = km._assign(_t(desc), voc.coarse).numpy()
    assert (a_j == a_t).mean() >= 0.999
    w_j, c_j = jkm.transform(jvoc, jnp.asarray(desc), jnp.asarray(mask))
    w_t, c_t = km.transform(voc, _t(desc), _t(mask))
    w_j, c_j, w_t, c_t = (np.asarray(w_j), np.asarray(c_j), w_t.numpy(),
                          c_t.numpy())
    assert w_t.dtype == np.int32 and (w_t[~mask] == -1).all()
    flip = w_j != w_t
    assert flip.mean() <= 0.001
    n = voc.n_words
    want = c_j - np.bincount(w_j[flip], minlength=n) \
        + np.bincount(w_t[flip], minlength=n)
    np.testing.assert_array_equal(c_t, want)


@pytest.mark.parametrize("masked", [False, True])
def test_kmeans_from_jax_init_matches_jax(rng, key, masked):
    """Fed JAX's own k-means++ init (same key), the port's Lloyd iterations
    land within 1e-4 of JAX's centroids after 20 iterations."""
    descs, _, _ = _clustered_descs(rng)
    m = np.ones(len(descs), np.float32)
    if masked:
        m[rng.random(len(descs)) < 0.2] = 0.0
    init = np.asarray(jkm._kmeanspp_init(jnp.asarray(descs), key, 6,
                                         jnp.asarray(m)))
    want = np.asarray(jkm.kmeans(jnp.asarray(descs), key, k=6, iters=20,
                                 mask=jnp.asarray(m) if masked else None))
    got = km.kmeans(_t(descs), 6, 20, mask=_t(m) if masked else None,
                    init=_t(init)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_kmeans_recovers_clusters(rng):
    descs, centers, _ = _clustered_descs(rng)
    gen = torch.Generator().manual_seed(0)
    cent = km.kmeans(_t(descs), 6, 25, generator=gen).numpy()
    d = np.linalg.norm(centers[:, None] - cent[None, :], axis=-1)
    assert (d.min(axis=1) < 0.5).all()


def test_vocabulary_transform_groups_cluster_members(rng):
    descs, _, labels = _clustered_descs(rng)
    voc = km.train_vocabulary(_t(descs), torch.Generator().manual_seed(0),
                              branch1=3, branch2=2)
    assert voc.n_words == 6
    words, counts = km.transform(voc, _t(descs))
    words = words.numpy()
    w2, _ = km.transform(voc, _t(descs))
    assert (words == w2.numpy()).all()
    purity = np.mean([np.bincount(words[labels == c]).max()
                      / (labels == c).sum() for c in range(6)])
    assert purity > 0.9
    assert float(counts.sum()) == len(descs)


def test_transform_mask_excludes_rows(rng):
    descs, _, _ = _clustered_descs(rng, n_clusters=3, per=30)
    voc = km.train_vocabulary(_t(descs), branch1=2, branch2=2)
    mask = np.ones(len(descs), bool)
    mask[:10] = False
    words, counts = km.transform(voc, _t(descs), _t(mask))
    assert (words.numpy()[:10] == -1).all()
    assert float(counts.sum()) == mask.sum()


def test_train_vocabulary_cell_rules(monkeypatch):
    """Each coarse cell's fine centroids: an empty cell repeats its coarse
    centroid, a cell with fewer than B2 rows tiles its rows (in row order,
    masked rows left out), a full cell is its own k-means.  Five distinct
    integer points (exact means) for six coarse cells: the sixth is drawn
    onto a chosen point, loses every tie and stays empty."""
    d = 16
    pts = np.zeros((5, d), np.float32)
    pts[0, 0] = pts[1, 1] = 1.0
    pts[2:, 2] = [40.0, 48.0, 56.0]
    x = np.concatenate([np.repeat(pts[:2], 40, axis=0), pts[2:]])
    mask = np.ones(len(x), bool)
    mask[5] = False
    B1, B2 = 6, 4
    monkeypatch.setattr(km, "MAX_BLOCK_ROWS", 50)     # blocks of cells
    voc = km.train_vocabulary(_t(x), torch.Generator().manual_seed(3),
                              branch1=B1, branch2=B2, mask=_t(mask))
    coarse, fine = voc.coarse.numpy(), voc.fine.numpy()
    cell = km._assign(_t(x), voc.coarse).numpy()
    cell[~mask] = -1
    kinds = set()
    for c in range(B1):
        rows = np.nonzero(cell == c)[0]
        if len(rows) == 0:
            np.testing.assert_array_equal(fine[c], np.repeat(coarse[c:c + 1],
                                                             B2, 0))
            kinds.add("empty")
        elif len(rows) < B2:
            np.testing.assert_array_equal(fine[c],
                                          x[rows[np.arange(B2) % len(rows)]])
            kinds.add("few")
        else:
            # a full cell: Lloyd from its own fine centroids is a fixed point
            again = km.kmeans(_t(x[rows]), B2, 1, init=_t(fine[c])).numpy()
            np.testing.assert_allclose(again, fine[c], atol=1e-5)
            kinds.add("full")
    assert kinds == {"empty", "few", "full"}, kinds


def test_padded_cells_equal_per_cell_kmeans(rng):
    """The batched fine stage (cells padded to one row count, masked rows,
    re-seed modulo each cell's own count) equals a k-means per cell from
    the same init, empty-cluster re-seeds included."""
    sizes = [9, 23, 17]
    x = _unit_rows(rng, sum(sizes), d=8)
    cell = torch.as_tensor(np.repeat(np.arange(3), sizes))
    cell = cell[torch.as_tensor(rng.permutation(len(x)))]
    n_cells = torch.bincount(cell, minlength=4)
    cells = torch.tensor([2, 0, 1])
    block, m = km._padded_cells(_t(x), cell, cells, n_cells, 23)
    k = 6
    init = torch.as_tensor(rng.normal(size=(3, k, 8)).astype(np.float32))
    init[:, -1] = 50.0                      # a far centroid goes empty
    got = km._lloyd(block, m, init, 5, n_cells[cells])
    for b, c in enumerate(cells.tolist()):
        rows = x[cell.numpy() == c]
        want = km.kmeans(_t(rows), k, 5, init=init[b])
        np.testing.assert_allclose(got[b].numpy(), want.numpy(), atol=1e-6)
        assert (np.abs(want[-1].numpy()) < 10).all()     # re-seeded


# -- similarity, intersections, candidates -----------------------------------

def _counts(lists, n_words):
    return np.stack([np.bincount(w[w >= 0], minlength=n_words)
                     for w in lists]).astype(np.float32)


def test_similarity_matrix_stop_words_and_idf():
    counts = np.zeros((8, 16), np.float32)
    counts[:, 0] = 5.0
    counts[0, 1] = counts[1, 1] = 3.0
    counts[2, 2] = 4.0
    sim = km.similarity_matrix(_t(counts), stop_word_frac=0.4).numpy()
    np.testing.assert_allclose(
        sim, np.asarray(jkm.similarity_matrix(jnp.asarray(counts),
                                              stop_word_frac=0.4)),
        atol=1e-5, rtol=0)
    assert np.allclose(np.diag(sim), 0.0)
    assert sim[0, 1] > 0.9
    assert sim[0, 2] == pytest.approx(0.0, abs=1e-6)
    assert sim[3, 4] == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("stop_word_frac", [0.01, 0.002])
def test_similarity_dense_and_chunked_match_jax(rng, stop_word_frac):
    """Dense similarity within 1e-5 of JAX on the same counts, the
    intersections exact; the chunked path (word blocks, no counts matrix)
    within 1e-5 of the port's dense path and of JAX's chunked one, its
    intersections exact."""
    n, n_words = 40, 3000
    lists = _synthetic_word_lists(rng, n, n_words, kp_per_image=200)
    counts = _counts(lists, n_words)
    sim_j = np.asarray(jkm.similarity_matrix(jnp.asarray(counts),
                                             stop_word_frac=stop_word_frac))
    inter_j = np.asarray(jkm.word_intersection_counts(jnp.asarray(counts)))
    sim_d = km.similarity_matrix(_t(counts), stop_word_frac).numpy()
    inter_d = km.word_intersection_counts(_t(counts)).numpy()
    np.testing.assert_allclose(sim_d, sim_j, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(inter_d, inter_j)
    sim_c, inter_c = km.similarity_chunked(lists, n_words, stop_word_frac,
                                           block=512, device="cpu")
    sim_jc, inter_jc = jkm.similarity_chunked(lists, n_words, stop_word_frac,
                                              block=512)
    assert sim_c.dtype == np.float32 and sim_c.shape == (n, n)
    np.testing.assert_allclose(sim_c, sim_d, atol=1e-5, rtol=0)
    np.testing.assert_allclose(sim_c, sim_jc, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(inter_c, inter_d)
    np.testing.assert_array_equal(inter_c, inter_jc)
    # the candidates the two packages select from the same similarity
    assert tmg.candidates_bow(sim_j, 3, 6) == jmg.candidates_bow(sim_j, 3, 6)


def test_similarity_chunked_never_builds_the_counts_matrix(rng, monkeypatch):
    """No (n_images, n_words) tensor is made on the chunked path."""
    n, n_words, block = 30, 5000, 1024
    lists = _synthetic_word_lists(rng, n, n_words, kp_per_image=150)
    shapes = []
    zeros = torch.zeros

    def spy(*size, **kw):
        shapes.append(tuple(size[0]) if len(size) == 1 and
                      isinstance(size[0], tuple) else tuple(size))
        return zeros(*size, **kw)

    monkeypatch.setattr(torch, "zeros", spy)
    sim, _ = km.similarity_chunked(lists, n_words, block=block, device="cpu")
    monkeypatch.undo()
    assert max(np.prod(s) for s in shapes) <= max(n * block, n_words)
    assert (n, n_words) not in shapes
    sim_d = km.similarity_matrix(_t(_counts(lists, n_words))).numpy()
    np.testing.assert_allclose(sim, sim_d, atol=1e-5, rtol=0)


def test_candidates_bow_matches_jax_and_count_rule():
    n = 30
    sim = np.random.default_rng(0).uniform(0.1, 1.0, size=(n, n))
    sim = (sim + sim.T) / 2
    np.fill_diagonal(sim, 0.0)
    pairs = tmg.candidates_bow(sim, min_c=2, max_c=3)
    assert pairs == jmg.candidates_bow(sim, min_c=2, max_c=3)
    per_img = np.zeros(n, int)
    for i, j in pairs:
        per_img[i] += 1
        per_img[j] += 1
    assert (per_img >= 3).all()
    assert len(pairs) <= n * 3


def test_top_candidates():
    sim = torch.tensor([[0.0, 0.2, 0.9], [0.2, 0.0, 0.5], [0.9, 0.5, 0.0]])
    vals, idx = km.top_candidates(sim, 1)
    assert idx[:, 0].tolist() == [2, 2, 0]
    np.testing.assert_allclose(vals[:, 0].numpy(), [0.9, 0.5, 0.9])


# -- the Database word stage -------------------------------------------------

def _port_opts(**kw):
    return DatabaseOptions(**{"min_keypoints_for_words": 1, **kw})


def test_build_words_and_resume(tmp_path, rng):
    jdb = _fake_db(tmp_path, rng)             # writes the feature stores
    db = Database(str(tmp_path), _port_opts(), device="cpu")
    assert db.out == jdb.out
    voc, counts = db.build_words()
    assert counts.shape == (8, voc.n_words)
    assert (counts.sum(axis=1) > 0).all()
    inter = km.word_intersection_counts(_t(counts)).numpy()
    assert inter[0, 1] > inter[0, 7]
    os.remove(os.path.join(db.out, "3_words.npz"))
    mtime5 = os.path.getmtime(os.path.join(db.out, "5_words.npz"))
    voc2, counts2 = Database(str(tmp_path), _port_opts(),
                             device="cpu").build_words()
    assert voc2.n_words == voc.n_words
    assert os.path.getmtime(os.path.join(db.out, "5_words.npz")) == mtime5
    np.testing.assert_allclose(counts2, counts, rtol=1e-5)


def test_voc_branch_level_and_min_keypoints(tmp_path, rng):
    """voc_branch ** voc_level below the floor cap shrinks the vocabulary;
    an image under min_keypoints_for_words gets no words."""
    _fake_db(tmp_path, rng)
    db = Database(str(tmp_path), _port_opts(voc_branch=2, voc_level=4,
                                            min_keypoints_for_words=60),
                  device="cpu")
    voc, counts = db.build_words()
    assert voc.n_words == 16
    # every fake image has 100 valid keypoints; the cap is above none
    assert (counts.sum(axis=1) == 100).all()
    db2 = Database(str(tmp_path), _port_opts(min_keypoints_for_words=101),
                   output_fold=str(tmp_path / "o2"), device="cpu")
    for i in range(db.n_images):
        shutil.copy(os.path.join(db.out, f"{i}_feature.npz"), db2.out)
    _, counts2 = db2.build_words()
    assert (counts2 == 0).all()
    assert all((w == -1).all() for w in db2.word_lists())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_word_stores_resume_across_packages(tmp_path, rng, writer):
    """A voctree.npz and word files written by one package are read by the
    other unchanged: nothing is retrained or rewritten, the counts equal."""
    jdb = _fake_db(tmp_path, rng)
    tdb = Database(str(tmp_path), _port_opts(), device="cpu")
    first, second = (jdb, tdb) if writer == "jax" else (tdb, jdb)
    voc1, counts1 = first.build_words()
    names = sorted(os.listdir(jdb.out))
    mtimes = {n: os.path.getmtime(os.path.join(jdb.out, n)) for n in names}
    voc2, counts2 = second.build_words()
    assert sorted(os.listdir(jdb.out)) == names
    assert {n: os.path.getmtime(os.path.join(jdb.out, n))
            for n in names} == mtimes
    np.testing.assert_array_equal(counts2, counts1)
    np.testing.assert_array_equal(np.asarray(voc2.fine),
                                  np.asarray(voc1.fine))
    for a, b in zip(tdb.word_lists(), jdb.word_lists()):
        np.testing.assert_array_equal(a, b)


# -- the BoW-selected matching path on 50 images ----------------------------

def _web_cfg(presets, opts):
    cfg = presets["web"]()
    return dataclasses.replace(
        cfg, database=opts,
        graph=dataclasses.replace(cfg.graph, matching_type="feature",
                                  min_candidates=4, max_candidates=6,
                                  word_seed_min_matches=30))


def _copy_fold(src, dst):
    """The images and the feature stores of `src` (no words, no matches)."""
    os.makedirs(os.path.join(dst, "mtpu_db"))
    for n in os.listdir(src):
        if n.endswith(".png"):
            shutil.copy(os.path.join(src, n), dst)
    for n in os.listdir(os.path.join(src, "mtpu_db")):
        if n.endswith("_feature.npz"):
            shutil.copy(os.path.join(src, "mtpu_db", n),
                        os.path.join(dst, "mtpu_db"))


@pytest.fixture(scope="module")
def bow50(tmp_path_factory):
    """The JAX test's 50-image geometric database, matched by the JAX
    package through BoW candidates; returns (fold, JAX candidates after the
    word-seed gate, JAX verified matches)."""
    fold = tmp_path_factory.mktemp("bow50_jax")
    jdb = _geometric_db(fold, np.random.default_rng(0))
    jcfg = _web_cfg(JPRESETS, jdb.opts)
    matches = jmg.build_match_graph(jdb, jcfg)
    _, counts = jdb.build_words()
    sim = np.asarray(jkm.similarity_matrix(jnp.asarray(counts)))
    inter = np.asarray(jkm.word_intersection_counts(jnp.asarray(counts)))
    cands = jmg.candidates_bow(sim, 4, 6)
    gated = [(i, j) for (i, j) in cands if inter[i, j] >= 30]
    return str(fold), gated, matches


def _port_bow(fold):
    opts = DatabaseOptions(min_keypoints_for_words=1, max_keypoints=192)
    db = Database(fold, opts, device="cpu")
    cfg = _web_cfg(PRESETS, opts)
    cands, gated = tmg.candidates_feature(db, cfg.graph, "cpu")
    matches = tmg.build_match_graph(db, cfg)
    return db, cands, gated, matches


def test_bow_matching_path_50_images(bow50, tmp_path):
    """The port alone (its own vocabulary) passes the JAX test's
    assertions: a banded graph, >= 40 adjacent pairs of >= 30 matches, and
    every pair through the word-seed gate."""
    fold = str(tmp_path / "port")
    _copy_fold(bow50[0], fold)
    db, cands, gated, matches = _port_bow(fold)
    assert os.path.exists(os.path.join(db.out, "voctree.npz"))
    assert matches, "no pairs survived"
    assert set(matches) <= set(gated) <= set(cands)
    gaps = np.array([abs(i - j) for (i, j) in matches])
    assert gaps.max() <= 10
    assert sum(1 for (i, j) in matches if j - i == 1) >= 40
    for (i, j), m in matches.items():
        if j - i == 1:
            assert len(m.kp_i) >= 30
    _, counts = db.build_words()
    inter = km.word_intersection_counts(_t(counts)).numpy()
    for (i, j) in matches:
        assert inter[i, j] >= 30


def test_bow_path_with_jax_vocabulary_matches_jax(bow50, tmp_path):
    """Given JAX's vocabulary, the port's candidates after the word-seed
    gate equal JAX's; the verified pair sets agree with Jaccard >= 0.98
    (the RANSAC streams differ)."""
    fold = str(tmp_path / "port")
    _copy_fold(bow50[0], fold)
    shutil.copy(os.path.join(bow50[0], "mtpu_db", "voctree.npz"),
                os.path.join(fold, "mtpu_db"))
    _, _, gated, matches = _port_bow(fold)
    assert gated == bow50[1]
    a, b = set(matches), set(bow50[2])
    assert len(a & b) / len(a | b) >= 0.98


def test_match_one_pair_matches_jax(bow50):
    """`match_one_pair` (one 2-NN, F-RANSAC, epipolar re-filter) keeps the
    same matches as the JAX package's on an adjacent pair, up to RANSAC's
    stream (Jaccard >= 0.95)."""
    jdb = JDatabase(bow50[0], JDatabaseOptions(min_keypoints_for_words=1,
                                               max_keypoints=192))
    fi, fj = jdb.features(10), jdb.features(11)
    jm = jmg.MatchGraphBuilder(JPRESETS["web"]().graph).match_one_pair(fi, fj)
    tf = [ImageFeatures(xy=f.xy, desc=f.desc, mask=f.mask, width=f.width,
                        height=f.height) for f in (fi, fj)]
    tm = tmg.MatchGraphBuilder(GraphOptions(), device="cpu"
                               ).match_one_pair(*tf)
    assert jm is not None and tm is not None
    a = set(zip(jm.kp_i.tolist(), jm.kp_j.tolist()))
    b = set(zip(tm.kp_i.tolist(), tm.kp_j.tolist()))
    assert len(a & b) / len(a | b) >= 0.95


# -- the host-side pair check ------------------------------------------------

@pytest.mark.parametrize("bad", [(1, 0), (2, 2), (-1, 3), (0, 6), (0, 2.0)])
def test_malformed_pairs_raise_before_matching(bad, monkeypatch):
    """A candidate list with a pair outside 0 <= i < j < n raises on the
    host before any pair is matched (on the card a stray index would trap
    the 2-NN kernel)."""
    def no_verify(*a, **k):
        raise AssertionError("matching ran")

    monkeypatch.setattr(tmg, "verify_pairs", no_verify)
    rng = np.random.default_rng(0)
    feats = {i: ImageFeatures(xy=rng.normal(size=(16, 2)).astype(np.float32),
                              desc=_unit_rows(rng, 16),
                              mask=np.ones(16, bool), width=64, height=64)
             for i in range(6)}
    builder = tmg.MatchGraphBuilder(GraphOptions(), device="cpu")
    err = TypeError if isinstance(bad[1], float) else IndexError
    with pytest.raises(err):
        builder.build(feats, [(0, 1), bad])
