"""Match-graph construction: candidate selection + fine matching + F-verify.

Counterpart of metricsfm_tpu/models/match_graph.py (the reference graph
layer, SfM/src/graph.{h,cc}, graph/initial_matching_graph.cc,
graph/fine_matching_graph.cc):

* Candidate pairs: "all" (exhaustive, initial_matching_graph.cc:57-64),
  "priori" (GPS mutual k-NN in the UTM plane, :83-162) or "feature" (BoW
  top-k by vocabulary similarity, then the word-seed gate, :164-294); like
  the JAX package, 12 images or fewer always match all pairs.
* Fine matching: exact 2-NN with dual ratio tests (fine_matching_graph.cc:
  42-43); "good" matches (ratio < 0.6) estimate F via batched RANSAC, then
  "all" matches (ratio < 0.85) are re-filtered by epipolar distance < 3 px
  (fine_matching_graph.cc:137-147).
* The driver is BATCHED: the descriptor store goes to the device once (as
  bf16), and each batch of pairs is one 2-NN kernel launch that gathers its
  rows by pair index, followed by one batched RANSAC + re-filter — the
  counterpart of the reference's OpenMP loop over pairs
  (fine_matching_graph.cc:87).
* Per-image match shards persist for resume (match_index semantics).
* Each batch of pairs is split over the ranks of a mesh (parallel/mesh;
  one process: a mesh of one): each verifies its rows (one 2-NN launch,
  its share of the batch's RANSAC) and the results are gathered, so every
  rank holds the whole graph; rank 0 alone writes the shards.  The
  RANSAC uniforms of the whole batch are drawn on every rank, so the
  split graph samples as the unsplit one at the same batch size: on the
  CPU the two are equal.  On the card a rank's rows, run alone at their
  smaller batch, give the split graph bit for bit, but a few pairs round
  otherwise than in the whole batch (273 of 276 bit-equal,
  `chip_smoke.py` phase 13).
"""
from __future__ import annotations

import itertools
import operator
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import GraphOptions
from ..io import store as fstore
from ..ops import epipolar, matching, ransac
from ..parallel.mesh import Mesh, make_global_mesh, owned_range
from ..utils import utm
from ..utils.device import resolve as resolve_device
from .incremental import PairMatches


def candidates_all(n: int) -> List[Tuple[int, int]]:
    """Exhaustive pairs (ref :57-64, UAV preset matching_type='all')."""
    return list(itertools.combinations(range(n), 2))


def candidates_gps(gps_utm: np.ndarray, knn: int) -> List[Tuple[int, int]]:
    """GPS prior: mutual k-NN in the UTM plane (ref :83-162).

    gps_utm: (n, 2) easting/northing. k = min(knn, n/10) as in the ref.
    """
    n = len(gps_utm)
    k = max(2, min(knn, max(n // 10, 2)))
    d2 = ((gps_utm[:, None, :] - gps_utm[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nbrs = np.argsort(d2, axis=1)[:, :k]
    pairs = set()
    for i in range(n):
        for j in nbrs[i]:
            if i in nbrs[j]:
                pairs.add((min(i, int(j)), max(i, int(j))))
    return sorted(pairs)


def candidates_bow(sim: np.ndarray, min_c: int = 200, max_c: int = 500
                   ) -> List[Tuple[int, int]]:
    """BoW similarity: per-image top min(max(min_c, n/10), max_c) candidates
    (ref :164-294, count rule :168-169)."""
    n = sim.shape[0]
    k = min(max(min_c, n // 10), max_c, n - 1)
    pairs = set()
    order = np.argsort(-sim, axis=1)
    for i in range(n):
        for j in order[i, :k]:
            if sim[i, j] > 0:
                pairs.add((min(i, int(j)), max(i, int(j))))
    return sorted(pairs)


def candidates_feature(database, opts: GraphOptions, device,
                       verbose: bool = False):
    """The "feature" strategy: the database's vocabulary and word bags
    (built, or resumed from its stores), BoW similarity on `device`, the
    per-image top-k (`candidates_bow`), then the word-intersection seed
    gate: pairs sharing fewer than `word_seed_min_matches` distinct words
    cannot yield that many seed matches and are dropped before fine
    matching (ref initial_matching_graph.cc:210-289).

    Returns (candidates before the gate, pairs after it).
    """
    from ..ops import kmeans as km

    voc, counts = database.build_words(verbose=verbose)
    if counts is not None:
        c = torch.from_numpy(counts).to(device)
        sim = km.similarity_matrix(c, opts.stop_word_frac).cpu().numpy()
        inter = km.word_intersection_counts(c).cpu().numpy()
    else:
        # large image sets: streamed word-block accumulation, no
        # (n_images, n_words) matrix (ref inverted file,
        # similarity_graph.cc:47-117)
        sim, inter = km.similarity_chunked(
            database.word_lists(), int(voc.n_words),
            stop_word_frac=opts.stop_word_frac, device=device)
    cands = candidates_bow(sim, opts.min_candidates, opts.max_candidates)
    pairs = cands
    if opts.word_seed_min_matches > 0:
        pairs = [(i, j) for (i, j) in cands
                 if inter[i, j] >= opts.word_seed_min_matches]
        if verbose and len(pairs) < len(cands):
            print(f"word-seed gate: {len(cands)} -> {len(pairs)} pairs")
    return cands, pairs


def check_pairs(pairs, n: int):
    """Every pair is two integers 0 <= i < j < n; raises IndexError (or
    TypeError for a non-integer) on the host, before any index reaches a
    device kernel."""
    for p in pairs:
        i, j = (operator.index(v) for v in p)
        if not 0 <= i < j < n:
            raise IndexError(f"candidate pair {tuple(p)} is not "
                             f"0 <= i < j < {n}")


def verify_pairs(opts: GraphOptions, desc, xy, mask, ii, jj, generator,
                 draw_rows=None):
    """The per-pair fine-matching + verification chain for a pair batch
    (ref fine_matching_graph.cc:104-147), all pairs at once.

    desc (M, N, D) bf16, xy (M, N, 2), mask (M, N): the device store;
    ii, jj (B,) int32 store rows of each pair; draw_rows: the RANSAC's
    whole-batch draw when the pairs are one rank's rows of a split batch
    (ransac.fundamental_ransac).
    Returns (keep (B, N) bool, idx2 (B, N), ok (B,)).
    """
    d1_sq, d2_sq, idx2 = matching.knn2_gather(desc, mask, ii, jj)
    iil, jjl = ii.long(), jj.long()
    res = matching.ratio_tests(d1_sq, d2_sq, idx2, mask[iil],
                               opts.ratio_good, opts.ratio_all)
    p1 = xy[iil]                                           # (B, N, 2)
    p2g = xy[jjl[:, None], idx2.long()]                    # (B, N, 2)
    fr = ransac.fundamental_ransac(p1, p2g, generator, mask=res["good"],
                                   th_px=opts.epipolar_px,
                                   min_inliers=opts.geoverify_min_inliers,
                                   draw_rows=draw_rows)
    d = epipolar.epipolar_distance(fr["F"], p1, p2g)
    keep = res["all"] & (d < opts.epipolar_px)
    # fixed per-pair match budget (GraphOptions.max_matches_per_pair):
    # keep the `budget` smallest descriptor distances among survivors
    budget = opts.max_matches_per_pair
    if budget < keep.shape[1]:
        dist = torch.where(keep, res["dist_sq"], torch.inf)
        kth = torch.sort(dist, dim=1).values[:, budget - 1:budget]
        keep = keep & (dist <= kth)
    ok = (fr["ok"] & (torch.sum(res["good"], dim=1) >= 8)
          & (torch.sum(keep, dim=1) >= opts.geoverify_min_inliers))
    return keep & ok[:, None], idx2, ok


def descriptor_store(features, imgs, device):
    """The device store of images `imgs`: every image padded to one
    keypoint budget N (a multiple of 128), descriptors (M, N, D) as bf16,
    coordinates (M, N, 2) and masks (M, N), uploaded once."""
    kmax = max(int(features[i].mask.shape[0]) for i in imgs)
    N = -(-kmax // 128) * 128
    D = features[imgs[0]].desc.shape[1]
    desc = np.zeros((len(imgs), N, D), np.float32)
    xy = np.zeros((len(imgs), N, 2), np.float32)
    mask = np.zeros((len(imgs), N), bool)
    for r, i in enumerate(imgs):
        f = features[i]
        k = f.mask.shape[0]
        desc[r, :k] = f.desc
        xy[r, :k] = f.xy
        mask[r, :k] = f.mask
    return (torch.from_numpy(desc).to(torch.bfloat16).to(device),
            torch.from_numpy(xy).to(device), torch.from_numpy(mask).to(device))


def split_batch(mesh, chunk_pairs):
    """One rank's share of a batch of pairs split over `mesh`: the batch
    filled up to a multiple of the mesh size with copies of its last pair,
    this rank's contiguous rows of it, and their RANSAC draw_rows (the
    whole batch's uniforms; a copy reuses its pair's)."""
    nb = len(chunk_pairs)
    fill = chunk_pairs + [chunk_pairs[-1]] * ((-nb) % mesh.size)
    lo, hi = mesh.rows(len(fill))
    rows = torch.clamp(torch.arange(lo, hi), max=nb - 1).to(mesh.device)
    return fill[lo:hi], (nb, rows)


def gather_rows(mesh, *tensors):
    """all_gather_rows of several (B, ...) tensors in one collective (each
    flattened to int32 columns; bool and int32 tensors only)."""
    cols = [t.reshape(t.shape[0], -1).to(torch.int32) for t in tensors]
    flat = mesh.all_gather_rows(torch.cat(cols, dim=1))
    out, off = [], 0
    for t, c in zip(tensors, cols):
        v = flat[:, off:off + c.shape[1]].reshape(-1, *t.shape[1:])
        out.append(v.to(t.dtype))
        off += c.shape[1]
    return out


class MatchGraphBuilder:
    """Build the verified match graph over candidate pairs (batched).

    Every batch is split over the ranks of `mesh` (parallel/mesh.Mesh;
    default: the one process on `device`), on the mesh's device (`device`
    is then unused); every rank must call `build` with the same pairs."""

    def __init__(self, options: GraphOptions, out_fold: Optional[str] = None,
                 seed: int = 0, batch_pairs: int = 32, device="cuda",
                 mesh=None):
        self.opts = options
        self.out = out_fold
        self.batch_pairs = batch_pairs
        self.mesh = mesh or Mesh(device=resolve_device(device))
        self.device = self.mesh.device
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def match_one_pair(self, feat_i, feat_j) -> Optional[PairMatches]:
        """Fine matching for one pair (ref fine_matching_graph.cc:104-147):
        2-NN with the dual ratio tests, F by RANSAC on the "good" matches,
        then the "all" matches re-filtered by epipolar distance."""
        def put(a, dtype=None):
            return torch.as_tensor(np.asarray(a, dtype)).to(self.device)

        res = matching.match_pair(
            put(feat_i.desc, np.float32), put(feat_j.desc, np.float32),
            put(feat_i.mask, bool), put(feat_j.mask, bool),
            ratio_good=self.opts.ratio_good, ratio_all=self.opts.ratio_all)
        good = res["good"].cpu().numpy()
        allm = res["all"].cpu().numpy()
        idx2 = res["idx2"].cpu().numpy().astype(np.int64)
        if good.sum() < 8:
            return None
        # F from "good" matches via batched RANSAC
        p1 = put(feat_i.xy, np.float32)
        p2 = put(feat_j.xy[idx2], np.float32)
        fr = ransac.fundamental_ransac(
            p1, p2, self.gen, mask=put(good),
            th_px=self.opts.epipolar_px,
            min_inliers=self.opts.geoverify_min_inliers)
        if not bool(fr["ok"]):
            return None
        # re-filter "all" matches by epipolar distance under the fixed F
        d = epipolar.epipolar_distance(fr["F"], p1, p2).cpu().numpy()
        keep = allm & (d < self.opts.epipolar_px)
        if keep.sum() < self.opts.geoverify_min_inliers:
            return None
        kp_i = np.where(keep)[0]
        return PairMatches(kp_i=kp_i.astype(np.int64),
                           kp_j=idx2[kp_i].astype(np.int64))

    def build(self, features, pairs: List[Tuple[int, int]],
              verbose: bool = False, owner=None
              ) -> Dict[Tuple[int, int], PairMatches]:
        """Match every candidate pair (resume-aware when out_fold set).

        `features` maps image id -> ImageFeatures with descriptors.  Pairs
        are processed in batches of `batch_pairs`: one kernel launch for
        the 2-NN of the batch, one batched RANSAC + re-filter, and one
        device->host copy of the results.

        owner=(process_id, process_count): this process matches only the
        pairs whose FIRST image falls in its contiguous image shard.

        A batch of `batch_pairs` rounded up to a multiple of the mesh
        size is split over the mesh's ranks; every rank returns the whole
        graph, and only rank 0 writes the shards.
        """
        # pair indices are checked here, on the host: a stray index would
        # trap the 2-NN kernel and lose the process's CUDA context
        check_pairs(pairs, len(features))
        if owner is not None:
            n_imgs = 1 + max((max(i, j) for i, j in pairs), default=0)
            lo, hi = owned_range(n_imgs, *owner)
            pairs = [(i, j) for (i, j) in pairs if lo <= i < hi]

        mesh = self.mesh
        writer = self.out is not None and mesh.rank == 0
        out: Dict[Tuple[int, int], PairMatches] = {}
        todo: List[Tuple[int, int]] = []
        # per-image match shards ({i}_match like the reference,
        # fine_matching_graph.cc:182-193), per-pair resume granularity
        # kept via the shard's processed-j list
        recs: Dict[int, dict] = {}
        if self.out is not None:
            for i in sorted({i for (i, _) in pairs}):
                r = fstore.read_image_matches(self.out, i)
                if r is not None:
                    recs[i] = r
        for (i, j) in pairs:
            r = recs.get(i)
            if r is not None and j in r["processed"]:
                if j in r["pairs"]:
                    a, b = r["pairs"][j]
                    out[(i, j)] = PairMatches(kp_i=a, kp_j=b)
                continue
            todo.append((i, j))
        # group the pairs by first image (a stable sort: sorted candidate
        # lists keep their order and batches), so that an image's shard is
        # written as soon as its last pair is verified, whatever the order
        # the caller passed the pairs in
        todo.sort(key=lambda p: p[0])
        pending: Dict[int, int] = {}
        for (i, _) in todo:
            pending[i] = pending.get(i, 0) + 1
        fresh: Dict[int, Dict[int, tuple]] = {}

        if todo:
            imgs = sorted({i for p in todo for i in p})
            row_of = {im: r for r, im in enumerate(imgs)}
            desc_all, xy_all, mask_all = descriptor_store(features, imgs,
                                                          self.device)
            B = -(-self.batch_pairs // mesh.size) * mesh.size
            n_batches = -(-len(todo) // B)
            for bi in range(n_batches):
                chunk_pairs = todo[bi * B:(bi + 1) * B]
                mine, draw_rows = split_batch(mesh, chunk_pairs)
                ii = torch.tensor([row_of[i] for i, _ in mine],
                                  dtype=torch.int32).to(self.device)
                jj = torch.tensor([row_of[j] for _, j in mine],
                                  dtype=torch.int32).to(self.device)
                keep, idx2, ok = verify_pairs(self.opts, desc_all, xy_all,
                                              mask_all, ii, jj, self.gen,
                                              draw_rows)
                keep, idx2, ok = gather_rows(mesh, keep, idx2, ok)
                keep, idx2, ok = (keep.cpu().numpy(), idx2.cpu().numpy(),
                                  ok.cpu().numpy())
                for b, (i, j) in enumerate(chunk_pairs):
                    if ok[b]:
                        kp_i = np.where(keep[b])[0]
                        m = PairMatches(kp_i=kp_i.astype(np.int64),
                                        kp_j=idx2[b][kp_i].astype(np.int64))
                        out[(i, j)] = m
                    else:
                        m = None
                    if self.out is not None:
                        fresh.setdefault(i, {})[j] = (
                            m.kp_i if m else np.empty(0, np.int64),
                            m.kp_j if m else np.empty(0, np.int64))
                        pending[i] -= 1
                        if pending[i] == 0:
                            # image i complete: merge with any prior shard
                            # and persist once (partial-progress semantics
                            # like the reference's per-image writes)
                            merged = dict(fresh.pop(i))
                            old = recs.get(i)
                            if old is not None:
                                for j2 in old["processed"]:
                                    if j2 not in merged:
                                        merged[j2] = old["pairs"].get(
                                            j2, (np.empty(0, np.int64),
                                                 np.empty(0, np.int64)))
                            if writer:
                                fstore.write_image_matches(self.out, i,
                                                           merged)
                if verbose:
                    print(f"matching batch {bi + 1}/{n_batches} "
                          f"({min((bi + 1) * B, len(todo))}/{len(todo)} pairs)")

        if writer:
            fstore.write_match_graph(
                self.out, {k: len(v.kp_i) for k, v in out.items()})
        return out


def _native_xy(feat, shape):
    """Centered keypoint coordinates of the working resolution (the feature
    meta's width x height) scaled to an image of `shape` (H, W)."""
    scale = np.array([shape[1] / feat.width, shape[0] / feat.height])
    return np.asarray(feat.xy, np.float64) * scale


def render_pair_matches(database, matches, render_dir: str,
                        features=None, max_pairs: int = 50,
                        max_lines: int = 200) -> List[str]:
    """Write side-by-side match renders for verified pairs (the
    reference's commented-out cv::line debug blocks,
    fine_matching_graph.cc:156-180, as a shipped affordance).

    Renders up to `max_pairs` pairs (evenly subsampled) as
    match_{i}_{j}.png in render_dir, on the images at their native
    resolution: keypoints found at a resized working resolution are scaled
    to it (the JAX package draws them unscaled).  Returns written paths.
    """
    from PIL import Image

    from ..io.exports import write_match_visualization

    os.makedirs(render_dir, exist_ok=True)
    feats = features or {i: database.features(i)
                         for i in range(database.n_images)}
    keys = sorted(matches.keys())
    sel = (np.linspace(0, len(keys) - 1,
                       min(len(keys), max_pairs)).astype(int)
           if keys else np.zeros(0, int))
    written = []
    for s in np.unique(sel):
        i, j = keys[s]
        m = matches[(i, j)]
        with Image.open(database.image_paths[i]) as a:
            img_i = np.asarray(a.convert("L"), np.float32) / 255.0
        with Image.open(database.image_paths[j]) as b:
            img_j = np.asarray(b.convert("L"), np.float32) / 255.0
        p = os.path.join(render_dir, f"match_{i:04d}_{j:04d}.png")
        write_match_visualization(p, img_i, img_j,
                                  _native_xy(feats[i], img_i.shape),
                                  _native_xy(feats[j], img_j.shape),
                                  m.kp_i, m.kp_j, max_lines=max_lines)
        written.append(p)
    return written


def build_match_graph(database, config, verbose: bool = False, device=None,
                      priori_utm=None, debug_render_dir=None, mesh=None):
    """End-to-end graph build (ref Graph::BuildGraph, graph.cc:52-70):
    candidate pairs, then batched fine matching on `device` (default: the
    database's).  Returns {(i, j): PairMatches}.

    mesh: the ranks that split the pair batches (MatchGraphBuilder); by
    default every rank of the process group when one with more than one
    rank is up (the JAX package's mesh over every visible device).  The
    candidates are then selected on rank 0 alone (the word stage writes
    its stores) and sent to the others.

    priori_utm: optional (n, 2) easting/northing for 'priori' candidate
    selection when positions come from a pose-prior file rather than image
    EXIF (the reference accepts both, initial_matching_graph.cc:83-162).

    debug_render_dir: when set, per-pair match visualizations are written
    there (render_pair_matches).
    """
    import torch.distributed as dist

    opts = config.graph
    n = database.n_images
    device = device or database.device
    if mesh is None:
        mesh = make_global_mesh() if dist.is_initialized() and \
            dist.get_world_size() > 1 else Mesh(device=resolve_device(device))
    lead = mesh.rank == 0
    pairs = mesh.broadcast_object(
        _candidates(database, opts, device, priori_utm, verbose)
        if lead else None)
    if verbose:
        print(f"match graph: {len(pairs)} candidate pairs for {n} images")
    builder = MatchGraphBuilder(opts, out_fold=database.out, device=device,
                                mesh=mesh)
    feats = {i: database.features(i) for i in range(n)}
    out = builder.build(feats, pairs, verbose=verbose)
    if debug_render_dir is not None and lead:
        render_pair_matches(database, out, debug_render_dir, features=feats)
    return out


def _candidates(database, opts: GraphOptions, device, priori_utm, verbose):
    """The candidate pairs of build_match_graph's strategy."""
    n = database.n_images
    if opts.matching_type == "all" or n <= 12:
        pairs = candidates_all(n)
    elif opts.matching_type == "priori":
        if priori_utm is not None:
            coords = np.asarray(priori_utm, np.float64)
        else:
            coords = []
            for i in range(n):
                lat, lon, _ = database.gps(i)
                e, no, _ = utm.ll_to_utm(lat, lon)
                coords.append([e, no])
            coords = np.array(coords)
        pairs = candidates_gps(coords, opts.knn)
    else:
        _, pairs = candidates_feature(database, opts, device, verbose)
    return pairs
