"""K-means vocabulary, BoW transform, inverted-file similarity.

Counterpart of metricsfm_tpu/ops/kmeans.py (the reference's fbow
vocabulary stack: hierarchical k-means k=10 L=6, SURVEY.md §2.3;
src/graph/similarity_graph.cc — inverted-file co-occurrence with stop
words, and pairwise BoW distance).

A shallow two-level k-means tree trained with Lloyd iterations, where
every assignment is one f32 product (the -2 a.c distance trick); the BoW
"vector" is the word-count histogram, and image-pair similarity is one
counts @ counts.T product with idf weighting and stop-word zeroing — the
inverted-file semantics as dense linear algebra.  Plain torch on the
caller's device, in f32 (the package turns TF32 off).

The fine level of the tree is trained as one masked k-means over the
coarse cells padded to a common row count, so the k-means++ and Lloyd
loops run once for all cells and never wait on the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .segsum import make_plan, segment_sum

# the fine stage's padded rows a block: cells x the widest cell's rows
# (at D = 128, 1 GiB of f32 and as much again for the k-means++ step)
MAX_BLOCK_ROWS = 1 << 21


class Vocabulary(NamedTuple):
    """Two-level k-means tree: coarse (B1, D) + fine (B1, B2, D) centroids.

    n_words = B1 * B2.  Replaces fbow's k=10/L=6 deep tree with a shallow
    one (two products per assignment, same BoW semantics).
    """
    coarse: torch.Tensor
    fine: torch.Tensor

    @property
    def n_words(self):
        return self.coarse.shape[0] * self.fine.shape[1]

    @classmethod
    def from_numpy(cls, coarse, fine, device) -> "Vocabulary":
        """A vocabulary from (B1, D) and (B1, B2, D) arrays (the `voctree.npz`
        store, or the JAX package's vocabulary as numpy), on `device`."""
        def put(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)
        return cls(coarse=put(coarse), fine=put(fine))


def _assign(desc, centroids):
    """Nearest-centroid index per row by one f32 product: desc (..., N, D),
    centroids (..., K, D) -> (..., N) int64; ties go to the lowest index."""
    sim = desc @ centroids.transpose(-1, -2)
    c2 = torch.sum(centroids * centroids, dim=-1)
    return torch.argmin(c2[..., None, :] - 2.0 * sim, dim=-1)


def _draw(w, generator):
    """One index per row of w (B, N) >= 0, drawn with probability
    proportional to w: the exponential race torch.multinomial runs for a
    single sample, without its host-side validity checks (each would wait
    on the device).  A row of zeros draws index 0."""
    q = torch.empty_like(w).exponential_(1.0, generator=generator)
    return torch.argmax(w / q.clamp_min(torch.finfo(w.dtype).tiny), dim=-1)


def _kmeanspp_init(desc, generator, k: int, m):
    """k-means++ seeding of each batch row: desc (B, N, D), m (B, N) row
    weights (0 = masked).  Each next center is drawn with probability
    proportional to the squared distance from the chosen set — a uniform-row
    init falls into Lloyd's local optima (two seeds in one cluster leave
    another cluster uncovered).  Returns (B, k, D)."""
    B, N, D = desc.shape
    b = torch.arange(B, device=desc.device)
    c = desc[b, _draw(m, generator)]
    cent = torch.empty((B, k, D), dtype=desc.dtype, device=desc.device)
    cent[:, 0] = c
    d2 = torch.sum((desc - c[:, None]) ** 2, dim=-1)
    for i in range(1, k):
        p = d2 * m
        # every weighted row already chosen: draw among the valid rows
        p = torch.where(torch.sum(p, dim=-1, keepdim=True) > 0, p, m)
        c = desc[b, _draw(p, generator)]
        cent[:, i] = c
        d2 = torch.minimum(d2, torch.sum((desc - c[:, None]) ** 2, dim=-1))
    return cent


def _lloyd(desc, m, cent, iters: int, n_rows):
    """Lloyd iterations of each batch row: desc (B, N, D), m (B, N) 0/1
    row mask, cent (B, k, D), n_rows (B,) the row count an empty cluster
    re-seeds from.  Empty clusters re-seed deterministically from data
    rows desc[(arange(k) * 7919) % n_rows] (fbow keeps k fixed).  Each
    iteration's cluster sums go through a segment plan of its assignment
    (ops/segsum: one fixed order, no atomics on the card); the counts are
    the plan's segment lengths."""
    B, N, D = desc.shape
    k = cent.shape[1]
    dev = desc.device
    b = torch.arange(B, device=dev)
    seed_rows = (torch.arange(k, device=dev) * 7919)[None, :] \
        % n_rows.to(dev)[:, None]
    reseed = desc[b[:, None], seed_rows].reshape(B * k, D)
    keep = m > 0
    offs = (b * k)[:, None]
    for _ in range(iters):
        plan = make_plan(_assign(desc, cent) + offs, B * k, keep)
        sums = segment_sum(desc, plan)
        counts = (plan.off[1:] - plan.off[:-1]).to(desc.dtype)
        new = sums / torch.clamp_min(counts, 1e-6)[:, None]
        cent = torch.where(counts[:, None] > 0.5, new, reseed).reshape(B, k, D)
    return cent


def kmeans(desc, k: int, iters: int = 20, mask=None,
           generator: Optional[torch.Generator] = None, init=None):
    """Lloyd's k-means on (N, D) rows with k-means++ init; returns (k, D)
    centroids on desc's device.

    generator: the stream of the k-means++ draws (default: seeded 0).
    init: optional (k, D) initial centroids, in place of the k-means++
      draw (so tests can feed both packages one init).
    Empty clusters re-seed from data rows (fbow keeps k fixed).
    """
    N = desc.shape[0]
    m = torch.ones(N, dtype=desc.dtype, device=desc.device) if mask is None \
        else mask.to(device=desc.device, dtype=desc.dtype)
    if init is not None:
        cent = torch.as_tensor(init, dtype=desc.dtype).to(desc.device)
    else:
        if generator is None:
            generator = torch.Generator(device=desc.device).manual_seed(0)
        cent = _kmeanspp_init(desc[None], generator, k, m[None])[0]
    return _lloyd(desc[None], m[None], cent[None], iters,
                  torch.tensor([N]))[0]


def _padded_cells(desc, cell, cells, n_cells, width: int):
    """Rows of the given coarse cells packed at the front of a (C, width, D)
    block, in row order, with their (C, width) mask."""
    D = desc.shape[1]
    dev = desc.device
    slot = torch.full((int(n_cells.shape[0]),), -1, dtype=torch.long,
                      device=dev)
    slot[cells] = torch.arange(len(cells), device=dev)
    rows = torch.nonzero(slot[cell] >= 0).reshape(-1)   # row order kept
    s = slot[cell[rows]]
    order = torch.argsort(s, stable=True)
    rows, s = rows[order], s[order]
    start = torch.cumsum(n_cells[cells], 0) - n_cells[cells]
    pos = torch.arange(len(rows), device=dev) - start[s]
    block = torch.zeros((len(cells), width, D), dtype=desc.dtype, device=dev)
    mask = torch.zeros((len(cells), width), dtype=desc.dtype, device=dev)
    block[s, pos] = desc[rows]
    mask[s, pos] = 1.0
    return block, mask


def train_vocabulary(desc, generator: Optional[torch.Generator] = None,
                     branch1: int = 64, branch2: int = 64, iters: int = 15,
                     mask=None) -> Vocabulary:
    """Train the two-level tree on desc (N, D) (mirrors
    Database::BuildVocabularyTree, database.cc:655-677: trained on a sample
    of descriptors from <= num_image_voc images).

    The coarse level is one k-means; each coarse cell with at least
    `branch2` rows gets its own fine k-means, run for all such cells at
    once over their rows padded to a common count (in blocks of at most
    MAX_BLOCK_ROWS padded rows).  A cell with fewer rows tiles its rows;
    an empty cell repeats its coarse centroid.  One generator is consumed
    in order (default: seeded 0).
    """
    dev = desc.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    coarse = kmeans(desc, branch1, iters, mask, generator)
    valid = torch.ones(desc.shape[0], dtype=torch.bool, device=dev) \
        if mask is None else mask.to(dev).bool()
    # masked rows go to a sentinel cell past the last one
    cell = torch.where(valid, _assign(desc, coarse), branch1)
    # integer counts: exact in any order
    n_cells = torch.zeros(branch1 + 1, dtype=torch.long, device=dev
                          ).index_add_(0, cell, torch.ones_like(cell))
    n_host = n_cells[:branch1].cpu().numpy()
    fine = coarse[:, None, :].repeat(1, branch2, 1)       # empty cells
    for c in np.nonzero((n_host > 0) & (n_host < branch2))[0]:
        rows = torch.nonzero(cell == int(c)).reshape(-1)
        fine[c] = desc[rows[torch.arange(branch2, device=dev) % len(rows)]]
    full = np.nonzero(n_host >= branch2)[0]
    full = full[np.argsort(n_host[full], kind="stable")]  # like sizes batch
    lo = 0
    while lo < len(full):
        hi = lo + 1
        while hi < len(full) and \
                (hi + 1 - lo) * n_host[full[hi]] <= MAX_BLOCK_ROWS:
            hi += 1
        cells = torch.as_tensor(full[lo:hi]).to(dev)
        block, m = _padded_cells(desc, cell, cells, n_cells,
                                 int(n_host[full[hi - 1]]))
        cent = _kmeanspp_init(block, generator, branch2, m)
        fine[cells] = _lloyd(block, m, cent, iters, n_cells[cells])
        lo = hi
    return Vocabulary(coarse=coarse, fine=fine)


def transform(voc: Vocabulary, desc, mask=None):
    """Per-descriptor word ids + word-count histogram (the fBow vector).

    Mirrors Vocabulary::transform (fbow.h:87) + GenerateWordsForImage
    (database.cc:853-867).
    Returns (word_ids (N,) int32, -1 on masked rows; counts (n_words,) f32).
    """
    c_idx = _assign(desc, voc.coarse)                        # (N,)
    fine_c = voc.fine[c_idx]                                 # (N, B2, D)
    sim = torch.bmm(fine_c, desc[:, :, None])[..., 0]        # (N, B2)
    c2 = torch.sum(fine_c * fine_c, dim=-1)
    f_idx = torch.argmin(c2 - 2.0 * sim, dim=-1)
    words = c_idx * voc.fine.shape[1] + f_idx
    w = torch.ones(desc.shape[0], dtype=torch.float32, device=desc.device) \
        if mask is None else mask.to(desc.device).float()
    # 0/1 counts, exact in f32 below 2^24 in any order
    counts = torch.zeros(voc.n_words, dtype=torch.float32,
                         device=desc.device).index_add_(0, words, w)
    words = torch.where(w > 0, words, -1).to(torch.int32)
    return words, counts


def similarity_matrix(counts, stop_word_frac: float = 0.01):
    """Pairwise image similarity from BoW count rows (n_imgs, n_words).

    Inverted-file semantics as dense algebra (similarity_graph.cc:47-117):
    a word whose inverted-file list is longer than stop_word_frac * n_words
    images is dropped as a stop word (the reference's th_bin_size =
    num_words_/100, GenerateInvertedFile condition 2 — the threshold is
    derived from the VOCABULARY size, not the image count); surviving rows
    are idf-weighted and L2-normalized; similarity is the cosine matrix
    (one product).  Diagonal zeroed.
    """
    n, n_words = counts.shape
    present = (counts > 0).float()
    doc_freq = torch.sum(present, dim=0)
    keep = doc_freq <= max(stop_word_frac * n_words, 1.0)
    idf = torch.log(torch.clamp_min(n / torch.clamp_min(doc_freq, 1.0), 1.0))
    w = counts * idf[None, :] * keep[None, :].float()
    w = w / torch.clamp_min(
        torch.linalg.vector_norm(w, dim=1, keepdim=True), 1e-12)
    sim = w @ w.T
    return sim * (1.0 - torch.eye(n, dtype=sim.dtype, device=sim.device))


def word_intersection_counts(counts):
    """Number of common distinct words per image pair, one product.

    The cheap pre-seeding gate of the reference's initial matching graph
    (initial_matching_graph.cc:210-289: candidate pairs whose word-id
    intersection yields fewer than ~30 seed matches are dropped before any
    fine matching); presence intersection as an (n_imgs, n_words) 0/1
    product (exact in f32 below 2^24 words).
    """
    present = (counts > 0).float()
    return present @ present.T


def similarity_chunked(word_lists, n_words: int,
                       stop_word_frac: float = 0.01, block: int = 8192, *,
                       device):
    """similarity_matrix + word_intersection_counts from per-image word-id
    lists, accumulated on `device` over word BLOCKS — never builds the
    (n_images, n_words) counts matrix (1.3 GB+ at 5k images x 65k words;
    ref similarity_graph.cc:47-117 streams an inverted file for the same
    reason).

    Args:
      word_lists: sequence of int arrays of per-keypoint word ids (-1 =
        masked, duplicates = multi-hit words), one per image.
      n_words: vocabulary size.
    Returns (sim (n, n) np.float32 cosine with zero diagonal,
             inter (n, n) np.float32 distinct-word intersection counts).
    Peak memory: O(n^2 + n * block + total keypoints).
    """
    n = len(word_lists)
    ws = [np.asarray(w).reshape(-1) for w in word_lists]
    ws = [w[w >= 0].astype(np.int64) for w in ws]
    img = torch.from_numpy(np.repeat(np.arange(n, dtype=np.int64),
                                     [len(w) for w in ws])).to(device)
    wid = torch.from_numpy(np.concatenate(ws) if ws
                           else np.zeros(0, np.int64)).to(device)
    # one entry per (image, word) present, with the word's count there
    key, cnt = torch.unique(img * n_words + wid, return_counts=True)
    ki, kw = key // n_words, key % n_words
    # pass 1: document frequency -> stop words + idf
    one = torch.ones_like(kw, dtype=torch.float32)
    # 0/1 counts, exact in f32 below 2^24 in any order
    doc_freq = torch.zeros(n_words, dtype=torch.float32,
                           device=device).index_add_(0, kw, one)
    keep = doc_freq <= max(stop_word_frac * n_words, 1.0)
    idf = torch.log(torch.clamp_min(n / torch.clamp_min(doc_freq, 1.0), 1.0)) \
        * keep.float()
    val = cnt.float() * idf[kw]
    # pass 2: S_raw = sum_blk W W^T and the presence intersections
    S = torch.zeros((n, n), dtype=torch.float32, device=device)
    inter = torch.zeros((n, n), dtype=torch.float32, device=device)
    for w0 in range(0, n_words, block):
        blk = min(block, n_words - w0)
        sel = (kw >= w0) & (kw < w0 + blk)
        r, c = ki[sel], kw[sel] - w0
        W = torch.zeros((n, blk), dtype=torch.float32, device=device)
        P = torch.zeros((n, blk), dtype=torch.float32, device=device)
        W[r, c] = val[sel]
        P[r, c] = 1.0
        S += W @ W.T
        inter += P @ P.T
    norms = torch.sqrt(torch.clamp_min(torch.diagonal(S), 1e-12))
    S = S / norms[:, None] / norms[None, :]
    S.fill_diagonal_(0.0)
    return S.cpu().numpy(), inter.cpu().numpy()


def top_candidates(sim, n_candidates: int):
    """Per-image top-k similar images (ref initial_matching_graph.cc:168-169:
    min(max(200, n/10), 500) candidates per image).  Returns (values,
    indices)."""
    vals, idx = torch.topk(sim, n_candidates, dim=-1)
    return vals, idx
