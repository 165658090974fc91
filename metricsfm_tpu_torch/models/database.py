"""Image database: discovery, EXIF, feature extraction, resume.

Counterpart of metricsfm_tpu/models/database.py; re-design of the reference
Database (SfM/src/database.{h,cc}):
  * image discovery by glob over jpg/png/bmp/tiff (database.cc:178-207)
  * EXIF focal (mm -> pixels) + GPS (database.cc:249-281) via PIL
  * optional resize to a target pixel count (database.cc:300-308)
  * SIFT feature extraction (ops/sift.py) on a torch device with per-image
    persistence and resume: only missing entries recomputed (feature_index
    semantics, database.cc:62-100,209-247)
  * vocabulary training + per-image word bags (database.cc:655-867), on
    the same device (ops/kmeans.py)

Storage is the JAX package's per-image store (io/store.py), so either
package resumes from the other's features, vocabulary and words.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from ..config import DatabaseOptions
from ..io import store as fstore
from ..ops import sift
from ..utils import exif as exif_util
from ..utils.device import resolve as resolve_device
from .incremental import ImageFeatures

IMAGE_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff")


def search_image_paths(fold: str) -> List[str]:
    """Glob image files (ref SearchImagePaths, database.cc:178-207)."""
    out = []
    for p in sorted(os.listdir(fold)):
        if p.lower().endswith(IMAGE_EXTS):
            out.append(os.path.join(fold, p))
    return out


def load_image_gray(path: str, target_pixels: Optional[int] = None):
    """Decode to float grayscale in [0,1]; optional resize to ~target pixels
    (ref database.cc:300-308).  Returns (img (H,W) float32, ratio)."""
    from PIL import Image
    im = Image.open(path)
    w, h = im.size
    ratio = 1.0
    if target_pixels and w * h > target_pixels:
        ratio = (target_pixels / (w * h)) ** 0.5
        im = im.resize((max(int(w * ratio), 8), max(int(h * ratio), 8)))
    g = np.asarray(im.convert("L"), np.float32) / 255.0
    return g, ratio


class Database:
    """Feature + word database with per-image resume."""

    def __init__(self, fold: str, options: DatabaseOptions,
                 output_fold: Optional[str] = None,
                 owner: Optional[Tuple[int, int]] = None, device="cuda"):
        """owner=(process_id, process_count) makes this database instance
        responsible for a contiguous image shard: feature extraction (and
        its resume bookkeeping) only touches owned images — the host-level
        sharding of the per-image store for multi-host runs (SURVEY §5;
        the reference's per-image files sharded per host).  Reads are
        unrestricted (a shared filesystem or a post-run sync is assumed,
        like the reference's output folder).  Extraction runs on `device`
        (the card unless the caller passes the CPU)."""
        self.device = resolve_device(device)
        self.fold = fold
        self.opts = options
        self.out = output_fold or os.path.join(fold, "mtpu_db")
        os.makedirs(self.out, exist_ok=True)
        self.image_paths = search_image_paths(fold)
        self.n_images = len(self.image_paths)
        self.owner = owner
        self.image_info: List[dict] = [None] * self.n_images
        self._features: Dict[int, ImageFeatures] = {}

    def owned_images(self) -> range:
        if self.owner is None:
            return range(self.n_images)
        from ..parallel.mesh import owned_range
        lo, hi = owned_range(self.n_images, *self.owner)
        return range(lo, hi)

    # -- feature stage -----------------------------------------------------
    @staticmethod
    def _shape_bucket(h: int, w: int, quantum: int = 256) -> Tuple[int, int]:
        """Round (H, W) up to a padded bucket so slightly different image
        sizes share one batch shape."""
        return (-(-h // quantum) * quantum, -(-w // quantum) * quantum)

    def feature_extraction(self, jit_pad_to: Optional[Tuple[int, int]] = None,
                           batch_size: int = 4, verbose: bool = False):
        """Extract (or resume) SIFT features for every image
        (ref FeatureExtraction, database.cc:51-107).

        Images are zero-padded into shape buckets and extracted in device
        batches; the asynchronous launch of batch N overlaps the host-side
        decode of batch N+1.  Keypoint coordinates are
        re-centered to the ORIGINAL image center (padding shifts the
        padded-image center) and detections inside the padding margin are
        masked out.
        """
        cfg = sift.SiftConfig(max_keypoints=self.opts.max_keypoints)
        missing = [i for i in self.owned_images()
                   if not fstore.has_features(self.out, i)]
        if not missing:
            return

        # cheap size-probe prepass (no pixel decode) to group images into
        # padded shape buckets; decode happens lazily per batch so host
        # memory stays O(batch), not O(dataset)
        from PIL import Image
        target = self.opts.size_image if self.opts.resize else None
        buckets: Dict[Tuple[int, int], List[int]] = {}
        for i in missing:
            with Image.open(self.image_paths[i]) as im:
                w, h = im.size
            if target and w * h > target:
                r = (target / (w * h)) ** 0.5
                w, h = max(int(w * r), 8), max(int(h * r), 8)
            bk = jit_pad_to or self._shape_bucket(h, w)
            buckets.setdefault(tuple(bk), []).append(i)

        def _drain(pending):
            """Fetch + persist one previously-dispatched batch."""
            chunk, loaded, out_dev, (Hb, Wb) = pending
            # the only device->host copies of the stage: launches are
            # asynchronous, so the dispatch step below never waits
            out = {k: v.cpu().numpy() for k, v in out_dev.items()}
            for b, i in enumerate(chunk):
                img, ratio, info = loaded[i]
                H, W = img.shape
                # re-center: extract() centers at the PADDED image
                # center; shift back to the original one and drop
                # detections that fall inside the padding
                xy_pix = out["xy"][b] + np.array([Wb / 2.0, Hb / 2.0])
                margin = 8.0
                ok = out["mask"][b] & (xy_pix[:, 0] < W - margin) & \
                    (xy_pix[:, 1] < H - margin)
                xy = xy_pix - np.array([W / 2.0, H / 2.0])
                fstore.write_features(
                    self.out, i,
                    xy=xy, desc=out["desc"][b], mask=ok,
                    sigma=out["sigma"][b], angle=out["angle"][b],
                    meta={"width": W, "height": H,
                          "focal_px": info.get("focal_px", 0.0) * ratio,
                          "gps": info.get("gps", (0.0, 0.0, 0.0)),
                          "path": self.image_paths[i]},
                    native=self.opts.use_native_store)
            return len(chunk)

        # double-buffered: dispatch batch N (async — the launches return
        # before the device finishes), decode batch N+1 on host while it
        # runs, then drain N.  Decode and device extraction fully overlap; the
        # serial form paid them back-to-back.
        done = 0
        pending = None
        for (Hb, Wb), idxs in buckets.items():
            for start in range(0, len(idxs), batch_size):
                chunk = idxs[start:start + batch_size]
                loaded = {}
                batch = np.zeros((len(chunk), Hb, Wb), np.float32)
                for b, i in enumerate(chunk):
                    img, ratio = load_image_gray(self.image_paths[i], target)
                    info = exif_util.extract_image_info(self.image_paths[i])
                    loaded[i] = (img, ratio, info)
                    batch[b, :img.shape[0], :img.shape[1]] = img[:Hb, :Wb]
                x = torch.from_numpy(batch)
                if self.device.type == "cuda":
                    # pinned: the upload queues behind batch N's kernels
                    # instead of waiting for them
                    x = x.pin_memory()
                out_dev = sift.extract(x.to(self.device, non_blocking=True),
                                       cfg)
                if pending is not None:
                    done += _drain(pending)
                    if verbose:
                        print(f"features {done}/{len(missing)}")
                pending = (chunk, loaded, out_dev, (Hb, Wb))
        if pending is not None:
            done += _drain(pending)
            if verbose:
                print(f"features {done}/{len(missing)}")

    def features(self, i: int) -> ImageFeatures:
        """Lazy paged read (ref ReadinImageFeatures/Release,
        database.cc:352-423,595-600)."""
        if i not in self._features:
            d = fstore.read_features(self.out, i)
            self._features[i] = ImageFeatures(
                xy=d["xy"], desc=d["desc"], mask=d["mask"],
                width=int(d["meta"]["width"]), height=int(d["meta"]["height"]),
                focal_exif=float(d["meta"]["focal_px"]))
        return self._features[i]

    def gps(self, i: int):
        d = fstore.read_features(self.out, i)
        return tuple(d["meta"]["gps"])

    def release(self, i: int):
        self._features.pop(i, None)

    # -- word stage --------------------------------------------------------
    def build_words(self, generator: Optional[torch.Generator] = None,
                    verbose: bool = False):
        """Vocabulary + per-image word bags with resume
        (ref BuildWords/BuildVocabularyTree, database.cc:655-867).

        Returns (vocabulary, counts (n_images, n_words) np.float32), counts
        None when n_images * n_words exceeds 50 M (candidate selection then
        goes through word_lists() + ops.kmeans.similarity_chunked).
        generator: the k-means++ draws' stream (default: seeded 0).
        """
        from ..ops import kmeans as km

        voc = fstore.read_vocabulary(self.out, self.device)
        if voc is None:
            # sample training descriptors from <= num_image_voc images
            idxs = np.linspace(0, self.n_images - 1,
                               min(self.n_images, self.opts.num_image_voc)
                               ).astype(int)
            descs = []
            for i in idxs:
                f = self.features(i)
                descs.append(f.desc[f.mask])
                self.release(i)
            train = np.concatenate(descs)[:200000]
            # Honor voc_branch/voc_level (ref fbow k=10, L=6) as a target
            # word count for a two-level tree, capped by what the sample
            # can support (>= 8 training descriptors per word).
            target_words = min(self.opts.voc_branch ** self.opts.voc_level,
                               max(256, min(65536, len(train) // 8)))
            b1 = max(2, int(np.ceil(np.sqrt(target_words))))
            voc = km.train_vocabulary(
                torch.from_numpy(np.ascontiguousarray(train, np.float32)
                                 ).to(self.device),
                generator, branch1=b1, branch2=b1)
            fstore.write_vocabulary(self.out, voc)
            if verbose:
                print(f"vocabulary: {voc.n_words} words")
        n_words = int(voc.n_words)
        dense = self.n_images * n_words <= 50_000_000
        counts = np.zeros((self.n_images, n_words), np.float32) if dense \
            else None
        for i in range(self.n_images):
            cached = fstore.read_words(self.out, i)
            if cached is not None:
                if dense:
                    counts[i] = cached["counts"]
                continue
            f = self.features(i)
            if int(f.mask.sum()) < self.opts.min_keypoints_for_words:
                fstore.write_words(self.out, i,
                                   words=np.full(len(f.xy), -1, np.int32),
                                   counts=np.zeros(n_words, np.float32))
                self.release(i)
                continue
            words, cts = km.transform(
                voc, torch.from_numpy(np.asarray(f.desc, np.float32)
                                      ).to(self.device),
                torch.from_numpy(np.asarray(f.mask, bool)).to(self.device))
            cts = cts.cpu().numpy()
            fstore.write_words(self.out, i, words=words.cpu().numpy(),
                               counts=cts)
            if dense:
                counts[i] = cts
            self.release(i)
        return voc, counts

    def word_lists(self):
        """Per-image keypoint word-id arrays (build_words must have run).
        The sparse counterpart of the dense counts matrix — O(total
        keypoints) memory regardless of vocabulary size."""
        out = []
        for i in range(self.n_images):
            cached = fstore.read_words(self.out, i)
            out.append(cached["words"] if cached is not None
                       else np.empty(0, np.int32))
        return out
