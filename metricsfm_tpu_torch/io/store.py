"""Columnar per-image array store with resume semantics.

Counterpart of metricsfm_tpu/io/store.py, byte-compatible with it: the port
reads feature, match and scene stores the JAX package wrote, and the other
way round.  Replaces the reference's ad-hoc binary files + append-log indices
({i}_feature / {i}_words / {i}_match + feature_index.txt etc.,
 database.cc:490-541,753-811, fine_matching_graph.cc:182-193) with .npz
shards keyed by image id.  Resume = "recompute whatever file is missing",
exactly the reference semantics (database.cc:209-247).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np


def _fpath(out: str, i: int) -> str:
    return os.path.join(out, f"{i}_feature.npz")


def _npath(out: str, i: int) -> str:
    return os.path.join(out, f"{i}_feature.msf")


def _wpath(out: str, i: int) -> str:
    return os.path.join(out, f"{i}_words.npz")


def has_features(out: str, i: int) -> bool:
    return os.path.exists(_fpath(out, i)) or os.path.exists(_npath(out, i))


def write_features(out: str, i: int, xy, desc, mask, sigma, angle, meta: dict,
                   native: bool = False):
    """Persist one image's feature record.

    native=True routes the ARRAY payload through the C++ raw-record store
    (native/feature_store.cpp, io/native_store.py) — fixed-layout
    memcpy-able records instead of per-file deflate (the reference's
    counterpart is its binary per-image file IO,
    SfM/src/database.cc:490-541).  The non-array metadata (gps, source
    path) rides in a tiny JSON sidecar.  Falls back to .npz when the
    native library can't be built.
    """
    if native:
        from . import native_store
        p = _npath(out, i)
        if native_store.write_features(
                p + ".tmp", xy, desc, mask, sigma, angle,
                int(meta["width"]), int(meta["height"]),
                float(meta.get("focal_px", 0.0))):
            with open(p + ".json.tmp", "w") as f:
                json.dump(meta, f)
            os.replace(p + ".json.tmp", p + ".json")
            os.replace(p + ".tmp", p)
            return
    tmp = os.path.join(out, f"{i}_feature.tmp.npz")
    np.savez_compressed(tmp, xy=xy, desc=desc, mask=mask, sigma=sigma,
                        angle=angle, meta=json.dumps(meta))
    os.replace(tmp, _fpath(out, i))


def read_features(out: str, i: int) -> Optional[dict]:
    pn = _npath(out, i)
    if os.path.exists(pn):
        from . import native_store
        d = native_store.read_features(pn)
        if d is not None:
            meta = {"width": d["width"], "height": d["height"],
                    "focal_px": d["focal"]}
            if os.path.exists(pn + ".json"):
                with open(pn + ".json") as f:
                    meta = json.load(f)
            return {"xy": d["xy"], "desc": d["desc"], "mask": d["mask"],
                    "sigma": d["sigma"], "angle": d["angle"], "meta": meta}
    p = _fpath(out, i)
    if not os.path.exists(p):
        return None
    with np.load(p, allow_pickle=False) as z:
        return {"xy": z["xy"], "desc": z["desc"], "mask": z["mask"],
                "sigma": z["sigma"], "angle": z["angle"],
                "meta": json.loads(str(z["meta"]))}


def write_words(out: str, i: int, words, counts):
    np.savez_compressed(_wpath(out, i), words=words, counts=counts)


def read_words(out: str, i: int) -> Optional[dict]:
    p = _wpath(out, i)
    if not os.path.exists(p):
        return None
    with np.load(p) as z:
        return {"words": z["words"], "counts": z["counts"]}


def _impath(out: str, i: int) -> str:
    return os.path.join(out, f"{i}_match.npz")


def write_image_matches(out: str, i: int, matches: Dict):
    """One shard per FIRST image: {j: (kp_i, kp_j)} for every processed
    pair (i, j) — empty pairs are recorded as processed but carry no
    arrays.  Mirrors the reference's per-image {i}_match binaries
    (fine_matching_graph.cc:182-193).  One uncompressed file per image
    instead of one deflated file per pair: file creation and deflate per
    pair dominate the stage at thousands of pairs.
    """
    arrs = {"js": np.array(sorted(matches), np.int64)}
    for j, (a, b) in matches.items():
        if len(a):
            arrs[f"a{j}"] = np.asarray(a, np.int64)
            arrs[f"b{j}"] = np.asarray(b, np.int64)
    tmp = os.path.join(out, f"{i}_match.tmp.npz")
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, _impath(out, i))


def read_image_matches(out: str, i: int) -> Optional[dict]:
    """Returns {"processed": set(j), "pairs": {j: (kp_i, kp_j)}} (pairs
    holds only non-empty matches)."""
    p = _impath(out, i)
    if not os.path.exists(p):
        return None
    with np.load(p) as z:
        js = set(int(j) for j in z["js"])
        pairs = {}
        for j in js:
            if f"a{j}" in z:
                pairs[j] = (z[f"a{j}"], z[f"b{j}"])
    return {"processed": js, "pairs": pairs}


# -- vocabulary ------------------------------------------------------------

def write_vocabulary(out: str, voc):
    np.savez_compressed(os.path.join(out, "voctree.npz"),
                        coarse=voc.coarse.cpu().numpy(),
                        fine=voc.fine.cpu().numpy())


def read_vocabulary(out: str, device):
    """The stored vocabulary on `device`, or None."""
    p = os.path.join(out, "voctree.npz")
    if not os.path.exists(p):
        return None
    from ..ops.kmeans import Vocabulary
    with np.load(p) as z:
        return Vocabulary.from_numpy(z["coarse"], z["fine"], device)


# -- match graph -----------------------------------------------------------

def write_match_graph(out: str, graph: Dict):
    """graph: {(i, j): n_matches} upper-triangular dict."""
    items = sorted(graph.items())
    arr = np.array([[i, j, n] for (i, j), n in items], np.int64).reshape(-1, 3)
    np.savez_compressed(os.path.join(out, "graph_matching.npz"), edges=arr)


def read_match_graph(out: str) -> Optional[Dict]:
    p = os.path.join(out, "graph_matching.npz")
    if not os.path.exists(p):
        return None
    with np.load(p) as z:
        return {(int(i), int(j)): int(n) for i, j, n in z["edges"]}


# -- reconstruction checkpoints (ref WriteTempResultOut, sfm_incremental.cc:1465) --
# JSON in the JAX package's layout: either package resumes the other's.

def write_scene_checkpoint(out: str, scene, tag: str):
    poses = {str(k): v.tolist() for k, v in scene.poses.items()}
    models = [{"f": m.f, "k1": m.k1, "k2": m.k2, "f_hint": m.f_hint,
               "calibrated": m.calibrated} for m in scene.models]
    model_of_image = {str(k): v for k, v in scene.model_of_image.items()}
    tracks = [{"xyz": t.xyz.tolist(),
               "obs": {str(k): int(v) for k, v in t.obs.items()},
               "bad": t.is_bad} for t in scene.tracks]
    fails = {str(k): v for k, v in scene.localization_failures.items()}
    blob = {"poses": poses, "models": models, "model_of_image": model_of_image,
            "tracks": tracks, "failures": fails, "n_images": scene.n_images}
    tmp = os.path.join(out, f"scene_{tag}.json.tmp")
    with open(tmp, "w") as f:
        json.dump(blob, f)
    os.replace(tmp, os.path.join(out, f"scene_{tag}.json"))


def read_scene_checkpoint(out: str, tag: str, kp_counts: Dict[int, int]):
    """Rebuild a Scene (ref ReadTempResultIn, sfm_incremental.cc:1622-1749);
    None when there is no checkpoint.  Bad tracks are dropped."""
    p = os.path.join(out, f"scene_{tag}.json")
    if not os.path.exists(p):
        return None
    from ..models.scene import CameraModel, Scene
    with open(p) as f:
        blob = json.load(f)
    scene = Scene(blob["n_images"])
    for m in blob["models"]:
        scene.add_camera_model(CameraModel(**m))
    for k, pose in blob["poses"].items():
        img = int(k)
        scene.register_image(img, np.array(pose),
                             blob["model_of_image"][k], kp_counts[img])
    for t in blob["tracks"]:
        if t["bad"]:
            continue
        scene.add_track(np.array(t["xyz"]),
                        {int(k): v for k, v in t["obs"].items()})
    scene.localization_failures = {int(k): v
                                   for k, v in blob["failures"].items()}
    return scene
