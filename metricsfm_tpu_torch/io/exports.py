"""Interop export writers: Bundler/CMVS, OpenMVS, SURE, MSP .qin, clouds,
undistorted images, match renders.

Counterpart of metricsfm_tpu/io/exports.py; the writers are host numpy and
produce the same files, except the undistortion warp, which runs on the
caller's torch device.  Format-compatible re-implementations of the reference writers
(SfM/src/sfm_incremental.cc:1148-1394 SaveforOpenMVS/SaveforCMVS,
 slam_gps.cc:1533-1571 SaveforMSP, sfm_incremental.cc:1425-1463
 WriteCameraPointsOut) so downstream MVS tools (CMVS/PMVS, OpenMVS
 converter, SURE, MSP.exe) accept the output unchanged.

All writers take a Scene + per-image metadata; observation coordinates are
de-centered back to pixel coords (+px, +py) exactly where the reference
does so.
"""
from __future__ import annotations

import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import lie, np_geom


def _Rt(scene, img):
    return np_geom.pose_to_Rt(scene.poses[img])


def _center(scene, img):
    return np_geom.camera_center(scene.poses[img])


def write_point_cloud(path: str, scene, colors: Optional[np.ndarray] = None,
                      with_cameras: bool = True, frustum_size: float = 0.2):
    """Colored cloud + camera frustum glyphs (ref WriteCameraPointsOut,
    sfm_incremental.cc:1425-1463): 'x y z r g b' rows."""
    with open(path, "w") as f:
        for k, t in enumerate(scene.tracks):
            if t.is_bad:
                continue
            c = colors[k] if colors is not None else (255, 255, 255)
            f.write(f"{t.xyz[0]:.6f} {t.xyz[1]:.6f} {t.xyz[2]:.6f} "
                    f"{int(c[0])} {int(c[1])} {int(c[2])}\n")
        if with_cameras:
            for img in scene.registered:
                R, _ = _Rt(scene, img)
                c = _center(scene, img)
                # 5-point frustum glyph in red (ref GenerateCamera3D)
                s = frustum_size
                corners = np.array([[-s, -s, 2 * s], [s, -s, 2 * s],
                                    [s, s, 2 * s], [-s, s, 2 * s]])
                world = c[None, :] + corners @ R
                for p in np.vstack([c[None, :], world]):
                    f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} 255 0 0\n")


def write_cams_points(fold: str, scene, tag: str = ""):
    """Plain cams/pts text dumps (ref SaveModel cams_pts path)."""
    os.makedirs(fold, exist_ok=True)
    with open(os.path.join(fold, f"cams{tag}.txt"), "w") as f:
        for img in scene.registered:
            R, t = _Rt(scene, img)
            m = scene.models[scene.model_of_image[img]]
            f.write(f"{img} {m.f:.8f} {m.k1:.10f} {m.k2:.10f}\n")
            f.write(" ".join(f"{v:.10f}" for v in R.reshape(-1)) + "\n")
            f.write(" ".join(f"{v:.10f}" for v in t) + "\n")
    with open(os.path.join(fold, f"pts{tag}.txt"), "w") as f:
        for t_ in scene.tracks:
            if not t_.is_bad:
                f.write(f"{t_.xyz[0]:.8f} {t_.xyz[1]:.8f} {t_.xyz[2]:.8f}\n")


def write_bundler(path: str, scene, kp_xy: Dict[int, np.ndarray],
                  image_subset: Optional[List[int]] = None):
    """Bundler v0.3 bundle.rd.out (ref SaveforCMVS step1,
    sfm_incremental.cc:1300-1345)."""
    imgs = image_subset if image_subset is not None else scene.registered
    local = {im: k for k, im in enumerate(imgs)}
    pts = [t for t in scene.tracks
           if not t.is_bad and any(im in local for im in t.obs)]
    with open(path, "w") as f:
        f.write("# Bundle file v0.3\n")
        f.write(f"{len(imgs)} {len(pts)}\n")
        for im in imgs:
            m = scene.models[scene.model_of_image[im]]
            R, t = _Rt(scene, im)
            f.write(f"{m.f:.8f} {m.k1:.8f} {m.k2:.8f}\n")
            for row in R:
                f.write(" ".join(f"{v:.8f}" for v in row) + "\n")
            f.write(" ".join(f"{v:.8f}" for v in t) + "\n")
        for tr in pts:
            f.write(f"{tr.xyz[0]:.8f} {tr.xyz[1]:.8f} {tr.xyz[2]:.8f}\n")
            f.write("255 255 255\n")
            obs = [(im, kp) for im, kp in tr.obs.items() if im in local]
            parts = []
            for im, kp in obs:
                xy = kp_xy[im][kp]
                parts.append(f"{local[im]} {kp} {float(xy[0]):.4f} {float(xy[1]):.4f}")
            f.write(f"{len(obs)} " + " ".join(parts) + "\n")


def write_cmvs(fold: str, scene, kp_xy: Dict[int, np.ndarray],
               max_cluster: int = 500):
    """CMVS folder layout: clusters of <=500 cameras with bundle.rd.out +
    txt/ P-matrices (ref SaveforCMVS, sfm_incremental.cc:1247-1394)."""
    os.makedirs(fold, exist_ok=True)
    imgs = scene.registered
    n_cluster = max(1, math.ceil(len(imgs) / max_cluster))
    step = math.ceil(len(imgs) / n_cluster)
    for k in range(n_cluster):
        sub = imgs[k * step:(k + 1) * step]
        cfold = os.path.join(fold, f"cmvs{k}")
        os.makedirs(os.path.join(cfold, "visualize"), exist_ok=True)
        os.makedirs(os.path.join(cfold, "txt"), exist_ok=True)
        write_bundler(os.path.join(cfold, "bundle.rd.out"), scene, kp_xy, sub)
        for li, im in enumerate(sub):
            R, t = _Rt(scene, im)
            m = scene.models[scene.model_of_image[im]]
            K = np.array([[m.f, 0, 0], [0, m.f, 0], [0, 0, 1.0]])
            P = K @ np.hstack([R, t[:, None]])
            name = str(li).zfill(8)
            with open(os.path.join(cfold, "txt", f"{name}.txt"), "w") as f:
                f.write("CONTOUR\n")
                for row in P:
                    f.write(" ".join(f"{v:.8f}" for v in row) + "\n")


def write_openmvs(path: str, scene, kp_xy: Dict[int, np.ndarray],
                  image_names: Dict[int, str],
                  principal: Dict[int, tuple], sizes: Dict[int, tuple]):
    """sfm_openmvs.txt interface (ref SaveforOpenMVS,
    sfm_incremental.cc:1148-1246): cams then points with de-centered obs."""
    imgs = scene.registered
    with open(path, "w") as f:
        f.write(f"{len(imgs)}\n")
        for im in imgs:
            m = scene.models[scene.model_of_image[im]]
            R, t = _Rt(scene, im)
            f.write(f"{image_names.get(im, str(im))}\n")
            f.write(f"{m.f:.8f}\n")
            f.write(" ".join(f"{v:.8f}" for v in R.reshape(-1)) + "\n")
            f.write(" ".join(f"{v:.8f}" for v in t) + "\n")
        good = []
        for tr in scene.tracks:
            if tr.is_bad:
                continue
            obs = []
            for im, kp in tr.obs.items():
                if im not in kp_xy:
                    continue
                px, py = principal.get(im, (0.0, 0.0))
                w, h = sizes.get(im, (1 << 30, 1 << 30))
                x = kp_xy[im][kp][0] + px
                y = kp_xy[im][kp][1] + py
                if 0 <= x < w and 0 <= y < h:
                    obs.append((im, float(x), float(y)))
            if len(obs) >= 2:
                good.append((tr, obs))
        f.write(f"{len(good)}\n")
        for tr, obs in good:
            f.write(f"{tr.xyz[0]:.8f} {tr.xyz[1]:.8f} {tr.xyz[2]:.8f} "
                    f"255 255 255 {len(obs)}\n")
            for im, x, y in obs:
                f.write(f"{im} {x:.4f} {y:.4f}\n")


def write_sure(path: str, scene, image_names: Dict[int, str],
               principal: Dict[int, tuple], sizes: Dict[int, tuple]):
    """SURE-format pose file (the format DenseReconstruction reads back,
    dense_reconstruction.cc:70-111): 8 header lines then per camera
    'name w h / K / k1 k2 k3 p1 p2 / t / R'."""
    with open(path, "w") as f:
        f.write("# SURE-compatible orientation file\n")
        f.write("# written by metricsfm_tpu\n")
        for _ in range(6):
            f.write("#\n")
        for im in scene.registered:
            m = scene.models[scene.model_of_image[im]]
            R, t = _Rt(scene, im)
            px, py = principal.get(im, (0.0, 0.0))
            w, h = sizes.get(im, (0, 0))
            f.write(f"{image_names.get(im, str(im))} {w} {h}\n")
            K = [[m.f, 0.0, px], [0.0, m.f, py], [0.0, 0.0, 1.0]]
            for row in K:
                f.write(" ".join(f"{v:.8f}" for v in row) + "\n")
            f.write(f"{m.k1:.10f} {m.k2:.10f} 0.0 0.0 0.0\n")
            f.write(" ".join(f"{v:.8f}" for v in t) + "\n")
            for row in R:
                f.write(" ".join(f"{v:.8f}" for v in row) + "\n")


def write_qin(path: str, scene, image_names: Dict[int, str],
              cols: int, rows: int, pixel_mm: float = 0.005):
    """MSP pose.qin (ref SaveforMSP, slam_gps.cc:1533-1571): photogrammetry
    convention (x-axis pi rotation), X-Y-Z Euler angles
    (RotationMatrixToEulerAngles, basic_funcs.cc:245-249), focal in mm."""
    imgs = scene.registered
    m = scene.models[scene.model_of_image[imgs[0]]]
    R_cv2ph = np.diag([1.0, -1.0, -1.0])
    Rph = torch.tensor(np.stack([R_cv2ph @ _Rt(scene, im)[0] for im in imgs]),
                       dtype=torch.float64)
    euler = lie.matrix_to_euler_xyz(Rph).numpy()
    with open(path, "w") as f:
        f.write(f"{len(imgs)}\n")
        f.write(f"{m.f * pixel_mm:.12f} {0.0:.12f} {0.0:.12f} "
                f"{pixel_mm} {pixel_mm} {cols} {rows}\n")
        lines = []
        for im, e in zip(imgs, euler):
            c = _center(scene, im)
            lines.append(f"{image_names.get(im, str(im))}.jpg "
                         f"{c[0]:.12f} {c[1]:.12f} {c[2]:.12f} "
                         f"{e[0]:.12f} {e[1]:.12f} {e[2]:.12f}")
        f.write("\n".join(lines))


def write_accuracy(path: str, avg_err: float, mse: float, n_obs: int):
    """accuracy.txt (ref slam_gps.cc:1582)."""
    with open(path, "w") as f:
        f.write(f"{avg_err:.8f} {mse:.8f} {n_obs}\n")


def undistort_image(img, f: float, k1: float, k2: float, device=None):
    """Remove radial distortion from an image by inverse warping.

    Each undistorted output pixel samples the distorted source at the
    forward-distorted position r_d = r_u (1 + k1 r_u^2 + k2 r_u^4) in
    normalized (centered, /f) coordinates — the model the whole pipeline
    uses (ref SaveUndistortedImage, sfm_incremental.cc:1092-1146).

    img: (H, W) or (H, W, C) float array or tensor; the warp runs on
    `device` (default: the tensor's own, the CPU for a numpy array).
    Returns a float32 tensor of the same shape on that device.
    """
    from ..ops.sift import _bilinear

    arr = torch.as_tensor(img, dtype=torch.float32, device=device)
    H, W = arr.shape[:2]
    cx, cy = W / 2.0, H / 2.0
    ys = torch.arange(H, dtype=torch.float32, device=arr.device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=arr.device)[None, :]
    xn = ((xs - cx) / f).expand(H, W)
    yn = ((ys - cy) / f).expand(H, W)
    r2 = xn * xn + yn * yn
    factor = 1.0 + r2 * (k1 + k2 * r2)
    coords = torch.stack([cx + f * xn * factor, cy + f * yn * factor], dim=-1)
    if arr.dim() == 2:
        return _bilinear(arr, coords)
    return torch.stack([_bilinear(arr[..., c], coords)
                        for c in range(arr.shape[-1])], dim=-1)


def write_undistorted_images(fold: str, scene, image_paths: Dict[int, str],
                             verbose: bool = False, *, device):
    """Save undistorted copies of the registered images (ref
    SaveUndistortedImage: fold/undistort_images/, used before every MVS
    export), warped on `device`.  Images whose file is missing are
    skipped; k1 = k2 = 0 copies through the same resampling path for
    uniform output.  Returns the written paths."""
    from PIL import Image

    os.makedirs(fold, exist_ok=True)
    written = []
    for img in scene.registered:
        path = image_paths.get(img)
        if path is None or not os.path.exists(path):
            continue
        with Image.open(path) as im:
            src = np.asarray(im, dtype=np.float32) / 255.0
        m = scene.models[scene.model_of_image[img]]
        out = undistort_image(src, m.f, m.k1, m.k2, device=device)
        out8 = torch.clamp(out * 255.0 + 0.5, 0, 255).to(torch.uint8)
        dst = os.path.join(fold, os.path.basename(path))
        Image.fromarray(out8.cpu().numpy()).save(dst)
        written.append(dst)
        if verbose:
            print(f"undistorted {path} -> {dst}")
    return written


def write_track_overlay_image(path: str, centers_est: np.ndarray,
                              centers_gps: np.ndarray, size: int = 800,
                              dot: int = 3):
    """GPS-vs-estimate track overlay image (ref GrawGPS/GrawSLAM debug
    renders, slam_gps.cc:1107-1213): both trajectories projected to the
    xy plane in one frame, GPS green, estimate red."""
    from PIL import Image, ImageDraw
    allp = np.concatenate([centers_est[:, :2], centers_gps[:, :2]])
    lo = allp.min(axis=0)
    span = max(float((allp.max(axis=0) - lo).max()), 1e-9)
    scale = (size - 40) / span

    im = Image.new("RGB", (size, size), (255, 255, 255))
    d = ImageDraw.Draw(im)

    def to_px(p):
        q = (p[:2] - lo) * scale + 20
        return float(q[0]), float(size - q[1])

    for pts, color in ((centers_gps, (0, 160, 0)),
                       (centers_est, (220, 0, 0))):
        prev = None
        for p in pts:
            x, y = to_px(p)
            d.ellipse([x - dot, y - dot, x + dot, y + dot], fill=color)
            if prev is not None:
                d.line([prev, (x, y)], fill=color, width=1)
            prev = (x, y)
    im.save(path)


def write_match_visualization(path: str, img_i: np.ndarray,
                              img_j: np.ndarray, xy_i: np.ndarray,
                              xy_j: np.ndarray, kp_i: np.ndarray,
                              kp_j: np.ndarray,
                              good: Optional[np.ndarray] = None,
                              max_lines: int = 200):
    """Side-by-side render of one image pair with match lines.

    The reference keeps (commented-out) cv::line match-visualization
    blocks as its pair-debugging affordance
    (graph/fine_matching_graph.cc:156-180); this is the shipped
    equivalent: image i left, image j right, one line per match (green =
    `good` subset used for F estimation, orange = the rest), subsampled
    to `max_lines` evenly.

    Args:
      img_i, img_j: (H, W) grayscale in [0, 1] or (H, W, 3) uint8/float.
      xy_i, xy_j: (K, 2) CENTERED keypoint coords of each image, at the
        images' own resolution (database.cc:522-527 semantics).
      kp_i, kp_j: (N,) matched keypoint index pairs.
      good: optional (N,) bool — the ratio-test "good" subset.
    """
    from PIL import Image, ImageDraw

    def to_rgb8(im):
        a = np.asarray(im)
        if a.dtype != np.uint8:
            a = np.clip(a * 255.0 + 0.5, 0, 255).astype(np.uint8)
        if a.ndim == 2:
            a = np.stack([a] * 3, axis=-1)
        return a

    a, b = to_rgb8(img_i), to_rgb8(img_j)
    H = max(a.shape[0], b.shape[0])
    canvas = np.zeros((H, a.shape[1] + b.shape[1], 3), np.uint8)
    canvas[:a.shape[0], :a.shape[1]] = a
    canvas[:b.shape[0], a.shape[1]:] = b
    im = Image.fromarray(canvas)
    d = ImageDraw.Draw(im)

    # centered coords -> pixel coords of each half
    ci = np.asarray([a.shape[1] / 2.0, a.shape[0] / 2.0])
    cj = np.asarray([b.shape[1] / 2.0 + a.shape[1], b.shape[0] / 2.0])
    kp_i = np.asarray(kp_i, np.int64)
    kp_j = np.asarray(kp_j, np.int64)
    n = len(kp_i)
    sel = (np.linspace(0, n - 1, min(n, max_lines)).astype(np.int64)
           if n else np.zeros(0, np.int64))
    g = (np.asarray(good, bool) if good is not None
         else np.ones(n, bool))
    for s in sel:
        p = np.asarray(xy_i[kp_i[s]], float) + ci
        q = np.asarray(xy_j[kp_j[s]], float) + cj
        color = (0, 200, 0) if g[s] else (230, 140, 0)
        d.line([(p[0], p[1]), (q[0], q[1])], fill=color, width=1)
        for pt in (p, q):
            d.ellipse([pt[0] - 2, pt[1] - 2, pt[0] + 2, pt[1] + 2],
                      outline=color)
    im.save(path)
    return path
