"""Synthetic rendered-image scenes with exact ground truth.

Counterpart of the scene fixtures of metricsfm_tpu/utils/synth.py: a
piecewise-planar textured scene rendered from N pinhole cameras by exact
homography inverse-warping (compositing near-over-far gives parallax and
occlusion — a non-planar scene, not degenerate for F estimation).  Host
numpy; the same seed renders the same images as the JAX package.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..ops import np_geom


def multiscale_texture(rng: np.random.Generator, size: int = 512,
                       scales: Tuple[int, ...] = (8, 24, 64, 192)) -> np.ndarray:
    """Random texture with power at several spatial scales.

    Sums bilinearly-upsampled white noise at a few coarse resolutions plus a
    fine layer — rich in blob/corner structure at multiple DoG octaves, and
    locally distinctive (unlike e.g. pure gaussian blobs, whose rotationally
    symmetric neighbourhoods defeat the SIFT ratio test).
    """
    img = np.zeros((size, size), np.float32)
    for s in scales:
        coarse = rng.uniform(-1.0, 1.0, size=(s, s)).astype(np.float32)
        # bilinear upsample coarse -> size
        yy = np.linspace(0, s - 1, size)
        xx = np.linspace(0, s - 1, size)
        y0 = np.clip(yy.astype(int), 0, s - 2)
        x0 = np.clip(xx.astype(int), 0, s - 2)
        fy = (yy - y0)[:, None]
        fx = (xx - x0)[None, :]
        up = (coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
              + coarse[np.ix_(y0 + 1, x0)] * fy * (1 - fx)
              + coarse[np.ix_(y0, x0 + 1)] * (1 - fy) * fx
              + coarse[np.ix_(y0 + 1, x0 + 1)] * fy * fx)
        img += up * (0.55 + 0.45 * (s / scales[-1]))
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return 0.08 + 0.84 * img


def _look_at(c: np.ndarray, target: np.ndarray) -> np.ndarray:
    """World->cam rotation rows for a camera at `c` looking at `target`
    (z forward, y down-ish — matches ops/projection conventions)."""
    z = target - c
    z = z / np.linalg.norm(z)
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=0)


def _bilinear(tex: np.ndarray, s: np.ndarray, t: np.ndarray) -> np.ndarray:
    T = tex.shape[0]
    u = np.clip(s, 0.0, 1.0) * (T - 1)
    v = np.clip(t, 0.0, 1.0) * (T - 1)
    u0 = np.clip(u.astype(int), 0, T - 2)
    v0 = np.clip(v.astype(int), 0, T - 2)
    fu = u - u0
    fv = v - v0
    return (tex[v0, u0] * (1 - fv) * (1 - fu) + tex[v0 + 1, u0] * fv * (1 - fu)
            + tex[v0, u0 + 1] * (1 - fv) * fu + tex[v0 + 1, u0 + 1] * fv * fu)


def default_planes() -> List[dict]:
    """Three textured rectangles at different depths/orientations around the
    world point (0, 0, 8) the cameras fixate."""
    return [
        # far back-wall, gently tilted
        dict(P0=np.array([-7.0, -5.0, 11.5]), U=np.array([14.0, 0.0, 1.6]),
             V=np.array([0.0, 10.0, 0.8])),
        # mid slab, offset left
        dict(P0=np.array([-4.6, -3.2, 8.4]), U=np.array([5.2, 0.0, -1.0]),
             V=np.array([0.3, 4.4, 0.5])),
        # near slab, offset right
        dict(P0=np.array([0.6, -2.4, 6.8]), U=np.array([3.6, 0.0, 0.9]),
             V=np.array([-0.3, 3.4, -0.4])),
    ]


def render_scene(seed: int = 0, n_cams: int = 6, width: int = 640,
                 height: int = 480, focal: float = 640.0,
                 arc_step: float = 0.055, tex_size: int = 512,
                 planes: List[dict] | None = None):
    """Render `n_cams` views of a 3-plane textured scene.

    Returns dict with:
      images  : (C, H, W) float32 in [0,1]
      poses   : (C, 6) ground-truth [angle-axis | t] (world->cam)
      centers : (C, 3) ground-truth camera centers
      focal   : float (pixels)
    """
    rng = np.random.default_rng(seed)
    if planes is None:
        planes = default_planes()
    texs = [multiscale_texture(rng, tex_size) for _ in planes]

    depth = 8.0
    K = np.array([[focal, 0.0, width / 2.0],
                  [0.0, focal, height / 2.0],
                  [0.0, 0.0, 1.0]])
    xs, ys = np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5)
    pix = np.stack([xs, ys, np.ones_like(xs)], axis=-1)  # (H, W, 3)

    images = np.zeros((n_cams, height, width), np.float32)
    poses = np.zeros((n_cams, 6), np.float64)
    centers = np.zeros((n_cams, 3), np.float64)
    for ci in range(n_cams):
        ang = (ci - (n_cams - 1) / 2.0) * arc_step
        c = np.array([np.sin(ang) * depth, 0.25 * np.sin(2.3 * ang + 0.4),
                      depth - np.cos(ang) * depth])
        target = np.array([0.0, 0.0, depth]) + rng.normal(0, 0.15, 3)
        R = _look_at(c, target)
        t = -R @ c
        aa = np_geom.matrix_to_angle_axis(R)
        poses[ci] = np.concatenate([aa, t])
        centers[ci] = c

        img = np.zeros((height, width), np.float32)
        # far -> near compositing
        order = np.argsort([-np.linalg.norm(p["P0"] + 0.5 * p["U"]
                                            + 0.5 * p["V"] - c)
                            for p in planes])
        for pi in order:
            p = planes[pi]
            A = np.stack([p["U"], p["V"], p["P0"]], axis=1)  # (3,3)
            Hm = K @ (R @ A + t[:, None] @ np.array([[0.0, 0.0, 1.0]]))
            Hinv = np.linalg.inv(Hm)
            st = pix @ Hinv.T                                # (H, W, 3)
            w = st[..., 2]
            s = st[..., 0] / np.where(np.abs(w) < 1e-12, 1e-12, w)
            tt = st[..., 1] / np.where(np.abs(w) < 1e-12, 1e-12, w)
            # camera-frame depth of the hit point (front-of-camera gate)
            X = (s[..., None] * p["U"] + tt[..., None] * p["V"] + p["P0"])
            z_cam = X @ R[2] + t[2]
            hit = ((s >= 0) & (s <= 1) & (tt >= 0) & (tt <= 1)
                   & (z_cam > 0.2))
            vals = _bilinear(texs[pi], s, tt)
            img = np.where(hit, vals, img)
        images[ci] = img
    return {"images": images, "poses": poses, "centers": centers,
            "focal": float(focal)}


def write_scene_images(fold: str, scene: dict) -> List[str]:
    """Write the rendered views as 8-bit PNGs into `fold` (what the Database
    discovery stage expects)."""
    import os

    from PIL import Image

    os.makedirs(fold, exist_ok=True)
    paths = []
    for i, img in enumerate(scene["images"]):
        p = f"{fold}/view_{i:03d}.png"
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(p)
        paths.append(p)
    return paths


def ate_vs_gt(est_centers: np.ndarray, gt_centers: np.ndarray) -> float:
    """Absolute trajectory error after similarity (Umeyama) alignment,
    normalized by the ground-truth trajectory extent."""
    import torch

    from ..ops import umeyama

    s, R, t = umeyama.similarity_align(
        torch.as_tensor(np.asarray(est_centers, np.float64)),
        torch.as_tensor(np.asarray(gt_centers, np.float64)))
    s, R, t = float(s), R.numpy(), t.numpy()
    aligned = s * est_centers @ R.T + t
    err = np.linalg.norm(aligned - gt_centers, axis=1).mean()
    extent = np.linalg.norm(gt_centers - gt_centers.mean(0), axis=1).max()
    return float(err / max(extent, 1e-9))


def stereo_pair(rng: np.random.Generator, H: int = 96, W: int = 160,
                disp_bg: float = 6.0, disp_fg: float = 16.0):
    """Rectified pair with a known piecewise-constant disparity (the scene
    of tests/test_sgm_dense.py's textured_scene, vectorized).

    The left view is uniform noise smoothed by a 3-tap box along each axis
    (zero context); the disparity is `disp_bg` with a `disp_fg` block over
    the middle third of the rows and half of the columns.  The right view
    is the left forward-warped (left pixel x lands on right pixel x - d;
    of several landing on one pixel the rightmost source wins), and holes
    take the last filled value to their left (the row's first left pixel
    before any).  Returns (left, right, disp) float32 (H, W).
    """
    tex = rng.uniform(0, 1, size=(H, W))
    for ax in (0, 1):
        p = np.pad(tex, [(1, 1) if a == ax else (0, 0) for a in range(2)])
        n = tex.shape[ax]
        tex = (np.take(p, range(0, n), ax) + np.take(p, range(1, n + 1), ax)
               + np.take(p, range(2, n + 2), ax)) / 3.0
    left = tex.astype(np.float32)
    disp = np.full((H, W), disp_bg, np.float32)
    disp[H // 3: 2 * H // 3, W // 4: 3 * W // 4] = disp_fg
    ys, xs = np.mgrid[0:H, 0:W]
    xr = xs - disp.astype(np.int64)
    ok = (xr >= 0) & (xr < W)
    src = np.full((H, W), -1, np.int64)        # source column per target
    np.maximum.at(src, (ys[ok], xr[ok]), xs[ok])
    last = np.maximum.accumulate(np.where(src >= 0, xs, -1), axis=1)
    col = np.where(last >= 0, src[ys, np.maximum(last, 0)], 0)
    right = left[ys, col]
    return left, right, disp


def write_stereo_sure(path: str, names, width: int, height: int,
                      focal: float, baseline: float):
    """SURE pose file of a rectified two-view rig: K = diag(f, f, 1),
    R = I for both, the second camera `baseline` along +x (t = -c), so
    rectification is the identity and the ground-truth disparity holds."""
    K = np.diag([focal, focal, 1.0])
    with open(path, "w") as f:
        for _ in range(8):
            f.write("#\n")
        for name, cx in zip(names, (0.0, baseline)):
            f.write(f"{name} {width} {height}\n")
            for row in K:
                f.write(" ".join(str(v) for v in row) + "\n")
            f.write("0 0 0 0 0\n")
            f.write(f"{-cx} 0.0 0.0\n")
            for row in np.eye(3):
                f.write(" ".join(str(v) for v in row) + "\n")
