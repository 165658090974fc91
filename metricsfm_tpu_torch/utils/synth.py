"""Synthetic rendered-image scenes with exact ground truth, and the
synthetic large-scale BA problem.

Counterpart of the fixtures of metricsfm_tpu/utils/synth.py: a
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


def render_aerial(seed: int = 0, rows: int = 10, cols: int = 20,
                  width: int = 640, height: int = 480,
                  focal: float | None = None, altitude: float = 40.0,
                  forward_overlap: float = 0.70, side_overlap: float = 0.55,
                  tile_rel: float = 0.5, relief: float = 0.12,
                  n_waves: int = 10, near_k: int = 40, cam_chunk: int = 32,
                  device="cuda"):
    """Render a lawnmower-grid aerial survey over tiled terrain
    (counterpart of metricsfm_tpu/utils/synth.render_aerial).

    Nadir-ish cameras on a rows x cols grid with the given forward/side
    overlap look down on a ground of textured tiles at different heights
    (relief = peak height as a fraction of altitude) with small random
    tilts: non-planar, so epipolar geometry is well-conditioned, while
    covisibility stays local (each image overlaps only its grid
    neighbours, like a real survey).

    The host precompute (grid, poses, per (camera, tile) homography
    inverses and camera-depth coefficients) is the JAX package's, in f64
    numpy, so the same seed gives the same poses.  The per-pixel texture is
    procedural, a per-tile sum of `n_waves` random plane waves, so the
    shading is pure elementwise math: a loop over each camera's `near_k`
    nearest tiles on `device`, `cam_chunk` cameras at a time, in f32 (the
    JAX package runs the same loop as a lax.scan).

    Returns the same dict schema as render_scene; `centers[:, :2]` doubles
    as the UTM easting/northing for GPS-priori candidate selection
    (ref initial_matching_graph.cc:83-162).
    """
    import torch

    rng = np.random.default_rng(seed)
    if focal is None:
        focal = 1.1 * width
    # ground footprint of one image and grid spacing from overlap
    fx = altitude * width / focal
    fy = altitude * height / focal
    sx = (1.0 - forward_overlap) * fx      # along a flight line (cols)
    sy = (1.0 - side_overlap) * fy         # across flight lines (rows)
    extent_x = (cols - 1) * sx + 1.2 * fx
    extent_y = (rows - 1) * sy + 1.2 * fy
    x_min = -extent_x / 2.0
    y_min = -extent_y / 2.0

    ts = tile_rel * min(fx, fy)            # tile edge length
    nx = int(np.ceil(extent_x / ts)) + 1
    ny = int(np.ceil(extent_y / ts)) + 1
    n_tiles = nx * ny
    dz = rng.uniform(-relief, relief, n_tiles) * altitude
    tilt_u = rng.uniform(-0.08, 0.08, n_tiles) * ts
    tilt_v = rng.uniform(-0.08, 0.08, n_tiles) * ts
    ix = np.tile(np.arange(nx), ny)
    iy = np.repeat(np.arange(ny), nx)
    P0 = np.stack([x_min + ix * ts, y_min + iy * ts, altitude + dz], 1)
    U = np.stack([np.full(n_tiles, ts), np.zeros(n_tiles), tilt_u], 1)
    Vv = np.stack([np.zeros(n_tiles), np.full(n_tiles, ts), tilt_v], 1)
    tile_centers = P0 + 0.5 * U + 0.5 * Vv
    # per-tile plane-wave texture coefficients: log-spaced cycles-per-tile
    # (multi-octave), random direction/phase, 1/sqrt(f) amplitude rolloff
    fmag = np.exp(rng.uniform(np.log(1.5), np.log(60.0),
                              (n_tiles, n_waves)))
    fdir = rng.uniform(0, 2 * np.pi, (n_tiles, n_waves))
    wf1 = fmag * np.cos(fdir)
    wf2 = fmag * np.sin(fdir)
    wph = rng.uniform(0, 2 * np.pi, (n_tiles, n_waves))
    wamp = 1.0 / np.sqrt(fmag)
    wamp *= 0.42 / np.abs(wamp).sum(1, keepdims=True)

    n_cams = rows * cols
    Km = np.array([[focal, 0.0, width / 2.0],
                   [0.0, focal, height / 2.0],
                   [0.0, 0.0, 1.0]])
    poses = np.zeros((n_cams, 6), np.float64)
    centers = np.zeros((n_cams, 3), np.float64)
    Rs = np.zeros((n_cams, 3, 3))
    ci = 0
    for row in range(rows):
        # lawnmower: alternate direction per flight line
        col_order = range(cols) if row % 2 == 0 else range(cols - 1, -1, -1)
        for col in col_order:
            c = np.array([
                x_min + 0.6 * fx + col * sx + rng.normal(0, 0.02 * sx),
                y_min + 0.6 * fy + row * sy + rng.normal(0, 0.02 * sy),
                rng.normal(0, 0.01 * altitude),
            ])
            target = np.array([c[0], c[1], altitude]) \
                + rng.normal(0, 0.01 * altitude, 3) * np.array([1, 1, 0])
            R = _look_at(c, target)
            poses[ci] = np.concatenate([np_geom.matrix_to_angle_axis(R),
                                        -R @ c])
            centers[ci] = c
            Rs[ci] = R
            ci += 1

    # host precompute: per (camera, k-nearest-tile) homography inverse +
    # camera-depth affine coefficients (all 3x3 algebra in f64 here; the
    # device loop sees only per-pixel elementwise math)
    Kn = min(near_k, n_tiles)
    d2 = ((tile_centers[None, :, :2] - centers[:, None, :2]) ** 2).sum(-1)
    near = np.argsort(d2, axis=1)[:, :Kn]                  # (C, Kn)
    tvecs = -np.einsum("cij,cj->ci", Rs, centers)          # (C, 3)
    e3 = np.array([0.0, 0.0, 1.0])
    # Hm = K (R A + t e3^T), A = [U | V | P0] columns, per (camera, tile)
    An = np.stack([U[near], Vv[near], P0[near]], axis=3)   # (C, Kn, 3, 3)
    RA = np.einsum("cij,ckjl->ckil", Rs, An)
    Hm = np.einsum("ij,ckjl->ckil", Km,
                   RA + tvecs[:, None, :, None] * e3[None, None, None, :])
    Hinv = np.linalg.inv(Hm)                               # (C, Kn, 3, 3)
    r3 = Rs[:, 2, :]                                       # (C, 3)
    zu = np.einsum("ci,cki->ck", r3, U[near])
    zv = np.einsum("ci,cki->ck", r3, Vv[near])
    z0 = np.einsum("ci,cki->ck", r3, P0[near]) + tvecs[:, 2:3]

    dev = torch.device(device)

    def t32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    xpix = (torch.arange(width, dtype=torch.float32, device=dev)
            + 0.5)[None, :].expand(height, width)
    ypix = (torch.arange(height, dtype=torch.float32, device=dev)
            + 0.5)[:, None].expand(height, width)
    two_pi = 2 * np.pi

    images = np.zeros((n_cams, height, width), np.float32)
    for lo in range(0, n_cams, cam_chunk):
        sl = slice(lo, min(lo + cam_chunk, n_cams))
        hinv, zuc, zvc, z0c = (t32(a[sl]) for a in (Hinv, zu, zv, z0))
        f1, f2, amp, ph = (t32(a[near[sl]]) for a in (wf1, wf2, wamp, wph))
        B = hinv.shape[0]
        img = torch.zeros((B, height, width), dtype=torch.float32,
                          device=dev)
        bz = torch.full((B, height, width), float("inf"),
                        dtype=torch.float32, device=dev)
        for k in range(Kn):
            hi = hinv[:, k, :, :, None, None]              # (B, 3, 3, 1, 1)
            den = hi[:, 2, 0] * xpix + hi[:, 2, 1] * ypix + hi[:, 2, 2]
            den = torch.where(torch.abs(den) < 1e-12, 1e-12, den)
            s = (hi[:, 0, 0] * xpix + hi[:, 0, 1] * ypix + hi[:, 0, 2]) / den
            t = (hi[:, 1, 0] * xpix + hi[:, 1, 1] * ypix + hi[:, 1, 2]) / den
            z = (s * zuc[:, k, None, None] + t * zvc[:, k, None, None]
                 + z0c[:, k, None, None])
            hit = ((s >= 0) & (s <= 1) & (t >= 0) & (t <= 1)
                   & (z > 0.2) & (z < bz))
            val = torch.full_like(s, 0.5)
            for w in range(n_waves):
                val = val + amp[:, k, w, None, None] * torch.cos(
                    two_pi * (f1[:, k, w, None, None] * s
                              + f2[:, k, w, None, None] * t)
                    + ph[:, k, w, None, None])
            img = torch.where(hit, val, img)
            bz = torch.where(hit, z, bz)
        images[sl] = torch.clamp(img, 0.0, 1.0).cpu().numpy()
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


def synthetic_ba_problem(n_cams: int = 1024, n_pts: int = 131072,
                         max_views: int = 6, seed: int = 0,
                         noise_pose: float = 0.01, noise_pt: float = 0.05,
                         focal: float = 1000.0, *, device="cuda"):
    """Large-scale synthetic BAProblem (the BASELINE 1k-camera shape), on
    `device`.

    Cameras sweep an arc over a point cloud; each point is observed by a
    window of `max_views` consecutive cameras (bounded per-camera slot
    counts, the realistic sparsity of a survey).  Observations are exact
    projections of the ground truth; poses and points are returned
    perturbed.  Camera 0 is fixed and the intrinsics are held constant.
    Host numpy from `np.random.default_rng(seed)`: the same draws as the
    JAX package's synthetic_ba_problem.
    """
    from ..ba import problem as ba_problem
    from . import device as device_util

    dev = device_util.resolve(device)
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-40, 40, size=(n_pts, 3))
    pts[:, 2] += 80.0
    poses = np.zeros((n_cams, 6))
    for i in range(n_cams):
        ang = (i - n_cams / 2) * (2.0 / n_cams)
        c = np.array([np.sin(ang) * 80.0, 2.0 * np.sin(2 * ang),
                      80.0 - np.cos(ang) * 80.0])
        z = np.array([0.0, 0.0, 80.0]) + rng.normal(0, 3.0, 3) - c
        z /= np.linalg.norm(z)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        R = np.stack([x, np.cross(z, x), z])
        poses[i] = np.concatenate([np_geom.matrix_to_angle_axis(R), -R @ c])
    intrs = np.tile(np.array([[focal, 0.0, 0.0]]), (n_cams, 1))

    track_cam = ((rng.integers(0, n_cams, size=n_pts)[:, None]
                  + np.arange(max_views)[None, :]) % n_cams).astype(np.int32)
    camf = track_cam.reshape(-1)
    # exact pinhole projection, host numpy
    Rts = [np_geom.pose_to_Rt(p) for p in poses]
    Rs = np.stack([R for R, _ in Rts])
    ts = np.stack([t for _, t in Rts])
    Xc = (np.einsum("nij,nj->ni", Rs[camf],
                    np.repeat(pts, max_views, axis=0)) + ts[camf])
    zc = np.where(np.abs(Xc[:, 2]) < 1e-9, 1e-9, Xc[:, 2])
    track_uv = (focal * Xc[:, :2] / zc[:, None]).reshape(
        n_pts, max_views, 2)
    pose_mut = np.ones((n_cams,))
    pose_mut[0] = 0.0
    return ba_problem.build_problem(
        poses + rng.normal(0, noise_pose, poses.shape), intrs,
        np.arange(n_cams), pts + rng.normal(0, noise_pt, pts.shape),
        track_cam, track_uv, np.ones((n_pts, max_views), bool),
        pose_mut=pose_mut, intr_mut=np.zeros((n_cams,)), device=dev)


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
