"""Dense pairwise-stereo reconstruction driver.

Counterpart of metricsfm_tpu/models/dense.py (the reference's
DenseReconstruction, SfM/src/dense_reconstruction.{h,cc}): reads a
SURE-format pose file, epipolar-rectifies each consecutive pair (linear
Fusiello method: both cameras rotated onto a common frame whose x-axis is
the baseline, images warped through the induced homographies with
bilinear resampling), runs SGM (ops/sgm.stereo_sgm) or ELAS
(ops/elas.stereo_elas) stereo on the device, converts disparity -> depth
-> world points and writes depth maps, the rectified poses and the cloud.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..config import DenseOptions
from ..ops import elas as elas_ops
from ..ops import sgm as sgm_ops
from ..ops.sift import _bilinear
from ..utils.device import resolve as resolve_device
from ..utils.tracing import span


@dataclass
class DensePose:
    name: str
    K: np.ndarray        # (3,3)
    R: np.ndarray        # (3,3) world->cam
    t: np.ndarray        # (3,)
    w: int = 0
    h: int = 0


def read_sure_pose_file(path: str) -> List[DensePose]:
    """Parse the SURE-format pose file (ref ReadinPoseFile,
    dense_reconstruction.cc:70-111): 8 header lines then
    'name w h / K / k1 k2 k3 p1 p2 / t / R' per camera."""
    with open(path) as f:
        lines = f.read().splitlines()
    tok = " ".join(lines[8:]).split()
    it = iter(tok)
    out = []
    try:
        while True:
            name = next(it)
            w, h = int(next(it)), int(next(it))
            K = np.array([float(next(it)) for _ in range(9)]).reshape(3, 3)
            _dist = [float(next(it)) for _ in range(5)]
            t = np.array([float(next(it)) for _ in range(3)])
            R = np.array([float(next(it)) for _ in range(9)]).reshape(3, 3)
            out.append(DensePose(name=name, K=K, R=R, t=t, w=w, h=h))
    except StopIteration:
        pass
    return out


def rectify_pair(K1, R1, t1, K2, R2, t2):
    """Fusiello linear rectification.

    Returns (Rn, Kn, H1, H2, baseline): new shared rotation, intrinsics,
    per-image homographies (new <- old pixel maps use H^-1), baseline.
    """
    c1 = -R1.T @ t1
    c2 = -R2.T @ t2
    b = c2 - c1
    baseline = float(np.linalg.norm(b))
    x = b / max(baseline, 1e-12)
    # y = cross(old z1, x), z = cross(x, y)
    z_old = R1[2, :]
    y = np.cross(z_old, x)
    y /= max(np.linalg.norm(y), 1e-12)
    z = np.cross(x, y)
    Rn = np.stack([x, y, z])
    Kn = (K1 + K2) / 2.0
    Kn[0, 1] = 0.0
    H1 = Kn @ Rn @ R1.T @ np.linalg.inv(K1)
    H2 = Kn @ Rn @ R2.T @ np.linalg.inv(K2)
    return Rn, Kn, H1, H2, baseline


def warp_homography(img, H_inv, out_shape=None):
    """Inverse-map warp of a (H, W) float32 tensor with bilinear sampling,
    on the image's device."""
    Hh, Ww = out_shape or img.shape
    dev = img.device
    ys, xs = torch.meshgrid(torch.arange(Hh, dtype=torch.float32, device=dev),
                            torch.arange(Ww, dtype=torch.float32, device=dev),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    Hm = torch.as_tensor(np.asarray(H_inv), dtype=torch.float32, device=dev)
    src = torch.einsum("ij,hwj->hwi", Hm, pix)
    w = src[..., 2].clamp(min=1e-9)
    coords = torch.stack([src[..., 0] / w, src[..., 1] / w], dim=-1)
    return _bilinear(img.float(), coords)


class DenseReconstruction:
    """Per-consecutive-pair dense stereo (ref Run/SGMDense/ELASDense) on
    `device`."""

    def __init__(self, options: DenseOptions, device="cuda"):
        if options.method not in ("sgm", "elas"):
            raise ValueError(f"dense method {options.method!r}: expected "
                             "'sgm' or 'elas'")
        self.opts = options
        self.device = resolve_device(device)

    def run(self, fold: str, pose_file: Optional[str] = None,
            image_loader=None, verbose: bool = False):
        """fold must contain the pose file + images; image_loader(name) may
        override image reading (for tests).  Returns the per-pair world
        point clouds ((N, 3) float32 numpy)."""
        pose_file = pose_file or os.path.join(fold, "sfm_sure.txt")
        poses = read_sure_pose_file(pose_file)
        out_fold = os.path.join(fold, "dense")
        os.makedirs(out_fold, exist_ok=True)
        dev = self.device

        def load(name):
            if image_loader is not None:
                img = image_loader(name)
            else:
                from .database import load_image_gray
                img = load_image_gray(os.path.join(fold, name))[0]
            return torch.as_tensor(np.asarray(img, np.float32), device=dev)

        o = self.opts
        clouds = []
        for i in range(len(poses) - 1):
            a, b = poses[i], poses[i + 1]
            with span("dense/load_images"):
                img1 = load(a.name)
                img2 = load(b.name)
            with span("dense/rectify"):
                Rn, Kn, H1, H2, baseline = rectify_pair(
                    a.K, a.R, a.t, b.K, b.R, b.t)
                r1 = warp_homography(img1, np.linalg.inv(H1))
                r2 = warp_homography(img2, np.linalg.inv(H2))
            with span("dense/stereo", sync=True):
                if o.method == "elas":
                    ep = elas_ops.middlebury_params() \
                        if o.elas_setting == "middlebury" \
                        else elas_ops.ElasParams()
                    disp, valid = elas_ops.stereo_elas(
                        r1, r2, max_disp=o.disp_size, params=ep)
                else:
                    disp, valid = sgm_ops.stereo_sgm(
                        r1, r2, max_disp=o.disp_size, p1=o.p1, p2=o.p2,
                        uniqueness=o.uniqueness, num_paths=o.num_paths)
            depth = sgm_ops.disparity_to_depth(
                disp, float(Kn[0, 0]), baseline, o.depth_scale,
                o.depth_clamp)
            # rectified camera pose: Rn, t_n = -Rn c1
            t_n = -Rn @ (-a.R.T @ a.t)

            def dev32(m):
                return torch.as_tensor(m, dtype=torch.float32, device=dev)

            Xw, mask = sgm_ops.depth_to_points(
                depth, dev32(np.linalg.inv(Kn)), dev32(Rn), dev32(t_n),
                stride=2)
            with span("dense/exports"):
                np.save(os.path.join(out_fold, f"depth_{i}.npy"),
                        depth.cpu().numpy())
                with open(os.path.join(out_fold, f"pose_rect_{i}.txt"),
                          "w") as f:
                    for row in np.hstack([Rn, t_n[:, None]]):
                        f.write(" ".join(f"{v:.8f}" for v in row) + "\n")
                pts = Xw[mask].cpu().numpy()
            clouds.append(pts)
            if verbose:
                print(f"pair {i}: {int(valid.sum())} valid px, "
                      f"{len(pts)} points")
        if clouds:
            cloud = np.concatenate(clouds)
            with span("dense/exports"), \
                    open(os.path.join(out_fold, "dense_cloud.txt"), "w") as f:
                for p in cloud[::max(1, len(cloud) // 2_000_000)]:
                    f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")
        return clouds
