"""Panorama feature extraction: equirectangular -> per-zone pinhole views.

Counterpart of metricsfm_tpu/ops/panorama.py (re-design of
SfM/src/feature/feature_extractor_panorama.{h,cc}): the reference
reprojects an equirectangular panorama into 12 overlapping zones (fov 30
deg, f = 600, bilinear resample) and runs SIFT on each; each zone's
features carry its yaw so matching works in a common frame.
"""
from __future__ import annotations

import math

import torch

from ..utils import device as device_util
from . import sift as sift_ops


def zone_to_pano_coords(zone_yaw: float, f: float, out_w: int, out_h: int,
                        pano_w: int, pano_h: int, *, device="cuda"):
    """Pixel grid of one pinhole zone -> (out_h, out_w, 2) (x, y) coords in
    the panorama, built on `device`."""
    dev = device_util.resolve(device)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev) - out_w / 2.0
    ys = torch.arange(out_h, dtype=torch.float32, device=dev) - out_h / 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    # pinhole ray (x, y, f) rotated by yaw about the vertical axis
    lon = torch.atan2(gx, torch.full_like(gx, f)) + zone_yaw
    lat = torch.atan2(gy, torch.sqrt(gx * gx + f * f))
    px = torch.remainder(lon / (2 * math.pi) + 0.5, 1.0) * pano_w
    py = (lat / math.pi + 0.5) * pano_h
    return torch.stack([px, py], dim=-1)


def extract_panorama(pano, n_zones: int = 12, fov_deg: float = 30.0,
                     f: float = 600.0, cfg: sift_ops.SiftConfig = None):
    """SIFT over per-zone reprojections of an equirectangular (H, W) image,
    on the image's device.

    Returns a list of per-zone dicts (sift.extract outputs + 'yaw'), with
    keypoint xy in zone-centered coords.
    """
    cfg = cfg or sift_ops.SiftConfig(n_octaves=3, max_keypoints=1024)
    H, W = pano.shape
    out_w = int(2 * f * math.tan(math.radians(fov_deg) / 2.0)) or 128
    out_h = min(int(out_w * 3), H)
    pano = pano.to(torch.float32)
    outs = []
    for z in range(n_zones):
        yaw = 2 * math.pi * z / n_zones
        coords = zone_to_pano_coords(yaw, f, out_w, out_h, W, H,
                                     device=pano.device)
        feats = dict(sift_ops.extract(sift_ops._bilinear(pano, coords), cfg))
        feats["yaw"] = yaw
        outs.append(feats)
    return outs
