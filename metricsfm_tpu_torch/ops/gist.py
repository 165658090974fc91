"""GIST global image descriptor (optional capability).

Counterpart of metricsfm_tpu/ops/gist.py (re-design of
SfM/src/utils/gist.{hpp,cpp}: 4 scales x 8 orientations Gabor bank averaged
over a 4x4 grid; used when DatabaseOptions.extract_gist,
database.cc:335-348), as frequency-domain Gabor filtering with torch.fft.
"""
from __future__ import annotations

import math

import torch


def _gabor_bank(H, W, n_scales, n_orients, device):
    """Frequency-domain Gabor transfer functions (n_scales * n_orients, H,
    W), scale-major."""
    fy = torch.fft.fftfreq(H, device=device)[:, None]
    fx = torch.fft.fftfreq(W, device=device)[None, :]
    rad = torch.sqrt(fx * fx + fy * fy)
    ang = torch.atan2(fy, fx)
    f0 = torch.tensor([0.25 / (2 ** s) for s in range(n_scales)],
                      device=device)[:, None, None, None]
    th = torch.tensor([math.pi * o / n_orients for o in range(n_orients)],
                      device=device)[None, :, None, None]
    x = ang - th
    dang = torch.atan2(torch.sin(x), torch.cos(x))        # wrap to (-pi, pi]
    g = torch.exp(-10.0 * (rad / f0 - 1.0) ** 2
                  - 2.0 * dang * dang * n_orients / math.pi)
    return g.reshape(n_scales * n_orients, H, W)


def gist_descriptor(img, n_scales: int = 4, n_orients: int = 8,
                    grid: int = 4):
    """(H, W) image -> (n_scales * n_orients * grid * grid,) GIST vector,
    L2-normalized."""
    H, W = img.shape
    img = img.to(torch.float32)
    img = (img - torch.mean(img)) / torch.clamp(
        torch.std(img, correction=0), min=1e-6)
    F = torch.fft.fft2(img)
    bank = _gabor_bank(H, W, n_scales, n_orients, img.device)
    resp = torch.abs(torch.fft.ifft2(F[None] * bank))    # (nf, H, W)
    # average-pool over a grid x grid partition
    gh, gw = H // grid, W // grid
    resp = resp[:, :gh * grid, :gw * grid]
    pooled = resp.reshape(resp.shape[0], grid, gh, grid, gw).mean(dim=(2, 4))
    v = pooled.reshape(-1)
    return v / torch.clamp(torch.linalg.norm(v), min=1e-12)
