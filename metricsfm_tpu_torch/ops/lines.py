"""Line-segment detection utilities (LSD-style) + Hough transform.

Counterpart of metricsfm_tpu/ops/lines.py (re-design of the reference's
line utilities, SfM/src/utils/lsd.{h,cc}, houghlines.{h,cpp},
local_orientation.{h,cc}: linked-in capability for line-feature work,
unused in the default pipelines): gradient orientation field, level-line
support masks, and a Hough accumulator filled by scatter-add voting.
"""
from __future__ import annotations

import math

import torch


def _linspace(start, stop, num, endpoint, like):
    """jnp.linspace's grid in the dtype of `like`, evaluated as XLA
    evaluates it: start (1 - i r) + i (stop r) with r = 1 / div rounded to
    that dtype (the endpoint, if any, is stop itself), so the grids are
    bit-equal."""
    div = num - 1 if endpoint else num
    kw = dict(dtype=like.dtype, device=like.device)
    i = torch.arange(num, **kw)
    r = torch.tensor(1.0 / div, **kw)
    start = torch.as_tensor(start, **kw)
    stop = torch.as_tensor(stop, **kw)
    out = start * (1.0 - i * r) + i * (stop * r)
    if endpoint:
        out[-1] = stop
    return out


def gradient_field(img):
    """Image gradients + magnitude + level-line angle (LSD convention:
    angle of the level line = gradient angle + pi/2)."""
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    mag = torch.sqrt(gx * gx + gy * gy)
    angle = torch.atan2(gy, gx)
    return gx, gy, mag, angle


def _pixel_grid(H, W, device):
    ys = torch.arange(H, dtype=torch.float32, device=device)[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=device)[None, :]
    return ys.expand(H, W), xs.expand(H, W)


def hough_lines(edge_mask, weights=None, n_theta: int = 180,
                n_rho: int = 256):
    """Weighted Hough accumulator over (theta, rho).

    Every edge pixel votes into the two rho bins around its line distance
    with linear-interpolation weights (houghlines.cpp's scatter voting);
    the upper bin is clipped to n_rho - 1.  Votes are summed in f64 and
    rounded to f32 once, so the accumulator does not depend on the order
    in which the adds land.
    Returns (acc (n_theta, n_rho), thetas, rhos).
    """
    H, W = edge_mask.shape
    dev = edge_mask.device
    ys, xs = _pixel_grid(H, W, dev)
    w = edge_mask.to(torch.float32)
    if weights is not None:
        w = w * weights
    diag = float(torch.sqrt(torch.tensor(float(H * H + W * W))))
    thetas = _linspace(0.0, math.pi, n_theta, False, w)
    rhos = _linspace(-diag, diag, n_rho, True, w)

    # only pixels with a nonzero vote change the sums
    sel = torch.nonzero(w.reshape(-1)).reshape(-1)
    x = xs.reshape(-1)[sel]
    y = ys.reshape(-1)[sel]
    wf = w.reshape(-1)[sel]
    rho = x[None, :] * torch.cos(thetas)[:, None] \
        + y[None, :] * torch.sin(thetas)[:, None]                # (T, E)
    idx = (rho + diag) / (2 * diag) * (n_rho - 1)
    i0 = torch.clamp(torch.floor(idx).to(torch.int64), 0, n_rho - 1)
    frac = idx - i0
    i1 = torch.clamp(i0 + 1, 0, n_rho - 1)
    base = torch.arange(n_theta, device=dev)[:, None] * n_rho
    acc = torch.zeros(n_theta * n_rho, dtype=torch.float64, device=dev)
    acc.index_add_(0, (base + i0).reshape(-1),
                   (wf * (1 - frac)).reshape(-1).to(torch.float64))
    acc.index_add_(0, (base + i1).reshape(-1),
                   (wf * frac).reshape(-1).to(torch.float64))
    return acc.to(torch.float32).reshape(n_theta, n_rho), thetas, rhos


def _top_peaks(acc, k):
    """The k largest accumulator cells, ties to the lowest flat index (as
    lax.top_k orders them).  Returns (votes (k,), flat index (k,))."""
    flat = acc.reshape(-1)
    order = torch.sort(flat, descending=True, stable=True).indices[:k]
    return flat[order], order


def detect_lines(img, mag_thresh: float = 0.05, max_lines: int = 32,
                 n_theta: int = 180, n_rho: int = 256):
    """Dominant lines of an image: gradient-magnitude edges -> Hough peaks.

    Returns dict: theta (L,), rho (L,), score (L,) sorted by vote weight.
    """
    _, _, mag, _ = gradient_field(img)
    edges = mag > mag_thresh
    acc, thetas, rhos = hough_lines(edges, weights=mag, n_theta=n_theta,
                                    n_rho=n_rho)
    top, idx = _top_peaks(acc, max_lines)
    return {"theta": thetas[idx // n_rho], "rho": rhos[idx % n_rho],
            "score": top}


def detect_segments(img, mag_thresh: float = 0.05, angle_tol: float = 0.3927,
                    band_px: float = 2.0, density_th: float = 0.3,
                    max_segments: int = 32, n_theta: int = 180,
                    n_rho: int = 256):
    """LSD-style line-SEGMENT detection, densely (ref utils/lsd.cc
    LineSegmentDetection: aligned support + density bound Hough peaks to
    finite extents).

    For each Hough peak (all peaks in one batched pass): pixels within
    `band_px` of the line whose level-line angle agrees with the line
    direction within `angle_tol` form the support; the segment spans the
    extreme projections of the support along the line, gated by support
    density.
    Returns dict: p0 (L, 2), p1 (L, 2) endpoint xy, score (L,),
    ok (L,) density gate.
    """
    H, W = img.shape
    _, _, mag, angle = gradient_field(img)
    edges = mag > mag_thresh
    acc, thetas, rhos = hough_lines(edges, weights=mag, n_theta=n_theta,
                                    n_rho=n_rho)
    score, idx = _top_peaks(acc, max_segments)
    th = thetas[idx // n_rho][:, None, None]
    r = rhos[idx % n_rho][:, None, None]

    ys, xs = _pixel_grid(H, W, img.device)
    level = angle + math.pi / 2.0
    nx, ny = torch.cos(th), torch.sin(th)                 # line normal
    d = xs * nx + ys * ny - r                             # signed distance
    # the level-line angle must align with the line DIRECTION (normal + 90)
    ddir = level - (th + math.pi / 2.0)
    sin_tol = torch.sin(torch.tensor(angle_tol, dtype=torch.float32))
    aligned = torch.abs(torch.sin(ddir)) < sin_tol.to(img.device)
    support = (torch.abs(d) < band_px) & aligned & edges    # (L, H, W)
    proj = -xs * ny + ys * nx                             # along-line coord
    cnt = torch.sum(support, dim=(1, 2)).to(torch.float32)
    lo = torch.where(support, proj, torch.inf).amin(dim=(1, 2))
    hi = torch.where(support, proj, -torch.inf).amax(dim=(1, 2))
    length = torch.clamp(hi - lo, min=1e-6)
    nx, ny, r = nx[:, 0, 0], ny[:, 0, 0], r[:, 0, 0]
    dirv = torch.stack([-ny, nx], dim=-1)
    base = r[:, None] * torch.stack([nx, ny], dim=-1)
    p0 = base + lo[:, None] * dirv
    p1 = base + hi[:, None] * dirv
    # density gate: aligned support per unit length within the band
    ok = (cnt / (length * 2.0 * band_px)) > density_th
    ok = ok & (cnt > 8) & torch.isfinite(lo) & torch.isfinite(hi)
    return {"p0": p0, "p1": p1, "score": score, "ok": ok}


def local_orientation(img, pts, win_half: int = 20, sigma_i: float = 0.1):
    """Dominant local gradient direction per point (ref
    utils/local_orientation.cc LocalOrientation::CalOrientation).

    A (2w, 2w) window around each point (origin truncated toward zero and
    clipped into the image) is gathered for all points at once; the
    reference's region growing is relaxed to a soft weight
    exp(-(I - I_seed)^2 / (2 sigma_i^2)) and (dx, dy) is the weighted
    gradient mean, normalized.
    img (H, W) float in [0, 1]; pts (N, 2) float xy.
    Returns (N, 2) unit (dx, dy); zero rows where the window is flat.
    """
    gx, gy, _, _ = gradient_field(img)
    H, W = img.shape
    w = 2 * win_half
    pts = pts.to(torch.float32)
    x0 = torch.clamp(pts[:, 0].to(torch.int32) - win_half, 0, W - w)
    y0 = torch.clamp(pts[:, 1].to(torch.int32) - win_half, 0, H - w)
    offs = torch.arange(w, device=img.device)
    rows = (y0[:, None] + offs)[:, :, None].long()        # (N, w, 1)
    cols = (x0[:, None] + offs)[:, None, :].long()        # (N, 1, w)
    win_i = img[rows, cols]                               # (N, w, w)
    seed = win_i[:, win_half, win_half]
    wgt = torch.exp(-((win_i - seed[:, None, None]) ** 2)
                    / (2.0 * sigma_i ** 2))
    dx = torch.sum(wgt * gx[rows, cols], dim=(1, 2))
    dy = torch.sum(wgt * gy[rows, cols], dim=(1, 2))
    nrm = torch.sqrt(dx * dx + dy * dy)
    scale = torch.where(nrm > 1e-8, 1.0 / torch.clamp(nrm, min=1e-8), 0.0)
    return torch.stack([dx, dy], dim=-1) * scale[:, None]


def line_support_regions(img, angle_tol: float = 0.3927,
                         mag_thresh: float = 0.05):
    """LSD-style aligned-pixel mask per quantized level-line orientation.

    Returns (8, H, W) boolean masks of pixels whose level-line angle agrees
    with the bin center within angle_tol (22.5 deg default), the angle
    difference wrapped to (-pi, pi].
    """
    _, _, mag, angle = gradient_field(img)
    level = angle + math.pi / 2.0
    centers = _linspace(-math.pi, math.pi, 8, False, img)[:, None, None]
    x = level - centers
    d = torch.atan2(torch.sin(x), torch.cos(x))
    return (torch.abs(d) < angle_tol) & (mag > mag_thresh)
