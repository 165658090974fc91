"""ELAS-style dense stereo (support points, a disparity prior, MAP).

Counterpart of metricsfm_tpu/ops/elas.py, the second dense backend beside
ops/sgm.py (the reference's CPU libelas, SfM/src/dense/libelas/: Sobel
descriptors -> support matches on a 5-px candidate grid -> a piecewise
smooth disparity prior -> per-pixel MAP disparity under a Gaussian-plus-
uniform prior -> L/R check, gap interpolation, median).  The JAX package
runs it through XLA only, so it has no kernel here: every step is plain
torch on the images' device.  Where the JAX code stacks one slice per
disparity, the port writes into a preallocated volume (`_sad_volume`) or
takes one gather (the support grid's cost, the right energy volume), with
the same values.  Semantics kept exactly: `jnp.roll` wraps and a
`col >= d` mask hides the wrapped part; argmin ties go to the first
disparity; bilinear resizes use half-pixel centres without antialiasing
(what `jax.image.resize(..., "bilinear")` does when it enlarges, which is
all it does here).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .sgm import median3
from .sgm_kernel import skew_right

_BIG = 1e9           # cost of a disparity that leaves the image


class ElasParams(NamedTuple):
    """Mirrors Elas::parameters (elas.h:47-109), ROBOTICS defaults."""
    support_threshold: float = 0.85
    support_texture: float = 10.0
    candidate_stepsize: int = 5
    incon_window_size: int = 5
    incon_threshold: float = 5.0
    incon_min_support: int = 5
    beta: float = 0.02
    gamma: float = 3.0
    sigma: float = 1.0
    match_texture: float = 1.0
    lr_threshold: float = 2.0
    ipol_gap_width: int = 3


def middlebury_params() -> ElasParams:
    """MIDDLEBURY preset (elas.h:106-131): interpolate everything."""
    return ElasParams(support_threshold=0.95, match_texture=0.0,
                      ipol_gap_width=9)


def _sobel(img):
    """3x3 Sobel responses (dx, dy) of an (H, W) image; edge-replicated
    borders so flat regions stay zero at the image boundary."""
    kx = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                      device=img.device)
    w = torch.stack([kx, kx.T])[:, None]                     # (2, 1, 3, 3)
    x = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")
    out = F.conv2d(x, w)[0]
    return out[0], out[1]


# 16 sample offsets (dy, dx) in the 5x5 neighbourhood (ref descriptor.cpp
# layout: 12 horizontal-gradient taps + 4 vertical-gradient taps).
_DX_OFFS = [(-2, 0), (-1, -1), (-1, 1), (0, -2), (0, -1), (0, 0), (0, 0),
            (0, 1), (0, 2), (1, -1), (1, 1), (2, 0)]
_DY_OFFS = [(-1, 0), (0, -1), (0, 1), (1, 0)]


def sobel_descriptor(img):
    """(H, W) [0, 1] image -> (H, W, 16) gradient descriptor, responses
    scaled to the reference's saturated-uint8 convention (sobel / 4
    clamped to [-128, 127]) so the ROBOTICS constants keep their meaning;
    zero context outside the image."""
    H, W = img.shape
    dx, dy = _sobel(img.float() * 255.0)
    pdx = F.pad((dx / 4.0).clamp(-128.0, 127.0), (2, 2, 2, 2))
    pdy = F.pad((dy / 4.0).clamp(-128.0, 127.0), (2, 2, 2, 2))
    feats = [pdx[2 + oy:2 + oy + H, 2 + ox:2 + ox + W] for oy, ox in _DX_OFFS]
    feats += [pdy[2 + oy:2 + oy + H, 2 + ox:2 + ox + W] for oy, ox in _DY_OFFS]
    return torch.stack(feats, dim=-1)


def _sad_volume(desc_l, desc_r, max_disp: int):
    """(H, W, D) sum-of-absolute-differences volume, _BIG where x < d,
    written one disparity at a time into one preallocated volume."""
    H, W, _ = desc_l.shape
    vol = torch.full((H, W, max_disp), _BIG, dtype=torch.float32,
                     device=desc_l.device)
    for d in range(min(max_disp, W)):
        vol[:, d:, d] = (desc_l[:, d:] - desc_r[:, :W - d]).abs().sum(-1)
    return vol


def support_matches(desc_l, desc_r, max_disp: int, p: ElasParams):
    """Support disparities on the candidate grid (ref
    computeSupportMatches, elas.cpp: grid matching + uniqueness + texture +
    L/R + neighbourhood vote).  Returns (sup_disp (Gy, Gx) float32,
    sup_valid (Gy, Gx) bool); the grid strides the image by
    candidate_stepsize from s // 2."""
    s = p.candidate_stepsize
    dev = desc_l.device
    gl = desc_l[s // 2::s, s // 2::s]                        # (Gy, Gx, F)
    gr = desc_r[s // 2::s, :]        # right rows at grid y, every x
    Gy, Gx, _ = gl.shape
    W = desc_l.shape[1]
    D = max_disp
    gx_cols = torch.arange(s // 2, W, s, device=dev)[:Gx]
    d_idx = torch.arange(D, device=dev)

    # cost(y, x, d) over the grid: the right column x - d, wrapped like
    # jnp.roll, masked where x < d
    src = (gx_cols[:, None] - d_idx) % W                     # (Gx, D)
    cost = (gl[:, :, None, :] - gr[:, src]).abs().sum(-1)    # (Gy, Gx, D)
    cost = cost.masked_fill(gx_cols[:, None] < d_idx, _BIG)

    best = cost.argmin(dim=-1)
    c0 = cost.amin(dim=-1)
    c1 = cost.masked_fill((d_idx - best[..., None]).abs() <= 1,
                          _BIG).amin(dim=-1)
    uniq = c0 <= p.support_threshold * c1                    # ratio gate
    texture = gl.abs().sum(-1) > p.support_texture

    # L/R check on the grid: cost_r(x, d) = cost(grid column of x + d, d)
    xr = (gx_cols[:, None] + d_idx).clamp(0, W - 1)
    xr_col = torch.div(xr - s // 2, s, rounding_mode="floor").clamp(0, Gx - 1)
    best_r = cost[:, xr_col, d_idx.expand(Gx, D)].argmin(dim=-1)
    at = torch.div(gx_cols - best - s // 2, s,
                   rounding_mode="floor").clamp(0, Gx - 1)
    dr_at = best_r.gather(1, at)
    lr_ok = (best - dr_at).abs() <= p.lr_threshold
    valid = uniq & texture & lr_ok

    # neighbourhood vote (ref incon_*): at least incon_min_support valid
    # neighbours in the window with |d - d_n| <= incon_threshold
    r = p.incon_window_size // 2
    db = best.float()
    pad_d = F.pad(db, (r, r, r, r), value=_BIG)
    pad_v = F.pad(valid, (r, r, r, r), value=False)
    votes = torch.zeros_like(db)
    for oy in range(p.incon_window_size):
        for ox in range(p.incon_window_size):
            nd = pad_d[oy:oy + Gy, ox:ox + Gx]
            nv = pad_v[oy:oy + Gy, ox:ox + Gx]
            votes += (nv & ((nd - db).abs() <= p.incon_threshold)).float()
    return db, valid & (votes >= p.incon_min_support)


def resize_bilinear(x, shape):
    """Bilinear resize of an (h, w) map to `shape` with half-pixel
    centres and no antialiasing: jax.image.resize(x, shape, "bilinear")
    when it enlarges."""
    return F.interpolate(x[None, None], size=tuple(shape), mode="bilinear",
                         align_corners=False, antialias=False)[0, 0]


def _masked_downsample(disp, valid):
    """2x2 masked mean-pool; a cell is valid if any child is."""
    Gy, Gx = disp.shape
    gy, gx = (Gy + 1) // 2 * 2, (Gx + 1) // 2 * 2
    d = F.pad(disp, (0, gx - Gx, 0, gy - Gy))
    v = F.pad(valid, (0, gx - Gx, 0, gy - Gy)).to(d.dtype)
    d = d.reshape(gy // 2, 2, gx // 2, 2)
    v = v.reshape(gy // 2, 2, gx // 2, 2)
    num = (d * v).sum(dim=(1, 3))
    den = v.sum(dim=(1, 3))
    return num / den.clamp(min=1.0), den > 0


def fill_prior(sup_disp, sup_valid, smooth_iters: int = 8):
    """Dense piecewise-smooth interpolation of sparse support disparities:
    a coarse-to-fine masked pyramid fill + Jacobi relaxation of the free
    cells (the JAX package's stand-in for the reference's Delaunay
    triangulation + per-triangle planes)."""
    levels = [(sup_disp, sup_valid)]
    d, v = sup_disp, sup_valid
    while min(d.shape) > 2:
        d, v = _masked_downsample(d, v)
        levels.append((d, v))

    # coarsest: fill unknowns with the global valid mean
    d, v = levels[-1]
    vf = v.to(d.dtype)
    mean = (d * vf).sum() / vf.sum().clamp(min=1.0)
    filled = torch.where(v, d, mean)

    for d, v in reversed(levels[:-1]):
        filled = torch.where(v, d, resize_bilinear(filled, d.shape))
        for _ in range(smooth_iters):     # periodic borders, like jnp.roll
            nb = (filled.roll(1, 0) + filled.roll(-1, 0) +
                  filled.roll(1, 1) + filled.roll(-1, 1)) / 4.0
            filled = torch.where(v, filled, nb)
    return filled


def _prior_energy(d_idx, prior, gamma: float, sigma: float):
    """-log(uniform_floor + Gaussian) prior well (ref elas.cpp MAP term:
    P(d) ~ gamma + exp(-(d - mu)^2 / (2 sigma^2)))."""
    z = (d_idx - prior[..., None]) / sigma
    return -torch.log(gamma + torch.exp(-0.5 * z * z))


def _interpolate_gaps(disp, valid, gap: int, axis: int):
    """Fill invalid runs of length <= gap where the flanking valid values
    agree within 3 px (ref gapInterpolation, elas.cpp), with the nearest
    valid value on each side found by rolls (periodic, like jnp.roll)."""
    d_lo, ok_lo = disp, valid
    d_hi, ok_hi = disp, valid
    for k in range(1, gap + 1):
        d_lo = torch.where(ok_lo, d_lo, disp.roll(k, axis))
        ok_lo = ok_lo | valid.roll(k, axis)
        d_hi = torch.where(ok_hi, d_hi, disp.roll(-k, axis))
        ok_hi = ok_hi | valid.roll(-k, axis)
    fill = ~valid & ok_lo & ok_hi & ((d_lo - d_hi).abs() <= 3.0)
    return torch.where(fill, torch.minimum(d_lo, d_hi), disp), valid | fill


def stereo_elas(left, right, max_disp: int = 128,
                params: ElasParams = ElasParams()):
    """Full ELAS pipeline on a rectified pair (API mirrors Elas::process,
    include/elas.h:142-152).

    Args:
      left, right: (H, W) float32 images in [0, 1], on one device.
    Returns:
      (disp (H, W) float32 with invalid = -1, valid (H, W) bool).
    """
    p = params
    H, W = left.shape
    D = max_disp
    desc_l = sobel_descriptor(left)
    desc_r = sobel_descriptor(right)

    sup_d, sup_v = support_matches(desc_l, desc_r, D, p)
    prior = resize_bilinear(fill_prior(sup_d, sup_v), (H, W))

    # energy = beta * SAD + prior well, built in place in the SAD volume
    energy = _sad_volume(desc_l, desc_r, D).mul_(p.beta)
    d_idx = torch.arange(D, dtype=torch.float32, device=left.device)
    energy += _prior_energy(d_idx, prior, p.gamma, p.sigma)

    best = energy.argmin(dim=-1)
    # parabolic subpixel on the energy
    bm = best.clamp(1, D - 2)[..., None]
    em, ec, ep = (energy.gather(-1, bm + o)[..., 0] for o in (-1, 0, 1))
    denom = em - 2 * ec + ep
    off = torch.where(denom.abs() > 1e-6,
                      0.5 * (em - ep) / denom.clamp(min=1e-6),
                      torch.zeros_like(denom))
    disp_l = bm[..., 0].float() + off.clamp(-1.0, 1.0)

    texture = desc_l.abs().sum(-1) > p.match_texture

    # right disparity from the same volume: energy_r(x, d) = energy(x+d, d)
    disp_r = skew_right(energy, _BIG).argmin(dim=-1).float()
    del energy

    col = torch.arange(W, device=left.device).expand(H, W)
    xr = (col - torch.round(disp_l).long()).clamp(0, W - 1)
    lr_ok = (disp_l - disp_r.gather(1, xr)).abs() <= p.lr_threshold

    valid = texture & lr_ok & (best > 0)
    disp_l, valid = _interpolate_gaps(disp_l, valid, p.ipol_gap_width, 1)
    disp_l, valid = _interpolate_gaps(disp_l, valid, p.ipol_gap_width, 0)
    disp_l = median3(disp_l)
    return torch.where(valid, disp_l, torch.full_like(disp_l, -1.0)), valid
