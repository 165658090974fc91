"""Semi-global matching dense stereo.

Counterpart of metricsfm_tpu/ops/sgm.py (the reference's libSGM backend,
SfM/src/dense/cudasgm/: 9x7 census -> 8-path aggregation (P1=10, P2=120)
-> winner-takes-all with uniqueness 0.96 -> 3x3 median -> L/R check).

Two paths, each through the kernels of ops/sgm_kernel (their plain
versions on a CPU tensor; on a CUDA tensor a kernel or an error):

* `stereo_sgm` follows the JAX package's fused accelerator branch
  (metricsfm_tpu/ops/sgm.py:350-369) on every device, and `cli dense`
  runs it: census + cost volume (2c), the three aggregation stages (2d,
  2e) and the fused left/right WTA (2f), then the per-pixel tail
  (uniqueness, subpixel, median, L/R check) in torch on the WTA maps.  The
  right disparity is the integer WTA of cost_r(x, d) = total(x + d, d).
* `stereo_sgm_volume` follows the JAX package's volume branch
  (metricsfm_tpu/ops/sgm.py:370-394, the one it runs off the TPU): 2c,
  then `aggregate_paths` (2d -> 2e -> 2g) writes the summed volume, and
  `winner_takes_all` (2h) runs on it and on the skewed right volume, each
  with subpixel.  The subpixel right disparity changes the L/R check
  against the fused path on a small share of pixels only.
"""
from __future__ import annotations

import torch

from . import sgm_kernel
from .sgm_kernel import census_transform, matching_cost_volume  # noqa: F401


def aggregate_paths(cost, p1: int = 10, p2: int = 120, num_paths: int = 8):
    """Sum of 4 or 8 directional aggregations over an (H, W, D) uint8 cost
    volume -> (H, W, D) int16, through kernels 2d -> 2e -> 2g (penalties
    are truncated to integers like the reference's)."""
    p1, p2 = int(p1), int(p2)
    h = sgm_kernel.sgm_horizontal(cost, p1, p2)
    part = sgm_kernel.sgm_partial(cost, h, p1, p2, num_paths)
    # at most two int16 volumes live at once, beside the cost; while 2e or
    # 2g runs, also its two single-path scratch volumes of the diagonals
    # (uint8 for P2 <= 191, int16 above; 8 paths only)
    del h
    return sgm_kernel.sgm_total(cost, part, p1, p2, num_paths)


def _disp_from_wta(w, max_disp: int, uniqueness: float, subpixel: bool):
    """Per-pixel WTA tail on the (H, W) maps of the fused kernel: the
    uniqueness test and the parabolic subpixel offset."""
    c0 = w["c0"].float()
    c1 = w["c1"].float()
    best = w["best"]
    valid = c0 <= uniqueness * c1
    if subpixel:
        bm = best.clamp(1, max_disp - 2)
        cm, cc, cp = (w[k].float() for k in ("cm", "cc", "cp"))
        denom = cm - 2 * cc + cp
        # the parabola only where its curvature is positive (a clipped best
        # at 0 / D-1 can make denom <= 0)
        pos = denom > 1e-6
        off = torch.where(pos, 0.5 * (cm - cp) / torch.where(
            pos, denom, torch.ones_like(denom)), torch.zeros_like(denom))
        disp = bm.float() + off.clamp(-1.0, 1.0)
        disp = torch.where(best == 0, torch.zeros_like(disp), disp)
    else:
        disp = best.float()
    return disp, valid


def winner_takes_all(agg, uniqueness: float = 0.96, subpixel: bool = True):
    """argmin + uniqueness test + parabolic subpixel over a full (H, W, D)
    int16, int32 or float32 volume, through kernel 2h (the second best is
    at least 2 disparities away and capped at 30000 for an integer volume,
    1e9 for a float one).  Returns (disp (H, W) float32, valid (H, W)
    bool)."""
    big = 1e9 if agg.is_floating_point() else 30000
    w = sgm_kernel.wta(agg, big)
    return _disp_from_wta(w, agg.shape[-1], uniqueness, subpixel)


def median3(x):
    """3x3 median filter, edge-padded (ref median_filter.cu)."""
    H, W = x.shape
    pad = torch.nn.functional.pad(x[None, None], (1, 1, 1, 1),
                                  mode="replicate")[0, 0]
    stack = torch.stack([pad[dy:dy + H, dx:dx + W]
                         for dy in range(3) for dx in range(3)], dim=-1)
    return torch.sort(stack, dim=-1).values[..., 4]


def lr_consistency(disp_l, disp_r, max_diff: float = 1.0):
    """Left/right check (ref check_consistency.cu): valid where
    |dL(x) - dR(x - dL(x))| <= max_diff, x - dL rounded half to even."""
    H, W = disp_l.shape
    x = torch.arange(W, device=disp_l.device).expand(H, W)
    xr = (x - torch.round(disp_l).long()).clamp(0, W - 1)
    dr = disp_r.gather(1, xr)
    return (disp_l - dr).abs() <= max_diff


def stereo_sgm(left, right, max_disp: int = 128, p1: int = 10,
               p2: int = 120, uniqueness: float = 0.96,
               num_paths: int = 8, subpixel: bool = True):
    """Full SGM on a rectified pair (public API mirrors
    sgm::StereoSGM::execute, dense/cudasgm/include/libsgm.h).

    Args:
      left, right: (H, W) float32 images in [0, 1], on one device.
      p1, p2: integer SGM penalties (non-integers are truncated).
    Returns:
      (disp (H, W) float32 with invalid = -1, valid (H, W) bool).
    """
    p1, p2 = int(p1), int(p2)
    D = max_disp
    left = left.float().contiguous()
    right = right.float().contiguous()
    cost = sgm_kernel.census_cost(left, right, D)
    hsum = sgm_kernel.sgm_horizontal(cost, p1, p2)
    part = sgm_kernel.sgm_partial(cost, hsum, p1, p2, num_paths)
    # at most two int16 volumes live at once, beside the cost; while 2e or
    # 2f runs, also its two single-path scratch volumes of the diagonals
    # (uint8 for P2 <= 191, int16 above; 8 paths only), and while 2f runs
    # its nine (H, W) int32 WTA maps
    del hsum
    wta_l, wta_r = sgm_kernel.sgm_total_wta(cost, part, p1, p2, num_paths)
    del cost, part
    return disparity_from_wta(wta_l, wta_r, D, uniqueness, subpixel)


def stereo_sgm_volume(left, right, max_disp: int = 128, p1: int = 10,
                      p2: int = 120, uniqueness: float = 0.96,
                      num_paths: int = 8, subpixel: bool = True):
    """SGM through the summed volume: the JAX package's volume branch of
    stereo_sgm.  Same arguments and result as `stereo_sgm`; the right
    disparity is the subpixel WTA of the skewed volume
    cost_r(x, d) = agg(x + d, d), 30000 where x + d >= W."""
    p1, p2 = int(p1), int(p2)
    cost = sgm_kernel.census_cost(left.float().contiguous(),
                                  right.float().contiguous(), max_disp)
    agg = aggregate_paths(cost, p1, p2, num_paths)
    del cost
    disp_l, uniq_l = winner_takes_all(agg, uniqueness, subpixel)
    cost_r = sgm_kernel.skew_right(agg, 30000)
    del agg
    disp_r, _ = winner_takes_all(cost_r, uniqueness, subpixel)
    return _median_lr(disp_l, uniq_l, disp_r)


def disparity_from_wta(wta_l, wta_r, max_disp: int, uniqueness: float = 0.96,
                       subpixel: bool = True):
    """The per-pixel tail of stereo_sgm on the fused WTA maps: uniqueness,
    subpixel, 3x3 medians and the L/R check.  Returns (disp with invalid =
    -1, valid)."""
    disp_l, uniq_l = _disp_from_wta(wta_l, max_disp, uniqueness, subpixel)
    # the right disparity is integer (libsgm semantics): it only feeds the
    # <= 1 px L/R check
    disp_r, _ = _disp_from_wta(wta_r, max_disp, uniqueness, False)
    return _median_lr(disp_l, uniq_l, disp_r)


def _median_lr(disp_l, uniq_l, disp_r):
    """3x3 medians of both disparities, then the L/R check; returns (disp
    with invalid = -1, valid)."""
    disp_l = median3(disp_l)
    valid = uniq_l & lr_consistency(disp_l, median3(disp_r))
    return torch.where(valid, disp_l, torch.full_like(disp_l, -1.0)), valid


def disparity_to_depth(disp, focal: float, baseline: float,
                       scale: float = 20.0, clamp: float = 600.0):
    """depth = scale * f * B / d, clamped (ref dense_reconstruction.cc:243-263)."""
    d = disp.clamp(min=1e-6)
    depth = (scale * focal * baseline / d).clamp(max=clamp)
    return torch.where(disp > 0, depth, torch.zeros_like(depth))


def depth_to_points(depth, K_inv, R, t, stride: int = 1):
    """Depth map -> world points Xw = R^T (Xc - t)
    (ref Depth2Points, dense_reconstruction.cc:364-453).  K_inv, R: (3, 3),
    t: (3,) float32 tensors on depth's device."""
    H, W = depth.shape
    dev = depth.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    xs, ys = xs[::stride, ::stride], ys[::stride, ::stride]
    z = depth[::stride, ::stride]
    pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    rays = torch.einsum("ij,hwj->hwi", K_inv, pix)
    Xc = rays * z[..., None]
    Xw = torch.einsum("ji,hwj->hwi", R, Xc - t)
    return Xw, z > 0
