"""SIFT detection + description as dense masked tensor code, image-batched.

Counterpart of metricsfm_tpu/ops/sift.py (the reference extractors
SfM/src/feature/feature_extractor_vl_sift.cpp — vlfeat, 4 octaves x 5
levels, edge_thresh 10 — and feature_extractor_cuda_sift.cpp), with a
leading image-batch axis in place of jit(vmap):

* Gaussian pyramid: separable conv2d with replicate padding.
* DoG extrema: 3x3x3 max/min pools over the whole volume; a fixed
  per-octave budget via top-k of the response.
* 3D quadratic subpixel/scale refinement (vlfeat semantics): one (K, 27)
  neighbourhood gather + a closed-form 3x3 solve, offsets clamped to +-1.
* Orientation + descriptor from integer-aligned (P, P) gradient patches at
  each keypoint's own level; every patch pixel contributes with tent
  (orientation) / trilinear (descriptor) weights.  The histograms are the
  JAX package's batched products of the pixels with their dense (pixels x
  bins) tent weights: cuBLAS sums them in a fixed order, so two runs give
  the same bits (a scatter-add of the two nonzero weights, the earlier
  form, summed through atomics in a varying order on the card).
* Up to 2 orientation slots per detection (vlfeat 80%-peak rule).

Output coordinates are centered at the principal point (w/2, h/2), the
reference convention (database.cc:522-527).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class SiftConfig(NamedTuple):
    n_octaves: int = 4
    n_scales: int = 3           # intervals per octave (ref: 5 DoG levels)
    sigma0: float = 1.6
    peak_thresh: float = 0.5 / 255.0  # DoG response gate
    edge_thresh: float = 10.0   # Hessian edge ratio (ref edge_thresh=10)
    max_keypoints: int = 2048   # fixed budget (ref cap 60000)
    desc_width: int = 4         # 4x4 spatial bins
    desc_bins: int = 8          # 8 orientation bins
    desc_mag: float = 3.0       # spatial bin size in units of sigma
    clip: float = 0.2           # descriptor clipping before renorm
    patch: int = 48             # gradient patch side (desc + orientation)
    n_orientations: int = 2     # max orientations per keypoint
    ori_peak_frac: float = 0.8  # 80%-peak rule (vlfeat)


def _gauss_kernel1d(sigma, radius, device):
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _blur(img, sigma):
    """Separable Gaussian blur of (B, H, W) images, edge-replicated."""
    radius = max(1, int(math.ceil(3.0 * float(sigma))))
    k = _gauss_kernel1d(sigma, radius, img.device)
    x = F.pad(img[:, None], (0, 0, radius, radius), mode="replicate")
    x = F.conv2d(x, k.view(1, 1, -1, 1))
    x = F.pad(x, (radius, radius, 0, 0), mode="replicate")
    x = F.conv2d(x, k.view(1, 1, 1, -1))
    return x[:, 0]


def gaussian_pyramid(img, cfg: SiftConfig):
    """List (per octave) of (B, S+3, H_o, W_o) Gaussian stacks."""
    S = cfg.n_scales
    k = 2.0 ** (1.0 / S)
    cur = _blur(img, cfg.sigma0)
    octaves = []
    for _ in range(cfg.n_octaves):
        levels = [cur]
        sigma_prev = cfg.sigma0
        for s in range(1, S + 3):
            sigma_total = cfg.sigma0 * (k ** s)
            sigma_extra = math.sqrt(max(sigma_total ** 2 - sigma_prev ** 2,
                                        0.01))
            levels.append(_blur(levels[-1], sigma_extra))
            sigma_prev = sigma_total
        stack = torch.stack(levels, dim=1)
        octaves.append(stack)
        # next octave seeds from level S (sigma doubled), downsample 2x
        cur = stack[:, S, ::2, ::2]
    return octaves


def _dog_extrema_response(dog):
    """(B, L, H, W) DoG -> (|dog|, strict 26-neighbourhood extremum on an
    interior level)."""
    mx = F.max_pool3d(dog[:, None], 3, stride=1, padding=1)[:, 0]
    mn = -F.max_pool3d(-dog[:, None], 3, stride=1, padding=1)[:, 0]
    is_ext = (dog >= mx - 1e-12) | (dog <= mn + 1e-12)
    L = dog.shape[1]
    lvl = torch.arange(L, device=dog.device)[:, None, None]
    interior = (lvl >= 1) & (lvl <= L - 2)
    return torch.abs(dog), is_ext & interior


def _edge_mask(dog, edge_thresh):
    """Hessian edge-response rejection (trace^2/det < (r+1)^2/r)."""
    c = dog[..., 1:-1, 1:-1]
    dxx = dog[..., 1:-1, 2:] + dog[..., 1:-1, :-2] - 2 * c
    dyy = dog[..., 2:, 1:-1] + dog[..., :-2, 1:-1] - 2 * c
    dxy = 0.25 * (dog[..., 2:, 2:] - dog[..., 2:, :-2] - dog[..., :-2, 2:]
                  + dog[..., :-2, :-2])
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_thresh
    ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)
    return F.pad(ok, (1, 1, 1, 1))


def _refine_extrema(dog, lvl, y, x):
    """3D quadratic subpixel/scale refinement at (lvl, y, x), all (B, K).

    Gathers the 27-neighbourhood, solves H d = -g in closed form
    (adjugate), clamps the offset to [-1, 1] per axis.  Returns
    (dx, dy, ds, refined response)."""
    B, L, H, W = dog.shape
    flat = dog.reshape(B, -1)
    base = (lvl * H + y) * W + x                                 # (B, K)
    d = torch.arange(-1, 2, device=dog.device)
    offs = ((d[:, None, None] * H + d[None, :, None]) * W
            + d[None, None, :]).reshape(27)                      # (l, y, x)
    gi = torch.clamp(base[..., None] + offs, 0, flat.shape[1] - 1)
    n = torch.gather(flat, 1, gi.reshape(B, -1)).reshape(*base.shape, 3, 3, 3)

    c = n[..., 1, 1, 1]
    gs = 0.5 * (n[..., 2, 1, 1] - n[..., 0, 1, 1])
    gy = 0.5 * (n[..., 1, 2, 1] - n[..., 1, 0, 1])
    gx = 0.5 * (n[..., 1, 1, 2] - n[..., 1, 1, 0])
    Hss = n[..., 2, 1, 1] + n[..., 0, 1, 1] - 2 * c
    Hyy = n[..., 1, 2, 1] + n[..., 1, 0, 1] - 2 * c
    Hxx = n[..., 1, 1, 2] + n[..., 1, 1, 0] - 2 * c
    Hsy = 0.25 * (n[..., 2, 2, 1] - n[..., 2, 0, 1] - n[..., 0, 2, 1]
                  + n[..., 0, 0, 1])
    Hsx = 0.25 * (n[..., 2, 1, 2] - n[..., 2, 1, 0] - n[..., 0, 1, 2]
                  + n[..., 0, 1, 0])
    Hyx = 0.25 * (n[..., 1, 2, 2] - n[..., 1, 2, 0] - n[..., 1, 0, 2]
                  + n[..., 1, 0, 0])

    det = (Hxx * (Hyy * Hss - Hsy * Hsy)
           - Hyx * (Hyx * Hss - Hsy * Hsx)
           + Hsx * (Hyx * Hsy - Hyy * Hsx))
    a00 = Hyy * Hss - Hsy * Hsy
    a01 = Hsx * Hsy - Hyx * Hss
    a02 = Hyx * Hsy - Hsx * Hyy
    a11 = Hxx * Hss - Hsx * Hsx
    a12 = Hsx * Hyx - Hxx * Hsy
    a22 = Hxx * Hyy - Hyx * Hyx
    ok = torch.abs(det) > 1e-12
    safe = torch.where(ok, det, 1.0)
    dx = -(a00 * gx + a01 * gy + a02 * gs) / safe
    dy = -(a01 * gx + a11 * gy + a12 * gs) / safe
    ds = -(a02 * gx + a12 * gy + a22 * gs) / safe
    dx = torch.where(ok, torch.clamp(dx, -1.0, 1.0), 0.0)
    dy = torch.where(ok, torch.clamp(dy, -1.0, 1.0), 0.0)
    ds = torch.where(ok, torch.clamp(ds, -1.0, 1.0), 0.0)
    resp = c + 0.5 * (gx * dx + gy * dy + gs * ds)
    return dx, dy, ds, resp


def detect_octave(stack, octave, cfg: SiftConfig, budget):
    """Top-`budget` keypoints of one octave's (B, L, H, W) Gaussian stack.

    Returns dict of (B, K) arrays: refined full-res `xy` (B, K, 2), integer
    octave coords `x`, `y`, sub-pixel offsets `dx`, `dy`, DoG level `lvl`,
    refined `sigma`, selection `score`, refined `resp`, `mask`."""
    dog = stack[:, 1:] - stack[:, :-1]                       # (B, S+2, H, W)
    resp, is_ext = _dog_extrema_response(dog)
    edge_ok = _edge_mask(dog, cfg.edge_thresh)
    B, L, H, W = dog.shape
    border = 8
    yy = torch.arange(H, device=dog.device)[:, None]
    xx = torch.arange(W, device=dog.device)[None, :]
    inb = (yy >= border) & (yy < H - border) & (xx >= border) & \
        (xx < W - border)
    valid = is_ext & edge_ok & inb & (resp > cfg.peak_thresh)
    score = torch.where(valid, resp, -1.0).reshape(B, -1)
    top, idx = torch.topk(score, min(budget, score.shape[1]), dim=1)
    lvl = idx // (H * W)
    rem = idx % (H * W)
    y = rem // W
    x = rem % W
    mask = top > 0
    ddx, ddy, dds, resp_ref = _refine_extrema(dog, lvl, y, x)
    scale_mult = 2.0 ** octave
    xy = (torch.stack([x, y], dim=-1).to(torch.float32)
          + torch.stack([ddx, ddy], dim=-1)) * scale_mult
    k = 2.0 ** (1.0 / cfg.n_scales)
    sigma = cfg.sigma0 * (k ** (lvl.to(torch.float32) + dds)) * scale_mult
    return {"xy": xy, "x": x, "y": y, "dx": ddx, "dy": ddy, "lvl": lvl,
            "sigma": sigma, "score": top, "resp": resp_ref, "mask": mask}


def _bilinear(img, xy):
    """Bilinear sample of a (H, W) image at (..., 2) float (x, y) coords,
    clipped to [0, W - 1.001] x [0, H - 1.001]."""
    H, W = img.shape
    x = xy[..., 0].clamp(0.0, W - 1.001)
    y = xy[..., 1].clamp(0.0, H - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _grad_stack(stack):
    """Central-difference gradients of a (B, L, H, W) Gaussian stack."""
    gx = torch.zeros_like(stack)
    gx[..., :, 1:-1] = 0.5 * (stack[..., :, 2:] - stack[..., :, :-2])
    gy = torch.zeros_like(stack)
    gy[..., 1:-1, :] = 0.5 * (stack[..., 2:, :] - stack[..., :-2, :])
    return gx, gy


def _extract_patches(field, lvl, y, x, P: int):
    """Integer-aligned (P, P) patches of a (B, L, H, W) field at each
    keypoint's own level; origins clamped to the field.
    Returns (patches (B, K, P, P), oy (B, K), ox (B, K))."""
    B, L, H, W = field.shape
    oy = torch.clamp(y - P // 2, 0, max(H - P, 0))
    ox = torch.clamp(x - P // 2, 0, max(W - P, 0))
    ar = torch.arange(P, device=field.device)
    rows = (oy[..., None] + ar)[..., :, None]                 # (B, K, P, 1)
    cols = (ox[..., None] + ar)[..., None, :]                 # (B, K, 1, P)
    b = torch.arange(B, device=field.device)[:, None, None, None]
    return field[b, lvl[..., None, None], rows, cols], oy, ox


def _patch_offsets(oy, ox, yf, xf, P: int):
    """Per-pixel offsets (dy, dx) of patch pixels from the subpixel
    keypoint centre, broadcastable to (..., P, P)."""
    ar = torch.arange(P, dtype=torch.float32, device=oy.device)
    dy = oy[..., None].to(torch.float32) + ar - yf[..., None]
    dx = ox[..., None].to(torch.float32) + ar - xf[..., None]
    return dy[..., :, None], dx[..., None, :]


def orientation_peaks(mag, ang, dy, dx, sigma_oct, cfg: SiftConfig,
                      n_bins: int = 36):
    """Top-2 orientation peaks per keypoint from (K, P, P) gradient patches.

    Gaussian window 1.5*sigma, radius cut 4.5*sigma, circular tent binning,
    box-smooth x2, parabolic peak refine, 80%-peak second orientation.
    Returns (theta1, theta2, has2), (K,) each."""
    K, P, _ = mag.shape
    sig_w = 1.5 * sigma_oct[:, None, None]
    r2 = dy * dy + dx * dx
    w = torch.exp(-r2 / (2.0 * sig_w ** 2)) * (r2 <= (3.0 * sig_w) ** 2)
    contrib = (mag * w).reshape(K, P * P)
    binf = ((ang + math.pi) / (2 * math.pi) * n_bins).reshape(K, P * P)
    bins = torch.arange(n_bins, dtype=torch.float32, device=mag.device)
    # circular tent weights (K, P^2, nb): 1 - min(|b - binf|, nb - |.|)
    d = torch.abs(binf[:, :, None] - bins)
    tri = torch.clamp(1.0 - torch.minimum(d, n_bins - d), min=0.0)
    hist = torch.bmm(contrib[:, None, :], tri)[:, 0]
    return _peaks_of(hist, cfg, n_bins)


def _peaks_of(hist, cfg: SiftConfig, n_bins: int):
    """orientation_peaks after its (K, n_bins) histogram: box-smooth x2,
    the two peaks, parabolic refinement."""
    for _ in range(2):
        hist = (torch.roll(hist, 1, dims=1) + hist
                + torch.roll(hist, -1, dims=1)) / 3.0

    def refine(peak_idx):
        l = hist.gather(1, ((peak_idx - 1) % n_bins)[:, None])[:, 0]
        c = hist.gather(1, peak_idx[:, None])[:, 0]
        r = hist.gather(1, ((peak_idx + 1) % n_bins)[:, None])[:, 0]
        den = l - 2 * c + r
        off = torch.where(torch.abs(den) > 1e-9, 0.5 * (l - r) / den, 0.0)
        theta = ((peak_idx.to(torch.float32) + off + 0.5) / n_bins
                 * 2 * math.pi - math.pi)
        return theta, c

    p1 = torch.argmax(hist, dim=1)
    theta1, h1 = refine(p1)
    left = torch.roll(hist, 1, dims=1)
    right = torch.roll(hist, -1, dims=1)
    is_max = (hist > left) & (hist >= right)
    idxs = torch.arange(n_bins, device=hist.device)[None, :]
    dist = torch.abs(idxs - p1[:, None])
    dist = torch.minimum(dist, n_bins - dist)
    cand = torch.where(is_max & (dist > 1), hist, -1.0)
    p2 = torch.argmax(cand, dim=1)
    theta2, _ = refine(p2)
    has2 = (torch.amax(cand, dim=1) >= cfg.ori_peak_frac * h1) & (h1 > 0)
    return theta1, theta2, has2


def descriptors_from_patches(mag, ang, dy, dx, sigma_oct, theta,
                             cfg: SiftConfig):
    """128-D descriptors from (K, P, P) gradient patches for one
    orientation slot: every pixel adds its trilinear (y-bin, x-bin,
    o-bin) weights, as nb batched (nb, P^2) @ (P^2, no) products, one per
    y-bin.  Returns (K, 128) L2-normalized, clipped, renormalized."""
    K, P, _ = mag.shape
    nb, no = cfg.desc_width, cfg.desc_bins
    ct = torch.cos(theta)[:, None, None]
    st = torch.sin(theta)[:, None, None]
    bin_size = (cfg.desc_mag * sigma_oct)[:, None, None]
    # rotate offsets into the keypoint frame, in bin units
    ux = (ct * dx + st * dy) / bin_size
    uy = (-st * dx + ct * dy) / bin_size
    wg = torch.exp(-(ux * ux + uy * uy) / (2.0 * (nb / 2.0) ** 2))
    support = (torch.abs(ux) < (nb + 1) / 2.0) & \
        (torch.abs(uy) < (nb + 1) / 2.0)
    c = (mag * wg * support).reshape(K, P * P)

    rel = ang - theta[:, None, None]
    ob = torch.remainder(rel / (2 * math.pi) * no, no).reshape(K, P * P)
    obins = torch.arange(no, dtype=torch.float32, device=mag.device)
    do = torch.abs(ob[:, :, None] - obins)
    wo = torch.clamp(1.0 - torch.minimum(do, no - do), min=0.0)  # (K,P^2,no)

    bx = (ux + nb / 2.0 - 0.5).reshape(K, P * P)
    by = (uy + nb / 2.0 - 0.5).reshape(K, P * P)
    sbins = torch.arange(nb, dtype=torch.float32, device=mag.device)
    wx = torch.clamp(1.0 - torch.abs(bx[:, :, None] - sbins), min=0.0)
    rows = []
    for ybin in range(nb):
        wyb = torch.clamp(1.0 - torch.abs(by - float(ybin)), min=0.0) * c
        rows.append(torch.bmm((wx * wyb[:, :, None]).transpose(1, 2), wo))
    desc = torch.stack(rows, dim=1).reshape(K, nb * nb * no)
    return _normalized(desc, cfg)


def _normalized(desc, cfg: SiftConfig):
    """L2-normalize, clip at cfg.clip, renormalize (K, 128) descriptors."""
    desc = desc / torch.clamp(torch.linalg.norm(desc, dim=1, keepdim=True),
                              min=1e-12)
    desc = torch.clamp(desc, max=cfg.clip)
    return desc / torch.clamp(torch.linalg.norm(desc, dim=1, keepdim=True),
                              min=1e-12)


def extract(img, cfg: SiftConfig = SiftConfig()):
    """SIFT extraction on (H, W) or (B, H, W) float images in [0, 1].

    Returns dict (leading B axis when the input had one):
      xy (K, 2) centered subpixel coords (principal point at the centre),
      xy_pix (K, 2), sigma (K,), angle (K,), response (K,),
      desc (K, 128) L2-normalized float32, mask (K,) validity.
    Up to cfg.n_orientations slots per detection (80%-peak rule); the
    budget cfg.max_keypoints is enforced by a final per-image top-K.
    """
    batched = img.dim() == 3
    if not batched:
        img = img[None]
    img = img.to(torch.float32)
    B, H, W = img.shape
    octs = gaussian_pyramid(img, cfg)
    budget = cfg.max_keypoints // cfg.n_octaves
    P = cfg.patch
    S = cfg.n_scales

    parts = {k: [] for k in ("xy", "sigma", "resp", "score", "mask", "desc",
                             "angle")}
    for o, stack in enumerate(octs):
        det = detect_octave(stack, o, cfg, budget)
        K = det["x"].shape[1]
        # per-level gradient stacks for the detection levels (gauss 1..S;
        # DoG level l uses gauss level l)
        glevels = stack[:, 1:S + 1]
        ph = max(P - glevels.shape[2], 0)
        pw = max(P - glevels.shape[3], 0)
        if ph or pw:
            glevels = F.pad(glevels, (0, pw, 0, ph))
        gx3, gy3 = _grad_stack(glevels)
        lvl_idx = torch.clamp(det["lvl"] - 1, 0, S - 1)
        gxp, oy, ox = _extract_patches(gx3, lvl_idx, det["y"], det["x"], P)
        gyp, _, _ = _extract_patches(gy3, lvl_idx, det["y"], det["x"], P)
        mag = torch.sqrt(gxp * gxp + gyp * gyp).reshape(B * K, P, P)
        ang = torch.atan2(gyp, gxp).reshape(B * K, P, P)
        yf = det["y"].to(torch.float32) + det["dy"]
        xf = det["x"].to(torch.float32) + det["dx"]
        dy, dx = _patch_offsets(oy, ox, yf, xf, P)
        dy = dy.reshape(B * K, P, 1)
        dx = dx.reshape(B * K, 1, P)
        sig_oct = (det["sigma"] / (2.0 ** o)).reshape(B * K)

        theta1, theta2, has2 = orientation_peaks(mag, ang, dy, dx, sig_oct,
                                                 cfg)
        slots_desc = [descriptors_from_patches(mag, ang, dy, dx, sig_oct,
                                               theta1, cfg)]
        slots_theta = [theta1]
        slots_mask = [det["mask"]]
        slots_score = [det["score"]]
        if cfg.n_orientations >= 2:
            slots_desc.append(descriptors_from_patches(mag, ang, dy, dx,
                                                       sig_oct, theta2, cfg))
            slots_theta.append(theta2)
            slots_mask.append(det["mask"] & has2.reshape(B, K))
            # tiny penalty so secondary orientations lose exact-tie breaks
            slots_score.append(det["score"] * 0.999)
        n_slots = len(slots_desc)
        parts["xy"].append(det["xy"].repeat(1, n_slots, 1))
        parts["sigma"].append(det["sigma"].repeat(1, n_slots))
        parts["resp"].append(det["resp"].repeat(1, n_slots))
        parts["score"].append(torch.cat(slots_score, dim=1))
        parts["mask"].append(torch.cat(slots_mask, dim=1))
        parts["desc"].append(torch.cat([d.reshape(B, K, -1)
                                        for d in slots_desc], dim=1))
        parts["angle"].append(torch.cat([t.reshape(B, K)
                                         for t in slots_theta], dim=1))
    cat = {k: torch.cat(v, dim=1) for k, v in parts.items()}

    # per-image top-K by detection score among valid slots
    Kf = min(cfg.max_keypoints, cat["score"].shape[1])
    sel_score = torch.where(cat["mask"], cat["score"], -1.0)
    top, idx = torch.topk(sel_score, Kf, dim=1)

    def take(a):
        ix = idx.reshape(*idx.shape, *([1] * (a.dim() - 2)))
        return torch.gather(a, 1, ix.expand(*idx.shape, *a.shape[2:]))

    xy = take(cat["xy"])
    out = {
        "xy": torch.stack([xy[..., 0] - W / 2.0, xy[..., 1] - H / 2.0],
                          dim=-1),
        "xy_pix": xy,
        "sigma": take(cat["sigma"]),
        "angle": take(cat["angle"]),
        "response": take(cat["resp"]),
        "desc": take(cat["desc"]).to(torch.float32),
        "mask": top > 0,
    }
    if not batched:
        out = {k: v[0] for k, v in out.items()}
    return out
