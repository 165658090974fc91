"""Time the port's SIFT histogram forms on one 1536 x 2048 image on the card.

SIFT's orientation and descriptor histograms add every patch pixel's tent
weights into a few bins.  Three forms of the same sums, each run as the
`sfm/feature_extraction` stage of `Database.feature_extraction` on one
1536 x 2048 PNG (bench.py's tiled multiscale texture, the default
DatabaseOptions without resizing: 8,192 keypoints), and as `sift.extract`
alone on the same image on the card:

  scatter      scatter_add_ of the two (2 x 2 x 2) nonzero weights: the
               port's earlier form, which sums through atomics in a
               varying order on the card (copied here);
  contraction  the batched products of the pixels with their dense tent
               weights, as the JAX package computes them (the port's form);
  segsum       the nonzero weights summed into bins k * n_bins + b by
               ops.segsum.segment_sum (one plan a histogram).

Each form is swapped in for `sift.orientation_peaks` and
`sift.descriptors_from_patches`, warmed up once, then timed in turns
(scatter, contraction, segsum, segsum, contraction, scatter); each form's
keypoints and descriptors are held to the contraction's (the largest
keypoint difference and the least descriptor cosine are printed), and each
form is run twice on the same image to show whether its output repeats bit
for bit.  Needs one NVIDIA card; run from the repository root:

    python3 tools/probe_sift_hist.py
"""
from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

H, W = 1536, 2048


def _two_bins(v):
    v0 = v.floor()
    f = v - v0
    v0 = v0.long()
    return ((v0, 1.0 - f), (v0 + 1, f))


def scatter_forms(sift):
    """The port's earlier forms: scatter_add_ of the nonzero tent weights."""
    import torch

    def orientation_peaks(mag, ang, dy, dx, sigma_oct, cfg, n_bins=36):
        K, P, _ = mag.shape
        sig_w = 1.5 * sigma_oct[:, None, None]
        r2 = dy * dy + dx * dx
        w = torch.exp(-r2 / (2.0 * sig_w ** 2)) * (r2 <= (3.0 * sig_w) ** 2)
        contrib = (mag * w).reshape(K, P * P)
        binf = ((ang + math.pi) / (2 * math.pi) * n_bins).reshape(K, P * P)
        b0f = torch.floor(binf)
        fr = binf - b0f
        b0 = b0f.to(torch.int64)
        hist = torch.zeros((K, n_bins), dtype=mag.dtype, device=mag.device)
        hist.scatter_add_(1, b0 % n_bins, contrib * (1.0 - fr))
        hist.scatter_add_(1, (b0 + 1) % n_bins, contrib * fr)
        return sift._peaks_of(hist, cfg, n_bins)

    def descriptors_from_patches(mag, ang, dy, dx, sigma_oct, theta, cfg):
        c, ob, bx, by, K = _desc_inputs(mag, ang, dy, dx, sigma_oct, theta,
                                        cfg)
        nb, no = cfg.desc_width, cfg.desc_bins
        desc = torch.zeros((K, nb * nb * no), dtype=mag.dtype,
                           device=mag.device)
        for ybin, wy in _two_bins(by):
            for xbin, wx in _two_bins(bx):
                inside = (ybin >= 0) & (ybin < nb) & (xbin >= 0) & \
                    (xbin < nb)
                cell = (ybin.clamp(0, nb - 1) * nb
                        + xbin.clamp(0, nb - 1)) * no
                wyx = torch.where(inside, c * wy * wx, 0.0)
                for obin, wo in _two_bins(ob):
                    desc.scatter_add_(1, cell + obin % no, wyx * wo)
        return sift._normalized(desc, cfg)

    return orientation_peaks, descriptors_from_patches


def segsum_forms(sift):
    """The nonzero tent weights summed by ops.segsum into k * n_bins + b."""
    import torch
    from metricsfm_tpu_torch.ops.segsum import make_plan, segment_sum

    def binsum(bins, vals, K, n_bins):
        row = torch.arange(K, device=bins.device).reshape(
            (1,) * (bins.dim() - 2) + (K, 1))
        plan = make_plan(row * n_bins + bins, K * n_bins)
        return segment_sum(vals, plan).reshape(K, n_bins)

    def orientation_peaks(mag, ang, dy, dx, sigma_oct, cfg, n_bins=36):
        K, P, _ = mag.shape
        sig_w = 1.5 * sigma_oct[:, None, None]
        r2 = dy * dy + dx * dx
        w = torch.exp(-r2 / (2.0 * sig_w ** 2)) * (r2 <= (3.0 * sig_w) ** 2)
        contrib = (mag * w).reshape(K, P * P)
        binf = ((ang + math.pi) / (2 * math.pi) * n_bins).reshape(K, P * P)
        b0f = torch.floor(binf)
        fr = binf - b0f
        b0 = b0f.to(torch.int64)
        bins = torch.stack([b0 % n_bins, (b0 + 1) % n_bins])
        vals = torch.stack([contrib * (1.0 - fr), contrib * fr])
        hist = binsum(bins, vals, K, n_bins)
        return sift._peaks_of(hist, cfg, n_bins)

    def descriptors_from_patches(mag, ang, dy, dx, sigma_oct, theta, cfg):
        c, ob, bx, by, K = _desc_inputs(mag, ang, dy, dx, sigma_oct, theta,
                                        cfg)
        nb, no = cfg.desc_width, cfg.desc_bins
        bins, vals = [], []
        for ybin, wy in _two_bins(by):
            for xbin, wx in _two_bins(bx):
                inside = (ybin >= 0) & (ybin < nb) & (xbin >= 0) & \
                    (xbin < nb)
                cell = (ybin.clamp(0, nb - 1) * nb
                        + xbin.clamp(0, nb - 1)) * no
                wyx = torch.where(inside, c * wy * wx, 0.0)
                for obin, wo in _two_bins(ob):
                    bins.append(cell + obin % no)
                    vals.append(wyx * wo)
        desc = binsum(torch.stack(bins), torch.stack(vals), K, nb * nb * no)
        return sift._normalized(desc, cfg)

    return orientation_peaks, descriptors_from_patches


def _desc_inputs(mag, ang, dy, dx, sigma_oct, theta, cfg):
    """The per-pixel magnitude, orientation and spatial bin coordinates of
    sift.descriptors_from_patches."""
    import torch
    K, P, _ = mag.shape
    nb, no = cfg.desc_width, cfg.desc_bins
    ct = torch.cos(theta)[:, None, None]
    st = torch.sin(theta)[:, None, None]
    bin_size = (cfg.desc_mag * sigma_oct)[:, None, None]
    ux = (ct * dx + st * dy) / bin_size
    uy = (-st * dx + ct * dy) / bin_size
    wg = torch.exp(-(ux * ux + uy * uy) / (2.0 * (nb / 2.0) ** 2))
    support = (torch.abs(ux) < (nb + 1) / 2.0) & \
        (torch.abs(uy) < (nb + 1) / 2.0)
    c = (mag * wg * support).reshape(K, P * P)
    rel = ang - theta[:, None, None]
    ob = torch.remainder(rel / (2 * math.pi) * no, no).reshape(K, P * P)
    bx = (ux + nb / 2.0 - 0.5).reshape(K, P * P)
    by = (uy + nb / 2.0 - 0.5).reshape(K, P * P)
    return c, ob, bx, by, K


def test_image():
    """bench.py's SIFT fixture: a multiscale texture tiled to H x W."""
    import numpy as np
    from metricsfm_tpu_torch.utils import synth
    tex = synth.multiscale_texture(np.random.default_rng(0), 1024)
    return np.tile(tex, (-(-H // 1024), -(-W // 1024)))[:H, :W]


def main():
    import numpy as np
    import torch
    from PIL import Image
    from metricsfm_tpu_torch.config import DatabaseOptions
    from metricsfm_tpu_torch.models.database import Database, \
        load_image_gray
    from metricsfm_tpu_torch.ops import sift
    from metricsfm_tpu_torch.utils.tracing import GLOBAL_TRACER, span

    card = chip_smoke.gpu_line()
    print(card, flush=True)
    chip_smoke.build_phase(("segsum",))
    forms = {"scatter": scatter_forms(sift),
             "contraction": (sift.orientation_peaks,
                             sift.descriptors_from_patches),
             "segsum": segsum_forms(sift)}
    root = tempfile.mkdtemp(prefix="probe_sift_")
    try:
        Image.fromarray((np.clip(test_image(), 0, 1) * 255).astype(
            np.uint8)).save(os.path.join(root, "img_0000.png"))
        img = torch.tensor(load_image_gray(os.path.join(root,
                                                        "img_0000.png"))[0],
                           device="cuda")
        opts = DatabaseOptions(resize=False)
        cfg = sift.SiftConfig(max_keypoints=opts.max_keypoints)

        def run(name):
            """One feature_extraction of the image with `name`'s form, in
            a fresh store; then sift.extract alone.  Returns (stage s,
            extract s, outputs)."""
            sift.orientation_peaks, sift.descriptors_from_patches = \
                forms[name]
            shutil.rmtree(os.path.join(root, "mtpu_db"), ignore_errors=True)
            GLOBAL_TRACER.reset()
            torch.cuda.synchronize()
            with span("sfm/feature_extraction", sync=True):
                Database(root, opts, device="cuda").feature_extraction()
            stage = GLOBAL_TRACER.as_dict()["sfm/feature_extraction"]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = sift.extract(img, cfg)
            torch.cuda.synchronize()
            return stage["total_s"], time.perf_counter() - t0, out

        outs = {}
        for name in forms:                       # warm-up, and outputs
            outs[name] = [run(name)[2], run(name)[2]]
        times = {name: {"stage": [], "extract": []} for name in forms}
        for name in ("scatter", "contraction", "segsum", "segsum",
                     "contraction", "scatter"):
            st, ex, _ = run(name)
            times[name]["stage"].append(st)
            times[name]["extract"].append(ex)
        ref = outs["contraction"][0]
        rows = []
        for name, (a, b) in outs.items():
            repeat = all(torch.equal(a[k], b[k]) for k in a)
            m = ref["mask"] & a["mask"]
            dxy = float((a["xy"][m] - ref["xy"][m]).abs().max()) \
                if bool(m.any()) else float("nan")
            cos = float((a["desc"][m] * ref["desc"][m]).sum(-1).min()) \
                if bool(m.any()) else float("nan")
            row = {"form": name, "card": card,
                   "feature_extraction_s": times[name]["stage"],
                   "feature_extraction_median_s":
                   statistics.median(times[name]["stage"]),
                   "extract_s": times[name]["extract"],
                   "keypoints": int(a["mask"].sum()),
                   "same_mask_as_contraction": bool(
                       torch.equal(a["mask"], ref["mask"])),
                   "max_xy_diff_px": dxy, "min_desc_cosine": cos,
                   "repeats_bit_for_bit": repeat}
            print(json.dumps(row), flush=True)
            rows.append(row)
        return rows
    finally:
        for name in ("contraction",):
            sift.orientation_peaks, sift.descriptors_from_patches = \
                forms[name]
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    main()
