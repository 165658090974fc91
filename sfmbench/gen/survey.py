"""Synthetic UAV survey for bundle adjustment: the benchmark's own
generator (a survey version of the program's ``synthetic_ba_problem``).

A lawnmower grid of nadir cameras over relief terrain.  Flight lines run
along the image width; the grid spacing follows the forward and side
overlaps.  World axes: X along the flight lines, Y across them, Z down, so
a nadir camera's rotation is near the identity.  Ground points are drawn
uniformly over the surveyed box at a density that gives each view
`obs_per_view` observations; every camera whose image holds a point
observes it (at most `max_views`, spread over the observers, as the
program's ``Scene.to_ba_problem`` caps a track), and points seen by fewer
than two views are dropped.  Observations are exact projections with
seeded pixel noise.

The site (the grid's jitter, the terrain and the ground points, so every
problem's size) is drawn from the configuration's `site_seed`; the
observation noise from the run's seed.  Every seed thus sees the same
sizes, and the same padded shapes, with other noise.  Both are drawn on
`device` with a ``torch.Generator``, in float64, in a few large calls.
"""
from __future__ import annotations

import math

import torch

from ..reference import geometry


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def _normal(g, shape, device, std=1.0):
    return std * torch.randn(shape, generator=g, device=device,
                             dtype=torch.float64)


def _uniform(g, shape, device, lo, hi):
    u = torch.rand(shape, generator=g, device=device, dtype=torch.float64)
    return lo + (hi - lo) * u


def grid_layout(survey: dict):
    """Footprint and spacing of the grid at nominal altitude (metres)."""
    W, H = survey["width"], survey["height"]
    f = survey["focal_rel"] * W
    h = survey["altitude_m"]
    fp_along, fp_across = W / f * h, H / f * h
    step_along = (1.0 - survey["forward_overlap"]) * fp_along
    step_across = (1.0 - survey["side_overlap"]) * fp_across
    return f, fp_along, fp_across, step_along, step_across


def terrain_z(xy, waves, survey):
    """Ground depth below the camera plane: altitude plus smooth relief."""
    kx, ky, ph, amp = waves
    arg = xy[:, 0:1] * kx + xy[:, 1:2] * ky + ph
    return survey["altitude_m"] + (torch.sin(arg) * amp).sum(dim=1)


def make_survey(survey: dict, seed: int, device) -> dict:
    """The ground truth and the noisy tracks of one survey, its noise
    drawn from `seed`.

    Returns float64 tensors on `device`: poses (C, 6) world->camera
    [angle-axis, t], intr (3,) [f, k1, k2], points (P, 3), and the tracks
    track_cam (P, V) int64, track_uv (P, V, 2) centred pixels, track_mask
    (P, V) bool, with V = survey["max_views"].
    """
    g = _gen(survey["site_seed"], device)
    rows, cols = survey["grid"]
    W, H = survey["width"], survey["height"]
    f, fp_along, fp_across, step_along, step_across = grid_layout(survey)
    h = survey["altitude_m"]
    C = rows * cols

    # serpentine flight lines, one heading for the whole survey
    line = torch.arange(rows, device=device).repeat_interleave(cols)
    k = torch.arange(cols, device=device).repeat(rows)
    k = torch.where(line % 2 == 1, cols - 1 - k, k)
    centers = torch.stack([k.double() * step_along,
                           line.double() * step_across,
                           _normal(g, (C,), device,
                                   survey["altitude_jitter_m"])], dim=1)
    tilt = math.radians(survey["tilt_deg"])
    aa = torch.cat([_normal(g, (C, 2), device, tilt),
                    _normal(g, (C, 1), device,
                            math.radians(survey["yaw_deg"]))], dim=1)
    R = geometry.rotation(aa)
    t = -(R @ centers[:, :, None])[:, :, 0]
    poses = torch.cat([aa, t], dim=1)
    intr = torch.tensor([f, survey["k1"], survey["k2"]], dtype=torch.float64,
                        device=device)

    n_w = survey["relief_waves"]
    lam = _uniform(g, (n_w,), device, 0.5 * h, 4.0 * h)
    ang = _uniform(g, (n_w,), device, 0.0, 2 * math.pi)
    waves = (2 * math.pi / lam * torch.cos(ang), 2 * math.pi / lam
             * torch.sin(ang), _uniform(g, (n_w,), device, 0.0, 2 * math.pi),
             survey["relief_rel"] * h / math.sqrt(n_w)
             * torch.ones(n_w, dtype=torch.float64, device=device))

    x0, x1 = -fp_along / 2, (cols - 1) * step_along + fp_along / 2
    y0, y1 = -fp_across / 2, (rows - 1) * step_across + fp_across / 2
    density = survey["obs_per_view"] / (fp_along * fp_across)
    n_draw = int(round(density * (x1 - x0) * (y1 - y0)))
    xy = torch.stack([_uniform(g, (n_draw,), device, x0, x1),
                      _uniform(g, (n_draw,), device, y0, y1)], dim=1)
    X = torch.cat([xy, terrain_z(xy, waves, survey)[:, None]], dim=1)

    V = survey["max_views"]
    cams, uvs, masks = [], [], []
    chunk = survey.get("chunk_points", 8192)
    for s in range(0, n_draw, chunk):
        Xs = X[s:s + chunk]
        uv, z = geometry.project_all(R, t, intr, Xs)          # (n, C, 2)
        vis = ((z > 0) & (uv[..., 0].abs() < W / 2 - 1)
               & (uv[..., 1].abs() < H / 2 - 1))
        n = vis.sum(dim=1)
        # camera ids of each point's observers in ascending order, then at
        # most V of them spread over the list (slot k -> k * n // V)
        order = torch.sort((~vis).to(torch.int8), dim=1, stable=True)[1]
        slot = torch.arange(V, device=device)[None, :]
        pick = torch.where(n[:, None] > V, slot * n[:, None] // V, slot)
        cam = torch.gather(order, 1, pick)
        valid = slot < n[:, None]
        uv_v = torch.gather(uv, 1, cam[..., None].expand(-1, -1, 2))
        cams.append(torch.where(valid, cam, 0))
        uvs.append(uv_v * valid[..., None])
        masks.append(valid)
    track_mask = torch.cat(masks)
    keep = track_mask.sum(dim=1) >= 2
    track_mask = track_mask[keep]
    noise = _normal(_gen(seed, device), (int(keep.sum()), V, 2), device,
                    survey["noise_px"])
    track_uv = (torch.cat(uvs)[keep] + noise) * track_mask[..., None]
    return {"poses": poses, "intr": intr, "points": X[keep],
            "track_cam": torch.cat(cams)[keep], "track_uv": track_uv,
            "track_mask": track_mask}
