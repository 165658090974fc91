"""Absolute pose (PnP): Grunert P3P in RANSAC, EPnP refit, unknown focal.

Counterpart of metricsfm_tpu/ops/pnp.py (the reference pose solvers,
SfM/src/orientation/absolute_pose_via_p3p.{h,cc}, absolute_pose_via_epnp,
absolute_pose_via_epnpf, absolute_pose_estimation):

* The RANSAC minimal solver is Grunert P3P with a Durand-Kerner quartic
  (ops/polynomial.py), batched over hypotheses (and focal samples).
* The non-minimal refit on inliers is EPnP (control points + barycentric
  + beta Gauss-Newton), weighted so inlier sets keep fixed shapes.
* Unknown focal = a focal grid sharing one P3P sample set
  (absolute_pose_via_epnpf.cc:35-64).

Conventions: world->camera pose (R, t); observations are centered pixels;
"normalized" observations are centered pixels divided by focal.  Not
ported yet: p4pf, p3pf, dlt_oriented, epnp_robust (off the sfm path).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import polynomial, umeyama
from .ransac import _gather_rows, _sample_indices

_EPS = 1e-12


def p3p_grunert(Xw, bearings):
    """Grunert's P3P: up to 4 poses from 3 world points + 3 unit bearings.

    Xw (..., 3, 3) world points, bearings (..., 3, 3) unit camera-frame
    rays.  Returns (R (..., 4, 3, 3), t (..., 4, 3), valid (..., 4)).
    """
    f1, f2, f3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]
    P1, P2, P3 = Xw[..., 0, :], Xw[..., 1, :], Xw[..., 2, :]
    a2 = torch.sum((P2 - P3) ** 2, dim=-1)
    b2 = torch.sum((P1 - P3) ** 2, dim=-1)
    c2 = torch.sum((P1 - P2) ** 2, dim=-1)
    cos_a = torch.sum(f2 * f3, dim=-1)
    cos_b = torch.sum(f1 * f3, dim=-1)
    cos_g = torch.sum(f1 * f2, dim=-1)

    b2s = torch.clamp(b2, min=_EPS)
    acb = (a2 - c2) / b2s
    apb = (a2 + c2) / b2s

    # Haralick et al., Grunert quartic in v (= s3/s1)
    A4 = (acb - 1.0) ** 2 - 4.0 * (c2 / b2s) * cos_a ** 2
    A3 = 4.0 * (acb * (1.0 - acb) * cos_b
                - (1.0 - apb) * cos_a * cos_g
                + 2.0 * (c2 / b2s) * cos_a ** 2 * cos_b)
    A2 = 2.0 * (acb ** 2 - 1.0
                + 2.0 * acb ** 2 * cos_b ** 2
                + 2.0 * ((b2 - c2) / b2s) * cos_a ** 2
                - 4.0 * apb * cos_a * cos_b * cos_g
                + 2.0 * ((b2 - a2) / b2s) * cos_g ** 2)
    A1 = 4.0 * (-acb * (1.0 + acb) * cos_b
                + 2.0 * (a2 / b2s) * cos_g ** 2 * cos_b
                - (1.0 - apb) * cos_a * cos_g)
    A0 = (1.0 + acb) ** 2 - 4.0 * (a2 / b2s) * cos_g ** 2

    coeffs = torch.stack([A4, A3, A2, A1, A0], dim=-1)
    v, is_real = polynomial.quartic_real_roots(coeffs)           # (..., 4)

    cos_a, cos_b, cos_g = cos_a[..., None], cos_b[..., None], cos_g[..., None]
    acb, b2 = acb[..., None], b2[..., None]
    den_u = 2.0 * (cos_g - v * cos_a)
    den_u = torch.where(torch.abs(den_u) < 1e-9, 1e-9, den_u)
    u = ((-1.0 + acb) * v ** 2 - 2.0 * acb * cos_b * v + 1.0 + acb) / den_u

    s1_den = 1.0 + v ** 2 - 2.0 * v * cos_b
    s1 = torch.sqrt(b2 / torch.clamp(s1_den, min=_EPS))
    s2 = u * s1
    s3 = v * s1
    valid = is_real & (s1 > 0) & (s2 > 0) & (s3 > 0)

    # camera-frame points per root, then 3-point absolute orientation.
    # Diverged roots are invalid already; zero them so the SVD below never
    # sees a non-finite matrix (LAPACK raises on those).
    Xc = torch.stack([s1[..., None] * f1[..., None, :],
                      s2[..., None] * f2[..., None, :],
                      s3[..., None] * f3[..., None, :]], dim=-2)  # (...,4,3,3)
    finite = torch.isfinite(Xc).all(dim=-1).all(dim=-1)
    valid = valid & finite
    Xc = torch.where(finite[..., None, None], Xc, 0.0)
    _, R, t = umeyama.rigid_align(Xw[..., None, :, :].expand(Xc.shape), Xc)
    return R, t, valid


def _control_points(Xw, w):
    """EPnP world control points: weighted centroid + principal axes."""
    wn = w / torch.clamp(torch.sum(w), min=_EPS)
    c0 = torch.sum(Xw * wn[:, None], dim=0)
    C = Xw - c0
    cov = (C * wn[:, None]).T @ C
    lam, V = torch.linalg.eigh(cov)
    axes = V * torch.sqrt(torch.clamp(lam, min=_EPS))[None, :]
    return torch.stack([c0, c0 + axes[:, 2], c0 + axes[:, 1], c0 + axes[:, 0]])


def _barycentric(Xw, cw):
    A = (cw[1:] - cw[0]).T
    Ainv = torch.linalg.inv(A + _EPS * torch.eye(3, dtype=Xw.dtype,
                                                 device=Xw.device))
    a123 = (Xw - cw[0]) @ Ainv.T
    a0 = 1.0 - torch.sum(a123, dim=-1, keepdim=True)
    return torch.cat([a0, a123], dim=-1)                          # (N, 4)


_IU0, _IU1 = (0, 0, 0, 1, 1, 2), (1, 2, 3, 2, 3, 3)   # triu_indices(4, 1)


def _beta_case1(v1, dist_w):
    """Least-squares scale of a single null vector (EPnP case N=1)."""
    cc = v1.reshape(4, 3)
    dc = torch.linalg.norm(cc[list(_IU0)] - cc[list(_IU1)], dim=-1)
    return torch.sum(dc * dist_w) / torch.clamp(torch.sum(dc ** 2), min=_EPS)


def _gauss_newton_betas(Vm, dist_w, beta0, iters: int = 8):
    """Refine betas (4,) minimizing the control-point distance residuals
    r_ij = |c_i - c_j|^2 - d_ij^2 with c = (Vm @ betas).reshape(4, 3);
    Jacobian analytic: dr_ij/db_k = 2 (c_i - c_j) . (V_k,i - V_k,j)."""
    i0, i1 = list(_IU0), list(_IU1)
    Vk = Vm.T.reshape(4, 4, 3)                    # (k, control point, xyz)
    dV = Vk[:, i0] - Vk[:, i1]                    # (k, 6, 3)
    eye = torch.eye(4, dtype=Vm.dtype, device=Vm.device)
    betas = beta0
    for _ in range(iters):
        cc = (Vm @ betas).reshape(4, 3)
        dcc = cc[i0] - cc[i1]                      # (6, 3)
        r = torch.sum(dcc * dcc, dim=-1) - dist_w ** 2
        J = 2.0 * torch.einsum("pc,kpc->pk", dcc, dV)   # (6, 4)
        step = torch.linalg.solve(J.T @ J + 1e-9 * eye, J.T @ r)
        betas = betas - step
    return betas


def epnp(Xw, norm_obs, weights=None):
    """EPnP pose from N >= 6 world points and normalized observations
    (absolute_pose_via_epnp.cc, Lepetit): case-N=1 beta init + 4-beta
    Gauss-Newton, weighted rows for masked inlier refits.
    Xw (N, 3), norm_obs (N, 2), weights (N,).  Returns (R, t) world->camera.
    """
    N = Xw.shape[0]
    w = torch.ones((N,), dtype=Xw.dtype, device=Xw.device) \
        if weights is None else weights
    cw = _control_points(Xw, w)
    alphas = _barycentric(Xw, cw)                                  # (N, 4)

    u, v = norm_obs[:, 0], norm_obs[:, 1]
    zeros = torch.zeros_like(u)
    ones = torch.ones_like(u)
    rx = torch.stack([ones, zeros, -u], dim=-1)                    # (N, 3)
    ry = torch.stack([zeros, ones, -v], dim=-1)
    Mx = alphas[:, :, None] * rx[:, None, :]                       # (N, 4, 3)
    My = alphas[:, :, None] * ry[:, None, :]
    M = torch.cat([Mx.reshape(N, 12), My.reshape(N, 12)], dim=0)   # (2N, 12)
    ww = torch.cat([w, w])[:, None]
    _, V = torch.linalg.eigh((M * ww).T @ M)
    Vm = V[:, :4]                                  # 4 smallest eigenvectors

    dist_w = torch.linalg.norm(cw[list(_IU0)] - cw[list(_IU1)], dim=-1)
    b1 = _beta_case1(Vm[:, 0], dist_w)
    betas = torch.zeros(4, dtype=Xw.dtype, device=Xw.device)
    betas = torch.cat([b1.reshape(1), betas[1:]])
    betas = _gauss_newton_betas(Vm, dist_w, betas)

    cc = (Vm @ betas).reshape(4, 3)
    Xc = alphas @ cc                                               # (N, 3)
    # cheirality: flip if the weighted mean depth is negative
    mean_z = torch.sum(Xc[:, 2] * w) / torch.clamp(torch.sum(w), min=_EPS)
    Xc = Xc * torch.where(mean_z < 0, -1.0, 1.0).to(Xc.dtype)
    _, R, t = umeyama.rigid_align(Xw, Xc, weights=w)
    return R, t


def reproj_errors_px(R, t, f, Xw, obs_px):
    """Per-point reprojection error in px for pose candidates (no
    distortion): R (..., 3, 3), t (..., 3), f scalar or (...,) ->
    (..., N); points behind the camera get +inf."""
    Xc = Xw @ R.transpose(-1, -2) + t[..., None, :]
    z = Xc[..., 2]
    zsafe = torch.where(torch.abs(z) < _EPS, _EPS, z)
    f = torch.as_tensor(f, dtype=Xw.dtype, device=Xw.device)
    uv = f[..., None, None] * Xc[..., :2] / zsafe[..., None]
    err = torch.linalg.norm(uv - obs_px, dim=-1)
    return torch.where(z > 0, err, torch.inf)


def _bearings(obs_px, f):
    """Unit camera rays of centered pixels for focal(s) f (...,)."""
    f = torch.as_tensor(f, dtype=obs_px.dtype, device=obs_px.device)
    xy = obs_px / f[..., None, None]
    bear = torch.cat([xy, torch.ones_like(xy[..., :1])], dim=-1)
    return bear / torch.linalg.norm(bear, dim=-1, keepdim=True)


def pnp_ransac(Xw, obs_px, f, generator: Optional[torch.Generator] = None,
               mask=None, num_hypotheses: int = 256,
               th_inlier_px: float = 10.0, sample_idx=None):
    """Batched P3P-RANSAC + EPnP refit with known focal
    (ref EPNPRansac, absolute_pose_via_epnp.cc:101-184).

    Xw (N, 3) world points; obs_px (N, 2) centered pixels; mask (N,).
    sample_idx: optional injected (H, 3) minimal samples.
    Returns dict: R, t, inlier_mask, n_inliers, avg_err (mean inlier px).
    """
    N = Xw.shape[0]
    m = torch.ones((N,), dtype=torch.bool, device=Xw.device) \
        if mask is None else mask.bool()
    idx = sample_idx.long() if sample_idx is not None else \
        _sample_indices(generator, m, num_hypotheses, 3)
    bear = _bearings(obs_px, f)
    Rs, ts, valids = p3p_grunert(_gather_rows(Xw, idx),
                                 _gather_rows(bear, idx))   # (H,4,...)
    Rs = Rs.reshape(-1, 3, 3)
    ts = ts.reshape(-1, 3)
    valids = valids.reshape(-1)

    errs = reproj_errors_px(Rs, ts, f, Xw, obs_px)            # (H*4, N)
    inl = (errs < th_inlier_px) & m[None, :]
    n_inl = torch.sum(inl, dim=-1) * valids.to(torch.int64)
    best = torch.argmax(n_inl)

    inlier_mask = inl[best]
    R_fin, t_fin = Rs[best], ts[best]
    for _ in range(2):          # EPnP refit on inliers, 2 rounds of re-gating
        w = inlier_mask.to(Xw.dtype)
        R, t = epnp(Xw, obs_px / f, weights=w)
        e = reproj_errors_px(R, t, f, Xw, obs_px)
        new_mask = (e < th_inlier_px) & m
        ok = torch.sum(new_mask) >= torch.clamp(torch.sum(inlier_mask) // 2,
                                                min=4)
        inlier_mask = torch.where(ok, new_mask, inlier_mask)
    # the last refit is kept only if it did not collapse
    R_fin = torch.where(ok, R, R_fin)
    t_fin = torch.where(ok, t, t_fin)

    e_fin = reproj_errors_px(R_fin, t_fin, f, Xw, obs_px)
    fin_inl = (e_fin < th_inlier_px) & m
    n = torch.sum(fin_inl)
    avg = torch.sum(torch.where(fin_inl, e_fin, 0.0)) / torch.clamp(n, min=1)
    return {"R": R_fin, "t": t_fin, "inlier_mask": fin_inl,
            "n_inliers": n, "avg_err": avg}


def pnp_ransac_unknown_focal(Xw, obs_px, f_hyp,
                             generator: Optional[torch.Generator] = None,
                             mask=None, num_hypotheses: int = 64,
                             num_focal_samples: int = 64,
                             th_inlier_px: float = 10.0,
                             f_lo: float = 0.5, f_hi: float = 4.0,
                             sample_idx=None):
    """Unknown-focal PnP: focal grid x shared P3P hypotheses (ref EPnP-f,
    absolute_pose_via_epnpf.cc:35-64), then an EPnP refit of the winner.

    sample_idx: optional injected (H, 3) minimal samples.
    Returns dict: R, t, f, inlier_mask, n_inliers, avg_err.
    """
    dt, dev = Xw.dtype, Xw.device
    fs = f_hyp * torch.linspace(f_lo, f_hi, num_focal_samples, dtype=dt,
                                device=dev)
    N = Xw.shape[0]
    m = torch.ones((N,), dtype=torch.bool, device=dev) if mask is None \
        else mask.bool()
    idx = sample_idx.long() if sample_idx is not None else \
        _sample_indices(generator, m, num_hypotheses, 3)
    H = idx.shape[0]
    F = fs.shape[0]

    bear = _bearings(obs_px, fs)                              # (F, N, 3)
    Xs = _gather_rows(Xw, idx)                                # (H, 3, 3)
    bs = _gather_rows(bear, idx.expand(F, H, 3))              # (F, H, 3, 3)
    Rs, ts, valids = p3p_grunert(Xs.expand(F, H, 3, 3), bs)   # (F, H, 4, ...)
    Rs = Rs.reshape(F, H * 4, 3, 3)
    ts = ts.reshape(F, H * 4, 3)
    valids = valids.reshape(F, H * 4)
    errs = reproj_errors_px(Rs, ts, fs[:, None], Xw, obs_px)  # (F, H*4, N)
    inl = (errs < th_inlier_px) & m
    n_inl = torch.sum(inl, dim=-1) * valids.to(torch.int64)   # (F, H*4)
    b = torch.argmax(n_inl, dim=-1)                           # (F,)
    ar = torch.arange(F, device=dev)
    n_best = n_inl[ar, b]
    bi = torch.argmax(n_best)
    f_best = fs[bi]
    R_best, t_best = Rs[bi, b[bi]], ts[bi, b[bi]]
    inl_best = inl[bi, b[bi]]

    w = inl_best.to(dt)
    R, t = epnp(Xw, obs_px / f_best, weights=w)
    e = reproj_errors_px(R, t, f_best, Xw, obs_px)
    fin_inl = (e < th_inlier_px) & m
    ok = torch.sum(fin_inl) >= torch.clamp(n_best[bi] // 2, min=4)
    R_fin = torch.where(ok, R, R_best)
    t_fin = torch.where(ok, t, t_best)
    e_fin = reproj_errors_px(R_fin, t_fin, f_best, Xw, obs_px)
    fin_inl = (e_fin < th_inlier_px) & m
    n = torch.sum(fin_inl)
    avg = torch.sum(torch.where(fin_inl, e_fin, 0.0)) / torch.clamp(n, min=1)
    return {"R": R_fin, "t": t_fin, "f": f_best, "inlier_mask": fin_inl,
            "n_inliers": n, "avg_err": avg}
