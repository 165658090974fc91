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
"normalized" observations are centered pixels divided by focal.  Off the
sfm path: the subset-consensus `epnp_robust`, the focal-sweep minimal
solvers `p3pf` / `p4pf` and the known-rotation `dlt_oriented`.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import polynomial, umeyama
from .lines import _linspace
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


def epnp_robust(Xw, obs_px, f, generator: Optional[torch.Generator] = None,
                mask=None, iters: int = 10, subset_frac: float = 0.9,
                subset_u=None):
    """Subset-consensus EPnP (ref EPNPRobust, absolute_pose_via_epnp.cc:45-99).

    EPnP is fit on `iters` random subsets (Bernoulli(subset_frac) weight
    masks), each point's reprojection error is accumulated across the fits,
    then one refit runs on the points whose accumulated error is at most
    the floor(subset_frac * n_valid)-th smallest (clipped to [4, N]).
    subset_u: optional injected (iters, N) uniforms in place of the draws
    from `generator`.
    Returns dict: R, t, inlier_mask, avg_err (mean kept-point error px).
    """
    N = Xw.shape[0]
    dt, dev = Xw.dtype, Xw.device
    m = torch.ones((N,), dtype=torch.bool, device=dev) if mask is None \
        else mask.bool()
    norm_obs = obs_px / f
    u = subset_u.to(device=dev, dtype=dt) if subset_u is not None else \
        torch.rand((iters, N), generator=generator, device=dev, dtype=dt)

    acc = torch.zeros((N,), dtype=dt, device=dev)
    for k in range(u.shape[0]):
        keep = (u[k] < subset_frac) & m
        R, t = epnp(Xw, norm_obs, weights=keep.to(dt))
        err = reproj_errors_px(R, t, f, Xw, obs_px)
        acc = acc + torch.where(torch.isfinite(err), err, 1e6)
    acc = torch.where(m, acc, torch.inf)
    n_valid = torch.sum(m)
    k_keep = torch.clamp((subset_frac * n_valid).to(torch.int64), 4, N)
    thresh = torch.sort(acc).values.gather(0, (k_keep - 1).reshape(1))
    inl = m & (acc <= thresh)
    w = inl.to(dt)
    R, t = epnp(Xw, norm_obs, weights=w)
    err = reproj_errors_px(R, t, f, Xw, obs_px)
    err = torch.where(torch.isfinite(err), err, 1e6)
    avg = torch.sum(err * w) / torch.clamp(torch.sum(w), min=1.0)
    return {"R": R, "t": t, "inlier_mask": inl, "avg_err": avg}


def _focal_sweep(f_hyp, num, f_lo, f_hi, dtype, device):
    """f_hyp * exp(linspace(log f_lo, log f_hi, num)), the grid as
    jnp.linspace evaluates it."""
    lo = torch.log(torch.tensor(f_lo, dtype=dtype, device=device))
    hi = torch.log(torch.tensor(f_hi, dtype=dtype, device=device))
    grid = _linspace(lo, hi, num, True, lo)
    return f_hyp * torch.exp(grid)


def p3pf(Xw, obs_px, f_hyp, num_focal_samples: int = 128,
         f_lo: float = 0.3, f_hi: float = 5.0):
    """Pose + focal candidates from 3 points (ref absolute_pose_via_p3pf).

    3 points underdetermine (pose, focal): like the reference, returns the
    candidate set over a log-spaced focal sweep, every focal solved by P3P
    in one batch; callers disambiguate with extra correspondences.
    Xw (..., 3, 3), obs_px (..., 3, 2): leading axes are problems.
    Returns dict R (..., S, 4, 3, 3), t (..., S, 4, 3), f (S,),
    valid (..., S, 4).
    """
    fs = _focal_sweep(f_hyp, num_focal_samples, f_lo, f_hi, Xw.dtype,
                      Xw.device)
    S = fs.shape[0]
    R, t, valid = p3p_grunert(
        Xw[..., None, :, :].expand(*Xw.shape[:-2], S, 3, 3),
        _bearings(obs_px[..., None, :, :], fs))
    return {"R": R, "t": t, "f": fs, "valid": valid}


def _take(idx, e, R, t):
    """Candidates idx (..., 1) along the candidate axis K of e (..., K),
    R (..., K, 3, 3) and t (..., K, 3)."""
    return (torch.take_along_dim(e, idx, -1)[..., 0],
            torch.take_along_dim(R, idx[..., None, None], -3)[..., 0, :, :],
            torch.take_along_dim(t, idx[..., None], -2)[..., 0, :])


def _p4pf_errors(Xw, obs_px, fs):
    """For focals fs (..., S) of problems Xw (..., 4, 3), obs_px (..., 4, 2):
    P3P on points 0..2, the root that best reprojects point 3.  Returns
    (err4 (..., S), R (..., S, 3, 3), t (..., S, 3)); invalid roots score
    +inf."""
    S = fs.shape[-1]
    R, t, valid = p3p_grunert(
        Xw[..., None, :3, :].expand(*fs.shape[:-1], S, 3, 3),
        _bearings(obs_px[..., None, :3, :], fs))          # (..., S, 4, ...)
    e4 = reproj_errors_px(R, t, fs[..., None], Xw[..., None, None, 3:4, :],
                          obs_px[..., None, None, 3:4, :])[..., 0]
    e4 = torch.where(valid, e4, torch.inf)
    return _take(torch.argmin(e4, dim=-1, keepdim=True), e4, R, t)


def p4pf(Xw, obs_px, f_hyp, num_focal_samples: int = 128,
         newton_iters: int = 6, f_lo: float = 0.3, f_hi: float = 5.0):
    """Pose + focal from exactly 4 points (ref absolute_pose_via_p4pf).

    A batched focal sweep replaces the reference's generated Groebner
    template: P3P on points 0..2 for every focal sample at once, scored by
    the 4th point's reprojection, then Newton steps on log f by central
    differences (the three focals of a step in one batch, the step clipped
    to +-0.2); the polished result replaces the swept one only if better.

    Xw (..., 4, 3) world points; obs_px (..., 4, 2) centered pixels
    (leading axes are problems, all solved in one batch); f_hyp focal
    hypothesis (e.g. 1.2 * max(w, h)).
    Returns dict R (..., 3, 3), t (..., 3), f (...), err4 (...) 4th-point
    error px, valid (...).
    """
    dt, dev = Xw.dtype, Xw.device
    lead = Xw.shape[:-2]
    fs = _focal_sweep(f_hyp, num_focal_samples, f_lo, f_hi, dt, dev)
    fs = fs.expand(*lead, fs.shape[0])
    e4s, Rs, ts = _p4pf_errors(Xw, obs_px, fs)
    bi = torch.argmin(e4s, dim=-1, keepdim=True)
    f_swept = torch.take_along_dim(fs, bi, -1)[..., 0]
    e_swept, R_swept, t_swept = _take(bi, e4s, Rs, ts)

    h = 1e-3
    offs = torch.tensor([-h, 0.0, h], dtype=dt, device=dev)
    lf = torch.log(f_swept)
    for _ in range(newton_iters):
        e0, e1, e2 = _p4pf_errors(Xw, obs_px,
                                  torch.exp(lf[..., None] + offs))[0].unbind(-1)
        g = (e2 - e0) / (2 * h)
        H = (e2 - 2 * e1 + e0) / (h * h)
        step = torch.where(H > 1e-9, g / H, 0.0)
        lf = lf - torch.clamp(step, -0.2, 0.2)
    f_fin = torch.exp(lf)
    e4, R_fin, t_fin = _p4pf_errors(Xw, obs_px, f_fin[..., None])
    e4, R_fin, t_fin = e4[..., 0], R_fin[..., 0, :, :], t_fin[..., 0, :]
    better = e4 < e_swept
    e_fin = torch.minimum(e4, e_swept)
    return {"R": torch.where(better[..., None, None], R_fin, R_swept),
            "t": torch.where(better[..., None], t_fin, t_swept),
            "f": torch.where(better, f_fin, f_swept), "err4": e_fin,
            "valid": torch.isfinite(e_fin)}


def _ridge_solve(A, b, ww):
    """Row-weighted least squares by the normal equations, 1e-9 ridge."""
    Aw = A * ww
    eye = torch.eye(A.shape[1], dtype=A.dtype, device=A.device)
    return torch.linalg.solve(Aw.T @ A + 1e-9 * eye, Aw.T @ b)


def dlt_oriented(R, Xw, obs_px, f=None, weights=None):
    """Position (+ optional focal) given a known rotation (ref
    absolute_pose_via_dlt_oriented.{h,cc}).

    With R fixed, projection is linear in the remaining unknowns.  Known
    f: a 2N x 3 least squares for t.  Unknown f: with s = f t_xy the
    system is linear in (f, s_x, s_y, t_z), and t_xy = s / f.  Both normal
    systems carry a 1e-9 ridge.
    R (3, 3) world->camera; Xw (N, 3); obs_px (N, 2); weights (N,).
    Returns dict t (3,), f ().
    """
    dt, dev = Xw.dtype, Xw.device
    Xc = Xw @ R.T                                   # rotated points
    u, v = obs_px[:, 0], obs_px[:, 1]
    N = Xw.shape[0]
    w = torch.ones((N,), dtype=dt, device=dev) if weights is None \
        else weights
    zeros = torch.zeros_like(u)
    ones = torch.ones_like(u)
    ww = torch.cat([w, w])[:, None]
    if f is not None:
        # f (Xc_x + t_x) = u (Xc_z + t_z): rows linear in t
        A = torch.cat([torch.stack([f * ones, zeros, -u], dim=-1),
                       torch.stack([zeros, f * ones, -v], dim=-1)])
        b = torch.cat([u * Xc[:, 2] - f * Xc[:, 0],
                       v * Xc[:, 2] - f * Xc[:, 1]])
        return {"t": _ridge_solve(A, b, ww),
                "f": torch.as_tensor(f, dtype=dt, device=dev)}
    # unknowns (f, s_x, s_y, t_z): f Xc_x + s_x - u t_z = u Xc_z
    A = torch.cat([torch.stack([Xc[:, 0], ones, zeros, -u], dim=-1),
                   torch.stack([Xc[:, 1], zeros, ones, -v], dim=-1)])
    b = torch.cat([u * Xc[:, 2], v * Xc[:, 2]])
    x = _ridge_solve(A, b, ww)
    f_est = x[0]
    fsafe = torch.where(torch.abs(f_est) < _EPS, _EPS, f_est)
    return {"t": torch.stack([x[1] / fsafe, x[2] / fsafe, x[3]]),
            "f": f_est}
