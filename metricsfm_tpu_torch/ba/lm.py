"""Schur-complement Levenberg-Marquardt bundle adjuster (dense path).

Counterpart of metricsfm_tpu/ba/lm.py (replacing Ceres DENSE_SCHUR +
Huber + autodiff functors, SfM/src/optimizer.cc:44-135):

* Per-observation 2-vector residuals and Jacobians come from one
  ``torch.func.vmap(jacfwd)`` over the flattened (P, V) track tensor.
* Huber robustness is IRLS: residual/Jacobian rows scaled by sqrt(rho'(s)).
* Elimination: point blocks H_pp are (P, 3, 3) closed-form inverses; the
  reduced camera system S (6C+3M dofs) is assembled with ``index_add_``
  (camera/model-indexed sums) and one (6C+3M, 3P) x (3P, 6C+3M) product
  for the Schur fill.  On CUDA index_add_ sums floats through atomics in
  a run-dependent order: two runs agree to f32 rounding (relative ~1e-6
  per entry), not bit for bit.
* Mutability masks freeze dofs by zeroing their rows/cols and pinning the
  diagonal (optimizer.cc:86-125).
* The LM loop is a Python loop with accept/reject damping and one host
  read of the candidate cost per iteration.

Not ported yet, and raising NotImplementedError: the matrix-free PCG camera
solve (cg_iterations > 0, used from sfm.th_cg_cameras cameras up) and the
GPS / pose-prior terms (see ba/problem.py).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..ops import projection
from .problem import BAProblem


class LMConfig(NamedTuple):
    max_iterations: int = 100
    huber_delta: float = 1.0
    init_lambda: float = 1e-3
    lambda_up: float = 4.0
    lambda_down: float = 2.0
    min_lambda: float = 1e-12
    max_lambda: float = 1e10
    rtol: float = 1e-8
    jacobi_scale: bool = True
    # > 0 selects the matrix-free PCG camera solve of the JAX package
    # (not ported yet: raises)
    cg_iterations: int = 0


def _residual_one(pose, intr, point, uv):
    """2-vector reprojection residual for one observation."""
    return projection.reprojection_residual(pose, intr, point, uv)


def _residual_aux(pose, intr, point, uv):
    r = _residual_one(pose, intr, point, uv)
    return r, r


_rj = vmap(jacfwd(_residual_aux, argnums=(0, 1, 2), has_aux=True))


def _gathered(problem: BAProblem):
    cam = problem.track_cam
    poses = problem.poses[cam]                              # (P,V,6)
    intrs = problem.intrs[problem.cam_model[cam]]           # (P,V,3)
    pts = problem.points[:, None, :].expand(-1, problem.max_views, -1)
    return poses, intrs, pts


def _obs_jacobians(problem: BAProblem):
    """Residuals + Jacobians for every (P, V) observation slot.

    Returns r (P,V,2), Jpose (P,V,2,6), Jintr (P,V,2,3), Jpt (P,V,2,3),
    all pre-multiplied by sqrt(track_weight) and the mask but NOT by
    robust weights.
    """
    P, V = problem.track_cam.shape
    poses, intrs, pts = _gathered(problem)
    (Jpo, Jin, Jpt), r = _rj(poses.reshape(-1, 6), intrs.reshape(-1, 3),
                             pts.reshape(-1, 3),
                             problem.track_uv.reshape(-1, 2))
    w = torch.sqrt(problem.track_weight)[:, None, None]
    m = problem.track_mask.to(r.dtype)[:, :, None]
    scale = (w * m)[..., None]
    return (r.reshape(P, V, 2) * w * m, Jpo.reshape(P, V, 2, 6) * scale,
            Jin.reshape(P, V, 2, 3) * scale, Jpt.reshape(P, V, 2, 3) * scale)


def robust_weights(r, delta):
    """sqrt(rho'(s)) for Huber rho (Ceres: rho(s) = s | 2 d sqrt(s) - d^2)."""
    s = torch.sum(r * r, dim=-1)
    w2 = torch.where(s <= delta * delta, 1.0,
                     delta / torch.sqrt(torch.clamp(s, min=1e-20)))
    return torch.sqrt(w2)


def robust_cost(r, mask, delta):
    """Total Huber cost, 0.5 * sum rho(|r|^2) over valid observations."""
    s = torch.sum(r * r, dim=-1)
    rho = torch.where(s <= delta * delta, s,
                      2.0 * delta * torch.sqrt(torch.clamp(s, min=1e-20))
                      - delta * delta)
    return 0.5 * torch.sum(rho * mask.to(r.dtype))


def compute_residuals(problem: BAProblem):
    poses, intrs, pts = _gathered(problem)
    r = _residual_one(poses, intrs, pts, problem.track_uv)
    w = torch.sqrt(problem.track_weight)[:, None, None]
    return r * w * problem.track_mask.to(r.dtype)[:, :, None]


def problem_cost(problem: BAProblem, huber_delta: float):
    return robust_cost(compute_residuals(problem), problem.track_mask,
                       huber_delta)


def _inv3x3(A, eps=1e-12):
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(torch.abs(det) < eps, eps, det)
    rows = torch.stack([torch.stack([A11, A12, A13], dim=-1),
                        torch.stack([A21, A22, A23], dim=-1),
                        torch.stack([A31, A32, A33], dim=-1)], dim=-2)
    return rows / det[..., None, None]


def _chol3x3(A, eps=1e-12):
    """Closed-form batched 3x3 Cholesky (lower)."""
    l11 = torch.sqrt(torch.clamp(A[..., 0, 0], min=eps))
    l21 = A[..., 1, 0] / l11
    l31 = A[..., 2, 0] / l11
    l22 = torch.sqrt(torch.clamp(A[..., 1, 1] - l21 * l21, min=eps))
    l32 = (A[..., 2, 1] - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(A[..., 2, 2] - l31 * l31 - l32 * l32,
                                 min=eps))
    z = torch.zeros_like(l11)
    return torch.stack([torch.stack([l11, z, z], dim=-1),
                        torch.stack([l21, l22, z], dim=-1),
                        torch.stack([l31, l32, l33], dim=-1)], dim=-2)


def _bin_sum(values, index, n):
    """sum of values (..., *tail) into n bins by a flat index (index_add_)."""
    tail = values.shape[index.dim():]
    out = torch.zeros((n, *tail), dtype=values.dtype, device=values.device)
    return out.index_add_(0, index.reshape(-1),
                          values.reshape(-1, *tail))


def partial_camera_system(problem: BAProblem, lam, cfg: LMConfig):
    """Linearize the tracks into the reduced camera system.

    Returns (S, rhs, aux): the undamped, unmasked (6C+3M)^2 system, its
    right-hand side, and the per-track tensors back-substitution needs.
    Every term is a sum over tracks.
    """
    C, M, P = problem.n_cameras, problem.n_models, problem.n_points
    D = 6 * C + 3 * M
    dtype, dev = problem.points.dtype, problem.points.device

    r, Jpo, Jin, Jpt = _obs_jacobians(problem)
    rw = robust_weights(r, cfg.huber_delta)[..., None]
    r = r * rw
    Jpo = Jpo * rw[..., None]
    Jin = Jin * rw[..., None]
    Jpt = Jpt * rw[..., None]

    cam = problem.track_cam                       # (P,V)
    model = problem.cam_model[cam]                # (P,V)

    # ---- gradient ----
    g_cam = torch.cat([
        _bin_sum(torch.einsum("pvri,pvr->pvi", Jpo, r), cam, C).reshape(-1),
        _bin_sum(torch.einsum("pvri,pvr->pvi", Jin, r), model, M).reshape(-1)])
    g_pt = torch.einsum("pvri,pvr->pi", Jpt, r)   # (P,3)

    # ---- point blocks ----
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hpp = torch.einsum("pvri,pvrj->pij", Jpt, Jpt)
    diag_pp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    damp = lam * torch.clamp(diag_pp, min=1e-12) + 1e-12
    Hpp_d = Hpp + torch.diag_embed(damp)
    # frozen points: identity block (benign inverse; d_pt forced 0 later)
    pm = problem.point_mut[:, None, None]
    Hpp_d = Hpp_d * pm + eye3 * (1.0 - pm)
    Hpp_inv = _inv3x3(Hpp_d)

    # ---- camera block-diagonals ----
    Hcc_pose = _bin_sum(torch.einsum("pvri,pvrj->pvij", Jpo, Jpo), cam, C)
    Hcc_intr = _bin_sum(torch.einsum("pvri,pvrj->pvij", Jin, Jin), model, M)
    Hcc_pi = _bin_sum(torch.einsum("pvri,pvrj->pvij", Jpo, Jin), cam, C)

    S = torch.zeros((D, D), dtype=dtype, device=dev)
    ar6 = torch.arange(6, device=dev)
    ar3 = torch.arange(3, device=dev)
    pose_rows = 6 * torch.arange(C, device=dev)[:, None] + ar6     # (C,6)
    intr_rows = 6 * C + 3 * torch.arange(M, device=dev)[:, None] + ar3
    pi_cols = 6 * C + 3 * problem.cam_model[:, None] + ar3         # (C,3)
    S.index_put_((pose_rows[:, :, None], pose_rows[:, None, :]), Hcc_pose,
                 accumulate=True)
    S.index_put_((intr_rows[:, :, None], intr_rows[:, None, :]), Hcc_intr,
                 accumulate=True)
    S.index_put_((pose_rows[:, :, None], pi_cols[:, None, :]), Hcc_pi,
                 accumulate=True)
    S.index_put_((pi_cols[:, :, None], pose_rows[:, None, :]),
                 Hcc_pi.transpose(-1, -2), accumulate=True)

    # ---- Schur subtraction: S -= sum_p E_p Hpp_inv E_p^T ----
    # W (P,V,9,3) = [Jpose|Jintr]^T Jpt per view; mutable points only.
    Jc = torch.cat([Jpo, Jin], dim=-1)                               # (P,V,2,9)
    W = torch.einsum("pvri,pvrj->pvij", Jc, Jpt) \
        * problem.point_mut[:, None, None, None]
    # Hpp_inv = L L^T; per point, fold its views into per-camera / per-model
    # factors G (P, C, 6, 3) and (P, M, 3, 3) — index_add_ over (point,
    # camera) bins — so the Schur fill is one G G^T product
    U = torch.einsum("pvij,pjk->pvik", W, _chol3x3(Hpp_inv))         # (P,V,9,3)
    p_idx = torch.arange(P, device=dev)[:, None]
    G_pose = _bin_sum(U[:, :, :6], p_idx * C + cam, P * C).reshape(P, C, 6, 3)
    G_intr = _bin_sum(U[:, :, 6:], p_idx * M + model, P * M).reshape(
        P, M, 3, 3)
    Gp = G_pose.permute(1, 2, 0, 3).reshape(6 * C, 3 * P)
    Gi = G_intr.permute(1, 2, 0, 3).reshape(3 * M, 3 * P)
    G = torch.cat([Gp, Gi], dim=0)                                    # (D,3P)
    S = S - G @ G.T

    # ---- rhs: -(g_cam - E Hpp_inv g_pt) ----
    y = torch.einsum("pij,pj->pi", Hpp_inv, g_pt)
    corr = torch.einsum("pvij,pj->pvi", W, y)                         # (P,V,9)
    rhs = -g_cam + torch.cat([_bin_sum(corr[..., :6], cam, C).reshape(-1),
                              _bin_sum(corr[..., 6:], model, M).reshape(-1)])
    aux = {"W": W, "Hpp_inv": Hpp_inv, "g_pt": g_pt}
    return S, rhs, aux


def solve_reduced(S, rhs, problem: BAProblem, lam, cfg: LMConfig):
    """Damp + freeze-mask the reduced system and solve it by Cholesky.

    A factorization failure (not positive definite) yields a NaN step,
    which the LM loop rejects, as in the JAX package."""
    diag = torch.diagonal(S)
    S = S + torch.diag_embed(lam * torch.clamp(diag, min=1e-12) + 1e-10)
    free = torch.cat([problem.pose_mut.repeat_interleave(6),
                      problem.intr_mut.repeat_interleave(3)])
    S = S * free[:, None] * free[None, :] + torch.diag_embed(1.0 - free)
    rhs = rhs * free
    if cfg.jacobi_scale:
        d = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-12))
        L, info = torch.linalg.cholesky_ex(S / d[:, None] / d[None, :])
        d_cam = torch.cholesky_solve((rhs / d)[:, None], L)[:, 0] / d
    else:
        L, info = torch.linalg.cholesky_ex(S)
        d_cam = torch.cholesky_solve(rhs[:, None], L)[:, 0]
    return torch.where(info == 0, d_cam, torch.nan)


def backsub_points(aux, d_cam, problem: BAProblem):
    """Point back-substitution: d_pt = -Hpp_inv (g_pt + E^T d_cam)."""
    C, M = problem.n_cameras, problem.n_models
    dp = d_cam[:6 * C].reshape(C, 6)
    di = d_cam[6 * C:].reshape(M, 3)
    d9 = torch.cat([dp, di[problem.cam_model]], dim=1)          # (C,9)
    dc = d9[problem.track_cam]                                  # (P,V,9)
    Et = torch.einsum("pvik,pvi->pk", aux["W"], dc)
    d_pt = -torch.einsum("pij,pj->pi", aux["Hpp_inv"], aux["g_pt"] + Et)
    return d_pt * problem.point_mut[:, None]


def _assemble_and_solve(problem: BAProblem, lam, cfg: LMConfig):
    C, M = problem.n_cameras, problem.n_models
    S, rhs, aux = partial_camera_system(problem, lam, cfg)
    d_cam = solve_reduced(S, rhs, problem, lam, cfg)
    d_pt = backsub_points(aux, d_cam, problem)
    d_pose = d_cam[:6 * C].reshape(C, 6) * problem.pose_mut[:, None]
    d_intr = d_cam[6 * C:].reshape(M, 3) * problem.intr_mut[:, None]
    return d_pose, d_intr, d_pt


def solve_lm(problem: BAProblem, cfg: LMConfig = LMConfig()):
    """Run LM to convergence or cfg.max_iterations.

    Returns (problem, info) with initial_cost, final_cost, iterations,
    lambda, converged and rms_px (host numbers).
    """
    if cfg.cg_iterations > 0:
        raise NotImplementedError(
            "the matrix-free PCG camera solve (ba/lm.py _cg_solve, used "
            "from sfm.th_cg_cameras = 128 cameras) is not ported yet "
            "(ROADMAP queue 1, 'BA PCG')")
    cost = float(problem_cost(problem, cfg.huber_delta))
    initial_cost = cost
    lam = float(cfg.init_lambda)
    it = 0
    converged = False
    while it < cfg.max_iterations:
        d_pose, d_intr, d_pt = _assemble_and_solve(problem, lam, cfg)
        cand = problem._replace(poses=problem.poses + d_pose,
                                intrs=problem.intrs + d_intr,
                                points=problem.points + d_pt)
        new_cost = float(problem_cost(cand, cfg.huber_delta))
        it += 1
        accept = new_cost < cost and math.isfinite(new_cost)
        if accept:
            rel = abs(cost - new_cost) / max(cost, 1e-20)
            problem, cost = cand, new_cost
            lam = max(lam / cfg.lambda_down, cfg.min_lambda)
            if rel < cfg.rtol:
                converged = True
                break
        else:
            lam = min(lam * cfg.lambda_up, cfg.max_lambda)
    n_obs = int(problem.n_observations())
    info = {"initial_cost": initial_cost, "final_cost": cost,
            "iterations": it, "lambda": lam, "converged": converged,
            "rms_px": math.sqrt(2.0 * cost / max(n_obs, 1))}
    return problem, info
