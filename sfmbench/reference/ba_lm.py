"""Plain Levenberg-Marquardt bundle adjustment: the yardstick that the BA
cells hold the program's solves against.

Huber-robust reprojection cost of the upstream bundle adjuster
(0.5 sum rho(w |r|^2), rho(s) = s below delta^2 and 2 delta sqrt(s) -
delta^2 above), one shared camera model [f, k1, k2], poses updated
additively in angle-axis.  Each step solves exactly the IRLS system far
from the optimum and, near it, one whose curvature along r on the linear
branch is cut halfway toward Newton's (J^T w rho' (I - r^ r^T) J: the cost
grows linearly along r there, and IRLS, keeping the full J^T J, converges
only linearly): Marquardt damping of the diagonal, the points eliminated by the
Schur complement, assembled densely from the 9x9 blocks of every pair of
observations of a point, and a Cholesky solve over the free camera
parameters.  Observations are flat lists (camera, point, uv, weight): the
yardstick shares no layout, code or plan with the program.

`solve` runs in float64 by default.  The control runs it in float32 with
every small matrix product's operands rounded to TF32 (`precision="tf32"`).
"""
from __future__ import annotations

import math

import torch

from . import geometry

PAIR_CHUNK = 1 << 20
# Near the optimum (once a step gains less than NEWTON_REL of the cost) the
# curvature along r of a residual on the linear branch is cut by KAPPA
# toward Newton's (which is 0 there): IRLS alone converges linearly, and
# Newton's own curvature leaves the blocks of points seen mostly by such
# residuals near singular.  Far from the optimum IRLS leads.
NEWTON_REL = 1e-2
KAPPA = 0.5


def observations(track_cam, track_uv, track_mask, track_weight):
    """Flat observations, point-major, from (P, V) tracks."""
    pt, slot = torch.nonzero(track_mask, as_tuple=True)
    return {"cam": track_cam[pt, slot], "pt": pt, "uv": track_uv[pt, slot],
            "w": track_weight[pt], "n_points": track_mask.shape[0]}


def _pairs(obs):
    """Every ordered pair (i, j) of observations of one point."""
    pt = obs["pt"]
    n = torch.bincount(pt, minlength=obs["n_points"])
    start = torch.cumsum(n, 0) - n
    n2 = n * n
    pstart = torch.cumsum(n2, 0) - n2
    owner = torch.repeat_interleave(torch.arange(n.numel(), device=pt.device),
                                    n2)
    q = torch.arange(int(n2.sum()), device=pt.device) - pstart[owner]
    return start[owner] + q // n[owner], start[owner] + q % n[owner]


def huber_rho(s, delta):
    return torch.where(s <= delta * delta, s,
                       2 * delta * torch.sqrt(s) - delta * delta)


def cost(obs, poses, intr, points, delta, mm=geometry.mm):
    """0.5 sum rho over the observations, in the dtype of `poses`."""
    dt = poses.dtype
    R = geometry.rotation(poses[:, :3], mm)
    cam, pt = obs["cam"], obs["pt"]
    r = geometry.residuals(R[cam], poses[cam, 3:], intr.expand(cam.numel(), 3),
                           points[pt], obs["uv"].to(dt), mm)
    s = obs["w"].to(dt) * (r * r).sum(dim=1)
    return 0.5 * huber_rho(s, delta).sum()


def solve(obs, poses, intr, points, pose_free, intr_free, *, delta,
          max_iterations, rtol, init_lambda=1e-3, lambda_floor=1e-10,
          max_rejections=6, lambda_down=2.0, precision="f64"):
    """LM from (poses (C, 6), intr (3,), points (P, 3)); pose_free (C,)
    bool, intr_free bool.  Returns poses, intr, points and
    {"cost", "initial_cost", "iterations"}."""
    dt = torch.float64 if precision == "f64" else torch.float32
    mm = geometry.mm if precision in ("f64", "f32") else geometry.mm_tf32
    dev = poses.device
    poses, intr, points = poses.to(dt), intr.to(dt), points.to(dt)
    cam, pt = obs["cam"], obs["pt"]
    uv, w = obs["uv"].to(dt), obs["w"].to(dt)
    C, P, N = poses.shape[0], points.shape[0], cam.numel()
    D = 6 * C + 3
    dof = torch.cat([6 * cam[:, None] + torch.arange(6, device=dev),
                     (6 * C + torch.arange(3, device=dev)).expand(N, 3)], 1)
    free = torch.cat([pose_free.repeat_interleave(6),
                      torch.full((3,), bool(intr_free), device=dev)])
    fidx = torch.nonzero(free)[:, 0]
    pi, pj = _pairs(obs)

    cur = cost(obs, poses, intr, points, delta, mm)
    info = {"initial_cost": float(cur)}
    lam, rejections, it = init_lambda, 0, 0
    newton = False
    while it < max_iterations:
        it += 1
        R = geometry.rotation(poses[:, :3], mm)
        r, Jc, Jp = geometry.jacobians(poses[cam, :3], R[cam], poses[cam, 3:],
                                       intr.expand(N, 3), points[pt], uv, mm)
        # the Huber cost's gradient sum w rho' J^T r and curvature
        # J^T w rho' (I - k r^ r^T) J: k = KAPPA on the linear branch near
        # the optimum, else 0 (IRLS)
        s = w * (r * r).sum(dim=1)
        lin = s > delta * delta
        a = w * torch.where(lin, delta / torch.sqrt(s.clamp_min(1e-30)), 1.0)
        rh = r / (r.norm(dim=1, keepdim=True).clamp_min(1e-30))
        Pr = torch.eye(2, dtype=dt, device=dev) - \
            (KAPPA * newton * lin)[:, None, None] * rh[:, :, None] \
            * rh[:, None, :]
        ar = (a[:, None] * r)[:, :, None]
        sa = torch.sqrt(a)[:, None, None]
        g_c = torch.zeros(D, dtype=dt, device=dev).index_add_(
            0, dof.reshape(-1), mm(Jc.transpose(1, 2), ar).reshape(-1))
        g_p = torch.zeros(P, 3, dtype=dt, device=dev).index_add_(
            0, pt, mm(Jp.transpose(1, 2), ar)[:, :, 0])
        Jc, Jp = sa * mm(Pr, Jc), sa * mm(Pr, Jp)
        JcT = Jc.transpose(1, 2)
        U = torch.zeros(D * D, dtype=dt, device=dev).index_add_(
            0, (dof[:, :, None] * D + dof[:, None, :]).reshape(-1),
            mm(JcT, Jc).reshape(-1)).reshape(D, D)
        V = torch.zeros(P, 3, 3, dtype=dt, device=dev).index_add_(
            0, pt, mm(Jp.transpose(1, 2), Jp))
        W = mm(JcT, Jp)                                            # (N,9,3)
        U = U + lam * torch.diag(torch.diagonal(U))
        V = V + lam * torch.diag_embed(torch.diagonal(V, dim1=1, dim2=2)
                                       .clamp_min(1e-12))
        Vinv = torch.linalg.inv(V)
        B = mm(W, Vinv[pt])                                        # (N,9,3)
        S = U.reshape(-1)
        for a in range(0, pi.numel(), PAIR_CHUNK):
            i, j = pi[a:a + PAIR_CHUNK], pj[a:a + PAIR_CHUNK]
            S = S.index_add(0, (dof[i][:, :, None] * D
                                + dof[j][:, None, :]).reshape(-1),
                            -mm(B[i], W[j].transpose(1, 2)).reshape(-1))
        S = S.reshape(D, D)
        rhs = -g_c + torch.zeros(D, dtype=dt, device=dev).index_add_(
            0, dof.reshape(-1), mm(B, g_p[pt][:, :, None]).reshape(-1))
        Sf = S[fidx][:, fidx]
        L, bad = torch.linalg.cholesky_ex(0.5 * (Sf + Sf.T))
        dx = torch.zeros(D, dtype=dt, device=dev)
        if int(bad) == 0:
            dx[fidx] = torch.cholesky_solve(rhs[fidx, None], L)[:, 0]
            Et = torch.zeros(P, 3, dtype=dt, device=dev).index_add_(
                0, pt, mm(W.transpose(1, 2), dx[dof][:, :, None])[:, :, 0])
            dp = -mm(Vinv, (g_p + Et)[:, :, None])[:, :, 0]
            cand = (poses + dx[:6 * C].reshape(C, 6), intr + dx[6 * C:],
                    points + dp)
            new = cost(obs, *cand, delta, mm)
        else:
            new = torch.tensor(math.inf)
        if math.isfinite(float(new)) and float(new) < float(cur):
            rel = (float(cur) - float(new)) / max(float(cur), 1e-30)
            poses, intr, points = cand
            cur = new
            lam = max(lam / lambda_down, lambda_floor)
            rejections = 0
            newton = newton or rel < NEWTON_REL
            if rel < rtol:
                break
        else:
            lam = min(lam * 4, 1e10)
            rejections += 1
            if rejections >= max_rejections:
                break
    info.update(cost=float(cur), iterations=it)
    return poses, intr, points, info


def gaps(obs, prog, ref, delta, gauge: int, reported_cost: float):
    """The numbers that judge a solve.  `prog` and `ref` are (poses, intr,
    points) of the program and of the reference optimum; the cameras and
    points are compared after the scale about the gauge camera's centre
    that the solve leaves free.  Every number is computed in float64."""
    P = [x.to(torch.float64) for x in prog]
    Q = [x.to(torch.float64) for x in ref]
    c_prog = cost(obs, *P, delta)
    c_ref = cost(obs, *Q, delta)
    Rp, Rq = geometry.rotation(P[0][:, :3]), geometry.rotation(Q[0][:, :3])
    # the angle between two rotations, 2 asin(|Rp - Rq|_F / sqrt(8))
    ang = 2 * torch.asin(((Rp - Rq).flatten(1).norm(dim=1)
                          / math.sqrt(8)).clamp(max=1.0))
    centre_p = -(Rp.transpose(1, 2) @ P[0][:, 3:, None])[:, :, 0]
    centre_q = -(Rq.transpose(1, 2) @ Q[0][:, 3:, None])[:, :, 0]
    o = centre_q[gauge]
    a, b = centre_p - o, centre_q - o
    s = (a * b).sum() / (a * a).sum().clamp_min(1e-30)
    pts = (P[2] - o) * s + o - Q[2]
    return {
        "cost_excess": float((c_prog - c_ref) / c_ref),
        "cost_report_gap": abs(reported_cost - float(c_prog)) / float(c_prog),
        "rot_gap_mdeg": float(torch.rad2deg(ang).max()) * 1e3,
        "center_gap_mm": float((a * s - b).norm(dim=1).max()) * 1e3,
        "point_gap_mm": float(pts.norm(dim=1).median()) * 1e3,
        "focal_gap_ppm": float(abs(P[1][0] - Q[1][0]) / Q[1][0]) * 1e6,
    }
