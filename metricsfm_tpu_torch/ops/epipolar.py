"""Two-view epipolar geometry: F/E estimation, focal recovery, decomposition.

Counterpart of metricsfm_tpu/ops/epipolar.py (the reference solvers
SfM/src/orientation/fundamental_matrix_eight_point.{h,cc},
relative_pose_from_fundamental_matrix.{h,cc},
relative_pose_from_essential_matrix.{h,cc}, relative_pose_estimation.{h,cc}).

* Convention: x2^T F x1 = 0 with homogeneous centered pixels x = (u, v, 1).
* Every function broadcasts over leading axes (hypotheses, pairs): the
  RANSAC hypothesis solves use the unrolled-Householder null vector and the
  adjugate rank-2 projection, which are plain batched arithmetic.
* Focal-from-F uses the linear Kruppa equations (centered principal
  points), replacing relative_pose_from_fundamental_matrix.cc:56-123.
"""
from __future__ import annotations

import math

import torch

from . import lie

_EPS = 1e-12


def _homog(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _matvec(M, v):
    """(..., n, m) @ (..., m) -> (..., n)."""
    return (M @ v[..., None])[..., 0]


def normalize_points(pts):
    """Hartley normalization: translate centroid to origin, mean dist sqrt(2).

    Returns (pts_n, T) with x_n = T x (homogeneous 3x3 T).
    """
    centroid = torch.mean(pts, dim=-2, keepdim=True)
    d = torch.linalg.norm(pts - centroid, dim=-1)
    scale = math.sqrt(2.0) / torch.clamp(torch.mean(d, dim=-1), min=_EPS)
    cx, cy = centroid[..., 0, 0], centroid[..., 0, 1]
    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * cx], dim=-1),
        torch.stack([zero, scale, -scale * cy], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    pts_n = (pts - centroid) * scale[..., None, None]
    return pts_n, T


def _smallest_right_singular(A):
    """Unit vector minimizing |A v| via eigh of A^T A."""
    AtA = A.transpose(-1, -2) @ A
    _, V = torch.linalg.eigh(AtA)
    return V[..., :, 0]


def _nullvec_minimal(A):
    """Exact null vector of a MINIMAL (..., k, k+1) linear system via k
    unrolled Householder reflections (QR of A^T; the null vector is the
    last column of Q).  Pure batched arithmetic — no per-matrix LAPACK
    calls.  Rank-deficient (degenerate) samples give an arbitrary
    null-space vector, which consensus scoring discards."""
    k, k1 = A.shape[-2], A.shape[-1]
    R = A.transpose(-1, -2)                            # (..., k+1, k)
    rows = torch.arange(k1, device=A.device)
    vs = []
    for c in range(k):
        x = R[..., :, c] * (rows >= c).to(A.dtype)
        alpha = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True) + _EPS)
        sign = torch.where(x[..., c:c + 1] >= 0, 1.0, -1.0).to(A.dtype)
        v = x + sign * alpha * (rows == c).to(A.dtype)
        v = v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                            min=_EPS)
        vs.append(v)
        R = R - 2.0 * v[..., :, None] * torch.sum(
            v[..., :, None] * R, dim=-2, keepdim=True)
    # null vector = Q e_{k+1} = H_1 ... H_k e_{k+1}
    u = torch.zeros(A.shape[:-2] + (k1,), dtype=A.dtype, device=A.device)
    u[..., k1 - 1] = 1.0
    for v in reversed(vs):
        u = u - 2.0 * v * torch.sum(v * u, dim=-1, keepdim=True)
    return u


def _rank2_project(F):
    """Zero the smallest singular value of (..., 3, 3) F without an SVD.

    v3 (smallest right-singular vector) from the ADJUGATE: its columns are
    cross products of row pairs of F and align with v3 as s3 -> 0; take
    the largest.  Then F - (F v3) v3^T removes that input direction (equal
    to U diag(s1, s2, 0) V^T up to O(s3/s2), which consensus absorbs)."""
    r0, r1, r2 = F[..., 0, :], F[..., 1, :], F[..., 2, :]
    c01 = _cross(r0, r1)
    c02 = _cross(r0, r2)
    c12 = _cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1, keepdim=True)
    n02 = torch.sum(c02 * c02, dim=-1, keepdim=True)
    n12 = torch.sum(c12 * c12, dim=-1, keepdim=True)
    best = torch.where(n01 >= torch.maximum(n02, n12), c01,
                       torch.where(n02 >= n12, c02, c12))
    v3 = best / torch.clamp(torch.linalg.norm(best, dim=-1, keepdim=True),
                            min=_EPS)
    Fv = _matvec(F, v3)
    return F - Fv[..., :, None] * v3[..., None, :]


def fundamental_8pt(pts1, pts2, weights=None, exact: bool = True):
    """Hartley-normalized 8-point fundamental matrix.

    pts1, pts2 (..., N, 2) centered pixels, N >= 8; weights (..., N) row
    weights (0 masks a row).  exact=True: eigh/SVD; exact=False: unrolled
    Householder null vector + adjugate rank-2 projection (minimal N == 8
    samples only; larger systems use the exact path).
    Returns F (..., 3, 3), rank 2, |F| = 1.
    """
    p1n, T1 = normalize_points(pts1)
    p2n, T2 = normalize_points(pts2)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    ones = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones],
                    dim=-1)  # (..., N, 9)
    if weights is not None:
        A = A * weights[..., None]
    exact = exact or pts1.shape[-2] != 8
    f = _smallest_right_singular(A) if exact else _nullvec_minimal(A)
    F = f.reshape(*f.shape[:-1], 3, 3)
    if exact:
        U, S, Vt = torch.linalg.svd(F)
        S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
        F = (U * S[..., None, :]) @ Vt
    else:
        F = _rank2_project(F)
    # denormalize: F_px = T2^T F T1
    F = T2.transpose(-1, -2) @ F @ T1
    norm = torch.linalg.norm(F.reshape(*F.shape[:-2], 9), dim=-1)
    return F / torch.clamp(norm[..., None, None], min=_EPS)


def essential_8pt(norm1, norm2, weights=None, exact: bool = True):
    """Essential matrix from >= 8 K-normalized correspondences: 8-point
    system + projection onto singular values (1, 1, 0).  exact=False
    returns the rank-2 F without the manifold projection."""
    F = fundamental_8pt(norm1, norm2, weights, exact=exact)
    if not exact:
        return F
    U, S, Vt = torch.linalg.svd(F)
    s = (S[..., 0] + S[..., 1]) * 0.5
    S_e = torch.stack([s, s, torch.zeros_like(s)], dim=-1)
    return (U * S_e[..., None, :]) @ Vt


def _fx(F, pts1, pts2):
    """(F x1, F^T x2) for homogeneous centered points, (..., N, 3) each."""
    x1 = _homog(pts1)
    x2 = _homog(pts2)
    Fx1 = x1 @ F.transpose(-1, -2)
    Ftx2 = x2 @ F
    return x1, x2, Fx1, Ftx2


def sampson_distance(F, pts1, pts2):
    """First-order geometric (Sampson) distance, (..., N)."""
    x1, x2, Fx1, Ftx2 = _fx(F, pts1, pts2)
    num = torch.sum(x2 * Fx1, dim=-1) ** 2
    den = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
           + Ftx2[..., 1] ** 2)
    return num / torch.clamp(den, min=_EPS)


def epipolar_distance(F, pts1, pts2):
    """Symmetric point-to-epipolar-line distance in px, (..., N)
    (fine_matching_graph.cc:137-147, geo_verification.cc:60-79).  F
    (..., 3, 3) broadcasts against the points' leading axes."""
    x1, x2, Fx1, Ftx2 = _fx(F, pts1, pts2)
    val = torch.abs(torch.sum(x2 * Fx1, dim=-1))
    d1 = val / torch.clamp(torch.sqrt(Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2),
                           min=_EPS)
    d2 = val / torch.clamp(torch.sqrt(Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2),
                           min=_EPS)
    return 0.5 * (d1 + d2)


def focals_from_fundamental(F, scale_hint=1000.0):
    """Focal lengths from F via the linear Kruppa equations (centered pp):
    F w1* F^T = lam [e2]x w2* [e2]x^T with wi* = diag(fi^2, fi^2, 1) is
    linear in (f1^2, lam f2^2, lam) — a 6x3 least-squares solve over the
    upper triangle.  `scale_hint` (~expected focal, px) keeps the unknowns
    O(1).  Returns (f1, f2, valid); valid is False when a squared focal
    comes out non-positive."""
    dt, dev = F.dtype, F.device
    s = torch.as_tensor(scale_hint, dtype=dt, device=dev)
    D = torch.stack([s, s, torch.ones_like(s)], dim=-1)
    F = F * D[..., :, None] * D[..., None, :]
    F = F / torch.clamp(torch.linalg.norm(F, dim=(-2, -1), keepdim=True),
                        min=_EPS)

    p = torch.tensor([0.0, 0.0, 1.0], dtype=dt, device=dev)
    I2 = torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=dt, device=dev))
    Ft = F.transpose(-1, -2)
    e2 = _smallest_right_singular(Ft)            # epipole: F^T e2 = 0
    e2x = lie.hat(e2)
    e2xt = e2x.transpose(-1, -2)

    M1 = F @ I2 @ Ft
    M2 = e2x @ I2 @ e2xt
    v2 = e2x @ p
    M3 = v2[..., :, None] * v2[..., None, :]
    v0 = F @ p
    M0 = v0[..., :, None] * v0[..., None, :]

    iu0, iu1 = torch.triu_indices(3, 3, device=dev)
    A = torch.stack([M1[..., iu0, iu1], -M2[..., iu0, iu1],
                     -M3[..., iu0, iu1]], dim=-1)      # (..., 6, 3)
    b = -M0[..., iu0, iu1]                             # (..., 6)
    AtA = A.transpose(-1, -2) @ A
    Atb = _matvec(A.transpose(-1, -2), b)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    x = torch.linalg.solve(AtA + 1e-12 * eye3, Atb)
    f1s = x[..., 0]
    lam = x[..., 2]
    lam = torch.where(torch.abs(lam) < _EPS, _EPS, lam)
    f2s = x[..., 1] / lam
    valid = (f1s > 0) & (f2s > 0)
    f1 = torch.sqrt(torch.clamp(f1s, min=_EPS)) * s
    f2 = torch.sqrt(torch.clamp(f2s, min=_EPS)) * s
    return f1, f2, valid


def essential_from_fundamental(F, f1, f2):
    """E = K2^T F K1 with K = diag(f, f, 1)
    (relative_pose_from_fundamental_matrix.cc:125-136)."""
    K1 = torch.stack([f1, f1, torch.ones_like(f1)], dim=-1)
    K2 = torch.stack([f2, f2, torch.ones_like(f2)], dim=-1)
    return F * K2[..., :, None] * K1[..., None, :]


def _two_view_depths(R, t, norm1, norm2):
    """Depths of midpoint-triangulated points for cams [I|0] and [R|t]."""
    d1 = _homog(norm1)
    d1 = d1 / torch.linalg.norm(d1, dim=-1, keepdim=True)
    d2c = _homog(norm2)
    d2c = d2c / torch.linalg.norm(d2c, dim=-1, keepdim=True)
    d2 = d2c @ R                                   # R^T d2c per row
    c2 = -_matvec(R.transpose(-1, -2), t)
    b_ = torch.sum(d1 * d2, dim=-1)
    rhs1 = d1 @ c2
    rhs2 = d2 @ c2
    det = 1.0 - b_ * b_
    det = torch.where(torch.abs(det) < _EPS, _EPS, det)
    s = (rhs1 - b_ * rhs2) / det                   # depth along ray 1
    X = d1 * s[..., None]
    z1 = s * d1[..., 2]
    Xc2 = X @ R.transpose(-1, -2) + t
    return z1, Xc2[..., 2]


def decompose_essential(E, norm1, norm2, mask=None):
    """E (3, 3) -> (R, t, n_front) by SVD + cheirality voting over the four
    candidates (relative_pose_from_essential_matrix.h:35-40); |t| = 1 and
    x2 ~ R x1 + t."""
    U, _, Vt = torch.linalg.svd(E)
    d = torch.linalg.det(U @ Vt)
    Vt = Vt * torch.where(d < 0, -1.0, 1.0).to(E.dtype)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]
    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    votes = []
    for R, tt in cands:
        z1, z2 = _two_view_depths(R, tt, norm1, norm2)
        ok = (z1 > 0) & (z2 > 0)
        if mask is not None:
            ok = ok & (mask > 0)
        votes.append(torch.sum(ok.to(torch.int32)))
    votes = torch.stack(votes)
    best = int(torch.argmax(votes))
    return cands[best][0], cands[best][1], votes[best]


def relative_pose_known_focal(pts1, pts2, f1, f2, weights=None, mask=None):
    """Calibrated relative pose: normalize by focal, 8pt-E, decompose
    (relative_pose_estimation.cc:90-120).  Returns R, t, E, n_front."""
    n1 = pts1 / f1
    n2 = pts2 / f2
    E = essential_8pt(n1, n2, weights)
    R, t, votes = decompose_essential(E, n1, n2, mask)
    return {"R": R, "t": t, "E": E, "n_front": votes}


def relative_pose_unknown_focal(pts1, pts2, weights=None, mask=None,
                                f_hint=None):
    """Uncalibrated path: 8pt-F -> Kruppa focals -> E -> decompose
    (relative_pose_estimation.cc:29-83).  `f_hint` defaults to 3x the pixel
    spread.  Returns R, t, f1, f2, F, E, n_front, valid."""
    F = fundamental_8pt(pts1, pts2, weights)
    if f_hint is None:
        f_hint = 3.0 * torch.maximum(torch.amax(torch.abs(pts1)),
                                     torch.amax(torch.abs(pts2)))
    f1, f2, valid = focals_from_fundamental(F, f_hint)
    n1 = pts1 / f1
    n2 = pts2 / f2
    E = essential_from_fundamental(F, f1, f2)
    # re-project onto the essential manifold for stability
    U, S, Vt = torch.linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) * 0.5
    E = (U * torch.stack([s, s, torch.zeros_like(s)], dim=-1)[..., None, :]) @ Vt
    R, t, votes = decompose_essential(E, n1, n2, mask)
    return {"R": R, "t": t, "f1": f1, "f2": f2, "F": F, "E": E,
            "n_front": votes, "valid": valid}
