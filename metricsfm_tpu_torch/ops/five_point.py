"""Nister 5-point essential-matrix minimal solver, batched.

Counterpart of metricsfm_tpu/ops/five_point.py (the reference's
SfM/src/orientation/essential_matrix_five_point.{h,cc}: Gauss-Jordan on
the 10x20 cubic-constraint system + a degree-10 polynomial):

* The 4-dim nullspace of the 5x9 epipolar system comes from a full SVD.
* The 10 cubic constraints (det(E) = 0 and the 9 trace constraints
  2 E E^T E - tr(E E^T) E = 0) are expanded over the 20 monomials of
  (x, y, z) as dense coefficient tensors: a product of polynomials is an
  outer product folded onto the product's monomials by a constant 0/1
  tensor, so the whole expansion is a dozen batched einsums.
* Elimination: solve A[:, :10] X = A[:, 10:] (one 10x10 solve), then
  Nister's 3x3 determinant of z-polynomials gives the degree-10
  polynomial, whose real roots come from sign-change bracketing and
  bisection (polynomial.real_roots_bracketed).
* x, y follow by least squares from the three rows at each root, and four
  Gauss-Newton steps on the 10 original constraints polish (x, y, z) in
  f32.
* All <= 10 candidates are returned with a validity mask, at fixed
  shapes, so RANSAC scores every candidate of every sample at once.

Everything broadcasts over leading axes (hypotheses).  Sampling follows
ops/ransac: a torch.Generator, or injected samples (`sample_idx`).
"""
from __future__ import annotations

import itertools

import torch

from . import epipolar, polynomial
from .ransac import _gather_rows, _sample_indices

_EPS = 1e-12

# Monomial order of the 10x20 constraint matrix (Nister's order):
# first 10 (eliminated):  x^3, y^3, x^2 y, x y^2, x^2 z, x^2, y^2 z, y^2, x y z, x y
# last 10 (kept):         x z^2, x z, x, y z^2, y z, y, z^3, z^2, z, 1
_MONOMIALS = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
# degree <= 1 (the nullspace combination x B0 + y B1 + z B2 + B3) and
# degree <= 2 monomials
_LINEAR = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_QUADRATIC = [e for e in itertools.product(range(3), repeat=3)
              if sum(e) <= 2]


def _fold(left, right, out):
    """0/1 tensor (len(left), len(right), len(out)) mapping a pair of
    monomials to their product's slot in `out`."""
    index = {m: i for i, m in enumerate(out)}
    T = torch.zeros(len(left), len(right), len(out))
    for a, ma in enumerate(left):
        for b, mb in enumerate(right):
            T[a, b, index[tuple(p + q for p, q in zip(ma, mb))]] = 1.0
    return T


_FOLD_11 = _fold(_LINEAR, _LINEAR, _QUADRATIC)        # (4, 4, 10)
_FOLD_21 = _fold(_QUADRATIC, _LINEAR, _MONOMIALS)     # (10, 4, 20)


def _nullspace4(norm1, norm2):
    """4 basis E's spanning the nullspace of the 5x9 epipolar system.

    norm1/norm2: (..., 5, 2) K-normalized correspondences, x2^T E x1 = 0.
    Returns (..., 4, 3, 3).
    """
    x1, y1 = norm1[..., 0], norm1[..., 1]
    x2, y2 = norm2[..., 0], norm2[..., 1]
    ones = torch.ones_like(x1)
    Q = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     ones], dim=-1)                       # (..., 5, 9)
    # full SVD (eigh of Q^T Q would square the condition number): right
    # singular vectors 5..8 span the nullspace
    _, _, Vt = torch.linalg.svd(Q, full_matrices=True)
    return Vt[..., 5:9, :].reshape(*Q.shape[:-2], 4, 3, 3)


def _constraint_matrix(basis):
    """(..., 10, 20) coefficient matrix of the det + trace cubic
    constraints.  basis: (..., 4, 3, 3); E = x B0 + y B1 + z B2 + B3."""
    T11 = _FOLD_11.to(basis)
    T21 = _FOLD_21.to(basis)
    E = basis.movedim(-3, -1)                             # (..., 3, 3, 4)

    def mul11(a, b):                 # linear x linear -> quadratic
        return torch.einsum("...a,...b,abm->...m", a, b, T11)

    def mul21(q, a):                 # quadratic x linear -> cubic
        return torch.einsum("...m,...a,man->...n", q, a, T21)

    # det(E) by the first row's cofactors
    cof = torch.stack([
        mul11(E[..., 1, 1, :], E[..., 2, 2, :])
        - mul11(E[..., 1, 2, :], E[..., 2, 1, :]),
        mul11(E[..., 1, 0, :], E[..., 2, 2, :])
        - mul11(E[..., 1, 2, :], E[..., 2, 0, :]),
        mul11(E[..., 1, 0, :], E[..., 2, 1, :])
        - mul11(E[..., 1, 1, :], E[..., 2, 0, :])], dim=-2)   # (..., 3, 10)
    det = (mul21(cof[..., 0, :], E[..., 0, 0, :])
           - mul21(cof[..., 1, :], E[..., 0, 1, :])
           + mul21(cof[..., 2, :], E[..., 0, 2, :]))          # (..., 20)

    # 2 E E^T E - tr(E E^T) E = 0  (9 equations, row-major over (i, j))
    EEt = torch.einsum("...ika,...jkb,abm->...ijm", E, E, T11)  # (...,3,3,10)
    EEtE = torch.einsum("...ikm,...kja,man->...ijn", EEt, E, T21)
    tr = EEt[..., 0, 0, :] + EEt[..., 1, 1, :] + EEt[..., 2, 2, :]
    trE = torch.einsum("...m,...ija,man->...ijn", tr, E, T21)
    rows = 2.0 * EEtE - trE                                # (..., 3, 3, 20)
    return torch.cat([det[..., None, :],
                      rows.reshape(*rows.shape[:-3], 9, 20)], dim=-2)


def _polymul(a, b):
    """1-D polynomial products over leading axes, ascending coefficients."""
    la, lb = a.shape[-1], b.shape[-1]
    out = torch.zeros(a.shape[:-1] + (la + lb - 1,), dtype=a.dtype,
                      device=a.device)
    for i in range(la):
        out[..., i:i + lb] += a[..., i:i + 1] * b
    return out


def _pminus(a, b):
    n = max(a.shape[-1], b.shape[-1])
    pad = torch.nn.functional.pad
    return pad(a, (0, n - a.shape[-1])) - pad(b, (0, n - b.shape[-1]))


def _zrow(B, a, b):
    """Nister's row pair (a, b): row_a - z row_b over the kept monomials
    gives [px(z), py(z), p1(z)] . [x, y, 1] = 0, with px, py of degree 3
    and p1 of degree 4 (ascending), scaled so the largest coefficient is
    1 (the determinant's roots do not change, and O(1) coefficients keep
    f32 accuracy through the degree-10 products)."""
    def shift_combo(idxs):
        # sum_i (B[a, idxs[i]] - z B[b, idxs[i]]) z^(n-1-i)
        n = len(idxs)
        c = [torch.zeros_like(B[..., 0, 0]) for _ in range(n + 1)]
        for i, col in enumerate(idxs):
            p = n - 1 - i
            c[p] = c[p] + B[..., a, col]
            c[p + 1] = c[p + 1] - B[..., b, col]
        return torch.stack(c, dim=-1)

    px = shift_combo([0, 1, 2])
    py = shift_combo([3, 4, 5])
    p1 = shift_combo([6, 7, 8, 9])
    s = torch.clamp(torch.amax(torch.abs(torch.cat([px, py, p1], dim=-1)),
                               dim=-1, keepdim=True), min=_EPS)
    return px / s, py / s, p1 / s


def _polyval_asc(c, z):
    """c (..., n) ascending at z (..., k)."""
    return polynomial._poly_eval_real(c.flip(-1), z)


def _monomials(v, exps):
    """Monomials m_k = x^ex y^ey z^ez of v (..., 3) and their exact
    partials (no division: stable at 0).  Returns (..., 20), (..., 20, 3)."""
    vv = v[..., None, :]                                   # (..., 1, 3)
    pows = vv ** exps                                      # (..., 20, 3)
    pml = vv ** torch.clamp(exps - 1, min=0)
    m = pows[..., 0] * pows[..., 1] * pows[..., 2]
    dm = torch.stack([
        exps[:, 0] * pml[..., 0] * pows[..., 1] * pows[..., 2],
        exps[:, 1] * pml[..., 1] * pows[..., 0] * pows[..., 2],
        exps[:, 2] * pml[..., 2] * pows[..., 0] * pows[..., 1]], dim=-1)
    return m, dm


def essential_5pt(norm1, norm2):
    """All essential matrices fitting 5 K-normalized correspondences.

    Args:
      norm1, norm2: (..., 5, 2) correspondences with x2^T E x1 = 0.
    Returns:
      E: (..., 10, 3, 3) candidate essential matrices (unit Frobenius).
      valid: (..., 10) bool, True for candidates from real roots.
    """
    return essential_from_basis(_nullspace4(norm1, norm2))


def essential_from_basis(basis):
    """essential_5pt's candidates from a nullspace basis (..., 4, 3, 3) of
    the 5x9 epipolar system (any orthonormal basis of that space)."""
    dt, dev = basis.dtype, basis.device
    A = _constraint_matrix(basis)                          # (..., 10, 20)
    eye10 = torch.eye(10, dtype=dt, device=dev)
    B = torch.linalg.solve(A[..., :10] + 1e-14 * eye10, A[..., 10:])

    # Nister rows: (4,5) = (x^2 z, x^2), (6,7) = (y^2 z, y^2),
    # (8,9) = (x y z, x y)
    P = [_zrow(B, 4, 5), _zrow(B, 6, 7), _zrow(B, 8, 9)]
    # det of [[px0, py0, p10], [px1, py1, p11], [px2, py2, p12]] by
    # cofactor expansion along the first row
    m01 = _pminus(_polymul(P[1][0], P[2][1]), _polymul(P[2][0], P[1][1]))
    m02 = _pminus(_polymul(P[1][0], P[2][2]), _polymul(P[2][0], P[1][2]))
    m12 = _pminus(_polymul(P[1][1], P[2][2]), _polymul(P[2][1], P[1][2]))
    det = _pminus(_polymul(P[0][0], m12), _polymul(P[0][1], m02))
    det = _pminus(det, -_polymul(P[0][2], m01))            # (..., 11)
    z, is_real = polynomial.real_roots_bracketed(det.flip(-1), max_roots=10,
                                                 grid_size=8192)

    # x, y by least squares over the three rows at each root:
    # [px py] [x y]^T = -p1
    rows = [[_polyval_asc(P[i][k], z) for k in range(3)] for i in range(3)]
    Am = torch.stack([torch.stack([rows[i][0], rows[i][1]], dim=-1)
                      for i in range(3)], dim=-2)          # (..., 10, 3, 2)
    bm = -torch.stack([rows[i][2] for i in range(3)], dim=-1)  # (..., 10, 3)
    AtA = Am.transpose(-1, -2) @ Am + 1e-12 * torch.eye(2, dtype=dt,
                                                        device=dev)
    xy = torch.linalg.solve(AtA, (Am.transpose(-1, -2)
                                  @ bm[..., None]))[..., 0]

    # Gauss-Newton polish of (x, y, z) on the 10 constraints A m(x,y,z) = 0:
    # recovers the f32 accuracy lost through elimination and determinant
    exps = torch.tensor(_MONOMIALS, dtype=dt, device=dev)  # (20, 3)
    A10 = A[..., None, :, :]                               # (..., 1, 10, 20)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    v = torch.stack([xy[..., 0], xy[..., 1], z], dim=-1)   # (..., 10, 3)
    for _ in range(4):
        m, dm = _monomials(v, exps)
        r = (A10 @ m[..., None])[..., 0]                   # (..., 10, 10)
        J = A10 @ dm                                       # (..., 10, 10, 3)
        JtJ = J.transpose(-1, -2) @ J + 1e-10 * eye3
        step = torch.linalg.solve(JtJ, (J.transpose(-1, -2)
                                        @ r[..., None]))[..., 0]
        v = v - step

    b = basis[..., None, :, :, :]                          # (..., 1, 4, 3, 3)
    c = v[..., None, None]                                 # (..., 10, 3, 1, 1)
    Es = (c[..., 0, :, :] * b[..., 0, :, :] + c[..., 1, :, :] * b[..., 1, :, :]
          + c[..., 2, :, :] * b[..., 2, :, :] + b[..., 3, :, :])
    nrm = torch.linalg.vector_norm(Es.flatten(-2), dim=-1)
    return Es / torch.clamp(nrm, min=_EPS)[..., None, None], is_real


def essential_ransac_5pt(norm1, norm2, generator=None, mask=None,
                         num_hypotheses: int = 128, th_sampson: float = 1e-5,
                         min_inliers: int = 15, refit_rounds: int = 2,
                         sample_idx=None):
    """Batched 5-point E-RANSAC (reference essential_matrix_five_point.cc:
    30-93).

    Each of the `num_hypotheses` minimal samples yields <= 10 candidate
    E's; all of them are Sampson-scored against every correspondence at
    once.  The winner is polished by masked 8-point refits (projected onto
    the essential manifold).

    norm1, norm2: (N, 2) K-normalized correspondences; mask (N,) valid
    rows; sample_idx: optional (H, 5) injected minimal samples (replaces
    the draw from `generator`).
    Returns dict: E, inlier_mask, n_inliers, ok.
    """
    essential_ransac_5pt.calls += 1
    N = norm1.shape[0]
    m = torch.ones((N,), dtype=torch.bool, device=norm1.device) \
        if mask is None else mask.bool()
    idx = sample_idx if sample_idx is not None else \
        _sample_indices(generator, m, num_hypotheses, 5)
    idx = idx.long()

    Es, valid = essential_5pt(_gather_rows(norm1, idx),
                              _gather_rows(norm2, idx))
    Es = Es.reshape(-1, 3, 3)                              # (H*10, 3, 3)
    valid = valid.reshape(-1)
    d = epipolar.sampson_distance(Es, norm1, norm2)        # (H*10, N)
    inl = (d < th_sampson) & m & valid[:, None]
    best = int(torch.argmax(torch.sum(inl, dim=-1)))

    inlier_mask = inl[best]
    E = Es[best]
    for _ in range(refit_rounds):
        w = inlier_mask.to(norm1.dtype)
        E = epipolar.essential_8pt(norm1, norm2, weights=w)
        new = (epipolar.sampson_distance(E, norm1, norm2) < th_sampson) & m
        keep = torch.sum(new) >= torch.clamp(torch.sum(inlier_mask) // 2,
                                             min=5)
        inlier_mask = torch.where(keep, new, inlier_mask)
    n = torch.sum(inlier_mask)
    E = torch.where(n >= 8, E, Es[best])
    return {"E": E, "inlier_mask": inlier_mask, "n_inliers": n,
            "ok": n >= min_inliers}


essential_ransac_5pt.calls = 0    # calls since the caller last reset it


def relative_pose_known_focal_5pt(pts1, pts2, f1, f2, generator=None,
                                  mask=None, num_hypotheses: int = 128,
                                  th_sampson_px: float = 2.0,
                                  sample_idx=None):
    """Calibrated relative pose via 5-point RANSAC + cheirality
    decomposition: the planar-safe alternative to
    epipolar.relative_pose_known_focal, as the reference's calibrated path
    (relative_pose_estimation.cc:90-120 -> essential_matrix_five_point.cc).
    `th_sampson_px` becomes normalized units through the mean focal.
    Returns dict with R, t, E, n_front, inlier_mask, n_inliers, ok.
    """
    n1 = pts1 / f1
    n2 = pts2 / f2
    fm = 0.5 * (f1 + f2)
    th = (th_sampson_px / fm) ** 2
    out = essential_ransac_5pt(n1, n2, generator, mask=mask,
                               num_hypotheses=num_hypotheses, th_sampson=th,
                               sample_idx=sample_idx)
    R, t, votes = epipolar.decompose_essential(
        out["E"], n1, n2, mask=out["inlier_mask"])
    return {"R": R, "t": t, "E": out["E"], "n_front": votes,
            "inlier_mask": out["inlier_mask"], "n_inliers": out["n_inliers"],
            "ok": out["ok"]}
