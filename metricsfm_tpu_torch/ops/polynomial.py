"""Polynomial root finding with batched real arithmetic.

Counterpart of metricsfm_tpu/ops/polynomial.py (replacing the reference's
companion-matrix root finders, SfM/src/utils/polynomial.{h,cc}): a fixed
iteration count Durand-Kerner (Weierstrass) method followed by
Ehrlich-Aberth polishing, with complex numbers as (re, im) pairs of real
tensors, batched over leading axes; and, for the calibrated 5-point
solver's degree-10 polynomial, a sign-change bracketing solver
(real_roots_bracketed) that cannot stall on clustered roots.
"""
from __future__ import annotations

import math

import torch

_EPS = 1e-20


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi):
    d = torch.clamp(br * br + bi * bi, min=_EPS)
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def _poly_eval(coeffs, zr, zi):
    """coeffs (..., d+1) descending; z (..., k) complex -> p(z)."""
    pr = torch.zeros_like(zr) + coeffs[..., 0:1]
    pi = torch.zeros_like(zi)
    d = coeffs.shape[-1] - 1
    for k in range(1, d + 1):
        pr, pi = _cmul(pr, pi, zr, zi)
        pr = pr + coeffs[..., k:k + 1]
    return pr, pi


def _poly_eval_deriv(coeffs, zr, zi):
    """p'(z) for descending-order coeffs at complex z."""
    d = coeffs.shape[-1] - 1
    powers = torch.arange(d, 0, -1, dtype=coeffs.dtype, device=coeffs.device)
    dcoeffs = coeffs[..., :-1] * powers
    pr = torch.zeros_like(zr) + dcoeffs[..., 0:1]
    pi = torch.zeros_like(zi)
    for k in range(1, d):
        pr, pi = _cmul(pr, pi, zr, zi)
        pr = pr + dcoeffs[..., k:k + 1]
    return pr, pi


def roots_durand_kerner(coeffs, iters: int = 60, newton_iters: int = 12):
    """All (complex) roots of real-coefficient polynomials.

    coeffs (..., d+1) descending.  Returns (roots_re, roots_im), (..., d).
    """
    d = coeffs.shape[-1] - 1
    dt, dev = coeffs.dtype, coeffs.device
    lead = coeffs[..., 0:1]
    lead = torch.where(torch.abs(lead) < 1e-12,
                       torch.where(lead < 0, -1e-12, 1e-12).to(dt), lead)
    monic = coeffs / lead

    # scale roots into O(1): z = s*w with s = max|a_k|^(1/k)
    powers = torch.arange(1, d + 1, dtype=dt, device=dev)
    mags = torch.abs(monic[..., 1:])
    s = torch.amax(mags ** (1.0 / powers), dim=-1, keepdim=True)
    s = torch.clamp(s, min=1e-6)
    scaled = monic * (s ** -torch.arange(0, d + 1, dtype=dt, device=dev))

    # Bini-style initial guesses over the Cauchy-bound annulus, with
    # non-symmetric angles
    a_last = torch.abs(scaled[..., -1:])
    a_mid = torch.amax(torch.abs(scaled[..., 1:]), dim=-1, keepdim=True)
    r_hi = 1.0 + torch.amax(torch.abs(scaled), dim=-1, keepdim=True)
    r_lo = torch.clamp(a_last / (a_last + torch.clamp(a_mid, min=1.0)),
                       min=1e-3)
    frac = torch.arange(d, dtype=dt, device=dev) / max(d - 1, 1)
    radii = r_lo * (r_hi / r_lo) ** frac
    angles = torch.arange(d, dtype=dt, device=dev) * (2.0 * math.pi * 0.382) \
        + 0.4
    zr = radii * torch.cos(angles)
    zi = radii * torch.sin(angles)
    eye = torch.eye(d, dtype=dt, device=dev)

    for _ in range(iters):                       # Weierstrass
        pr, pi = _poly_eval(scaled, zr, zi)
        dr = zr[..., :, None] - zr[..., None, :] + eye
        di = zi[..., :, None] - zi[..., None, :]
        qr = torch.ones_like(zr)
        qi = torch.zeros_like(zi)
        for j in range(d):
            qr, qi = _cmul(qr, qi, dr[..., j], di[..., j])
        wr, wi = _cdiv(pr, pi, qr, qi)
        zr, zi = zr - wr, zi - wi

    for _ in range(newton_iters):                # Ehrlich-Aberth
        pr, pi = _poly_eval(scaled, zr, zi)
        dpr, dpi = _poly_eval_deriv(scaled, zr, zi)
        wr, wi = _cdiv(pr, pi, dpr, dpi)
        dr = zr[..., :, None] - zr[..., None, :] + eye
        di = zi[..., :, None] - zi[..., None, :]
        den = torch.clamp(dr * dr + di * di, min=_EPS)
        sr = torch.sum(dr / den * (1.0 - eye), dim=-1)
        si = torch.sum(-di / den * (1.0 - eye), dim=-1)
        br, bi = _cmul(wr, wi, sr, si)
        stepr, stepi = _cdiv(wr, wi, 1.0 - br, -bi)
        zr, zi = zr - stepr, zi - stepi
    return zr * s, zi * s


def real_roots(coeffs, iters: int = 60, imag_tol: float = 1e-4,
               newton_iters: int = 12):
    """Real roots with validity mask: (roots (..., d), is_real (..., d))."""
    zr, zi = roots_durand_kerner(coeffs, iters, newton_iters)
    return zr, torch.abs(zi) < imag_tol * (1.0 + torch.abs(zr))


def quartic_real_roots(coeffs, iters: int = 60):
    """Real roots of quartics (descending coeffs, shape (..., 5))."""
    return real_roots(coeffs, iters)


def _poly_eval_real(coeffs, x):
    """Horner for real x: coeffs (..., d+1) descending, x (..., k)."""
    p = torch.zeros_like(x) + coeffs[..., 0:1]
    for k in range(1, coeffs.shape[-1]):
        p = p * x + coeffs[..., k:k + 1]
    return p


def real_roots_bracketed(coeffs, max_roots: int, grid_size: int = 2048,
                         bisect_iters: int = 60, newton_iters: int = 3):
    """All simple real roots via sign-change bracketing + bisection.

    p is evaluated on a cubically spaced symmetric grid spanning the
    Fujiwara root bound; the first `max_roots` sign changes are bisected a
    fixed number of times, then Newton-polished.  Roots of even
    multiplicity (no sign change) are not found: harmless inside RANSAC,
    where tangent configurations have measure zero.

    Args:
      coeffs: (..., d+1) descending real coefficients.
      max_roots: number of root slots returned (>= expected real roots).
    Returns:
      (roots (..., max_roots), valid (..., max_roots) bool).
    """
    dt, dev = coeffs.dtype, coeffs.device
    lead = coeffs[..., 0:1]
    lead = torch.where(torch.abs(lead) < 1e-14,
                       torch.where(lead < 0, -1e-14, 1e-14).to(dt), lead)
    monic = coeffs / lead
    # Fujiwara bound R <= 2 max_k |a_k|^(1/k), the last term halved: far
    # tighter than Cauchy's when coefficients span decades, which in f32
    # keeps grid resolution near the roots
    d = monic.shape[-1] - 1
    kk = torch.arange(1, d + 1, dtype=dt, device=dev)
    mags = torch.abs(monic[..., 1:])
    mags = torch.cat([mags[..., :-1], 0.5 * mags[..., -1:]], dim=-1)
    R = 2.0 * torch.amax(mags ** (1.0 / kk), dim=-1, keepdim=True)
    R = torch.clamp(R, min=1e-6)                              # (..., 1)

    u = torch.linspace(-1.0, 1.0, grid_size, dtype=dt, device=dev)
    x = R * (u * u * u)                             # dense near 0, covers +-R
    s = torch.sign(_poly_eval_real(monic, x))
    s = torch.where(s == 0, 1.0, s)
    bracket = (s[..., :-1] * s[..., 1:]) < 0                  # (..., G-1)

    # the first max_roots brackets (by grid position)
    score = bracket.to(dt) * (2.0 - torch.arange(grid_size - 1, dtype=dt,
                                                 device=dev) / grid_size)
    idx = torch.topk(score, max_roots, dim=-1).indices
    valid = torch.gather(bracket, -1, idx)
    lo = torch.gather(x, -1, idx)
    hi = torch.gather(x, -1, idx + 1)
    plo = _poly_eval_real(monic, lo)
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        pm = _poly_eval_real(monic, mid)
        same = (torch.sign(pm) == torch.sign(plo)) | (pm == 0)
        lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
        plo = torch.where(same, pm, plo)
    root = 0.5 * (lo + hi)

    dmonic = monic[..., :-1] * torch.arange(d, 0, -1, dtype=dt, device=dev)
    for _ in range(newton_iters):
        pr = _poly_eval_real(monic, root)
        dr = _poly_eval_real(dmonic, root)
        dr = torch.where(torch.abs(dr) < 1e-30, 1e-30, dr)
        root = root - torch.maximum(torch.minimum(pr / dr, R), -R)
    return root, valid
