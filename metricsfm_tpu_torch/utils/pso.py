"""Particle-swarm optimization (compiled-in capability of the reference).

Counterpart of metricsfm_tpu/utils/pso.py (re-design of
SfM/src/utils/simpsolib.{h,cpp} + simtstlib: a generic PSO minimizer the
reference links but wires to no pipeline).
"""
from __future__ import annotations

from typing import Optional

import torch


def pso_minimize(fn, lo, hi, generator: Optional[torch.Generator] = None,
                 n_particles: int = 64, iters: int = 100,
                 inertia: float = 0.72, c_personal: float = 1.49,
                 c_global: float = 1.49, draws=None):
    """Minimize fn over the box [lo, hi], on the device of lo.

    fn: vectorized objective mapping (N, D) -> (N,); lo, hi: (D,) bounds.
    draws: optional injected uniforms in [0, 1) in place of the draws from
      `generator`: {"x0": (P, D), "v0": (P, D), "r1": (iters, P, D),
      "r2": (iters, P, D)}.  Positions start at x0 (hi - lo) + lo, speeds
      at (v0 - 0.5) (hi - lo) 0.1.
    Returns (best_x (D,), best_val ()).
    """
    D = lo.shape[0]
    shape = (n_particles, D)

    def uniform(name, i=None):
        if draws is not None:
            u = draws[name] if i is None else draws[name][i]
            return u.to(device=lo.device, dtype=lo.dtype)
        return torch.rand(shape, generator=generator, device=lo.device,
                          dtype=lo.dtype)

    x = uniform("x0") * (hi - lo) + lo
    v = (uniform("v0") - 0.5) * (hi - lo) * 0.1
    pbest = x
    pval = fn(x)
    gi = torch.argmin(pval)
    gbest, gval = x[gi], pval[gi]
    for i in range(iters):
        r1 = uniform("r1", i)
        r2 = uniform("r2", i)
        v = inertia * v + c_personal * r1 * (pbest - x) \
            + c_global * r2 * (gbest[None] - x)
        x = torch.clamp(x + v, lo, hi)
        val = fn(x)
        better = val < pval
        pbest = torch.where(better[:, None], x, pbest)
        pval = torch.where(better, val, pval)
        gi = torch.argmin(pval)
        upd = pval[gi] < gval
        gbest = torch.where(upd, pbest[gi], gbest)
        gval = torch.where(upd, pval[gi], gval)
    return gbest, gval
