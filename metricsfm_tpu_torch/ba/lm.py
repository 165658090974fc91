"""Schur-complement Levenberg-Marquardt bundle adjuster.

Counterpart of metricsfm_tpu/ba/lm.py (replacing Ceres DENSE_SCHUR +
Huber + autodiff functors, SfM/src/optimizer.cc:44-135):

* Per-observation 2-vector residuals and Jacobians, scaled by the track
  weights, the mask and the robust weights, come from
  ``ops.ba_linearize.linearize``, which holds the kernel, its plain
  version (``vmap(jacfwd)``, the JAX package's composition) and the
  choice between them by device; here it is one call in the
  ba/lm/linearize span.
* Huber robustness is IRLS: residual/Jacobian rows scaled by sqrt(rho'(s)).
* Elimination: point blocks H_pp are (P, 3, 3) closed-form inverses.
  Both camera solvers open the same way (``_reduced_slots``): every
  slot's products (its JᵀJ blocks and rhs row, W, its Cholesky-folded U)
  and every point's inverse come from one call of
  ``ops.ba_reduce_slots.reduce_slots`` (its kernel on the card, its plain
  einsums on the CPU).  The dense path assembles the reduced camera
  system S (6C+3M dofs) from camera- and model-indexed sums of those rows
  and one (6C+3M, 3P) x (3P, 6C+3M) product for the Schur fill.
* Every sum over observation slots (or over triples sharing a camera)
  goes through ``ops.segsum.segment_sum`` with the plans of `BAPlans`,
  made once per solve (the index sets do not change across iterations):
  on the card one launch of the segsum kernel, which adds in a fixed
  order without atomics, so two solves on the same inputs give the same
  bits.  Masked slots are dropped from the plans.
* Mutability masks freeze dofs by zeroing their rows/cols and pinning the
  diagonal (optimizer.cc:86-125).
* The LM loop is a Python loop with accept/reject damping and one host
  read of the candidate cost per iteration.  The candidate (the points'
  back-substitution, the step's adds) and its robust reprojection cost
  come from one call of ``ops.ba_candidate_cost.candidate_cost`` (its
  kernel on the card, which adds the cost in a fixed order; its plain
  composition on the CPU), and so does the cost that opens each solve.
* cg_iterations > 0 solves the reduced camera system matrix-free by
  block-Jacobi PCG instead (used from sfm.th_cg_cameras cameras up): no
  (D, D) matrix and no O(P*C) factor, only O(P*V) per-track tensors.  The
  JAX package's lane-major layouts and one-hot reducers exist for the TPU;
  here slot sums go through the same segment sums, and the CG loop keeps an
  on-device "active" flag polled every few iterations instead of reading a
  host scalar per iteration.  With cg_forcing, the CG tolerance follows the
  inexact-Newton forcing sequence (Agarwal et al., "Bundle Adjustment in
  the Large"): eta starts at cg_eta0 and tightens to max(eta^1.5, cg_tol)
  on every accepted LM step.
* The camera-indexed prior terms (GPS anchors, pose priors, GPS triples;
  ba/problem.py) add their Gauss-Newton blocks to the reduced system: to
  S in the dense path, to the matvec and the block-Jacobi preconditioner
  in the PCG path.  Their Jacobians come from ``torch.func.jacfwd``.  A
  solve whose prior weights are all zero skips them, in the system and in
  the cost (one host check per solve; their cost is then exactly +0).
* Track sharding (parallel/sharded_ba): the functions take an optional
  `reduce`, the sum over the ranks of a track-sharded problem (None: the
  identity, and the single-device path exactly as without it).  The sums
  go where the JAX package puts its psums: the track partials of the
  reduced system (S and rhs in the dense path; rhs and the block-Jacobi
  blocks once a solve, and the (D,) track matvec once a CG iteration, in
  the PCG path) before the prior terms and the damping are added, and the
  robust track cost before the prior costs are added.  Everything after a
  sum (the camera solve, the CG vectors, lambda, the accept test and the
  CG poll) is replicated and read from reduced values only, so every rank
  takes the same branch.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap

from ..ops import (ba_candidate_cost, ba_linearize, ba_reduce_slots,
                   projection)
from ..ops.ba_reduce_slots import inv3x3
from ..ops.segsum import SegmentPlan, make_plan, segment_sum
from ..utils.tracing import span
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
    # > 0: solve the reduced camera system by matrix-free block-Jacobi PCG
    # with at most this many CG iterations per LM step (dense Cholesky at 0)
    cg_iterations: int = 0
    cg_tol: float = 1e-5
    # inexact-Newton forcing sequence: the CG relative tolerance starts at
    # cg_eta0 and tightens to max(eta^1.5, cg_tol) on accepted LM steps
    cg_forcing: bool = True
    cg_eta0: float = 0.25


class BAPlans(NamedTuple):
    """Segment plans (ops/segsum) of one BA problem's index sets, which an
    LM solve never changes.  Observation slots (P, V) by camera (`cam`)
    and by model (`model`), cameras by model (`cam_model`, the PCG
    matvec's fold); with prior terms, the triples' (T, 3) cameras
    (`triple`) and their (T, 3, 3) camera pairs (`pair`, the dense path's
    S); in the dense path the slots by point and camera / model
    (`point_cam`, `point_model`: the Schur fill's G factors).  Masked
    slots and zero-weight triples are dropped."""
    cam: SegmentPlan
    model: SegmentPlan
    cam_model: SegmentPlan
    triple: Optional[SegmentPlan] = None
    pair: Optional[SegmentPlan] = None
    point_cam: Optional[SegmentPlan] = None
    point_model: Optional[SegmentPlan] = None


def _triple_plans(problem: BAProblem, pairs: bool):
    """The live triples' (T, 3) cameras, and with `pairs` their (T, 3, 3)
    camera pairs (a * C + b)."""
    C, trip = problem.n_cameras, problem.gps_triple
    live = torch.any(problem.gps_triple_weight != 0, dim=-1)
    triple = make_plan(trip, C, live[:, None].expand_as(trip))
    if not pairs:
        return triple, None
    return triple, make_plan(trip[:, :, None] * C + trip[:, None, :], C * C,
                             live[:, None, None].expand(-1, 3, 3))


def make_plans(problem: BAProblem, cfg, priors: bool) -> BAPlans:
    """The plans one solve of `problem` sums through (`priors`: with the
    prior terms' plans)."""
    C, M, P = problem.n_cameras, problem.n_models, problem.n_points
    cam = problem.track_cam
    model = problem.cam_model[cam]
    mask = problem.track_mask
    plans = BAPlans(cam=make_plan(cam, C, mask),
                    model=make_plan(model, M, mask),
                    cam_model=make_plan(problem.cam_model, M))
    if priors:
        triple, pair = _triple_plans(problem, cfg.cg_iterations <= 0)
        plans = plans._replace(triple=triple, pair=pair)
    if cfg.cg_iterations <= 0:
        p_idx = torch.arange(P, device=cam.device)[:, None]
        plans = plans._replace(
            point_cam=make_plan(p_idx * C + cam, P * C, mask),
            point_model=make_plan(p_idx * M + model, P * M, mask))
    return plans


def _aux(fn):
    """fn returning (r, r): jacfwd(has_aux=True) then yields (J, r)."""
    def f(*args):
        r = fn(*args)
        return r, r
    return f


# the JAX package's ba/lm names; they live with the plain versions of the
# kernels that evaluate them
robust_weights = ba_linearize.robust_weights
robust_cost = ba_candidate_cost.robust_cost


def _linearize(problem: BAProblem, cfg: LMConfig):
    """r (P,V,2), Jpose (P,V,2,6), Jintr (P,V,2,3) and Jpt (P,V,2,3) of
    every observation slot, scaled by sqrt(track_weight), the mask and the
    robust weights sqrt(rho'(s)) (ops.ba_linearize.linearize)."""
    with span("ba/lm/linearize"):
        return ba_linearize.linearize(
            problem.poses, problem.intrs, problem.points, problem.cam_model,
            problem.track_cam, problem.track_uv, problem.track_weight,
            problem.track_mask, cfg.huber_delta)


@contextlib.contextmanager
def _reduced_slots(problem: BAProblem, lam, cfg: LMConfig):
    """The opening both camera solvers share: linearize every slot, then,
    inside the ba/lm/reduce span that the caller's sums stay in, reduce
    them in one call of ops.ba_reduce_slots.reduce_slots.  Yields Jpose,
    Jintr and reduce_slots' (Hpp_inv, g_pt, W, U, cam rows, model rows)."""
    r, Jpo, Jin, Jpt = _linearize(problem, cfg)
    with span("ba/lm/reduce"):
        yield Jpo, Jin, ba_reduce_slots.reduce_slots(
            r, Jpo, Jin, Jpt, problem.point_mut, lam)


def _host(x, name: str, to=float):
    """The 0-d device tensor x on the host as `to`: one blocking read,
    alone in the span `name`."""
    with span(name):
        return to(x)


def compute_residuals(problem: BAProblem):
    """(P, V, 2) reprojection residuals scaled by sqrt(track_weight) and
    the mask (ops.ba_candidate_cost.residuals)."""
    return ba_candidate_cost.residuals(
        problem.poses, problem.intrs, problem.points, problem.cam_model,
        problem.track_cam, problem.track_uv, problem.track_weight,
        problem.track_mask)


def _gps_residual_one(pose, gpos, gw):
    return gw * (projection.camera_center(pose) - gpos)


def gps_residuals(problem: BAProblem):
    """GPS camera-center anchor residuals (C, 3): weight * (center - gps)
    (ref GPSErrorPoseAbsolute, utils/gps_error_pose_absolute.h:31-44,
    with per-axis weights)."""
    return _gps_residual_one(problem.poses, problem.gps_pos,
                             problem.gps_weight)


def pose_prior_residuals(problem: BAProblem):
    """Full-pose prior residuals (C, 6) (ref cam_error_pose_absolute.h)."""
    return problem.pose_prior_weight * (problem.poses - problem.pose_prior)


def _triple_residual(poses3, gps3, w2, eps=1e-8):
    """(..., 2) GPS relative residuals of camera triples (i, j, k):
    the cosine of the triangle angle at the middle camera and the distance
    ratio |ci - cj| / |cj - ck|, each against the GPS triangle (ref
    gps_error_pose_raletive_angle.h, gps_error_pose_raletive_dis.h)."""
    c = projection.camera_center(poses3)                  # (..., 3, 3)
    # a tensor eps: under jacfwd a Python float added to a 0-d dual tensor
    # promotes the tangent to float64; filled on the device, as a copy from
    # the host would wait for the card
    eps = torch.full((), eps, dtype=poses3.dtype, device=poses3.device)
    v1 = c[..., 0, :] - c[..., 1, :]
    v2 = c[..., 2, :] - c[..., 1, :]
    # sqrt(|v|^2 + eps) keeps the Jacobian finite for degenerate triples
    # (the zero-weight placeholder, three coinciding cameras): norm() has
    # a NaN gradient at 0, and weight 0 times NaN still poisons the system
    n1 = torch.sqrt(torch.sum(v1 * v1, dim=-1) + eps)
    n2 = torch.sqrt(torch.sum(v2 * v2, dim=-1) + eps)
    cos_est = torch.sum(v1 * v2, dim=-1) / (n1 * n2)
    g1 = gps3[..., 0, :] - gps3[..., 1, :]
    g2 = gps3[..., 2, :] - gps3[..., 1, :]
    m1 = torch.sqrt(torch.sum(g1 * g1, dim=-1) + eps)
    m2 = torch.sqrt(torch.sum(g2 * g2, dim=-1) + eps)
    cos_gps = torch.sum(g1 * g2, dim=-1) / (m1 * m2)
    return torch.stack([w2[..., 0] * (cos_est - cos_gps),
                        w2[..., 1] * (n1 / n2 - m1 / m2)], dim=-1)


def gps_triple_residuals(problem: BAProblem):
    """(T, 2) relative GPS residuals over the configured camera triples."""
    return _triple_residual(problem.poses[problem.gps_triple],
                            problem.gps_pos[problem.gps_triple],
                            problem.gps_triple_weight)


def _reduce_cat(reduce, *tensors):
    """The sum over the ranks of several tensors in one collective."""
    flat = reduce(torch.cat([t.reshape(-1) for t in tensors]))
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(t.shape))
        off += t.numel()
    return out


def _cost(problem: BAProblem, huber_delta: float, reduce=None,
          priors: bool = True, step: Optional[ba_candidate_cost.Step] = None):
    """(candidate, cost) of `step` (the problem itself and its own cost
    without one): the robust reprojection cost of
    ops.ba_candidate_cost.candidate_cost, summed over the ranks by
    `reduce`, plus the camera-indexed prior costs, added once after the
    sum when `priors`.  With every prior weight zero those are exactly
    +0, so `priors` False changes no bit of a cost."""
    poses, intrs, points, cost = ba_candidate_cost.candidate_cost(
        problem.poses, problem.intrs, problem.points, problem.cam_model,
        problem.track_cam, problem.track_uv, problem.track_weight,
        problem.track_mask, huber_delta, step)
    if step is not None:
        problem = problem._replace(poses=poses, intrs=intrs, points=points)
    if reduce is not None:
        cost = reduce(cost)
    if priors:
        rg = gps_residuals(problem)
        rp = pose_prior_residuals(problem)
        rt = gps_triple_residuals(problem)
        cost = (cost + 0.5 * torch.sum(rg * rg) + 0.5 * torch.sum(rp * rp)
                + 0.5 * torch.sum(rt * rt))
    return problem, cost


def problem_cost(problem: BAProblem, huber_delta: float, reduce=None):
    """Robust reprojection cost (summed over the ranks by `reduce`) plus the
    camera-indexed prior costs, added once after the sum."""
    return _cost(problem, huber_delta, reduce)[1]


def has_priors(problem: BAProblem) -> bool:
    """Whether any GPS / pose-prior / triple weight is nonzero (one host
    read)."""
    return _host(torch.any(problem.gps_weight != 0)
                 | torch.any(problem.pose_prior_weight != 0)
                 | torch.any(problem.gps_triple_weight != 0),
                 "ba/lm/read.priors", bool)


_gps_rj = vmap(jacfwd(_aux(_gps_residual_one), has_aux=True))
_triple_rj = vmap(jacfwd(_aux(_triple_residual), has_aux=True))


def _gps_prior_blocks(problem: BAProblem, triple_plan=None):
    """Camera-indexed Gauss-Newton blocks of the GPS / prior / triple terms
    (O(C)): Hg (C, 6, 6) per camera (GPS + pose prior), Ht (T, 3, 6, 3, 6)
    per triple, and their share of the rhs (6C + 3M,); the triples' rhs is
    summed per camera through `triple_plan` (made here if None)."""
    C, M = problem.n_cameras, problem.n_models
    dev = problem.points.device
    Jg, rg = _gps_rj(problem.poses, problem.gps_pos, problem.gps_weight)
    Hg = torch.einsum("cri,crj->cij", Jg, Jg)               # (C,6,6)
    gg = torch.einsum("cri,cr->ci", Jg, rg)
    wp = problem.pose_prior_weight
    Hg = Hg + torch.diag_embed(wp * wp)
    gg = gg + wp * pose_prior_residuals(problem)

    Jt, rt = _triple_rj(problem.poses[problem.gps_triple],
                        problem.gps_pos[problem.gps_triple],
                        problem.gps_triple_weight)        # (T,2,3,6), (T,2)
    Ht = torch.einsum("trai,trbj->taibj", Jt, Jt)           # (T,3,6,3,6)
    gt = torch.einsum("trai,tr->tai", Jt, rt)               # (T,3,6)

    if triple_plan is None:
        triple_plan = _triple_plans(problem, False)[0]
    rhs_extra = torch.zeros((6 * C + 3 * M,), dtype=gg.dtype, device=dev)
    rhs_extra[:6 * C] = -(gg + segment_sum(gt, triple_plan)).reshape(-1)
    return Hg, Ht, rhs_extra


def partial_camera_system(problem: BAProblem, lam, cfg: LMConfig,
                          plans: Optional[BAPlans] = None, reduce=None):
    """Linearize the tracks into the reduced camera system.

    Returns (S, rhs, aux): the undamped, unmasked (6C+3M)^2 system, its
    right-hand side, and the per-track tensors back-substitution needs.
    Every term is a sum over tracks, through `plans` (made here if None),
    and S and rhs are summed over the ranks by `reduce`.
    """
    C, M, P = problem.n_cameras, problem.n_models, problem.n_points
    D = 6 * C + 3 * M
    dtype, dev = problem.points.dtype, problem.points.device
    if plans is None:
        plans = make_plans(problem, cfg._replace(cg_iterations=0), False)

    # every slot's products in one pass (ops/ba_reduce_slots): the point
    # blocks' inverses, W = [Jpose|Jintr]^T Jpt, its Cholesky-folded U
    # (Hpp_inv = L L^T) and the camera / model rows [JᵀJ blocks | rv],
    # rv = W Hpp_inv g_pt - [Jpose|Jintr]^T r
    with _reduced_slots(problem, lam, cfg) as (
            _, _, (Hpp_inv, g_pt, W, U, cam_rows, model_rows)):
        cam = segment_sum(cam_rows, plans.cam)                      # (C,60)
        model = segment_sum(model_rows, plans.model)                # (M,12)
        Hcc_pose = cam[:, :36].reshape(C, 6, 6)
        Hcc_pi = cam[:, 36:54].reshape(C, 6, 3)
        Hcc_intr = model[:, :9].reshape(M, 3, 3)

        # ---- camera block-diagonals: each entry written once, into zeros
        S = torch.zeros((D, D), dtype=dtype, device=dev)
        torch.diagonal(S[:6 * C, :6 * C].view(C, 6, C, 6), dim1=0,
                       dim2=2).copy_(Hcc_pose.permute(1, 2, 0))
        torch.diagonal(S[6 * C:, 6 * C:].view(M, 3, M, 3), dim1=0,
                       dim2=2).copy_(Hcc_intr.permute(1, 2, 0))
        S_pi = S[:6 * C, 6 * C:]
        S_pi.view(C, 6, M, 3)[torch.arange(C, device=dev), :,
                              problem.cam_model] = Hcc_pi
        S[6 * C:, :6 * C] = S_pi.T

        # ---- Schur subtraction: S -= sum_p E_p Hpp_inv E_p^T ----
        # per point, fold its views' U into per-camera / per-model factors
        # G (P, C, 6, 3) and (P, M, 3, 3) — segment sums over (point,
        # camera) bins — so the Schur fill is one G G^T product
        G_pose = segment_sum(U[:, :, :6], plans.point_cam).reshape(
            P, C, 6, 3)
        G_intr = segment_sum(U[:, :, 6:], plans.point_model).reshape(
            P, M, 3, 3)
        Gp = G_pose.permute(1, 2, 0, 3).reshape(6 * C, 3 * P)
        Gi = G_intr.permute(1, 2, 0, 3).reshape(3 * M, 3 * P)
        G = torch.cat([Gp, Gi], dim=0)                                # (D,3P)
        S = S - G @ G.T

        # ---- rhs: -(g_cam - E Hpp_inv g_pt), the sums of rv ----
        rhs = torch.cat([cam[:, 54:].reshape(-1), model[:, 9:].reshape(-1)])
        aux = {"W": W, "Hpp_inv": Hpp_inv, "g_pt": g_pt}
        if reduce is not None:
            S, rhs = _reduce_cat(reduce, S, rhs)
    return S, rhs, aux


def solve_reduced(S, rhs, problem: BAProblem, lam, cfg: LMConfig,
                  priors: bool = True, plans: Optional[BAPlans] = None):
    """Add the prior terms' blocks (when `priors`), damp + freeze-mask the
    reduced system and solve it by Cholesky.

    A factorization failure (not positive definite) yields a NaN step,
    which the LM loop rejects, as in the JAX package."""
    if priors:
        C = problem.n_cameras
        if plans is None:
            plans = make_plans(problem, cfg._replace(cg_iterations=0), True)
        Hg, Ht, rhs_extra = _gps_prior_blocks(problem, plans.triple)
        pose_rows = 6 * torch.arange(C, device=S.device)[:, None] \
            + torch.arange(6, device=S.device)
        # one block per camera, written once: exact in any order
        S = S.index_put((pose_rows[:, :, None], pose_rows[:, None, :]), Hg,
                        accumulate=True)
        # the triples' (camera a, camera b) blocks collide on shared
        # cameras: summed per camera pair, then added as one (6C, 6C) block
        Hab = segment_sum(Ht.permute(0, 1, 3, 2, 4), plans.pair)  # (C*C,6,6)
        S[:6 * C, :6 * C] += Hab.reshape(C, C, 6, 6).permute(
            0, 2, 1, 3).reshape(6 * C, 6 * C)
        rhs = rhs + rhs_extra
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
    """Point back-substitution: d_pt = -Hpp_inv (g_pt + E^T d_cam)
    (ops.ba_candidate_cost.backsub)."""
    return ba_candidate_cost.backsub(aux["W"], aux["Hpp_inv"], aux["g_pt"],
                                     d_cam, problem.cam_model,
                                     problem.track_cam, problem.point_mut)


def _step(problem: BAProblem, d_cam, aux) -> ba_candidate_cost.Step:
    """The LM step d_cam with what back-substitution reads."""
    return ba_candidate_cost.Step(d_cam, aux["W"], aux["Hpp_inv"],
                                  aux["g_pt"], problem.pose_mut,
                                  problem.intr_mut, problem.point_mut)


# ---------------------------------------------------------------------------
# Matrix-free PCG path for the reduced camera system (cfg.cg_iterations > 0)
# ---------------------------------------------------------------------------

CG_POLL = 8   # CG iterations between host reads of the on-device flag


def _track_terms(problem: BAProblem, lam, cfg: LMConfig,
                 plans: Optional[BAPlans] = None, reduce=None):
    """Per-track tensors and rhs of the PCG path: everything O(P*V), no
    (D, D) matrix and no O(P*C) factor.

    Returns (terms, rhs, aux): terms holds the per-slot Jacobians Jc
    (P,V,2,9), W (P,V,9,3) = [Jpose|Jintr]^T Jpt, the point-block inverses
    Hpp_inv (P,3,3) and the block-Jacobi pieces of S (the camera and model
    diagonal blocks minus their Schur parts); aux is what backsub_points
    needs.  Every slot's products come from the reduce the dense path
    runs (`_reduced_slots`).  Masked slots carry zero Jacobians and
    residuals, so they add nothing to any camera sum.  `reduce` sums rhs
    and the block-Jacobi pieces over the ranks.
    """
    if plans is None:
        plans = make_plans(problem, cfg, False)

    with _reduced_slots(problem, lam, cfg) as (
            Jpo, Jin, (Hpp_inv, g_pt, W, U, cam, model)):
        P, V = W.shape[:2]
        # rhs: -(g_cam - E Hpp_inv g_pt), the sums of rv
        rhs = torch.cat([segment_sum(cam[..., 54:], plans.cam).reshape(-1),
                         segment_sum(model[..., 9:], plans.model).reshape(-1)])
        # block-Jacobi pieces of S: each slot's JᵀJ block minus its Schur
        # part U Uᵀ, per slot before the sums
        blk_pose = segment_sum(
            cam[..., :36].reshape(P, V, 6, 6)
            - torch.einsum("pvik,pvjk->pvij", U[:, :, :6], U[:, :, :6]),
            plans.cam)
        blk_intr = segment_sum(
            model[..., :9].reshape(P, V, 3, 3)
            - torch.einsum("pvik,pvjk->pvij", U[:, :, 6:], U[:, :, 6:]),
            plans.model)
        if reduce is not None:
            rhs, blk_pose, blk_intr = _reduce_cat(reduce, rhs, blk_pose,
                                                  blk_intr)
        terms = {"Jc": torch.cat([Jpo, Jin], dim=-1), "W": W,
                 "Hpp_inv": Hpp_inv, "blk_pose": blk_pose,
                 "blk_intr": blk_intr}
    return terms, rhs, {"W": W, "Hpp_inv": Hpp_inv, "g_pt": g_pt}


def _cg_solve(problem: BAProblem, terms, rhs, lam, cfg: LMConfig,
              tol_rel=None, prior_blocks=None, reduce=None,
              plans: Optional[BAPlans] = None):
    """Block-Jacobi PCG on the damped, freeze-masked reduced system.

    The matvec applies S = Hcc - E Hpp^-1 E^T track by track, plus the
    prior terms' camera blocks (`prior_blocks` = (Hg, Ht) of
    _gps_prior_blocks, or None); the preconditioner's pose blocks include
    Hg, which is what pins a problem whose gauge rests on the pose prior
    alone.  Damping is lam * diag(S) (clamped) + 1e-10, frozen dofs are
    identity rows.  The
    loop stops after cfg.cg_iterations or once |r|^2 <= (tol_rel |b|)^2
    (tol_rel defaults to cfg.cg_tol).  That test lives on the device: an
    iteration that starts converged moves nothing, and the host reads the
    flag every CG_POLL iterations, so the result equals a per-iteration
    check without a host sync per iteration.  A preconditioner block that
    fails its Cholesky yields a NaN step, which the LM loop rejects.
    `terms` and `rhs` are reduced already; `reduce` sums the track part
    of each matvec.  Camera sums go through `plans` (made here if None).
    """
    C, M = problem.n_cameras, problem.n_models
    if plans is None:
        plans = make_plans(problem, cfg, prior_blocks is not None)
    dtype, dev = rhs.dtype, rhs.device
    free = torch.cat([problem.pose_mut.repeat_interleave(6),
                      problem.intr_mut.repeat_interleave(3)])
    blk_pose, blk_intr = terms["blk_pose"], terms["blk_intr"]
    if prior_blocks is not None:
        Hg, Ht = prior_blocks
        blk_pose = blk_pose + Hg
        T = Ht.shape[0]
        # the triples' diagonal: Ht[t, a, i, a, i] at row 6 triple[t, a] + i
        tdiag = torch.zeros_like(rhs)
        tdiag[:6 * C] = segment_sum(
            torch.diagonal(Ht.reshape(T, 18, 18), dim1=-2,
                           dim2=-1).reshape(T, 3, 6), plans.triple).reshape(-1)
    diag_p = torch.diagonal(blk_pose, dim1=-2, dim2=-1)             # (C,6)
    diag_i = torch.diagonal(blk_intr, dim1=-2, dim2=-1)             # (M,3)
    diag_s = torch.cat([diag_p.reshape(-1), diag_i.reshape(-1)])
    if prior_blocks is not None:
        diag_s = diag_s + tdiag
    dampv = lam * torch.clamp(diag_s, min=1e-12) + 1e-10

    Jc, W, Hpp_inv = terms["Jc"], terms["W"], terms["Hpp_inv"]
    cam = problem.track_cam
    cam_model = problem.cam_model

    def matvec(x):
        xm = x * free
        x9 = torch.cat([xm[:6 * C].reshape(C, 6),
                        xm[6 * C:].reshape(M, 3)[cam_model]], dim=1)  # (C,9)
        xv = x9[cam]                                                  # (P,V,9)
        t = torch.einsum("pvri,pvi->pvr", Jc, xv)
        u = torch.einsum("pvri,pvr->pvi", Jc, t)
        b3 = torch.einsum("pjk,pk->pj", Hpp_inv,
                          torch.einsum("pvik,pvi->pk", W, xv))
        z9 = u - torch.einsum("pvik,pk->pvi", W, b3)
        zc = segment_sum(z9, plans.cam)                               # (C,9)
        # model ids are a function of the camera id: fold the camera rows
        # into model bins
        Sx = torch.cat([zc[:, :6].reshape(-1),
                        segment_sum(zc[:, 6:], plans.cam_model).reshape(-1)])
        if reduce is not None:
            Sx = reduce(Sx)
        if prior_blocks is not None:
            xp = xm[:6 * C].reshape(C, 6)
            Sxp = torch.einsum("cij,cj->ci", Hg, xp)
            tx = torch.einsum("taibj,tbj->tai", Ht, xp[problem.gps_triple])
            Sxp = Sxp + segment_sum(tx, plans.triple)
            Sx[:6 * C] += Sxp.reshape(-1)
        Sx = Sx + dampv * xm
        return Sx * free + (1.0 - free) * x

    # block-Jacobi preconditioner (damped, freeze-safe)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Bp = blk_pose + torch.diag_embed(lam * torch.clamp(diag_p, min=1e-12)
                                     + 1e-10)
    Bi = blk_intr + torch.diag_embed(lam * torch.clamp(diag_i, min=1e-12)
                                     + 1e-10)
    fp = problem.pose_mut[:, None, None]
    fi = problem.intr_mut[:, None, None]
    Bp = Bp * fp + eye6 * (1.0 - fp)
    Bi = Bi * fi + eye3 * (1.0 - fi)
    Lp, info = torch.linalg.cholesky_ex(Bp)
    Bi_inv = inv3x3(Bi)

    def prec(r):
        zp = torch.cholesky_solve(r[:6 * C].reshape(C, 6, 1), Lp)
        zi = torch.einsum("mij,mj->mi", Bi_inv, r[6 * C:].reshape(M, 3))
        return torch.cat([zp.reshape(-1), zi.reshape(-1)])

    rhs = rhs * free
    if tol_rel is None:
        tol_rel = cfg.cg_tol
    tol2 = (tol_rel * torch.linalg.vector_norm(rhs)) ** 2
    x = torch.zeros_like(rhs)
    r = rhs
    z = prec(r)
    p = z
    rz = torch.sum(r * z)
    active = torch.sum(r * r) > tol2
    for i in range(cfg.cg_iterations):
        if i % CG_POLL == 0 and not _host(active, "ba/lm/read.cg_poll",
                                          bool):
            break
        Ap = matvec(p)
        alpha = torch.where(active,
                            rz / torch.clamp(torch.sum(p * Ap), min=1e-30),
                            0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp(rz, min=1e-30)
        p = torch.where(active, z + beta * p, p)
        rz = torch.where(active, rz_new, rz)
        active = active & (torch.sum(r * r) > tol2)
    x = torch.where(torch.any(info != 0), torch.nan, x)
    return x * free


def _camera_step(problem: BAProblem, lam, cfg: LMConfig, tol_rel=None,
                 priors: bool = True, reduce=None,
                 plans: Optional[BAPlans] = None):
    """The camera step d_cam (6C + 3M,) of one LM step and what
    back-substitution needs: dense Schur and Cholesky, or block-Jacobi PCG
    when cfg.cg_iterations > 0.  `priors` False skips the prior terms (all
    weights zero); `reduce` sums the track partials over the ranks;
    `plans` are the problem's (made here if None)."""
    if plans is None:
        plans = make_plans(problem, cfg, priors)
    if cfg.cg_iterations <= 0:
        S, rhs, aux = partial_camera_system(problem, lam, cfg, plans, reduce)
        with span("ba/lm/camera_solve"):
            return solve_reduced(S, rhs, problem, lam, cfg, priors=priors,
                                 plans=plans), aux
    terms, rhs, aux = _track_terms(problem, lam, cfg, plans, reduce)
    with span("ba/lm/camera_solve"):
        prior_blocks = None
        if priors:
            Hg, Ht, rhs_extra = _gps_prior_blocks(problem, plans.triple)
            prior_blocks = (Hg, Ht)
            rhs = rhs + rhs_extra
        return _cg_solve(problem, terms, rhs, lam, cfg, tol_rel=tol_rel,
                         prior_blocks=prior_blocks, reduce=reduce,
                         plans=plans), aux


def _split_step(problem: BAProblem, d_cam, aux):
    """(d_pose, d_intr, d_pt) of the camera step d_cam: the points' by
    back-substitution, frozen dofs zero."""
    C, M = problem.n_cameras, problem.n_models
    d_pt = backsub_points(aux, d_cam, problem)
    d_pose = d_cam[:6 * C].reshape(C, 6) * problem.pose_mut[:, None]
    d_intr = d_cam[6 * C:].reshape(M, 3) * problem.intr_mut[:, None]
    return d_pose, d_intr, d_pt


def _assemble_and_solve(problem: BAProblem, lam, cfg: LMConfig,
                        tol_rel=None, priors: bool = True, reduce=None,
                        plans: Optional[BAPlans] = None):
    """One LM step (d_pose, d_intr, d_pt), dense or PCG as _camera_step."""
    return _split_step(problem, *_camera_step(problem, lam, cfg, tol_rel,
                                              priors, reduce, plans))


def solve_lm(problem: BAProblem, cfg: LMConfig = LMConfig(), reduce=None):
    """Run LM to convergence or cfg.max_iterations.

    Returns (problem, info) with initial_cost, final_cost, iterations,
    lambda, converged and rms_px (host numbers).  With `reduce` (the sum
    over the ranks) `problem` is this rank's block of tracks, and the
    numbers are the whole problem's.

    Spans (utils/tracing): ba/lm/solve holds the call; ba/lm/plans the
    plans; ba/lm/iteration each LM iteration, which holds ba/lm/linearize,
    ba/lm/reduce, ba/lm/camera_solve and ba/lm/step (back-substitution,
    the candidate and its cost: one call of candidate_cost, then the
    prior costs when the solve has priors) in that order.  Each blocking
    host read is alone in a ba/lm/read.* or segsum/read.* span.
    """
    with span("ba/lm/solve"):
        priors = has_priors(problem)
        cost = _host(_cost(problem, cfg.huber_delta, reduce, priors)[1],
                     "ba/lm/read.initial_cost")
        initial_cost = cost
        lam = float(cfg.init_lambda)
        forcing = cfg.cg_forcing and cfg.cg_iterations > 0
        eta = cfg.cg_eta0 if forcing else cfg.cg_tol
        # the index sets are the same every iteration: one set of plans
        with span("ba/lm/plans"):
            plans = make_plans(problem, cfg, priors)
        it = 0
        converged = False
        while it < cfg.max_iterations:
            with span("ba/lm/iteration"):
                d_cam, aux = _camera_step(
                    problem, lam, cfg, tol_rel=eta if forcing else None,
                    priors=priors, reduce=reduce, plans=plans)
                with span("ba/lm/step"):
                    cand, new_cost = _cost(problem, cfg.huber_delta, reduce,
                                           priors, _step(problem, d_cam, aux))
                    new_cost = _host(new_cost, "ba/lm/read.cost")
                it += 1
                accept = new_cost < cost and math.isfinite(new_cost)
                if accept:
                    rel = abs(cost - new_cost) / max(cost, 1e-20)
                    problem, cost = cand, new_cost
                    lam = max(lam / cfg.lambda_down, cfg.min_lambda)
                    # forcing sequence: tighten superlinearly on acceptance
                    eta = max(eta ** 1.5, cfg.cg_tol)
                    if rel < cfg.rtol:
                        converged = True
                        break
                else:
                    lam = min(lam * cfg.lambda_up, cfg.max_lambda)
        n_obs = problem.n_observations()
        if reduce is not None:
            n_obs = reduce(n_obs)
        n_obs = _host(n_obs, "ba/lm/read.n_obs", int)
    info = {"initial_cost": initial_cost, "final_cost": cost,
            "iterations": it, "lambda": lam, "converged": converged,
            "rms_px": math.sqrt(2.0 * cost / max(n_obs, 1))}
    return problem, info
