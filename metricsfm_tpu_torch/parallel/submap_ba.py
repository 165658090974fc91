"""Hierarchical submap bundle adjustment with a Sim(3) pose-graph merge.

Counterpart of metricsfm_tpu/parallel/submap_ba.py, the periodic full BA
of large scenes (above sfm.th_hierarchical_cameras cameras): partition the
registered cameras into overlapping windows, solve each window's bundle
adjustment, then stitch the windows with a Sim(3) pose graph over the
cameras they share.  The reference has no distributed counterpart; its
closest analogue is the CMVS clustering of <= 500 cameras for dense work
(sfm_incremental.cc:1255-1256).

The JAX package pads every submap to one (Cp, Pp) shape and solves them as
one vmapped batch.  Here each submap is its own unpadded BAProblem, solved
by its own LM run (ba/lm.solve_lm, which makes the submap's own segment
plans) one after another: the same semantics as the vmapped batch, where
every submap keeps its own lambda and its own accept / reject decisions.  Submaps are not merged into one block-diagonal
problem, which would share one lambda.  A submap's `iterations` is the sum
over its whole solve.  With a mesh of ranks the submaps are dealt to the
ranks in contiguous blocks (no collective inside a solve), and the solved
cameras, points and numbers are summed into every rank, so every rank
runs the same pose-graph merge.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import jacfwd

from ..ba import problem as ba_problem
from ..ba.lm import LMConfig, solve_lm
from ..ops import lie, np_geom
from .mesh import Mesh, owned_range


# ---------------------------------------------------------------- partition
def partition_images(imgs: Sequence[int], max_cams: int = 64,
                     overlap: int = 8) -> List[List[int]]:
    """Contiguous overlapping windows over the registration order.

    Consecutive submaps share `overlap` cameras: the glue the pose graph
    optimizes over.
    """
    imgs = list(imgs)
    if len(imgs) <= max_cams:
        return [imgs]
    parts = []
    step = max_cams - overlap
    start = 0
    while start < len(imgs):
        end = min(start + max_cams, len(imgs))
        parts.append(imgs[start:end])
        if end == len(imgs):
            break
        start += step
    return parts


# ------------------------------------------------------------- problems
def build_submap_problems(scene, kp_xy: Dict[int, np.ndarray],
                          parts: List[List[int]], max_views: int = 8,
                          gauge_weight: float = 1.0, *, device,
                          dtype=torch.float32):
    """One BAProblem per submap, on `device`.

    Per submap: cameras = its window (one intrinsics block each, frozen:
    the global solves own the intrinsics), tracks = scene tracks with >= 2
    observations inside the window, observations cut to the window's
    cameras and capped at `max_views` per track (kept views spread across
    the track, rotated by its row).

    Gauge: every camera carries a weak pose prior (weight `gauge_weight`)
    toward its current pose instead of two hard-frozen cameras: freezing
    noisy anchors bends the structure around their error, while the soft
    prior averages it over the window.

    Returns (problems, infos); infos[s] holds the submap's "images",
    "tracks" (scene track indices, one per point row) and "counts" (each
    track's observations inside the window, before the view cap).
    """
    V = max_views
    # ---- observation harvest off the scene's flat log ----
    t_all, i_all, k_all = scene._obs_arrays()
    bad = scene.bad_mask()
    n_tr = len(scene.tracks)
    # keep-LAST per (track, img): Track.obs dict-overwrite semantics
    pos = np.arange(len(t_all))
    key = t_all * np.int64(scene.n_images) + i_all
    srt = np.lexsort((pos, key))
    key_s = key[srt]
    last = np.ones(len(srt), bool)
    if len(srt) > 1:
        last[:-1] = key_s[1:] != key_s[:-1]
    sel = srt[last]
    tD, iD, kD = t_all[sel], i_all[sel], k_all[sel]   # track-major order
    liveD = ~bad[tD] if bad.size else np.ones(len(tD), bool)
    tD, iD, kD = tD[liveD], iD[liveD], kD[liveD]

    # concatenated keypoint store for uv lookups
    base = np.full(scene.n_images + 1, -1, np.int64)
    off = 0
    uv_parts = []
    for im in sorted(kp_xy.keys()):
        base[im] = off
        xy = np.asarray(kp_xy[im], np.float64).reshape(-1, 2)
        uv_parts.append(xy)
        off += len(xy)
    uv_all = np.concatenate(uv_parts) if uv_parts else np.zeros((0, 2))
    xyz_all = (np.stack([t.xyz for t in scene.tracks])
               if scene.tracks else np.zeros((0, 3)))

    problems, infos = [], []
    for part in parts:
        C = len(part)
        row_of = np.full(scene.n_images, -1, np.int64)
        row_of[np.asarray(part, np.int64)] = np.arange(C)
        cam_row = row_of[iD]
        m = cam_row >= 0
        tw, cw, kw, iw = tD[m], cam_row[m], kD[m], iD[m]
        # tracks with >= 2 observations inside the window
        cnt = np.bincount(tw, minlength=n_tr)
        keep_tr = np.nonzero(cnt >= 2)[0]
        prow_of = np.full(n_tr, -1, np.int64)
        prow_of[keep_tr] = np.arange(len(keep_tr))
        pr = prow_of[tw]
        ok = pr >= 0
        tw, cw, kw, iw, pr = tw[ok], cw[ok], kw[ok], iw[ok], pr[ok]
        order = np.argsort(tw, kind="stable")
        tw, cw, kw, iw, pr = tw[order], cw[order], kw[order], iw[order], \
            pr[order]
        _, start, n_per_t = np.unique(tw, return_index=True,
                                      return_counts=True)
        slot = np.arange(len(tw)) - np.repeat(start, n_per_t)
        n_per = np.repeat(n_per_t, n_per_t)
        # V cap: spread the kept views across the track, rotated by p_row
        # (a fixed subsampling starves the same cameras in every track)
        u = (slot - pr) % n_per
        c1 = -(-(u * V) // n_per)
        c2 = -(-((u + 1) * V) // n_per)
        keepv = (n_per <= V) | ((c1 < c2) & (c1 < V))
        tw, cw, kw, iw, pr = tw[keepv], cw[keepv], kw[keepv], iw[keepv], \
            pr[keepv]
        _, start3, cnt3 = np.unique(tw, return_index=True, return_counts=True)
        vslot = np.arange(len(tw)) - np.repeat(start3, cnt3)

        P = len(keep_tr)
        track_cam = np.zeros((P, V), np.int64)
        track_uv = np.zeros((P, V, 2), np.float64)
        track_mask = np.zeros((P, V), bool)
        track_cam[pr, vslot] = cw
        track_uv[pr, vslot] = uv_all[base[iw] + kw]
        track_mask[pr, vslot] = True
        poses = np.stack([scene.poses[im] for im in part])
        intrs = np.stack([scene.models[scene.model_of_image[im]].as_array()
                          for im in part])
        problems.append(ba_problem.build_problem(
            poses, intrs, np.arange(C), xyz_all[keep_tr].reshape(P, 3),
            track_cam, track_uv, track_mask, intr_mut=np.zeros(C),
            pose_prior=poses, pose_prior_weight=np.full((C, 6), gauge_weight),
            device=device, dtype=dtype))
        infos.append({"images": list(part), "tracks": keep_tr.tolist(),
                      "counts": cnt[keep_tr]})
    return problems, infos


INFO_KEYS = ("initial_cost", "final_cost", "iterations", "lambda",
             "converged", "rms_px")


def solve_submaps(problems, cfg: LMConfig = LMConfig(),
                  mesh: Optional[Mesh] = None, axis_name: str = "data"):
    """Solve every submap by its own LM run, one after another.  Each rank
    of `mesh` (default: the one process) solves its contiguous block of
    submaps, and the results are summed into every rank (one all-reduce of
    the cameras and points, one of the numbers).

    Returns (solved problems, info): info holds one entry per submap of
    solve_lm's numbers (initial_cost, final_cost, iterations, lambda,
    converged, rms_px); `iterations` counts every LM iteration of that
    submap's solve.
    """
    if not problems:
        return [], {}
    ref = problems[0].points
    mesh = mesh or Mesh(device=ref.device)
    S = len(problems)
    lo, hi = owned_range(S, mesh.rank, mesh.shape[axis_name])
    fields = ("poses", "intrs", "points")
    sizes = [sum(getattr(p, f).numel() for f in fields) for p in problems]
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    flat = torch.zeros(int(offs[-1]), dtype=ref.dtype, device=ref.device)
    nums = torch.zeros((S, len(INFO_KEYS)), dtype=torch.float64,
                       device=ref.device)
    for s in range(lo, hi):
        out, info = solve_lm(problems[s], cfg)
        flat[offs[s]:offs[s + 1]] = torch.cat(
            [getattr(out, f).reshape(-1) for f in fields])
        nums[s] = torch.tensor([float(info[k]) for k in INFO_KEYS],
                               dtype=torch.float64)
    flat = mesh.psum(flat)
    nums = mesh.psum(nums).cpu().numpy()
    solved = []
    for s, prob in enumerate(problems):
        parts, o = {}, int(offs[s])
        for f in fields:
            t = getattr(prob, f)
            parts[f] = flat[o:o + t.numel()].reshape(t.shape)
            o += t.numel()
        solved.append(prob._replace(**parts))
    info = {k: nums[:, c] for c, k in enumerate(INFO_KEYS)}
    info["iterations"] = info["iterations"].astype(np.int64)
    info["converged"] = info["converged"].astype(bool)
    return solved, info


# ------------------------------------------------------------ pose graph
def _apply_sim3(p7, pts):
    """pts (..., N, 3) under p7 (..., 7) = [aa, t, log_s]."""
    R = lie.angle_axis_to_matrix(p7[..., :3])
    s = torch.exp(p7[..., 6])
    return s[..., None, None] * pts @ R.transpose(-1, -2) \
        + p7[..., None, 3:6]


def optimize_pose_graph(centers_by_submap: List[np.ndarray],
                        pairs: List[tuple], iters: int = 30,
                        lam: float = 1e-4, rot_weight: float = 1.0,
                        identity_weight: float = 1e-2, *, device):
    """Sim(3) pose graph over submaps, on `device`.

    centers_by_submap[k]: (Nk, 3) camera centers of submap k (its solved
    frame).  pairs: (i, j, ci, cj[, Ri, Rj]): the matched centers (and
    optionally world->cam rotations (N, 3, 3)) of cameras that submaps i
    and j share.  Rotation residuals matter: shared cameras are often near
    collinear, and centers alone leave the rotation about that line free.
    A weak identity prior pins the remaining gauge (the soft-gauge submap
    solves keep every frame near the parent frame).

    Returns (S, 7) transforms T_k = [aa, t, log_s] (submap 0 pinned to
    identity) minimizing the stacked residual by damped Gauss-Newton.
    """
    S = len(centers_by_submap)
    if S == 1 or not pairs:
        return np.zeros((S, 7))
    dt = torch.float32

    def t(a, dtype=dt):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    pair_i = t([p[0] for p in pairs], torch.int64)
    pair_j = t([p[1] for p in pairs], torch.int64)
    n_shared = max(p[2].shape[0] for p in pairs)
    E = len(pairs)
    ci = np.zeros((E, n_shared, 3))
    cj = np.zeros((E, n_shared, 3))
    Ri = np.tile(np.eye(3), (E, n_shared, 1, 1))
    Rj = np.tile(np.eye(3), (E, n_shared, 1, 1))
    have_rot = np.zeros((E,), bool)
    msk = np.zeros((E, n_shared))
    for r, p in enumerate(pairs):
        a, b = p[2], p[3]
        ci[r, :a.shape[0]] = a
        cj[r, :b.shape[0]] = b
        msk[r, :a.shape[0]] = 1.0
        if len(p) >= 6:
            Ri[r, :p[4].shape[0]] = p[4]
            Rj[r, :p[5].shape[0]] = p[5]
            have_rot[r] = True
    rot_msk = t(msk * have_rot[:, None] * rot_weight)
    ci, cj, Ri, Rj, msk = t(ci), t(cj), t(Ri), t(Rj), t(msk)
    # rotation residuals scaled to center units (the scene's extent)
    extent = float(np.std(np.concatenate(centers_by_submap, axis=0))) + 1e-6

    def residuals(T):                                  # T: (S, 7)
        Ti, Tj = T[pair_i], T[pair_j]                  # (E, 7)
        r_c = ((_apply_sim3(Ti, ci) - _apply_sim3(Tj, cj))
               * msk[..., None]).reshape(-1)
        # camera rotation after the world similarity: R' = R R_T^T
        bi = torch.einsum("enab,ecb->enac", Ri,
                          lie.angle_axis_to_matrix(Ti[:, :3]))
        bj = torch.einsum("enab,ecb->enac", Rj,
                          lie.angle_axis_to_matrix(Tj[:, :3]))
        r_r = ((bi - bj) * rot_msk[..., None, None] * extent).reshape(-1)
        r_id = (identity_weight * extent) * T[1:].reshape(-1)
        return torch.cat([r_c, r_r, r_id])

    zero = torch.zeros((1, 7), dtype=dt, device=device)

    def r_of(free_flat):
        return residuals(torch.cat([zero, free_flat.reshape(S - 1, 7)]))

    T = torch.zeros((S, 7), dtype=dt, device=device)
    for _ in range(iters):
        free = T[1:].reshape(-1)                       # submap 0 pinned
        r = r_of(free)
        J = jacfwd(r_of)(free)
        H = J.T @ J
        H = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-8))
        d = torch.linalg.solve(H, -(J.T @ r))
        better = torch.sum(r_of(free + d) ** 2) < torch.sum(r ** 2)
        T_new = torch.cat([T[:1], T[1:] + d.reshape(S - 1, 7)])
        T = torch.where(better, T_new, T)
    return T.cpu().numpy().astype(np.float64)


# ------------------------------------------------------- hierarchical BA
def hierarchical_ba(scene, kp_xy: Dict[int, np.ndarray],
                    max_cams: int = 64, overlap: int = 8,
                    max_views: int = 8, cfg: LMConfig = LMConfig(),
                    mesh: Optional[Mesh] = None, verbose: bool = False, *,
                    device):
    """Partition -> submap BA -> Sim(3) pose-graph merge, on `device`
    (with a `mesh`, the submap solves dealt to its ranks: solve_submaps).

    Mutates `scene` in place (poses + track xyz): each camera is owned by
    the submap where it sits furthest from the window edges, each track by
    the submap holding most of its observations (the first such submap on
    a tie).  Returns the solve_submaps info.
    """
    parts = partition_images(scene.registered, max_cams, overlap)
    probs, infos = build_submap_problems(scene, kp_xy, parts, max_views,
                                         device=device)
    if cfg.cg_iterations == 0:
        # as the JAX package: submap solves always run the matrix-free PCG
        # camera solve
        cfg = cfg._replace(cg_iterations=50)
    solved, info = solve_submaps(probs, cfg, mesh=mesh)
    poses_out = [p.poses.cpu().numpy().astype(np.float64) for p in solved]
    points_out = [p.points.cpu().numpy().astype(np.float64) for p in solved]

    # camera centers + rotations per submap (solved frame)
    centers = [np.stack([np_geom.camera_center(p) for p in ps])
               for ps in poses_out]
    rots = [np.stack([np_geom.pose_to_Rt(p)[0] for p in ps])
            for ps in poses_out]

    # shared-camera pairs between every overlapping submap pair
    pairs = []
    for i in range(len(parts)):
        set_i = {im: r for r, im in enumerate(parts[i])}
        for j in range(i + 1, len(parts)):
            shared = [(set_i[im], r) for r, im in enumerate(parts[j])
                      if im in set_i]
            if len(shared) >= 3:
                ri = [a for a, _ in shared]
                rj = [b for _, b in shared]
                pairs.append((i, j, centers[i][ri], centers[j][rj],
                              rots[i][ri], rots[j][rj]))

    T = optimize_pose_graph(centers, pairs, device=device)
    if verbose:
        print(f"hierarchical_ba: {len(parts)} submaps, {len(pairs)} "
              f"overlap pairs")

    # camera ownership: the submap where the camera is most interior
    owner_cam: Dict[int, Tuple[int, int]] = {}
    for s, part in enumerate(parts):
        for r, im in enumerate(part):
            depth = min(r, len(part) - 1 - r)
            if im not in owner_cam or depth > owner_cam[im][1]:
                owner_cam[im] = (s, depth)

    # track ownership: the submap holding most of the track's
    # observations (the first such submap on a tie)
    n_tr = len(scene.tracks)
    best_count = np.zeros(n_tr, np.int64)
    owner_track = np.full(n_tr, -1, np.int64)
    for s in range(len(parts)):
        tr = np.asarray(infos[s]["tracks"], np.int64)
        more = infos[s]["counts"] > best_count[tr]
        best_count[tr[more]] = infos[s]["counts"][more]
        owner_track[tr[more]] = s

    for s, part in enumerate(parts):
        R_s = np_geom.angle_axis_to_matrix(T[s, :3])
        t_s = T[s, 3:6]
        sc = float(np.exp(T[s, 6]))
        for r, im in enumerate(part):
            if owner_cam[im][0] == s:
                scene.poses[im] = np_geom.apply_similarity_to_pose(
                    poses_out[s][r], sc, R_s, t_s)
        tr = np.asarray(infos[s]["tracks"], np.int64)
        rows = np.nonzero(owner_track[tr] == s)[0]
        xyz = sc * points_out[s][rows] @ R_s.T + t_s
        for k, ti in enumerate(tr[rows]):
            scene.tracks[int(ti)].xyz = xyz[k]
    return info
