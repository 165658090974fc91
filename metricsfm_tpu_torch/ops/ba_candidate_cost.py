"""BA's LM candidate and its robust cost in one launch.

`candidate_cost(poses, intrs, points, cam_model, track_cam, track_uv,
track_weight, track_mask, delta, step)` takes a BA problem's tensors
(ba/problem.BAProblem's fields of the same names) and an LM step, and
returns the candidate (poses, intrs, points) and its robust reprojection
cost, 0.5 sum rho(|r|^2) over the kept slots (Huber rho of threshold
`delta`), a 0-d tensor in the values' dtype.  The step (`Step`) is the
camera solver's d_cam (6C + 3M,) with what back-substitution reads from
the reduce (`ops.ba_reduce_slots`: W, Hpp_inv, g_pt) and the mutability
masks: the points' step is d_pt = -Hpp_inv (g_pt + sum_v W^T dc)
point_mut (`backsub`), the cameras' d_cam times pose_mut and intr_mut.
Without a step it is the problem's own values and their cost.  The prior
terms are not in it: ba/lm adds them after any sum over ranks.

On CUDA tensors it is one launch of the hand-written kernel
`ops/csrc/ba_candidate_cost.cu`, which adds the cost in double in a fixed
order (no float atomics: two launches give the same bits); a failed build
or launch raises, there is no fallback.  On CPU tensors it is the plain
version, `candidate_cost_plain`: the composition ba/lm evaluated before
the kernel (`backsub`, the candidate's adds, `robust_cost` of
`residuals`), bit for bit.  Any other device raises.  Float32 or float64.

This is a port-only kernel: the JAX package writes these steps as einsums
and elementwise ops (`metricsfm_tpu/ba/lm.py`), which XLA fuses.
`candidate_cost.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import numbers
from typing import NamedTuple

import torch

from . import cuda_build, projection

_SYMBOLS = {torch.float32: "ba_candidate_cost_f32_launch",
            torch.float64: "ba_candidate_cost_f64_launch"}
_fns = {}
# per (device, stream): the kernel's cross-block partials (float64) and its
# ticket (int32, 0 between launches); launches on one stream run in order
_workspace = {}


class Step(NamedTuple):
    """One LM step as the camera solver leaves it: d_cam (6C + 3M,), the
    reduce's W (P, V, 9, 3), Hpp_inv (P, 3, 3) and g_pt (P, 3), and the
    mutability masks pose_mut (C,), intr_mut (M,), point_mut (P,)."""
    d_cam: torch.Tensor
    W: torch.Tensor
    Hpp_inv: torch.Tensor
    g_pt: torch.Tensor
    pose_mut: torch.Tensor
    intr_mut: torch.Tensor
    point_mut: torch.Tensor


def residuals(poses, intrs, points, cam_model, track_cam, track_uv,
              track_weight, track_mask):
    """(P, V, 2) reprojection residuals scaled by sqrt(track_weight) and
    the mask."""
    pose = poses[track_cam]                                   # (P,V,6)
    intr = intrs[cam_model[track_cam]]                        # (P,V,3)
    pts = points[:, None, :].expand(-1, track_cam.shape[1], -1)
    r = projection.reprojection_residual(pose, intr, pts, track_uv)
    w = torch.sqrt(track_weight)[:, None, None]
    return r * w * track_mask.to(r.dtype)[:, :, None]


def robust_cost(r, mask, delta):
    """Total Huber cost, 0.5 * sum rho(|r|^2) over valid observations."""
    s = torch.sum(r * r, dim=-1)
    rho = torch.where(s <= delta * delta, s,
                      2.0 * delta * torch.sqrt(torch.clamp(s, min=1e-20))
                      - delta * delta)
    return 0.5 * torch.sum(rho * mask.to(r.dtype))


def backsub(W, Hpp_inv, g_pt, d_cam, cam_model, track_cam, point_mut):
    """Point back-substitution: d_pt = -Hpp_inv (g_pt + E^T d_cam)."""
    C = cam_model.shape[0]
    M = (d_cam.shape[0] - 6 * C) // 3
    dp = d_cam[:6 * C].reshape(C, 6)
    di = d_cam[6 * C:].reshape(M, 3)
    d9 = torch.cat([dp, di[cam_model]], dim=1)                  # (C,9)
    dc = d9[track_cam]                                          # (P,V,9)
    Et = torch.einsum("pvik,pvi->pk", W, dc)
    d_pt = -torch.einsum("pij,pj->pi", Hpp_inv, g_pt + Et)
    return d_pt * point_mut[:, None]


def candidate_cost_plain(poses, intrs, points, cam_model, track_cam,
                         track_uv, track_weight, track_mask, delta,
                         step=None):
    """The plain version: `candidate_cost`'s outputs from `backsub`, the
    candidate's adds and `robust_cost` of `residuals`, in the values'
    dtype."""
    if step is not None:
        C, M = poses.shape[0], intrs.shape[0]
        d_pt = backsub(step.W, step.Hpp_inv, step.g_pt, step.d_cam,
                       cam_model, track_cam, step.point_mut)
        d_pose = step.d_cam[:6 * C].reshape(C, 6) * step.pose_mut[:, None]
        d_intr = step.d_cam[6 * C:].reshape(M, 3) * step.intr_mut[:, None]
        poses, intrs, points = poses + d_pose, intrs + d_intr, points + d_pt
    r = residuals(poses, intrs, points, cam_model, track_cam, track_uv,
                  track_weight, track_mask)
    return poses, intrs, points, robust_cost(r, track_mask, delta)


def _kernel(dtype):
    """The launch function for `dtype` and the library's block count."""
    if dtype not in _fns:
        lib = cuda_build.load_library("ba_candidate_cost")
        fn = getattr(lib, _SYMBOLS[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 15
                       + [ctypes.c_longlong] + [ctypes.c_int] * 3
                       + [ctypes.c_double] + [ctypes.c_void_p] * 5
                       + [ctypes.c_longlong] + [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        blocks = lib.candidate_cost_blocks
        blocks.argtypes = [ctypes.c_longlong, ctypes.c_int]
        blocks.restype = ctypes.c_longlong
        _fns[dtype] = fn, blocks
    return _fns[dtype]


def _check(poses, intrs, points, cam_model, track_cam, track_uv,
           track_weight, track_mask, delta, step):
    dtype = points.dtype
    if dtype not in _SYMBOLS:
        raise TypeError("candidate_cost takes float32 or float64 problems, "
                        f"got {dtype}")
    P, V = track_cam.shape
    C, M = poses.shape[0], intrs.shape[0]
    values = {"poses": (poses, (C, 6)), "intrs": (intrs, (M, 3)),
              "points": (points, (P, 3)), "track_uv": (track_uv, (P, V, 2)),
              "track_weight": (track_weight, (P,))}
    masks = {}
    if step is not None:
        values.update(d_cam=(step.d_cam, (6 * C + 3 * M,)),
                      W=(step.W, (P, V, 9, 3)),
                      Hpp_inv=(step.Hpp_inv, (P, 3, 3)),
                      g_pt=(step.g_pt, (P, 3)))
        masks = {"pose_mut": (step.pose_mut, (C,)),
                 "intr_mut": (step.intr_mut, (M,)),
                 "point_mut": (step.point_mut, (P,))}
    for name, (t, _) in values.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, the points {dtype}")
    for name, (t, _) in masks.items():
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating, got {t.dtype}")
    for name, t in (("cam_model", cam_model), ("track_cam", track_cam)):
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {t.dtype}")
    if track_mask.dtype != torch.bool:
        raise TypeError(f"track_mask must be bool, got {track_mask.dtype}")
    if isinstance(delta, bool) or not isinstance(delta, numbers.Real):
        raise TypeError(f"delta must be a real number, got {type(delta)}")
    want = dict(values, **masks, cam_model=(cam_model, (C,)),
                track_mask=(track_mask, (P, V)))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    devices = {t.device for t, _ in want.values()} | {track_cam.device}
    if len(devices) != 1:
        raise ValueError("candidate_cost takes tensors on one device, got "
                         f"{sorted(map(str, devices))}")


def _scratch(dev, stream, blocks):
    """The (partials, ticket) of launches on `stream`, partials grown to
    `blocks` doubles at least."""
    key = (dev.index, stream)
    ws = _workspace.get(key)
    if ws is None or ws[0].numel() < blocks:
        ticket = ws[1] if ws is not None else torch.zeros(
            1, dtype=torch.int32, device=dev)
        ws = (torch.empty(blocks, dtype=torch.float64, device=dev), ticket)
        _workspace[key] = ws
    return ws


def _launch(poses, intrs, points, cam_model, track_cam, track_uv,
            track_weight, track_mask, delta, step):
    """One launch of the kernel on the current stream."""
    P, V = track_cam.shape
    C, M = poses.shape[0], intrs.shape[0]
    dev, dtype = points.device, points.dtype
    fn, n_blocks = _kernel(dtype)
    ins = [t.contiguous() for t in (poses, intrs, points, cam_model,
                                    track_cam, track_uv, track_weight,
                                    track_mask)]
    cost = torch.empty((), dtype=dtype, device=dev)
    if step is None:
        extra = [None] * 7
        outs = (poses, intrs, points)
        ptrs = [None] * 3
    else:
        extra = [t.contiguous() for t in step[:4]] + [
            t.to(dtype).contiguous() for t in step[4:]]
        outs = tuple(torch.empty_like(t, memory_format=torch.contiguous_format)
                     for t in (poses, intrs, points))
        ptrs = [t.data_ptr() for t in outs]
    stream = torch.cuda.current_stream(dev).cuda_stream
    partials, ticket = _scratch(dev, stream, n_blocks(P, V))
    args = ([t.data_ptr() for t in ins]
            + [None if t is None else t.data_ptr() for t in extra]
            + [P, V, C, M, float(delta)] + ptrs
            + [cost.data_ptr(), partials.data_ptr(), partials.numel(),
               ticket.data_ptr(), stream])
    if dev.index == torch.cuda.current_device():
        rc = fn(*args)
    else:                          # the launch goes to the current device
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"ba_candidate_cost kernel launch failed: "
                           f"cudaError {rc}")
    candidate_cost.launches += 1
    return (*outs, cost)


def candidate_cost(poses, intrs, points, cam_model, track_cam, track_uv,
                   track_weight, track_mask, delta: float,
                   step: Step = None):
    """(poses, intrs, points, cost) of the candidate of `step` (see the
    module's docstring), or of the problem's own values with no step.
    CUDA tensors: one launch of the kernel on the current stream, counted
    in `candidate_cost.launches`; CPU tensors: `candidate_cost_plain`.
    Every tensor on one device; the values float32 or float64, the masks
    floating (taken in the values' dtype)."""
    args = (poses, intrs, points, cam_model, track_cam, track_uv,
            track_weight, track_mask)
    _check(*args, delta, step)
    dev = points.device.type
    if dev == "cuda":
        return _launch(*args, delta, step)
    if dev == "cpu":
        return candidate_cost_plain(*args, delta, step)
    raise ValueError(f"candidate_cost has no implementation for device "
                     f"{dev!r}")


candidate_cost.launches = 0
