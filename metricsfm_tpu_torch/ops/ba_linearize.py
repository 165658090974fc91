"""Bundle adjustment's linearization of every observation slot.

`linearize` returns, for the (P, V) observation slots of a BA problem,
the reprojection residuals r (P, V, 2) and their Jacobians in the pose
(P, V, 2, 6), the camera model (P, V, 2, 3) and the point (P, V, 2, 3),
each scaled by sqrt(track_weight), the slot's mask and the Huber weight
sqrt(rho'(s)) of the scaled residual (`robust_weights`): what both camera
solvers of `ba/lm` reduce (`ops.ba_reduce_slots`).  A masked slot is zero.

On CUDA tensors it is one launch of the hand-written kernel
`ops/csrc/ba_linearize.cu` (analytic derivatives of the same expressions;
a masked slot is written as zeros, unprojected); a failed build or launch
raises, there is no fallback.  On CPU tensors it is the plain version,
`linearize_plain`: `vmap(jacfwd)` of `ops/projection.reprojection_residual`
over the flattened slots, masked slots selected to zero before any
scaling (so a slot whose projection or derivative is not finite is zero
on both devices), then scaled by the track weights and the Huber weights.
Any other device raises.  Float32 or float64.

This is a port-only kernel: the JAX package linearizes with
`jax.vmap(jax.jacfwd)` (`metricsfm_tpu/ba/lm.py:85-107`), which XLA fuses.
`linearize.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
from torch.func import jacfwd, vmap

from . import cuda_build, projection

_SYMBOLS = {torch.float32: "ba_linearize_f32_launch",
            torch.float64: "ba_linearize_f64_launch"}
_fns = {}


def _residual_aux(pose, intr, point, uv):
    """One slot's residual twice: jacfwd(has_aux=True) then yields (J, r)."""
    r = projection.reprojection_residual(pose, intr, point, uv)
    return r, r


_rj = vmap(jacfwd(_residual_aux, argnums=(0, 1, 2), has_aux=True))


def robust_weights(r, delta):
    """sqrt(rho'(s)) for Huber rho (Ceres: rho(s) = s | 2 d sqrt(s) - d^2)."""
    s = torch.sum(r * r, dim=-1)
    w2 = torch.where(s <= delta * delta, 1.0,
                     delta / torch.sqrt(torch.clamp(s, min=1e-20)))
    return torch.sqrt(w2)


def linearize_plain(poses, intrs, points, cam_model, track_cam, track_uv,
                    track_weight, track_mask, delta):
    """The plain version: `linearize`'s outputs from `vmap(jacfwd)` of the
    reprojection residual, in the values' dtype."""
    P, V = track_cam.shape
    (Jpo, Jin, Jpt), r = _rj(
        poses[track_cam].reshape(-1, 6),
        intrs[cam_model[track_cam]].reshape(-1, 3),
        points[:, None, :].expand(-1, V, -1).reshape(-1, 3),
        track_uv.reshape(-1, 2))
    keep = track_mask.reshape(P, V, 1)
    w = torch.sqrt(track_weight)[:, None, None]
    r = torch.where(keep, r.reshape(P, V, 2), 0.0) * w
    Js = [torch.where(keep[..., None], J.reshape(P, V, 2, -1), 0.0)
          * w[..., None] for J in (Jpo, Jin, Jpt)]
    rw = robust_weights(r, delta)[..., None]
    return (r * rw, *(J * rw[..., None] for J in Js))


def _kernel(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(cuda_build.load_library("ba_linearize"), _SYMBOLS[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 8
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_double]
                       + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _check(poses, intrs, points, cam_model, track_cam, track_uv,
           track_weight, track_mask):
    dtype = points.dtype
    if dtype not in _SYMBOLS:
        raise TypeError("linearize takes float32 or float64 problems, got "
                        f"{dtype}")
    for name, t in (("poses", poses), ("intrs", intrs),
                    ("track_uv", track_uv), ("track_weight", track_weight)):
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, the points {dtype}")
    for name, t in (("cam_model", cam_model), ("track_cam", track_cam)):
        if t.dtype != torch.int64:
            raise TypeError(f"{name} must be int64, got {t.dtype}")
    if track_mask.dtype != torch.bool:
        raise TypeError(f"track_mask must be bool, got {track_mask.dtype}")
    P, V = track_cam.shape
    C, M = poses.shape[0], intrs.shape[0]
    want = {"poses": (poses, (C, 6)), "intrs": (intrs, (M, 3)),
            "cam_model": (cam_model, (C,)), "points": (points, (P, 3)),
            "track_uv": (track_uv, (P, V, 2)),
            "track_weight": (track_weight, (P,)),
            "track_mask": (track_mask, (P, V))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    devices = {t.device for t in (poses, intrs, points, cam_model, track_cam,
                                  track_uv, track_weight, track_mask)}
    if len(devices) != 1:
        raise ValueError("linearize takes tensors on one device, got "
                         f"{sorted(map(str, devices))}")


def _launch(poses, intrs, points, cam_model, track_cam, track_uv,
            track_weight, track_mask, delta):
    """One launch of the kernel on the current stream."""
    P, V = track_cam.shape
    dev, dtype = points.device, points.dtype
    ins = [t.contiguous() for t in (poses, intrs, points, cam_model,
                                    track_cam, track_uv, track_weight,
                                    track_mask)]
    outs = [torch.empty((P, V, 2, *tail), dtype=dtype, device=dev)
            for tail in ((), (6,), (3,), (3,))]
    if P * V == 0:
        return tuple(outs)
    args = ([t.data_ptr() for t in ins] + [P * V, V, float(delta)]
            + [t.data_ptr() for t in outs]
            + [torch.cuda.current_stream(dev).cuda_stream])
    fn = _kernel(dtype)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args)
    else:                          # the launch goes to the current device
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"ba_linearize kernel launch failed: cudaError "
                           f"{rc}")
    linearize.launches += 1
    return tuple(outs)


def linearize(poses, intrs, points, cam_model, track_cam, track_uv,
              track_weight, track_mask, delta: float):
    """(r, Jpose, Jintr, Jpt) of every (P, V) slot, scaled by
    sqrt(track_weight), the mask and the Huber weights of threshold
    `delta`.  CUDA tensors: one launch of the kernel on the current
    stream, counted in `linearize.launches`; CPU tensors:
    `linearize_plain`.  The problem's tensors (ba/problem.BAProblem's
    fields of the same names) lie on one device; float32 or float64."""
    args = (poses, intrs, points, cam_model, track_cam, track_uv,
            track_weight, track_mask)
    _check(*args)
    dev = points.device.type
    if dev == "cuda":
        return _launch(*args, delta)
    if dev == "cpu":
        return linearize_plain(*args, delta)
    raise ValueError(f"linearize has no implementation for device {dev!r}")


linearize.launches = 0
