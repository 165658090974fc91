"""Bundle adjustment's linearization of every observation slot in one launch.

`linearize` returns, for the (P, V) observation slots of a BA problem,
the reprojection residuals r (P, V, 2) and their Jacobians in the pose
(P, V, 2, 6), the camera model (P, V, 2, 3) and the point (P, V, 2, 3),
each scaled by sqrt(track_weight), the slot's mask and the Huber weight
sqrt(rho'(s)) of the scaled residual: what `ba/lm._linearize` hands the
reduced camera system.  It is one launch of the hand-written kernel
`ops/csrc/ba_linearize.cu` (analytic derivatives of the same expressions;
a masked slot is zero), on CUDA tensors only: a failed build or launch
raises, there is no fallback.  The plain version is `ba/lm._linearize`'s
CPU branch, `vmap(jacfwd)` of `ops/projection.reprojection_residual`
scaled by the weights, the mask and `ba/lm.robust_weights`.

This is a port-only kernel: the JAX package linearizes with
`jax.vmap(jax.jacfwd)` (`metricsfm_tpu/ba/lm.py:85-107`), which XLA fuses.
`linearize.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_SYMBOLS = {torch.float32: "ba_linearize_f32_launch",
            torch.float64: "ba_linearize_f64_launch"}
_fns = {}


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
        raise TypeError("the linearize kernel takes float32 or float64 "
                        f"problems, got {dtype}")
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
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError("the linearize kernel takes tensors on one CUDA "
                         f"device, got {sorted(map(str, devices))}")


def linearize(poses, intrs, points, cam_model, track_cam, track_uv,
              track_weight, track_mask, delta: float):
    """(r, Jpose, Jintr, Jpt) of every (P, V) slot, scaled by
    sqrt(track_weight), the mask and the Huber weights of threshold
    `delta`: one launch of the kernel on the current stream, counted in
    `linearize.launches`.  The problem's tensors (ba/problem.BAProblem's
    fields of the same names) lie on one CUDA device; float32 or float64."""
    _check(poses, intrs, points, cam_model, track_cam, track_uv,
           track_weight, track_mask)
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


linearize.launches = 0
