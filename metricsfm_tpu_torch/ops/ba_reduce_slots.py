"""BA's reduce of every observation slot in one launch.

`reduce_slots(r, Jpo, Jin, Jpt, point_mut, lam)` takes a BA problem's
linearized (P, V) observation slots (`ops.ba_linearize.linearize`'s
outputs: r (P, V, 2) and the Jacobians in the pose (P, V, 2, 6), the
camera model (P, V, 2, 3) and the point (P, V, 2, 3), scaled by the
weights; a masked slot is zero) and returns what both camera solvers of
`ba/lm` sum and back-substitute: the dense path's S and rhs, and the PCG
path's rhs and block-Jacobi blocks.  With Jc = [Jpo | Jin] and
L L^T = Hpp_inv:

- Hpp_inv (P, 3, 3): the inverse of each point's block sum_v Jpt^T Jpt,
  damped by lam * max(diag, 1e-12) + 1e-12 and the identity where
  point_mut is 0 (`inv3x3`);
- g_pt (P, 3): sum_v Jpt^T r;
- W (P, V, 9, 3): Jc^T Jpt point_mut;
- U (P, V, 9, 3): W L (`chol3x3`), whose sums per (point, camera) and
  (point, model) are the dense Schur fill's factor, and whose U U^T is
  the slot's Schur part of a PCG block-Jacobi block;
- cam (P, V, 60): [Jpo^T Jpo (36) | Jpo^T Jin (18) | rv[:6]] and
  model (P, V, 12): [Jin^T Jin (9) | rv[6:]], with
  rv = W Hpp_inv g_pt - Jc^T r, so that each camera's and model's sum of
  its rows is its diagonal blocks of S and its share of the rhs.

On CUDA tensors it is one launch of the hand-written kernel
`ops/csrc/ba_reduce_slots.cu` (each point's sums in slot order, no
atomics); a failed build or launch raises, there is no fallback.  On CPU
tensors it is the plain version, `reduce_slots_plain`: the einsums both
solvers used before the kernel, grouped into the same rows.  Any other
device raises.  Float32 or float64.

This is a port-only kernel: the JAX package writes these products as
einsums against one-hot operands (`metricsfm_tpu/ba/lm.py:274-339`),
which XLA fuses.  `reduce_slots.launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import numbers

import torch

from . import cuda_build

CAM_ROW = 60      # Jpo^T Jpo (36), Jpo^T Jin (18), rv[:6]
MODEL_ROW = 12    # Jin^T Jin (9), rv[6:]

_SYMBOLS = {torch.float32: "ba_reduce_slots_f32_launch",
            torch.float64: "ba_reduce_slots_f64_launch"}
_fns = {}


def inv3x3(A, eps=1e-12):
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = torch.where(torch.abs(det) < eps, eps, det)
    rows = torch.stack([torch.stack([A11, A12, A13], dim=-1),
                        torch.stack([A21, A22, A23], dim=-1),
                        torch.stack([A31, A32, A33], dim=-1)], dim=-2)
    return rows / det[..., None, None]


def chol3x3(A, eps=1e-12):
    """Closed-form batched 3x3 Cholesky (lower)."""
    l11 = torch.sqrt(torch.clamp(A[..., 0, 0], min=eps))
    l21 = A[..., 1, 0] / l11
    l31 = A[..., 2, 0] / l11
    l22 = torch.sqrt(torch.clamp(A[..., 1, 1] - l21 * l21, min=eps))
    l32 = (A[..., 2, 1] - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(A[..., 2, 2] - l31 * l31 - l32 * l32,
                                 min=eps))
    z = torch.zeros_like(l11)
    return torch.stack([torch.stack([l11, z, z], dim=-1),
                        torch.stack([l21, l22, z], dim=-1),
                        torch.stack([l31, l32, l33], dim=-1)], dim=-2)


def reduce_slots_plain(r, Jpo, Jin, Jpt, point_mut, lam):
    """The plain version: `reduce_slots`' outputs from einsums and the
    closed-form 3x3 inverse and Cholesky, in the values' dtype."""
    P, V = r.shape[:2]
    dtype, dev = r.dtype, r.device
    Hpp = torch.einsum("pvri,pvrj->pij", Jpt, Jpt)
    g_pt = torch.einsum("pvri,pvr->pi", Jpt, r)
    diag_pp = torch.diagonal(Hpp, dim1=-2, dim2=-1)
    damp = lam * torch.clamp(diag_pp, min=1e-12) + 1e-12
    Hpp_d = Hpp + torch.diag_embed(damp)
    # frozen points: identity block (benign inverse; d_pt forced 0 later)
    pm = point_mut[:, None, None]
    Hpp_d = Hpp_d * pm + torch.eye(3, dtype=dtype, device=dev) * (1.0 - pm)
    Hpp_inv = inv3x3(Hpp_d)
    Jc = torch.cat([Jpo, Jin], dim=-1)                           # (P,V,2,9)
    W = torch.einsum("pvri,pvrj->pvij", Jc, Jpt) \
        * point_mut[:, None, None, None]
    U = torch.einsum("pvij,pjk->pvik", W, chol3x3(Hpp_inv))
    y = torch.einsum("pij,pj->pi", Hpp_inv, g_pt)
    rv = torch.einsum("pvij,pj->pvi", W, y) \
        - torch.einsum("pvri,pvr->pvi", Jc, r)                   # (P,V,9)
    cam = torch.cat([torch.einsum("pvri,pvrj->pvij", Jpo, Jpo).reshape(
                         P, V, 36),
                     torch.einsum("pvri,pvrj->pvij", Jpo, Jin).reshape(
                         P, V, 18),
                     rv[..., :6]], dim=-1)
    model = torch.cat([torch.einsum("pvri,pvrj->pvij", Jin, Jin).reshape(
                           P, V, 9),
                       rv[..., 6:]], dim=-1)
    return Hpp_inv, g_pt, W, U, cam, model


def _kernel(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        fn = getattr(cuda_build.load_library("ba_reduce_slots"),
                     _SYMBOLS[dtype])
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_double]
                       + [ctypes.c_void_p] * 7)
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _check(r, Jpo, Jin, Jpt, point_mut, lam):
    dtype = r.dtype
    if dtype not in _SYMBOLS:
        raise TypeError("reduce_slots takes float32 or float64 slots, got "
                        f"{dtype}")
    for name, t in (("Jpo", Jpo), ("Jin", Jin), ("Jpt", Jpt)):
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, r {dtype}")
    if not point_mut.is_floating_point():
        raise TypeError(f"point_mut must be floating, got {point_mut.dtype}")
    if isinstance(lam, bool) or not isinstance(lam, numbers.Real):
        raise TypeError(f"lam must be a real number, got {type(lam)}")
    if r.dim() != 3:
        raise ValueError(f"r has shape {tuple(r.shape)}, expected (P, V, 2)")
    P, V = r.shape[:2]
    want = {"r": (r, (P, V, 2)), "Jpo": (Jpo, (P, V, 2, 6)),
            "Jin": (Jin, (P, V, 2, 3)), "Jpt": (Jpt, (P, V, 2, 3)),
            "point_mut": (point_mut, (P,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    devices = {t.device for t in (r, Jpo, Jin, Jpt, point_mut)}
    if len(devices) != 1:
        raise ValueError("reduce_slots takes tensors on one device, got "
                         f"{sorted(map(str, devices))}")


def _launch(r, Jpo, Jin, Jpt, point_mut, lam):
    """One launch of the kernel on the current stream."""
    P, V = r.shape[:2]
    dev, dtype = r.device, r.dtype
    ins = [t.contiguous() for t in (r, Jpo, Jin, Jpt)]
    ins.append(point_mut.to(dtype).contiguous())
    outs = [torch.empty(shape, dtype=dtype, device=dev)
            for shape in ((P, 3, 3), (P, 3), (P, V, 9, 3), (P, V, 9, 3),
                          (P, V, CAM_ROW), (P, V, MODEL_ROW))]
    if P == 0:
        return tuple(outs)
    args = ([t.data_ptr() for t in ins] + [P, V, float(lam)]
            + [t.data_ptr() for t in outs]
            + [torch.cuda.current_stream(dev).cuda_stream])
    fn = _kernel(dtype)
    if dev.index == torch.cuda.current_device():
        rc = fn(*args)
    else:                          # the launch goes to the current device
        with torch.cuda.device(dev):
            rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"ba_reduce_slots kernel launch failed: cudaError "
                           f"{rc}")
    reduce_slots.launches += 1
    return tuple(outs)


def reduce_slots(r, Jpo, Jin, Jpt, point_mut, lam):
    """(Hpp_inv, g_pt, W, U, cam, model) of the linearized slots (see the
    module's docstring); `lam` is the LM damping, a Python number.  CUDA
    tensors: one launch of the kernel on the current stream, counted in
    `reduce_slots.launches`; CPU tensors: `reduce_slots_plain`.  Every
    tensor on one device; the slots float32 or float64, point_mut (P,)
    floating (taken in the slots' dtype)."""
    _check(r, Jpo, Jin, Jpt, point_mut, lam)
    dev = r.device.type
    if dev == "cuda":
        return _launch(r, Jpo, Jin, Jpt, point_mut, lam)
    if dev == "cpu":
        return reduce_slots_plain(r, Jpo, Jin, Jpt, point_mut.to(r.dtype),
                                  lam)
    raise ValueError(f"reduce_slots has no implementation for device "
                     f"{dev!r}")


reduce_slots.launches = 0
