"""SGM kernels: census + cost volume, 8-path aggregation, WTA.

Counterpart of metricsfm_tpu/ops/pallas/sgm_kernel.py.  Six kernels, each
a wrapper here with its plain PyTorch version beside it:

  census_cost      (2c) <- census_cost_pallas / _census_cost_kernel
  sgm_horizontal   (2d) <- _horizontal_pass / _horizontal_kernel
  sgm_partial      (2e) <- _partial_sum / _vertical_fwd_kernel
  sgm_total_wta    (2f) <- aggregate_wta_pallas / _vertical_bwd_kernel
  sgm_total        (2g) <- aggregate_paths_pallas / _vertical_bwd_total_kernel
  wta              (2h) <- wta_pallas / _wta_kernel

2c-2f carry the fused stereo path (ops/sgm.stereo_sgm).  2c, 2d, 2e, 2g
and 2h (twice: the left volume and the skewed right one) carry the volume
path (ops/sgm.stereo_sgm_volume, through ops/sgm.aggregate_paths and
ops/sgm.winner_takes_all).

On a CUDA tensor a wrapper launches its kernel (ops/csrc/sgm_census.cu,
ops/csrc/sgm_aggregate.cu) or raises; on a CPU tensor it runs the plain
version; any other device raises.  Each wrapper counts its launches in
`<wrapper>.launches`.

Layouts hold the semantics, not the TPU's padding: the cost volume is
(H, W, D) uint8 (Hamming costs <= 64), aggregated volumes are (H, W, D)
int16 (a path value is <= 64 + P2 and the 8-path sum <= 8 * 184 = 1,472),
and the WTA maps are (H, W) int32.  On the card 2d, 2e and the up pass
of 2f and 2g pass single path values between their launches in scratch
volumes of `scratch_dtype(P2)`: uint8 while 64 + P2 <= 255, int16 above.
All values are integers, so kernel and plain version agree exactly whatever the
order of the sums.  2h also takes int32 and float32 volumes (float32 maps
but an int32 `best`); a float minimum is exact too, so there as well the
two agree exactly.  Semantics:

  * census: 9x7 window, bit = centre > neighbour, zero-padded context,
    bits in dy-outer / dx-inner order with the centre skipped, bits 0-31
    in word 0 and 32-61 in word 1.  Words are held as int64 tensors with
    values in [0, 2^32): torch has no uint32 bit operations on every
    backend.
  * cost(y, x, d) = popcount(cl(y, x) ^ cr(y, x - d)), and 64 where x < d.
  * path recurrence L = c + min(prev, prev[d-1] + P1, prev[d+1] + P1,
    m + P2) - m with m = min_d prev; disparities outside [0, D) count as
    +big; the first pixel of every path is L = c (a uniform carry, i.e. a
    restart).
  * WTA (left): c0 = min_d, best = argmin (ties -> smallest d), c1 = the
    min over |d - best| > 1 capped at 2 * 8000 (the TPU kernel's masked
    fill), and cm/cc/cp at clip(best, 1, D-2) -1/0/+1.
    WTA (right, integer only): the same c0/best/c1 over
    cost_r(x, d) = total(x + d, d), with 30000 where x + d >= W.
  * 2h: the left WTA maps of any volume, with c1 capped at `c1_cap`
    (ops/sgm.winner_takes_all passes 30000 for an integer volume and 1e9
    for a float one, as the JAX package's winner_takes_all does).
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_RESTART = 16000       # uniform carry == "the path restarts here"
_C1_CAP = 16000        # c1 fill of the excluded |d - best| <= 1 lanes
_RIGHT_OOR = 30000     # cost_r where x + d >= W
MAX_DISP = 256         # 32 lanes x 8 disparities per lane in a warp

WTA_LEFT = ("c0", "best", "c1", "cm", "cc", "cp")
WTA_RIGHT = ("c0", "best", "c1")


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def census_transform(img, win_h: int = 9, win_w: int = 7):
    """Census over a (H, W) float image -> (2, H, W) int64 words."""
    H, W = img.shape
    rh, rw = win_h // 2, win_w // 2
    pad = torch.nn.functional.pad(img[None, None], (rw, rw, rh, rh))[0, 0]
    words = torch.zeros((2, H, W), dtype=torch.int64, device=img.device)
    k = 0
    for dy in range(win_h):
        for dx in range(win_w):
            if dy == rh and dx == rw:
                continue
            bit = (img > pad[dy:dy + H, dx:dx + W]).long() << (k % 32)
            words[k // 32] |= bit
            k += 1
    return words


def _popcount32(x):
    """Bit count of int64 tensors holding values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def matching_cost_volume(census_l, census_r, max_disp: int):
    """(H, W, D) uint8 Hamming cost volume from (2, H, W) census words."""
    _, H, W = census_l.shape
    vol = torch.full((H, W, max_disp), 64, dtype=torch.uint8,
                     device=census_l.device)
    for d in range(min(max_disp, W)):
        x = census_l[:, :, d:] ^ census_r[:, :, :W - d]
        vol[:, d:, d] = (_popcount32(x[0]) + _popcount32(x[1])).to(torch.uint8)
    return vol


def census_cost_reference(left, right, max_disp: int):
    """Plain version of kernel 2c: 9x7 census of both images + volume."""
    return matching_cost_volume(census_transform(left),
                                census_transform(right), max_disp)


def _step(prev, c, p1: int, p2: int):
    """One SGM recurrence, disparity on the last axis (int32)."""
    m = prev.amin(dim=-1, keepdim=True)
    edge = torch.full_like(prev[..., :1], _RESTART)
    sp = torch.cat([edge, prev[..., :-1]], dim=-1)
    sn = torch.cat([prev[..., 1:], edge], dim=-1)
    best = torch.minimum(torch.minimum(prev, m + p2),
                         torch.minimum(sp, sn) + p1)
    return c + best - m


def _shift(prev, s: int):
    """Move a (M, D) carry by s in {-1, 0, +1} along M; the cell shifted
    in is uniform (restart).  s=+1: out[x] = prev[x-1]."""
    if s == 0:
        return prev
    fill = torch.full_like(prev[:1], _RESTART)
    if s > 0:
        return torch.cat([fill, prev[:-1]], dim=0)
    return torch.cat([prev[1:], fill], dim=0)


def _scan(cost, reverse: bool, shifts, p1: int, p2: int):
    """Paths along the leading axis of a (N, M, D) volume, one carry per
    entry of `shifts` (0: straight; +-1: the carry moves one cell along M
    per step, i.e. a diagonal).  Returns the sum of those paths, int32."""
    out = torch.empty(cost.shape, dtype=torch.int32, device=cost.device)
    carries = [torch.full(cost.shape[1:], _RESTART, dtype=torch.int32,
                          device=cost.device) for _ in shifts]
    order = range(cost.shape[0] - 1, -1, -1) if reverse \
        else range(cost.shape[0])
    for i in order:
        c = cost[i].to(torch.int32)
        for j, s in enumerate(shifts):
            carries[j] = _step(_shift(carries[j], s), c, p1, p2)
        out[i] = sum(carries)
    return out


def _vertical_shifts(num_paths: int):
    return (0, 1, -1) if num_paths >= 8 else (0,)


def horizontal_reference(cost, p1: int = 10, p2: int = 120):
    """Plain version of kernel 2d: left->right + right->left paths, int16."""
    ct = cost.transpose(0, 1)
    h = _scan(ct, False, (0,), p1, p2) + _scan(ct, True, (0,), p1, p2)
    return h.transpose(0, 1).contiguous().to(torch.int16)


def partial_reference(cost, hsum, p1: int = 10, p2: int = 120,
                      num_paths: int = 8):
    """Plain version of kernel 2e: hsum + down (+ down-right, down-left)."""
    down = _scan(cost, False, _vertical_shifts(num_paths), p1, p2)
    return (hsum.to(torch.int32) + down).to(torch.int16)


def total_reference(cost, partial, p1: int = 10, p2: int = 120,
                    num_paths: int = 8):
    """The aggregation half of kernel 2f: partial + up (+ up-right,
    up-left) = the full 4/8-path sum, int16."""
    up = _scan(cost, True, _vertical_shifts(num_paths), p1, p2)
    return (partial.to(torch.int32) + up).to(torch.int16)


def _wta(vol, cap_c1):
    """c0, best, c1 over the last axis of an int32 or float32 volume."""
    D = vol.shape[-1]
    best = vol.argmin(dim=-1)                   # ties -> the first d
    c0 = vol.gather(-1, best[..., None])[..., 0]
    d = torch.arange(D, device=vol.device)
    near = (d - best[..., None]).abs() <= 1     # always holds at d = best
    c1 = vol.masked_fill(near, cap_c1).amin(dim=-1)
    return c0, best, c1


def skew_right(vol, fill):
    """The right view's volume vol_r(x, d) = vol(x + d, d), `fill` where
    x + d >= W, in one gather over an (H, W, D) volume."""
    H, W, D = vol.shape
    dev = vol.device
    xs = torch.arange(W, device=dev)[:, None] + torch.arange(D, device=dev)
    dd = torch.arange(D, device=dev).expand(W, D)
    return vol[:, xs.clamp(max=W - 1), dd].masked_fill_(xs >= W, fill)


def wta_reference(vol, c1_cap):
    """Plain version of kernel 2h: the WTA_LEFT maps of an (H, W, D)
    volume.  int16 / int32 volumes give int32 maps; a float32 volume gives
    float32 maps and an int32 `best`."""
    if vol.is_floating_point():
        v, cap = vol, float(c1_cap)
    else:
        v, cap = vol.to(torch.int32), int(c1_cap)
    D = v.shape[-1]
    c0, best, c1 = _wta(v, cap)
    bm = best.clamp(1, D - 2)[..., None]
    return {"c0": c0, "best": best.to(torch.int32), "c1": c1,
            "cm": v.gather(-1, bm - 1)[..., 0],
            "cc": v.gather(-1, bm)[..., 0],
            "cp": v.gather(-1, bm + 1)[..., 0]}


def wta_maps_reference(total):
    """The WTA epilogue of kernel 2f on a (H, W, D) total: (left, right)
    dicts of (H, W) int32 maps (WTA_LEFT / WTA_RIGHT keys)."""
    t = total.to(torch.int32)
    left = wta_reference(t, _C1_CAP)
    r0, rbest, r1 = _wta(skew_right(t, _RIGHT_OOR), _C1_CAP)
    right = {"c0": r0, "best": rbest.to(torch.int32), "c1": r1}
    return left, right


def total_wta_reference(cost, partial, p1: int = 10, p2: int = 120,
                        num_paths: int = 8):
    """Plain version of kernel 2f: up paths onto `partial`, then both WTAs."""
    return wta_maps_reference(total_reference(cost, partial, p1, p2,
                                              num_paths))


# --------------------------------------------------------------------------
# argument checks and kernel launches
# --------------------------------------------------------------------------

def _check_penalties(p1: int, p2: int, num_paths: int):
    if num_paths not in (4, 8):
        raise ValueError(f"num_paths must be 4 or 8, got {num_paths}")
    # a path value is <= 64 + P2; the 8-path sum must fit int16
    if not (0 <= p1 and 0 <= p2 and 8 * (64 + p2) <= 32767):
        raise ValueError(f"penalties out of range: P1={p1}, P2={p2}")


def _check_volume(name, t, dtype, shape=None):
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if t.dim() != 3 or t.dtype not in dtypes:
        raise TypeError(f"{name} must be a 3-D {dtype} tensor, got "
                        f"{t.dtype} {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    D = t.shape[2]
    if not 4 <= D <= MAX_DISP:
        raise ValueError(f"disparity count {D} outside [4, {MAX_DISP}]")


def _device_of(*ts):
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("all SGM operands must share a device")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"SGM kernels have no implementation for {dev}")
    return dev


def _launch(lib_name, fn_name, dev, ptrs, scalars):
    """Call a C entry `fn(ptrs..., scalars..., stream)` of
    csrc/<lib_name>.cu on the current stream (a tensor passes as its
    pointer, None as a null pointer; a Python float as a C float, anything
    else as an int); raise if it returns a CUDA error."""
    fn = getattr(cuda_build.load_library(lib_name), fn_name)
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + \
        [ctypes.c_float if isinstance(v, float) else ctypes.c_int
         for v in scalars] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(None if t is None else t.data_ptr() for t in ptrs),
                *scalars, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: cudaError {rc}")


def census_cost(left, right, max_disp: int):
    """Kernel 2c: (H, W) float32 left/right -> (H, W, D) uint8 volume.  On
    the card one launch builds both census transforms in shared memory, a
    row tile at a time, and writes the volume 16 bytes a store; it needs no
    scratch beyond the volume it returns."""
    if left.dim() != 2 or left.dtype != torch.float32 \
            or right.shape != left.shape or right.dtype != torch.float32:
        raise TypeError("left and right must be (H, W) float32 of one shape")
    if not (left.is_contiguous() and right.is_contiguous()):
        raise ValueError("left and right must be contiguous")
    if not 4 <= max_disp <= MAX_DISP:
        raise ValueError(f"max_disp {max_disp} outside [4, {MAX_DISP}]")
    if left.shape[0] > 65535:
        raise ValueError(f"image height {left.shape[0]} > 65535")
    dev = _device_of(left, right)
    if dev.type == "cpu":
        return census_cost_reference(left, right, max_disp)
    H, W = left.shape
    vol = torch.empty((H, W, max_disp), dtype=torch.uint8, device=dev)
    _launch("sgm_census", "sgm_census_cost_launch", dev,
            (left, right, vol), (H, W, max_disp))
    census_cost.launches += 1
    return vol


census_cost.launches = 0


def scratch_dtype(p2: int):
    """The type of the single-path scratch volumes of kernels 2d-2g: a
    single path value is <= 64 + P2, so uint8 where that is <= 255, int16
    above."""
    if p2 < 0:
        raise ValueError(f"P2 must be >= 0, got {p2}")
    return torch.uint8 if 64 + p2 <= 255 else torch.int16


def sgm_horizontal(cost, p1: int = 10, p2: int = 120):
    """Kernel 2d: left->right + right->left path sum, (H, W, D) int16.  On
    the card the left->right path goes through a single-path scratch
    volume (`scratch_dtype(p2)`), freed before the call returns."""
    _check_volume("cost", cost, torch.uint8)
    _check_penalties(p1, p2, 8)
    dev = _device_of(cost)
    if dev.type == "cpu":
        return horizontal_reference(cost, p1, p2)
    H, W, D = cost.shape
    st = scratch_dtype(p2)
    scratch = torch.empty((H, W, D), dtype=st, device=dev)
    out = torch.empty((H, W, D), dtype=torch.int16, device=dev)
    _launch("sgm_aggregate", "sgm_horizontal_launch", dev,
            (cost, scratch, out),
            (H, W, D, p1, p2, int(st == torch.int16)))
    sgm_horizontal.launches += 1
    return out


sgm_horizontal.launches = 0


def _diag_scratch(shape, p2: int, num_paths: int, dev):
    """The two single-path scratch volumes of a vertical stage's diagonals
    (8 paths; None, None with 4) and the scratch-type flag of its C
    entry."""
    st = scratch_dtype(p2)
    if num_paths < 8:
        return None, None, int(st == torch.int16)
    sa, sb = torch.empty((2, *shape), dtype=st, device=dev)
    return sa, sb, int(st == torch.int16)


def sgm_partial(cost, hsum, p1: int = 10, p2: int = 120,
                num_paths: int = 8):
    """Kernel 2e: hsum + down (+ both down diagonals), (H, W, D) int16.
    On the card with 8 paths the two diagonals go through two single-path
    scratch volumes (`scratch_dtype(p2)`), freed before the call
    returns."""
    _check_volume("cost", cost, torch.uint8)
    _check_volume("hsum", hsum, torch.int16, cost.shape)
    _check_penalties(p1, p2, num_paths)
    dev = _device_of(cost, hsum)
    if dev.type == "cpu":
        return partial_reference(cost, hsum, p1, p2, num_paths)
    H, W, D = cost.shape
    dr, dl, s16 = _diag_scratch(cost.shape, p2, num_paths, dev)
    out = torch.empty((H, W, D), dtype=torch.int16, device=dev)
    _launch("sgm_aggregate", "sgm_partial_launch", dev,
            (cost, hsum, dr, dl, out),
            (H, W, D, p1, p2, int(num_paths >= 8), s16))
    sgm_partial.launches += 1
    return out


sgm_partial.launches = 0


def sgm_total_wta(cost, partial, p1: int = 10, p2: int = 120,
                  num_paths: int = 8):
    """Kernel 2f: up paths onto `partial`, then the left and right WTA
    maps.  Returns (left, right) dicts of (H, W) int32 maps.  On the card
    the up pass is 2g's (with 8 paths the two up diagonals go through two
    single-path scratch volumes of `scratch_dtype(p2)`) into an int16
    total, which the WTA kernel reads in row tiles; the scratch and the
    total are freed before the call returns."""
    _check_volume("cost", cost, torch.uint8)
    _check_volume("partial", partial, torch.int16, cost.shape)
    _check_penalties(p1, p2, num_paths)
    dev = _device_of(cost, partial)
    if dev.type == "cpu":
        return total_wta_reference(cost, partial, p1, p2, num_paths)
    H, W, D = cost.shape
    ur, ul, s16 = _diag_scratch(cost.shape, p2, num_paths, dev)
    total = torch.empty((H, W, D), dtype=torch.int16, device=dev)
    maps = torch.empty((9, H, W), dtype=torch.int32, device=dev)
    _launch("sgm_aggregate", "sgm_total_wta_launch", dev,
            (cost, partial, ur, ul, total, maps),
            (H, W, D, p1, p2, int(num_paths >= 8), s16))
    sgm_total_wta.launches += 1
    left = dict(zip(WTA_LEFT, maps[:6]))
    right = dict(zip(WTA_RIGHT, maps[6:]))
    return left, right


sgm_total_wta.launches = 0


def sgm_total(cost, partial, p1: int = 10, p2: int = 120,
              num_paths: int = 8):
    """Kernel 2g: up paths onto `partial`, the full 4/8-path sum as an
    (H, W, D) int16 volume.  On the card with 8 paths the two up
    diagonals go through two single-path scratch volumes
    (`scratch_dtype(p2)`), freed before the call returns."""
    _check_volume("cost", cost, torch.uint8)
    _check_volume("partial", partial, torch.int16, cost.shape)
    _check_penalties(p1, p2, num_paths)
    dev = _device_of(cost, partial)
    if dev.type == "cpu":
        return total_reference(cost, partial, p1, p2, num_paths)
    H, W, D = cost.shape
    ur, ul, s16 = _diag_scratch(cost.shape, p2, num_paths, dev)
    total = torch.empty((H, W, D), dtype=torch.int16, device=dev)
    _launch("sgm_aggregate", "sgm_total_launch", dev,
            (cost, partial, ur, ul, total),
            (H, W, D, p1, p2, int(num_paths >= 8), s16))
    sgm_total.launches += 1
    return total


sgm_total.launches = 0

_WTA_DTYPES = {torch.int16: 0, torch.int32: 1, torch.float32: 2}


def wta(vol, c1_cap):
    """Kernel 2h: the WTA_LEFT maps (c0, best, c1, cm, cc, cp) of an
    (H, W, D) int16, int32 or float32 volume, c1 capped at `c1_cap`.
    Returns a dict of (H, W) maps: int32 for an integer volume; float32
    but an int32 `best` for a float32 one.  On the card one launch streams
    the volume once, 32 pixels a warp; a float c0 or c1 of zero comes back
    as +0.0 (a -0.0 ties with it, as in argmin)."""
    _check_volume("vol", vol, tuple(_WTA_DTYPES))
    floating = vol.is_floating_point()
    if not floating and c1_cap != int(c1_cap):
        raise ValueError(f"c1_cap {c1_cap} must be an integer for an "
                         f"integer volume")
    # the kernel takes the cap as a C float: keep it exact
    if float(torch.tensor(float(c1_cap), dtype=torch.float32)) != c1_cap:
        raise ValueError(f"c1_cap {c1_cap} is not exact in float32")
    dev = _device_of(vol)
    if dev.type == "cpu":
        return wta_reference(vol, c1_cap)
    H, W, D = vol.shape
    vals = torch.empty((5, H, W), dtype=torch.float32 if floating
                       else torch.int32, device=dev)
    best = torch.empty((H, W), dtype=torch.int32, device=dev)
    _launch("sgm_aggregate", "sgm_wta_launch", dev, (vol, vals, best),
            (H, W, D, _WTA_DTYPES[vol.dtype], float(c1_cap)))
    wta.launches += 1
    maps = dict(zip(("c0", "c1", "cm", "cc", "cp"), vals))
    maps["best"] = best
    return {k: maps[k] for k in WTA_LEFT}


wta.launches = 0

KERNELS = (census_cost, sgm_horizontal, sgm_partial, sgm_total_wta,
           sgm_total, wta)


def reset_launches():
    for k in KERNELS:
        k.launches = 0
