"""Parity of the PyTorch port's geometry core with the JAX package.

Same seeded numpy inputs through metricsfm_tpu (JAX, CPU) and
metricsfm_tpu_torch (CPU), compared in f32 with the stated tolerances.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metricsfm_tpu import config as jconfig
from metricsfm_tpu.ops import epipolar as jepi
from metricsfm_tpu.ops import lie as jlie
from metricsfm_tpu.ops import polynomial as jpoly
from metricsfm_tpu.ops import projection as jproj
from metricsfm_tpu.ops import triangulation as jtri
from metricsfm_tpu.ops import umeyama as jume
from metricsfm_tpu_torch import config as tconfig
from metricsfm_tpu_torch.ops import epipolar as tepi
from metricsfm_tpu_torch.ops import lie as tlie
from metricsfm_tpu_torch.ops import polynomial as tpoly
from metricsfm_tpu_torch.ops import projection as tproj
from metricsfm_tpu_torch.ops import triangulation as ttri
from metricsfm_tpu_torch.ops import umeyama as tume
from tests.conftest import make_scene
from tests.torch_threads import torch_threads  # noqa: F401


def J(x):
    return jnp.asarray(np.asarray(x, np.float32))


def T(x):
    return torch.tensor(np.asarray(x, np.float32))


def close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("mode", ["web", "uav", "street"])
def test_config_presets_equal(mode):
    """Every field of every preset equals the JAX package's."""
    j = dataclasses.asdict(jconfig.PRESETS[mode]())
    t = dataclasses.asdict(tconfig.PRESETS[mode]())
    assert j == t


def _rotations(rng, n=64):
    aa = rng.normal(size=(n, 3)) * rng.uniform(0, 3.0, size=(n, 1))
    aa[:4] *= 1e-6                                    # small-angle branch
    return aa.astype(np.float32)


# (name, input builder, tolerance): f32 on both sides, differences are
# rounding only
LIE_CASES = [
    ("angle_axis_to_matrix", lambda r: [_rotations(r)], 2e-6),
    ("angle_axis_to_quaternion", lambda r: [_rotations(r)], 2e-6),
    ("matrix_to_angle_axis",
     lambda r: [np.asarray(jlie.angle_axis_to_matrix(J(_rotations(r))))],
     2e-5),
    ("matrix_to_quaternion",
     lambda r: [np.asarray(jlie.angle_axis_to_matrix(J(_rotations(r))))],
     2e-6),
    ("quaternion_to_matrix", lambda r: [r.normal(size=(64, 4))], 2e-6),
    ("quaternion_to_angle_axis",
     lambda r: [r.normal(size=(64, 4)) * [1, .5, .5, .5]], 2e-5),
    ("rotate_point", lambda r: [_rotations(r), r.normal(size=(64, 3))], 5e-6),
    ("hat", lambda r: [r.normal(size=(64, 3))], 0.0),
    ("euler_zyx_to_matrix", lambda r: [r.uniform(-1, 1, size=(64, 3))], 2e-6),
    ("euler_xyz_to_matrix", lambda r: [r.uniform(-1, 1, size=(64, 3))], 2e-6),
    ("matrix_to_euler_zyx",
     lambda r: [np.asarray(jlie.euler_zyx_to_matrix(J(r.uniform(-1, 1, (64, 3)))))],
     2e-5),
    ("matrix_to_euler_xyz",
     lambda r: [np.asarray(jlie.euler_xyz_to_matrix(J(r.uniform(-1, 1, (64, 3)))))],
     2e-5),
    ("project_to_so3",
     lambda r: [np.asarray(jlie.angle_axis_to_matrix(J(_rotations(r))))
                + 1e-3 * r.normal(size=(64, 3, 3))], 2e-5),
]


@pytest.mark.parametrize("name,build,atol", LIE_CASES,
                         ids=[c[0] for c in LIE_CASES])
def test_lie_parity(name, build, atol):
    args = build(np.random.default_rng(1))
    a = getattr(jlie, name)(*[J(x) for x in args])
    b = getattr(tlie, name)(*[T(x) for x in args])
    close(a, b, atol=atol)


def _cams(rng, n=32):
    poses = np.concatenate([_rotations(rng, n) * 0.3,
                            rng.normal(size=(n, 3))], axis=1)
    intrs = np.stack([rng.uniform(500, 1500, n), rng.normal(0, 0.05, n),
                      rng.normal(0, 0.01, n)], axis=1)
    pts = rng.normal(size=(n, 3)) + [0, 0, 8.0]
    return poses, intrs, pts


def test_projection_parity():
    rng = np.random.default_rng(2)
    poses, intrs, pts = _cams(rng)
    uv_j, z_j = jproj.project(J(poses), J(intrs), J(pts))
    uv_t, z_t = tproj.project(T(poses), T(intrs), T(pts))
    close(uv_j, uv_t, atol=2e-3, rtol=1e-5)        # px, |uv| ~ 1e3
    close(z_j, z_t, atol=1e-5)
    obs = np.asarray(uv_j) + rng.normal(size=(32, 2))
    close(jproj.reprojection_residual(J(poses), J(intrs), J(pts), J(obs)),
          tproj.reprojection_residual(T(poses), T(intrs), T(pts), T(obs)),
          atol=2e-3)
    close(jproj.camera_center(J(poses)), tproj.camera_center(T(poses)),
          atol=1e-5)
    o_j, d_j = jproj.backproject_ray(J(poses), J(intrs), J(obs))
    o_t, d_t = tproj.backproject_ray(T(poses), T(intrs), T(obs))
    close(o_j, o_t, atol=1e-5)
    close(d_j, d_t, atol=1e-6)
    close(jproj.compose_relative(J(poses), J(poses[::-1].copy())),
          tproj.compose_relative(T(poses), T(poses[::-1].copy())), atol=2e-5)
    xd = rng.normal(size=(32, 2)) * 0.3
    close(jproj.undistort_radial(J(xd), J(intrs[:, 1]), J(intrs[:, 2])),
          tproj.undistort_radial(T(xd), T(intrs[:, 1]), T(intrs[:, 2])),
          atol=1e-6)
    close(jproj.projection_matrix(J(poses), J(intrs)),
          tproj.projection_matrix(T(poses), T(intrs)), atol=1e-3, rtol=1e-6)


def test_polynomial_quartic_roots_parity():
    """Durand-Kerner + Aberth on random quartics with 4 real roots."""
    rng = np.random.default_rng(3)
    roots = rng.uniform(-3, 3, size=(64, 4))
    coeffs = np.stack([np.poly(r) for r in roots]).astype(np.float32)
    rj, okj = jpoly.quartic_real_roots(J(coeffs))
    rt, okt = tpoly.quartic_real_roots(T(coeffs))
    np.testing.assert_array_equal(np.asarray(okj), okt.numpy())
    close(np.sort(np.asarray(rj), 1), np.sort(rt.numpy(), 1), atol=1e-4)
    close(np.sort(rt.numpy(), 1), np.sort(roots, 1), atol=2e-2)


def test_umeyama_parity():
    rng = np.random.default_rng(4)
    src = rng.normal(size=(4, 50, 3))
    R = np.asarray(jlie.angle_axis_to_matrix(J(_rotations(rng, 4))))
    dst = 2.5 * np.einsum("bij,bnj->bni", R, src) + [1.0, -2.0, 0.5]
    dst += 0.01 * rng.normal(size=dst.shape)
    w = rng.uniform(0.2, 1.0, size=(4, 50))
    sj, Rj, tj = jume.similarity_align(J(src), J(dst), J(w))
    st, Rt, tt = tume.similarity_align(T(src), T(dst), T(w))
    close(sj, st, atol=1e-5)
    close(Rj, Rt, atol=1e-5)
    close(tj, tt, atol=1e-4)
    _, Rj2, _ = jume.rigid_align(J(src), J(dst))
    _, Rt2, _ = tume.rigid_align(T(src), T(dst))
    close(Rj2, Rt2, atol=1e-5)


def _two_view(noise_px=0.3, n_pts=200, seed=5):
    sc = make_scene(np.random.default_rng(seed), n_cams=4, n_pts=n_pts,
                    noise_px=noise_px)
    return sc["obs"][0].astype(np.float32), sc["obs"][2].astype(np.float32), sc


def _same_up_to_sign(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    err = min(np.abs(a - b).max(), np.abs(a + b).max())
    assert err < atol, err


def test_fundamental_8pt_parity():
    p1, p2, _ = _two_view()
    w = np.random.default_rng(6).uniform(0.5, 1.0, len(p1)).astype(np.float32)
    _same_up_to_sign(jepi.fundamental_8pt(J(p1), J(p2), J(w)),
                     tepi.fundamental_8pt(T(p1), T(p2), T(w)), atol=1e-4)
    # the minimal (RANSAC hypothesis) path on batched 8-point samples
    idx = np.random.default_rng(7).choice(len(p1), size=(16, 8))
    Fj = jepi.fundamental_8pt(J(p1[idx]), J(p2[idx]), exact=False)
    Ft = tepi.fundamental_8pt(T(p1[idx]), T(p2[idx]), exact=False)
    for a, b in zip(np.asarray(Fj), Ft.numpy()):
        _same_up_to_sign(a, b, atol=1e-3)


def test_epipolar_distance_parity():
    p1, p2, _ = _two_view()
    F = np.asarray(jepi.fundamental_8pt(J(p1), J(p2)))
    Fs = F[None] + 1e-4 * np.random.default_rng(8).normal(size=(8, 3, 3))
    dj = jepi.epipolar_distance(J(Fs), J(p1), J(p2))
    dt = tepi.epipolar_distance(T(Fs), T(p1), T(p2))
    close(dj, dt, atol=1e-3, rtol=1e-4)
    close(jepi.sampson_distance(J(Fs), J(p1), J(p2)),
          tepi.sampson_distance(T(Fs), T(p1), T(p2)), atol=1e-4, rtol=1e-3)


def test_relative_pose_unknown_focal_parity():
    p1, p2, sc = _two_view(noise_px=0.2)
    rj = jepi.relative_pose_unknown_focal(J(p1), J(p2))
    rt = tepi.relative_pose_unknown_focal(T(p1), T(p2))
    assert bool(rj["valid"]) and bool(rt["valid"])
    close(rj["f1"], rt["f1"], atol=0.0, rtol=1e-3)
    close(rj["f2"], rt["f2"], atol=0.0, rtol=1e-3)
    close(rj["R"], rt["R"], atol=1e-4)
    close(rj["t"], rt["t"], atol=1e-3)
    assert int(rj["n_front"]) == int(rt["n_front"])


def test_triangulation_parity():
    rng = np.random.default_rng(9)
    sc = make_scene(rng, n_cams=5, n_pts=120, noise_px=0.3)
    P, V = 120, 5
    poses = np.broadcast_to(sc["poses"], (P, V, 6)).astype(np.float32)
    intrs = np.broadcast_to(sc["intrs"], (P, V, 3)).astype(np.float32)
    obs = np.transpose(sc["obs"], (1, 0, 2)).astype(np.float32)
    mask = (rng.uniform(size=(P, V)) > 0.3).astype(np.float32)
    mask[:, :2] = 1.0
    for method in ("midpoint", "dlt"):
        xj, okj, msej = jtri.triangulate_tracks(J(poses), J(intrs), J(obs),
                                                J(mask), 3.0, 1.0, method)
        xt, okt, mset = ttri.triangulate_tracks(T(poses), T(intrs), T(obs),
                                                T(mask), 3.0, 1.0, method)
        close(xj, xt, atol=2e-3, rtol=1e-4)
        close(msej, mset, atol=1e-2, rtol=1e-3)
        assert (np.asarray(okj) == okt.numpy()).mean() >= 0.99
    # device-gathered table form equals the materialized one
    cam_idx = np.tile(np.arange(V), (P, 1)).astype(np.int32)
    xi, oki, _ = ttri.triangulate_tracks_indexed(
        T(sc["poses"]), T(sc["intrs"]), torch.tensor(cam_idx), T(obs),
        T(mask), 3.0, 1.0)
    xm, okm, _ = ttri.triangulate_tracks(T(poses), T(intrs), T(obs), T(mask),
                                         3.0, 1.0)
    close(xm, xi, atol=0.0)
    assert torch.equal(oki, okm)
