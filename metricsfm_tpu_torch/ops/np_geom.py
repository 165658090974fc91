"""NumPy twins of the small pose-math helpers for host-side driver code.

The pipeline drivers make many single-pose calls (camera centers for
exports, pose composition when registering one image, ...). Routing those
through device tensors costs a launch and a copy each; these float64 numpy
versions are for host orchestration only, and batched device compute stays
on the tensor kernels in ops/lie.py / ops/projection.py.
"""
from __future__ import annotations

import numpy as np


def angle_axis_to_matrix(aa: np.ndarray) -> np.ndarray:
    """Rodrigues formula (single (3,) vector -> (3, 3) matrix)."""
    aa = np.asarray(aa, np.float64)
    theta = float(np.linalg.norm(aa))
    if theta < 1e-10:
        K = hat(aa)
        return np.eye(3) + K + 0.5 * (K @ K)
    k = aa / theta
    K = hat(k)
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def hat(v: np.ndarray) -> np.ndarray:
    return np.array([[0.0, -v[2], v[1]],
                     [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]])


def matrix_to_angle_axis(R: np.ndarray) -> np.ndarray:
    """Log map SO(3) -> R^3 (single matrix)."""
    R = np.asarray(R, np.float64)
    tr = np.trace(R)
    cos_t = np.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = float(np.arccos(cos_t))
    if theta < 1e-10:
        return 0.5 * np.array([R[2, 1] - R[1, 2],
                               R[0, 2] - R[2, 0],
                               R[1, 0] - R[0, 1]])
    if abs(np.pi - theta) < 1e-6:
        # near pi: axis from the dominant diagonal of (R + I) / 2
        A = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diagonal(A), 0.0))
        k = int(np.argmax(axis))
        axis = A[:, k] / max(axis[k], 1e-12)
        axis = axis / max(np.linalg.norm(axis), 1e-12)
        return theta * axis
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]]) / (2.0 * np.sin(theta))
    return theta * axis


def pose_to_Rt(pose: np.ndarray):
    pose = np.asarray(pose, np.float64)
    return angle_axis_to_matrix(pose[:3]), pose[3:6].copy()


def pose_from_Rt(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return np.concatenate([matrix_to_angle_axis(R),
                           np.asarray(t, np.float64)])


def camera_center(pose: np.ndarray) -> np.ndarray:
    """c = -R^T t (ref ACPose.c, camera.cc:67-77)."""
    R, t = pose_to_Rt(pose)
    return -R.T @ t


def pose_from_center(aa: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Angle-axis + camera center -> [aa, t] with t = -R c."""
    R = angle_axis_to_matrix(np.asarray(aa, np.float64))
    return np.concatenate([np.asarray(aa, np.float64),
                           -R @ np.asarray(c, np.float64)])


def compose_relative(pose_ref: np.ndarray, rel: np.ndarray) -> np.ndarray:
    """World pose from a reference pose and a relative pose:
    R = R_rel R_ref, t = R_rel t_ref + t_rel (ref Camera::SetRTPose
    relative-compose, camera.cc:55-65)."""
    R1, t1 = pose_to_Rt(pose_ref)
    R2, t2 = pose_to_Rt(rel)
    return pose_from_Rt(R2 @ R1, R2 @ t1 + t2)


def apply_similarity_to_pose(pose: np.ndarray, s: float, R_s: np.ndarray,
                             t_s: np.ndarray) -> np.ndarray:
    """Update a world->cam pose under a world similarity x' = s R_s x + t_s
    (numpy twin of projection.apply_similarity_to_pose)."""
    R, t = pose_to_Rt(pose)
    R_new = R @ np.asarray(R_s, np.float64).T
    t_new = s * t - R_new @ np.asarray(t_s, np.float64)
    return pose_from_Rt(R_new, t_new)
