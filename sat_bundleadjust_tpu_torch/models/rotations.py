"""3-D rotations on tensors.

Counterpart of `sat_bundleadjust_tpu/models/rotations.py`: the Euler-angle
rotation the BA stage runs, Rodrigues' rotation, and the conversions between
Euler angles, quaternions, matrices and axis-angle pairs (the reference's
ba_rotate.py), batched over leading dims on the device of their inputs. The
matrix -> angles conversion of the matrix camera models is numpy
(`euler_angles_from_R`). Convention: R = Rz(yaw) @ Ry(pitch) @ Rx(roll).
"""

import numpy as np
import torch

from sat_bundleadjust_tpu_torch import resolve_device


def rotate_euler(pts, euler_angles):
    """Rotate points by per-point Euler angles (roll=x, pitch=y, yaw=z).

    pts, euler_angles: (..., 3). Applies Rx, then Ry, then Rz."""
    cx, sx = torch.cos(euler_angles[..., 0]), torch.sin(euler_angles[..., 0])
    cy, sy = torch.cos(euler_angles[..., 1]), torch.sin(euler_angles[..., 1])
    cz, sz = torch.cos(euler_angles[..., 2]), torch.sin(euler_angles[..., 2])
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    y, z = cx * y - sx * z, sx * y + cx * z
    x, z = cy * x + sy * z, -sy * x + cy * z
    x, y = cz * x - sz * y, sz * x + cz * y
    return torch.stack([x, y, z], dim=-1)


def euler_angles_to_R(roll, pitch, yaw):
    """Euler angles -> (..., 3, 3) rotation matrix, R = Rz @ Ry @ Rx."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    r00 = cy * cp
    r01 = cy * sp * sr - sy * cr
    r02 = cy * sp * cr + sy * sr
    r10 = sy * cp
    r11 = sy * sp * sr + cy * cr
    r12 = sy * sp * cr - cy * sr
    r20 = -sp
    r21 = cp * sr
    r22 = cp * cr
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def euler_angles_from_R(R):
    """(..., 3, 3) rotation matrix (numpy) -> (roll, pitch, yaw)."""
    R = np.asarray(R, np.float64)
    sy = np.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    roll = np.where(singular, np.arctan2(-R[..., 1, 2], R[..., 1, 1]),
                    np.arctan2(R[..., 2, 1], R[..., 2, 2]))
    pitch = np.arctan2(-R[..., 2, 0], sy)
    yaw = np.where(singular, np.zeros_like(sy), np.arctan2(R[..., 1, 0], R[..., 0, 0]))
    return roll, pitch, yaw


def rotate_rodrigues(pts, axis_angle):
    """Rotate points by per-point axis-angle vectors (Rodrigues' formula).

    pts, axis_angle: (..., 3) tensors; a zero vector leaves its point as it
    is."""
    theta = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    safe_theta = torch.where(theta == 0, torch.ones_like(theta), theta)
    v = axis_angle / safe_theta
    dot = torch.sum(pts * v, dim=-1, keepdim=True)
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    out = cos_t * pts + sin_t * torch.linalg.cross(v, pts) + dot * (1.0 - cos_t) * v
    return torch.where(theta == 0, pts, out)


def euler_to_quaternion(roll, pitch, yaw):
    """Euler angles (tensors) -> quaternion (qw, qx, qy, qz)."""
    hr, hp, hy = roll / 2, pitch / 2, yaw / 2
    sr, cr = torch.sin(hr), torch.cos(hr)
    sp, cp = torch.sin(hp), torch.cos(hp)
    sy, cy = torch.sin(hy), torch.cos(hy)
    qx = sr * cp * cy - cr * sp * sy
    qy = cr * sp * cy + sr * cp * sy
    qz = cr * cp * sy - sr * sp * cy
    qw = cr * cp * cy + sr * sp * sy
    return qw, qx, qy, qz


def quaternion_to_euler(qw, qx, qy, qz):
    """Quaternion (tensors) -> Euler angles (roll, pitch, yaw); the pitch's
    sine is clipped to [-1, 1]."""
    roll = torch.atan2(2.0 * (qw * qx + qy * qz), 1.0 - 2.0 * (qx * qx + qy * qy))
    pitch = torch.asin(torch.clamp(2.0 * (qw * qy - qz * qx), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (qw * qz + qx * qy), 1.0 - 2.0 * (qy * qy + qz * qz))
    return roll, pitch, yaw


def quaternion_to_R(q0, q1, q2, q3):
    """Quaternion (tensors) -> (..., 3, 3) rotation matrix."""
    r00 = q0 ** 2 + q1 ** 2 - q2 ** 2 - q3 ** 2
    r11 = q0 ** 2 - q1 ** 2 + q2 ** 2 - q3 ** 2
    r22 = q0 ** 2 - q1 ** 2 - q2 ** 2 + q3 ** 2
    r01 = 2.0 * (q1 * q2 - q0 * q3)
    r02 = 2.0 * (q0 * q2 + q1 * q3)
    r12 = 2.0 * (q2 * q3 - q0 * q1)
    r10 = 2.0 * (q1 * q2 + q0 * q3)
    r20 = 2.0 * (q1 * q3 - q0 * q2)
    r21 = 2.0 * (q0 * q1 + q2 * q3)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def _as_rotation(R, device):
    """R as a float64 tensor: a tensor stays where it is, anything else goes
    to `device` (default: the card)."""
    if torch.is_tensor(R):
        return R
    return torch.as_tensor(np.asarray(R, np.float64), device=resolve_device(device))


def R_to_quaternion(R, device=None):
    """(..., 3, 3) rotation matrix -> quaternion (qw, qx, qy, qz), through
    the Euler angles (euler_angles_from_R's singular-pitch rule)."""
    R = _as_rotation(R, device)
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    roll = torch.where(singular, torch.atan2(-R[..., 1, 2], R[..., 1, 1]),
                       torch.atan2(R[..., 2, 1], R[..., 2, 2]))
    pitch = torch.atan2(-R[..., 2, 0], sy)
    yaw = torch.where(singular, torch.zeros_like(sy), torch.atan2(R[..., 1, 0], R[..., 0, 0]))
    return euler_to_quaternion(roll, pitch, yaw)


def axis_angle_from_R(R, device=None):
    """(..., 3, 3) rotation matrix -> (unit axis (..., 3), angle); the
    identity gives the zero axis."""
    R = _as_rotation(R, device)
    axis = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    r = torch.linalg.norm(axis, dim=-1)
    t = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.atan2(r, t - 1.0)
    return axis / torch.where(r == 0, torch.ones_like(r), r)[..., None], theta


def axis_angle_to_R(axis, angle):
    """(unit axis (..., 3), angle) tensors -> (..., 3, 3) rotation matrix."""
    ca, sa = torch.cos(angle), torch.sin(angle)
    c = 1.0 - ca
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    return torch.stack(
        [
            torch.stack([x * x * c + ca, x * y * c - z * sa, z * x * c + y * sa], dim=-1),
            torch.stack([x * y * c + z * sa, y * y * c + ca, y * z * c - x * sa], dim=-1),
            torch.stack([z * x * c - y * sa, y * z * c + x * sa, z * z * c + ca], dim=-1),
        ],
        dim=-2,
    )
