"""Euler-angle rotations on tensors.

Counterpart of `sat_bundleadjust_tpu/models/rotations.py` (the parts the
BA stage runs, and the matrix -> angles conversion of the matrix camera
models, in numpy). Convention: R = Rz(yaw) @ Ry(pitch) @ Rx(roll).
"""

import numpy as np
import torch


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
