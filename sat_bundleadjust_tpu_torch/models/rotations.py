"""Euler-angle rotations on tensors.

Counterpart of `sat_bundleadjust_tpu/models/rotations.py` (the parts the
BA stage runs). Convention: R = Rz(yaw) @ Ry(pitch) @ Rx(roll).
"""

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
