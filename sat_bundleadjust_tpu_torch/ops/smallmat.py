"""Batched tiny-matrix algebra as broadcast products and short sums.

Counterpart of `sat_bundleadjust_tpu/ops/smallmat.py`. Each product is one
elementwise multiply and one reduction over the tiny inner dimension, in
the operands' own precision: no matmul routine, so no TF32 and no library
choice of algorithm can reduce it. The batch axis is the number of
observations or points.
"""

import torch


def mm(a, b):
    """a @ b: (..., I, J) x (..., J, L) -> (..., I, L)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def mv(a, x):
    """a @ x: (..., I, J) x (..., J) -> (..., I)."""
    return torch.sum(a * x[..., None, :], dim=-1)


def mtm(a, b):
    """a^T @ b: (..., R, I) x (..., R, J) -> (..., I, J)."""
    return torch.sum(a[..., :, :, None] * b[..., :, None, :], dim=-3)


def mtv(a, x):
    """a^T @ x: (..., R, I) x (..., R) -> (..., I)."""
    return torch.sum(a * x[..., :, None], dim=-2)


def mbt(a, b):
    """a @ b^T: (..., I, J) x (..., L, J) -> (..., I, L)."""
    return torch.sum(a[..., :, None, :] * b[..., None, :, :], dim=-1)


def chol3x3(A, eps=0.0):
    """Batched closed-form Cholesky factor of SPD (..., 3, 3) matrices.

    eps: additive diagonal jitter. Pivots are floored at 1e-30 so that a
    semidefinite block yields a finite factor (a clamp by a Python scalar: a
    scalar tensor made from the host would be a copy, which a CUDA graph
    capture refuses)."""
    a11 = A[..., 0, 0] + eps
    a21 = A[..., 1, 0]
    a31 = A[..., 2, 0]
    a22 = A[..., 1, 1] + eps
    a32 = A[..., 2, 1]
    a33 = A[..., 2, 2] + eps
    l11 = torch.sqrt(torch.clamp(a11, min=1e-30))
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = torch.sqrt(torch.clamp(a22 - l21 * l21, min=1e-30))
    l32 = (a32 - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(a33 - l31 * l31 - l32 * l32, min=1e-30))
    z = torch.zeros_like(l11)
    return torch.stack(
        [
            torch.stack([l11, z, z], dim=-1),
            torch.stack([l21, l22, z], dim=-1),
            torch.stack([l31, l32, l33], dim=-1),
        ],
        dim=-2,
    )
