"""Robust losses with scipy.optimize.least_squares semantics.

Counterpart of `sat_bundleadjust_tpu/ops/robust.py`. cost = 0.5 *
f_scale^2 * sum rho0(z), z = (r / f_scale)^2; the IRLS scaling of residuals
and Jacobians is sqrt(rho0'(z)) (first-order, as scipy's TRF).
"""

import torch

LOSSES = ("linear", "soft_l1", "huber", "cauchy", "arctan")


def loss_id(loss: str) -> int:
    """Loss name -> integer id (position in LOSSES)."""
    try:
        return LOSSES.index(loss)
    except ValueError:
        raise ValueError("unknown loss {}".format(loss))


# sqrt(rho0'(z)) and rho0(z), indexed by loss_id
_SCALE_BRANCHES = (
    lambda z: torch.ones_like(z),
    lambda z: (1.0 + z) ** -0.25,
    lambda z: torch.clamp(z ** -0.25, max=1.0),
    lambda z: (1.0 + z) ** -0.5,
    lambda z: (1.0 + z ** 2) ** -0.5,
)
_RHO_BRANCHES = (
    lambda z: z,
    lambda z: 2.0 * (torch.sqrt(1.0 + z) - 1.0),
    lambda z: torch.where(z <= 1.0, z, 2.0 * torch.sqrt(torch.clamp(z, min=1.0)) - 1.0),
    lambda z: torch.log1p(z),
    lambda z: torch.atan(z),
)


def loss_scale(loss, r, f_scale):
    """Per-component IRLS weight sqrt(rho'(z)), z = (r/f_scale)^2.

    r: (..., 2) weighted residuals; loss: a name or a loss_id."""
    lid = loss_id(loss) if isinstance(loss, str) else int(loss)
    if lid == 0:
        return torch.ones_like(r)
    return _SCALE_BRANCHES[lid]((r / f_scale) ** 2)


def loss_cost(loss, r, f_scale):
    """0.5 * f_scale^2 * sum rho(z), scipy's cost. Returns a 0-d tensor."""
    lid = loss_id(loss) if isinstance(loss, str) else int(loss)
    z = (r / f_scale) ** 2
    return 0.5 * (f_scale ** 2) * torch.sum(_RHO_BRANCHES[lid](z))
