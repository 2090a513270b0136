"""A BA problem whose camera centres agree with its RPCs' parallax, and the
triangulation pairs that the upstream project's rule gives it.

`generate.ba_problem`'s cameras see the ground along lines of sight that
its camera centres (60 km apart along one axis) do not lie on, and its
tracks are seen by cameras of nearly the same view, whose pairs no
baseline rule would let triangulate. Here the same synthetic RPCs (one
ring of views, 300 px of parallax per normalized altitude) are dealt to
the cameras with a stride, so that the cameras of one track look from
views far apart on the ring, and each camera's centre lies on its line of
sight, `orbit_alt` above the scene. The draws are generate.ba_problem's,
in its order: the same seed gives the same points, rotations, tracks and
noise.
"""

import math

import numpy as np
import torch

from portbench.scenes import generate
from portbench.scenes import rpc as rpcm


def view_rpcs(n_cam, stride):
    """The ring's synthetic RPCs, camera i taking the view at position
    stride * i (mod n_cam); stride coprime to n_cam."""
    if math.gcd(stride, n_cam) != 1:
        raise ValueError("the stride {} does not visit all {} views".format(stride, n_cam))
    at = [(stride * i) % n_cam for i in range(n_cam)]
    return [rpcm.synthetic_rpc(view_dx=300.0 * np.cos(2 * np.pi * k / n_cam),
                               view_dy=300.0 * np.sin(2 * np.pi * k / n_cam)) for k in at]


def sight_centers(rpcs, orbit_alt, device):
    """(M, 3) ECEF camera centres: on the line of sight through each image's
    centre pixel (its localizations at 0 and 1 000 m), orbit_alt metres
    above the ground point it sees."""
    b = rpcm.stack(rpcs, device=device)
    col, row = b["col_offset"], b["row_offset"]
    ends = []
    for alt in (0.0, 1000.0):
        h = torch.full_like(col, alt)
        lon, lat = rpcm.localize(b, col, row, h)
        ends.append(rpcm.latlon_to_ecef(lat, lon, h))
    low, high = ends
    sight = (high - low) / torch.linalg.norm(high - low, dim=1, keepdim=True)
    up = low / torch.linalg.norm(low, dim=1, keepdim=True)
    return (low + sight * (orbit_alt / (sight * up).sum(1))[:, None]).cpu().numpy()


def triangulation_pairs(centers, orbit_alt, min_baseline):
    """The pairs (i, j), i < j, whose baseline over the orbit's altitude
    exceeds min_baseline: the upstream rule for `pairs_to_triangulate`
    (ft_match.compute_pairs_to_match) where every footprint overlaps. Its
    rescue of a camera left without a pair is not modelled: such a camera
    raises."""
    c = np.asarray(centers, np.float64)
    base = np.linalg.norm(c[:, None] - c[None], axis=-1)
    i, j = np.nonzero(np.triu(base / orbit_alt > min_baseline, 1))
    if len(np.union1d(i, j)) < len(c):
        raise ValueError("a camera has no pair with a baseline over {}".format(min_baseline))
    return list(zip(i.tolist(), j.tolist()))


def ba_problem(n_cam, n_pts, obs_per_pt, rot_scale, noise_px, noise_pts, scene_seed, device,
               stride, orbit_alt, noise_seed=None):
    """generate.ba_problem's problem (its arguments and its dict) with the
    cameras of view_rpcs and the centres of sight_centers: n_pts ground
    points each seen by obs_per_pt consecutive cameras, observations by the
    true (rotated) cameras plus N(0, noise_px), the start at zero rotations
    and the points moved by N(0, noise_pts) m."""
    rng = np.random.RandomState(scene_seed)
    rpcs = view_rpcs(n_cam, stride)
    lons = generate.LON0 + 0.02 * rng.uniform(-1, 1, n_pts)
    lats = generate.LAT0 + 0.015 * rng.uniform(-1, 1, n_pts)
    alts = 50.0 + 100.0 * rng.uniform(-1, 1, n_pts)

    def t64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    pts3d = rpcm.latlon_to_ecef(t64(lats), t64(lons), t64(alts)).cpu().numpy()
    centers = sight_centers(rpcs, orbit_alt, device)
    params_true = np.zeros((n_cam, 9))
    params_true[:, :3] = rot_scale * rng.uniform(-1, 1, (n_cam, 3))
    params_true[:, 6:9] = centers
    start = rng.randint(0, n_cam, n_pts)
    cam_ind = ((start[:, None] + np.arange(obs_per_pt)[None, :]) % n_cam).reshape(-1)
    pts_ind = np.repeat(np.arange(n_pts), obs_per_pt)
    obs = rpcm.project_corrected(rpcm.index(rpcm.stack(rpcs, device=device), t64(cam_ind).long()),
                                 t64(pts3d)[t64(pts_ind).long()],
                                 t64(params_true)[t64(cam_ind).long()]).cpu().numpy()
    noise = rng.randn(*obs.shape)
    if noise_seed is not None:
        noise = np.random.RandomState(generate.substreams(noise_seed, 2)[1]).randn(*obs.shape)
    obs += noise_px * noise
    pts0 = pts3d + noise_pts * np.random.RandomState(1).randn(n_pts, 3)
    params0 = params_true.copy()
    params0[:, :6] = 0.0
    return {"rpcs": rpcs, "params_true": params_true, "params0": params0, "centers": centers,
            "pts3d": pts3d, "pts0": pts0, "pts_ind": pts_ind, "cam_ind": cam_ind, "pts2d": obs}
