"""The benchmark's scenes, made from a seed: frozen copies of the program's
synthetic generators, in plain torch and numpy.

`ba_problem` is `utils/demo.make_scene_arrays` followed by the point noise
of `utils/demo.scene_to_baparams`, `render_views` is
`utils/demo.render_synthetic_images` with its default cameras: the same
draws in the same order, so that one scene seed gives the program's demo
scene. The cell's seed then reorders (`shuffle`) or biases (`biases`) that
scene, so that every seed asks for the same work, or draws its observation
noise anew (`ba_problem`'s `noise_seed`): a problem of its own.
"""

import numpy as np
import torch

from portbench.scenes import rpc as rpcm

LON0, LAT0 = -72.71, 11.02


def substreams(seed, n):
    """n independent numpy seeds (uint32) from any whole number."""
    return [int(s) for s in np.random.SeedSequence(abs(int(seed))).generate_state(n)]


def ba_problem(n_cam, n_pts, obs_per_pt, rot_scale, noise_px, noise_pts, scene_seed, device,
               noise_seed=None):
    """A BA problem with a known truth: n_cam synthetic RPC cameras around a
    ring, n_pts ground points each seen by obs_per_pt consecutive cameras,
    observations by the true (rotated) cameras plus N(0, noise_px), the
    start at zero rotations and the points moved by N(0, noise_pts) m.
    noise_seed, if given, draws the observation noise instead of the scene
    seed. Returns a dict of numpy arrays and the list of dict RPCs."""
    rng = np.random.RandomState(scene_seed)
    rpcs = [rpcm.synthetic_rpc(view_dx=300.0 * np.cos(2 * np.pi * i / n_cam),
                               view_dy=300.0 * np.sin(2 * np.pi * i / n_cam))
            for i in range(n_cam)]
    lons = LON0 + 0.02 * rng.uniform(-1, 1, n_pts)
    lats = LAT0 + 0.015 * rng.uniform(-1, 1, n_pts)
    alts = 50.0 + 100.0 * rng.uniform(-1, 1, n_pts)

    def t64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    pts3d = rpcm.latlon_to_ecef(t64(lats), t64(lons), t64(alts)).cpu().numpy()
    ground = pts3d.mean(axis=0)
    up = ground / np.linalg.norm(ground)
    centers = np.stack([ground + up * 500000.0 + np.array([1.0, 0, 0]) * (i - n_cam / 2) * 60000.0
                        for i in range(n_cam)])
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
        noise = np.random.RandomState(substreams(noise_seed, 2)[1]).randn(*obs.shape)
    obs += noise_px * noise
    pts0 = pts3d + noise_pts * np.random.RandomState(1).randn(n_pts, 3)
    params0 = params_true.copy()
    params0[:, :6] = 0.0
    return {"rpcs": rpcs, "params_true": params_true, "params0": params0, "centers": centers,
            "pts3d": pts3d, "pts0": pts0, "pts_ind": pts_ind, "cam_ind": cam_ind, "pts2d": obs}


def shuffle(problem, seed):
    """The same problem with its observation table in an order drawn from
    seed. The program sorts the table by (point, camera) before it solves,
    so every seed asks for the same work; relabelling the cameras or the
    points instead would move the solver's float32 sums and, with them,
    where it stops."""
    order = np.random.RandomState(substreams(seed, 1)[0]).permutation(len(problem["cam_ind"]))
    return dict(problem, cam_ind=problem["cam_ind"][order], pts_ind=problem["pts_ind"][order],
                pts2d=problem["pts2d"][order])


def texture(n_tex, octaves, seed):
    """A smooth noise texture in [0, 1] (numpy, scipy's gaussian_filter)."""
    from scipy.ndimage import gaussian_filter

    rng = np.random.RandomState(seed)
    tex = np.zeros((n_tex, n_tex))
    for o in range(octaves):
        tex += gaussian_filter(rng.randn(n_tex, n_tex), sigma=2.0 ** (o + 1)) * 2.0 ** o
    return (tex - tex.min()) / (tex.max() - tex.min())


def render_views(n_cam, h, w, alt, n_tex, octaves, texture_seed, device, span=0.035,
                 block_rows=256):
    """n_cam uint8 views of one ground texture through synthetic RPCs: pixel
    = the texture, bilinear, at the ground point that the pixel localizes
    to at altitude alt. Returns (frames [(h, w) uint8 numpy], dict RPCs)."""
    tex = torch.as_tensor(texture(n_tex, octaves, texture_seed), device=device)
    frames, rpcs = [], []
    for i in range(n_cam):
        rpc = rpcm.synthetic_rpc(view_dx=250.0 * np.cos(2 * np.pi * i / n_cam),
                                 view_dy=250.0 * np.sin(2 * np.pi * i / n_cam),
                                 img_halfsize=(w / 2.0, h / 2.0))
        r = {k: torch.as_tensor(np.asarray(rpc[k], np.float64), device=device) for k in rpcm.FIELDS}
        vals = torch.empty(h, w, dtype=torch.float64, device=device)
        for r0 in range(0, h, block_rows):  # in blocks of rows, to bound the memory
            rows = torch.arange(r0, min(h, r0 + block_rows), dtype=torch.float64, device=device)
            cols = torch.arange(w, dtype=torch.float64, device=device).repeat(len(rows))
            rows = rows.repeat_interleave(w)
            lons, lats = rpcm.localize(r, cols, rows, torch.full_like(cols, alt))
            u = torch.clamp((lons - (LON0 - span)) / (2 * span) * (n_tex - 1), 0, n_tex - 1.001)
            v = torch.clamp((lats - (LAT0 - span)) / (2 * span) * (n_tex - 1), 0, n_tex - 1.001)
            u0, v0 = torch.floor(u).long(), torch.floor(v).long()
            fu, fv = u - u0, v - v0
            vals[r0:r0 + block_rows] = (
                (1 - fv) * ((1 - fu) * tex[v0, u0] + fu * tex[v0, u0 + 1])
                + fv * ((1 - fu) * tex[v0 + 1, u0] + fu * tex[v0 + 1, u0 + 1])).reshape(-1, w)
        frames.append((vals.float().cpu().numpy() * 255).astype(np.uint8))
        rpcs.append(rpc)
    return frames, rpcs


def biases(n_cam, bias_px, seed):
    """(n_cam, 2) RPC (col, row) offset biases, uniform in +-bias_px, camera
    0 unbiased."""
    b = np.random.RandomState(substreams(seed, 1)[0]).uniform(-bias_px, bias_px, (n_cam, 2))
    b[0] = 0.0
    return b
