"""Self-contained synthetic scenes (no data files needed).

Counterpart of `sat_bundleadjust_tpu/utils/demo.py`: plausible RPC cameras
built programmatically, ground-truth-controlled BA problems of any size, and
rendered multi-view imagery for the tracks front end. Random numbers come
from numpy with the same calls in the same order, so a seed gives the JAX
package's scene.

For the matrix camera models: `satellite_pinhole` (a perspective camera of a
satellite looking at the scene), `pinhole_rpc` (an RPC fitted to one, so
that an RPC scene has a well-posed perspective approximation: the RPCs of
`make_synthetic_rpc` are affine, and the third row of their perspective fit
is noise) and `make_matrix_scene` (a BA problem of affine or perspective
cameras cloned from a few views and perturbed).
"""

import numpy as np
import torch

from sat_bundleadjust_tpu_torch import resolve_device
from sat_bundleadjust_tpu_torch.models import ellipsoid
from sat_bundleadjust_tpu_torch.models.rpc import RPCModel, stack_rpcs


def make_synthetic_rpc(lon0=-72.71, lat0=11.02, view_dx=0.0, view_dy=0.0,
                       img_halfsize=(1600.0, 675.0)):
    """A well-conditioned RPC (numpy fields): linear in normalized ground
    coordinates, with a per-camera altitude parallax (view_dx/view_dy px per
    normalized altitude). Valid domain: |L|, |P|, |H| <= 1."""
    colh, rowh = img_halfsize
    zeros = np.zeros(20)

    def poly(lin_l, lin_p, lin_h):
        p = zeros.copy()
        p[1], p[2], p[3] = lin_l, lin_p, lin_h
        return p

    den = zeros.copy()
    den[0] = 1.0
    return RPCModel(
        line_num=poly(0.08, 1.0, view_dy / rowh), line_den=den.copy(),
        samp_num=poly(1.0, -0.06, view_dx / colh), samp_den=den.copy(),
        row_offset=rowh, col_offset=colh,
        lat_offset=lat0, lon_offset=lon0, alt_offset=50.0,
        row_scale=rowh, col_scale=colh,
        lat_scale=0.02, lon_scale=0.03, alt_scale=600.0,
    )


def make_scene_arrays(n_cam=8, n_pts=2000, obs_per_pt=None, rot_scale=2e-5,
                      noise_px=0.1, seed=0, device=None):
    """A flat synthetic BA problem (observation-table form), projected on
    `device`. Returns a dict of numpy arrays (cam_params_true (M, 9),
    cam_params0 (M, 9) zero-correction start, camera_centers, pts3d,
    pts_ind/cam_ind/pts2d/weights), the list of RPCs (rpc_list) and the
    batched RPCs on the device (rpcs)."""
    from sat_bundleadjust_tpu_torch.ops import project as project_ops

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    rpcs = [
        make_synthetic_rpc(view_dx=300.0 * np.cos(2 * np.pi * i / n_cam),
                           view_dy=300.0 * np.sin(2 * np.pi * i / n_cam))
        for i in range(n_cam)
    ]
    batched = stack_rpcs(rpcs, dev)

    lon0, lat0 = -72.71, 11.02
    lons = lon0 + 0.02 * rng.uniform(-1, 1, n_pts)
    lats = lat0 + 0.015 * rng.uniform(-1, 1, n_pts)
    alts = 50.0 + 100.0 * rng.uniform(-1, 1, n_pts)

    def t64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)

    pts3d = ellipsoid.latlon_to_ecef_arr(t64(lats), t64(lons), t64(alts)).cpu().numpy()

    ground = pts3d.mean(axis=0)
    up = ground / np.linalg.norm(ground)
    centers = np.stack(
        [ground + up * 500000.0 + np.array([1.0, 0, 0]) * (i - n_cam / 2) * 60000.0
         for i in range(n_cam)]
    )

    cam_params_true = np.zeros((n_cam, 9))
    cam_params_true[:, :3] = rot_scale * rng.uniform(-1, 1, (n_cam, 3))
    cam_params_true[:, 6:9] = centers

    if obs_per_pt is None:
        obs_per_pt = min(n_cam, 4)
    # each point observed by obs_per_pt consecutive cameras (ring)
    start = rng.randint(0, n_cam, n_pts)
    cam_ind = ((start[:, None] + np.arange(obs_per_pt)[None, :]) % n_cam).reshape(-1)
    pts_ind = np.repeat(np.arange(n_pts), obs_per_pt)

    obs = project_ops.project_rpc(
        t64(pts3d), batched, t64(cam_params_true),
        torch.as_tensor(pts_ind, dtype=torch.int64, device=dev),
        torch.as_tensor(cam_ind, dtype=torch.int64, device=dev),
    ).cpu().numpy()
    obs += noise_px * rng.randn(*obs.shape)

    cam_params0 = cam_params_true.copy()
    cam_params0[:, :6] = 0.0

    return {
        "rpcs": batched,
        "rpc_list": rpcs,
        "cam_params_true": cam_params_true,
        "cam_params0": cam_params0,
        "camera_centers": centers,
        "pts3d": pts3d,
        "pts_ind": pts_ind.astype(np.int32),
        "cam_ind": cam_ind.astype(np.int32),
        "pts2d": obs,
        "weights": np.ones(len(pts_ind)),
    }


def render_synthetic_images(n_cam=4, h=300, w=400, seed=0, alt=50.0, lon0=-72.71, lat0=11.02,
                            span=0.035, n_tex=1024, tex_octaves=4, device=None, rpcs=None):
    """Render n_cam views of a shared smooth ground texture through
    synthetic RPC cameras (or through `rpcs`, one view each): pixel value =
    texture (n_tex^2, tex_octaves noise octaves, seeded numpy) at the ground
    position that the pixel localizes to at altitude alt. The localization
    runs on `device`.

    Returns (images [n_cam (h, w) float32 arrays in [0, 1]], rpcs)."""
    from scipy.ndimage import gaussian_filter

    from sat_bundleadjust_tpu_torch.models.rpc import map_rpc, rpc_localization

    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    tex = np.zeros((n_tex, n_tex))
    for o in range(tex_octaves):
        tex += gaussian_filter(rng.randn(n_tex, n_tex), sigma=2.0 ** (o + 1)) * 2.0 ** o
    tex = (tex - tex.min()) / (tex.max() - tex.min())

    cols = torch.arange(w, dtype=torch.float64, device=dev).repeat(h)
    rows = torch.arange(h, dtype=torch.float64, device=dev).repeat_interleave(w)
    alts = torch.full_like(cols, alt)
    given, images, rpcs = rpcs, [], []
    for i in range(n_cam if given is None else len(given)):
        rpc = given[i] if given is not None else make_synthetic_rpc(
            lon0=lon0, lat0=lat0,
            view_dx=250.0 * np.cos(2 * np.pi * i / n_cam),
            view_dy=250.0 * np.sin(2 * np.pi * i / n_cam),
            img_halfsize=(w / 2.0, h / 2.0),
        )
        rpc_t = map_rpc(lambda f: torch.as_tensor(np.asarray(f, np.float64), device=dev), rpc)
        lons, lats = rpc_localization(rpc_t, cols, rows, alts)
        lons, lats = lons.cpu().numpy(), lats.cpu().numpy()
        u = np.clip((lons - (lon0 - span)) / (2 * span) * (n_tex - 1), 0, n_tex - 1.001)
        v = np.clip((lats - (lat0 - span)) / (2 * span) * (n_tex - 1), 0, n_tex - 1.001)
        u0 = np.floor(u).astype(int)
        v0 = np.floor(v).astype(int)
        fu, fv = u - u0, v - v0
        vals = ((1 - fv) * ((1 - fu) * tex[v0, u0] + fu * tex[v0, u0 + 1])
                + fv * ((1 - fu) * tex[v0 + 1, u0] + fu * tex[v0 + 1, u0 + 1]))
        images.append(vals.reshape(h, w).astype(np.float32))
        rpcs.append(rpc)
    return images, rpcs


def scene_to_baparams(scene, noise_pts=1.0, verbose=False, dense_c=False):
    """Wrap make_scene_arrays output into a BAParams problem with perturbed
    starting points: through from_obs_table, or through the C-matrix
    constructor with dense_c=True (both give identical problems)."""
    from sat_bundleadjust_tpu_torch.ba.params import BAParams

    n_cam = scene["cam_params0"].shape[0]
    n_pts = scene["pts3d"].shape[0]
    pairs = [(i, j) for i in range(n_cam) for j in range(i + 1, n_cam)]
    rng = np.random.RandomState(1)
    pts0 = scene["pts3d"] + noise_pts * rng.randn(n_pts, 3)
    if dense_c:
        C = np.full((2 * n_cam, n_pts), np.nan)
        C[2 * scene["cam_ind"], scene["pts_ind"]] = scene["pts2d"][:, 0]
        C[2 * scene["cam_ind"] + 1, scene["pts_ind"]] = scene["pts2d"][:, 1]
        return BAParams(
            C, pts0, scene["rpc_list"], "rpc", pairs,
            [c for c in scene["camera_centers"]], {"verbose": verbose},
        )
    return BAParams.from_obs_table(
        scene["pts_ind"], scene["cam_ind"], scene["pts2d"], pts0,
        scene["rpc_list"], "rpc", [c for c in scene["camera_centers"]],
        pairs, {"verbose": verbose},
    )


def satellite_pinhole(lon0=-72.71, lat0=11.02, alt=50.0, view=(0.0, 0.0), height=600e3,
                      gsd=2.0, img_halfsize=(1600.0, 675.0)):
    """The 3x4 perspective camera (P[2, 3] = 1) of a satellite `height` m
    above the ground point (lon0, lat0, alt), moved by view = (east, north)
    m off nadir, looking at that point: image x to the east, y to the
    south, focal height / gsd px, principal point at the image centre."""
    c = np.array(ellipsoid.latlon_to_ecef_np(lat0, lon0, alt))
    up = c / np.linalg.norm(c)
    east = np.cross([0.0, 0.0, 1.0], up)
    east /= np.linalg.norm(east)
    north = np.cross(up, east)
    sat = c + height * up + view[0] * east + view[1] * north
    z = (c - sat) / np.linalg.norm(c - sat)
    x = east - np.dot(east, z) * z
    x /= np.linalg.norm(x)
    R = np.stack([x, np.cross(z, x), z])
    f = height / gsd
    K = np.array([[f, 0.0, img_halfsize[0]], [0.0, f, img_halfsize[1]], [0.0, 0.0, 1.0]])
    P = K @ np.hstack([R, -(R @ sat)[:, None]])
    return P / P[2, 3]


def pinhole_rpc(P, lon0=-72.71, lat0=11.02, alt=50.0, half=(0.04, 0.03), alt_half=600.0,
                n=10):
    """An RPC (numpy fields) fitted to the 3x4 camera P over an n^3 grid of
    lon0 +- half[0], lat0 +- half[1] deg and alt +- alt_half m (rpcfit's
    regularized IRLS)."""
    from sat_bundleadjust_tpu_torch.ba.rpcfit import weighted_lsq
    from sat_bundleadjust_tpu_torch.models.cameras import apply_projection_matrix

    g = np.meshgrid(np.linspace(lon0 - half[0], lon0 + half[0], n),
                    np.linspace(lat0 - half[1], lat0 + half[1], n),
                    np.linspace(alt - alt_half, alt + alt_half, n), indexing="ij")
    lons, lats, alts = (v.ravel() for v in g)
    pts = np.stack(ellipsoid.latlon_to_ecef_np(lats, lons, alts), axis=1)
    return weighted_lsq(apply_projection_matrix(P, pts), np.stack([lons, lats, alts], axis=1))


def make_matrix_scene(cam_model, n_cam=4, n_pts=80, obs_per_pt=None, n_views=4, rot_std=1e-6,
                      noise_px=0.0, seed=0, lon0=-72.71, lat0=11.02):
    """A BA problem of matrix cameras with a known truth. n_views base views
    (affine: affine_rpc_approx of make_synthetic_rpc views at the scene
    centre; perspective: satellite_pinhole views 100 km off nadir), camera
    i a clone of view i % n_views with every camera's intrinsics those of
    view 0 (so that COMMON_K holds) and its Euler angles moved by
    N(0, 1e-4) rad. Tie points: n_pts ground points within 0.4 of the
    synthetic RPC's lon/lat scales of the centre, at 30-90 m, each seen by
    obs_per_pt distinct random cameras (None: every camera); observations
    by the true cameras plus N(0, noise_px). Initial state: each camera's
    angles but camera 0's moved by N(0, rot_std) rad, points by N(0, 1) m.

    Returns a dict of numpy arrays and lists: cameras_true, cameras_init
    (3x4), params_true (M, F), pts3d, pts0 (N, 3), pts_ind, cam_ind (K,),
    pts2d (K, 2), camera_centers, pairs (every camera pair)."""
    from sat_bundleadjust_tpu_torch.ba.params import (
        load_cam_params_from_camera,
        load_camera_from_cam_params,
    )
    from sat_bundleadjust_tpu_torch.models.cameras import (
        affine_rpc_approx,
        decompose_perspective_camera,
    )

    rng = np.random.RandomState(seed)
    base_rpc = make_synthetic_rpc(lon0=lon0, lat0=lat0)
    c = np.array(ellipsoid.latlon_to_ecef_np(lat0, lon0, 50.0))
    views = []
    for v in range(n_views):
        a = 2 * np.pi * v / n_views + 0.4
        if cam_model == "affine":
            rpc = make_synthetic_rpc(lon0=lon0, lat0=lat0, view_dx=300.0 * np.cos(a),
                                     view_dy=300.0 * np.sin(a))
            P = affine_rpc_approx(rpc, c[0], c[1], c[2])
        else:
            P = satellite_pinhole(lon0, lat0, view=(1e5 * np.cos(a), 1e5 * np.sin(a)))
        views.append(load_cam_params_from_camera(P, c, cam_model))
    views = np.array(views)
    nk = 3 if cam_model == "affine" else 5
    views[:, -nk:] = views[0, -nk:]
    params = views[np.arange(n_cam) % n_views].copy()
    params[:, :3] += rng.normal(0.0, 1e-4, (n_cam, 3))
    init = params.copy()
    init[1:, :3] += rng.normal(0.0, rot_std, (n_cam - 1, 3))
    cams_true = [load_camera_from_cam_params(q, cam_model) for q in params]
    cams_init = [load_camera_from_cam_params(q, cam_model) for q in init]

    lons = lon0 + 0.4 * float(base_rpc.lon_scale) * rng.uniform(-1, 1, n_pts)
    lats = lat0 + 0.4 * float(base_rpc.lat_scale) * rng.uniform(-1, 1, n_pts)
    alts = 30.0 + rng.uniform(0, 60, n_pts)
    pts3d = np.stack(ellipsoid.latlon_to_ecef_np(lats, lons, alts), axis=1)
    if obs_per_pt is None:
        pts_ind = np.repeat(np.arange(n_pts), n_cam)
        cam_ind = np.tile(np.arange(n_cam), n_pts)
    else:
        # distinct cameras: a random first one, then increasing random steps
        # of at most n_cam // obs_per_pt (their sum stays below n_cam)
        steps = rng.randint(1, n_cam // obs_per_pt + 1, (n_pts, obs_per_pt - 1))
        offs = np.concatenate([np.zeros((n_pts, 1), int), np.cumsum(steps, axis=1)], axis=1)
        cam_ind = ((rng.randint(0, n_cam, n_pts)[:, None] + offs) % n_cam).ravel()
        pts_ind = np.repeat(np.arange(n_pts), obs_per_pt)
    mats = np.stack(cams_true)[cam_ind]  # (K, 3, 4)
    ph = np.einsum("kij,kj->ki", mats, np.hstack([pts3d[pts_ind], np.ones((len(pts_ind), 1))]))
    pts2d = ph[:, :2] / ph[:, 2:3] + noise_px * rng.randn(len(pts_ind), 2)
    if cam_model == "perspective":
        centers = [decompose_perspective_camera(P)[3] for P in cams_init]
    else:
        centers = [c + 600e3 * c / np.linalg.norm(c) for _ in range(n_cam)]
    pts0 = pts3d + rng.randn(n_pts, 3)
    return {
        "cameras_true": cams_true, "cameras_init": cams_init, "params_true": params,
        "pts3d": pts3d, "pts0": pts0, "pts_ind": pts_ind, "cam_ind": cam_ind, "pts2d": pts2d,
        "camera_centers": centers,
        "pairs": [(i, j) for i in range(n_cam) for j in range(i + 1, n_cam)],
    }
