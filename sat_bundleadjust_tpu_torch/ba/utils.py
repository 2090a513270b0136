"""Miscellaneous BA utilities.

Counterpart of `sat_bundleadjust_tpu/ba/utils.py`: the geotiff-tag form of
an RPC, the in-place geotiff RPC update (tag 50844, utils/tiffwrite.py),
reprojection before and after a correction, the relative motion between
two perspective matrices, matrix and RPC rescaling, and the AOI where at
least two footprints overlap. Host numpy throughout.
"""

import numpy as np

from sat_bundleadjust_tpu_torch.models.cameras import (
    apply_projection_matrix,
    apply_rpc_projection_np,
    decompose_perspective_camera,
)
from sat_bundleadjust_tpu_torch.models.rpc import rpc_to_geotiff_dict, scale_rpc
from sat_bundleadjust_tpu_torch.utils import geo as geo_utils
from sat_bundleadjust_tpu_torch.utils.tiffwrite import update_geotiff_rpc  # noqa: F401

# the reference's names for these two
rpc_to_geotiff_format = rpc_to_geotiff_dict
rescale_rpc = scale_rpc


def project_pts3d(camera, cam_model, pts3d):
    """(N, 2) projections of (N, 3) ECEF points by an RPC or a 3x4 matrix."""
    if cam_model == "rpc":
        return apply_rpc_projection_np(camera, np.asarray(pts3d))
    return apply_projection_matrix(camera, pts3d)


def reproject_pts3d(cam_before, cam_after, cam_model, obs2d, pts3d_before, pts3d_after):
    """Projections of the tie points before and after the correction and
    their errors against obs2d: (proj_before, proj_after, err_before,
    err_after, None)."""
    proj_before = project_pts3d(cam_before, cam_model, pts3d_before)
    proj_after = project_pts3d(cam_after, cam_model, pts3d_after)
    err_before = np.linalg.norm(proj_before - obs2d, axis=1)
    err_after = np.linalg.norm(proj_after - obs2d, axis=1)
    return proj_before, proj_after, err_before, err_after, None


def compute_relative_motion_between_projection_matrices(P1, P2, verbose=False):
    """Relative extrinsics ext2 @ inv(ext1) of two perspective matrices."""
    _, r1, t1, _ = decompose_perspective_camera(P1)
    _, r2, t2, _ = decompose_perspective_camera(P2)
    ext1 = np.vstack([np.hstack([r1, t1.reshape(3, 1)]), [0, 0, 0, 1]])
    ext2 = np.vstack([np.hstack([r2, t2.reshape(3, 1)]), [0, 0, 0, 1]])
    return ext2 @ np.linalg.inv(ext1)


def rescale_projection_matrix(P, alpha):
    """The matrix of the image scaled by alpha."""
    return np.diag([alpha, alpha, 1.0]) @ np.asarray(P)


def get_aoi_where_at_least_two_lonlat_geojson_overlap(lonlat_geojson_list):
    """The union (a convex hull, with the convex polygon kernel) of all
    pairwise footprint intersections, as a lon/lat geojson; None when no
    two footprints overlap."""
    from sat_bundleadjust_tpu_torch.utils.polygons import union_polygon

    utm_zone = geo_utils.utm_zonestring_from_lonlat_geojson(lonlat_geojson_list[0])
    polys = [geo_utils.geojson_to_polygon(geo_utils.utm_geojson_from_lonlat_geojson(g))
             for g in lonlat_geojson_list]
    inters = []
    for i in range(len(polys)):
        for j in range(i + 1, len(polys)):
            inter = polys[i].intersection(polys[j])
            if inter.area > 0:
                inters.append(inter)
    if not inters:
        return None
    utm_geojson = geo_utils.geojson_from_polygon(union_polygon(inters))
    return geo_utils.lonlat_geojson_from_utm_geojson(utm_geojson, utm_zone)
