"""Output figures: error histograms, reprojection-error heatmaps, the
connectivity graph, footprints, track-observation SVGs.

Counterpart of `sat_bundleadjust_tpu/utils/viz.py` (host numpy and
matplotlib, as there, with the same file names). The connectivity graph
is drawn from `tracks/build.build_connectivity_graph` on networkx's
circular layout, without networkx. matplotlib and scipy are imported where
a figure is drawn; where one is missing, the figure raises an error that
names the `save_figures` option instead of being skipped.
"""

import importlib
import os

import numpy as np

from sat_bundleadjust_tpu_torch.utils import geo as geo_utils


def _needs(module):
    """Import a module that the figures need, or raise naming save_figures."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError("save_figures needs {} ({}); set save_figures to false in the "
                          "scene config to run without figures".format(module, e)) from e


def _pyplot():
    _needs("matplotlib").use("Agg")
    return _needs("matplotlib.pyplot")


def save_histogram_of_errors(img_path, err_init, err_ba, plot=False):
    plt = _pyplot()
    os.makedirs(os.path.dirname(os.path.abspath(img_path)), exist_ok=True)
    plt.figure(figsize=(12, 3))
    plt.subplot(1, 2, 1)
    plt.hist(err_init, bins=40)
    plt.title("Before BA")
    plt.ylabel("Number of tie point observations")
    plt.xlabel("Reprojection error (pixel units)")
    plt.subplot(1, 2, 2)
    plt.hist(err_ba, bins=40, range=(float(np.min(err_init)), float(np.max(err_init))))
    plt.title("After BA")
    plt.ylabel("Number of tie point observations")
    plt.xlabel("Reprojection error (pixel units)")
    plt.savefig(img_path, bbox_inches="tight")
    plt.close()


def idw_interpolation(pts2d, z, pts2d_query, N=8):
    """Inverse-distance-weighted interpolation over the N nearest points."""
    tree = _needs("scipy.spatial").cKDTree(pts2d)
    N = min(N, len(pts2d))
    nn_dist, nn_idx = tree.query(pts2d_query, k=N)
    if N == 1:
        return z[nn_idx]
    w = 1.0 / np.maximum(nn_dist, 1e-12)
    w /= np.sum(w, axis=1, keepdims=True)
    z_query = np.sum(w * z[nn_idx], axis=1)
    exact = nn_dist[:, 0] < 1e-10
    z_query[exact] = z[nn_idx[exact, 0]]
    return z_query


def save_heatmap_of_reprojection_error(img_path, p, err, input_ims_footprints_lonlat,
                                       aoi_lonlat_roi=None, smooth=20, global_transform=None):
    """IDW-interpolated mean reprojection error per track over the union of
    the footprints. A .tif path writes the surface as a georeferenced
    GeoTIFF; any other extension saves the matplotlib figure."""
    from sat_bundleadjust_tpu_torch.ba.solver import compute_mean_reprojection_error_per_track
    from sat_bundleadjust_tpu_torch.models.ellipsoid import ecef_to_latlon_np

    plt = _pyplot()
    gaussian_filter = _needs("scipy.ndimage").gaussian_filter
    os.makedirs(os.path.dirname(os.path.abspath(img_path)), exist_ok=True)
    union = geo_utils.combine_lonlat_geojson_borders(input_ims_footprints_lonlat)
    max_size = 1000
    utm_bbx = geo_utils.utm_bbox_from_aoi_lonlat(union)
    height, width = geo_utils.utm_bbox_shape(utm_bbx, 1.0)
    resolution = float(max(height, width)) / max_size

    track_err = compute_mean_reprojection_error_per_track(err, p.pts_ind, p.n_pts)

    pts3d = p.pts3d_ba.copy() if p.pts3d_ba is not None else p.pts3d.copy()
    if global_transform is not None:
        pts3d = pts3d - global_transform
    lats, lons, _ = ecef_to_latlon_np(pts3d[:, 0], pts3d[:, 1], pts3d[:, 2])
    easts, norths = geo_utils.utm_from_lonlat(lons, lats)
    pts2d_utm = np.stack([easts, norths], axis=1)
    pts2d = geo_utils.compute_relative_utm_coords_inside_utm_bbx(pts2d_utm, utm_bbx, resolution)

    cols, rows = pts2d.T
    height, width = geo_utils.utm_bbox_shape(utm_bbx, resolution)
    valid = (cols < width) & (cols >= 0) & (rows < height) & (rows >= 0)
    pts2d, track_err = pts2d[valid], np.asarray(track_err)[valid]
    if len(pts2d) < 2:
        return

    all_cols, all_rows = np.meshgrid(np.arange(width), np.arange(height))
    query = np.vstack([all_cols.ravel(), all_rows.ravel()]).T
    interp = idw_interpolation(pts2d, track_err, query).reshape(height, width)
    interp = gaussian_filter(interp, sigma=smooth)

    if os.path.splitext(img_path)[1] == ".tif":
        from sat_bundleadjust_tpu_torch.utils.tiffwrite import write_georeferenced_raster_utm_bbox

        utm_zs = geo_utils.zonestring_from_lonlat(*union["center"])
        epsg = geo_utils.epsg_code_from_utm_zone(utm_zs)
        write_georeferenced_raster_utm_bbox(img_path, interp, utm_bbx, epsg, resolution)
        return

    fig, ax = plt.subplots(figsize=(10, 10))
    ax.invert_yaxis()
    ax.axis("equal")
    ax.axis("off")
    im = plt.imshow(interp, vmin=0.0, vmax=2.0)
    plt.scatter(pts2d[:, 0], pts2d[:, 1], 30, track_err, edgecolors="k", vmin=0.0, vmax=2.0)
    cbar = plt.colorbar(im, fraction=0.04)
    cbar.set_label("Reprojection error across AOI (pixel units)", rotation=270, labelpad=25)
    plt.savefig(img_path, bbox_inches="tight")
    plt.close()


def save_connectivity_graph(img_path, C, min_matches, plot=False):
    """The camera graph on a circle (networkx's circular layout), edges
    coloured by their match count."""
    from sat_bundleadjust_tpu_torch.tracks.build import build_connectivity_graph

    plt = _pyplot()
    cm = _needs("matplotlib.cm")

    os.makedirs(os.path.dirname(os.path.abspath(img_path)), exist_ok=True)
    G, edges, matches_per_edge, _, _ = build_connectivity_graph(C, min_matches=min_matches,
                                                                verbose=False)
    n = len(G["nodes"])
    theta = 2 * np.pi * np.arange(n) / max(n, 1)
    pos = np.stack([np.cos(theta), np.sin(theta)], axis=1)
    max_w = 60
    fig, ax = plt.subplots(figsize=(10, 10))
    ax.axis("off")
    for (i, j), m in zip(edges, matches_per_edge):
        ax.plot(pos[[i, j], 0], pos[[i, j], 1], color=cm.Blues(float(min(m, max_w)) / max_w),
                linewidth=2.0, zorder=1)
    ax.scatter(pos[:, 0], pos[:, 1], s=600, c="#FFFFFF", edgecolors="#000000", zorder=2)
    for k in range(n):
        ax.text(pos[k, 0], pos[k, 1], str(k), fontsize=12, family="sans-serif",
                ha="center", va="center", zorder=3)
    plt.savefig(img_path, bbox_inches="tight")
    plt.close()


def draw_image_footprints(img_path, lonlat_footprints, aoi_lonlat):
    plt = _pyplot()
    os.makedirs(os.path.dirname(os.path.abspath(img_path)), exist_ok=True)
    utm_footprints = [geo_utils.utm_geojson_from_lonlat_geojson(x) for x in lonlat_footprints]
    aoi_utm = geo_utils.utm_geojson_from_lonlat_geojson(aoi_lonlat)
    fig, ax = plt.subplots(figsize=(10, 10))
    ax.axis("equal")
    ax.axis("off")
    for f in utm_footprints:
        xy = np.array(f["coordinates"][0] + [f["coordinates"][0][0]])
        plt.plot(xy[:, 0], xy[:, 1], color="black", linewidth=1.0)
    xy = np.array(aoi_utm["coordinates"][0] + [aoi_utm["coordinates"][0][0]])
    plt.plot(xy[:, 0], xy[:, 1], color="red", linewidth=3.0)
    plt.savefig(img_path, bbox_inches="tight")
    plt.close()


def save_pts2d_as_svg(output_filename, pts2d, c="yellow", r=5, w=None, h=None):
    """An SVG of crosses at pts2d (the points whose cross leaves the image
    are left out)."""
    os.makedirs(os.path.dirname(os.path.abspath(output_filename)), exist_ok=True)

    def boundaries_ok(col, row):
        return 0 < col < w - 1 and 0 < row < h - 1

    header = (
        '<?xml version="1.0" standalone="no"?>\n'
        '<!DOCTYPE svg PUBLIC "-//W3C//DTD SVG 1.1//EN"\n'
        ' "http://www.w3.org/Graphics/SVG/1.1/DTD/svg11.dtd">\n'
        '<svg width="{}px" height="{}px" version="1.1"\n'
        ' xmlns="http://www.w3.org/2000/svg" xmlns:xlink="http://www.w3.org/1999/xlink">\n'
    ).format(w, h)
    with open(output_filename, "w") as f:
        f.write(header)
        for p in np.asarray(pts2d):
            col, row = int(p[0]), int(p[1])
            lines = [(col - r, row - r, col + r, row + r), (col + r, row - r, col - r, row + r)]
            if w is not None and h is not None:
                if not all(boundaries_ok(x1, y1) and boundaries_ok(x2, y2) for x1, y1, x2, y2 in lines):
                    continue
            for (x1, y1, x2, y2) in lines:
                f.write('<line x1="{}" y1="{}" x2="{}" y2="{}" stroke="{}" stroke-width="5" />\n'
                        .format(x1, y1, x2, y2, c))
        f.write("</svg>")
