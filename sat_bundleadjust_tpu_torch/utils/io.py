"""Host-side IO helpers of the tracks front end.

Counterpart of `sat_bundleadjust_tpu/utils/io.py` for one process:
printing, ids, json, image size and pixels (cv2, then PIL), percentile
equalization, the RPC files of a scene, the list/path savers, geojson, the
`.ply` point clouds, the AOI of a set of images and its keypoint mask
inside an image (cv2 polygon fill), the projection-matrix json files and
the predefined-matches bundle.
"""

import json
import os

import numpy as np

from sat_bundleadjust_tpu_torch.models.rpc import rpc_from_rpc_file, write_rpc_file
from sat_bundleadjust_tpu_torch.utils import tiffmeta


def flush_print(s):
    print(s, flush=True)


def display_dict(d):
    if not d:
        return
    max_k = max(len(k) for k in d)
    for k in d:
        print("    - {}:{}{}".format(k, " " * (max_k - len(k) + 2), d[k]))
    print("\n")


def get_id(fname):
    """Basename without extension."""
    return os.path.splitext(os.path.basename(fname))[0]


def get_time_in_hours_mins_secs(seconds):
    hours, rem = divmod(seconds, 3600)
    minutes, secs = divmod(rem, 60)
    return "{:0>2}:{:0>2}:{:05.2f}".format(int(hours), int(minutes), secs)


def add_suffix_to_fname(src_fname, suffix):
    base = os.path.basename(src_fname)
    file_id, ext = os.path.splitext(base)
    return src_fname.replace(base, file_id + suffix + ext)


def save_dict_to_json(d, path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(d, f, indent=2)


def load_dict_from_json(path):
    with open(path) as f:
        return json.load(f)


def read_image_size(path, rpc=None):
    """(height, width) without reading pixels; 2x the RPC row/col offsets
    when no readable raster exists."""
    if os.path.exists(path):
        size = tiffmeta.image_size_from_tiff(path)
        if size is not None:
            return size
        try:
            from PIL import Image

            with Image.open(path) as im:
                return im.height, im.width
        except (ImportError, OSError):
            pass
    if rpc is not None:
        return (
            int(round(2 * float(np.asarray(rpc.row_offset)) + 1)),
            int(round(2 * float(np.asarray(rpc.col_offset)) + 1)),
        )
    raise IOError("cannot determine image size of {}".format(path))


def load_image(path, offset=None, equalize=False):
    """Read a (possibly multiband) image as a 2-D float64 array: cv2, then
    PIL where cv2 cannot read it. `path` may also be an image array already
    in memory (a rendered scene), which is used as read."""
    if isinstance(path, np.ndarray):
        im = path
    else:
        import cv2

        im = cv2.imread(path, cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH)
        if im is None:
            from PIL import Image

            im = np.asarray(Image.open(path))
    im = im.astype(np.float64)
    if im.ndim > 2:
        im = np.mean(im, axis=int(np.argmin(im.shape)))
    if offset is not None:
        y0, x0 = int(offset["row0"]), int(offset["col0"])
        h, w = int(offset["height"]), int(offset["width"])
        im = im[y0: y0 + h, x0: x0 + w]
    if equalize:
        im = custom_equalization(im)
    return im


def custom_equalization(im, mask=None, clip=True, percentiles=5):
    """Percentile-clipped 0-255 equalization."""
    valid = mask > 0 if mask is not None else np.isfinite(im)
    if clip:
        mi, ma = np.percentile(im[valid], (percentiles, 100 - percentiles))
    else:
        mi, ma = im[valid].min(), im[valid].max()
    if ma <= mi:
        ma = mi + 1
    im = np.clip(im, mi, ma)
    return (im - mi) / (ma - mi) * 255.0


def mask_from_polygons(polygons, im_size):
    """uint8 mask of im_size, 1 inside the polygons (cv2.fillPoly on their
    vertices rounded to whole pixels)."""
    import cv2

    img_mask = np.zeros(im_size, np.uint8)
    exteriors = [np.array(p.coords).round().astype(np.int32) for p in polygons]
    cv2.fillPoly(img_mask, exteriors, 1)
    return img_mask


def get_binary_mask_from_aoi_lonlat_within_image(height, width, geotiff_rpc, aoi_lonlat, alt=0.0):
    """Mask of the AOI (a lon/lat geojson polygon) inside an image: the
    AOI's vertices projected through the RPC at altitude alt (host f64)."""
    from sat_bundleadjust_tpu_torch.models.rpc import rpc_projection_np
    from sat_bundleadjust_tpu_torch.utils.geo import geojson_polygon, geojson_to_polygon

    lons, lats = np.array(aoi_lonlat["coordinates"][0]).T
    cols, rows = rpc_projection_np(geotiff_rpc, lons, lats, np.full(len(lons), float(alt)))
    poly = geojson_to_polygon(geojson_polygon(np.vstack((cols, rows)).T))
    return mask_from_polygons([poly], (height, width))


def save_projection_matrices(filenames, projection_matrices, crop_offsets):
    """One json file per 3x4 matrix: its rows and the crop's size and
    offset."""
    for fn, P, offset in zip(filenames, projection_matrices, crop_offsets):
        P = np.asarray(P)
        save_dict_to_json({
            "P": [P[0, :].tolist(), P[1, :].tolist(), P[2, :].tolist()],
            "height": int(offset["height"]),
            "width": int(offset["width"]),
            "col_offset": int(offset["col0"]),
            "row_offset": int(offset["row0"]),
        }, fn)


def save_list_of_pairs(path, list_of_pairs):
    np.save(path, np.array(list_of_pairs))


def load_list_of_pairs(path):
    arr = np.load(path).T.astype(int)
    return list(zip(arr[0], arr[1]))


def save_list_of_paths(path, paths):
    with open(path, "w") as f:
        for p in paths:
            f.write("%s\n" % p)


def load_list_of_paths(path):
    with open(path) as f:
        return [x.strip() for x in f.readlines()]


def save_rpcs(filenames, rpcs):
    for fn, rpc in zip(filenames, rpcs):
        write_rpc_file(rpc, fn)


def load_rpcs_from_dir(image_fnames_list, rpc_dir, suffix="", extension="rpc", verbose=True):
    """The RPC of every image, read from <rpc_dir>/<image id><suffix>.<extension>."""
    rpcs = []
    for fname in image_fnames_list:
        rpc_basename = "{}.{}".format(get_id(add_suffix_to_fname(fname, suffix)), extension)
        rpcs.append(rpc_from_rpc_file(os.path.join(rpc_dir, rpc_basename)))
    if verbose:
        flush_print("Loaded {} rpcs".format(len(image_fnames_list)))
    return rpcs


def rpc_from_geotiff(path):
    """The RPC of a geotiff's tags (tag 50844)."""
    rpc = tiffmeta.rpc_from_tiff(path)
    if rpc is None:
        raise IOError("no RPC tag found in {}".format(path))
    return rpc


def save_geojson(path, geojson):
    save_dict_to_json({"coordinates": geojson["coordinates"], "type": "Polygon"}, path)


def load_geojson(path):
    from sat_bundleadjust_tpu_torch.utils.geo import geojson_polygon

    d = load_dict_from_json(path)
    return geojson_polygon(np.array(d["coordinates"][0]))


def write_point_cloud_ply(filename, point_cloud, color=None):
    """ASCII .ply, one vertex per row of point_cloud (N, 3)."""
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "w") as f:
        n = point_cloud.shape[0]
        f.write("ply\nformat ascii 1.0\nelement vertex {}\n".format(n))
        f.write("property float x\nproperty float y\nproperty float z\n")
        if color is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n"
                    "property uchar alpha\n")
            f.write("element face 0\nproperty list uchar int vertex_indices\n")
        f.write("end_header\n")
        for i in range(n):
            p = point_cloud[i]
            f.write("{} {} {}".format(p[0], p[1], p[2]))
            if color is not None:
                f.write(" {} {} {} 255".format(*color[:3]))
            f.write("\n")


def read_point_cloud_ply(filename):
    with open(filename) as f:
        lines = [x.strip() for x in f.readlines()]
    start = lines.index("end_header") + 1
    return np.array([[float(v) for v in line.split()[:3]] for line in lines[start:] if line])


def load_aoi_from_multiple_images(images, verbose=False):
    """The union of the images' footprints (lon/lat geojson)."""
    from sat_bundleadjust_tpu_torch.utils.geo import combine_lonlat_geojson_borders

    if verbose:
        print("Defined aoi from union of all geotiff footprints")
    return combine_lonlat_geojson_borders([im.lonlat_geojson for im in images])


def save_predefined_matches(input_dir, output_dir):
    """A matches directory (features/, matches.npy, filenames.txt, as the
    tracks front end writes them with FT_save) as a predefined-matches
    bundle under output_dir/predefined_matches: the keypoints' (col, row,
    scale), the match table and the filenames manifest."""
    import glob
    import shutil

    predefined = os.path.join(output_dir, "predefined_matches")
    os.makedirs(predefined + "/keypoints", exist_ok=True)
    for fn in glob.glob(input_dir + "/features/*.npy"):
        light = np.load(fn)[:, :3]
        np.save(fn.replace(input_dir + "/features/", predefined + "/keypoints/"), light)
    shutil.copyfile(os.path.join(input_dir, "matches.npy"), predefined + "/matches.npy")
    shutil.copyfile(os.path.join(input_dir, "filenames.txt"), predefined + "/filenames.txt")
