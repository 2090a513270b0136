"""Host-side IO helpers of the tracks front end.

Counterpart of the parts of `sat_bundleadjust_tpu/utils/io.py` that the
front end uses: printing, ids, image size and pixels (cv2, then PIL),
percentile equalization, and the list/path savers. The RPC-file readers and
the AOI masks come with the modules that need them.
"""

import os

import numpy as np

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


def save_list_of_pairs(path, list_of_pairs):
    np.save(path, np.array(list_of_pairs))


def save_list_of_paths(path, paths):
    with open(path, "w") as f:
        for p in paths:
            f.write("%s\n" % p)
