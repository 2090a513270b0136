"""Minimal GeoTIFF writer (no GDAL/rasterio dependency).

Counterpart of `sat_bundleadjust_tpu/utils/tiffwrite.py` (host numpy and
struct, as there), the writer beside utils/tiffmeta.py (the reader):

  * write_georeferenced_raster_utm_bbox — single-band float32 GeoTIFF with
    UTM georeferencing keys, for the .tif variant of the reprojection
    error heatmap (utils/viz.py);
  * update_geotiff_rpc — in-place update of the TIFF RPC coefficient tag
    50844 of an existing geotiff; the file is rewritten with its first IFD
    relocated, strip and tile data preserved byte for byte.

Only classic (non-Big) little-endian TIFF is produced; the RPC updater
accepts either byte order and classic or BigTIFF input.
"""

import os
import struct

import numpy as np

from sat_bundleadjust_tpu_torch.models.rpc import rpc_to_numpy
from sat_bundleadjust_tpu_torch.utils.tiffmeta import _TYPE_SIZES, TAG_RPC

_TYPE_FMT = {1: "B", 2: "s", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d", 16: "Q", 17: "q"}

# TIFF tags used by the writer
T_WIDTH, T_HEIGHT = 256, 257
T_BITS, T_COMPRESSION, T_PHOTOMETRIC = 258, 259, 262
T_STRIP_OFFSETS, T_SAMPLES, T_ROWS_PER_STRIP, T_STRIP_COUNTS = 273, 277, 278, 279
T_PLANAR, T_SAMPLE_FORMAT = 284, 339
T_TILE_OFFSETS, T_TILE_COUNTS = 324, 325
T_MODEL_PIXEL_SCALE, T_MODEL_TIEPOINT = 33550, 33922
T_GEO_KEYS = 34735
T_GDAL_NODATA = 42113


def _pack_entries(entries, data_start):
    """entries: list of (tag, type, count, payload_bytes). Returns
    (ifd_bytes, data_bytes) with external payloads placed from data_start."""
    entries = sorted(entries)
    ifd = [struct.pack("<H", len(entries))]
    data = []
    offset = data_start
    for tag, typ, count, payload in entries:
        if len(payload) <= 4:
            value = payload.ljust(4, b"\x00")
        else:
            if offset % 2:  # TIFF offsets should be word-aligned
                data.append(b"\x00")
                offset += 1
            value = struct.pack("<I", offset)
            data.append(payload)
            offset += len(payload)
        ifd.append(struct.pack("<HHI", tag, typ, count) + value)
    ifd.append(struct.pack("<I", 0))  # no next IFD
    return b"".join(ifd), b"".join(data)


def _entry(tag, typ, values):
    if typ == 2:  # ASCII: values is a str
        payload = values.encode("ascii") + b"\x00"
        return (tag, typ, len(payload), payload)
    if isinstance(values, (int, float)):
        values = [values]
    payload = struct.pack("<" + _TYPE_FMT[typ] * len(values), *values)
    return (tag, typ, len(values), payload)


def write_tiff(path, raster, extra_entries=()):
    """Write a single-band float32 TIFF (one strip) + extra IFD entries."""
    raster = np.ascontiguousarray(np.asarray(raster, dtype="<f4"))
    assert raster.ndim == 2
    h, w = raster.shape
    pixels = raster.tobytes()

    strip_offset = 8  # immediately after the header
    entries = [
        _entry(T_WIDTH, 4, w),
        _entry(T_HEIGHT, 4, h),
        _entry(T_BITS, 3, 32),
        _entry(T_COMPRESSION, 3, 1),
        _entry(T_PHOTOMETRIC, 3, 1),
        _entry(T_STRIP_OFFSETS, 4, strip_offset),
        _entry(T_SAMPLES, 3, 1),
        _entry(T_ROWS_PER_STRIP, 4, h),
        _entry(T_STRIP_COUNTS, 4, len(pixels)),
        _entry(T_PLANAR, 3, 1),
        _entry(T_SAMPLE_FORMAT, 3, 3),  # IEEE float
    ] + list(extra_entries)

    ifd_offset = strip_offset + len(pixels)
    if ifd_offset % 2:
        pixels += b"\x00"
        ifd_offset += 1
    n = len(entries)
    ifd_size = 2 + n * 12 + 4
    ifd, tag_data = _pack_entries(entries, ifd_offset + ifd_size)

    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<H", 42) + struct.pack("<I", ifd_offset))
        f.write(pixels)
        f.write(ifd)
        f.write(tag_data)


def geokey_entries(epsg, resolution, west, north):
    """GeoTIFF georeferencing entries for a north-up UTM raster."""
    # GeoKeyDirectory: version 1.1.0, 3 keys
    keys = [
        1, 1, 0, 3,
        1024, 0, 1, 1,      # GTModelTypeGeoKey = Projected
        1025, 0, 1, 1,      # GTRasterTypeGeoKey = PixelIsArea
        3072, 0, 1, int(epsg),  # ProjectedCSTypeGeoKey
    ]
    return [
        _entry(T_MODEL_PIXEL_SCALE, 12, [float(resolution), float(resolution), 0.0]),
        _entry(T_MODEL_TIEPOINT, 12, [0.0, 0.0, 0.0, float(west), float(north), 0.0]),
        _entry(T_GEO_KEYS, 3, keys),
        _entry(T_GDAL_NODATA, 2, "nan"),
    ]


def write_georeferenced_raster_utm_bbox(img_path, raster, utm_bbx, epsg, resolution):
    """Georeferenced float32 GeoTIFF over a UTM bounding box. The raster
    rows run north -> south from utm_bbx['ymax']; nodata is NaN."""
    from sat_bundleadjust_tpu_torch.utils import geo as geo_utils

    west, north = utm_bbx["xmin"], utm_bbx["ymax"]
    height, width = geo_utils.utm_bbox_shape(utm_bbx, resolution)
    raster = np.asarray(raster, dtype=np.float32)
    assert raster.shape == (height, width), (raster.shape, (height, width))
    os.makedirs(os.path.dirname(os.path.abspath(img_path)), exist_ok=True)
    write_tiff(img_path, raster, geokey_entries(epsg, resolution, west, north))


def rpc_tag_values(rpc):
    """The 92 doubles of TIFF tag 50844 (RPCCoefficientTag) from an
    RPCModel: [ERR_BIAS ERR_RAND LINE_OFF SAMP_OFF LAT_OFF LONG_OFF
    HEIGHT_OFF LINE_SCALE SAMP_SCALE LAT_SCALE LONG_SCALE HEIGHT_SCALE
    LINE_NUM(20) LINE_DEN(20) SAMP_NUM(20) SAMP_DEN(20)] — the inverse of
    utils/tiffmeta.rpc_from_tiff."""
    r = rpc_to_numpy(rpc)
    g = lambda a: [float(x) for x in np.asarray(a).ravel()]
    return (
        [-1.0, -1.0]
        + g(r.row_offset) + g(r.col_offset)
        + g(r.lat_offset) + g(r.lon_offset) + g(r.alt_offset)
        + g(r.row_scale) + g(r.col_scale)
        + g(r.lat_scale) + g(r.lon_scale) + g(r.alt_scale)
        + g(r.line_num) + g(r.line_den) + g(r.samp_num) + g(r.samp_den)
    )


def _read_ifd_raw(path):
    """Read the first IFD of a TIFF: list of (tag, type, count, payload
    bytes, decoded values or None). Returns (byteorder, entries)."""
    with open(path, "rb") as f:
        header = f.read(8)
        bo = "<" if header[:2] == b"II" else ">"
        magic = struct.unpack(bo + "H", header[2:4])[0]
        if magic == 42:
            ifd_offset = struct.unpack(bo + "I", header[4:8])[0]
            off_size = 4
        elif magic == 43:
            ifd_offset = struct.unpack(bo + "Q", f.read(8)[:8])[0]
            off_size = 8
        else:
            raise ValueError("not a TIFF file: {}".format(path))

        f.seek(ifd_offset)
        if magic == 42:
            n_entries = struct.unpack(bo + "H", f.read(2))[0]
        else:
            n_entries = struct.unpack(bo + "Q", f.read(8))[0]
        entries = []
        for _ in range(n_entries):
            if magic == 42:
                tag, typ, count = struct.unpack(bo + "HHI", f.read(8))
                value_bytes = f.read(4)
            else:
                tag, typ, count = struct.unpack(bo + "HHQ", f.read(12))
                value_bytes = f.read(8)
            size = _TYPE_SIZES.get(typ, 1) * count
            if size <= off_size:
                payload = value_bytes[:size]
            else:
                offset = struct.unpack(bo + ("I" if magic == 42 else "Q"), value_bytes)[0]
                pos = f.tell()
                f.seek(offset)
                payload = f.read(size)
                f.seek(pos)
            entries.append((tag, typ, count, payload))
        return bo, entries


def _decode_ints(bo, typ, count, payload):
    fmt = _TYPE_FMT[typ]
    return list(struct.unpack(bo + fmt * count, payload[: struct.calcsize(bo + fmt * count)]))


def update_geotiff_rpc(geotiff_path, rpc_model):
    """Replace/insert the RPC tag (50844) of an existing geotiff, in place.
    The image is rewritten
    with its strip/tile data copied verbatim and the first IFD rebuilt in
    little-endian classic TIFF layout."""
    bo, entries = _read_ifd_raw(geotiff_path)

    # locate the pixel-data pointer tags and load the data blocks
    by_tag = {tag: (typ, count, payload) for tag, typ, count, payload in entries}
    if T_STRIP_OFFSETS in by_tag:
        off_tag, cnt_tag = T_STRIP_OFFSETS, T_STRIP_COUNTS
    elif T_TILE_OFFSETS in by_tag:
        off_tag, cnt_tag = T_TILE_OFFSETS, T_TILE_COUNTS
    else:
        raise ValueError("TIFF without strip or tile data: {}".format(geotiff_path))
    typ_o, cnt_o, payload_o = by_tag[off_tag]
    typ_c, cnt_c, payload_c = by_tag[cnt_tag]
    offsets = _decode_ints(bo, typ_o, cnt_o, payload_o)
    counts = _decode_ints(bo, typ_c, cnt_c, payload_c)
    with open(geotiff_path, "rb") as f:
        blocks = []
        for off, cnt in zip(offsets, counts):
            f.seek(off)
            blocks.append(f.read(cnt))

    # rebuild: data blocks first (from offset 8), then IFD + tag data
    new_offsets = []
    pos = 8
    out_blocks = []
    for blk in blocks:
        if pos % 2:
            out_blocks.append(b"\x00")
            pos += 1
        new_offsets.append(pos)
        out_blocks.append(blk)
        pos += len(blk)
    data_section = b"".join(out_blocks)

    new_entries = []
    for tag, typ, count, payload in entries:
        if tag == TAG_RPC:
            continue  # replaced below
        if tag == off_tag:
            new_entries.append(_entry(tag, 4, new_offsets))
        elif tag == cnt_tag:
            new_entries.append(_entry(tag, 4, [len(b) for b in blocks]))
        elif bo == ">":
            # re-encode byte order via decode/encode of typed values
            if typ == 2:
                new_entries.append((tag, typ, count, payload))
            else:
                vals = _decode_ints(bo, typ, count, payload)
                new_entries.append(_entry(tag, typ, vals))
        else:
            new_entries.append((tag, typ, count, payload))
    new_entries.append(_entry(TAG_RPC, 12, rpc_tag_values(rpc_model)))

    ifd_offset = 8 + len(data_section)
    if ifd_offset % 2:
        data_section += b"\x00"
        ifd_offset += 1
    ifd_size = 2 + len(new_entries) * 12 + 4
    ifd, tag_data = _pack_entries(new_entries, ifd_offset + ifd_size)

    tmp = geotiff_path + ".rpcupd.tmp"
    with open(tmp, "wb") as f:
        f.write(b"II" + struct.pack("<H", 42) + struct.pack("<I", ifd_offset))
        f.write(data_section)
        f.write(ifd)
        f.write(tag_data)
    os.replace(tmp, geotiff_path)
