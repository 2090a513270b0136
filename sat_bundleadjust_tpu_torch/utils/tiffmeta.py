"""Minimal TIFF metadata reader (tags only, no GDAL/rasterio dependency).

A copy of `sat_bundleadjust_tpu/utils/tiffmeta.py`.

Extracts what the pipeline needs from geotiffs:
  * image width/height (tags 256/257)
  * acquisition datetime (tag 306, TIFFTAG_DATETIME) — used for the
    timeline grouping (reference: ba_timeseries.get_acquisition_date,
    ba_timeseries.py:28-44)
  * RPC coefficients (tag 50844, the TIFF RPC extension GDAL writes:
    92 doubles ERR_BIAS ERR_RAND LINE_OFF SAMP_OFF LAT_OFF LONG_OFF
    HEIGHT_OFF LINE_SCALE SAMP_SCALE LAT_SCALE LONG_SCALE HEIGHT_SCALE
    + LINE_NUM(20) LINE_DEN(20) SAMP_NUM(20) SAMP_DEN(20)) — replaces
    rpcm.rpc_from_geotiff.
"""

import struct

TAG_WIDTH = 256
TAG_HEIGHT = 257
TAG_DATETIME = 306
TAG_RPC = 50844

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 16: 8, 17: 8}


def read_tiff_tags(path, wanted=(TAG_WIDTH, TAG_HEIGHT, TAG_DATETIME, TAG_RPC)):
    """Parse the first IFD of a (Big)TIFF file; return {tag: value}."""
    out = {}
    with open(path, "rb") as f:
        header = f.read(8)
        if len(header) < 8:
            return out
        bo = "<" if header[:2] == b"II" else ">"
        magic = struct.unpack(bo + "H", header[2:4])[0]
        if magic == 42:  # classic TIFF
            ifd_offset = struct.unpack(bo + "I", header[4:8])[0]
            entry_fmt, entry_size, count_fmt = bo + "HHI", 12, bo + "H"
            off_size, count_size = 4, 2
        elif magic == 43:  # BigTIFF
            more = f.read(8)
            ifd_offset = struct.unpack(bo + "Q", more[:8])[0]
            entry_fmt, entry_size = bo + "HHQ", 20
            off_size, count_size = 8, 8
        else:
            return out

        f.seek(ifd_offset)
        if magic == 42:
            n_entries = struct.unpack(bo + "H", f.read(2))[0]
        else:
            n_entries = struct.unpack(bo + "Q", f.read(8))[0]

        for _ in range(n_entries):
            entry = f.read(entry_size)
            if magic == 42:
                tag, typ, count = struct.unpack(bo + "HHI", entry[:8])
                value_bytes = entry[8:12]
            else:
                tag, typ, count = struct.unpack(bo + "HHQ", entry[:12])
                value_bytes = entry[12:20]
            if tag not in wanted:
                continue
            size = _TYPE_SIZES.get(typ, 1) * count
            if size <= off_size:
                data = value_bytes[:size]
            else:
                offset = struct.unpack(bo + ("I" if magic == 42 else "Q"), value_bytes)[0]
                pos = f.tell()
                f.seek(offset)
                data = f.read(size)
                f.seek(pos)
            out[tag] = _decode(bo, typ, count, data)
    return out


def _decode(bo, typ, count, data):
    if typ == 2:  # ASCII
        return data.split(b"\x00")[0].decode("ascii", errors="replace")
    fmt = {3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d", 16: "Q", 17: "q"}.get(typ)
    if fmt is None:
        return data
    vals = struct.unpack(bo + fmt * count, data[: struct.calcsize(bo + fmt * count)])
    return vals[0] if count == 1 else list(vals)


def image_size_from_tiff(path):
    tags = read_tiff_tags(path, wanted=(TAG_WIDTH, TAG_HEIGHT))
    if TAG_WIDTH in tags and TAG_HEIGHT in tags:
        return int(tags[TAG_HEIGHT]), int(tags[TAG_WIDTH])
    return None


def datetime_from_tiff(path):
    """TIFFTAG_DATETIME as a datetime, or None."""
    import datetime

    tags = read_tiff_tags(path, wanted=(TAG_DATETIME,))
    if TAG_DATETIME in tags:
        try:
            return datetime.datetime.strptime(tags[TAG_DATETIME], "%Y:%m:%d %H:%M:%S")
        except ValueError:
            return None
    return None


def rpc_from_tiff(path):
    """RPCModel from TIFF tag 50844, or None if absent."""
    from sat_bundleadjust_tpu_torch.models.rpc import rpc_from_dict

    tags = read_tiff_tags(path, wanted=(TAG_RPC,))
    vals = tags.get(TAG_RPC)
    if vals is None or len(vals) < 92:
        return None
    return rpc_from_dict(
        {
            "row_offset": vals[2],
            "col_offset": vals[3],
            "lat_offset": vals[4],
            "lon_offset": vals[5],
            "alt_offset": vals[6],
            "row_scale": vals[7],
            "col_scale": vals[8],
            "lat_scale": vals[9],
            "lon_scale": vals[10],
            "alt_scale": vals[11],
            "line_num": vals[12:32],
            "line_den": vals[32:52],
            "samp_num": vals[52:72],
            "samp_den": vals[72:92],
        }
    )
