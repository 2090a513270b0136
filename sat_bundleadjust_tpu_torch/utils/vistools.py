"""Notebook visualization helpers (a side layer, off the pipeline's path).

A copy of `sat_bundleadjust_tpu/utils/vistools.py` (numpy, matplotlib,
PIL), with the same optional imports: where ipyleaflet is importable the
clickable and overlay maps are its widgets, otherwise a matplotlib
rendering of the footprints; IPython displays where it is present."""

import numpy as np


def _have_ipyleaflet():
    try:
        import ipyleaflet  # noqa: F401

        return True
    except ImportError:
        return False


def clickablemap(center=(0.0, 0.0), zoom=10):
    """Interactive map widget (reference: vistools.py:15-111) or a
    matplotlib fallback handle."""
    if _have_ipyleaflet():
        from ipyleaflet import Map, basemaps

        return Map(center=list(center), zoom=zoom, basemap=basemaps.OpenStreetMap.Mapnik)
    return _StaticMap(center, zoom)


def overlaymap(aoi_lonlat_list, center=None, zoom=12):
    """Map with footprint overlays (reference: vistools.py:114-166)."""
    if center is None and aoi_lonlat_list:
        center = list(reversed(aoi_lonlat_list[0]["center"]))
    m = clickablemap(center=center or (0.0, 0.0), zoom=zoom)
    if _have_ipyleaflet():
        from ipyleaflet import Polygon as LeafletPolygon

        for aoi in aoi_lonlat_list:
            ring = [(lat, lon) for lon, lat in aoi["coordinates"][0]]
            m.add_layer(LeafletPolygon(locations=ring, color="blue", fill_opacity=0.1))
        return m
    for aoi in aoi_lonlat_list:
        m.add_polygon(np.array(aoi["coordinates"][0]))
    return m


class _StaticMap:
    """matplotlib fallback for the map widgets."""

    def __init__(self, center, zoom):
        self.center = center
        self.zoom = zoom
        self.polygons = []

    def add_polygon(self, lonlat_ring):
        self.polygons.append(np.asarray(lonlat_ring))

    # API-compat no-ops for common ipyleaflet calls
    def add_layer(self, *_, **__):
        pass

    def show(self, path=None):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 8))
        ax.axis("equal")
        for ring in self.polygons:
            closed = np.vstack([ring, ring[:1]])
            ax.plot(closed[:, 0], closed[:, 1], color="blue")
        ax.set_xlabel("lon")
        ax.set_ylabel("lat")
        if path:
            fig.savefig(path, bbox_inches="tight")
            plt.close(fig)
            return path
        return fig


def display_gallery(images, titles=None, cols=4, path=None):
    """Image thumbnail gallery (reference: vistools.py:413-470), rendered
    with matplotlib instead of HTML widgets."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(images)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows), squeeze=False)
    for i in range(rows * cols):
        ax = axes[i // cols][i % cols]
        ax.axis("off")
        if i < n:
            ax.imshow(np.asarray(images[i]), cmap="gray")
            if titles:
                ax.set_title(str(titles[i]), fontsize=8)
    if path:
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def printmd(string):
    """Markdown print in notebooks, plain print elsewhere
    (reference: vistools.py:273-276)."""
    try:
        from IPython.display import Markdown, display

        display(Markdown(string))
    except ImportError:
        print(string)


def printbf(obj):
    """Bold print (reference: vistools.py:279-280)."""
    printmd("**" + str(obj) + "**")


def _to_uint8(a):
    a = np.asarray(a, dtype=np.float64)
    lo, hi = np.nanmin(a), np.nanmax(a)
    return np.uint8(np.clip((a - lo) / max(hi - lo, 1e-12), 0, 1) * 255)


def urlencoded_jpeg_img(a):
    """base64 data-URL jpeg of an array (reference: vistools.py:345-359)."""
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(_to_uint8(a)).save(buf, format="JPEG")
    return "data:image/jpeg;base64," + base64.b64encode(buf.getvalue()).decode("ascii")


def show_array(a, fmt="jpeg"):
    """Inline image display of an array (reference: vistools.py:283-297);
    returns the encoded bytes when no notebook frontend is present."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(_to_uint8(a)).save(buf, format=fmt.upper())
    data = buf.getvalue()
    try:
        from IPython.display import Image as IPImage
        from IPython.display import display

        display(IPImage(data=data))
    except ImportError:
        pass
    return data


def display_image(img):
    """Reference: vistools.py:300-317 (display a filename or array)."""
    if isinstance(img, str):
        from PIL import Image

        img = np.asarray(Image.open(img))
    return show_array(img)


def display_imshow(im, range=None, cmap="gray", axis="equal", invert=False,
                   path=None):
    """matplotlib imshow wrapper (reference: vistools.py:320-342)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    vmin, vmax = (range if range is not None else (None, None))
    fig, ax = plt.subplots()
    ax.imshow(np.asarray(im), cmap=cmap, vmin=vmin, vmax=vmax)
    ax.axis(axis)
    if invert:
        ax.invert_yaxis()
    if path:
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def overprintText(im, imout, text, textRGBA=(255, 255, 255, 255)):
    """Overlay text onto an image file (reference: vistools.py:455-480)."""
    from PIL import Image, ImageDraw

    base = Image.open(im).convert("RGBA")
    txt = Image.new("RGBA", base.size, (255, 255, 255, 0))
    d = ImageDraw.Draw(txt)
    d.text((5, 5), text, fill=tuple(textRGBA))
    Image.alpha_composite(base, txt).convert("RGB").save(imout)


def mkdir_p(path):
    """Reference: vistools.py:483-498."""
    import os

    os.makedirs(path, exist_ok=True)


def display_cloud(xyz, path=None, max_points=20000):
    """3-D point cloud display (reference: vistools.py:501-536 streams to a
    potree server; here a matplotlib 3-D scatter, subsampled)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xyz = np.asarray(xyz)
    if xyz.shape[0] > max_points:
        idx = np.random.RandomState(0).choice(xyz.shape[0], max_points, replace=False)
        xyz = xyz[idx]
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(xyz[:, 0], xyz[:, 1], xyz[:, 2], s=1, c=xyz[:, 2], cmap="viridis")
    if path:
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


# reference alias (vistools.py:539-586 is a variant of the same display)
display_cloud_hack = display_cloud
