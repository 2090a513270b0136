"""Minimal 2-D polygon geometry (numpy), internalizing the role of shapely.

A copy of `sat_bundleadjust_tpu/utils/polygons.py` (numpy only; the port
keeps its own copy and imports nothing of the JAX package).

The reference depends on shapely for footprint algebra
(geo_utils.py:117-205, ft_match.py:17-73, ba_rpcfit.py:348-356). This
environment has no shapely, and the polygons involved are small (image
footprint quadrilaterals, AOIs, convex hulls of projected grids), so a
compact exact implementation suffices:

* shoelace area / centroid
* Andrew monotone-chain convex hull
* Sutherland-Hodgman clipping for convex-convex intersection
* point-in-polygon (winding)
* union of overlapping footprints approximated by the convex hull of all
  vertices (the reference itself falls back to `convex_hull` whenever the
  shapely union is a MultiPolygon, geo_utils.py:196-205)
"""

import numpy as np


class Polygon:
    """A simple polygon given by an (N, 2) vertex ring (no closing repeat)."""

    def __init__(self, coords):
        coords = np.asarray(coords, dtype=np.float64)
        if coords.shape[0] >= 2 and np.allclose(coords[0], coords[-1]):
            coords = coords[:-1]
        self.coords = coords

    # -- measures ------------------------------------------------------

    @property
    def area(self):
        return abs(self.signed_area)

    @property
    def signed_area(self):
        x, y = self.coords[:, 0], self.coords[:, 1]
        return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))

    @property
    def centroid(self):
        """Area-weighted centroid (same definition as shapely's)."""
        x, y = self.coords[:, 0], self.coords[:, 1]
        xn, yn = np.roll(x, -1), np.roll(y, -1)
        cross = x * yn - xn * y
        a = np.sum(cross) / 2.0
        if abs(a) < 1e-30:
            return self.coords.mean(axis=0)
        cx = np.sum((x + xn) * cross) / (6.0 * a)
        cy = np.sum((y + yn) * cross) / (6.0 * a)
        return np.array([cx, cy])

    @property
    def exterior(self):
        """Closed ring (first vertex repeated), shapely-like accessor."""
        return np.vstack([self.coords, self.coords[:1]])

    @property
    def is_valid(self):
        """True if no two non-adjacent edges intersect (simple polygon).
        Vectorized over all edge pairs (broadcast cross products)."""
        c = self.coords
        n = len(c)
        if n < 3:
            return False
        i_idx, j_idx = np.triu_indices(n, 1)
        adjacent = ((j_idx - i_idx) % n == 1) | ((i_idx - j_idx) % n == 1)
        i_idx, j_idx = i_idx[~adjacent], j_idx[~adjacent]
        if len(i_idx) == 0:
            return True
        p1, p2 = c[i_idx], c[(i_idx + 1) % n]
        p3, p4 = c[j_idx], c[(j_idx + 1) % n]

        def cross(a, b):
            return a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]

        d1 = cross(p4 - p3, p1 - p3)
        d2 = cross(p4 - p3, p2 - p3)
        d3 = cross(p2 - p1, p3 - p1)
        d4 = cross(p2 - p1, p4 - p1)
        inter = ((d1 > 0) != (d2 > 0)) & ((d3 > 0) != (d4 > 0))
        return not bool(np.any(inter))

    # -- predicates / ops ----------------------------------------------

    def contains_point(self, p):
        return _point_in_polygon(np.asarray(p), self.coords)

    def contains_points(self, pts):
        """Vectorized ray-crossing test for (P, 2) points: same parity rule
        as _point_in_polygon, broadcast over all points at once (needed for
        per-pixel AOI masks at real image sizes)."""
        pts = np.asarray(pts, dtype=np.float64)
        c = self.coords
        n = len(c)
        if n < 3 or len(pts) == 0:
            return np.zeros(len(pts), dtype=bool)
        xi, yi = c[:, 0], c[:, 1]
        xj, yj = np.roll(xi, 1), np.roll(yi, 1)
        # precompute per-edge slope terms; chunk points so the (chunk, n)
        # broadcast temporaries stay cache-resident at mask scales
        with np.errstate(divide="ignore", invalid="ignore"):
            slope = (xj - xi) / (yj - yi)
        out = np.empty(len(pts), dtype=bool)
        chunk = 1 << 17
        for s in range(0, len(pts), chunk):
            x = pts[s : s + chunk, 0:1]
            y = pts[s : s + chunk, 1:2]
            cond = (yi[None, :] > y) != (yj[None, :] > y)
            with np.errstate(invalid="ignore"):
                hits = cond & (x < slope[None, :] * (y - yi[None, :]) + xi[None, :])
            out[s : s + chunk] = hits.sum(axis=1) % 2
        return out

    def intersection(self, other):
        """Convex-convex intersection (non-convex inputs are hulled)."""
        a = self if _is_convex(self.coords) else convex_hull_polygon(self.coords)
        b = other if _is_convex(other.coords) else convex_hull_polygon(other.coords)
        clipped = _sutherland_hodgman(a._ccw().coords, b._ccw().coords)
        return Polygon(clipped) if len(clipped) >= 3 else Polygon(np.zeros((0, 2)))

    def intersection_area(self, other):
        return self.intersection(other).area

    def buffer(self, _):
        return self

    def _ccw(self):
        return Polygon(self.coords[::-1]) if self.signed_area < 0 else self


def _is_convex(coords):
    n = len(coords)
    if n < 4:
        return True
    sign = 0
    for i in range(n):
        o, a, b = coords[i], coords[(i + 1) % n], coords[(i + 2) % n]
        cr = (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])
        if abs(cr) < 1e-12:
            continue
        s = 1 if cr > 0 else -1
        if sign == 0:
            sign = s
        elif s != sign:
            return False
    return True


def _cross2d(a, b):
    return a[0] * b[1] - a[1] * b[0]


def _segments_intersect(p1, p2, p3, p4):
    d1 = _cross2d(p4 - p3, p1 - p3)
    d2 = _cross2d(p4 - p3, p2 - p3)
    d3 = _cross2d(p2 - p1, p3 - p1)
    d4 = _cross2d(p2 - p1, p4 - p1)
    return ((d1 > 0) != (d2 > 0)) and ((d3 > 0) != (d4 > 0))


def _point_in_polygon(p, coords):
    x, y = p
    inside = False
    n = len(coords)
    j = n - 1
    for i in range(n):
        xi, yi = coords[i]
        xj, yj = coords[j]
        if (yi > y) != (yj > y) and x < (xj - xi) * (y - yi) / (yj - yi) + xi:
            inside = not inside
        j = i
    return inside


def _sutherland_hodgman(subject, clip):
    """Clip CCW subject polygon by CCW convex clip polygon."""
    output = list(subject)
    n = len(clip)
    for i in range(n):
        a, b = clip[i], clip[(i + 1) % n]
        input_list = output
        output = []
        if not input_list:
            break
        edge = np.array(b) - np.array(a)

        def inside(p):
            return edge[0] * (p[1] - a[1]) - edge[1] * (p[0] - a[0]) >= -1e-12

        s = input_list[-1]
        for e in input_list:
            if inside(e):
                if not inside(s):
                    output.append(_line_intersect(s, e, a, b))
                output.append(e)
            elif inside(s):
                output.append(_line_intersect(s, e, a, b))
            s = e
    return np.array(output) if output else np.zeros((0, 2))


def _line_intersect(p1, p2, p3, p4):
    x1, y1 = p1
    x2, y2 = p2
    x3, y3 = p3
    x4, y4 = p4
    denom = (x1 - x2) * (y3 - y4) - (y1 - y2) * (x3 - x4)
    if abs(denom) < 1e-30:
        return np.array(p2)
    px = ((x1 * y2 - y1 * x2) * (x3 - x4) - (x1 - x2) * (x3 * y4 - y3 * x4)) / denom
    py = ((x1 * y2 - y1 * x2) * (y3 - y4) - (y1 - y2) * (x3 * y4 - y3 * x4)) / denom
    return np.array([px, py])


def convex_hull(points):
    """Andrew monotone chain; returns hull vertices CCW, (H, 2)."""
    pts = np.unique(np.asarray(points, dtype=np.float64), axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def cross2(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(iterable):
        out = []
        for p in iterable:
            while len(out) >= 2 and cross2(out[-2], out[-1], p) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def convex_hull_polygon(points):
    return Polygon(convex_hull(points))


def union_polygon(polygons):
    """Union of overlapping footprints, approximated by the convex hull of
    all vertices (reference falls back to convex_hull for MultiPolygon
    unions, geo_utils.py:196-205)."""
    allv = np.vstack([np.asarray(p.coords if isinstance(p, Polygon) else p) for p in polygons])
    return convex_hull_polygon(allv)
