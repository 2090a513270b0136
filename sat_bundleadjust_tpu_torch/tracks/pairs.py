"""Stereo pair selection from footprint overlap and baseline.

A copy of `sat_bundleadjust_tpu/tracks/pairs.py` (numpy).

Covers the reference's ft_match.compute_pairs_to_match
(feature_tracks/ft_match.py:17-73): a pair is matchable if the footprints
overlap by >10% of the first image's area; it is triangulable if the
camera baseline over the orbit altitude exceeds 1/4. Cameras whose every
pair fails the baseline test are rescued by re-admitting their pairs
(ft_match.py:56-63)."""

import numpy as np

from sat_bundleadjust_tpu_torch.utils.geo import geojson_to_polygon


def compute_pairs_to_match(init_pairs, footprints, optical_centers,
                           min_overlap=0.1, min_baseline=1 / 4,
                           orbit_alt=500000, verbose=True):
    """Args and semantics identical to the reference (ft_match.py:17-73)."""

    def set_pair(i, j):
        return (min(i, j), max(i, j))

    pairs_to_match, pairs_to_triangulate = [], []
    for (i, j) in init_pairs:
        i, j = int(i), int(j)
        poly_i = geojson_to_polygon(footprints[i]["geojson"])
        poly_j = geojson_to_polygon(footprints[j]["geojson"])
        inter_area = poly_i.intersection(poly_j).area
        overlap_ok = poly_i.area > 0 and inter_area / poly_i.area > min_overlap
        if overlap_ok:
            pairs_to_match.append(set_pair(i, j))
            baseline = np.linalg.norm(
                np.asarray(optical_centers[i]) - np.asarray(optical_centers[j])
            )
            if baseline / orbit_alt > min_baseline:
                pairs_to_triangulate.append(set_pair(i, j))

    # rescue cameras with no acceptable baseline (ft_match.py:56-63)
    cams_match = set(np.unique(np.array(pairs_to_match).flatten())) if pairs_to_match else set()
    cams_tri = set(np.unique(np.array(pairs_to_triangulate).flatten())) if pairs_to_triangulate else set()
    cams_bad_baseline = list(cams_match - cams_tri)
    pairs_to_triangulate.extend(
        [(i, j) for (i, j) in pairs_to_match if i in cams_bad_baseline or j in cams_bad_baseline]
    )

    if verbose:
        print("     {} / {} pairs suitable to match".format(len(pairs_to_match), len(init_pairs)))
        print("     {} / {} pairs suitable to triangulate".format(len(pairs_to_triangulate), len(init_pairs)))
        if cams_bad_baseline:
            print(
                "     WARNING: Found {} cameras with insufficient baseline w.r.t. "
                "all neighbor cameras".format(len(cams_bad_baseline))
            )
            print("              Concerned cameras are: {}".format(cams_bad_baseline))

    return pairs_to_match, pairs_to_triangulate
