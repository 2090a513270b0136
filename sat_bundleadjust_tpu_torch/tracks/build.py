"""Feature track construction.

Counterpart of `sat_bundleadjust_tpu/tracks/build.py` (host numpy, as
there): union-find over the pairwise matches into the correspondence matrix
C (2M x N) and the keypoint-id matrix C_v2 (M x N), and the camera
connectivity checks. The union-find is the repository's committed C++
library `native/libtrackbuild.so`, loaded read-only through ctypes, with an
iterative path-halving Python fallback where it cannot be loaded. The
connectivity graph's components come from the same union-find (no
networkx).
"""

import ctypes
import os

import numpy as np
import torch

from sat_bundleadjust_tpu_torch.ops.triangulate import pair_lookup, tracks_with_a_pair

_NATIVE_LIB = None
_NATIVE_TRIED = False
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _load_native():
    """ctypes handle to native/libtrackbuild.so, or None if unavailable."""
    global _NATIVE_LIB, _NATIVE_TRIED
    if _NATIVE_TRIED:
        return _NATIVE_LIB
    _NATIVE_TRIED = True
    path = os.path.join(_REPO, "native", "libtrackbuild.so")
    if os.path.exists(path):
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
        lib.uf_build.restype = None
        lib.uf_build.argtypes = [ctypes.c_int64, i64p, i64p, ctypes.c_int64, i64p]
        _NATIVE_LIB = lib
    return _NATIVE_LIB


def union_find(n, edges_a, edges_b):
    """Union-find over match edges; returns the root of each element (the
    native library, else the Python path-halving fallback)."""
    edges_a = np.ascontiguousarray(edges_a, dtype=np.int64)
    edges_b = np.ascontiguousarray(edges_b, dtype=np.int64)
    lib = _load_native()
    if lib is not None:
        roots = np.empty(n, dtype=np.int64)
        lib.uf_build(n, edges_a, edges_b, len(edges_a), roots)
        return roots

    parent = np.arange(n, dtype=np.int64)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in zip(edges_a.tolist(), edges_b.tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    for i in range(n):
        parent[i] = find(i)
    return parent


def feature_tracks_from_pairwise_matches(features, pairwise_matches, pairs_to_triangulate):
    """Build C (2M, N) and C_v2 (M, N) from pairwise matches.

    features: per-image (N_i, 132) keypoint arrays or .npy paths;
    pairwise_matches: (K, 4) int rows (kp_i, kp_j, im_i, im_j);
    pairs_to_triangulate: camera index pairs (a track needs one)."""
    loaded = [np.load(f, mmap_mode="r") if isinstance(f, str) else np.asarray(f) for f in features]
    n_cams = len(loaded)
    kp_counts = [f.shape[0] for f in loaded]
    id_offsets = np.concatenate([[0], np.cumsum(kp_counts)])[:-1]

    pm = np.asarray(pairwise_matches, dtype=np.int64)
    kp_i, kp_j, im_i, im_j = pm[:, 0], pm[:, 1], pm[:, 2], pm[:, 3]
    ids_i = id_offsets[im_i] + kp_i
    ids_j = id_offsets[im_j] + kp_j

    parents = union_find(int(np.sum(kp_counts)), ids_i, ids_j)

    # tracks = roots appearing at least twice
    uniq, inverse, counts = np.unique(parents, return_inverse=True, return_counts=True)
    is_track_root = counts > 1
    track_idx_of_root = np.full(len(uniq), -1, dtype=np.int64)
    track_idx_of_root[is_track_root] = np.arange(int(np.sum(is_track_root)))
    track_of_kp = track_idx_of_root[inverse]
    n_tracks = int(np.sum(is_track_root))

    C = np.full((2 * n_cams, n_tracks), np.nan)
    C_v2 = np.full((n_cams, n_tracks), np.nan)

    t_idx = track_of_kp[ids_i]
    all_xy = np.concatenate([np.asarray(f[:, :2]) for f in loaded], axis=0)
    coords_i = all_xy[ids_i]
    coords_j = all_xy[ids_j]
    C[2 * im_i, t_idx] = coords_i[:, 0]
    C[2 * im_i + 1, t_idx] = coords_i[:, 1]
    C[2 * im_j, t_idx] = coords_j[:, 0]
    C[2 * im_j + 1, t_idx] = coords_j[:, 1]
    C_v2[im_i, t_idx] = kp_i
    C_v2[im_j, t_idx] = kp_j

    # the tracks that a listed pair of their cameras observes, by the table's
    # key lookup (ops/triangulate.tracks_with_a_pair's test m^T P m > 0)
    pt, cam = (torch.as_tensor(a) for a in np.nonzero(~np.isnan(C[::2]).T))
    keep = tracks_with_a_pair(pt, cam, n_tracks, n_cams,
                              pair_lookup(pairs_to_triangulate, n_cams, "cpu")).numpy()
    return C[:, keep], C_v2[:, keep]


def correspondence_matrix(p):
    """The (2M, N) correspondence matrix (NaN where unobserved) of a BA
    problem's observation table: its tracks in this layer's format."""
    C = np.full((2 * p.n_cam, p.n_pts), np.nan)
    C[2 * p.cam_ind, p.pts_ind] = p.pts2d[:, 0]
    C[2 * p.cam_ind + 1, p.pts_ind] = p.pts2d[:, 1]
    return C


def check_pairs(camera_indices, pairs_to_match, pairs_to_triangulate):
    """Every camera must appear in both pair lists. Returns (fatal_error,
    err_msg, disconnected camera indices)."""
    fatal_error, err_msg, disconnected = False, "", []
    camera_indices = set(int(i) for i in camera_indices)
    for name, pairs in (("pairs_to_match", pairs_to_match),
                        ("pairs_to_triangulate", pairs_to_triangulate)):
        present = set(np.unique(np.array(pairs).flatten())) if pairs else set()
        missing = list(camera_indices - present)
        if missing:
            disconnected = missing
            fatal_error = len(missing) > len(camera_indices) // 2
            print("WARNING: Found {} cameras out of {} missing in {}".format(
                len(missing), len(camera_indices), name))
            print("         The disconnected camera indices are: {}".format(missing))
            if fatal_error:
                err_msg = "More than 50% of the cameras are disconnected in terms of feature tracking"
    return fatal_error, err_msg, disconnected


def check_correspondence_matrix(C, min_obs_cam=10):
    """Every camera needs min_obs_cam observations. Returns (fatal_error,
    err_msg, disconnected camera indices)."""
    fatal_error, err_msg, disconnected = False, "", []
    if C is None or C.shape[0] // 2 > C.shape[1]:
        return True, "Found less tracks than cameras", disconnected
    n_cam = C.shape[0] // 2
    obs_per_cam = np.sum(~np.isnan(C[::2]), axis=1)
    if np.sum(obs_per_cam < min_obs_cam) > 0:
        disconnected = np.arange(n_cam)[obs_per_cam < min_obs_cam].tolist()
        fatal_error = len(disconnected) > n_cam // 2
        print("WARNING: Found {} cameras out of {} with less than {} tie point observations"
              .format(len(disconnected), n_cam, min_obs_cam))
        print("         The disconnected camera indices are: {}".format(disconnected))
        if fatal_error:
            err_msg = "More than 50% of the cameras are disconnected in terms of feature tracking"
    return fatal_error, err_msg, disconnected


def build_connectivity_matrix(C, min_matches=10):
    """(M, M) pairwise match counts, counts below min_matches set to 0."""
    mask = (~np.isnan(C[::2])).astype(np.int64)
    A = mask @ mask.T
    np.fill_diagonal(A, 0)
    A[A < min_matches] = 0
    return A.astype(np.float64)


def build_connectivity_graph(C, min_matches, verbose=True):
    """The camera graph (an edge where two cameras share more than
    min_matches tracks) and its connected components.

    Returns (G, edges, matches_per_edge, n_cc, missing_cams): G is a dict
    of the nodes, the edges with their match counts, and the components
    (sorted node lists, ordered by their first node, as networkx lists
    them); missing_cams are the cameras outside the largest component (the
    first of equal size)."""
    n_cam = C.shape[0] // 2
    A = build_connectivity_matrix(C, 0)
    ii, jj = np.nonzero(np.triu(A > min_matches, k=1))
    edges = list(zip(ii.tolist(), jj.tolist()))
    matches_per_edge = [int(A[i, j]) for i, j in edges]

    roots = union_find(n_cam, ii, jj)
    components = {}
    for node, root in enumerate(roots.tolist()):
        components.setdefault(root, []).append(node)
    cc = sorted(components.values(), key=lambda c: c[0])
    n_cc = len(cc)
    largest = int(np.argmax([len(c) for c in cc])) if cc else 0
    missing_cams = sorted(set(range(n_cam)) - set(cc[largest])) if cc else []
    G = {"nodes": list(range(n_cam)), "edges": edges, "weights": matches_per_edge,
         "components": cc}
    if verbose:
        obs_per_cam = np.sum(~np.isnan(C), axis=1)[::2]
        print("Connectivity graph: {} connected components (CCs)".format(n_cc))
        print("                    {} missing cameras from largest CC: {}".format(
            len(missing_cams), missing_cams))
        print("                    {} edges".format(len(edges)))
        if matches_per_edge:
            print("                    {} min n_matches in an edge".format(min(matches_per_edge)))
        print("                    {} min obs per camera\n".format(int(np.min(obs_per_cam))))
    return G, edges, matches_per_edge, n_cc, missing_cams
