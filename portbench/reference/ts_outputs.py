"""The plain reference of a time series run in `ba_sequential`: what the
series wrote, judged from its files, date by date and as one series.

The views were rendered through known RPCs (portbench/scenes/series.py)
and handed to the program with biased RPCs. In `ba_sequential` each date
is adjusted together with its `n_dates` previous dates, whose cameras stay
frozen; the caches of `<ba_dir>/matches/` keep every view's keypoints
(`features/<id>.npy`) and every matched pair's matches
(`pairwise_matches/<idA>_<idB>.npy`, rows kp_A, kp_B), and each date
writes its points to `pts3d_adj/<date id>_pts3d_adj.ply`. For each date the
reference takes the date's image set (its views and those of its previous
`n_dates` dates), joins the matches of every pair of the set into tracks
(`cli_outputs.tracks`), triangulates them through the final adjusted RPCs
(`rpcs_adj/<id>.rpc_adj`) and gives, each the worst over the dates:

- `reproj_px`: the tracks' mean reprojection error at those points
  (each date's RPCs agree with its tracks);
- `ply_m`: the mean distance from a point of the date's .ply to the nearest
  point that the reference triangulated (a date whose views a later date
  moved no longer agrees with the points it wrote);
- `pair_matches_min`: the fewest matches of any pair of the set (a pair
  with no file has none);
- `view_tracks_min`: the fewest tracks that one view of the set sees;

and, over the whole series:

- `series_bias_px`: the worst view's RMS gap, over all the views of every
  date, between its adjusted RPC and its true one, once the one 3-D shift
  of the ground that fits all of them best is taken out
  (`cli_outputs.bias`): one common shift aligns every date with the truth
  only where the dates share one geometry.

Besides, for the record: `cross_pair_ratio_min`, the fewest matches of a
pair across two dates over the mean of the same-date pairs of the set
(the least of the dates').

`rounding` rounds what the program wrote before it is judged: the control,
in the precision below the one that the configuration states for it.
"""

import os

import numpy as np
import torch

from portbench.reference import cli_outputs
from portbench.scenes import rpc as rpcm

F64 = torch.float64


def pair_matches(mdir, a, b):
    """(K, 2) int64 matches (kp of a, kp of b) from the pairwise cache, in
    either order, or None where the pair has no file."""
    for x, y, flip in ((a, b, False), (b, a, True)):
        path = os.path.join(mdir, "pairwise_matches", "{}_{}.npy".format(x, y))
        if os.path.exists(path):
            m = np.load(path).astype(np.int64).reshape(-1, 2)
            return m[:, ::-1] if flip else m
    return None


def judge_date(ba_dir, ids, date_id, adj, rounding, alt):
    """The numbers of one date: its image set `ids`, their adjusted RPCs
    `adj` (dict RPCs, in the order of ids)."""
    geo, kp_dtype = rounding
    mdir = os.path.join(ba_dir, "matches")
    keypoints = []
    for i in ids:
        feats = np.load(os.path.join(mdir, "features", i + ".npy"))
        keypoints.append(cli_outputs._round(feats[np.isfinite(feats[:, 0]), :2], kp_dtype))
    n = len(ids)
    rows, per_pair = [], {}
    for a in range(n):
        for b in range(a + 1, n):
            m = pair_matches(mdir, ids[a], ids[b])
            per_pair[a, b] = 0 if m is None else len(m)
            if m is not None and len(m):
                rows.append(np.hstack([m, np.broadcast_to([a, b], (len(m), 2))]))
    matches = np.concatenate(rows) if rows else np.zeros((0, 4), np.int64)
    table = cli_outputs.tracks([k.numpy() for k in keypoints], matches)
    seen = torch.as_tensor(table >= 0).T  # (V, T)
    obs = torch.stack([k[torch.as_tensor(np.maximum(t, 0))] for k, t in zip(keypoints, table.T)])
    pts, err = cli_outputs.triangulate(adj, obs, seen, alt)
    ply = cli_outputs._round(cli_outputs.read_ply(
        os.path.join(ba_dir, "pts3d_adj", date_id + "_pts3d_adj.ply")), geo)
    mine = rpcm.latlon_to_ecef(pts[:, 1], pts[:, 0], pts[:, 2])
    near = torch.cat([torch.cdist(c, mine).min(1).values for c in ply.split(4096)])
    day = [i[:8] for i in ids]
    same = [v for (a, b), v in per_pair.items() if day[a] == day[b]]
    cross = [v for (a, b), v in per_pair.items() if day[a] != day[b]]
    return {"reproj_px": float(err.mean()), "ply_m": float(near.mean()),
            "pair_matches_min": min(per_pair.values()),
            "view_tracks_min": int(seen.sum(1).min()),
            "cross_pair_ratio_min": min(cross) / np.mean(same) if cross and same else None}


def judge(ba_dir, dates, n_dates, true_rpcs, h, w, alt, rounding=(F64, torch.float32)):
    """The numbers of one series. dates: [[image id of each view] of each
    date], in the series' order; n_dates: the previous dates adjusted with
    each; true_rpcs: {image id: its rendered dict RPC}; rounding: the dtypes
    that the geometry (RPCs, points) and the keypoint coordinates are
    rounded to before they are judged."""
    geo = rounding[0]
    adj = {i: cli_outputs._rpc(rpcm.read_file(os.path.join(ba_dir, "rpcs_adj", i + ".rpc_adj")),
                               geo)
           for date in dates for i in date}
    per_date = []
    for d, date in enumerate(dates):
        ids = [i for prev in dates[max(0, d - n_dates):d] for i in prev] + list(date)
        per_date.append(judge_date(ba_dir, ids, date[0][:15], [adj[i] for i in ids], rounding,
                                   alt))
    every = [i for date in dates for i in date]
    ratios = [x["cross_pair_ratio_min"] for x in per_date if x["cross_pair_ratio_min"] is not None]
    return {"reproj_px": max(x["reproj_px"] for x in per_date),
            "ply_m": max(x["ply_m"] for x in per_date),
            "series_bias_px": cli_outputs.bias([adj[i] for i in every],
                                               [cli_outputs._rpc(true_rpcs[i]) for i in every],
                                               h, w, alt),
            "pair_matches_min": min(x["pair_matches_min"] for x in per_date),
            "view_tracks_min": min(x["view_tracks_min"] for x in per_date),
            "cross_pair_ratio_min": min(ratios) if ratios else None}
