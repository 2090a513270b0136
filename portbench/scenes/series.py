"""A multi-date series of views, made from a seed: `generate.render_views`'
arithmetic, per date.

The series has `dates` dates of `per_date` views each. Every view sits on
one ring of dates x per_date positions (`generate.render_views`' ring of
synthetic RPCs): view k of date d at position d + dates * k, so that each
date takes its own positions, spread round the ring. A pixel is, as there,
the texture (bilinear) at the ground point that the pixel localizes to at
altitude alt. Each date changes the scene: its own second texture
(texture seed change["texture_seed"] + d) blended into the ground texture
at the weight change["weight"], then the date's gain and offset (0..255
units), as a season or the light changes a site between two passes. With
the weight 0, gain 1 and offset 0 a view is `render_views`' view of that
ring position, bit for bit.

The seed draws the RPC biases alone (`generate.biases`, view 0 of date 0
unbiased), so every seed asks for the same detection and matching work.
"""

import datetime

import numpy as np
import torch

from portbench.scenes import generate
from portbench.scenes import rpc as rpcm

FIRST = datetime.datetime(2020, 4, 13, 15, 14, 10)


def names(dates, per_date, days_apart, seconds_apart):
    """[[image id of each view] of each date]: YYYYMMDD_HHMMSS_d<d>v<k>,
    dates `days_apart` days apart, a date's views `seconds_apart` apart."""
    return [["{}_d{}v{}".format((FIRST + datetime.timedelta(days=days_apart * d,
                                                           seconds=seconds_apart * k))
                                .strftime("%Y%m%d_%H%M%S"), d, k)
             for k in range(per_date)] for d in range(dates)]


def ring_position(d, k, dates):
    """The position of view k of date d on the ring."""
    return d + dates * k


def ring_rpc(i, n_ring, h, w):
    """render_views' RPC of position i of a ring of n_ring views of h x w."""
    return rpcm.synthetic_rpc(view_dx=250.0 * np.cos(2 * np.pi * i / n_ring),
                              view_dy=250.0 * np.sin(2 * np.pi * i / n_ring),
                              img_halfsize=(w / 2.0, h / 2.0))


def _sample(tex, lons, lats, span):
    """render_views' bilinear lookup of the texture at (lons, lats)."""
    n_tex = tex.shape[0]
    u = torch.clamp((lons - (generate.LON0 - span)) / (2 * span) * (n_tex - 1), 0, n_tex - 1.001)
    v = torch.clamp((lats - (generate.LAT0 - span)) / (2 * span) * (n_tex - 1), 0, n_tex - 1.001)
    u0, v0 = torch.floor(u).long(), torch.floor(v).long()
    fu, fv = u - u0, v - v0
    return ((1 - fv) * ((1 - fu) * tex[v0, u0] + fu * tex[v0, u0 + 1])
            + fv * ((1 - fu) * tex[v0 + 1, u0] + fu * tex[v0 + 1, u0 + 1]))


def render_series(dates, per_date, h, w, alt, n_tex, octaves, texture_seed, change, device,
                  span=0.035, block_rows=256):
    """[[(h, w) uint8 frame of each view] of each date], and the views' dict
    RPCs in the same nesting."""
    n_ring = dates * per_date
    ground = torch.as_tensor(generate.texture(n_tex, octaves, texture_seed), device=device)
    weight = float(change["weight"])
    frames, rpcs = [], []
    for d in range(dates):
        second = None
        if weight:
            second = torch.as_tensor(generate.texture(n_tex, octaves, change["texture_seed"] + d),
                                     device=device)
        gain, offset = float(change["gain"][d]), float(change["offset"][d]) / 255.0
        date_frames, date_rpcs = [], []
        for k in range(per_date):
            rpc = ring_rpc(ring_position(d, k, dates), n_ring, h, w)
            r = {f: torch.as_tensor(np.asarray(rpc[f], np.float64), device=device)
                 for f in rpcm.FIELDS}
            vals = torch.empty(h, w, dtype=torch.float64, device=device)
            for r0 in range(0, h, block_rows):  # in blocks of rows, to bound the memory
                rows = torch.arange(r0, min(h, r0 + block_rows), dtype=torch.float64,
                                    device=device)
                cols = torch.arange(w, dtype=torch.float64, device=device).repeat(len(rows))
                rows = rows.repeat_interleave(w)
                lons, lats = rpcm.localize(r, cols, rows, torch.full_like(cols, alt))
                x = _sample(ground, lons, lats, span)
                if second is not None:
                    x = (1 - weight) * x + weight * _sample(second, lons, lats, span)
                vals[r0:r0 + block_rows] = (gain * x + offset).reshape(-1, w)
            date_frames.append(np.clip(vals.float().cpu().numpy() * 255, 0, 255).astype(np.uint8))
            date_rpcs.append(rpc)
        frames.append(date_frames)
        rpcs.append(date_rpcs)
    return frames, rpcs
