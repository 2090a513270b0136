"""Epipolar-gated 2-NN descriptor matching: CUDA kernels, wrappers, plain
versions.

Counterpart of `sat_bundleadjust_tpu/ops/pallas_match.py`. For each pair b
and each row i (keypoints of image i), over the columns j (image j):

    dist = max((sq_i + sq_j) - 2 * cross, 0)
    ok   = valid_i > 0 and valid_j > 0 and num * num <= (thr * thr) * denom
           (num = l_i . h_j, denom = l_i0^2 + l_i1^2; thr = 1e9 turns it off)
    d    = dist where ok, else BIG = 1e12

and the result is (d1, d2, idx): the smallest d, the smallest d over every
column except the argmin (d2 == d1 on a tie), and the lowest column reaching
d1 (0 when no column is valid).

Three entry points, as in the JAX package:
* `nn2_batched_i8`  <- `pallas_2nn_batched_i8`: int8 descriptors (value -
  128), packed (B, 3, N1) result;
* `nn2_batched`     <- `pallas_2nn_batched`: f32 descriptors;
* `nn2_single`      <- `pallas_2nn`: one pair with a scalar threshold,
  three (N1,) results; the f32 kernel with B = 1.

CUDA tensors launch the kernels of `csrc/nn2_match.cu` (or raise), all on
the tensor cores: the int8 entry point as s8 `mma.sync`, the f32 ones as
TF32 `wgmma` with a three-product split (a = a_hi + a_lo; a.b ~
a_hi.b_hi + a_hi.b_lo + a_lo.b_hi), their columns split over `S` slices of
the grid where the pairs' row blocks alone would not fill the card
(`column_splits`). CPU tensors run `nn2_plain`, the plain PyTorch version,
which the kernels are held against. On integer descriptors every value
after the cross term is an exact integer below 2^24 in f32 (and exact in
TF32 up to 2047), so kernels, plain version and JAX give the same bits,
whatever S. The gate is computed elementwise in the order
((l0*h0) + (l1*h1)) + (l2*h2) on both sides.
"""

import ctypes

import torch

from sat_bundleadjust_tpu_torch.ops import _build

BIG = 1e12
# rows per block of the plain version: bounds its (rows, N2) temporaries
PLAIN_ROWS = 1024

_SIGNATURES = {
    "nn2_match_i8": (ctypes.c_int, [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    "nn2_match_i8_scratch_bytes": (ctypes.c_long, [ctypes.c_int] * 2),
    "nn2_match_f32": (ctypes.c_int,
                      [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "nn2_match_f32_scratch_bytes": (ctypes.c_long, [ctypes.c_int] * 2),
    "nn2_match_f32_splits": (ctypes.c_int, [ctypes.c_int] * 4),
}


def _top2_rows(di, dj, sq_j, li, hj, vi, vj, thr):
    """Plain (d1, d2, idx) for a block of rows of one pair: di (R, 128) f32,
    dj (N2, 128) f32, sq_j (N2,), li (R, 3), hj (N2, 3), vi (R,), vj (N2,),
    thr a 0-d f32 tensor."""
    sq_i = torch.sum(di * di, dim=1)
    cross = di @ dj.T
    dist = torch.clamp_min((sq_i[:, None] + sq_j[None, :]) - 2.0 * cross, 0.0)
    num = (li[:, 0:1] * hj[None, :, 0] + li[:, 1:2] * hj[None, :, 1]) + li[:, 2:3] * hj[None, :, 2]
    denom = li[:, 0:1] * li[:, 0:1] + li[:, 1:2] * li[:, 1:2]
    gate_ok = num * num <= (thr * thr) * denom
    valid = (vi[:, None] > 0) & (vj[None, :] > 0) & gate_ok
    big = torch.tensor(BIG, dtype=torch.float32, device=di.device)
    dist = torch.where(valid, dist, big)
    d1 = dist.min(dim=1, keepdim=True).values
    cols = torch.arange(dist.shape[1], device=di.device, dtype=torch.int32)[None, :]
    arg1 = torch.where(dist <= d1, cols, torch.full_like(cols, 2 ** 30)).min(dim=1, keepdim=True).values
    d2 = torch.where(cols == arg1, big, dist).min(dim=1).values
    return d1[:, 0], d2, arg1[:, 0]


def nn2_plain(desc_i, desc_j, lines_i, hpts_j, valid_i, valid_j, epi_thr):
    """Plain PyTorch version of both batched kernels (the CPU path and the
    reference the kernels are held against). desc_* int8 (value - 128) or
    f32; returns the packed (B, 3, N1) f32 (d1, d2, idx).

    The int8 cross term is taken as an f32 product: every partial sum of
    products of values in -128..127 is an integer below 2^22, exact in f32."""
    B, N1 = desc_i.shape[0], desc_i.shape[1]
    N2 = desc_j.shape[1]
    dev = desc_i.device
    out = torch.empty((B, 3, N1), dtype=torch.float32, device=dev)
    if N2 == 0:
        out[:, 0:2] = BIG
        out[:, 2] = 0.0
        return out
    for b in range(B):
        dj = desc_j[b].to(torch.float32)
        hj = hpts_j[b].to(torch.float32)
        vj = valid_j[b].to(torch.float32)
        sq_j = torch.sum(dj * dj, dim=1)
        thr = epi_thr[b].to(torch.float32)
        for r0 in range(0, N1, PLAIN_ROWS):
            r1 = min(N1, r0 + PLAIN_ROWS)
            d1, d2, idx = _top2_rows(
                desc_i[b, r0:r1].to(torch.float32), dj, sq_j,
                lines_i[b, r0:r1].to(torch.float32), hj,
                valid_i[b, r0:r1].to(torch.float32), vj, thr)
            out[b, 0, r0:r1] = d1
            out[b, 1, r0:r1] = d2
            out[b, 2, r0:r1] = idx.to(torch.float32)
    return out


def _check(name, desc_dtype, desc_i, desc_j, lines_i, hpts_j, valid_i, valid_j, epi_thr):
    dev = desc_i.device
    B, N1 = desc_i.shape[0], desc_i.shape[1]
    N2 = desc_j.shape[1]
    want = (
        ("desc_i", desc_i, desc_dtype, (B, N1, 128)),
        ("desc_j", desc_j, desc_dtype, (B, N2, 128)),
        ("lines_i", lines_i, torch.float32, (B, N1, 3)),
        ("hpts_j", hpts_j, torch.float32, (B, N2, 3)),
        ("valid_i", valid_i, torch.float32, (B, N1)),
        ("valid_j", valid_j, torch.float32, (B, N2)),
        ("epi_thr", epi_thr, torch.float32, (B,)),
    )
    for arg, t, dt, shape in want:
        if t.device != dev:
            raise ValueError("{}: {} is on {}, desc_i on {}".format(name, arg, t.device, dev))
        if t.dtype != dt:
            raise ValueError("{}: {} must be {}, got {}".format(name, arg, dt, t.dtype))
        if tuple(t.shape) != shape:
            raise ValueError("{}: {} has shape {}, expected {}".format(
                name, arg, tuple(t.shape), shape))
        if not t.is_contiguous():
            raise ValueError("{}: {} must be contiguous".format(name, arg))
    for arg, t in (("desc_i", desc_i), ("desc_j", desc_j)):
        if t.numel() and t.data_ptr() % 16:
            raise ValueError("{}: {} must be 16-byte aligned".format(name, arg))
    return B, N1, N2


def _lib():
    return _build.load("nn2_match", _SIGNATURES)


def _launch(fn, buffers, *ints):
    """Call the C entry point `fn` on device buffers and ints, in its order."""
    stream = torch.cuda.current_stream(buffers[0].device).cuda_stream
    err = getattr(_lib(), fn)(*[t.data_ptr() for t in buffers], *ints, stream)
    if err != 0:
        raise RuntimeError("{} kernel launch failed: CUDA error {}".format(fn, err))


def column_splits(B, N1, N2, device):
    """The number S of column splits the f32 kernel takes for B pairs of
    N1 x N2 on `device`: about two waves of blocks, 1 once the pairs' row
    blocks fill the card (csrc/nn2_match.cu, nn2_match_f32_splits)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _lib().nn2_match_f32_splits(B, N1, N2, sms)


def _launch_f32(args, B, N1, N2, splits=None):
    """The f32 kernel with at most `splits` column splits (default:
    column_splits for this card)."""
    dev = args[0].device
    S = column_splits(B, N1, N2, dev) if splits is None else splits
    out = torch.empty((B, 3, N1), dtype=torch.float32, device=dev)
    # each column tile's TF32 hi and lo and its records (sq_j, h_j), written by the first launch
    scratch = torch.empty(_lib().nn2_match_f32_scratch_bytes(B, N2), dtype=torch.uint8, device=dev)
    # the splits' partial (d1, d2, idx), merged by the last launch
    part = torch.empty((S, B, 3, N1) if S > 1 else (0,), dtype=torch.float32, device=dev)
    _launch("nn2_match_f32", (*args, out, scratch, part), B, N1, N2, S)
    return out


def _launch_i8(args, B, N1, N2):
    dev = args[0].device
    out = torch.empty((B, 3, N1), dtype=torch.float32, device=dev)
    # the per-column records (sq_j, h_j) that the first of its two launches writes
    scratch = torch.empty(_lib().nn2_match_i8_scratch_bytes(B, N2), dtype=torch.uint8, device=dev)
    _launch("nn2_match_i8", (*args, out, scratch), B, N1, N2)
    return out


def _batched(name, launch, desc_dtype, args):
    B, N1, N2 = _check(name, desc_dtype, *args)
    dev = args[0].device
    if dev.type == "cpu":
        return nn2_plain(*args)
    if dev.type != "cuda":
        raise ValueError("{}: unsupported device {}".format(name, dev))
    return launch(args, B, N1, N2)


def nn2_batched_i8(desc_i, desc_j, lines_i, hpts_j, valid_i, valid_j, epi_thr):
    """Batched 2-NN on int8 descriptors (descriptor value - 128).

    desc_i (B, N1, 128) int8; desc_j (B, N2, 128) int8; lines_i (B, N1, 3)
    epipolar lines of the rows in image j; hpts_j (B, N2, 3) homogeneous
    column points; valid_* (B, N) f32 0/1; epi_thr (B,) f32 (1e9 disables
    the gate). Returns the packed (B, 3, N1) f32 (d1, d2, idx). Each launch
    adds one to nn2_batched_i8.launches."""
    args = (desc_i, desc_j, lines_i, hpts_j, valid_i, valid_j, epi_thr)
    out = _batched("nn2_batched_i8", _launch_i8, torch.int8, args)
    if out.device.type == "cuda" and out.numel():
        nn2_batched_i8.launches += 1
    return out


def nn2_batched(desc_i, desc_j, lines_i, hpts_j, valid_i, valid_j, epi_thr):
    """nn2_batched_i8 with f32 descriptors (the fallback for descriptors that
    are not integers in 0..255), on the TF32 split. Each launch adds one to
    nn2_batched.launches."""
    args = (desc_i, desc_j, lines_i, hpts_j, valid_i, valid_j, epi_thr)
    out = _batched("nn2_batched", _launch_f32, torch.float32, args)
    if out.device.type == "cuda" and out.numel():
        nn2_batched.launches += 1
    return out


def nn2_single(desc_i, desc_j, lines_i, hpts_j, valid_i, valid_j, epi_thr):
    """One pair: desc_i (N1, 128), desc_j (N2, 128) f32, lines_i (N1, 3),
    hpts_j (N2, 3), valid_* (N,) f32, epi_thr a float. Returns (d1 (N1,),
    d2 (N1,), idx (N1,) int32). Runs the f32 kernel with B = 1, its columns
    split to fill the card; each launch adds one to nn2_single.launches."""
    dev = desc_i.device
    # a fill on the device: a copy from the host would wait for the stream
    thr = torch.full((1,), float(epi_thr), dtype=torch.float32, device=dev)
    args = (desc_i[None], desc_j[None], lines_i[None], hpts_j[None],
            valid_i[None], valid_j[None], thr)
    out = _batched("nn2_single", _launch_f32, torch.float32, args)
    if out.device.type == "cuda" and out.numel():
        nn2_single.launches += 1
    return out[0, 0], out[0, 1], out[0, 2].to(torch.int32)


nn2_batched_i8.launches = 0
nn2_batched.launches = 0
nn2_single.launches = 0
