"""The Schur-complement CG operator: CUDA kernel, wrapper, plain version.

Counterpart of `sat_bundleadjust_tpu/ops/pallas_matvec.py`. For x (M, P)
the operator's W V^-1 W^T part is

    wz[m] = sum_{k: cam(k)=m} What_k ( sum_{k' in track(k)} What_k'^T x[cam(k')] )

with What = W chol(V^-1) folded once per LM step and laid out track-major
(W_pt (N, Tp, P, 3), camera ids cam_ind_pt (N, Tp), sentinel M) and
camera-major (W_cm (M, Tc, P, 3), track ids pts_ind_cam (M, Tc), sentinel
N); ops/lm.py builds both.

Numerical contract: exact f32 products, an f32 sum per track, an f64 sum
per camera (independent of the observation order). The kernel
(csrc/schur_matvec.cu) and `schur_wz_plain` follow it; they differ only in
the order of the f32 per-track sums.
"""

import ctypes

import torch

from sat_bundleadjust_tpu_torch.ops import _build

MAX_P = 9

_SIGNATURES = {
    "schur_wz_f32": (
        ctypes.c_int,
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    ),
}


def schur_wz_plain(x, W_pt, cam_ind_pt, W_cm, pts_ind_cam):
    """Plain PyTorch version of the operator (the CPU path and the
    kernel's reference). Returns wz (M, P) float32."""
    M = x.shape[0]
    N = W_pt.shape[0]
    ci = cam_ind_pt.long()
    c_ok = ((ci >= 0) & (ci < M)).to(x.dtype)[..., None]
    xg = x[ci.clamp(0, max(M - 1, 0))] * c_ok  # (N, Tp, P)
    what = torch.sum(W_pt * xg[..., None], dim=(1, 2))  # (N, 3) f32
    pi = pts_ind_cam.long()
    p_ok = ((pi >= 0) & (pi < N)).to(torch.float64)[..., None]
    whg = what[pi.clamp(0, max(N - 1, 0))].to(torch.float64) * p_ok  # (M, Tc, 3)
    wz = torch.sum(W_cm.to(torch.float64) * whg[:, :, None, :], dim=(1, 3))
    return wz.to(torch.float32)


def _check(x, W_pt, cam_ind_pt, W_cm, pts_ind_cam):
    dev = x.device
    for name, t, dt in (("x", x, torch.float32), ("W_pt", W_pt, torch.float32),
                        ("cam_ind_pt", cam_ind_pt, torch.int32),
                        ("W_cm", W_cm, torch.float32),
                        ("pts_ind_cam", pts_ind_cam, torch.int32)):
        if t.device != dev:
            raise ValueError("schur_wz: {} is on {}, x on {}".format(name, t.device, dev))
        if t.dtype != dt:
            raise ValueError("schur_wz: {} must be {}, got {}".format(name, dt, t.dtype))
        if not t.is_contiguous():
            raise ValueError("schur_wz: {} must be contiguous".format(name))
    M, P = x.shape
    N, Tp = cam_ind_pt.shape
    Tc = pts_ind_cam.shape[1]
    if not 1 <= P <= MAX_P:
        raise ValueError("schur_wz: P={} outside 1..{}".format(P, MAX_P))
    if tuple(W_pt.shape) != (N, Tp, P, 3) or tuple(W_cm.shape) != (M, Tc, P, 3) \
            or pts_ind_cam.shape[0] != M:
        raise ValueError("schur_wz: inconsistent shapes x {}, W_pt {}, cam_ind_pt {}, "
                         "W_cm {}, pts_ind_cam {}".format(
                             tuple(x.shape), tuple(W_pt.shape), tuple(cam_ind_pt.shape),
                             tuple(W_cm.shape), tuple(pts_ind_cam.shape)))
    return M, N, P, Tp, Tc


def schur_wz(x, W_pt, cam_ind_pt, W_cm, pts_ind_cam):
    """wz (M, P) float32. CUDA tensors launch the kernel (or raise); CPU
    tensors run schur_wz_plain. Each launch adds one to schur_wz.launches."""
    M, N, P, Tp, Tc = _check(x, W_pt, cam_ind_pt, W_cm, pts_ind_cam)
    if x.device.type == "cpu":
        return schur_wz_plain(x, W_pt, cam_ind_pt, W_cm, pts_ind_cam)
    if x.device.type != "cuda":
        raise ValueError("schur_wz: unsupported device {}".format(x.device))
    lib = _build.load("schur_matvec", _SIGNATURES)
    what = torch.empty((N, 3), dtype=torch.float32, device=x.device)
    wz = torch.empty((M, P), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.schur_wz_f32(
        x.data_ptr(), W_pt.data_ptr(), cam_ind_pt.data_ptr(), W_cm.data_ptr(),
        pts_ind_cam.data_ptr(), what.data_ptr(), wz.data_ptr(),
        M, N, P, Tp, Tc, stream,
    )
    if err != 0:
        raise RuntimeError("schur_wz kernel launch failed: CUDA error {}".format(err))
    schur_wz.launches += 1
    return wz


schur_wz.launches = 0
