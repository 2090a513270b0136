"""The Schur-complement CG operator: CUDA kernels, binding, plain version.

Counterpart of `sat_bundleadjust_tpu/ops/pallas_matvec.py`. For x (M, P)
the operator's W V^-1 W^T part is

    wz[m] = sum_{k: cam(k)=m} What_k ( sum_{k' in track(k)} What_k'^T x[cam(k')] )

with What = W chol(V^-1) folded once per LM step and laid out track-major
(W_pt (N, Tp, P, 3), camera ids cam_ind_pt (N, Tp), sentinel M) and
camera-major (W_cm (M, Tc, P, 3), track ids pts_ind_cam (M, Tc), sentinel
N); ops/lm.py builds both.

Numerical contract: exact f32 products, an f32 sum per track in slot order,
an f64 sum per camera in a fixed tree whose shape `plan` derives from the
shapes alone (independent of the observation order and of the card). The
kernels (csrc/schur_matvec.cu) and `schur_wz_plain` follow it; they differ
only in the order of the sums.

`SchurOperator` binds the operands once (checks, scratch, output, launch
geometry); calling it launches the kernels with no per-call checks,
allocation or host sync. `schur_wz` binds and calls once. Binding and
calling are safe inside a CUDA graph capture (ops/lm.build_solve captures
them): the scratch and output come from the capture's memory pool, and
binding's only CUDA call sets the kernels' attributes.
"""

import ctypes

import torch

from sat_bundleadjust_tpu_torch.ops import _build

# the kernels' widest camera block: perspective R, T, K (3 + 3 + 5)
MAX_P = 11
# the camera CTA's threads: a thread sums slots t, t+128, ... of its chunk
CAM_THREADS = 128
# camera work items to aim for (M * chunks), and the most chunks per camera
CAM_CTAS_TARGET = 512
MAX_CHUNKS = 16
# the kernels' names, as the profiler reports them
KERNEL_NAMES = ("schur_points", "schur_cameras")


class _Args(ctypes.Structure):
    """csrc/schur_matvec.cu's SchurArgs."""

    _fields_ = [(n, ctypes.c_void_p) for n in
                ("w_pt", "cam_ind_pt", "w_cm", "pts_ind_cam", "what")] + [
        (n, ctypes.c_int) for n in
        ("M", "N", "P", "Tp", "Tc", "T", "G", "L", "point_piece", "point_smem", "cam_piece",
         "cam_smem")]


_SIGNATURES = {
    "schur_wz_prepare": (ctypes.c_int, [ctypes.POINTER(_Args)]),
    "schur_wz_run": (ctypes.c_int, [ctypes.POINTER(_Args)] + [ctypes.c_void_p] * 3),
    "schur_wz_graph_edges": (ctypes.c_int, [ctypes.POINTER(_Args)] + [ctypes.c_void_p] * 3),
}


def plan(M, N, P, Tp, Tc):
    """The kernels' shape-only geometry: slabs of T tracks, and G chunks of
    L slots per camera (the shape of the f64 tree; one thread-block cluster
    of G CTAs per camera). G is the largest power of two <= min(ceil(512 /
    M), ceil(Tc / 128), 16)."""
    T = 64
    while T > 32 and -(-N // T) < 256:
        T //= 2
    g = max(1, min(-(-CAM_CTAS_TARGET // max(M, 1)), -(-Tc // CAM_THREADS), MAX_CHUNKS))
    G = 1 << (g.bit_length() - 1)
    L = -(-Tc // G)
    return {"T": T, "G": G, "L": L}


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


def _check_operands(W_pt, cam_ind_pt, W_cm, pts_ind_cam):
    dev = W_cm.device
    for name, t, dt in (("W_pt", W_pt, torch.float32), ("cam_ind_pt", cam_ind_pt, torch.int32),
                        ("W_cm", W_cm, torch.float32),
                        ("pts_ind_cam", pts_ind_cam, torch.int32)):
        if t.device != dev:
            raise ValueError("schur_wz: {} is on {}, W_cm on {}".format(name, t.device, dev))
        if t.dtype != dt:
            raise ValueError("schur_wz: {} must be {}, got {}".format(name, dt, t.dtype))
        if not t.is_contiguous():
            raise ValueError("schur_wz: {} must be contiguous".format(name))
    shapes = "schur_wz: inconsistent shapes W_pt {}, cam_ind_pt {}, W_cm {}, pts_ind_cam {}".format(
        *(tuple(t.shape) for t in (W_pt, cam_ind_pt, W_cm, pts_ind_cam)))
    if W_cm.dim() != 4 or cam_ind_pt.dim() != 2:
        raise ValueError(shapes)
    M, Tc, P = W_cm.shape[:3]
    N, Tp = cam_ind_pt.shape
    if not 1 <= P <= MAX_P:
        raise ValueError("schur_wz: P={} outside 1..{}".format(P, MAX_P))
    if W_pt.shape != (N, Tp, P, 3) or W_cm.shape[3] != 3 or pts_ind_cam.shape != (M, Tc):
        raise ValueError(shapes)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("schur_wz: unsupported device {}".format(dev))
    return M, N, P, Tp, Tc


def _check(x, W_pt, cam_ind_pt, W_cm, pts_ind_cam):
    M, N, P, Tp, Tc = _check_operands(W_pt, cam_ind_pt, W_cm, pts_ind_cam)
    if x.device != W_cm.device:
        raise ValueError("schur_wz: x is on {}, W_cm on {}".format(x.device, W_cm.device))
    if x.dtype != torch.float32:
        raise ValueError("schur_wz: x must be torch.float32, got {}".format(x.dtype))
    if not x.is_contiguous():
        raise ValueError("schur_wz: x must be contiguous")
    if tuple(x.shape) != (M, P):
        raise ValueError("schur_wz: inconsistent shapes x {}, W_cm {}".format(
            tuple(x.shape), tuple(W_cm.shape)))
    return M, N, P, Tp, Tc


class SchurOperator:
    """x -> wz (M, P) float32 for operands bound once (per LM step).

    Binding checks the operands, allocates the scratch and the output and
    fills the kernels' argument block; a call on CUDA tensors is one C call
    that launches the kernels on the current stream (no checks of x, no
    allocation, no sync; x must be (M, P) float32, contiguous, on the
    operands' card). It returns the operator's own output tensor, which the
    next call overwrites. On CPU tensors a call is `schur_wz_plain`. Each
    CUDA call adds one to `schur_wz.launches`.
    """

    def __init__(self, W_pt, cam_ind_pt, W_cm, pts_ind_cam):
        M, N, P, Tp, Tc = _check_operands(W_pt, cam_ind_pt, W_cm, pts_ind_cam)
        self.operands = (W_pt, cam_ind_pt, W_cm, pts_ind_cam)
        self.geometry = g = plan(M, N, P, Tp, Tc)
        self.device = W_cm.device
        self.kernels_per_call = (int(N > 0) + int(M > 0)) * int(self.device.type == "cuda")
        if self.device.type == "cpu":
            return
        self._lib = _build.load("schur_matvec", _SIGNATURES)
        self.what = torch.empty((N, 4), dtype=torch.float32, device=self.device)
        self.out = torch.empty((M, P), dtype=torch.float32, device=self.device)
        self._args = _Args(W_pt.data_ptr(), cam_ind_pt.data_ptr(), W_cm.data_ptr(),
                           pts_ind_cam.data_ptr(), self.what.data_ptr(), M, N, P, Tp, Tc,
                           g["T"], g["G"], g["L"])
        err = self._lib.schur_wz_prepare(ctypes.byref(self._args))
        if err != 0:
            raise RuntimeError("schur_wz: kernel set-up failed: CUDA error {}".format(err))
        self._argp = ctypes.byref(self._args)
        self._out_ptr = self.out.data_ptr()
        self._dev_index = self.device.index if self.device.index is not None \
            else torch.cuda.current_device()

    def __call__(self, x):
        if self.device.type == "cpu":
            return schur_wz_plain(x, *self.operands)
        err = self._lib.schur_wz_run(self._argp, x.data_ptr(), self._out_ptr,
                                     torch.cuda.current_stream(self._dev_index).cuda_stream)
        if err != 0:
            raise RuntimeError("schur_wz kernel launch failed: CUDA error {}".format(err))
        schur_wz.launches += 1
        return self.out


def graph_edges(op, x):
    """One call of a bound CUDA operator captured into a CUDA graph of its
    own and not run: {"nodes", "edges", "programmatic"}, the last the edges
    that keep schur_cameras a dependent launch inside a graph."""
    out = (ctypes.c_int * 3)()
    err = op._lib.schur_wz_graph_edges(op._argp, x.data_ptr(), op._out_ptr, out)
    if err != 0:
        raise RuntimeError("schur_wz: graph capture failed: CUDA error {}".format(err))
    return dict(zip(("nodes", "edges", "programmatic"), out))


def schur_wz(x, W_pt, cam_ind_pt, W_cm, pts_ind_cam):
    """wz (M, P) float32: binds a SchurOperator and calls it once (CUDA
    tensors launch the kernels or raise; CPU tensors run schur_wz_plain)."""
    _check(x, W_pt, cam_ind_pt, W_cm, pts_ind_cam)
    return SchurOperator(W_pt, cam_ind_pt, W_cm, pts_ind_cam)(x)


schur_wz.launches = 0
