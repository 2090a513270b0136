"""Scale-space SIFT keypoint detection in PyTorch.

Counterpart of `sat_bundleadjust_tpu/ops/sift.py`, on its content-adaptive
two-phase path (`_pyramid_extrema`, then `_describe_buckets` for the
power-of-two bucket of valid slots of each octave). Same IPOL "Anatomy of
SIFT" parameters: delta_min 0.5, sigma_min 0.8, sigma_in 0.5, 3 scales per
octave, C_DoG 0.0133, C_edge 10, lambda_ori 1.5, lambda_descr 6, 36
orientation bins, 4x4x8 descriptors quantized to the integers 0..255.

Each step keeps the JAX package's arithmetic and its order of operations in
float32, so that on the CPU the two agree to the last bits up to the
elementary functions of the orientation and descriptor stages:
* the bilinear 2x upsampling is written out (weights 1, 0.75/0.25, 1 at the
  borders, as `jax.image.resize` normalizes them), not `F.interpolate`;
* blurs are separable slice-and-accumulate sums with edge padding, in tap
  order, not a convolution; on the card the blur of a level and the
  upsample are one launch each of a hand-written kernel
  (csrc/sift_blur.cu, `blur`, `upsample2`) that computes the plain
  version's bits, and each level is written into its slot of the octave's
  (B, S, H, W) scale space;
* the 3x3x3 extremum test is one max pool with -inf padding;
* `lax.top_k` becomes a stable descending sort of the candidates (ties go
  to the lowest index, as `lax.top_k` breaks them).

The card gives the CPU's bits: every step is elementwise IEEE arithmetic in
separate operations, which both devices round alike, or a sum whose result
does not depend on the order of its terms. So atan2, hypot, exp, sin, cos
and 2 ** x are the port's own float64 evaluations rounded to float32, a
division by a constant divides by a device tensor, the orientation
histograms and the descriptor bins are exact integer sums in float64, and
the descriptor norms are sums in a fixed order.

Output layout: (N, 132) float rows (col, row, scale, orientation, 128-dim
descriptor) in the input image's pixel coordinates.
"""

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from sat_bundleadjust_tpu_torch import resolve_device
from sat_bundleadjust_tpu_torch.ops import _build
from sat_bundleadjust_tpu_torch.utils.profiling import span

# IPOL anatomy parameters
DELTA_MIN = 0.5
SIGMA_MIN = 0.8
SIGMA_IN = 0.5
N_SPO = 3
C_EDGE = 10.0
N_BINS = 36
LAMBDA_ORI = 1.5
LAMBDA_DESCR = 6.0
N_HIST = 4
N_ORI = 8
MAX_KP_PER_OCTAVE = 4096

# integer patch radius (octave px) for orientation/descriptor accumulation
_PATCH_R = 20
_MAX_BLUR_RADIUS = 13
# keypoints described per batch: bounds the (K, (2R+1)^2, 16) temporaries
_DESCRIBE_CHUNK = 2048

_F32 = torch.float32


def _fma(a, b, c):
    """a * b + c in float32 with a single rounding, as XLA's CPU code
    contracts a multiply-add: the exact product and a TwoSum in float64,
    rounded to odd, then to float32 (round-to-odd makes the second rounding
    correct). a may be a Python float (taken as the nearest float32) or a
    tensor."""
    p = (a.double() if torch.is_tensor(a) else float(np.float32(a))) * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    bits = s.view(torch.int64)
    toward_zero = (err > 0) == (s > 0)
    trunc = torch.where(toward_zero, bits, bits - 1)
    rto = torch.where(err != 0, trunc | 1, bits)
    return rto.view(torch.float64).to(_F32)


# Cephes' single-precision exp (range reduction by n = floor(x log2(e) +
# 1/2), a degree-5 polynomial, scaling by 2^n), the approximation XLA's CPU
# code evaluates for float32 exp, with its flush of subnormal results to 0
_EXP_LO, _EXP_HI = -88.3762626647950, 88.3762626647949
_EXP_P = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
          1.6666665459e-1, 5.0000001201e-1)
_F32_TINY = 1.17549435e-38


def _exp_f32(x):
    """float32 exp with the arithmetic of the JAX package's CPU backend (the
    Gaussian taps of the scale space come from it, and a last-bit change in
    a tap moves every pixel of the pyramid). Elementwise, any device."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.floor(_fma(1.44269504088896341, x, torch.full_like(x, 0.5)))
    a = _fma(-0.693359375, n, x)
    a = _fma(2.12194440e-4, n, a)
    y = torch.full_like(x, _EXP_P[0])
    for p in _EXP_P[1:]:
        y = _fma(y, a, torch.full_like(x, p))
    y = _fma(y, a * a, a) + 1.0
    out = y * torch.exp2(n)
    return torch.where(out < _F32_TINY, torch.zeros_like(out), out)


def _div(x, c):
    """x / c for a Python number c, divided element by element on every
    device (the card's kernels multiply by the reciprocal of a host scalar
    divisor, which is not the quotient's rounding)."""
    return x / torch.tensor(c, dtype=x.dtype, device=x.device)


def _tree_sum(x):
    """The sum over the leading dim of x in a fixed pairwise order, the same
    on every device: the last half of the rows added onto the first half,
    in place, until one row is left (an odd middle row waits for the next
    round). x is a temporary of the caller's and is overwritten."""
    n = x.shape[0]
    while n > 1:
        half = n // 2
        x[:half] += x[n - half:n]
        n -= half
    return x[0]


def _fixed_point(x, bits):
    """Non-negative x (K, ...) as integers below 2 ** bits, in x's dtype:
    x * 2 ** (bits - e) rounded, e the binary exponent of the largest value
    of its row (that value < 2 ** e; e >= bits - 127, so that the scale is a
    float32 number too). Scaling by a power of two and rounding are exact.
    Sums of up to 2 ** (53 - bits) such integers are exact in float64, so
    they do not depend on the order in which the CPU or the card adds them.
    Returns (integers, e (K,) float64)."""
    _, e = torch.frexp(x.reshape(x.shape[0], -1).amax(dim=1))
    e = torch.clamp(e.double(), min=bits - 127.0)
    scale = _pow2i(bits - e).to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))
    return torch.round(x * scale), e


# The float32 elementary functions of the orientation and descriptor stages,
# evaluated in float64 with Cephes' approximations (atan.c, sin.c, exp.c:
# within 2.2e-16 of the true value on their reduced ranges) in separate
# IEEE operations, then rounded to float32: the same bits on every device
# (the libraries' atan2, sin, cos, exp and pow differ between the card and
# the CPU in the last bit), and the correctly rounded float32 value on 2e6
# seeded inputs of each.
_ATAN_P = (-8.750608600031904122785e-1, -1.615753718733365076637e1, -7.500855792314704667340e1,
           -1.228866684490136173410e2, -6.485021904942025371773e1)
_ATAN_Q = (2.485846490142306297962e1, 1.650270098316988542046e2, 4.328810604912902668951e2,
           4.853903996359136964868e2, 1.945506571482613964425e2)
_T3P8 = 2.41421356237309504880  # tan(3 pi / 8)
_MOREBITS = 6.123233995736765886130e-17  # pi / 2 - float64(pi / 2)
_SIN_P = (1.58962301576546568060e-10, -2.50507477628578072866e-8, 2.75573136213857245213e-6,
          -1.98412698295895385996e-4, 8.33333333332211858878e-3, -1.66666666666666307295e-1)
_COS_P = (-1.13585365213876817300e-11, 2.08757008419747316778e-9, -2.75573141792967388112e-7,
          2.48015872888517045348e-5, -1.38888888888730564116e-3, 4.16666666666665929218e-2)
_PIO4_PARTS = (7.85398125648498535156e-1, 3.77489470793079817668e-8, 2.69515142907905952645e-15)
_FOPI = 1.27323954473516268615  # 4 / pi


def _polevl(x, coeffs, monic=False):
    """Horner's rule, one multiply and one add a step (no fused multiply-
    add); monic: a leading coefficient 1 before coeffs."""
    y = torch.ones_like(x) if monic else torch.full_like(x, coeffs[0])
    for c in (coeffs if monic else coeffs[1:]):
        y = y * x + c
    return y


def _atan2_f32(y, x):
    """float32 atan2(y, x) (the signed-zero quadrants included), through
    Cephes' atan of |y| / |x| in float64."""
    yd, xd = y.double(), x.double()
    ay, ax = yd.abs(), xd.abs()
    zero = torch.zeros_like(ax)
    t = ay / torch.where((ay == 0) & (ax == 0), zero + 1.0, ax)  # atan2(0, 0) = 0
    big = t > _T3P8
    mid = ~big & (t > 0.66)
    u = torch.where(big, -1.0 / torch.where(big, t, zero + 1.0),
                    torch.where(mid, (t - 1.0) / (t + 1.0), t))
    z = u * u
    r = u * (z * _polevl(z, _ATAN_P) / _polevl(z, _ATAN_Q, monic=True)) + u
    r = r + torch.where(big, zero + _MOREBITS, torch.where(mid, zero + 0.5 * _MOREBITS, zero))
    r = torch.where(big, zero + np.pi / 2, torch.where(mid, zero + np.pi / 4, zero)) + r
    r = torch.where(torch.signbit(xd), np.pi - r, r)
    return torch.where(torch.signbit(yd), -r, r).to(_F32)


def _sincos_f32(theta):
    """float32 (sin, cos) of theta through Cephes' sin and cos in float64:
    |theta| reduced by the multiple of pi / 4 in three parts, then the
    octant's polynomial and sign."""
    xd = theta.double()
    ax = xd.abs()
    j = torch.floor(ax * _FOPI)
    j = torch.where(torch.fmod(j, 2.0) == 1.0, j + 1.0, j)
    z = ((ax - j * _PIO4_PARTS[0]) - j * _PIO4_PARTS[1]) - j * _PIO4_PARTS[2]
    zz = z * z
    s = z + z * (zz * _polevl(zz, _SIN_P))
    c = (1.0 - 0.5 * zz) + zz * zz * _polevl(zz, _COS_P)
    octant = torch.fmod(j, 8.0)  # 0, 2, 4 or 6
    swap = (octant == 2.0) | (octant == 6.0)
    sin_v = torch.where(swap, c, s)
    cos_v = torch.where(swap, s, c)
    sin_v = torch.where((octant >= 4.0) != torch.signbit(xd), -sin_v, sin_v)
    cos_v = torch.where((octant == 2.0) | (octant == 4.0), -cos_v, cos_v)
    return sin_v.to(_F32), cos_v.to(_F32)


_EXPD_P = (1.26177193074810590878e-4, 3.02994407707441961300e-2, 9.99999999999999999910e-1)
_EXPD_Q = (3.00198505138664455042e-6, 2.52448340349684104192e-3, 2.27265548208155028766e-1,
           2.00000000000000000009e0)
_LOG2E = 1.4426950408889634073599
_LN2 = 0.6931471805599453094172
_LN2_PARTS = (6.93145751953125e-1, 1.42860682030941723212e-6)


def _pow2i(n):
    """2 ** n for integer-valued float64 n in [-1022, 1023], from its bits."""
    return ((n.to(torch.int64) + 1023) << 52).view(torch.float64)


def _exp_via_f64(x):
    """float32 exp(x) through Cephes' exp in float64: x = n ln2 + r with
    |r| <= ln2 / 2, a rational approximation of exp(r), scaled by 2 ** n
    (x below -700 taken as -700, whose exp is 0 in float32)."""
    xd = torch.clamp(x.double(), min=-700.0)
    n = torch.floor(_LOG2E * xd + 0.5)
    r = (xd - n * _LN2_PARTS[0]) - n * _LN2_PARTS[1]
    rr = r * r
    p = r * _polevl(rr, _EXPD_P)
    return ((1.0 + 2.0 * (p / (_polevl(rr, _EXPD_Q) - p))) * _pow2i(n)).to(_F32)


def _exp2_f32(t):
    """float32 2 ** t: exp(t ln2) with the product in float64."""
    return _exp_via_f64(t.double() * _LN2)


def _hypot_f32(x, y):
    """float32 hypot(x, y): the float64 square root of the float64 sum of
    the two exact squares, rounded to float32."""
    xd, yd = x.double(), y.double()
    return torch.sqrt(xd * xd + yd * yd).to(_F32)


def _mod(x, y):
    """jnp.mod: fmod, then + y where the remainder's sign differs from y's."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _gaussian_kernel(sigma):
    """Normalized Gaussian taps (numpy, host constants)."""
    radius = max(1, int(np.ceil(4.0 * sigma)))
    x = np.arange(-radius, radius + 1)
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _pad_edge(im, r, dim):
    """Edge padding of (B, H, W) by r along dim 1 (rows) or 2 (cols)."""
    if dim == 1:
        return torch.cat([im[:, :1].expand(-1, r, -1), im, im[:, -1:].expand(-1, r, -1)], dim=1)
    return torch.cat([im[:, :, :1].expand(-1, -1, r), im, im[:, :, -1:].expand(-1, -1, r)], dim=2)


def _accumulate(taps, im_p, n, dim):
    """sum_t taps[t] * im_p shifted by t along dim, in tap order, each step
    one fused multiply-add (the contraction XLA applies to the JAX
    package's sum of weighted slices)."""
    acc = taps[0] * im_p.narrow(dim, 0, n)
    for t in range(1, len(taps)):
        acc = _fma(taps[t], im_p.narrow(dim, t, n), acc)
    return acc


def _blur_plain(im, taps):
    """Separable Gaussian blur of (B, H, W) with edge padding, along rows,
    then along columns (jax _blur, _blur_dynamic): blur's plain version,
    ~1 000 device operations a call."""
    radius = (len(taps) - 1) // 2
    _, h, w = im.shape
    im = _accumulate(taps, _pad_edge(im, radius, 1), h, 1)
    return _accumulate(taps, _pad_edge(im, radius, 2), w, 2)


def _dynamic_taps(sigma, radius):
    """Gaussian taps of the fixed-radius blur for a float32 tensor sigma,
    computed as jax _blur_dynamic computes them: XLA's float32 exp, a sum
    in index order, one division. Returns a (2 radius + 1,) tensor on
    sigma's device."""
    x = torch.arange(-radius, radius + 1, dtype=_F32, device=sigma.device)
    k = _exp_f32(-(x * x) / (2.0 * (sigma * sigma)))
    total = k[0]
    for t in range(1, 2 * radius + 1):
        total = total + k[t]
    return k / total


def _upsample_axis(im, dim):
    """Bilinear 2x along one axis with half-pixel centres: out[2k] =
    0.25 x[k-1] + 0.75 x[k], out[2k+1] = 0.75 x[k] + 0.25 x[k+1], and the
    single in-range sample (weight 1) at the two borders."""
    n = im.shape[dim]
    x = im
    if n == 1:
        return torch.cat([x, x], dim=dim)
    lo = x.narrow(dim, 0, n - 1)
    hi = x.narrow(dim, 1, n - 1)
    # the resize is a dense contraction with these weights; XLA's CPU code
    # accumulates it in index order with fused multiply-adds
    even = torch.cat([x.narrow(dim, 0, 1), _fma(0.75, hi, 0.25 * lo)], dim=dim)
    odd = torch.cat([_fma(0.25, hi, 0.75 * lo), x.narrow(dim, n - 1, 1)], dim=dim)
    out = torch.stack([even, odd], dim=dim + 1)
    shape = list(im.shape)
    shape[dim] = 2 * n
    return out.reshape(shape)


def _upsample_plain(im):
    """upsample2's plain version: columns, then rows, the order in which
    jax.image.resize's contractions run."""
    return _upsample_axis(_upsample_axis(im, 2), 1)


# csrc/sift_blur.cu: the largest radius it is built for (kMaxRadius)
BLUR_MAX_RADIUS = 16

_SIGNATURES = {
    "sift_blur": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 4
                  + [ctypes.c_void_p]),
    "sift_upsample2": (ctypes.c_int, [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p]),
}


def _check_stack(name, arg, t, device):
    """t is a (B, H, W) float32 stack on `device` whose images are each
    contiguous (row-major, any distance between them)."""
    if t.device != device:
        raise ValueError("{}: {} is on {}, the images on {}".format(name, arg, t.device, device))
    if t.dtype != _F32:
        raise ValueError("{}: {} must be float32, got {}".format(name, arg, t.dtype))
    if t.dim() != 3:
        raise ValueError("{}: {} must be (B, H, W), got {}".format(name, arg, tuple(t.shape)))
    _, h, w = t.shape
    if (w > 1 and t.stride(2) != 1) or (h > 1 and t.stride(1) != w):
        raise ValueError("{}: each image of {} must be contiguous".format(name, arg))


def _shares_memory(a, b):
    """Whether an image of the stack a and one of the same-shape stack b
    share memory (their images sorted by address: an overlap shows between
    neighbours, all images being of one size)."""
    n = 4 * a.shape[1] * a.shape[2]
    starts = sorted((t.data_ptr() + 4 * i * t.stride(0), k)
                    for k, t in enumerate((a, b)) for i in range(t.shape[0]))
    return any(k0 != k1 and s1 < s0 + n for (s0, k0), (s1, k1) in zip(starts, starts[1:]))


def _launch(fn, dev, *args):
    """Call the C entry point `fn` with `args` and dev's current stream;
    raise on the CUDA error it returns."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(_build.load("sift_blur", _SIGNATURES), fn)(*args, stream)
    if err != 0:
        raise RuntimeError("{} kernel launch failed: CUDA error {}".format(fn, err))


def blur(im, taps, out=None):
    """Separable Gaussian blur of a (B, H, W) float32 stack with edge
    padding: along rows, then along columns, each pass a chain of fused
    multiply-adds in tap order (jax _blur, _blur_dynamic).

    taps: (2 r + 1,) float32 on im's device, r <= BLUR_MAX_RADIUS. out: the
    (B, H, W) float32 stack to write (a slot of a scale space: each image
    contiguous), which may not overlap im; by default a new one. CPU
    tensors take the plain version (_blur_plain); CUDA tensors launch
    csrc/sift_blur.cu once or raise, and each launch adds one to
    blur.launches. Returns out."""
    dev = im.device
    _check_stack("blur", "im", im, dev)
    if out is None:
        out = torch.empty_like(im, memory_format=torch.contiguous_format)
    _check_stack("blur", "out", out, dev)
    if out.shape != im.shape:
        raise ValueError("blur: out has shape {}, im {}".format(tuple(out.shape),
                                                                tuple(im.shape)))
    if taps.device != dev or taps.dtype != _F32 or taps.dim() != 1 or not taps.is_contiguous():
        raise ValueError("blur: taps must be a contiguous 1-D float32 tensor on {}".format(dev))
    radius = (taps.shape[0] - 1) // 2
    if taps.shape[0] % 2 == 0 or not 1 <= radius <= BLUR_MAX_RADIUS:
        raise ValueError("blur: {} taps; the kernel takes 2 r + 1 for r in 1..{}".format(
            taps.shape[0], BLUR_MAX_RADIUS))
    if im.numel() and _shares_memory(im, out):
        raise ValueError("blur: out overlaps im")
    if dev.type == "cpu":
        return out.copy_(_blur_plain(im, taps))
    if dev.type != "cuda":
        raise ValueError("blur: unsupported device {}".format(dev))
    B, H, W = im.shape
    if im.numel():
        _launch("sift_blur", dev, im.data_ptr(), im.stride(0), out.data_ptr(), out.stride(0),
                taps.data_ptr(), radius, B, H, W)
        blur.launches += 1
    return out


def upsample2(im):
    """Bilinear 2x upsampling of a contiguous (B, H, W) float32 stack to
    (B, 2H, 2W), delta_min = 0.5: jax.image.resize's weights, columns, then
    rows. CPU tensors take the plain version (_upsample_plain); CUDA
    tensors launch csrc/sift_blur.cu once or raise, and each launch adds
    one to upsample2.launches."""
    dev = im.device
    _check_stack("upsample2", "im", im, dev)
    if not im.is_contiguous():
        raise ValueError("upsample2: im must be contiguous")
    if dev.type == "cpu":
        return _upsample_plain(im)
    if dev.type != "cuda":
        raise ValueError("upsample2: unsupported device {}".format(dev))
    B, H, W = im.shape
    out = torch.empty((B, 2 * H, 2 * W), dtype=_F32, device=dev)
    if im.numel():
        _launch("sift_upsample2", dev, im.data_ptr(), out.data_ptr(), B, H, W)
        upsample2.launches += 1
    return out


blur.launches = 0
upsample2.launches = 0


def _blur(im, sigma, out=None):
    """blur with the host taps of _gaussian_kernel(sigma) (jax _blur),
    uploaded once a call."""
    return blur(im, torch.as_tensor(_gaussian_kernel(sigma), device=im.device), out)


def _inv3x3(V):
    """Batched closed-form 3x3 inverse (jax ops/lm._inv3x3)."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 0], V[..., 1, 1], V[..., 1, 2]
    g, h, i = V[..., 2, 0], V[..., 2, 1], V[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F_ = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(det.abs() < 1e-30, torch.ones_like(det), det)
    inv = torch.stack([torch.stack([A, B, C], -1), torch.stack([D, E, F_], -1),
                       torch.stack([G, H, I], -1)], -2)
    return inv / det[..., None, None]


def _top_k_desc(flat, k):
    """lax.top_k(flat, k) for a non-negative 1-D response: the positive
    entries in descending order, ties by lowest index, then zero entries
    (whose slots are invalid, so any in-range index serves)."""
    pos = torch.nonzero(flat > 0, as_tuple=True)[0]
    vals = flat[pos]
    order = torch.sort(vals, descending=True, stable=True).indices
    pos, vals = pos[order][:k], vals[order][:k]
    if pos.numel() < k:
        pad = k - pos.numel()
        pos = torch.cat([pos, torch.zeros(pad, dtype=pos.dtype, device=flat.device)])
        vals = torch.cat([vals, torch.zeros(pad, dtype=vals.dtype, device=flat.device)])
    return vals, pos


def _extrema_and_refine(dog, thresh_dog, max_kp):
    """Find and refine the 3-D DoG extrema of one octave of one image.

    dog (S, H, W), S = n_spo + 2; thresh_dog a 0-d f32 tensor. Returns a
    dict of (max_kp,) tensors x, y (octave px), s (DoG level coordinate),
    value, valid."""
    S, H, W = dog.shape
    inner = dog[1:-1]
    nb_max = F.max_pool3d(dog[None, None], 3, stride=1, padding=(0, 1, 1))[0, 0]
    nb_min = -F.max_pool3d(-dog[None, None], 3, stride=1, padding=(0, 1, 1))[0, 0]
    is_max = (inner >= nb_max) & (inner > 0.8 * thresh_dog)
    is_min = (inner <= nb_min) & (inner < -0.8 * thresh_dog)
    is_ext = is_max | is_min
    border = torch.zeros((H, W), dtype=torch.bool, device=dog.device)
    border[1:-1, 1:-1] = True
    is_ext = is_ext & border[None]

    resp = torch.where(is_ext, inner.abs(), torch.zeros_like(inner))
    flat = resp.reshape(-1)
    k = min(max_kp, flat.shape[0])
    vals, idx = _top_k_desc(flat, k)
    valid = vals > 0.0
    s_idx = idx // (H * W)
    rem = idx % (H * W)
    yy = rem // W
    xx = rem % W
    # padded (invalid) slots sit at the interior pixel (1, 1)
    yy = torch.where(valid, yy, torch.ones_like(yy))
    xx = torch.where(valid, xx, torch.ones_like(xx))

    def at(ds, dy, dx):
        return dog[s_idx + 1 + ds, yy + dy, xx + dx]

    v = at(0, 0, 0)
    gx = 0.5 * (at(0, 0, 1) - at(0, 0, -1))
    gy = 0.5 * (at(0, 1, 0) - at(0, -1, 0))
    gs = 0.5 * (at(1, 0, 0) - at(-1, 0, 0))
    hxx = at(0, 0, 1) + at(0, 0, -1) - 2 * v
    hyy = at(0, 1, 0) + at(0, -1, 0) - 2 * v
    hss = at(1, 0, 0) + at(-1, 0, 0) - 2 * v
    hxy = 0.25 * (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1))
    hxs = 0.25 * (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1))
    hys = 0.25 * (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0))

    Hm = torch.stack([torch.stack([hxx, hxy, hxs], -1), torch.stack([hxy, hyy, hys], -1),
                      torch.stack([hxs, hys, hss], -1)], -2)
    g = torch.stack([gx, gy, gs], -1)
    det = (
        Hm[:, 0, 0] * (Hm[:, 1, 1] * Hm[:, 2, 2] - Hm[:, 1, 2] * Hm[:, 2, 1])
        - Hm[:, 0, 1] * (Hm[:, 1, 0] * Hm[:, 2, 2] - Hm[:, 1, 2] * Hm[:, 2, 0])
        + Hm[:, 0, 2] * (Hm[:, 1, 0] * Hm[:, 2, 1] - Hm[:, 1, 1] * Hm[:, 2, 0])
    )
    eye = torch.eye(3, dtype=Hm.dtype, device=Hm.device)
    Hm_safe = torch.where(det.abs()[:, None, None] < 1e-12, eye, Hm)
    inv = _inv3x3(Hm_safe)
    off = -((inv[:, :, 0] * g[:, None, 0] + inv[:, :, 1] * g[:, None, 1]) + inv[:, :, 2] * g[:, None, 2])
    off = torch.clamp(off, -1.5, 1.5)
    refined_ok = off.abs().max(dim=-1).values < 1.5

    v_hat = v + 0.5 * ((g[:, 0] * off[:, 0] + g[:, 1] * off[:, 1]) + g[:, 2] * off[:, 2])
    contrast_ok = v_hat.abs() > thresh_dog

    tr = hxx + hyy
    det2 = hxx * hyy - hxy * hxy
    safe = torch.where(det2 == 0, torch.full_like(det2, 1e-30), det2)
    edge_ok = (det2 > 0) & (tr * tr / safe < (C_EDGE + 1) ** 2 / C_EDGE)

    valid = valid & refined_ok & contrast_ok & edge_ok
    return {
        "x": xx.to(_F32) + off[:, 0],
        "y": yy.to(_F32) + off[:, 1],
        "s": s_idx.to(_F32) + 1.0 + off[:, 2],
        "value": v_hat,
        "valid": valid,
    }


def _orientation(mag, ang, dx, dy, sigma):
    """Principal and secondary orientations of K keypoints: mag/ang (K, P2,
    P2), dx/dy (K, P2), sigma (K,). Returns theta1, theta2, valid2."""
    K = mag.shape[0]
    d2 = dx[:, None, :] * dx[:, None, :] + dy[:, :, None] * dy[:, :, None]
    win_sigma = LAMBDA_ORI * sigma
    ws2 = (win_sigma * win_sigma)[:, None, None]
    w = _exp_via_f64(-d2 / (2 * ws2)) * (d2 <= ((3 * win_sigma) * (3 * win_sigma))[:, None, None])
    wm = (w * mag).reshape(K, -1)
    fbin = _div(ang.reshape(K, -1) + np.pi, 2 * np.pi) * N_BINS
    bins = _mod(torch.floor(fbin), torch.tensor(float(N_BINS), dtype=_F32, device=mag.device))
    # each sample's weight into its bin, as 42-bit integers: 1681 of them
    # sum exactly, in any order (the scatter's order on the card is not
    # fixed)
    wq, e = _fixed_point(wm, 42)
    hist = torch.zeros((K, N_BINS), dtype=torch.float64, device=mag.device)
    hist = hist.scatter_add_(1, bins.to(torch.int64), wq.double())
    hist = (hist * _pow2i(e - 42)[:, None]).to(_F32)
    for _ in range(6):
        hist = _div(torch.roll(hist, 1, 1) + hist + torch.roll(hist, -1, 1), 3.0)

    rows = torch.arange(K, device=mag.device)

    def peak_theta(b):
        hm = hist[rows, (b - 1) % N_BINS]
        h0 = hist[rows, b]
        hp = hist[rows, (b + 1) % N_BINS]
        denom = hm - 2 * h0 + hp
        delta = torch.where(denom.abs() < 1e-12, torch.zeros_like(denom), 0.5 * (hm - hp) / denom)
        return (b.to(_F32) + delta + 0.5) * (2 * np.pi / N_BINS) - np.pi

    b1 = torch.argmax(hist, dim=1)
    theta1 = peak_theta(b1)
    ids = torch.arange(N_BINS, device=mag.device)[None, :]
    circ_d = torch.minimum((ids - b1[:, None]).abs(), N_BINS - (ids - b1[:, None]).abs())
    is_local_max = (hist >= torch.roll(hist, 1, 1)) & (hist >= torch.roll(hist, -1, 1))
    cand = torch.where((circ_d > 1) & is_local_max, hist, torch.full_like(hist, -1.0))
    b2 = torch.argmax(cand, dim=1)
    theta2 = peak_theta(b2)
    valid2 = cand[rows, b2] >= 0.8 * hist[rows, b1]
    return theta1, theta2, valid2


def _descriptor(mag2d, ang2d, dx, dy, sigma, theta):
    """4x4x8 descriptors of K keypoints (K, 128), quantized to 0..255."""
    K = mag2d.shape[0]
    radius = LAMBDA_DESCR * sigma * (N_HIST + 1.0) / N_HIST
    st, ct = _sincos_f32(theta)
    ox = dx[:, None, :] + torch.zeros_like(dy)[:, :, None]
    oy = dy[:, :, None] + torch.zeros_like(dx)[:, None, :]
    ct3, st3, r3 = ct[:, None, None], st[:, None, None], radius[:, None, None]
    us = ((ct3 * ox + st3 * oy) / r3).reshape(K, -1)
    vs = ((-st3 * ox + ct3 * oy) / r3).reshape(K, -1)
    mag = mag2d.reshape(K, -1)
    ang = ang2d.reshape(K, -1) - theta[:, None]
    ratio2 = ((N_HIST + 1.0) / N_HIST) ** 2
    w = _exp_via_f64(-(us * us + vs * vs) * ratio2 / 2.0)
    hx = (us + 1.0) / 2.0 * N_HIST - 0.5
    hy = (vs + 1.0) / 2.0 * N_HIST - 0.5
    ho = _mod(_div(ang, 2 * np.pi) * N_ORI,
              torch.tensor(float(N_ORI), dtype=_F32, device=mag.device))
    m = w * mag
    # the trilinear weights 1 - |h - bin| (circular in the orientation) are
    # non-zero at the two bins around h only: those two per axis
    x0, y0 = torch.floor(hx), torch.floor(hy)
    o0 = torch.floor(ho)
    o0 = torch.where(o0 == N_ORI, torch.zeros_like(o0), o0)  # ho rounded up to 8
    xs = torch.stack([x0, x0 + 1.0], dim=-1)  # (K, S, 2)
    ys = torch.stack([y0, y0 + 1.0], dim=-1)
    os_ = torch.stack([o0, torch.where(o0 == N_ORI - 1, torch.zeros_like(o0), o0 + 1.0)], dim=-1)
    wx = torch.clamp_min(1.0 - (hx[..., None] - xs).abs(), 0.0) * ((xs >= 0) & (xs < N_HIST))
    wy = torch.clamp_min(1.0 - (hy[..., None] - ys).abs(), 0.0) * ((ys >= 0) & (ys < N_HIST))
    do_ = (ho[..., None] - os_).abs()
    wo = torch.clamp_min(1.0 - torch.minimum(do_, N_ORI - do_), 0.0)
    lhs = m[..., None, None] * (wy[..., :, None] * wx[..., None, :])  # (K, S, 2, 2)
    # each sample's 8 terms lhs * wo (exact in float64) as 42-bit integers of
    # its keypoint's largest term, summed into their (y, x, o) bins: 1681 of
    # them sum exactly, in any order (the scatter's order on the card is not
    # fixed)
    terms = (lhs.double()[..., None] * wo.double()[..., None, None, :]).reshape(K, -1, 8)
    tq, e = _fixed_point(terms, 42)
    idx = ((torch.clamp(ys, 0, N_HIST - 1)[..., :, None, None] * N_HIST
            + torch.clamp(xs, 0, N_HIST - 1)[..., None, :, None]) * N_ORI
           + os_[..., None, None, :]).reshape(K, -1).to(torch.int64)
    acc = torch.zeros((K, N_HIST * N_HIST * N_ORI), dtype=torch.float64, device=mag.device)
    acc = acc.scatter_add_(1, idx, tq.reshape(K, -1))
    d = (acc * _pow2i(e - 42)[:, None]).to(_F32)
    norm = torch.sqrt(_tree_sum((d * d).t().contiguous()))[:, None] + 1e-12
    d = torch.clamp_max(d / norm, 0.2)
    norm2 = torch.sqrt(_tree_sum((d * d).t().contiguous()))[:, None] + 1e-12
    return torch.clamp_max(torch.floor(512.0 * d / norm2), 255.0)


def _gradients(ss, kp_x, kp_y, kp_level):
    """Gradient magnitudes and angles over one contiguous (2R+3)^2 patch
    per keypoint, and the patch grid's offsets from the keypoint.

    ss (S, H, W) scale space of one image's octave. Returns mag, ang
    (K, P-2, P-2), dx, dy (K, P-2)."""
    S_lv, H_im, W_im = ss.shape
    flat = ss.reshape(S_lv * H_im, W_im)
    P = min(2 * _PATCH_R + 3, H_im, W_im)
    xc = torch.round(kp_x).to(torch.int64)
    yc = torch.round(kp_y).to(torch.int64)
    x0 = torch.clamp(xc - _PATCH_R - 1, 0, W_im - P)
    y0 = torch.clamp(yc - _PATCH_R - 1, 0, H_im - P)
    rows = kp_level.to(torch.int64) * H_im + y0
    ar = torch.arange(P, device=ss.device)
    patches = flat[(rows[:, None] + ar)[:, :, None], (x0[:, None] + ar)[:, None, :]]  # (K, P, P)
    gx = 0.5 * (patches[:, 1:-1, 2:] - patches[:, 1:-1, :-2])
    gy = 0.5 * (patches[:, 2:, 1:-1] - patches[:, :-2, 1:-1])
    mag = _hypot_f32(gx, gy)
    ang = _atan2_f32(gy, gx)
    grid = torch.arange(P - 2, dtype=_F32, device=ss.device)
    dx = (x0.to(_F32)[:, None] + 1.0 + grid[None]) - kp_x[:, None]
    dy = (y0.to(_F32)[:, None] + 1.0 + grid[None]) - kp_y[:, None]
    return mag, ang, dx, dy


def _orientation_and_descriptor(ss, kp_x, kp_y, kp_sigma_oct, kp_level):
    """Per-keypoint orientations and descriptors (jax
    _orientation_and_descriptor). Returns thetas, descs, thetas2, descs2,
    valid2."""
    mag, ang, dx, dy = _gradients(ss, kp_x, kp_y, kp_level)
    theta1, theta2, valid2 = _orientation(mag, ang, dx, dy, kp_sigma_oct)
    desc1 = _descriptor(mag, ang, dx, dy, kp_sigma_oct, theta1)
    desc2 = _descriptor(mag, ang, dx, dy, kp_sigma_oct, theta2)
    return theta1, desc1, theta2, desc2, valid2


def _sigma_oct(s, n_scales):
    """A keypoint's blur in octave pixels from its DoG level coordinate s."""
    return SIGMA_MIN / DELTA_MIN * _exp2_f32(_div(s, n_scales))


def _sig_inc(n_scales):
    sig_abs = np.array([SIGMA_MIN / DELTA_MIN * 2 ** (s / n_scales) for s in range(n_scales + 3)])
    return np.sqrt(np.maximum(sig_abs[1:] ** 2 - sig_abs[:-1] ** 2, 0.0)).astype(np.float32)


def _octave_slots(h, w, n_octaves, max_kp_per_octave):
    """Per-octave keypoint slot capacities (octave-0 shape 2h x 2w)."""
    H, W = 2 * h, 2 * w
    slots = []
    for _o in range(n_octaves):
        if H < 12 or W < 12:
            break
        slots.append(int(min(max_kp_per_octave, max(192, (H * W) // 128))))
        H, W = (H + 1) // 2, (W + 1) // 2
    return slots


def _pyramid_extrema(im, thresh_dog, n_octaves, n_scales, max_kp_per_octave):
    """Phase A: pyramid, DoG extrema and refinement for a (B, H, W) stack.
    Returns [(ss (B, S, H, W), [kp dict per image])] per octave and the
    (B, n_oct) valid counts."""
    sigma_extra = float(np.sqrt(max(SIGMA_MIN ** 2 - SIGMA_IN ** 2, 0.0)) / DELTA_MIN)
    sig_inc = torch.as_tensor(_sig_inc(n_scales), device=im.device)
    taps = [_dynamic_taps(sig_inc[s], _MAX_BLUR_RADIUS) for s in range(n_scales + 2)]
    up = upsample2(im)
    B, S = up.shape[0], n_scales + 3
    ss = up.new_empty((B, S, *up.shape[1:]))  # the octave's scale space, level by level
    _blur(up, sigma_extra, out=ss[:, 0])
    del up
    octs, counts = [], []
    for _o in range(n_octaves):
        H, W = ss.shape[2:]
        if H < 12 or W < 12:
            break
        slots = int(min(max_kp_per_octave, max(192, (H * W) // 128)))
        for s in range(n_scales + 2):
            blur(ss[:, s], taps[s], out=ss[:, s + 1])
        dog = ss[:, 1:] - ss[:, :-1]
        kps = [_extrema_and_refine(dog[b], thresh_dog, slots) for b in range(B)]
        del dog
        octs.append((ss, kps))
        counts.append(torch.stack([kp["valid"].sum() for kp in kps]))
        first = ss[:, n_scales, ::2, ::2]
        ss = first.new_empty((B, S, *first.shape[1:]))
        ss[:, 0] = first
    return octs, torch.stack(counts, dim=1)


def _describe_buckets(octs, buckets, n_scales, fetch_k=None):
    """Phase B: orientations and descriptors of the first `bucket` valid
    slots of each octave, packed per image into (geometry (S, 4), integer
    descriptors (S, 128), valid (S,))."""
    B = octs[0][0].shape[0]
    out = []
    for b in range(B):
        geom_parts, desc_parts, valid_parts = [], [], []
        delta = DELTA_MIN
        for (ss, kps), bucket in zip(octs, buckets):
            if bucket > 0:
                kp = kps[b]
                slots = kp["x"].shape[0]
                if bucket < slots:
                    # slots are response-ordered: keep the first `bucket`
                    # valid ones in that order (invalid slots sort last)
                    score = torch.where(
                        kp["valid"], torch.arange(slots, 0, -1, device=ss.device),
                        torch.zeros(slots, dtype=torch.int64, device=ss.device))
                    sel = torch.sort(score, descending=True, stable=True).indices[:bucket]
                    kp = {k: v[sel] for k, v in kp.items()}
                sigma_oct = _sigma_oct(kp["s"], n_scales)
                level = torch.clamp(torch.round(kp["s"]).to(torch.int64), 0, n_scales + 2)
                parts = [[], [], [], [], []]
                for c0 in range(0, kp["x"].shape[0], _DESCRIBE_CHUNK):
                    sl = slice(c0, c0 + _DESCRIBE_CHUNK)
                    res = _orientation_and_descriptor(
                        ss[b], kp["x"][sl], kp["y"][sl], sigma_oct[sl], level[sl])
                    for acc, r in zip(parts, res):
                        acc.append(r)
                th, de, th2, de2, v2 = [torch.cat(p) for p in parts]
                v2 = v2 & kp["valid"]
                abs_sigma = delta / DELTA_MIN * SIGMA_MIN * _exp2_f32(_div(kp["s"], n_scales))
                col, row = kp["x"] * delta, kp["y"] * delta
                for theta, desc, vv in ((th, de, kp["valid"]), (th2, de2, v2)):
                    geom_parts.append(torch.stack([col, row, abs_sigma, theta], dim=1))
                    desc_parts.append(desc)
                    valid_parts.append(vv)
            delta *= 2.0
        geom = torch.cat(geom_parts, 0)
        desc = torch.cat(desc_parts, 0)
        valid = torch.cat(valid_parts, 0)
        if fetch_k is not None and fetch_k < geom.shape[0]:
            score = torch.where(valid, geom[:, 2], torch.full_like(geom[:, 2], -1.0))
            sel = torch.sort(score, descending=True, stable=True).indices[:fetch_k]
            geom, desc, valid = geom[sel], desc[sel], valid[sel]
        out.append((geom, desc, valid))
    return out


def _next_bucket(count, slots):
    """Power-of-two bucket of a valid count (floor 64, capped at slots)."""
    if count <= 0:
        return 0
    b = 64
    while b < count:
        b *= 2
    return min(b, slots)


# images per batch on the CPU (the JAX package's bound for 4-core hosts)
BATCH_CHUNK = 4
_CHUNK_PX = 4 * 300 * 400
# device bytes of phase A per input pixel: the 2x-upsampled first octave
# holds 6 scale-space levels, 5 DoG levels and their pooled extremes, in f32
_BYTES_PER_PX = 4 * 4 * 24


def _auto_chunk(h, w, dev):
    """Images per batch: the JAX package's CPU rule on the CPU; on the card,
    as many as a third of the free device memory holds (at most 16)."""
    if dev.type == "cpu":
        return max(1, min(BATCH_CHUNK, _CHUNK_PX // max(h * w, 1)))
    free, _ = torch.cuda.mem_get_info(dev)
    return max(1, min(16, int(free // 3 // max(_BYTES_PER_PX * h * w, 1))))


def _normalized_stack(images, dev):
    """Same-shape grayscale images, each scaled to [0, 1], as one (B, H, W)
    float32 tensor on dev."""
    ims = []
    for image in images:
        image = np.asarray(image, dtype=np.float32)
        lo, hi = np.min(image), np.max(image)
        ims.append((image - lo) / max(hi - lo, 1e-12))
    return torch.as_tensor(np.stack(ims), device=dev)


def detect_sift(image, thresh_dog=0.0133, n_octaves=8, n_scales=3, max_kp=None,
                max_kp_per_octave=MAX_KP_PER_OCTAVE, device=None):
    """Full SIFT detection on one grayscale image; (N, 132) numpy array."""
    return detect_sift_batch(
        [image], thresh_dog=thresh_dog, n_octaves=n_octaves, n_scales=n_scales,
        max_kp=max_kp, max_kp_per_octave=max_kp_per_octave, device=device,
    )[0]


def detect_sift_batch(images, thresh_dog=0.0133, n_octaves=8, n_scales=3,
                      max_kp=None, max_kp_per_octave=MAX_KP_PER_OCTAVE,
                      batch_chunk=None, device=None):
    """SIFT detection over a list of same-shape grayscale images, on
    `device` (default: the card). Returns a list of (N_i, 132) numpy
    arrays (float32 rows; descriptors are the integers 0..255)."""
    dev = resolve_device(device)
    if batch_chunk is None:
        h0, w0 = np.asarray(images[0]).shape[:2]
        chunk = _auto_chunk(int(h0), int(w0), dev)
    else:
        chunk = batch_chunk
    if len(images) > chunk:
        out = []
        for s in range(0, len(images), chunk):
            out.extend(detect_sift_batch(
                images[s: s + chunk], thresh_dog=thresh_dog, n_octaves=n_octaves,
                n_scales=n_scales, max_kp=max_kp, max_kp_per_octave=max_kp_per_octave,
                batch_chunk=chunk, device=dev,
            ))
        return out
    with span("sift.batch", frames=len(images)):
        return _detect_batch(images, thresh_dog, n_octaves, n_scales, max_kp, max_kp_per_octave,
                             dev)


def _detect_batch(images, thresh_dog, n_octaves, n_scales, max_kp, max_kp_per_octave, dev):
    """detect_sift_batch on one batch that the device holds at once."""
    with span("sift.upload"):
        im = _normalized_stack(images, dev)

    with torch.no_grad():
        # blur_launches: the scale space's kernel launches (blurs and upsample)
        with span("sift.pyramid") as pyramid:
            launched = blur.launches + upsample2.launches
            thresh = torch.tensor(thresh_dog, dtype=_F32, device=dev)
            octs, counts = _pyramid_extrema(im, thresh, n_octaves, n_scales, max_kp_per_octave)
            counts = counts.max(dim=0).values.cpu().numpy()  # the one host sync between phases
            pyramid.attrs["blur_launches"] = blur.launches + upsample2.launches - launched
        h0, w0 = int(im.shape[1]), int(im.shape[2])
        slots = _octave_slots(h0, w0, n_octaves, max_kp_per_octave)
        buckets = tuple(_next_bucket(int(c), s) for c, s in zip(counts, slots))
        if sum(buckets) == 0:
            return [np.zeros((0, 132)) for _ in images]
        fetch_k = None
        if max_kp is not None and max_kp < 2 * sum(buckets):
            fetch_k = int(max_kp)
        with span("sift.describe"):
            packed = _describe_buckets(octs, buckets, n_scales, fetch_k=fetch_k)
    out = []
    with span("sift.to_host"):
        for geom, desc, valid in packed:
            v = valid.cpu().numpy()
            feats = np.concatenate([geom.cpu().numpy()[v],
                                    desc.to(torch.uint8).cpu().numpy()[v].astype(np.float32)],
                                   axis=1)
            if feats.shape[0] == 0:
                out.append(np.zeros((0, 132)))
                continue
            if max_kp is not None and feats.shape[0] > max_kp:
                feats = feats[np.argsort(-feats[:, 2], kind="stable")[:max_kp]]
            out.append(feats)
    return out
