"""Parity of the port's 2-NN matching, its wrappers and RANSAC with the JAX
package (tests/test_pallas_match.py and tests/test_sift_match.py are the JAX
side's own tests of the same functions).

The JAX Pallas kernels run in interpret mode on the CPU, as the JAX
package's tests run them. The port's wrappers take their plain PyTorch
versions here, because the tensors lie on the CPU; the CUDA kernels are
held against those plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerances: none for the 2-NN. On integer descriptors every value after
the cross term is an integer below 2^24, exact in float32, and the gate is
evaluated elementwise in the kernels' order, so the port must give the same
bits as JAX (Queue 2 of ROADMAP.md).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sat_bundleadjust_tpu.ops import match as jmatch
from sat_bundleadjust_tpu.ops import ransac as jransac
from sat_bundleadjust_tpu.ops.pallas_match import (
    pallas_2nn, pallas_2nn_batched, pallas_2nn_batched_i8,
)
from sat_bundleadjust_tpu.parallel.feature_shard import packed_2nn_lax

from sat_bundleadjust_tpu_torch.ops import match as tmatch
from sat_bundleadjust_tpu_torch.ops import nn2_match as nm
from sat_bundleadjust_tpu_torch.ops import ransac as transac

torch.set_num_threads(1)


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


def _integer_problem(seed=4, B=3, n1=300, n2=700):
    """Integer descriptors 0..255 with exact correspondences, exact ties
    (duplicated columns), invalid rows and columns, a pair with no valid
    column, and per-pair gates: off (1e9), 8 px, 20 px."""
    rng = np.random.RandomState(seed)
    d_i = rng.randint(0, 256, (B, n1, 128)).astype(np.float32)
    d_j = rng.randint(0, 256, (B, n2, 128)).astype(np.float32)
    d_j[:, :60] = d_i[:, :60]
    d_j[:, 100:110] = d_j[:, 90:100]  # ties between two columns
    d_i[:, 200:205] = d_j[:, 90:95]  # rows whose nearest columns tie
    li = np.concatenate([rng.randn(B, n1, 2), -300.0 * rng.rand(B, n1, 1)], 2).astype(np.float32)
    hj = np.concatenate([rng.rand(B, n2, 2) * 400, np.ones((B, n2, 1))], 2).astype(np.float32)
    vi = np.ones((B, n1), np.float32)
    vj = np.ones((B, n2), np.float32)
    vi[:, -5:] = 0.0
    vj[0] = rng.rand(n2) > 0.2
    vj[2] = 0.0  # nothing valid in pair 2
    thr = np.array([1e9, 8.0, 20.0], np.float32)
    return d_i, d_j, li, hj, vi, vj, thr


@pytest.fixture(scope="module")
def integer_problem():
    return _integer_problem()


@pytest.fixture(scope="module")
def jax_i8_packed(integer_problem):
    d_i, d_j, li, hj, vi, vj, thr = integer_problem
    return np.asarray(pallas_2nn_batched_i8(
        jnp.asarray((d_i - 128).astype(np.int8)), jnp.asarray((d_j - 128).astype(np.int8)),
        jnp.asarray(li), jnp.asarray(hj), jnp.asarray(vi), jnp.asarray(vj), jnp.asarray(thr),
        interpret=True))


@pytest.mark.parametrize("reference", ["pallas_2nn_batched_i8", "pallas_2nn_batched",
                                       "packed_2nn_lax"])
@pytest.mark.parametrize("entry", ["nn2_batched_i8", "nn2_batched"])
def test_2nn_bit_identical_to_jax(integer_problem, jax_i8_packed, reference, entry):
    """Both batched entry points against each JAX matcher: the int8 and f32
    Pallas kernels in interpret mode and the lax twin of the mesh path.
    Bit-identical, gate on and off, with ties and with a pair that has no
    valid column."""
    d_i, d_j, li, hj, vi, vj, thr = integer_problem
    jops = [jnp.asarray(a) for a in (li, hj, vi, vj, thr)]
    if reference == "pallas_2nn_batched_i8":
        want = jax_i8_packed
    elif reference == "pallas_2nn_batched":
        want = np.asarray(pallas_2nn_batched(jnp.asarray(d_i), jnp.asarray(d_j), *jops,
                                             interpret=True))
    else:
        want = np.asarray(packed_2nn_lax(jnp.asarray(d_i), jnp.asarray(d_j), *jops))
    tops = [_t(a) for a in (li, hj, vi, vj, thr)]
    if entry == "nn2_batched_i8":
        got = nm.nn2_batched_i8(_t((d_i - 128).astype(np.int8)), _t((d_j - 128).astype(np.int8)),
                                *tops)
    else:
        got = nm.nn2_batched(_t(d_i), _t(d_j), *tops)
    got = got.numpy()
    assert got.shape == want.shape == (3, 3, d_i.shape[1])
    np.testing.assert_array_equal(got, want)
    # the problem exercises what it claims to
    assert (want[:, 0] == want[:, 1]).sum() > 0  # ties: d2 == d1
    assert np.all(want[2, 0] == nm.BIG) and np.all(want[2, 2] == 0)  # nothing valid


@pytest.mark.parametrize("b", [0, 1, 2])
def test_single_pair_bit_identical_to_jax(integer_problem, jax_i8_packed, b):
    """nn2_single (the f32 entry point with B = 1 and a scalar threshold)
    against JAX pallas_2nn in interpret mode, and against the batched
    result's row b: bit-identical."""
    d_i, d_j, li, hj, vi, vj, thr = integer_problem
    jd1, jd2, jidx = pallas_2nn(jnp.asarray(d_i[b]), jnp.asarray(d_j[b]), jnp.asarray(li[b]),
                                jnp.asarray(hj[b]), jnp.asarray(vi[b]), jnp.asarray(vj[b]),
                                float(thr[b]), interpret=True)
    d1, d2, idx = nm.nn2_single(_t(d_i[b]), _t(d_j[b]), _t(li[b]), _t(hj[b]), _t(vi[b]),
                                _t(vj[b]), float(thr[b]))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(d1.numpy(), np.asarray(jd1))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(jd2))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(
        np.stack([d1.numpy(), d2.numpy(), idx.numpy().astype(np.float32)]), jax_i8_packed[b])


def _column_scan(packed_in):
    """The CUDA kernel's algorithm, step for step in numpy: each row scans
    its columns in increasing order; a strictly smaller d moves (d1, idx) to
    (d, j) and d1 to d2, any other d lowers d2 to min(d2, d)."""
    d, = packed_in
    n1, n2 = d.shape
    out = np.empty((3, n1), np.float32)
    for i in range(n1):
        d1 = d2 = np.float32(nm.BIG)
        idx = 0
        for j in range(n2):
            if d[i, j] < d1:
                d1, d2, idx = d[i, j], d1, j
            elif d[i, j] < d2:
                d2 = d[i, j]
        out[:, i] = d1, d2, idx
    return out


def test_column_scan_tie_rule_equals_tile_merge():
    """The kernel scans columns in order with a strict '<'; the TPU kernel
    takes a per-tile argmin (lowest column of the minimum) and merges tiles
    keeping the earlier tile on equality. Descriptors drawn from {0, 1} make
    ties the rule: the scan must equal the plain version (the reference the
    kernel is held against) and JAX's tiled kernel bit for bit, including
    rows with nothing valid."""
    rng = np.random.RandomState(11)
    n1, n2 = 40, 1100  # three 512-column tiles of the TPU kernel
    d_i = rng.randint(0, 2, (1, n1, 128)).astype(np.float32)
    d_j = rng.randint(0, 2, (1, n2, 128)).astype(np.float32)
    d_j[0, 600:1100] = d_j[0, 0:500]  # equal minima in different tiles
    li = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (1, n1, 1))
    hj = np.concatenate([rng.rand(1, n2, 2) * 400, np.ones((1, n2, 1))], 2).astype(np.float32)
    vi = np.ones((1, n1), np.float32)
    vi[0, :3] = 0.0
    vj = (rng.rand(1, n2) > 0.1).astype(np.float32)
    thr = np.array([1e9], np.float32)
    plain = nm.nn2_plain(_t((d_i - 128).astype(np.int8)), _t((d_j - 128).astype(np.int8)),
                         _t(li), _t(hj), _t(vi), _t(vj), _t(thr)).numpy()[0]
    dist = ((d_i[0, :, None, :] - d_j[0, None, :, :]) ** 2).sum(-1).astype(np.float32)
    dist = np.where((vi[0, :, None] > 0) & (vj[0, None, :] > 0), dist, np.float32(nm.BIG))
    scan = _column_scan((dist,))
    jax_out = np.asarray(pallas_2nn_batched_i8(
        jnp.asarray((d_i - 128).astype(np.int8)), jnp.asarray((d_j - 128).astype(np.int8)),
        jnp.asarray(li), jnp.asarray(hj), jnp.asarray(vi), jnp.asarray(vj), jnp.asarray(thr),
        interpret=True))[0]
    assert (scan[0] == scan[1]).mean() > 0.5  # ties are the common case here
    np.testing.assert_array_equal(scan, plain)
    np.testing.assert_array_equal(scan, jax_out)


NONE, DEAD = 1 << 29, -2 ** 31  # the kernel's "no column yet" and invalid-row marks
I8_TILE = 64  # columns per shared-memory stage of the int8 kernel


def _merge(a1, a2, ia, b1, b2, ib):
    """Merge of two partial (d1, d2, idx) of disjoint column sets: the
    lower column on a tie of d1."""
    take = (b1 < a1) | ((b1 == a1) & (ib < ia))
    return np.minimum(a1, b1), np.minimum(np.maximum(a1, b1), np.minimum(a2, b2)), np.where(take, ib, ia)


def _i8_tensor_core_schedule(q_i, q_j, li, hj, vi, vj, thr):
    """The int8 CUDA kernel's order of work for one pair, in numpy int64
    holding its int32 values: q_* int8 descriptors (value - 128).

    Each row's columns are split over the 4 lanes of a quad as the m16n8
    accumulator layout splits them (lane t holds columns 8n + 2t and
    8n + 2t + 1). Each lane scans its columns in increasing order in the
    shifted domain e = d - sq_i (2^29 for none, INT_MIN for an invalid
    row) with v = sq_j - 2 cross (sq_j = 2^30 for invalid and padding
    columns); only a candidate (v below the lane's bound) has its gate
    evaluated. At the start of every
    64-column tile the quad's (e1, e2) merge into Q, the bound of every lane
    of the quad; it falls with the lane's e2. At the end the lanes merge
    (lane xor 1, then xor 2)."""
    n1, n2 = q_i.shape[0], q_j.shape[0]
    qi, qj = q_i.astype(np.int64), q_j.astype(np.int64)
    sq_i = (qi * qi).sum(1)
    n2p = -(-n2 // I8_TILE) * I8_TILE
    sq_j = np.full(n2p, 1 << 30, np.int64)  # invalid and padding columns
    sq_j[:n2] = np.where(vj > 0, (qj * qj).sum(1), 1 << 30)
    cross = np.zeros((n1, n2p), np.int64)
    cross[:, :n2] = qi @ qj.T
    v = sq_j[None, :] - 2 * cross
    h = np.zeros((n2p, 3), np.float32)
    h[:n2] = hj
    t = np.float32(thr)
    rhs = (t * t) * (li[:, 0] * li[:, 0] + li[:, 1] * li[:, 1])
    e1 = np.full((n1, 4), NONE, np.int64)
    e2 = np.repeat(np.where(vi > 0, NONE, DEAD)[:, None], 4, 1).astype(np.int64)
    idx = np.zeros((n1, 4), np.int64)
    lanes = np.arange(4)
    for tile in range(n2p // I8_TILE):
        q1, bound = e1, e2
        for x in (1, 2):
            q1, bound, _ = _merge(q1, bound, idx, q1[:, lanes ^ x], bound[:, lanes ^ x], idx)
        for c in range(tile * I8_TILE, (tile + 1) * I8_TILE):
            t_ = (c % 8) // 2
            vc = v[:, c]
            cand = vc < bound[:, t_]
            if not cand.any():
                continue
            num = (li[:, 0] * h[c, 0] + li[:, 1] * h[c, 1]) + li[:, 2] * h[c, 2]
            cand &= num * num <= rhs
            first = cand & (vc < e1[:, t_])
            second = cand & ~first
            e2[first, t_] = e1[first, t_]
            e1[first, t_] = vc[first]
            idx[first, t_] = c
            e2[second, t_] = vc[second]
            bound[cand, t_] = np.minimum(bound[cand, t_], e2[cand, t_])
    for x in (1, 2):
        e1, e2, idx = _merge(e1, e2, idx, e1[:, lanes ^ x], e2[:, lanes ^ x], idx[:, lanes ^ x])
    e1, e2, idx = e1[:, 0], e2[:, 0], idx[:, 0]
    ok = e2 != DEAD
    big = np.float32(nm.BIG)
    return np.stack([np.where(ok & (e1 != NONE), (e1 + sq_i).astype(np.float32), big),
                     np.where(ok & (e2 != NONE), (e2 + sq_i).astype(np.float32), big),
                     np.where(ok, idx, 0).astype(np.float32)])


def _schedule_problem(binary, gate, seed=21, n1=45, n2=1001):
    """Three pairs with ragged n1 and n2 (not multiples of 16, 8 or the
    64-column tile): pair 0 with invalid rows and columns, pair 1 with
    equal minima in different tiles and lanes, pair 2 with no valid
    column. Descriptors from {0, 1} (ties the rule) or 0..255."""
    rng = np.random.RandomState(seed)
    hi = 2 if binary else 256
    d_i = rng.randint(0, hi, (3, n1, 128)).astype(np.float32)
    d_j = rng.randint(0, hi, (3, n2, 128)).astype(np.float32)
    d_j[:, 20:40] = d_i[:, :20]
    d_j[1, 300:600] = d_j[1, 0:300]  # shift 300: other tiles, other lanes
    li = np.concatenate([rng.randn(3, n1, 2), -300.0 * rng.rand(3, n1, 1)], 2).astype(np.float32)
    hj = np.concatenate([rng.rand(3, n2, 2) * 400, np.ones((3, n2, 1))], 2).astype(np.float32)
    vi = np.ones((3, n1), np.float32)
    vi[0, :3] = vi[1, -2:] = 0.0
    vj = (rng.rand(3, n2) > 0.1).astype(np.float32)
    vj[2] = 0.0
    thr = np.full(3, 8.0 if gate else 1e9, np.float32)
    return d_i, d_j, li, hj, vi, vj, thr


@pytest.mark.parametrize("gate", [False, True], ids=["gate_off", "gate_8px"])
@pytest.mark.parametrize("binary", [True, False], ids=["desc01", "desc0_255"])
def test_i8_tensor_core_schedule_equals_plain_and_jax(binary, gate):
    """The int8 kernel's schedule (columns split over the lanes of the
    accumulator layout, strict-'<' scans in int32 with the 2^29
    sentinel, the pruned gate, the quad's per-tile bound, the merge tree)
    equals the plain version and JAX's pallas_2nn_batched_i8 bit for bit."""
    d_i, d_j, li, hj, vi, vj, thr = _schedule_problem(binary, gate)
    q_i, q_j = (d_i - 128).astype(np.int8), (d_j - 128).astype(np.int8)
    model = np.stack([_i8_tensor_core_schedule(q_i[b], q_j[b], li[b], hj[b], vi[b], vj[b], thr[b])
                      for b in range(3)])
    plain = nm.nn2_plain(_t(q_i), _t(q_j), _t(li), _t(hj), _t(vi), _t(vj), _t(thr)).numpy()
    jax_out = np.asarray(pallas_2nn_batched_i8(
        jnp.asarray(q_i), jnp.asarray(q_j), jnp.asarray(li), jnp.asarray(hj), jnp.asarray(vi),
        jnp.asarray(vj), jnp.asarray(thr), interpret=True))
    np.testing.assert_array_equal(model, plain)
    np.testing.assert_array_equal(model, jax_out)
    # the problem exercises what it claims to
    found = plain[:2, 0] < nm.BIG
    assert found[0, 3:].all() if not gate else found.sum() > 10
    assert np.all(plain[2, 0] == nm.BIG) and np.all(plain[2, 2] == 0)
    assert np.all(plain[0, 0, :3] == nm.BIG)
    if binary:
        assert (plain[:2, 0] == plain[:2, 1]).mean() > 0.3  # ties are common
        # the argmin of tied rows is not always in lane 0 of the quad
        tied = (plain[:2, 0] == plain[:2, 1]) & found
        assert len(np.unique((plain[:2, 2][tied].astype(int) % 8) // 2)) > 1


# the f32 kernel's columns per tile (csrc/nn2_match.cu, kFTile)
_F32_TILE = 32


def _split_geometry(n2, S):
    """(S', columns per split): at most S splits of whole column tiles, the
    last one ragged and none empty, as nn2_match_f32 cuts them."""
    n_tiles = -(-n2 // _F32_TILE)
    if n_tiles == 0:
        return 1, 0
    per = -(-n_tiles // S)
    return -(-n_tiles // per), per * _F32_TILE


def _tf32(x):
    """cvt.rna.tf32.f32 on the float32 bits (nearest, ties away from zero),
    the low 13 bits cleared."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = np.where(np.isfinite(x), u + np.uint32(0x1000), u) & np.uint32(0xffffe000)
    return r.astype(np.uint32).view(np.float32)


def _rz32(x):
    """float64 -> float32 rounded toward zero, as the tensor cores round the
    sums they carry."""
    f = np.asarray(x, np.float64).astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _tf32_cross(a, b):
    """The f32 kernel's cross term a . b^T in its k order: a = a_hi + a_lo,
    b = b_hi + b_lo (TF32 each); k-step s takes elements 8s .. 8s + 7. The
    main products a_hi.b_hi of each k-step, summed exactly and rounded
    toward zero (a fresh tensor-core accumulator), are added to `main` in
    f32, round-to-nearest, in k order; the corrections a_hi.b_lo then
    a_lo.b_hi are added to one chain, cc, each add rounded toward zero
    (the tensor cores' accumulator); cross = main + cc. (Where the tensor
    cores round inside a sum of 8 products is their own; on integer
    descriptors every sum is exact and the model gives the kernel's bits.)"""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    main = np.zeros((a.shape[0], b.shape[0]), np.float32)
    cc = np.zeros_like(main)
    for s in range(16):
        k = slice(8 * s, 8 * s + 8)
        main = main + _rz32(a_hi[:, k].astype(np.float64) @ b_hi[:, k].T.astype(np.float64))
        for x, y in ((a_hi, b_lo), (a_lo, b_hi)):
            cc = _rz32(cc + x[:, k].astype(np.float64) @ y[:, k].T.astype(np.float64))
    return main + cc


def _f32_tensor_core_schedule(d_i, d_j, li, hj, vi, vj, thr, S):
    """The f32 CUDA kernel's order of work for one pair, in numpy float32:
    the TF32 cross term (_tf32_cross), dist = max((sq_i + sq_j) - 2 cross, 0)
    (+inf for invalid and padding columns), the columns cut into S splits of
    whole 32-column tiles (_split_geometry). In each split each row's
    columns are spread over the 4 lanes of a quad as the m16n8 accumulator
    layout spreads them (lane t: columns 8n + 2t and 8n + 2t + 1); a lane
    scans its columns in increasing order and evaluates the gate only for a
    candidate, dist below its bound: the quad's second value Q at the start
    of each tile, then the lane's d2 as it falls. The quad merges its lanes
    (xor 1, then xor 2), and the splits' partials merge in increasing order."""
    n1, n2 = d_i.shape[0], d_j.shape[0]
    S_, per = _split_geometry(n2, S)
    n2p = -(-n2 // _F32_TILE) * _F32_TILE
    sq_i = (d_i.astype(np.float64) ** 2).sum(1).astype(np.float32)
    sq_j = np.full(n2p, np.inf, np.float32)
    sq_j[:n2] = np.where(vj > 0, (d_j.astype(np.float64) ** 2).sum(1).astype(np.float32), np.inf)
    cross = np.zeros((n1, n2p), np.float32)
    cross[:, :n2] = _tf32_cross(d_i, d_j)
    with np.errstate(invalid="ignore"):
        dist = np.maximum((sq_i[:, None] + sq_j[None, :]) - np.float32(2) * cross, np.float32(0))
    h = np.zeros((n2p, 3), np.float32)
    h[:n2] = hj
    t32 = np.float32(thr)
    rhs = (t32 * t32) * (li[:, 0] * li[:, 0] + li[:, 1] * li[:, 1])
    big = np.float32(nm.BIG)
    lanes = np.arange(4)
    parts = []
    for z in range(S_):
        d1 = np.full((n1, 4), big, np.float32)
        d2 = np.repeat(np.where(vi > 0, big, -np.inf)[:, None], 4, 1).astype(np.float32)
        idx = np.zeros((n1, 4), np.int64)
        for c0 in range(z * per, min(n2p, (z + 1) * per), _F32_TILE):
            q1, bound = d1, d2
            for x in (1, 2):
                q1, bound, _ = _merge(q1, bound, idx, q1[:, lanes ^ x], bound[:, lanes ^ x], idx)
            bound = bound.copy()
            for c in range(c0, c0 + _F32_TILE):
                t_ = (c % 8) // 2
                dc = dist[:, c]
                cand = dc < bound[:, t_]
                if not cand.any():
                    continue
                num = (li[:, 0] * h[c, 0] + li[:, 1] * h[c, 1]) + li[:, 2] * h[c, 2]
                cand &= num * num <= rhs
                first = cand & (dc < d1[:, t_])
                second = cand & ~first
                d2[first, t_] = d1[first, t_]
                d1[first, t_] = dc[first]
                idx[first, t_] = c
                d2[second, t_] = dc[second]
                bound[cand, t_] = np.minimum(bound[cand, t_], d2[cand, t_])
        for x in (1, 2):
            d1, d2, idx = _merge(d1, d2, idx, d1[:, lanes ^ x], d2[:, lanes ^ x], idx[:, lanes ^ x])
        ok = d2[:, 0] != -np.inf
        parts.append((np.where(ok, d1[:, 0], big), np.where(ok, d2[:, 0], big),
                      np.where(ok, idx[:, 0], 0)))
    a1, a2, ia = parts[0]
    for b1, b2, ib in parts[1:]:
        a1, a2, ia = _merge(a1, a2, ia, b1, b2, ib)
    return np.stack([a1, a2, ia.astype(np.float32)]).astype(np.float32)


def _f32_schedule_problem(kind, gate, seed=31, n1=45, n2=301):
    """Three pairs with ragged n1 and n2 (n2 ends inside the tenth 32-column
    tile): pair 0 with invalid rows and columns, pair 1 with equal minima in
    other tiles, lanes and splits, pair 2 with no valid column. Descriptors
    from {0, 1} (ties the rule), 0..255, or 0..255 plus a fraction."""
    rng = np.random.RandomState(seed)
    hi = 2 if kind == "desc01" else 256
    d_i = rng.randint(0, hi, (3, n1, 128)).astype(np.float32)
    d_j = rng.randint(0, hi, (3, n2, 128)).astype(np.float32)
    d_j[:, 20:40] = d_i[:, :20]
    d_j[1, 150:300] = d_j[1, 0:150]  # shift 150: other tiles, lanes and splits
    if kind == "fraction":
        d_i += rng.rand(*d_i.shape).astype(np.float32)
        d_j += rng.rand(*d_j.shape).astype(np.float32)
    li = np.concatenate([rng.randn(3, n1, 2), -300.0 * rng.rand(3, n1, 1)], 2).astype(np.float32)
    hj = np.concatenate([rng.rand(3, n2, 2) * 400, np.ones((3, n2, 1))], 2).astype(np.float32)
    vi = np.ones((3, n1), np.float32)
    vi[0, :3] = vi[1, -2:] = 0.0
    vj = (rng.rand(3, n2) > 0.1).astype(np.float32)
    vj[2] = 0.0
    thr = np.full(3, 8.0 if gate else 1e9, np.float32)
    return d_i, d_j, li, hj, vi, vj, thr


@functools.lru_cache(maxsize=None)
def _f32_jax(kind, gate):
    """JAX's pallas_2nn_batched and pallas_2nn (pair 0), interpret mode."""
    d_i, d_j, li, hj, vi, vj, thr = _f32_schedule_problem(kind, gate)
    ops = [jnp.asarray(a) for a in (d_i, d_j, li, hj, vi, vj, thr)]
    batched = np.asarray(pallas_2nn_batched(*ops, interpret=True))
    single = pallas_2nn(*[jnp.asarray(a[0]) for a in (d_i, d_j, li, hj, vi, vj)], float(thr[0]),
                        interpret=True)
    return batched, np.stack([np.asarray(single[0]), np.asarray(single[1]),
                              np.asarray(single[2]).astype(np.float32)])


@pytest.mark.parametrize("S", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("gate", [False, True], ids=["gate_off", "gate_8px"])
@pytest.mark.parametrize("kind", ["desc01", "desc0_255"])
def test_f32_tensor_core_schedule_bit_identical_to_plain_and_jax(kind, gate, S):
    """The f32 kernel's schedule (TF32 split products in the kernel's k
    order, the f32 epilogue pruned by the quad's bound, S column splits of
    whole tiles, the last ragged, merged in order) on integer descriptors
    equals the plain version, JAX's pallas_2nn_batched and, for pair 0,
    JAX's pallas_2nn (interpret mode) bit for bit, whatever S."""
    d_i, d_j, li, hj, vi, vj, thr = _f32_schedule_problem(kind, gate)
    assert np.array_equal(_tf32(d_i), d_i) and not _tf32(d_i - _tf32(d_i)).any()
    model = np.stack([_f32_tensor_core_schedule(d_i[b], d_j[b], li[b], hj[b], vi[b], vj[b],
                                                thr[b], S) for b in range(3)])
    plain = nm.nn2_plain(_t(d_i), _t(d_j), _t(li), _t(hj), _t(vi), _t(vj), _t(thr)).numpy()
    jax_batched, jax_single = _f32_jax(kind, gate)
    np.testing.assert_array_equal(model, plain)
    np.testing.assert_array_equal(model, jax_batched)
    np.testing.assert_array_equal(model[0], jax_single)
    # the problem exercises what it claims to
    n_tiles = -(-d_j.shape[1] // _F32_TILE)
    S_, per = _split_geometry(d_j.shape[1], S)
    assert S_ == S and (S - 1) * per < n_tiles * _F32_TILE <= S * per
    found = plain[:2, 0] < nm.BIG
    assert found.sum() > 10
    assert np.all(plain[2, 0] == nm.BIG) and np.all(plain[2, 2] == 0)
    assert np.all(plain[0, 0, :3] == nm.BIG)
    if kind == "desc01":
        assert (plain[:2, 0] == plain[:2, 1]).mean() > 0.3  # ties are common
        tied = (plain[:2, 0] == plain[:2, 1]) & found
        assert len(np.unique((plain[:2, 2][tied].astype(int) % 8) // 2)) > 1


@pytest.mark.parametrize("S", [1, 3])
def test_f32_tensor_core_schedule_on_non_integer_descriptors(S):
    """On descriptors with fractional parts the split keeps the error near
    f32's: the model's distances are within 16 ulp of S = max sq_i + max
    sq_j of JAX's pallas_2nn_batched (interpret mode), and an argmin moves
    only between columns within twice that of each other."""
    d_i, d_j, li, hj, vi, vj, thr = _f32_schedule_problem("fraction", False)
    model = np.stack([_f32_tensor_core_schedule(d_i[b], d_j[b], li[b], hj[b], vi[b], vj[b],
                                                thr[b], S) for b in range(3)])
    want, _ = _f32_jax("fraction", False)
    Smax = float((d_i.astype(np.float64) ** 2).sum(-1).max()
                 + (d_j.astype(np.float64) ** 2).sum(-1).max())
    tol = 16 * np.finfo(np.float32).eps * Smax
    assert np.abs(model[:, :2] - want[:, :2]).max() <= tol
    moved = model[:, 2] != want[:, 2]
    assert np.all((want[:, 1] - want[:, 0])[moved] <= 2 * tol)
    assert (model[:2, 0] < nm.BIG).sum() > 80  # every valid row of pairs 0 and 1


@pytest.mark.parametrize("seed", [1, 2])
def test_f32_tensor_core_model_bias_against_exact_distances(seed):
    """The model of the kernel's cross term (_tf32_cross: each k-step's 8
    main products in a fresh accumulator rounded toward zero, then added
    round-to-nearest) on 0..255 descriptors plus a [0, 1) fraction, half of
    the rows repeated among the columns: d1's mean error against the exact
    (float64) distance to its column stays within the card's bar of
    0.5 eps * S (S = max sq_i + max sq_j), and every error within 16."""
    rng = np.random.RandomState(seed)
    d_i = rng.randint(0, 256, (300, 128)).astype(np.float32)
    d_j = rng.randint(0, 256, (600, 128)).astype(np.float32)
    d_j[:150] = d_i[:150]
    d_i += rng.rand(*d_i.shape).astype(np.float32)
    d_j += rng.rand(*d_j.shape).astype(np.float32)
    sq_i = (d_i.astype(np.float64) ** 2).sum(1).astype(np.float32)
    sq_j = (d_j.astype(np.float64) ** 2).sum(1).astype(np.float32)
    dist = np.maximum((sq_i[:, None] + sq_j[None, :]) - np.float32(2) * _tf32_cross(d_i, d_j),
                      np.float32(0))
    j = dist.argmin(1)
    rows = np.arange(len(d_i))
    exact = ((d_i.astype(np.float64) - d_j[j].astype(np.float64)) ** 2).sum(1)
    err = dist[rows, j].astype(np.float64) - exact
    eps_S = np.finfo(np.float32).eps * float(sq_i.max() + sq_j.max())
    assert abs(err.mean()) <= 0.5 * eps_S, err.mean() / eps_S
    assert np.abs(err).max() <= 16 * eps_S


def test_gate_is_elementwise_and_one_sided():
    """The plain gate is num^2 <= thr^2 (l0^2 + l1^2) with num evaluated as
    ((l0*h0) + (l1*h1)) + (l2*h2) in float32 (no fused multiply-add), the
    order the CUDA kernel uses with round-to-nearest intrinsics: every
    reported neighbour satisfies the gate computed that way in numpy."""
    d_i, d_j, li, hj, vi, vj, thr = _integer_problem(seed=5)
    out = nm.nn2_plain(_t(d_i), _t(d_j), _t(li), _t(hj), _t(vi), _t(vj), _t(thr)).numpy()
    for b in (1, 2):
        found = out[b, 0] < nm.BIG
        j = out[b, 2, found].astype(int)
        l_, h_ = li[b, found], hj[b, j]
        num = (l_[:, 0] * h_[:, 0] + l_[:, 1] * h_[:, 1]) + l_[:, 2] * h_[:, 2]
        rhs = (thr[b] * thr[b]) * (l_[:, 0] * l_[:, 0] + l_[:, 1] * l_[:, 1])
        assert np.all(num * num <= rhs)
    assert (out[1, 0] < nm.BIG).sum() > 10


def test_wrappers_check_their_operands():
    d_i, d_j, li, hj, vi, vj, thr = _integer_problem()
    ops = [_t(a) for a in (li, hj, vi, vj, thr)]
    with pytest.raises(ValueError, match="must be torch.int8"):
        nm.nn2_batched_i8(_t(d_i), _t(d_j), *ops)
    with pytest.raises(ValueError, match="shape"):
        nm.nn2_batched(_t(d_i), _t(d_j[:, :, :64].copy()), *ops)
    with pytest.raises(ValueError, match="contiguous"):
        nm.nn2_batched(_t(d_i), _t(d_j), _t(li).transpose(1, 2).contiguous().transpose(1, 2),
                       *ops[1:])


def _frames(seed=3):
    rng = np.random.RandomState(seed)
    frames = []
    for k in (500, 650, 380):
        f = np.zeros((k, 132), np.float32)
        f[:, :2] = rng.rand(k, 2) * 400
        f[:, 2] = 1.0 + rng.rand(k)
        f[:, 4:] = rng.randint(0, 256, size=(k, 128)).astype(np.float32)
        frames.append(f)
    frames[1][:200, 4:] = frames[0][:200, 4:]
    frames[2][:150, 4:] = frames[1][100:250, 4:]
    return frames


def test_match_pairs_2nn_staged_matches_jax():
    """The staged matcher (frames staged once, pair operands gathered on the
    device, int8 2-NN) against JAX's with interpret=True, as
    tests/test_pallas_match.py::test_match_pairs_2nn_staged_matches_host_packed
    sets it up: identical (nn, accepted) per pair."""
    frames = _frames()
    pair_frames = [(0, 1), (1, 2), (0, 2)]
    pair_idx = [(np.arange(0, 450), np.arange(0, 600)),
                (np.arange(50, 640), np.arange(0, 380)),
                (np.arange(0, 500), np.arange(10, 370))]
    Fs = [None,
          np.array([[0.0, 1e-4, -0.02], [-1e-4, 0.0, 0.03], [0.02, -0.03, 1.0]], np.float32),
          None]
    want = jmatch.match_pairs_2nn_staged(jmatch.stage_frames_for_matching(frames), pair_frames,
                                         pair_idx, Fs, rel_thr=0.8, interpret=True)
    staged = tmatch.stage_frames_for_matching(frames, device="cpu")
    assert staged["desc"].dtype == torch.int8 and staged["n_f"] == 1024
    got = tmatch.match_pairs_2nn_staged(staged, pair_frames, pair_idx, Fs, rel_thr=0.8)
    for (nn_g, acc_g), (nn_w, acc_w) in zip(got, want):
        np.testing.assert_array_equal(acc_g, acc_w)
        np.testing.assert_array_equal(nn_g, nn_w)
    assert sum(int(a.sum()) for _, a in got) > 300


def _padded_frames():
    """_frames() as the detector writes frames: float64, NaN-padded to 4 096
    rows; a fourth frame with a NaN row among its keypoints, and a fifth that
    is all NaN."""
    frames = _frames()
    frames.append(frames[0][:420].copy())
    frames[3][200] = np.nan
    padded = []
    for f in frames + [np.zeros((0, 132))]:
        p = np.full((4096, 132), np.nan)
        p[: len(f)] = f
        padded.append(p)
    return padded


_PADDED_PAIRS = {
    # the UTM boxes' row subsets, and indices into the padding: past a
    # frame's keypoints inside the staged table (520-699 of frame 0), past
    # the table (4 000), a frame's NaN row (200 of frame 3), a frame of
    # padding only (frame 4)
    "pair_frames": [(0, 1), (1, 2), (0, 2), (3, 1), (0, 4)],
    "pair_idx": [(np.arange(0, 450), np.arange(0, 600)),
                 (np.arange(50, 640), np.arange(0, 380)),
                 (np.r_[np.arange(0, 700), 4000], np.arange(10, 370)),
                 (np.arange(0, 420), np.r_[np.arange(0, 300), 4000]),
                 (np.arange(0, 100), np.arange(0, 64))],
    "Fs": [None,
           np.array([[0.0, 1e-4, -0.02], [-1e-4, 0.0, 0.03], [0.02, -0.03, 1.0]], np.float32),
           np.array([[0.0, -2e-4, 0.01], [2e-4, 0.0, -0.04], [-0.01, 0.04, 1.0]], np.float32),
           None, None],
}


def test_stage_frames_stages_the_keypoint_rows():
    """Frames padded far past their keypoints stage only their keypoint rows
    (n_f 1 024, not 4 096); those rows are JAX's staged rows, and the rows
    below n_f past a frame's keypoints are its padding, as there."""
    frames = _padded_frames()
    counts = {}
    staged = tmatch.stage_frames_for_matching(frames, device="cpu", counts=counts)
    assert staged["n_f"] == 1024
    want = jmatch.stage_frames_for_matching(frames)
    assert want["n_f"] == 4096
    np.testing.assert_array_equal(staged["desc"].numpy(), np.asarray(want["desc"])[:, :1024])
    np.testing.assert_array_equal(staged["hpts"].numpy(), np.asarray(want["hpts"])[:, :1024])
    rows = 500 + 650 + 380 + 420
    assert counts == {"rows_given": 5 * 4096, "rows_staged": rows, "h2d_bytes": rows * 132 * 8,
                      "route": "device"}


def test_staged_operands_equal_the_whole_tables():
    """The kernel's operands gathered from the keypoint rows equal, bit for
    bit, those gathered from tables of every row of the frames (JAX's
    staging); an index into the padding, within the table or past it, gives
    descriptor -128 and point (0, 0, 1)."""
    frames = _padded_frames()
    staged = tmatch.stage_frames_for_matching(frames, device="cpu")
    full = jmatch.stage_frames_for_matching(frames)
    full = {"desc": _t(np.array(full["desc"])), "hpts": _t(np.array(full["hpts"])),
            "n_f": full["n_f"]}
    pp = _PADDED_PAIRS
    seen = set()
    for chunk, n1, n2 in tmatch.staged_chunks(pp["pair_idx"], max_bytes=8 << 20):
        arrays = tmatch.staged_chunk_arrays(chunk, n1, n2, pp["pair_frames"], pp["pair_idx"],
                                            pp["Fs"], tmatch.EPIPOLAR_THR)
        got = tmatch.staged_chunk_operands(staged, arrays)
        want = tmatch.staged_chunk_operands(full, arrays)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
        for b, q in enumerate(chunk):
            if q == 2:  # (0, 2): rows 500-699 and 4 000 of frame 0 are padding
                assert bool((got[0][b, 500:701] == -128).all())
                assert bool((got[2][b, 500:701] == _t(pp["Fs"][2][:, 2])).all())
            if q == 3:  # (3, 1): column 300 is frame 1's row 4 000
                assert bool((got[1][b, 300] == -128).all())
                assert torch.equal(got[3][b, 300], torch.tensor([0.0, 0.0, 1.0]))
        seen.update(chunk)
    assert seen == set(range(5))


def test_match_pairs_2nn_staged_padded_frames_match_jax():
    """The staged matcher on padded frames gives JAX's staged matcher's
    (nn, accepted) exactly, indices into the padding included."""
    frames = _padded_frames()
    pp = _PADDED_PAIRS
    want = jmatch.match_pairs_2nn_staged(jmatch.stage_frames_for_matching(frames),
                                         pp["pair_frames"], pp["pair_idx"], pp["Fs"],
                                         rel_thr=0.8, interpret=True)
    got = tmatch.match_pairs_2nn_staged(tmatch.stage_frames_for_matching(frames, device="cpu"),
                                        pp["pair_frames"], pp["pair_idx"], pp["Fs"], rel_thr=0.8)
    for (nn_g, acc_g), (nn_w, acc_w) in zip(got, want):
        np.testing.assert_array_equal(acc_g, acc_w)
        np.testing.assert_array_equal(nn_g, nn_w)
    assert sum(int(a.sum()) for _, a in got[:4]) > 300


def test_host_packing_matches_jax():
    """pack_pairs, int8_packable and accept_from_packed give JAX's arrays."""
    frames = _frames(seed=6)
    feats = [(frames[0][:300], frames[1][:400]), (frames[1][100:], frames[2])]
    Fs = [np.eye(3) * 1e-3, None]
    pj, pt = jmatch.pack_pairs(feats, Fs), tmatch.pack_pairs(feats, Fs)
    for k in pj:
        np.testing.assert_array_equal(pt[k], pj[k])
    assert tmatch.int8_packable(pt["di"], pt["dj"]) == jmatch.int8_packable(pj["di"], pj["dj"])
    assert not tmatch.int8_packable(pt["di"] + 0.5, pt["dj"])
    packed = nm.nn2_plain(*[_t(pt[k]) for k in ("di", "dj", "li", "hj", "vi", "vj", "thr")])
    got = tmatch.accept_from_packed(packed.numpy(), feats, pt["vi"], "relative", 0.8, 250.0)
    want = jmatch.accept_from_packed(packed.numpy(), feats, pj["vi"], "relative", 0.8, 250.0)
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_stage_frames_declines_non_integer_descriptors():
    f = np.zeros((32, 132), np.float32)
    f[:, 4:] = 0.5
    assert tmatch.stage_frames_for_matching([f], device="cpu") is None


@pytest.mark.parametrize("bad", [3.5, 256.0, -1.0])
def test_stage_frames_declines_in_the_last_keypoint_row(bad):
    """One descriptor value that is not an integer in 0..255, in a padded
    frame's last keypoint row, declines the whole call."""
    frames = _padded_frames()
    frames[2][379, 70] = bad
    counts = {}
    assert tmatch.stage_frames_for_matching(frames, device="cpu", counts=counts) is None
    assert jmatch.stage_frames_for_matching(frames) is None
    assert counts["route"] == "declined"


@pytest.mark.parametrize("gate", [False, True])
def test_cpu_matcher_matches_jax(gate):
    """On the CPU both packages match through match_descriptors_2nn (the
    symmetric epipolar gate); match_pairs_2nn_batched and match_pair
    without RANSAC give JAX's matches exactly (integer descriptors make the
    cross term exact; the gate's f32 epipolar distances agree)."""
    frames = _frames(seed=8)
    fi, fj = frames[0].astype(np.float64), frames[1].astype(np.float64)
    fi[-7:] = np.nan
    F = np.array([[0.0, 1e-4, -0.02], [-1e-4, 0.0, 0.03], [0.02, -0.03, 1.0]]) if gate else None
    got = tmatch.match_pairs_2nn_batched([(fi, fj)], [F], rel_thr=0.8, device="cpu")
    want = jmatch.match_pairs_2nn_batched([(fi, fj)], [F], rel_thr=0.8)
    np.testing.assert_array_equal(got[0][1], want[0][1])
    np.testing.assert_array_equal(got[0][0][got[0][1]], want[0][0][want[0][1]])
    m_got, n_ratio, _ = tmatch.match_pair(fi, fj, F=F, rel_thr=0.8, ransac_thr=None, device="cpu")
    m_want, n_ratio_j, _ = jmatch.match_pair(fi, fj, F=F, rel_thr=0.8, ransac_thr=None)
    assert n_ratio == n_ratio_j > (5 if gate else 100)
    np.testing.assert_array_equal(m_got, m_want)


def _ransac_problem(seed, n=200, n_out=40):
    rng = np.random.RandomState(seed)
    pts1 = rng.uniform(0, 500, (n, 2))
    pts2 = pts1 + np.stack([20.0 / rng.uniform(1, 2, n), np.zeros(n)], axis=1)
    pts2 += 0.05 * rng.randn(n, 2)
    out = rng.choice(n, n_out, replace=False)
    pts2[out] += rng.uniform(-60, 60, (n_out, 2))
    return pts1, pts2, out


@pytest.mark.parametrize("adaptive", [True, False])
def test_ransac_fundamental_many_bit_identical(adaptive):
    """The batched numpy RANSAC is copied with its RandomState stream, its
    dtypes and its refit: same F and same inliers, bit for bit."""
    probs = [_ransac_problem(s, n=150 + 40 * s) for s in range(4)]
    probs.append((probs[0][0][:5], probs[0][1][:5], None))  # too few matches
    p1 = [p[0] for p in probs]
    p2 = [p[1] for p in probs]
    got = transac.ransac_fundamental_many(p1, p2, thr=0.3, adaptive=adaptive)
    want = jransac.ransac_fundamental_many(p1, p2, thr=0.3, adaptive=adaptive)
    for (Fg, ig), (Fw, iw) in zip(got, want):
        if Fw is None:
            assert Fg is None and ig is None
            continue
        np.testing.assert_array_equal(Fg, Fw)
        np.testing.assert_array_equal(ig, iw)


def test_ransac_fundamental_single_pair_by_property():
    """ransac_fundamental draws its minimal sets from numpy (the JAX
    package's `_ransac_numpy` stream: bit-identical to it), where the JAX
    path draws them with jax.random; against the JAX path the two are held
    by property: both reject the injected outliers and keep the inliers."""
    pts1, pts2, out = _ransac_problem(3)
    F_t, inl_t = transac.ransac_fundamental(pts1, pts2, thr=0.3)
    F_j, inl_j = jransac.ransac_fundamental(pts1, pts2, thr=0.3)
    F_n, inl_n = jransac._ransac_numpy(pts1, pts2, np.ones(len(pts1), bool), 0.3, 0, 512, True)
    np.testing.assert_array_equal(F_t, F_n)
    np.testing.assert_array_equal(inl_t, inl_n)
    true_in = np.setdiff1d(np.arange(len(pts1)), out)
    for inl in (inl_t, inl_j):
        assert np.sum(inl[out]) < 10
        assert np.sum(inl[true_in]) > 140
    assert np.mean(inl_t == inl_j) > 0.95
