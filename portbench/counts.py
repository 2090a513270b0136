"""Operations, bytes and least times that the yardstick computes from a
problem's shapes, never from the program's layouts."""

from portbench import peaks


def schur_wz_bytes(M, N, K, P):
    """The bytes that one product of the reduced camera system's coupling
    term, wz = W V^-1 W^T x, needs at least (float32 values, int32
    indices): each observation's P x 3 block of W read once, each point's
    3 x 3 block of V^-1 once, one camera index and one point index per
    observation, x once, and wz written once."""
    return 4 * (3 * K * P + 9 * N + 2 * K + 2 * M * P)


def schur_wz_ops(M, N, K, P):
    """Its floating-point operations: W^T x and W u, 2 x 3P per observation
    each, and V^-1 t, 18 per point."""
    return 12 * K * P + 18 * N


def schur_wz_least_s(M, N, K, P):
    """The least time of one product on the card: the larger of its bytes
    over the memory bandwidth and its operations over the float32 rate."""
    return max(schur_wz_bytes(M, N, K, P) / peaks.BYTES_PER_S,
               schur_wz_ops(M, N, K, P) / peaks.F32_PER_S)
