"""The yardstick's arithmetic on the CPU: the window rule, the union of
device spans, the idle gaps, and the Schur operator's problem count."""

import pytest

from portbench import counts, peaks, trace, window


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("durations,seconds,n_units,per_unit", [
    ((4.0, 4.0, 4.0, 4.0), 10.0, 3, 4.0),        # the third starts at 8 < 10 and finishes at 12
    ((3.0, 9.0, 1.0), 10.0, 2, 6.0),             # a stall shows in the time per unit
    ((25.0,), 10.0, 1, 25.0),                    # a unit longer than the window still counts
])
def test_units_that_start_in_the_window_finish_and_count_to_their_end(durations, seconds,
                                                                      n_units, per_unit):
    clock = FakeClock()
    it = iter(durations)

    def unit(i):
        clock.t += next(it)
        return {"i": i}

    records, start, ends = window.closed_loop(unit, seconds, clock=clock)
    assert [r["i"] for r in records] == list(range(n_units))
    assert ends[-1] - start == pytest.approx(sum(durations[:n_units]))
    assert ends[-1] - start >= seconds or n_units == len(durations)
    assert window.seconds_per_unit(start, ends) == pytest.approx(per_unit)


def test_seconds_per_unit_needs_a_unit():
    with pytest.raises(ValueError):
        window.seconds_per_unit(0.0, [])


def test_union_of_spans_counts_overlaps_once_and_keeps_the_gaps():
    busy, gaps = trace.union([(10, 20), (15, 25), (30, 40), (32, 35), (50, 51)])
    assert busy == 15 + 10 + 1
    assert gaps == [(25, 30), (40, 50)]
    assert trace.union([]) == (0, [])


def test_idle_gaps_are_named_by_the_host_operation_that_was_open():
    gaps = [(25, 30), (40, 50), (60, 61)]
    host = [("outer", 0, 100), ("aten::item", 24, 31), ("cudaStreamSynchronize", 39, 45)]
    named = trace.label_gaps(gaps, host)
    assert named == {"aten::item": 5, "cudaStreamSynchronize": 10, "outer": 1}
    assert trace.label_gaps([(5, 6)], []) == {"host (no operation)": 1}
    assert trace.top({"a": 1.0, "b": 3.0, "c": 2.0}, 2) == [["b", 3.0], ["c", 2.0]]


def test_schur_wz_problem_count_by_hand():
    # M = 2 cameras, N = 1 point seen by K = 2 observations, P = 3:
    # W: 2 blocks of 3 x 3 (18 values), V^-1: 9 values, 4 indices,
    # x and wz: 6 values each
    assert counts.schur_wz_bytes(M=2, N=1, K=2, P=3) == 4 * (18 + 9 + 4 + 12)
    # W^T x and W u: 2 * 9 each per observation; V^-1 t: 18
    assert counts.schur_wz_ops(M=2, N=1, K=2, P=3) == 2 * 36 + 18
    # at 1000 cameras and 800 000 observations the bytes bound it: ~42.4 MB
    b = counts.schur_wz_bytes(M=1000, N=200000, K=800000, P=3)
    assert b == 4 * (7_200_000 + 1_800_000 + 1_600_000 + 6_000)
    assert counts.schur_wz_least_s(M=1000, N=200000, K=800000, P=3) == pytest.approx(
        b / peaks.BYTES_PER_S)
