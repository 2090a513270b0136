"""ts.date_s (s/date): the mean wall of the traced series' dates after the
first (`ts.date` spans with `date` > 0, timeseries.Scene.
run_sequential_bundle_adjustment: the date's input data, its whole
pipeline against its frozen predecessor, the .ply copy and the reprojection
errors): the steady state of a series (portbench/spans.py)."""

from portbench.drivers.ts_scenes import later_dates


def read(run):
    later = later_dates(run)
    if not later:
        return None
    return sum(s[4] - s[3] for s in later) * 1e-9 / len(later)
