"""The measured window: a closed loop of whole units of work.

A unit starts only while the window is open, and a unit that started runs
to its end. The time per unit is the time from the window's start to the
end of the last unit, over the units completed, so that a stall anywhere
in the window shows.
"""

import time


def closed_loop(unit, seconds, clock=time.perf_counter):
    """Run unit() back to back while `seconds` have not passed since the
    start. Returns (records, start, ends): each unit's return value, the
    window's start and each unit's end on `clock`."""
    records, ends = [], []
    start = clock()
    while clock() - start < seconds:
        records.append(unit(len(records)))
        ends.append(clock())
    return records, start, ends


def seconds_per_unit(start, ends):
    """The window's time to the end of its last unit, over the units."""
    if not ends:
        raise ValueError("the window completed no unit")
    return (ends[-1] - start) / len(ends)
