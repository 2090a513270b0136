"""ts.cache_read_s (s/date): what the traced series' dates after the first
(`ts.date` spans with `date` > 0) spend on the state that the earlier dates
left: the reads of the cached keypoints (`detection.cache_read`) and of the
cached pairwise matches (`matching.cache_read`), and the triangulation of
the tracks that only frozen cameras see (`pipeline.pts3d_fix`), their
seconds summed over those dates (portbench/spans.py)."""

from portbench import spans
from portbench.drivers.ts_scenes import later_dates

NAMES = ("detection.cache_read", "matching.cache_read", "pipeline.pts3d_fix")


def read(run):
    later = later_dates(run)
    if not later:
        return None
    inside = [s for s in spans.named(spans.recorded(run), NAMES)
              if any(d[3] <= s[3] and s[4] <= d[4] for d in later)]
    return sum(s[4] - s[3] for s in inside) * 1e-9 / len(later)
