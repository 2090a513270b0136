"""ba.outliers_s (s/stage): the outlier pass of the traced robust BA stages
(`ba.outliers` spans, ba/outliers.rm_outliers: thresholds, removal, track
filters, re-triangulation, the new parameters), their seconds summed, over
the traced stages (portbench/spans.py)."""

from portbench import spans


def read(run):
    return spans.seconds_per_traced_unit(run, ("ba.outliers",))
