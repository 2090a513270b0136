"""ba.outliers.idle_share (%): the share of the traced stages' outlier
passes (`ba.outliers` spans) in which no operation ran on the device: the
spans' length less their overlap with the union of the device operations,
over their length (portbench/spans.py)."""

from portbench import spans


def read(run):
    return spans.idle_share(run, ("ba.outliers",))
