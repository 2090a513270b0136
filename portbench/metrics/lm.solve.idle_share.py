"""lm.solve.idle_share (%): the share of the traced BA stages' LM solves
(`lm.solve` spans: `ops.lm`'s run, its warm-up, captures, graph replays and
the host's reads of each CG block) in which no operation ran on the device:
the spans' length less their overlap with the union of the device
operations, over their length (portbench/spans.py)."""

from portbench import spans


def read(run):
    return spans.idle_share(run, ("lm.solve",))
