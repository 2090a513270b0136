"""ba.host_phases_s (s/stage): the host phases around the LM solve in the
traced BA stages: the parameters (`ba.params`, BAParams.from_obs_table), the
solver's tables (`ba.solver.init`) and `ba.reconstruct` (reconstruct_vars),
their spans' seconds summed, over the traced stages (portbench/spans.py)."""

from portbench import spans


def read(run):
    return spans.seconds_per_traced_unit(run, ("ba.params", "ba.solver.init", "ba.reconstruct"))
