"""lm.soft_l1_s (s/stage): the soft-L1 rounds of the traced robust BA
stages (`ba.solve` spans whose `loss` is soft_l1: the LM solve with the
robust loss's scaling, its CUDA graphs' capture and replays), their seconds
summed, over the traced stages (portbench/spans.py)."""

from portbench import spans


def read(run):
    recorded = spans.recorded(run)
    traced = [u for u in run["units"] if u.get("traced")]
    if recorded is None or not traced:
        return None
    chosen = [s for s in spans.named(recorded, ("ba.solve",)) if s[5].get("loss") == "soft_l1"]
    if not chosen:
        return None
    return sum(s[4] - s[3] for s in chosen) * 1e-9 / len(traced)
