"""pipeline.refit_s (s/scene): `ba.rpcfit` and the writers of a CLI scene
(`pipeline.timing["refit_s"] + ["writes_s"]`), mean per scene."""


def read(run):
    units = run["units"]
    if not units or "timing" not in units[0]:
        return None
    return sum(u["timing"]["refit_s"] + u["timing"]["writes_s"] for u in units) / len(units)
