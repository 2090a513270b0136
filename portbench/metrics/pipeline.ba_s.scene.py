"""pipeline.ba_s.scene (s/scene): the pipeline's BA stage in a CLI scene,
soft-L1, outliers and L2 (`pipeline.timing["soft_l1_s"] + ["outliers_s"] +
["l2_s"]`), mean per scene."""


def read(run):
    units = run["units"]
    if not units or "timing" not in units[0]:
        return None
    keys = ("soft_l1_s", "outliers_s", "l2_s")
    return sum(sum(u["timing"].get(k, 0.0) for k in keys) for u in units) / len(units)
