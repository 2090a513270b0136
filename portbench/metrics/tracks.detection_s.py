"""tracks.detection_s (s/scene): `tracks.detection` -> `ops.sift`, the
tracks front end's detection wall (`ft_timing["detection_s"]`), mean per
scene."""


def read(run):
    units = run["units"]
    if not units or "ft_timing" not in units[0]:
        return None
    return sum(u["ft_timing"]["detection_s"] for u in units) / len(units)
