"""tracks.matching_s (s/scene): `tracks.matching` -> `ops.match` ->
`ops.nn2_match` (csrc/nn2_match.cu) and `ops.ransac` on the host, the
tracks front end's matching wall (`ft_timing["matching_s"]`), mean per
scene."""


def read(run):
    units = run["units"]
    if not units or "ft_timing" not in units[0]:
        return None
    return sum(u["ft_timing"].get("matching_s", 0.0) for u in units) / len(units)
