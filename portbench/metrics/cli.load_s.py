"""cli.load_s (s/scene): the scene load of `cli` -> `timeseries.Scene`
(reading the tifs and RPCs) and the pipeline's footprints and camera
centers, from the program's own walls (`Scene.timing["scene_load_s"]`,
`pipeline.timing["footprints_s"]`, `["cameras_s"]`), mean per scene."""


def read(run):
    units = run["units"]
    if not units or "timing" not in units[0]:
        return None
    keys = ("scene_load_s", "footprints_s", "cameras_s")
    return sum(sum(u["timing"][k] for k in keys) for u in units) / len(units)
