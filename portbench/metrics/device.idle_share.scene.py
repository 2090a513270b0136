"""device.idle_share.scene (%): the share of the traced CLI scenes' wall in
which no operation ran on the device: 1 - the union of the device
operations' spans over the traced window."""


def read(run):
    t = run["trace"]
    if t is None or not run["units"] or "ft_timing" not in run["units"][0]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
