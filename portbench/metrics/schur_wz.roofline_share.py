"""schur_wz.roofline_share (%): `ops.schur_matvec` (csrc/schur_matvec.cu)
against its roofline in the traced BA stages: the least time the problem's
operator work needs, over the device time of the operator's kernels.

Device time: the union of the profiler's spans of the kernels named in
KERNELS. Least time, per matvec, from the problem's shapes alone
(portbench/counts.py; not from either of the port's layouts), times the
matvecs of each traced round."""

from portbench import counts, trace

KERNELS = ("schur_points", "schur_cameras")


def read(run):
    t = run["trace"]
    traced = [u for u in run["units"] if u.get("traced") and "shapes" in u]
    if t is None or not traced:
        return None
    spans = [(s, e) for name, s, e in t["device_ops"] if any(k in name for k in KERNELS)]
    if not spans:
        return None
    device_s = trace.union(spans)[0] * 1e-9
    least_s = sum(r["matvecs"] * counts.schur_wz_least_s(**shape)
                  for u in traced for r, shape in zip(u["rounds"], u["shapes"]))
    return 100.0 * least_s / device_s
