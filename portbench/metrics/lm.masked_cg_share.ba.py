"""lm.masked_cg_share.ba (%): the CG iterations that `ops.lm`'s blocks ran
masked (work wasted) against all that they ran, `cg_masked /
(cg_iterations + cg_masked)` over the window's BA stages."""


def read(run):
    rounds = [r for u in run["units"] if "shapes" in u for r in u["rounds"]]
    ran = sum(r["cg_iterations"] + r["cg_masked"] for r in rounds)
    if not ran:
        return None
    return 100.0 * sum(r["cg_masked"] for r in rounds) / ran
