"""lm.capture_share.ba (%): the share of a BA stage's wall spent capturing
the LM solve's CUDA graphs (`ops.lm`; the solver's `capture_s`, summed over
the stage's rounds), over all the window's stages."""


def read(run):
    units = [u for u in run["units"] if "shapes" in u]
    if not units:
        return None
    capture = sum(r["capture_s"] for u in units for r in u["rounds"])
    return 100.0 * capture / sum(u["wall_s"] for u in units)
