"""sift.device_ops_per_frame (ops/frame): the device operations that start
inside the traced scenes' `sift.batch` spans (`ops.sift`, one batch of
frames that the card holds at once), over those spans' frames: the SIFT's
launch count a frame (portbench/spans.py)."""

from portbench import spans


def read(run):
    return spans.ops_per_attr(run, "sift.batch", "frames")
