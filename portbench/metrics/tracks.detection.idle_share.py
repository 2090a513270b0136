"""tracks.detection.idle_share (%): the share of the traced scenes'
detection (`tracks.detection` spans: the images' loads, the SIFT batches,
the keypoints' selection and writes) in which no operation ran on the
device: the spans' length less their overlap with the union of the device
operations, over their length (portbench/spans.py)."""

from portbench import spans


def read(run):
    return spans.idle_share(run, ("tracks.detection",))
