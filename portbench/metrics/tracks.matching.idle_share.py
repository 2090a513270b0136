"""tracks.matching.idle_share (%): the share of the traced scenes' matching
(`tracks.matching` spans: the F init, the pairs' preparation, staging, the
2-NN kernel's enqueue and drain, RANSAC and the UTM filter) in which no
operation ran on the device: the spans' length less their overlap with the
union of the device operations, over their length (portbench/spans.py)."""

from portbench import spans


def read(run):
    return spans.idle_share(run, ("tracks.matching",))
