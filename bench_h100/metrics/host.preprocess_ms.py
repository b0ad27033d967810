"""Mean host milliseconds of the service's `preprocess` (the crop and
alignment, the Delaunay topologies) a request, from the harness's span
around each call in the traced window."""

LAYER = "service host (eval/serving.py:ShadowRemovalService.preprocess)"
UNIT = "ms"
MOVES = "faces_per_s"
SPAN = "preprocess"


def read(run):
    ms = run.spans.durations_ms(SPAN)
    return sum(ms) / len(ms) if ms else None
