"""The 95th percentile of the traced window's request latencies, each from
when the request was due to when its future held the result (the
open-loop driver's): the tail that the end-to-end median sits under.  It
swings with the host's speed, by more than a check's bound can hold, so
it is read here and not held to a bound."""

import numpy as np

LAYER = "frontend (eval/serving.py:BatchingFrontend)"
UNIT = "ms"
MOVES = "latency_p50_ms"


def read(run):
    lat = run.window.get("latency_ms")
    return float(np.percentile(lat, 95)) if lat is not None and len(lat) \
        else None
