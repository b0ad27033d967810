"""Requests a dispatched batch carried over the traced window: the
frontend's own counters, `requests_served` over `batches_dispatched`,
taken as their change across the window."""

LAYER = "frontend (eval/serving.py:BatchingFrontend)"
UNIT = "requests"
MOVES = "latency_p50_ms"


def read(run):
    batches = run.window.get("batches", 0)
    return run.window["served"] / batches if batches else None
