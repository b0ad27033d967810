"""Share of the window in which the frontend's collector thread was in the
service's `preprocess` or `stage`, timed from outside by the open-loop
driver's host-clock wrappers (harness/clock.py)."""

LAYER = "frontend (eval/serving.py:BatchingFrontend)"
UNIT = "%"
MOVES = "latency_p50_ms"


def read(run):
    threads = run.window.get("threads")
    return 100.0 * threads["collector_busy"] if threads else None
