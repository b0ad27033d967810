"""Mean device milliseconds of the kernels launched inside each call of
`device_geometry_maps` (the harness's `geometry` range), over the traced
window."""

LAYER = "device geometry (geometry/triangulation.py:device_geometry_maps)"
UNIT = "ms"
MOVES = "faces_per_s"
RANGE = "geometry"


def read(run):
    calls = run.trace.calls(RANGE)
    if not calls:
        return None
    return 1e3 * run.trace.seconds_under(RANGE) / calls
