"""The share of the traced window in which nothing ran on the device: the
window less the union of the kernel, copy and set intervals."""

LAYER = "device"
UNIT = "%"
MOVES = "faces_per_s"


def read(run):
    return run.trace.idle_pct()
