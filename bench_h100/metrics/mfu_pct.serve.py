"""The whole served path's share of the card's dense bf16 peak: the
generator's FLOPs a face (a served request, or a video frame of the TSM
generator's clip; counted on the benchmark's plain reference at the
cell's shapes) times the faces returned in the traced window, over the
window, against 989 TFLOP/s."""

from bench_h100.harness.device import PEAK_BF16_FLOPS

LAYER = "generator (models/generator.py, models/blocks.py)"
UNIT = "%"
MOVES = "faces_per_s"


def read(run):
    units = run.window.get("units", 0)
    if not units:
        return None
    flops = run.cell.driver.flops_per_unit(run)
    return 100.0 * flops * units / run.window["window_s"] / PEAK_BF16_FLOPS
