"""The train step's share of the f32 peak (%): forward and backward FLOPs
of a step from the configuration's shapes (three times the forward, less
the first conv's input gradient) times the traced steps, over the traced
window, against 67 TFLOP/s."""
from h100bench import roofline


def read(cell, traced):
    if traced is None:
        return None
    flops = cell.step_flops() * cell.trace_stats["steps"]
    return 100.0 * flops / traced.window_s / roofline.PEAK_F32_FLOPS
