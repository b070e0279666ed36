"""The encode launches' share of the f32 peak (%): features, encoder,
pre-VQ conv and search FLOPs of the traced launches from their shapes,
over the traced window, against 67 TFLOP/s."""
from h100bench import roofline


def read(cell, traced):
    if traced is None:
        return None
    flops = 0.0
    for j in cell.trace_stats["launches"]:
        B, T, _ = cell.launch_shape(j)
        flops += roofline.encode_flops(cell.cfg, T, B)
    return 100.0 * flops / traced.window_s / roofline.PEAK_F32_FLOPS
