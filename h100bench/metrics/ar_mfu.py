"""The AR loop's share of the f32 peak (%): the FLOPs of the samples the
traced steps delivered (layer stack and head a sample) and of the
admissions among them (upsampling and the per-layer projection of each
request's true samples), over the traced window's time, against
67 TFLOP/s."""
from h100bench import roofline


def read(cell, traced):
    if traced is None:
        return None
    s = cell.trace_stats
    flops = (s["samples"] * roofline.decode_sample_flops(cell.cfg)
             + roofline.admission_flops(cell.cfg, s["admitted_samples"]))
    return 100.0 * flops / traced.window_s / roofline.PEAK_F32_FLOPS
