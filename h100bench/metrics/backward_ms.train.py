"""Device ms a train step of the kernels launched inside the program's
``train.backward`` span (``_gradients``: autograd's backward, launched from
its device thread while the step waits in the span), over 20 steps traced
with CUDA activity (``h100bench/program_spans.py``, segment (b))."""
from h100bench import program_spans


def read(cell, traced):
    seg = program_spans.segment(cell)
    return None if seg is None else seg.device_ms_a_call("train.backward")
