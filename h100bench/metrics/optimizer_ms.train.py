"""Device ms a train step of the kernels launched inside the program's
``train.optimizer`` span (``Amsgrad.update``: the multi-tensor moment and
parameter updates), over 20 steps traced with CUDA activity
(``h100bench/program_spans.py``, segment (b))."""
from h100bench import program_spans


def read(cell, traced):
    seg = program_spans.segment(cell)
    return None if seg is None else seg.device_ms_a_call("train.optimizer")
