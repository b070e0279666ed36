"""Device ms an encode launch of the kernels launched inside the program's
``encode.features`` span (MFCC+D+DD and the normalizer), over 12 launches
traced with CUDA activity (``h100bench/program_spans.py``, segment (b))."""
from h100bench import program_spans


def read(cell, traced):
    seg = program_spans.segment(cell)
    return None if seg is None else seg.device_ms_a_call("encode.features")
