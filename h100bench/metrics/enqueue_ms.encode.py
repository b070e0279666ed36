"""Median host ms of one ``encode_batch`` call: the program's
``encode.batch`` span, the host's enqueue of a launch's features, encoder
and codebook search, over 12 launches with spans on and no profiler
(``h100bench/program_spans.py``, segment (a))."""
from h100bench import program_spans


def read(cell, traced):
    seg = program_spans.segment(cell)
    return None if seg is None else seg.median_host_ms("encode.batch")
