"""Median host ms of one admission into a decode slot: the program's
``ar.admit`` span (the zero-padded copy of the request's conditioning,
``slot_conditioning``'s upsample and hoist, ``admit_slot``), over the
admissions of 6 chunks with spans on and no profiler
(``h100bench/program_spans.py``, segment (a))."""
from h100bench import program_spans


def read(cell, traced):
    seg = program_spans.segment(cell)
    return None if seg is None else seg.median_host_ms("ar.admit")
