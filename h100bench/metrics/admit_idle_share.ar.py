"""Share of the device's idle time that falls inside admissions (%): the
idle gaps charged to the program's ``ar.admit`` spans over all the idle of
6 chunks traced with CUDA activity (``h100bench/program_spans.py``,
segment (b))."""
from h100bench import program_spans


def read(cell, traced):
    seg = program_spans.segment(cell)
    if seg is None:
        return None
    idle = seg.attribution.idle_ms
    total = sum(idle.values())
    return 100.0 * idle.get("ar.admit", 0.0) / total if total else None
