"""Share of the decode slots' steps that delivered a sample to a live
stream over the window (%): the harness's count of delivered samples over
steps x slots x chunk."""


def read(cell, traced):
    rec = getattr(cell, "rec", None)
    if not rec or not rec["slot_steps"]:
        return None
    return 100.0 * rec["samples"] / rec["slot_steps"]
