"""K2's share of its roofline (%): the bound of the traced steps (the
larger of the layer stack's operations at all slots over the f32 peak and
its bytes, weights read once a step, over the HBM peak) over K2's device
time in the trace, its launches held to the wrapper's count."""
from h100bench import roofline


def read(cell, traced):
    if traced is None:
        return None
    seconds = traced.seconds_of("step_kernel")
    launches = traced.launches_of("step_kernel")
    if not seconds:
        return None
    if launches != cell.trace_stats["k2_launches"]:
        raise RuntimeError(f"the trace shows {launches} K2 launches, the "
                           f"wrapper counted {cell.trace_stats['k2_launches']}")
    cfg = cell.cfg
    bound = roofline.k2_bound(cfg["n_layers"], cfg["filter_size"],
                              cfg["residual_channels"], cfg["gate_channels"],
                              cfg["skip_out_channels"], cell.t["slots"])
    return 100.0 * bound * cell.trace_stats["steps"] / seconds
