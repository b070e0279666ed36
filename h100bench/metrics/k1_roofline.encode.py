"""K1's share of its roofline (%) in the encode launches: each traced
search's bound (N = batch x latent frames rows, K codes of width D; bytes
bound at these shapes) over K1's device time, its launches held to the
wrapper's count."""
from h100bench import roofline


def read(cell, traced):
    if traced is None:
        return None
    seconds = traced.seconds_of("vq_search_kernel") + \
        traced.seconds_of("vq_stats_kernel")
    launches = traced.launches_of("vq_search_kernel")
    if not seconds:
        return None
    if launches != cell.trace_stats["k1_launches"]:
        raise RuntimeError(f"the trace shows {launches} K1 launches, the "
                           f"wrapper counted {cell.trace_stats['k1_launches']}")
    cfg = cell.cfg
    bound = 0.0
    for j in cell.trace_stats["launches"]:
        B, _, T2 = cell.launch_shape(j)
        bound += roofline.k1_bound(B * T2, cfg["num_embeddings"],
                                   cfg["embedding_dim"])
    return 100.0 * bound / seconds
