"""Tiny sizes of every cell, for the CPU tests (the widths and depths cut,
the traffic shrunk; the paths the same)."""

WAVENET = {"n_layers": 4, "n_loop": 2, "residual_channels": 16,
           "gate_channels": 16, "skip_out_channels": 8,
           "local_condition_dim": 8, "global_condition_dim": 4,
           "num_embeddings": 5, "embedding_dim": 4, "num_speakers": 8,
           "num_hiddens": 16}
CONV = {"num_hiddens": 16, "residual_channels": 16, "num_embeddings": 5,
        "embedding_dim": 4, "batch_size": 4}

OVERRIDES = {
    "wavenet-ar-c64": {"config": WAVENET, "traffic": {
        "clients": 3, "slots": 3, "chunk": 64, "max_frames": 3,
        "frames": [1, 3], "speakers": 8, "pool": 16, "check_requests": 2}},
    "vq44-train-b64": {"config": CONV, "traffic": {"pool_batches": 8}},
    "vq44-encode-bulk": {"config": CONV, "traffic": {
        "batch": 2, "batches_per_bucket": 2, "buckets": [800, 1600, 3200],
        "shortest": 400, "group": 2, "check_launches": 2}},
}
SEED = 2 ** 31 + 11


def run(workload, seconds=0.5, seed=SEED):
    """One run of ``workload`` at tiny size on the CPU: (line, checks)."""
    import torch

    from h100bench import harness

    torch.manual_seed(0)
    return harness.run_cell(workload, seed, seconds, 0, device="cpu",
                            overrides=OVERRIDES[workload],
                            log=lambda s: None)
