"""The hand-written CUDA codebook search (csrc/vq_search.cu) against its
plain PyTorch version, on the same CUDA tensors.

This file imports no JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_vq_kernel.py

(``--noconftest`` because tests/conftest.py configures JAX). The CUDA cases
skip without a CUDA device.

Tolerances: an index may differ from the plain search only at a near-tie,
where the two distances are within 1e-5 * (||z||^2 + 1) (the two sum in
another f32 order); quantized rows are exact copies; counts exact; dw within
rtol 1e-4 / atol 1e-4, the JAX package's own bound (tests/test_vq.py).
"""
import numpy as np
import pytest
import torch

from vqvae_speech_tpu_torch.ops import vq_search, vq_search_torch
from vqvae_speech_tpu_torch.ops._kernels import vq_search_cuda, vq_search_plan
from vqvae_speech_tpu_torch.ops.vq import vq_distances


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = old


def _inputs(N, K, D, seed, device):
    rng = np.random.default_rng(seed)
    flat = rng.standard_normal((N, D)).astype(np.float32)
    cb = rng.standard_normal((K, D)).astype(np.float32)
    return (torch.from_numpy(flat).to(device), torch.from_numpy(cb).to(device))


def _assert_matches_plain(flat, cb):
    got, want = vq_search(flat, cb), vq_search_torch(flat, cb)
    torch.cuda.synchronize()
    assert got.indices.dtype == torch.int32 and got.indices.is_cuda
    diff = (got.indices != want.indices).nonzero().flatten()
    d = vq_distances(flat[diff], cb)
    gap = (d.gather(1, got.indices[diff, None].long())
           - d.gather(1, want.indices[diff, None].long())).abs()
    assert bool((gap <= 1e-5 * (flat[diff].square().sum(1, keepdim=True) + 1))
                .all())
    torch.testing.assert_close(got.quantized, cb[got.indices.long()],
                               rtol=0, atol=0)
    if len(diff) == 0:
        torch.testing.assert_close(got.counts, want.counts, rtol=0, atol=0)
        torch.testing.assert_close(got.dw, want.dw, rtol=1e-4, atol=1e-4)
    return len(diff)


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,D", [
    (1, 44, 64),         # one row, a tile that is mostly padding
    (1536, 44, 64),      # the server's flagship launch
    (24576, 44, 64),     # bench.py's batch 1024 x 24 rows
    (1536, 1000, 64),    # partial statistics larger than shared memory
    (77, 5, 16),         # K below the 16 code groups; N off a tile
    (300, 3, 200),       # D not a multiple of 32 (stats column slices)
    (40, 11, 1024),      # a width that leaves room for 16-row tiles only
    (9000, 500, 64),     # two passes with 64-row tiles (a full card)
    (700, 37, 30),       # D off a multiple of 4: scalar reads
])
def test_kernel_matches_plain(cuda, N, K, D):
    flat, cb = _inputs(N, K, D, seed=N + K + D, device=cuda)
    assert _assert_matches_plain(flat, cb) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 7, 44, 1000])
@pytest.mark.parametrize("N", [1, 31, 32, 33, 1536, 24576])
@pytest.mark.parametrize("D", [64, 24])
def test_kernel_matches_plain_over_the_grid(cuda, N, K, D):
    """Tile edges (N around 32, one row), one code, a codebook under the 16
    code groups, the flagship's, and one on the two-pass side of the rule,
    at the templated width and at a runtime one."""
    flat, cb = _inputs(N, K, D, seed=N + K + D, device=cuda)
    _assert_matches_plain(flat, cb)
    got = vq_search(flat, cb)
    assert int(got.counts.sum().item()) == N
    assert int(got.indices.min()) >= 0 and int(got.indices.max()) < K


def _statistics_of_own_indices(got, flat, K):
    """The kernel's counts exact and its dw within rtol/atol 1e-5 of the
    plain sums over the kernel's own indices."""
    onehot = torch.nn.functional.one_hot(got.indices.long(), K).float()
    torch.testing.assert_close(got.counts, onehot.sum(0), rtol=0, atol=0)
    torch.testing.assert_close(got.dw, onehot.t() @ flat, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 8, 30, 40])
@pytest.mark.parametrize("N", [1, 64, 300, 600, 2000])
def test_kernel_matches_plain_at_d2(cuda, N, K):
    """The 2-D demos' width (examples/, models/vq_balanced.py,
    models/vq_adaptive.py): 8-byte rows, the scalar path with a row stride
    of D+1; one block writes its statistics straight out at N <= 64, more
    blocks sum partials after the grid barrier."""
    flat, cb = _inputs(N, K, 2, seed=N + K, device=cuda)
    _assert_matches_plain(flat, cb)
    got = vq_search(flat, cb)
    _statistics_of_own_indices(got, flat, K)
    assert int(got.counts.sum().item()) == N
    assert vq_search_plan(N, K, 2, cuda)["device_kernels"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("N", [300, 600, 2000])
def test_kernel_on_gathered_active_codes_at_d2(cuda, N):
    """The adaptive quantizer's masked search: active subsets of a 30-row
    codebook gathered in ascending order, the indices mapped back, against
    the argmin over the whole codebook with +inf on inactive codes (the JAX
    package's form); a differing row must be a near-tie."""
    rng = np.random.default_rng(N)
    flat, cb = _inputs(N, 30, 2, seed=N, device=cuda)
    for n_active in (1, 5, 17, 29, 30):
        active = torch.from_numpy(np.sort(rng.choice(30, n_active,
                                                     replace=False))).to(cuda)
        sub = cb[active]
        _assert_matches_plain(flat, sub)
        got = vq_search(flat, sub)
        _statistics_of_own_indices(got, flat, n_active)
        mapped = active[got.indices.long()]
        masked = torch.full((30,), float("inf"), device=cuda)
        masked[active] = 0.0
        want = torch.argmin(vq_distances(flat, cb) + masked, dim=1)
        diff = (mapped != want).nonzero().flatten()
        d = vq_distances(flat[diff], cb)
        gap = (d.gather(1, mapped[diff, None]) - d.gather(1, want[diff, None]))
        assert bool((gap.abs() <= 1e-5 * (flat[diff].square().sum(
            1, keepdim=True) + 1)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("K,fused", [(126, True), (127, False), (400, False),
                                     (401, False), (900, False)])
def test_both_sides_of_the_one_launch_rule(cuda, K, fused):
    """At D=64 the search is one launch up to K=126 and two passes above
    (csrc/vq_search.cu's header: a partial of at most 8192 floats; K=401 is
    where the partial would no longer fit in shared memory, K=900 where the
    codebook is K-tiled); all agree with the plain search, and the profiler
    sees that many device kernels a call."""
    from vqvae_speech_tpu_torch.utils.profiling import device_events

    plan = vq_search_plan(1536, K, 64, cuda)
    assert bool(plan["fused"]) is fused
    assert plan["device_kernels"] == (1 if fused else 2)
    flat, cb = _inputs(1536, K, 64, seed=K, device=cuda)
    _assert_matches_plain(flat, cb)
    # raises when the profiler loses device events in every window it takes
    ran = {e.key: e.count
           for e in device_events(lambda: vq_search(flat, cb))[1]}
    assert sum(ran.values()) == plan["device_kernels"], ran


@pytest.mark.cuda
@pytest.mark.parametrize("N,K", [(1536, 44), (24576, 44), (1536, 1000)])
def test_twenty_runs_are_bit_equal(cuda, N, K):
    """No float atomics: partial statistics are summed in a fixed order."""
    flat, cb = _inputs(N, K, 64, seed=3, device=cuda)
    first = vq_search(flat, cb)
    for _ in range(19):
        again = vq_search(flat, cb)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_side_stream_has_its_own_scratch(cuda):
    """Searches enqueued on two streams at once do not share partials: each
    stream's results equal the serial ones."""
    flat, cb = _inputs(24576, 44, 64, seed=5, device=cuda)
    want = vq_search(flat, cb)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    outs = []
    for _ in range(5):
        outs.append(vq_search(flat, cb))
        with torch.cuda.stream(side):
            outs.append(vq_search(flat, cb))
    torch.cuda.synchronize()
    for got in outs:
        for a, b in zip(want, got):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_exact_tie_takes_the_first_index(cuda):
    """Duplicate codebook rows give bit-equal distances: argmin's first
    index wins, across the kernel's code groups, passes and chunks too."""
    flat, cb = _inputs(256, 44, 64, seed=1, device=cuda)
    cb[37] = cb[2]
    cb[9] = cb[2]
    flat[:64] = cb[2] + 1e-3 * flat[:64]
    got = vq_search(flat, cb)
    assert bool((got.indices[:64] == 2).all())
    assert _assert_matches_plain(flat, cb) == 0
    # the K-tiled two-pass side: duplicates in a later pass and a later chunk
    flat, cb = _inputs(256, 1000, 64, seed=2, device=cuda)
    cb[50] = cb[3]
    cb[900] = cb[3]
    flat[:64] = cb[3] + 1e-3 * flat[:64]
    got = vq_search(flat, cb)
    assert bool((got.indices[:64] == 3).all())


@pytest.mark.cuda
def test_backward_on_cuda_matches_plain_autograd(cuda):
    flat, cb = _inputs(600, 29, 16, seed=7, device=cuda)
    grads = []
    for search in (vq_search, vq_search_torch):
        f = flat.clone().requires_grad_()
        c = cb.clone().requires_grad_()
        res = search(f, c)
        (res.quantized.square().sum() + 0.5 * (res.dw * res.dw).sum()).backward()
        grads.append((f.grad, c.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_launch_counter_and_no_fallback(cuda):
    flat, cb = _inputs(64, 44, 64, seed=2, device=cuda)
    before = vq_search_cuda.launches
    vq_search(flat, cb)
    assert vq_search_cuda.launches == before + 1
    vq_search_torch(flat, cb)
    assert vq_search_cuda.launches == before + 1
    with pytest.raises(ValueError, match="float32"):
        vq_search(flat.half(), cb.half())


def test_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only; the CPU path is the
    dispatching vq_search's plain chain."""
    flat, cb = _inputs(8, 4, 16, seed=0, device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        vq_search_cuda(flat, cb)
    got, want = vq_search(flat, cb), vq_search_torch(flat, cb)
    torch.testing.assert_close(got.indices, want.indices, rtol=0, atol=0)


@pytest.mark.cuda
def test_bf16_flagship_step_launches_the_kernel_once(cuda):
    """A train step at compute_dtype bfloat16 on the card (a narrow flagship
    configuration): K1 once a step on f32 copies of the bf16 latents and
    codebook, f32 metrics and parameters, and the first step on the CPU
    (the plain search on the same rounded rows): the bf16 terms equal, the
    f32 reconstruction loss and total within rtol 1e-5 (measured 1.2e-07 on
    an H100)."""
    from vqvae_speech_tpu_torch.convert import load_jax_params, numpy_params
    from vqvae_speech_tpu_torch.models import ConvVQVAE
    from vqvae_speech_tpu_torch.train import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    cfg = dict(input_features_filters=13, augment_input_features=True,
               output_features_filters=13, augment_output_features=True,
               num_hiddens=64, num_residual_layers=2, residual_channels=64,
               embedding_dim=16, num_embeddings=11, commitment_cost=0.25,
               decay=0.0, use_kaiming_normal=False, use_jitter=False,
               jitter_probability=0.12, use_speaker_conditioning=False,
               learning_rate=2e-4, compute_dtype="bfloat16")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 47, 39)).astype(np.float32))
    metrics = {}
    for device in ("cuda", "cpu"):
        model = load_jax_params(ConvVQVAE.from_config(cfg),
                                *numpy_params(cfg, 0))
        optimizer = make_optimizer(cfg["learning_rate"])
        state = create_train_state(model, optimizer, device=device)
        step = make_train_step(cfg, optimizer)
        batch = {"input_features": x.to(device),
                 "output_features": x.to(device)}
        vq_search_cuda.launches = 0
        firsts = []
        for _ in range(3):
            state, m = step(state, batch)
            firsts.append(m)
        assert vq_search_cuda.launches == (3 if device == "cuda" else 0)
        assert all(v.dtype == torch.float32 for v in m.values())
        assert all(p.dtype == torch.float32 for p in model.parameters())
        metrics[device] = {k: v.item() for k, v in firsts[0].items()}
    for name, value in metrics["cpu"].items():
        np.testing.assert_allclose(metrics["cuda"][name], value, rtol=1e-5,
                                   atol=1e-7, err_msg=name)


@pytest.mark.cuda
def test_wavenet_train_step_launches_the_kernel_once(cuda):
    """make_wavenet_train_step on the card at a narrow width, the f32 and
    the bf16 decoder: K1 once a step, finite f32 metrics; the f32 first
    step's metrics (from the same weights, cuDNN's TF32 off as the trainer
    sets it) equal the CPU's on the same dropout masks within rtol 1e-5
    (measured at most 2.3e-07 on an H100)."""
    from vqvae_speech_tpu_torch.convert import (
        load_wavenet_vqvae_params,
        numpy_wavenet_vqvae_params,
    )
    from vqvae_speech_tpu_torch.models import WaveNetVQVAE
    from vqvae_speech_tpu_torch.train import (
        create_wavenet_train_state,
        make_optimizer,
        make_wavenet_train_step,
    )

    cfg = dict(input_features_filters=13, augment_input_features=True,
               num_hiddens=16, num_residual_layers=2, residual_channels=8,
               embedding_dim=8, num_embeddings=7, commitment_cost=0.25,
               decay=0.0, use_kaiming_normal=False, use_jitter=False,
               jitter_probability=0.12, quantize=32, n_loop=2, n_layers=4,
               filter_size=2, gate_channels=8, skip_out_channels=8,
               global_condition_dim=6, local_condition_dim=16,
               learning_rate=2e-4, length=1920)
    rng = np.random.default_rng(0)
    batch = {"preprocessed_audio": np.clip(0.3 * rng.standard_normal(
                 (2, 1921)), -1, 1).astype(np.float32),
             "input_features": rng.standard_normal((2, 11, 39)).astype(
                 np.float32),
             "speaker_id": np.array([0, 3])}
    params, state, wcfg = numpy_wavenet_vqvae_params(cfg, 4, 0)
    masks = [torch.from_numpy(rng.random((2, 1920, 8)) < 0.95)
             for _ in range(4)]
    metrics = {}
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    for device, dtype in (("cuda", None), ("cuda", torch.bfloat16),
                          ("cpu", None)):
        model = load_wavenet_vqvae_params(WaveNetVQVAE(cfg, 4), params, state)
        optimizer = make_optimizer(cfg["learning_rate"])
        tstate = create_wavenet_train_state(model, optimizer, device=device)
        step = make_wavenet_train_step(cfg, wcfg, optimizer,
                                       compute_dtype=dtype)
        on = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        vq_search_cuda.launches = 0
        firsts = []
        for _ in range(2):
            tstate, m = step(tstate, on, dropout_masks=masks)
            firsts.append(m)
        assert vq_search_cuda.launches == (2 if device == "cuda" else 0)
        assert all(v.dtype == torch.float32 and bool(torch.isfinite(v))
                   for v in m.values())
        metrics[(device, dtype)] = {k: v.item() for k, v in firsts[0].items()}
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
    for name, value in metrics[("cpu", None)].items():
        np.testing.assert_allclose(metrics[("cuda", None)][name], value,
                                   rtol=1e-5, atol=1e-7, err_msg=name)
