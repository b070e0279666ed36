"""PyTorch port: ``data.prefetch_to_device``.

On the CPU the loader's batches come out as tensors equal to them, with no
thread, and a loader's exception reaches the consumer. On a card (marker
``cuda``, skipped without one) each batch staged by the producer thread on
its side stream is bit-equal to the loader's numpy batch while the
consumer's stream is kept busy, and an exception in the loader is raised in
the consumer instead of ending the epoch early (the JAX package's producer
ends it silently).
"""
import threading

import numpy as np
import pytest
import torch

from vqvae_speech_tpu_torch.data import FeatureLoader, FeatureStore
from vqvae_speech_tpu_torch.data.prefetch import prefetch_to_device


def _loader(tmp_path, seed=0, n=23, batch_size=4):
    rng = np.random.default_rng(seed)
    store = FeatureStore(str(tmp_path))
    store.write("train", rng.standard_normal((n, 47, 39)).astype(np.float32),
                rng.standard_normal((n, 47, 39)).astype(np.float32),
                rng.integers(0, 8, n).astype(np.int32),
                preprocessed_audio=rng.uniform(-1, 1, (n, 7681)).astype(
                    np.float32))
    return lambda: FeatureLoader(store, "train", batch_size, seed=seed)


def _failing(batches, after):
    for i, batch in enumerate(batches):
        if i == after:
            raise OSError("the store went away")
        yield batch


def _assert_equal_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key, value in w.items():
            assert g[key].dtype == torch.from_numpy(value).dtype, key
            assert torch.equal(g[key].cpu(), torch.from_numpy(value)), key


def test_cpu_batches_are_the_loaders_as_tensors(tmp_path):
    make = _loader(tmp_path)
    threads = threading.active_count()
    got = list(prefetch_to_device(iter(make()), device="cpu"))
    assert threading.active_count() == threads
    _assert_equal_batches(got, list(make()))
    assert all(t.device.type == "cpu" for b in got for t in b.values())


def test_cpu_loader_exception_reaches_the_consumer(tmp_path):
    make = _loader(tmp_path)
    batches = prefetch_to_device(_failing(iter(make()), 2), device="cpu")
    assert len([next(batches), next(batches)]) == 2
    with pytest.raises(OSError, match="went away"):
        next(batches)


def test_prefetch_names_its_device(tmp_path):
    with pytest.raises(TypeError, match="device"):
        next(prefetch_to_device(iter(_loader(tmp_path)())))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    yield torch.device("cuda")


@pytest.mark.cuda
def test_cuda_batches_equal_the_loaders_under_a_busy_stream(tmp_path, cuda):
    make = _loader(tmp_path, n=64, batch_size=2)
    want = list(make())
    busy = torch.randn(2048, 2048, device=cuda)
    got = []
    for batch in prefetch_to_device(iter(make()), size=2, device=cuda):
        for _ in range(4):          # queue work ahead of the batch's use
            busy = torch.tanh(busy @ busy * 1e-3)
        assert all(t.is_cuda for t in batch.values())
        # a copy on the consumer's stream, after its wait on the staging
        got.append({k: v.clone() for k, v in batch.items()})
    torch.cuda.synchronize()
    _assert_equal_batches(got, want)


@pytest.mark.cuda
def test_cuda_loader_exception_reaches_the_consumer(tmp_path, cuda):
    make = _loader(tmp_path)
    seen = 0
    with pytest.raises(OSError, match="went away"):
        for _ in prefetch_to_device(_failing(iter(make()), 3), device=cuda):
            seen += 1
    assert seen == 3


@pytest.mark.cuda
def test_cuda_consumer_that_stops_early_ends_the_producer(tmp_path, cuda):
    make = _loader(tmp_path, n=64, batch_size=2)
    threads = threading.active_count()
    batches = prefetch_to_device(iter(make()), size=1, device=cuda)
    next(batches)
    batches.close()
    assert threading.active_count() == threads
