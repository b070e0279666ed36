"""Double-buffered host->device input pipeline.

Counterpart of ``vqvae_speech_tpu/data/prefetch.py``: while the current step
runs, a background thread stages the next batches on the GPU.

On CUDA the producer thread copies each batch of numpy arrays into pinned
host memory, issues the host-to-device copies on a side stream and records an
event after them. The consumer makes its current stream wait on that event
before it hands the batch out, and marks each tensor as used on that stream
(``record_stream``), so the caching allocator does not give the memory of a
batch to another tensor while the consumer's work on it is still queued.

On the CPU the batch is handed over as tensors (``torch.from_numpy``); there
is no thread and no stream.

One repair of the JAX package's behaviour: its producer puts the end marker
in a ``finally``, so an exception in the loader ends the epoch early and
silently. Here the producer passes the exception on and the consumer raises
it.
"""
import queue
import threading

import torch

from vqvae_speech_tpu_torch.utils import resolve_device

_END = object()


def _as_tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def prefetch_to_device(iterator, size: int = 2, *, device):
    """Wrap an iterator of dict batches of numpy arrays; yields dicts of
    tensors on ``device`` ("cuda", or "cpu" when the caller asks for it),
    with up to ``size`` batches staged ahead on a GPU."""
    device = resolve_device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield _as_tensors(batch)
        return

    q = queue.Queue(maxsize=size)
    stop = threading.Event()
    side = torch.cuda.Stream(device=device)

    def put(item):
        # gives up once the consumer is gone, so the thread ends with it
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            with torch.cuda.device(device), torch.cuda.stream(side):
                for batch in iterator:
                    staged = {k: v.pin_memory().to(device, non_blocking=True)
                              for k, v in _as_tensors(batch).items()}
                    ready = torch.cuda.Event()
                    ready.record(side)
                    if not put((staged, ready)):
                        return
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)
            return
        put(_END)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, BaseException):
                raise item
            staged, ready = item
            stream = torch.cuda.current_stream(device)
            stream.wait_event(ready)
            for tensor in staged.values():
                tensor.record_stream(stream)
            yield staged
    finally:
        stop.set()
        thread.join()
