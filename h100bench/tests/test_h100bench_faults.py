"""The check sees a broken timed path: each cell at tiny size on the CPU,
the harness's look for a chip skipped, with a fault planted in the program
underneath, comes out not correct; unbroken, it comes out correct."""
import pytest
import torch

from h100bench.tests import tiny


def test_unbroken_runs_are_correct():
    for cell in tiny.OVERRIDES:
        line, _ = tiny.run(cell)
        assert line["correct"], (cell, line["checks"])


def _alter_tokens(monkeypatch):
    from vqvae_speech_tpu_torch import serve
    orig = serve.decode_chunk

    def broken(*args, **kwargs):
        state, emitted = orig(*args, **kwargs)
        emitted = emitted.clone()
        emitted[:, ::5] = (emitted[:, ::5] + 1) % 256
        return state, emitted
    monkeypatch.setattr(serve, "decode_chunk", broken)


def _stale_state(monkeypatch):
    from vqvae_speech_tpu_torch import serve
    orig = serve.decode_chunk

    def broken(prep, state, *args, **kwargs):
        with torch.inference_mode():
            ring = state["ring"].clone()
        state, emitted = orig(prep, state, *args, **kwargs)
        with torch.inference_mode():
            state["ring"].copy_(ring)      # the history never advances
        return state, emitted
    monkeypatch.setattr(serve, "decode_chunk", broken)


def _unchanged_step(monkeypatch):
    from vqvae_speech_tpu_torch.train import trainer
    monkeypatch.setattr(trainer.Amsgrad, "update",
                        lambda self, params, grads, state: None)


def _half_batch(monkeypatch, module, name):
    orig = getattr(module, name)

    def make(*args, **kwargs):
        step = orig(*args, **kwargs)

        def half(state, batch, **kw):
            return step(state, {k: v[:v.shape[0] // 2]
                                for k, v in batch.items()}, **kw)
        return half
    monkeypatch.setattr(module, name, make)


def _flagship_half(monkeypatch):
    from vqvae_speech_tpu_torch.train import trainer
    _half_batch(monkeypatch, trainer, "make_train_step")


def _alter_codes(monkeypatch):
    from vqvae_speech_tpu_torch import serve
    orig = serve.BucketedEncodeServer.encode_batch

    def broken(self, waves):
        codes = orig(self, waves).clone()
        codes[:, ::3] = (codes[:, ::3] + 1) % self.model.vq.codebook.shape[0]
        return codes
    monkeypatch.setattr(serve.BucketedEncodeServer, "encode_batch", broken)


def _encode_half(monkeypatch):
    from vqvae_speech_tpu_torch import serve
    orig = serve.BucketedEncodeServer.encode_batch

    def broken(self, waves):
        codes = orig(self, waves[:waves.shape[0] // 2])
        return torch.cat([codes, torch.zeros_like(codes)])
    monkeypatch.setattr(serve.BucketedEncodeServer, "encode_batch", broken)


FAULTS = [
    ("wavenet-ar-c64", "token altered", _alter_tokens),
    ("wavenet-ar-c64", "state unchanged", _stale_state),
    ("vq44-train-b64", "state unchanged", _unchanged_step),
    ("vq44-train-b64", "half of the batch", _flagship_half),
    ("vq44-encode-bulk", "answer altered", _alter_codes),
    ("vq44-encode-bulk", "half of the batch", _encode_half),
]


@pytest.mark.parametrize("cell,fault,plant", FAULTS,
                         ids=[f"{c}-{f}" for c, f, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(monkeypatch, cell, fault, plant):
    plant(monkeypatch)
    line, checks = tiny.run(cell)
    assert not line["correct"], (fault, checks)
