"""On the card: a kernel launched inside one of the program's spans has its
launch call's stamp inside that span on the device trace's clock, the
backward's kernels too (launched from autograd's device thread while the
main thread waits in the span). Skips without a card; imports nothing of
JAX (run with ``--noconftest`` on the card)."""
import pytest
import torch

from vqvae_speech_tpu_torch.utils.profiling import annotate, trace


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_launch_stamps_fall_inside_their_spans(card):
    x = torch.zeros(1024, device="cuda")
    torch.cuda.synchronize()
    with trace(None) as t:
        for i in range(64):
            with annotate("launch", i):
                x.add_(1.0)
    launches = sorted(r.launch_ns for r in t.records)
    assert len(t.records) == len(t.spans) == 64
    assert None not in launches
    for span, launch in zip(sorted(t.spans, key=lambda s: s.start_ns),
                            launches):
        assert span.start_ns <= launch <= span.end_ns, (
            launch - span.start_ns, span.end_ns - launch)


@pytest.mark.cuda
def test_backward_launches_fall_inside_the_backward_span(card):
    conv = torch.nn.Conv1d(64, 64, 3, padding=1).cuda()
    x = torch.randn(8, 64, 256, device="cuda", requires_grad=True)
    conv(x).square().mean().backward()
    torch.cuda.synchronize()
    with trace(None) as t:
        with annotate("fwd"):
            loss = conv(x).square().mean()
        with annotate("bwd"):
            torch.autograd.grad(loss, [x, conv.weight, conv.bias])
    spans = {s.name: s for s in t.spans}
    seen = {"fwd": 0, "bwd": 0}
    for r in t.records:
        assert r.launch_ns is not None, r.name
        inside = [n for n, s in spans.items()
                  if s.start_ns <= r.launch_ns <= s.end_ns]
        assert len(inside) == 1, (r.name, inside)
        seen[inside[0]] += 1
    assert seen["fwd"] >= 2 and seen["bwd"] >= 2, seen
