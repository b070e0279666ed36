"""On the card: the control (the plain reference in the program's place,
computed in the precision below the configuration's own: TF32 for an f32
configuration) comes out not correct at each cell's own size, and the
program, checked the same way in the same process, correct. Skips without
a card."""
import pytest

from h100bench import harness

CELLS = sorted(w["name"] for w in harness.benchmark()["workloads"])
SECONDS = {"wavenet-ar-c64": 10.0}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_lower_precision_control_is_not_correct(card, cell):
    from h100bench import calibrate

    ctx = harness.Context(cell, 0, "cuda")
    got = calibrate.readings(cell, 2 ** 31 + 99, SECONDS.get(cell, 1.0),
                             ["control"])
    program = harness.compare(got["program"], ctx.limits)
    control = harness.compare(got["control"], ctx.limits)
    assert all(c[3] for c in program), program
    assert not all(c[3] for c in control), control
