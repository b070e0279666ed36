"""PyTorch port: 3 FloWaveNet train steps at ``compute_dtype`` bf16 against
the JAX package's bf16 step (the f32 steps: tests/test_torch_flow_train.py),
on the same widths, weights and batch; the runs and the tolerances are
tests/test_torch_vocoder_train.py's: the loss within a bf16 ulp, the
gradients within 1.5 times JAX's own bf16-vs-f32 spread.
"""
from tests.test_torch_vocoder_train import (  # noqa: F401
    assert_bf16_gradients_within_jax_spread,
    jax_run,
    one_torch_thread,
    port_run,
)


def test_bf16_flow_steps_within_jax_spread():
    jf, jb, pb = jax_run("flow"), jax_run("flow", True), port_run("flow", True)
    for t in range(3):
        # within a bf16 ulp of the loss, 2**-8 relative
        assert abs(pb[t]["loss"] - jb[t]["loss"]) <= 2 ** -8 * abs(
            jb[t]["loss"]), t
    assert_bf16_gradients_within_jax_spread(jf, jb, pb)
