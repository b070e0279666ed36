"""PyTorch port: 3 FloWaveNet train steps (``train/vocoder.py::
make_flow_train_step``: loss -(log_p + logdet), clip 1, StepLR) against
the JAX package's in f32 (bf16: tests/test_torch_flow_train_bf16.py; the
two JAX compiles in one file ran over a minute under the Tier-1 command's
six workers), on the --tiny widths with a split after block 0 (numpy
weights with non-zero zero convs: every coupling and the prior train). The
runs, the gradient recovery from the first moments and the tolerances are
tests/test_torch_vocoder_train.py's. Also the flow's checkpoints resumed
across the packages, as tests/test_torch_vocoder_trainer.py does the
teacher's.
"""
import numpy as np

from tests.test_torch_vocoder_train import (  # noqa: F401
    assert_gradients_close,
    assert_parameters_close,
    gradients,
    jax_run,
    one_torch_thread,
    port_run,
)
from tests.test_torch_vocoder_trainer import (  # noqa: F401
    data_root,
    resume_across_the_packages,
)


def test_f32_flow_steps_follow_jax():
    want, got = jax_run("flow"), port_run("flow")
    for t, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=2e-6)
        assert_parameters_close(g["params"], w["params"], f"step {t}")
        # the flow step keeps no EMA: the shadow stays the initial tree
        assert_parameters_close(g["ema"], w["ema"], f"step {t}")
        np.testing.assert_array_equal(g["ema"][0], got[0]["ema"][0])
    assert_gradients_close(gradients(got), gradients(want))


def test_flow_resumes_across_the_packages(data_root, tmp_path):
    resume_across_the_packages("flow", data_root, tmp_path)
