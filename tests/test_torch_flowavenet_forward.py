"""PyTorch port: FloWaveNet's MLE half (``flowavenet_forward``,
``actnorm_initialize``) against the JAX package's, on
the same numpy weights (``convert.numpy_flowavenet_params``: non-zero zero
convs and ActNorms, so every coupling reaches the result) at the vocoder
CLI's --tiny widths with a split after block 0 (so the prior runs). The
eager (op by op) JAX forward compiles every primitive at each new shape;
one flow a block keeps it to seconds.

Tolerances: f32 forward (log_p, logdet) rtol 1e-5; the ActNorm init's loc
(minus a mean of values of order 1 over 1024-2048 rows, some channels' near
0) within 1e-6, its scale (1 / an unbiased std) rtol 1e-5: sums in another
order, and torch splits them over threads. bf16: the
port rounds op by op as JAX's eager bf16 does, so its forward is held to
JAX's under ``jax.disable_jit()`` within 2e-6 relative (JAX's jitted bf16
keeps f32 inside XLA's fusions: tests/test_torch_flow_train.py holds the
steps to it). The flow's train steps are in tests/test_torch_flow_train.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vocoder_train import (  # noqa: F401
    FLOW,
    one_torch_thread,
)
from vqvae_speech_tpu.models.flowavenet import model as jax_model
from vqvae_speech_tpu_torch import convert
from vqvae_speech_tpu_torch.models.flowavenet import model


def inputs(T=1024, B=2):
    rng = np.random.default_rng(1)
    c = rng.random((B, T // 256, 80)).astype(np.float32)
    x = (0.3 * rng.standard_normal((B, T, 1))).astype(np.float32)
    return x, c


def trees():
    tree = convert.numpy_flowavenet_params(model.FlowavenetConfig(**FLOW), 0)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            convert.tensor_tree(tree, "cpu"))


def jax_forward(x, c, compute_dtype=None, eager=False):
    jtree, _ = trees()
    cfg = jax_model.FlowavenetConfig(**FLOW)
    fn = jax.jit(lambda p, x, c: jax_model.flowavenet_forward(
        p, cfg, x, c, compute_dtype=compute_dtype))
    with jax.enable_x64(False):
        if eager:
            with jax.disable_jit():
                out = fn(jtree, jnp.asarray(x), jnp.asarray(c))
        else:
            out = fn(jtree, x, c)
    return np.array([float(v) for v in out])


def port_forward(x, c, compute_dtype=None):
    _, ttree = trees()
    out = model.flowavenet_forward(ttree, model.FlowavenetConfig(**FLOW),
                                   torch.from_numpy(x), torch.from_numpy(c),
                                   compute_dtype=compute_dtype)
    assert all(v.dtype == torch.float32 and v.dim() == 0 for v in out)
    return np.array([float(v) for v in out])


def test_forward_f32_matches_jax():
    x, c = inputs()
    np.testing.assert_allclose(port_forward(x, c), jax_forward(x, c),
                               rtol=1e-5)


def test_forward_bf16_rounds_as_jax():
    x, c = inputs()
    got = port_forward(x, c, torch.bfloat16)
    eager = jax_forward(x, c, jnp.bfloat16, eager=True)
    np.testing.assert_allclose(got, eager, rtol=2e-6)


def test_forward_takes_gradients_to_every_leaf():
    """Every leaf but each net's last residual conv (whose output no later
    layer reads: jax.grad gives it zeros) gets a finite gradient."""
    x, c = inputs()
    _, ttree = trees()
    ttree = convert.tensor_tree(ttree, "cpu", requires_grad=True)
    log_p, logdet = model.flowavenet_forward(
        ttree, model.FlowavenetConfig(**FLOW), torch.from_numpy(x),
        torch.from_numpy(c))
    (-(log_p + logdet)).backward()
    paths, _ = jax.tree_util.tree_flatten_with_path(
        ttree, is_leaf=lambda t: isinstance(t, torch.Tensor))
    unused = [jax.tree_util.keystr(p) for p, t in paths if t.grad is None]
    assert all(t.grad is None or torch.isfinite(t.grad).all()
               for _, t in paths)
    assert unused and all("['res_blocks'][1]['res_conv']" in p
                          or "['res_blocks'][0]['res_conv']" in p
                          for p in unused), unused


def test_actnorm_initialize_matches_jax():
    x, c = inputs(T=2048)
    jtree, ttree = trees()
    cfg = jax_model.FlowavenetConfig(**FLOW)
    with jax.enable_x64(False):
        want = jax.jit(lambda p, x, c: jax_model.actnorm_initialize(
            p, cfg, x, c))(jtree, x, c)
    got = model.actnorm_initialize(ttree, model.FlowavenetConfig(**FLOW),
                                   torch.from_numpy(x), torch.from_numpy(c))
    for i in range(FLOW["n_block"]):
        for f in range(FLOW["n_flow"]):
            for name, tol in (("loc", dict(rtol=0, atol=1e-6)),
                              ("scale", dict(rtol=1e-5))):
                w = np.asarray(want["blocks"][i]["flows"][f]["actnorm"][name])
                g = got["blocks"][i]["flows"][f]["actnorm"][name].numpy()
                np.testing.assert_allclose(g, w, **tol)
            # every other leaf is the tree's own
            assert (got["blocks"][i]["flows"][f]["coupling"]
                    is ttree["blocks"][i]["flows"][f]["coupling"])
    # and the initialised flow maps the batch to unit scale at block 0
    assert not torch.equal(got["blocks"][0]["flows"][0]["actnorm"]["scale"],
                           ttree["blocks"][0]["flows"][0]["actnorm"]["scale"])


@pytest.mark.parametrize("bad", ["float16", "blocks"])
def test_forward_refuses(bad):
    x, c = inputs()
    _, ttree = trees()
    cfg = model.FlowavenetConfig(**FLOW)
    if bad == "float16":
        with pytest.raises(ValueError, match="compute_dtype"):
            model.flowavenet_forward(ttree, cfg, torch.from_numpy(x),
                                     torch.from_numpy(c), torch.float16)
    else:
        ttree["blocks"] = ttree["blocks"][:1]
        with pytest.raises(ValueError, match="blocks"):
            model.flowavenet_forward(ttree, cfg, torch.from_numpy(x),
                                     torch.from_numpy(c))
