"""PyTorch port: the multi-device modules (``vqvae_speech_tpu_torch.parallel``
and ``train/dcp_checkpoint.py``) in a gloo world of 4 CPU ranks, held
against the JAX package's own modules on its 8-device CPU mesh at the sizes
of ``tests/test_parallel.py``.

One world runs every check (``tests/torch_parallel_jobs.py:
parallel_modules``) while this process computes JAX's results; each test
then reads one part of what the ranks returned. Tolerances are JAX's own
tests': the sharded search's indices equal and its minima within 1e-4; the
tensor-parallel decode's logits within rtol 2e-5 / atol 1e-5 and its greedy
streams equal; the sequence-parallel core within rtol 2e-5 / atol 2e-6, its
loss within 1e-5 and its gradient within rtol 5e-4 / atol 1e-6.
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_training import TINY_CFG
from tests.torch_world import World
from vqvae_speech_tpu.parallel.mesh import make_mesh as jax_mesh
from vqvae_speech_tpu_torch import convert
from vqvae_speech_tpu_torch.models.clarinet import (
    GaussianWaveNetConfig as TeacherConfig,
)
from vqvae_speech_tpu_torch.models.wavenet import WaveNetConfig

WORLD = 4
TP_2WAY = dict(out_channels=32, layers=3, stacks=1, residual_channels=8,
               gate_channels=16, skip_out_channels=8, kernel_size=3,
               cin_channels=4, gin_channels=6, n_speakers=3,
               upsample_conditional_features=True, upsample_scales=(4,))
TP_4WAY = dict(out_channels=32, layers=4, stacks=2, residual_channels=16,
               gate_channels=32, skip_out_channels=16, kernel_size=2,
               cin_channels=4, gin_channels=-1,
               upsample_conditional_features=True, upsample_scales=(2, 2))
# the JAX meshes: the same model axis, the data axis filling the 8 devices
TP_CASES = {"2way": (TP_2WAY, 16, True, None, (4, 2)),
            "4way": (TP_4WAY, 24, False, None, (2, 4)),
            "2way_int8": (TP_2WAY, 16, True, "int8", (4, 2)),
            "4way_int8": (TP_4WAY, 20, False, "int8", (2, 4))}
SP_CORE = dict(num_blocks=2, num_layers=3, front_channels=8,
               residual_channels=8, gate_channels=8, skip_channels=8,
               kernel_size=3, cin_channels=6, upsample_scales=(4, 4))
SP_LOSS = dict(num_blocks=1, num_layers=2, front_channels=4,
               residual_channels=8, gate_channels=8, skip_channels=8,
               kernel_size=2, cin_channels=6, upsample_scales=(4, 4))
SP_HALO = dict(num_blocks=1, num_layers=6, front_channels=4,
               residual_channels=8, gate_channels=8, skip_channels=8,
               kernel_size=3, cin_channels=6, upsample_scales=(4, 4))


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tp_inputs():
    """Trees of ``wavenet_init``'s structure and init distributions drawn
    with numpy (``convert.numpy_wavenet_params``: JAX's init takes seconds a
    tree eagerly)."""
    cases = {}
    for name, (kw, T, speakers, wq, _) in TP_CASES.items():
        cases[name] = dict(
            cfg=kw, T=T, weight_quant=wq, mesh=name.split("_")[0],
            params=convert.numpy_wavenet_params(WaveNetConfig(**kw), 0),
            c=_normal(1, (2, T // 4, 4)),
            g=np.asarray([0, 2], np.int32) if speakers else None)
    return cases


def _tp_references(cases):
    from vqvae_speech_tpu.models.wavenet.model import WaveNetConfig as JaxConfig
    from vqvae_speech_tpu.parallel.tp_decode import (
        wavenet_incremental_generate_tp,
    )

    def one(name):
        case = cases[name]
        g = None if case["g"] is None else jnp.asarray(case["g"])
        out, emit = wavenet_incremental_generate_tp(
            jax.tree_util.tree_map(jnp.asarray, case["params"]),
            JaxConfig(**case["cfg"]), jax.random.PRNGKey(2), case["T"],
            jax_mesh(*TP_CASES[name][4]), c=jnp.asarray(case["c"]), g=g,
            sample=False, weight_quant=case["weight_quant"])
        return np.asarray(out), np.asarray(emit)

    # four compiles, which overlap in threads
    with concurrent.futures.ThreadPoolExecutor(len(cases)) as pool:
        return dict(zip(cases, pool.map(one, cases)))


def _sp_inputs():
    out = {}
    for key, kw, (B, T), scale in (("core", SP_CORE, (2, 512), 1.0),
                                   ("loss", SP_LOSS, (2, 256), 0.1)):
        out[key] = dict(cfg=kw, params=convert.numpy_gaussian_wavenet_params(
            TeacherConfig(**kw), 0), x=_normal(1, (B, T, 1), scale),
            c=_normal(2, (B, T, 6)))
    out["halo"] = dict(cfg=SP_HALO, params=convert.numpy_gaussian_wavenet_params(
        TeacherConfig(**SP_HALO), 0))
    return out


def _sp_references(case):
    from vqvae_speech_tpu.models.clarinet import GaussianWaveNetConfig
    from vqvae_speech_tpu.parallel.sp_vocoder import (
        sp_gaussian_wavenet_core,
        sp_teacher_loss,
    )

    mesh = jax_mesh(num_data=WORLD, num_model=1)
    core = case["core"]
    cfg = GaussianWaveNetConfig(**core["cfg"])
    ref_core = jax.jit(lambda p, x, c: sp_gaussian_wavenet_core(
        p, cfg, x, c, mesh, axis="data"))(core["params"], core["x"], core["c"])
    lo = case["loss"]
    cfg_loss = GaussianWaveNetConfig(**lo["cfg"])
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, x, c: sp_teacher_loss(p, cfg_loss, x, c, mesh)))(
        lo["params"], lo["x"], lo["c"])
    return (np.asarray(ref_core), float(loss),
            [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)])


def _vq_references(inputs):
    from vqvae_speech_tpu.ops.vq import vq_distances
    from vqvae_speech_tpu.parallel.sharded_vq import (
        place_sharded_codebook,
        sharded_vq_search,
    )

    refs = {}
    for name, shape in (("vq2", (4, 2)), ("vq4", (2, 4))):
        flat, cb = (jnp.asarray(a) for a in inputs[name])
        mesh = jax_mesh(*shape)
        idx, mins = jax.jit(lambda f, c: sharded_vq_search(f, c, mesh))(
            flat, place_sharded_codebook(cb, mesh))
        dmin = np.asarray(vq_distances(flat, cb)).min(axis=1)
        refs[name] = (np.asarray(idx), np.asarray(mins), dmin)
    return refs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng0, rng1 = np.random.default_rng(0), np.random.default_rng(1)
    inputs = {
        "vq2": (rng0.standard_normal((96, 64)).astype(np.float32),
                rng0.standard_normal((128, 64)).astype(np.float32)),
        "vq4": (rng1.standard_normal((48, 16)).astype(np.float32),
                rng1.standard_normal((64, 16)).astype(np.float32)),
        "tp": _tp_inputs(), "sp": _sp_inputs(),
        "dcp": {"cfg": dict(TINY_CFG)}}
    with World("tests.torch_parallel_jobs:parallel_modules", WORLD, inputs,
               tmp_path_factory.mktemp("world4")) as ranks:
        refs = {"tp": _tp_references(inputs["tp"]),
                "sp": _sp_references(inputs["sp"]),
                "vq": _vq_references(inputs)}
        return inputs, refs, ranks.join(deadline=90.0)


def test_mesh_shapes_and_configuration(world):
    _, _, outs = world
    for out in outs:
        assert out["shapes"] == [{"data": 2, "model": 2},
                                 {"data": 1, "model": 4},
                                 {"data": 4, "model": 1}]
        # (data axis, use_data_parallel, a mesh, the backend)
        assert out["mesh_configuration"] == [(4, True, True, "gloo"),
                                             (1, False, False, "gloo"),
                                             (2, True, True, "gloo")]


def test_shard_batch_and_replicate(world):
    _, _, outs = world
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out["shard"], x[rank * 4:rank * 4 + 4])
        d = rank // 2                      # rank = data * 2 + model
        np.testing.assert_array_equal(out["shard_22"], x[d * 8:d * 8 + 8])
        assert "does not divide" in out["indivisible"]
        # data rank 0 of the rank's data group is its model index
        np.testing.assert_array_equal(out["replicated"],
                                      np.full(3, rank % 2, np.float32))


def test_all_gather_rows_and_its_gradient(world):
    """The gather is in rank order, and its backward sums every rank's
    gradient of the gathered rows into each rank's own block."""
    _, _, outs = world
    want = np.repeat(np.arange(WORLD, dtype=np.float32), 2)[:, None] * \
        np.ones((1, 3), np.float32)
    weights = np.arange(1.0, 9.0, dtype=np.float32)
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out["gathered"], want)
        # rank r's loss: (r + 1) * sum_i weights[i] * row_i
        block = weights[rank * 2:rank * 2 + 2, None] * sum(range(1, 5))
        np.testing.assert_array_equal(out["gather_grad"],
                                      np.broadcast_to(block, (2, 3)))


@pytest.mark.parametrize("name", ["vq2", "vq4"])
def test_sharded_search_matches_jax(world, name):
    _, refs, outs = world
    idx_ref, mins_ref, dmin = refs["vq"][name]
    for out in outs:
        idx, mins = out[name]
        np.testing.assert_array_equal(idx, idx_ref)
        np.testing.assert_allclose(mins, mins_ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(mins, dmin, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", list(TP_CASES))
def test_tensor_parallel_decode_matches_jax(world, name):
    """The port's decode sharded 2 and 4 ways over its model axis against
    JAX's over its own; every rank holds the same streams, which are the
    port's single-device decode's."""
    _, refs, outs = world
    out_ref, emit_ref = refs["tp"][name]
    for out in outs:
        got, emitted, single = out["tp"][name]
        np.testing.assert_allclose(got, out_ref, rtol=2e-5, atol=1e-5)
        np.testing.assert_array_equal(emitted, emit_ref)
        np.testing.assert_array_equal(emitted, single)


def test_tensor_parallel_server_serves_the_single_device_waves(world):
    _, _, outs = world
    for out in outs:
        waves = out["tp"]["server"]
        assert [len(w) for w in waves["tp"]] == [16, 12, 24]
        for tp, single in zip(waves["tp"], waves["single"]):
            np.testing.assert_array_equal(tp, single)


def test_tensor_parallel_server_refuses_what_jax_refuses(world):
    """Sampling and a bf16 compute dtype raise ValueError over a model axis
    of more than one rank, as in the JAX server; so does int8_block, which
    the JAX decode does not shard."""
    _, _, outs = world
    for out in outs:
        sample, bf16, block = out["tp"]["server_refused"]
        assert "greedy" in sample and "compute_dtype" in bf16
        assert "int8_block" in block


def test_sequence_parallel_core_matches_jax(world):
    _, refs, outs = world
    got = np.concatenate([out["sp"]["core"] for out in outs], axis=1)
    np.testing.assert_allclose(got, refs["sp"][0], rtol=2e-5, atol=2e-6)


def test_sequence_parallel_loss_and_gradient_match_jax(world):
    """The loss's pairs cross every rank's last sample; the gradient
    reaches the previous rank through the halo's backward."""
    _, refs, outs = world
    _, loss_ref, grads_ref = refs["sp"]
    for out in outs:
        np.testing.assert_allclose(out["sp"]["loss"], loss_ref, rtol=1e-5)
        got = np.concatenate([g.ravel() for g in out["sp"]["grads"]])
        want = np.concatenate([g.ravel() for g in grads_ref])
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=1e-6)


def test_sequence_parallel_halo_too_large_raises(world):
    _, _, outs = world
    for out in outs:
        assert "exceeds the local block of 32 samples" in out["sp"]["halo"]


def test_dcp_round_trip_across_ranks(world):
    """Every rank saves the replicated flagship-test-width train state; the
    newest epoch is found, and it comes back bit for bit both built from
    the checkpoint's metadata and restored into each rank's own tensors."""
    _, _, outs = world
    for out in outs:
        dcp = out["dcp"]
        assert dcp["epoch"] == 3 and dcp["path"] == "tiny_dcp/3"
        assert dcp["meta"] == ("tiny", 3, [{"loss": 1.5}], [3.0])
        assert dcp["leaves"] > 20
        assert all(dcp["plain_equal"]) and all(dcp["into_equal"])
        assert dcp["in_place"]


def test_dcp_round_trip_without_a_process_group(tmp_path):
    """``tests/test_orbax_checkpoint.py``'s round trip, in one process."""
    import torch

    from vqvae_speech_tpu_torch.train.dcp_checkpoint import (
        latest_checkpoint_epoch_dcp,
        load_checkpoint_dcp,
        save_checkpoint_dcp,
    )

    assert not torch.distributed.is_initialized()
    params = {"w": np.arange(6.0).reshape(2, 3), "b": np.ones(3)}
    model_state = {"vq": {"codebook": torch.full((4, 2), 0.5)}}
    opt_state = {"count": np.zeros((), np.int32)}
    losses = [{"loss": 1.0}, {"loss": 0.5}]
    assert latest_checkpoint_epoch_dcp(str(tmp_path), "exp") == (None, None)
    for epoch in (0, 1):
        save_checkpoint_dcp(str(tmp_path), "exp", epoch, params, model_state,
                            opt_state, losses, [2.0, 3.0])
    epoch, path = latest_checkpoint_epoch_dcp(str(tmp_path), "exp")
    assert epoch == 2 and path.endswith("exp_dcp/2")
    ckpt = load_checkpoint_dcp(str(tmp_path), "exp")
    assert ckpt["epoch"] == 2 and ckpt["experiment_name"] == "exp"
    np.testing.assert_array_equal(ckpt["params"]["w"].numpy(),
                                  np.arange(6.0).reshape(2, 3))
    assert ckpt["params"]["w"].dtype == torch.float64
    np.testing.assert_array_equal(
        ckpt["model_state"]["vq"]["codebook"].numpy(), np.full((4, 2), 0.5))
    assert ckpt["opt_state"]["count"].dtype == torch.int32
    assert ckpt["train_res_recon_error"] == losses
