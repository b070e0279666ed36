"""PyTorch port: the ConvVQVAE train step against the JAX package's.

Both sides start from the same ``conv_vqvae_init`` parameters and see the same
batches; the jitter masks (and, with revival, the permutations) of the JAX
step are recomputed here from its key splits (``train/trainer.py:126``,
``nn/layers.py:105-108``) and handed to the port's step.

Tolerances. One step's gradients: rtol 1e-4 / atol 1e-6 (the same f32 graph in
another framework's summation order). A trajectory of 5 steps: losses,
perplexity and the VQ terms rtol 2e-4; the codebook atol 2e-5 and every other
parameter atol 5e-5 at lr 2e-4, a quarter of one step (an Adam update is
``lr * m / (sqrt(v) + eps)``, so where a gradient element is near 1e-8 the
two frameworks' rounding can move a weight by a fraction of lr; differences
do not grow with the parameter's size). Codes after the last step: equal,
except where the two nearest codes are within 1e-4 * (||z||^2 + 1).
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from vqvae_speech_tpu.models import conv_vqvae_encode, conv_vqvae_init
from vqvae_speech_tpu.train import trainer as jtrainer
from vqvae_speech_tpu_torch.convert import (
    export_jax_params,
    jax_param_leaves,
    load_jax_params,
)
from vqvae_speech_tpu_torch.models import ConvVQVAE
from vqvae_speech_tpu_torch.train import (
    create_train_state,
    make_grad_stats_fn,
    make_optimizer,
    make_train_step,
)
from vqvae_speech_tpu_torch.train.trainer import _named_grad_entries

CFG = dict(
    input_features_filters=13,
    augment_input_features=True,
    output_features_filters=13,
    augment_output_features=True,
    num_hiddens=32,
    num_residual_layers=2,
    residual_channels=32,
    embedding_dim=16,
    num_embeddings=11,
    commitment_cost=0.25,
    decay=0.0,
    use_kaiming_normal=False,
    use_jitter=False,
    jitter_probability=0.12,
    use_speaker_conditioning=False,
    learning_rate=2e-4,
)
B, T = 4, 47
T_LAT = 24

VARIANTS = {
    "baseline": {},
    "jitter12": {"use_jitter": True},
    "ema": {"decay": 0.99, "use_jitter": True},
    "speaker": {"use_speaker_conditioning": True, "num_speakers": 5,
                "use_jitter": True},
    "weight_norm": {"use_kaiming_normal": True},
    "flow_gradient": {"use_jitter": True, "jitter_gradient_detach": False},
    # a fast usage EMA, so that unused codes fall under the threshold and
    # are re-seeded within the five steps
    "revival": {"codebook_revival": True, "revival_threshold": 0.05,
                "revival_usage_decay": 0.5, "use_jitter": True},
    "revival_ema": {"codebook_revival": True, "revival_threshold": 0.05,
                    "revival_usage_decay": 0.5, "decay": 0.99},
}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def batches(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((B, T, 39)).astype(np.float32)
        batch = {"input_features": x, "output_features": x}
        if cfg["use_speaker_conditioning"]:
            batch["speaker_id"] = rng.integers(
                0, cfg["num_speakers"], (B,)).astype(np.int32)
        out.append(batch)
    return out


def jax_step_draws(rng, cfg, n_rows):
    """What one JAX train step draws from ``state.rng``: the jitter's
    (replace, direction) and the revival permutation (or None)."""
    rng, sub = jax.random.split(rng)
    k_rep, k_dir = jax.random.split(sub)
    replace = jax.random.bernoulli(k_rep, 1.0 - cfg["jitter_probability"],
                                   (T_LAT,))
    direction = jnp.where(jax.random.bernoulli(k_dir, 0.5, (T_LAT,)), 1, -1)
    perm = None
    if cfg.get("codebook_revival"):
        _, rev_key = jax.random.split(rng)
        perm = np.array(jax.random.permutation(rev_key, n_rows))
    return ((torch.from_numpy(np.array(replace)),
             torch.from_numpy(np.asarray(direction).astype(np.int64))),
            None if perm is None else torch.from_numpy(perm))


def both_sides(cfg, seed=0, use_pallas=False):
    params, state = conv_vqvae_init(jax.random.PRNGKey(seed), cfg)
    joptimizer = jtrainer.make_optimizer(cfg["learning_rate"])
    jstate = jtrainer.create_train_state(jax.random.PRNGKey(7), params, state,
                                         joptimizer)
    jstep = jtrainer.make_train_step(cfg, joptimizer, use_pallas=use_pallas)
    model = load_jax_params(ConvVQVAE.from_config(cfg), numpy_tree(params),
                            numpy_tree(state))
    optimizer = make_optimizer(cfg["learning_rate"])
    tstate = create_train_state(model, optimizer, device="cpu")
    return jstate, jstep, tstate, make_train_step(cfg, optimizer)


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_params_close(model, jparams, jstate, cfg):
    params, state = export_jax_params(model)
    got = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    want = dict(jax.tree_util.tree_flatten_with_path(numpy_tree(jparams))[0])
    assert set(got) == set(want)
    for path, value in want.items():
        atol = 2e-5 if "codebook" in jax.tree_util.keystr(path) else 5e-5
        np.testing.assert_allclose(got[path], value, rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))
    for name, value in numpy_tree(jstate["vq"]).items():
        np.testing.assert_allclose(state["vq"][name], value, rtol=1e-5,
                                   atol=2e-5, err_msg=name)
    if cfg.get("codebook_revival"):
        np.testing.assert_allclose(state["revival"]["usage"],
                                   np.asarray(jstate["revival"]["usage"]),
                                   rtol=1e-5, atol=1e-7)


def assert_codes_equal_or_near_tie(model, jstate, cfg, x):
    want, z = conv_vqvae_encode(jstate.params, jstate.model_state,
                                jnp.asarray(x), cfg, training=False,
                                use_pallas=False, return_latents=True)
    model.eval()
    with torch.no_grad():
        got = model.encode(torch.from_numpy(x))
    model.train()
    got_idx = got.indices[:, 0].numpy()
    want_idx = np.asarray(want.indices)[:, 0]
    diff = np.nonzero(got_idx != want_idx)[0]
    if len(diff):
        d = got.distances.reshape(-1, cfg["num_embeddings"]).numpy()[diff]
        gap = np.abs(d[np.arange(len(diff)), got_idx[diff]]
                     - d[np.arange(len(diff)), want_idx[diff]])
        zz = np.asarray(z).transpose(2, 1, 0).reshape(
            -1, cfg["embedding_dim"])[diff]
        assert (gap <= 1e-4 * (np.square(zz).sum(1) + 1)).all()
    return len(diff)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_five_steps_follow_jax(variant):
    cfg = dict(CFG, **VARIANTS[variant])
    # one case runs the JAX side's Pallas kernel, in interpret mode on the
    # CPU as tests/test_vq.py runs it
    use_pallas = variant == "jitter12"
    jstate, jstep, tstate, tstep = both_sides(cfg, use_pallas=use_pallas)
    data = batches(cfg, 5)
    revived = 0.0
    for batch in data:
        masks, perm = jax_step_draws(jstate.rng, cfg, B * T_LAT)
        with (pltpu.force_tpu_interpret_mode() if use_pallas
              else contextlib.nullcontext()):
            jstate, want = jstep(jstate, jax_batch(batch))
        tstate, got = tstep(tstate, torch_batch(batch), jitter_masks=masks,
                            revival_perm=perm)
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name].item(), float(want[name]),
                                       rtol=2e-4, atol=1e-7, err_msg=name)
        revived += float(want.get("revived_codes", 0.0))
    assert tstate.opt_state.count == int(jstate.opt_state[0].count) == 5
    assert_params_close(tstate.model, jstate.params, jstate.model_state, cfg)
    assert_codes_equal_or_near_tie(tstate.model, jstate, cfg,
                                   data[0]["input_features"])
    if variant.startswith("revival"):
        assert revived > 0   # the case does re-seed codes


@pytest.mark.parametrize("variant", ["baseline", "ema", "weight_norm",
                                     "speaker", "flow_gradient"])
def test_one_step_gradients_match_jax(variant):
    """The port's gradients of one step, leaf by leaf under the JAX tree's
    names, against ``jax.grad`` of the same loss; the tied residual block's
    gradient is the sum over its applications in both."""
    cfg = dict(CFG, **VARIANTS[variant])
    jstate, _, tstate, _ = both_sides(cfg)
    batch = batches(cfg, 1)[0]
    masks, _ = jax_step_draws(jstate.rng, cfg, B * T_LAT)
    _, sub = jax.random.split(jstate.rng)

    def loss_fn(params):
        from vqvae_speech_tpu.models import conv_vqvae_apply
        out = conv_vqvae_apply(
            params, jstate.model_state, jnp.asarray(batch["input_features"]),
            cfg, training=True, rng=sub,
            speaker_ids=(jnp.asarray(batch["speaker_id"])
                         if "speaker_id" in batch else None),
            use_pallas=False)
        return out.vq_loss + jnp.mean(jnp.square(
            out.reconstructed_x - jnp.asarray(batch["output_features"])))

    want = dict(jax.tree_util.tree_flatten_with_path(
        numpy_tree(jax.grad(loss_fn)(jstate.params)))[0])
    model = tstate.model
    tb = torch_batch(batch)
    out = model(tb["input_features"], tb.get("speaker_id"), jitter_masks=masks)
    loss = out.vq_loss + torch.mean(
        (out.reconstructed_x - tb["output_features"]) ** 2)
    leaves = jax_param_leaves(model)
    grads = torch.autograd.grad(loss, [leaf.tensor for leaf in leaves])
    assert len(leaves) == len(want)
    for leaf, g in zip(leaves, grads):
        key = tuple(jax.tree_util.DictKey(k) for k in leaf.path)
        g = g.numpy().transpose(2, 1, 0) if leaf.is_kernel else g.numpy()
        np.testing.assert_allclose(g, want[key], rtol=1e-4, atol=1e-6,
                                   err_msg=str(leaf.path))
        assert np.abs(want[key]).max() > 0, leaf.path


def test_one_step_gradients_at_flagship_width():
    """One gradient check at the flagship vq44-mfcc39 width (768 hidden,
    K=44, D=64, jitter12), batch 2. rtol 2e-4 / atol 2e-6: reductions over
    2304 terms."""
    cfg = dict(CFG, num_hiddens=768, residual_channels=768, embedding_dim=64,
               num_embeddings=44, use_jitter=True)
    params, state = conv_vqvae_init(jax.random.PRNGKey(0), cfg)
    model = load_jax_params(ConvVQVAE.from_config(cfg), numpy_tree(params),
                            numpy_tree(state)).train()
    x = np.random.default_rng(0).standard_normal((2, T, 39)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    k_rep, k_dir = jax.random.split(key)
    replace = np.asarray(jax.random.bernoulli(k_rep, 0.88, (T_LAT,)))
    direction = np.asarray(jnp.where(
        jax.random.bernoulli(k_dir, 0.5, (T_LAT,)), 1, -1)).astype(np.int64)

    def loss_fn(p):
        from vqvae_speech_tpu.models import conv_vqvae_apply
        out = conv_vqvae_apply(p, state, jnp.asarray(x), cfg, training=True,
                               rng=key, use_pallas=False)
        return out.vq_loss + jnp.mean(jnp.square(out.reconstructed_x - x))

    want = dict(jax.tree_util.tree_flatten_with_path(
        numpy_tree(jax.grad(loss_fn)(params)))[0])
    xt = torch.from_numpy(x)
    out = model(xt, jitter_masks=(torch.from_numpy(replace),
                                  torch.from_numpy(direction)))
    loss = out.vq_loss + torch.mean((out.reconstructed_x - xt) ** 2)
    leaves = jax_param_leaves(model)
    grads = torch.autograd.grad(loss, [leaf.tensor for leaf in leaves])
    for leaf, g in zip(leaves, grads):
        key_path = tuple(jax.tree_util.DictKey(k) for k in leaf.path)
        g = g.numpy().transpose(2, 1, 0) if leaf.is_kernel else g.numpy()
        np.testing.assert_allclose(g, want[key_path], rtol=2e-4, atol=2e-6,
                                   err_msg=str(leaf.path))


def test_flagship_width_drift_follows_jax():
    """At the flagship width the gradient quantizer's latents outrun its
    codebook when one batch of time-correlated features is repeated: the VQ
    terms grow a hundredfold within ten steps while the reconstruction loss
    falls. It is the reference's behaviour, not the port's: the JAX step
    grows the same way. e_latent after 10 steps within 2% (a growing
    trajectory amplifies the frameworks' rounding), the reconstruction loss
    within 1e-3."""
    from vqvae_speech_tpu_torch.convert import numpy_params

    cfg = dict(CFG, num_hiddens=768, residual_channels=768, embedding_dim=64,
               num_embeddings=44)
    params, state = numpy_params(cfg, seed=0)
    joptimizer = jtrainer.make_optimizer(cfg["learning_rate"])
    jstate = jtrainer.create_train_state(
        jax.random.PRNGKey(7), jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, state), joptimizer)
    jstep = jtrainer.make_train_step(cfg, joptimizer, use_pallas=False)
    optimizer = make_optimizer(cfg["learning_rate"])
    tstate = create_train_state(
        load_jax_params(ConvVQVAE.from_config(cfg), params, state), optimizer,
        device="cpu")
    tstep = make_train_step(cfg, optimizer)
    # a random walk along time, standardised: smooth like speech features
    x = np.cumsum(np.random.default_rng(3).standard_normal((B, T, 39)), 1)
    x = ((x - x.mean((0, 1))) / x.std((0, 1))).astype(np.float32)
    batch = {"input_features": x, "output_features": x}
    first = None
    for _ in range(10):
        jstate, want = jstep(jstate, jax_batch(batch))
        tstate, got = tstep(tstate, torch_batch(batch))
        first = first or {k: float(v) for k, v in want.items()}
    assert float(want["e_latent_loss"]) > 100 * first["e_latent_loss"]
    assert float(want["reconstruction_loss"]) < first["reconstruction_loss"]
    np.testing.assert_allclose(got["e_latent_loss"].item(),
                               float(want["e_latent_loss"]), rtol=2e-2)
    np.testing.assert_allclose(got["reconstruction_loss"].item(),
                               float(want["reconstruction_loss"]), rtol=1e-3)


def test_grad_stats_have_the_jax_layer_names_and_values():
    cfg = dict(CFG, use_kaiming_normal=True)
    jstate, _, tstate, _ = both_sides(cfg)
    batch = batches(cfg, 1)[0]
    jmeans, jmaxs = jtrainer.make_grad_stats_fn(cfg, use_pallas=False)(
        jstate, jax_batch(batch))
    want = jtrainer._named_grad_entries(jmeans, jmaxs)
    before = tstate.rng.get_state()
    means, maxs = make_grad_stats_fn(cfg)(tstate, torch_batch(batch))
    assert torch.equal(tstate.rng.get_state(), before)
    got = _named_grad_entries(means, maxs)
    assert got["layers"] == want["layers"]
    assert "['encoder']['conv_1']['v']" in got["layers"]
    np.testing.assert_allclose(got["avg_grads"], want["avg_grads"], rtol=1e-4)
    np.testing.assert_allclose(got["max_grads"], want["max_grads"], rtol=1e-4)
    part = _named_grad_entries(means["decoder"], maxs["decoder"])
    assert part["layers"][0] == "['conv_1']['b']"


def test_step_draws_its_own_masks_from_the_state_generator():
    """Without masks the step draws them from ``state.rng``: two states
    with one seed take the same steps, another seed takes others."""
    cfg = dict(CFG, use_jitter=True)
    losses = []
    for seed in (1, 1, 2):
        params, state = conv_vqvae_init(jax.random.PRNGKey(0), cfg)
        model = load_jax_params(ConvVQVAE.from_config(cfg),
                                numpy_tree(params), numpy_tree(state))
        optimizer = make_optimizer(cfg["learning_rate"])
        tstate = create_train_state(model, optimizer, device="cpu",
                                    seed=seed)
        step = make_train_step(cfg, optimizer)
        for batch in batches(cfg, 3):
            tstate, metrics = step(tstate, torch_batch(batch))
        losses.append(metrics["loss"].item())
    assert losses[0] == losses[1] != losses[2]


def test_unported_step_options_raise():
    optimizer = make_optimizer(2e-4)
    with pytest.raises(NotImplementedError, match="11.4"):
        make_train_step(dict(CFG, compute_dtype="bfloat16"), optimizer)
    with pytest.raises(NotImplementedError, match="item 14"):
        make_train_step(CFG, optimizer, mesh=object())
    assert dataclasses.is_dataclass(create_train_state(
        ConvVQVAE.from_config(CFG), optimizer, device="cpu"))


def test_train_state_names_its_device():
    """The entry point has no default device: the caller says "cuda" or asks
    for the CPU, a CUDA request without a card raises, and a batch on another
    device than the model is refused, not moved."""
    optimizer = make_optimizer(2e-4)
    with pytest.raises(TypeError, match="device"):
        create_train_state(ConvVQVAE.from_config(CFG), optimizer)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_train_state(ConvVQVAE.from_config(CFG), optimizer,
                               device="cuda")
    tstate = create_train_state(ConvVQVAE.from_config(CFG), optimizer,
                                device="cpu")
    batch = torch_batch(batches(CFG, 1)[0])
    batch["output_features"] = batch["output_features"].to("meta")
    with pytest.raises(ValueError, match="output_features.*meta"):
        make_train_step(CFG, optimizer)(tstate, batch)


def test_distances_read_after_the_step_raise():
    """``VQOutput.distances`` is computed on first read from the codebook the
    call searched, which is not cloned: read before the optimizer step it is
    the JAX package's, read first after the step's in-place update it raises
    rather than answer against the updated codebook."""
    cfg = dict(CFG)
    _, _, tstate, tstep = both_sides(cfg)
    batch = torch_batch(batches(cfg, 1)[0])
    model = tstate.model
    early = model(batch["input_features"])
    kept = early.distances.clone()
    late = model(batch["input_features"])
    tstep(tstate, batch)
    assert torch.equal(early.distances, kept)      # read before: kept
    assert late.encodings.shape == kept.shape      # one-hot needs no codebook
    with pytest.raises(RuntimeError, match="changed in place"):
        late.distances
