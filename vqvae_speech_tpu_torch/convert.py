"""Carry JAX param trees (as numpy arrays) into the port's modules.

JAX stores conv kernels as (K, Cin, Cout) and transposed-conv kernels as
(K, Cout, Cin); PyTorch wants (Cout, Cin, K) and (Cin, Cout, K). Both are
``transpose(2, 1, 0)``. A weight-norm pair ``{v, g}`` keeps its form (``v``
transposed the same way, ``g`` as is): the module resolves it on forward.
The codebook comes from ``params["vq"]`` (gradient variant) or, with the EMA
statistics, from ``state["vq"]`` (EMA variant).

``numpy_params``, ``numpy_wavenet_params`` and
``numpy_wavenet_vqvae_params`` build random trees with the structure, shapes
and init distributions of ``conv_vqvae_init``, ``wavenet_init`` and
``wavenet_vqvae_init``, from numpy alone, for machines with no JAX.

The one-pass vocoders (ClariNet, FloWaveNet) are plain functions over
tensor trees, not modules: ``load_gaussian_wavenet_params``,
``load_student_params`` and ``load_flowavenet_params`` turn a JAX tree into
the same tree of tensors on a device, with every conv's weight norm resolved
to ``{"w": (Cout, Cin, K), "b"}`` and each resblock chain's weights stacked
for the fused chain under ``"chains"``. With ``compute_dtype=torch.bfloat16``
they load the tree as the JAX package's bf16 models see it: every leaf cast
to bf16 FIRST, the weight norm then resolved in bf16 op by op (the square
in bf16, its sum in f32, the norm rounded to bf16), which equals JAX's eager
``conv_weight`` on the cast tree in every element; resolving in f32 and
casting after differs in ~45% of them. ``numpy_gaussian_wavenet_params``,
``numpy_student_params`` and ``numpy_flowavenet_params`` build random trees
in the JAX layout that both packages load.
"""
import math
from typing import NamedTuple

import numpy as np
import torch

from vqvae_speech_tpu_torch.models.clarinet import (
    GaussianWaveNetConfig,
    StudentConfig,
)
from vqvae_speech_tpu_torch.models.conv_vqvae import ConvVQVAE, feature_channels
from vqvae_speech_tpu_torch.models.decoder import GIN_CHANNELS
from vqvae_speech_tpu_torch.models.flowavenet.model import (
    CouplingNetConfig,
    FlowavenetConfig,
    _block_channels,
    _flow_net_cfg,
    _prior_net_cfg,
)
from vqvae_speech_tpu_torch.models.wavenet import WaveNet, WaveNetConfig
from vqvae_speech_tpu_torch.models.wavenet_decoder import wavenet_config_from
from vqvae_speech_tpu_torch.models.wavenet_vqvae import WaveNetVQVAE
from vqvae_speech_tpu_torch.ops.fused_resblock import (
    prepare_block_chain,
    stack_block_weights,
)


def _copy(dst: torch.Tensor, src) -> None:
    src = np.asarray(src)
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: JAX {src.shape} vs torch "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(torch.from_numpy(np.array(src, np.float32)))


def _load_conv(module, p: dict) -> None:
    """Conv1d and ConvTranspose1d alike: kernels are transpose(2, 1, 0)."""
    if module.use_weight_norm != ("v" in p):
        raise ValueError("weight-norm mismatch between config and params")
    if "v" in p:
        _copy(module.v, np.asarray(p["v"]).transpose(2, 1, 0))
        _copy(module.g, p["g"])
    else:
        _copy(module.weight, np.asarray(p["w"]).transpose(2, 1, 0))
    if (module.bias is None) != ("b" not in p):
        raise ValueError("bias mismatch between module and params")
    if "b" in p:
        _copy(module.bias, p["b"])


def _load_stack(stack, p: dict) -> None:
    _load_conv(stack.block.conv1, p["block"]["conv1"])
    _load_conv(stack.block.conv2, p["block"]["conv2"])


def _load_encoder(encoder, enc: dict) -> None:
    for name in ("conv_1", "conv_2", "conv_3", "conv_4", "conv_5"):
        _load_conv(getattr(encoder, name), enc[name])
    _load_stack(encoder.residual_stack, enc["residual_stack"])


def _load_vq(vq, params: dict, state: dict) -> None:
    if vq.ema:
        vq_state = state["vq"]
        _copy(vq.codebook, vq_state["codebook"])
        _copy(vq.ema_cluster_size, vq_state["ema_cluster_size"])
        _copy(vq.ema_w, vq_state["ema_w"])
    else:
        _copy(vq.codebook, params["vq"]["codebook"])


def load_jax_params(model: ConvVQVAE, params: dict, state: dict) -> ConvVQVAE:
    """Copy a ``conv_vqvae_init``-shaped (params, state) tree into ``model``
    in place and return it."""
    _load_encoder(model.encoder, params["encoder"])
    _load_conv(model.pre_vq_conv, params["pre_vq_conv"])
    dec = params["decoder"]
    if (model.decoder.speaker_embedding is None) != (
            "speaker_embedding" not in dec):
        raise ValueError("speaker-conditioning mismatch between config and "
                         "params")
    if "speaker_embedding" in dec:
        _copy(model.decoder.speaker_embedding.table,
              dec["speaker_embedding"]["table"])
    for name in ("conv_1", "conv_trans_1", "conv_trans_2", "conv_trans_3"):
        _load_conv(getattr(model.decoder, name), dec[name])
    _load_stack(model.decoder.residual_stack, dec["residual_stack"])
    _load_vq(model.vq, params, state)
    _load_revival(model, state)
    return model


def _load_revival(model, state: dict) -> None:
    if (model.revival_usage is None) != ("revival" not in state):
        raise ValueError("codebook_revival mismatch between config and state")
    if "revival" in state:
        _copy(model.revival_usage, state["revival"]["usage"])


# -------------------- back to the JAX layout --------------------


class ParamLeaf(NamedTuple):
    path: tuple           # the leaf's keys (str) and list indices (int) in
    #                       the JAX param tree
    tensor: torch.Tensor  # the port's parameter
    is_kernel: bool       # a kernel: the JAX layout is transpose(perm)
    perm: tuple = (2, 1, 0)   # conv kernels; the LC upsample's (2, 3, 0, 1)


def _conv_leaves(path, module):
    if module.use_weight_norm:
        yield ParamLeaf(path + ("v",), module.v, True)
        yield ParamLeaf(path + ("g",), module.g, False)
    else:
        yield ParamLeaf(path + ("w",), module.weight, True)
    if module.bias is not None:
        yield ParamLeaf(path + ("b",), module.bias, False)


def _stack_leaves(path, stack):
    yield from _conv_leaves(path + ("block", "conv1"), stack.block.conv1)
    yield from _conv_leaves(path + ("block", "conv2"), stack.block.conv2)


def _wavenet_leaves(path, module: WaveNet):
    """A ``wavenet_init`` tree's leaves: ``conv_layers`` and
    ``upsample_conv`` are lists, their items indexed by int."""
    yield from _conv_leaves(path + ("first_conv",), module.first_conv)
    for i, layer in enumerate(module.conv_layers):
        for name in ("conv", "conv1x1c", "conv1x1g", "conv1x1_skip",
                     "conv1x1_out"):
            if getattr(layer, name) is not None:
                yield from _conv_leaves(path + ("conv_layers", i, name),
                                        getattr(layer, name))
    yield from _conv_leaves(path + ("last_conv_1",), module.last_conv_1)
    yield from _conv_leaves(path + ("last_conv_2",), module.last_conv_2)
    if module.embed_speakers is not None:
        yield ParamLeaf(path + ("embed_speakers", "table"),
                        module.embed_speakers, False)
    for i, stage in enumerate(module.upsample_conv or ()):
        at = path + ("upsample_conv", i)
        yield ParamLeaf(at + ("v",), stage.v, True, (2, 3, 0, 1))
        yield ParamLeaf(at + ("g",), stage.g, False)
        yield ParamLeaf(at + ("b",), stage.b, False)


def jax_param_leaves(model) -> list:
    """Every parameter of ``model`` (a ``ConvVQVAE`` or a ``WaveNetVQVAE``)
    with its place in the JAX package's ``conv_vqvae_init`` or
    ``wavenet_vqvae_init`` param tree, in JAX's flatten order (sorted keys,
    list items in order): the map that checkpoint writing, optimizer-state
    conversion and the gradient statistics' layer names all go through."""
    leaves = []
    for name in ("conv_1", "conv_2", "conv_3", "conv_4", "conv_5"):
        leaves += _conv_leaves(("encoder", name), getattr(model.encoder, name))
    leaves += _stack_leaves(("encoder", "residual_stack"),
                            model.encoder.residual_stack)
    leaves += _conv_leaves(("pre_vq_conv",), model.pre_vq_conv)
    if not model.vq.ema:
        leaves.append(ParamLeaf(("vq", "codebook"), model.vq.codebook, False))
    dec = model.decoder
    if isinstance(model, WaveNetVQVAE):
        leaves += _conv_leaves(("decoder", "conv_1"), dec.conv_1)
        leaves += _wavenet_leaves(("decoder", "wavenet"), dec.wavenet)
    else:
        for name in ("conv_1", "conv_trans_1", "conv_trans_2",
                     "conv_trans_3"):
            leaves += _conv_leaves(("decoder", name), getattr(dec, name))
        leaves += _stack_leaves(("decoder", "residual_stack"),
                                dec.residual_stack)
        if dec.speaker_embedding is not None:
            leaves.append(ParamLeaf(("decoder", "speaker_embedding", "table"),
                                    dec.speaker_embedding.table, False))
    if len(leaves) != len(list(model.parameters())):
        raise AssertionError("a parameter of the model has no place in the "
                             "JAX param tree")
    return sorted(leaves, key=lambda leaf: leaf.path)


def nest_by_path(items) -> dict:
    """(path, value) pairs -> nested dicts keyed by the paths' parts; a
    level whose keys are the ints 0..n-1 becomes a list."""
    tree = {}
    for path, value in items:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(isinstance(k, int) for k in node):
            if sorted(node) != list(range(len(node))):
                raise ValueError(f"list indices {sorted(node)} have gaps")
            return [node[i] for i in range(len(node))]
        return node

    return lists(tree)


def _to_jax_layout(leaf: ParamLeaf, value: torch.Tensor) -> np.ndarray:
    a = value.detach().cpu().numpy()
    return np.ascontiguousarray(a.transpose(leaf.perm)) if leaf.is_kernel \
        else a.copy()


def export_jax_params(model):
    """The inverse of ``load_jax_params`` (``ConvVQVAE``) and
    ``load_wavenet_vqvae_params`` (``WaveNetVQVAE``): ``(params,
    model_state)`` as nested dicts of numpy arrays in the JAX tree's names
    and layouts
    ((K, Cin, Cout) kernels, weight-norm ``v``/``g``, the EMA state under
    ``model_state["vq"]``, ``revival.usage``)."""
    params = nest_by_path((leaf.path, _to_jax_layout(leaf, leaf.tensor))
                          for leaf in jax_param_leaves(model))
    params.setdefault("vq", {})
    state = {"vq": {k: v.detach().cpu().numpy().copy()
                    for k, v in model.vq.ema_state().items()}
             if model.vq.ema else {}}
    if model.revival_usage is not None:
        state["revival"] = {
            "usage": model.revival_usage.detach().cpu().numpy().copy()}
    return params, state


def _moment_index(model) -> dict:
    """id(parameter) -> its position in ``list(model.parameters())``, the
    order of the optimizer's moment lists."""
    return {id(p): i for i, p in enumerate(model.parameters())}


def export_jax_opt_state(model, opt_state):
    """The optimizer's state as ``optax.amsgrad`` lays it out, as numpy
    arrays: ``(ScaleByAmsgradState(count, mu, nu, nu_max), EmptyState())``,
    each moment a tree shaped like ``params`` with every leaf transposed as
    its weight is. The two classes are ``train/checkpoint.py``'s stand-ins
    for optax's, which ``save_checkpoint`` pickles under optax's names (the
    port imports no optax)."""
    from vqvae_speech_tpu_torch.train.checkpoint import (
        EmptyState,
        ScaleByAmsgradState,
    )

    at = _moment_index(model)
    leaves = jax_param_leaves(model)

    def tree(moments):
        out = nest_by_path(
            (leaf.path, _to_jax_layout(leaf, moments[at[id(leaf.tensor)]]))
            for leaf in leaves)
        out.setdefault("vq", {})
        return out

    return (ScaleByAmsgradState(np.asarray(opt_state.count, np.int32),
                                tree(opt_state.mu), tree(opt_state.nu),
                                tree(opt_state.nu_max)), EmptyState())


def load_jax_opt_state(model, opt_state, into) -> None:
    """Copy an ``optax.amsgrad`` state, as the checkpoint reader returns it
    (nested tuples ``((count, mu, nu, nu_max), ...)`` of param-shaped trees),
    into the port's ``AmsgradState`` ``into``, in place."""
    (count, mu, nu, nu_max), *_ = opt_state
    at = _moment_index(model)
    into.count = int(np.asarray(count))
    for leaf in jax_param_leaves(model):
        for src, dst in ((mu, into.mu), (nu, into.nu), (nu_max, into.nu_max)):
            value = src
            for key in leaf.path:
                value = value[key]
            value = np.asarray(value)
            # perm is its own inverse for both kernel layouts
            _copy(dst[at[id(leaf.tensor)]],
                  value.transpose(leaf.perm) if leaf.is_kernel else value)


def load_wavenet_params(module: WaveNet, tree: dict) -> WaveNet:
    """Copy a ``wavenet_init``-shaped tree into ``module`` in place and
    return it. Upsample kernels go from JAX's (kh, s, 1, 1) to the
    ConvTranspose2d layout (1, 1, kh, s)."""
    _load_conv(module.first_conv, tree["first_conv"])
    if len(tree["conv_layers"]) != len(module.conv_layers):
        raise ValueError("layer count mismatch between config and params")
    for layer, p in zip(module.conv_layers, tree["conv_layers"]):
        for name in ("conv", "conv1x1c", "conv1x1g", "conv1x1_skip",
                     "conv1x1_out"):
            conv = getattr(layer, name)
            if (conv is None) != (name not in p):
                raise ValueError(f"{name} mismatch between config and params")
            if conv is not None:
                _load_conv(conv, p[name])
    _load_conv(module.last_conv_1, tree["last_conv_1"])
    _load_conv(module.last_conv_2, tree["last_conv_2"])
    if (module.embed_speakers is None) != ("embed_speakers" not in tree):
        raise ValueError("speaker-embedding mismatch between config and params")
    if module.embed_speakers is not None:
        _copy(module.embed_speakers, tree["embed_speakers"]["table"])
    if (module.upsample_conv is None) != ("upsample_conv" not in tree):
        raise ValueError("upsample mismatch between config and params")
    for stage, p in zip(module.upsample_conv or (),
                        tree.get("upsample_conv", ())):
        _copy(stage.v, np.asarray(p["v"]).transpose(2, 3, 0, 1))
        _copy(stage.g, p["g"])
        _copy(stage.b, p["b"])
    return module


def load_wavenet_vqvae_params(model: WaveNetVQVAE, params: dict,
                              state: dict) -> WaveNetVQVAE:
    """Copy a ``wavenet_vqvae_init``-shaped (params, state) tree into
    ``model`` in place and return it."""
    _load_encoder(model.encoder, params["encoder"])
    _load_conv(model.pre_vq_conv, params["pre_vq_conv"])
    _load_vq(model.vq, params, state)
    _load_conv(model.decoder.conv_1, params["decoder"]["conv_1"])
    load_wavenet_params(model.decoder.wavenet, params["decoder"]["wavenet"])
    _load_revival(model, state)
    return model


# -------------------- one-pass vocoders: tensor trees --------------------


def _tensor(a, device, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(device, dtype or torch.float32)


def _weight_norm(v: torch.Tensor, g: torch.Tensor, dims) -> torch.Tensor:
    """g * v / ||v||, the norm over ``dims``, in v's dtype. Below f32 each
    op rounds as JAX's do: v**2 in that dtype, summed in f32 (``jnp.sum``
    upcasts), the sum rounded back before its square root."""
    square = v.square()
    if v.dtype == torch.float32:
        norm = square.sum(dims, keepdim=True).sqrt()
    else:
        norm = square.float().sum(dims, keepdim=True).to(v.dtype).sqrt()
    return g * v / norm


def _resolved_conv(p: dict, device, dtype=None) -> dict:
    """A JAX conv ``{v, g, b}`` or ``{w, b}`` (kernel (K, Cin, Cout)) as
    ``{"w": (Cout, Cin, K), "b"}`` with ``w = g * v / ||v||``, the norm over
    (K, Cin) (``nn/conv.py::conv_weight``), every leaf cast to ``dtype``
    (None: f32) before the norm is resolved."""
    if "v" in p:
        w = _weight_norm(_tensor(p["v"], "cpu", dtype),
                         _tensor(p["g"], "cpu", dtype), (0, 1))
    else:
        w = _tensor(p["w"], "cpu", dtype)
    return {"w": w.permute(2, 1, 0).contiguous().to(device),
            "b": _tensor(p["b"], device, dtype)}


_RESBLOCK_CONVS = ("filter_conv", "gate_conv", "res_conv", "skip_conv",
                   "filter_conv_c", "gate_conv_c")


def load_upsample_params(stages, device, compute_dtype=None) -> list:
    """ClariNet upsampling stages ``{v (3, 2s, 1, 1), g (1,), b (1,)}`` with
    the weight norm taken over the WHOLE kernel, as ConvTranspose2d weights
    (1, 1, 3, 2s), in ``compute_dtype`` (None: f32; cast before the norm is
    resolved, as JAX does)."""
    out = []
    for p in stages:
        v = _tensor(p["v"], "cpu", compute_dtype)
        w = _weight_norm(v, _tensor(p["g"], "cpu", compute_dtype)[0],
                         tuple(range(v.dim())))
        out.append({"w": w[:, :, 0, 0][None, None].contiguous().to(device),
                    "b": _tensor(p["b"], device, compute_dtype)})
    return out


def _resolved_resblocks(tree, total_layers, num_layers, device,
                        prepare_chains=False, compute_dtype=None):
    """(res_blocks, chains): every resblock's convs resolved in
    ``compute_dtype``, and each run of ``num_layers`` blocks stacked for the
    fused chain (weights in ``compute_dtype``, biases f32) and, with
    ``prepare_chains``, bound to the chain kernel once
    (``ops.fused_resblock.prepare_block_chain``: on a CUDA device about
    twice the chains' weights of device memory more at f32, as much at bf16;
    a no-op on the CPU)."""
    if len(tree) != total_layers:
        raise ValueError(f"{len(tree)} resblocks in the params, "
                         f"{total_layers} in the config")
    blocks = [{n: _resolved_conv(p[n], device, compute_dtype)
               for n in _RESBLOCK_CONVS} for p in tree]
    chains = [stack_block_weights(blocks[at:at + num_layers], compute_dtype)
              for at in range(0, total_layers, num_layers)]
    if prepare_chains:
        chains = [prepare_block_chain(c) for c in chains]
    return blocks, chains


def load_gaussian_wavenet_params(tree: dict, cfg: GaussianWaveNetConfig,
                                 device, prepare_chains=False,
                                 compute_dtype=None) -> dict:
    """A ``gaussian_wavenet_init``-shaped tree as tensors on ``device`` in
    ``compute_dtype`` (None: f32); ``prepare_chains`` as in
    ``_resolved_resblocks``, for the fused path."""
    blocks, chains = _resolved_resblocks(tree["res_blocks"], cfg.total_layers,
                                         cfg.num_layers, device,
                                         prepare_chains, compute_dtype)

    def conv(name):
        return _resolved_conv(tree[name], device, compute_dtype)

    return {"front_conv": conv("front_conv"),
            "res_blocks": blocks, "chains": chains,
            "final_conv_1": conv("final_conv_1"),
            "final_conv_2": conv("final_conv_2"),
            "upsample_conv": load_upsample_params(tree["upsample_conv"], device,
                                                  compute_dtype)}


def load_student_params(tree: dict, cfg: StudentConfig, device,
                        prepare_chains=False, compute_dtype=None) -> dict:
    """A ``wavenet_student_init``-shaped tree as tensors on ``device`` in
    ``compute_dtype`` (None: f32); ``prepare_chains`` binds every chain to
    the chain kernel at load."""
    if len(tree["iafs"]) != cfg.num_flow:
        raise ValueError(f"{len(tree['iafs'])} flows in the params, "
                         f"{cfg.num_flow} in the config")
    return {"iafs": [load_gaussian_wavenet_params(p, cfg.flow_config(i), device,
                                                  prepare_chains, compute_dtype)
                     for i, p in enumerate(tree["iafs"])]}


def _load_coupling_net(tree: dict, cfg: CouplingNetConfig, device,
                       prepare_chains=False, compute_dtype=None) -> dict:
    blocks, chains = _resolved_resblocks(tree["res_blocks"], cfg.total_layers,
                                         cfg.num_layers, device,
                                         prepare_chains, compute_dtype)
    return {"front_conv": _resolved_conv(tree["front_conv"], device,
                                         compute_dtype),
            "res_blocks": blocks, "chains": chains,
            "final_conv_1": _resolved_conv(tree["final_conv_1"], device,
                                           compute_dtype),
            "final_zero_conv": {n: _tensor(tree["final_zero_conv"][n], device,
                                           compute_dtype)
                                for n in ("w", "b", "scale")}}


def load_flowavenet_params(tree: dict, cfg: FlowavenetConfig, device,
                           prepare_chains=False, compute_dtype=None) -> dict:
    """A ``flowavenet_init``-shaped tree as tensors on ``device`` in
    ``compute_dtype`` (None: f32); ``prepare_chains`` binds every coupling
    chain to the chain kernel at load (the priors' nets are not fused and
    stay as they are)."""
    if len(tree["blocks"]) != cfg.n_block:
        raise ValueError(f"{len(tree['blocks'])} blocks in the params, "
                         f"{cfg.n_block} in the config")
    blocks = []
    for i, (in_ch, cin_ch) in enumerate(_block_channels(cfg)):
        sq, sqc = in_ch * 2, cin_ch * 2
        src = tree["blocks"][i]
        if len(src["flows"]) != cfg.n_flow or (
                ("prior" in src) != cfg.split_at(i)):
            raise ValueError(f"block {i} of the params does not match the "
                             "config")
        net_cfg = _flow_net_cfg(cfg, sq, sqc)
        block = {"flows": [
            {"actnorm": {n: _tensor(f["actnorm"][n], device, compute_dtype)
                         for n in ("loc", "scale")},
             "coupling": _load_coupling_net(f["coupling"], net_cfg, device,
                                            prepare_chains, compute_dtype)}
            for f in src["flows"]]}
        if cfg.split_at(i):
            block["prior"] = _load_coupling_net(
                src["prior"], _prior_net_cfg(sq, sqc), device,
                compute_dtype=compute_dtype)
        blocks.append(block)
    return {"blocks": blocks,
            "upsample_conv": load_upsample_params(tree["upsample_conv"], device,
                                                  compute_dtype)}


# -------------------- random trees without JAX --------------------


def _uniform(rng, shape, fan_in):
    bound = 1.0 / math.sqrt(fan_in)
    return rng.uniform(-bound, bound, shape).astype(np.float32)


def _conv(rng, in_ch, out_ch, k, bias=True, wn=False):
    """nn/conv.py:conv1d_init: kernel (K, Cin, Cout)."""
    shape = (k, in_ch, out_ch)
    if wn:
        v = (rng.standard_normal(shape) * math.sqrt(2.0 / (in_ch * k))
             ).astype(np.float32)
        p = {"v": v, "g": np.sqrt(np.square(v).sum((0, 1))).astype(np.float32)}
    else:
        p = {"w": _uniform(rng, shape, in_ch * k)}
    if bias:
        p["b"] = _uniform(rng, (out_ch,), in_ch * k)
    return p


def _conv_t(rng, in_ch, out_ch, k, wn=False):
    """nn/conv.py:conv_transpose1d_init: kernel (K, Cout, Cin)."""
    shape = (k, out_ch, in_ch)
    if wn:
        v = (rng.standard_normal(shape) * math.sqrt(2.0 / (in_ch * k))
             ).astype(np.float32)
        p = {"v": v, "g": np.sqrt(np.square(v).sum((0, 1))).astype(np.float32)}
    else:
        p = {"w": _uniform(rng, shape, out_ch * k)}
    p["b"] = _uniform(rng, (out_ch,), out_ch * k)
    return p


def _stack(rng, in_ch, hid, res_hid, wn):
    return {"block": {"conv1": _conv(rng, in_ch, res_hid, 3, False, wn),
                      "conv2": _conv(rng, res_hid, hid, 1, False, wn)}}


def _vq_tree(rng, config: dict):
    """vector_quantizer_init's (params["vq"], state["vq"])."""
    K, D = config["num_embeddings"], config["embedding_dim"]
    if config["decay"] > 0.0:
        return {}, {
            "codebook": rng.standard_normal((K, D)).astype(np.float32),
            "ema_cluster_size": np.zeros((K,), np.float32),
            "ema_w": rng.standard_normal((K, D)).astype(np.float32),
        }
    return {"codebook": rng.uniform(-1.0 / K, 1.0 / K, (K, D))
            .astype(np.float32)}, {}


def numpy_params(config: dict, seed: int):
    """Random (params, state) with exactly ``conv_vqvae_init``'s tree
    structure and shapes, made with ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    wn = config["use_kaiming_normal"]
    hid = config["num_hiddens"]
    K, D = config["num_embeddings"], config["embedding_dim"]
    fin = feature_channels(config, "input")
    spk = config["use_speaker_conditioning"]
    params = {
        "encoder": {
            "conv_1": _conv(rng, fin, hid, 3, wn=wn),
            "conv_2": _conv(rng, hid, hid, 3, wn=wn),
            "conv_3": _conv(rng, hid, hid, 4, wn=wn),
            "conv_4": _conv(rng, hid, hid, 3, wn=wn),
            "conv_5": _conv(rng, hid, hid, 3, wn=wn),
            "residual_stack": _stack(rng, hid, hid, hid, wn),
        },
        "pre_vq_conv": _conv(rng, hid, D, 3),
        "vq": {},
        "decoder": {
            "conv_1": _conv(rng, D + (GIN_CHANNELS if spk else 0), hid, 3,
                            wn=wn),
            "residual_stack": _stack(rng, hid, hid,
                                     config["residual_channels"], wn),
            "conv_trans_1": _conv_t(rng, hid, hid, 3, wn),
            "conv_trans_2": _conv_t(rng, hid, hid, 3, wn),
            "conv_trans_3": _conv_t(rng, hid, feature_channels(config, "output"),
                                    2, wn),
        },
    }
    params["vq"], vq_state = _vq_tree(rng, config)
    if spk:   # drawn last: the other leaves do not depend on the option
        params["decoder"]["speaker_embedding"] = {"table": (
            0.1 * rng.standard_normal((config.get("num_speakers", 0),
                                       GIN_CHANNELS))).astype(np.float32)}
    state = {"vq": vq_state}
    if config.get("codebook_revival", False):
        state["revival"] = {"usage": np.full((K,), 1.0 / K, np.float32)}
    return params, state


def _wn_conv(rng, in_ch, out_ch, k, dropout=0.0, std_mul=1.0):
    """models/wavenet/model.py:_conv_init: v ~ N(0, std) with
    std = sqrt(std_mul * (1 - dropout) / (k * in_ch)), g = ||v|| over
    (K, Cin), zero bias."""
    std = math.sqrt(std_mul * (1.0 - dropout) / (k * in_ch))
    v = (std * rng.standard_normal((k, in_ch, out_ch))).astype(np.float32)
    return {"v": v, "g": np.sqrt(np.square(v).sum((0, 1))).astype(np.float32),
            "b": np.zeros((out_ch,), np.float32)}


def numpy_wavenet_params(cfg: WaveNetConfig, seed: int) -> dict:
    """A random tree with exactly ``wavenet_init``'s structure, shapes and
    init distributions, made with ``np.random.default_rng(seed)``."""
    return _wavenet_tree(np.random.default_rng(seed), cfg)


def _wavenet_tree(rng, cfg: WaveNetConfig) -> dict:
    gate_out = cfg.gate_channels // 2
    in_ch = 1 if cfg.scalar_input else cfg.out_channels
    layers = []
    for _ in range(cfg.layers):
        p = {"conv": _wn_conv(rng, cfg.residual_channels, cfg.gate_channels,
                              cfg.kernel_size, dropout=cfg.dropout),
             "conv1x1_out": _wn_conv(rng, gate_out, cfg.residual_channels, 1),
             "conv1x1_skip": _wn_conv(rng, gate_out, cfg.skip_out_channels, 1)}
        if cfg.cin_channels > 0:
            p["conv1x1c"] = _wn_conv(rng, cfg.cin_channels, cfg.gate_channels, 1)
        if cfg.gin_channels > 0:
            p["conv1x1g"] = _wn_conv(rng, cfg.gin_channels, cfg.gate_channels, 1)
        layers.append(p)
    tree = {
        "first_conv": _wn_conv(rng, in_ch, cfg.residual_channels, 1),
        "conv_layers": layers,
        "last_conv_1": _wn_conv(rng, cfg.skip_out_channels,
                                cfg.skip_out_channels, 1),
        "last_conv_2": _wn_conv(rng, cfg.skip_out_channels, cfg.out_channels, 1),
    }
    if cfg.gin_channels > 0 and cfg.use_speaker_embedding:
        tree["embed_speakers"] = {"table": (0.1 * rng.standard_normal(
            (cfg.n_speakers, cfg.gin_channels))).astype(np.float32)}
    if cfg.upsample_conditional_features:
        kh = cfg.freq_axis_kernel_size
        tree["upsample_conv"] = []
        for s in cfg.upsample_scales:
            # the reference's averaging fill (PARITY #36, model.py:124-144)
            v = np.full((kh, s, 1, 1), 1.0 / kh, np.float32)
            tree["upsample_conv"].append({
                "v": v, "g": np.sqrt(np.square(v).sum()).reshape(1),
                "b": np.zeros((1,), np.float32)})
    return tree


def numpy_wavenet_vqvae_params(config: dict, num_speakers: int, seed: int):
    """Random (params, state, wavenet_cfg) with exactly
    ``wavenet_vqvae_init``'s tree structure and shapes, made with
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    wn = config["use_kaiming_normal"]
    hid = config["num_hiddens"]
    res_hid = config["residual_channels"]
    fin = feature_channels(config, "input")
    cfg = wavenet_config_from(config, num_speakers)
    vq_params, vq_state = _vq_tree(rng, config)
    params = {
        "encoder": {
            "conv_1": _conv(rng, fin, hid, 3, wn=wn),
            "conv_2": _conv(rng, hid, hid, 3, wn=wn),
            "conv_3": _conv(rng, hid, hid, 4, wn=wn),
            "conv_4": _conv(rng, hid, hid, 3, wn=wn),
            "conv_5": _conv(rng, hid, hid, 3, wn=wn),
            "residual_stack": _stack(rng, hid, hid, res_hid, wn),
        },
        "pre_vq_conv": _conv(rng, hid, config["embedding_dim"], 1),
        "vq": vq_params,
        "decoder": {
            "conv_1": _conv(rng, config["embedding_dim"],
                            config["local_condition_dim"], 2, wn=wn),
            "wavenet": _wavenet_tree(rng, cfg),
        },
    }
    state = {"vq": vq_state}
    if config.get("codebook_revival", False):
        K = config["num_embeddings"]
        state["revival"] = {"usage": np.full((K,), 1.0 / K, np.float32)}
    return params, state, cfg


# ---- one-pass vocoders ----


def _clarinet_conv(rng, in_ch, out_ch, k):
    """models/clarinet/modules.py:conv_init: weight-normed, kaiming-normal
    direction, uniform bias."""
    return _conv(rng, in_ch, out_ch, k, bias=True, wn=True)


def _resblock_tree(rng, in_ch, out_ch, skip_ch, k, cin):
    return {"filter_conv": _clarinet_conv(rng, in_ch, out_ch, k),
            "gate_conv": _clarinet_conv(rng, in_ch, out_ch, k),
            "res_conv": _clarinet_conv(rng, out_ch, in_ch, 1),
            "skip_conv": _clarinet_conv(rng, out_ch, skip_ch, 1),
            "filter_conv_c": _clarinet_conv(rng, cin, out_ch, 1),
            "gate_conv_c": _clarinet_conv(rng, cin, out_ch, 1)}


def _upsample_tree(rng, scales):
    """modules.py:upsample_init: a random (asymmetric) kernel a stage."""
    stages = []
    for s in scales:
        v = (rng.standard_normal((3, 2 * s, 1, 1))
             * math.sqrt(2.0 / (3 * 2 * s))).astype(np.float32)
        stages.append({"v": v, "g": np.sqrt(np.square(v).sum()).reshape(1),
                       "b": np.zeros((1,), np.float32)})
    return stages


def _gaussian_wavenet_tree(rng, cfg: GaussianWaveNetConfig) -> dict:
    return {
        "front_conv": _clarinet_conv(rng, 1, cfg.residual_channels,
                                     cfg.front_channels),
        "res_blocks": [
            _resblock_tree(rng, cfg.residual_channels, cfg.gate_channels,
                           cfg.skip_channels, cfg.kernel_size,
                           cfg.cin_channels)
            for _ in range(cfg.total_layers)],
        "final_conv_1": _clarinet_conv(rng, cfg.skip_channels,
                                       cfg.skip_channels, 1),
        "final_conv_2": _clarinet_conv(rng, cfg.skip_channels,
                                       cfg.out_channels, 1),
        "upsample_conv": _upsample_tree(rng, cfg.upsample_scales),
    }


def numpy_gaussian_wavenet_params(cfg: GaussianWaveNetConfig, seed: int):
    """A random tree with ``gaussian_wavenet_init``'s structure, shapes and
    init distributions, made with ``np.random.default_rng(seed)``."""
    return _gaussian_wavenet_tree(np.random.default_rng(seed), cfg)


def numpy_student_params(cfg: StudentConfig, seed: int) -> dict:
    """A random tree with ``wavenet_student_init``'s structure and shapes.
    Each flow's last conv has its gain cut to a tenth of the init's, so that
    ``exp(logs)`` composed over the flows stays near 1 with random weights
    and the generated wave stays at the noise's scale."""
    rng = np.random.default_rng(seed)
    iafs = []
    for i in range(cfg.num_flow):
        flow = _gaussian_wavenet_tree(rng, cfg.flow_config(i))
        flow["final_conv_2"]["g"] = flow["final_conv_2"]["g"] * np.float32(0.1)
        iafs.append(flow)
    return {"iafs": iafs}


def _coupling_net_tree(rng, cfg: CouplingNetConfig) -> dict:
    """flowavenet/model.py:coupling_net_init, but with a NON-zero zero conv
    (w ~ N(0, 0.05^2 / in), b ~ N(0, 0.01^2), scale ~ N(0, 0.1^2)): at the
    init's zeros every coupling is the identity and the coupling nets never
    reach the wave. Small enough that 48 couplings of exp(log_s) stay near
    1."""
    S = cfg.skip_channels
    return {
        "front_conv": _clarinet_conv(rng, cfg.in_channels,
                                     cfg.residual_channels, 3),
        "res_blocks": [
            _resblock_tree(rng, cfg.residual_channels, cfg.gate_channels,
                           cfg.skip_channels, cfg.kernel_size,
                           cfg.cin_channels)
            for _ in range(cfg.total_layers)],
        "final_conv_1": _clarinet_conv(rng, S, S, 1),
        "final_zero_conv": {
            "w": (rng.standard_normal((1, S, cfg.out_channels))
                  * 0.05 / math.sqrt(S)).astype(np.float32),
            "b": (0.01 * rng.standard_normal((cfg.out_channels,))
                  ).astype(np.float32),
            "scale": (0.1 * rng.standard_normal((cfg.out_channels,))
                      ).astype(np.float32)},
    }


def numpy_flowavenet_params(cfg: FlowavenetConfig, seed: int) -> dict:
    """A random tree with ``flowavenet_init``'s structure and shapes, with
    non-trivial ActNorms (loc ~ N(0, 0.1^2), scale = exp(N(0, 0.05^2))) and
    non-zero zero convs (see ``_coupling_net_tree``), as a trained flow
    has."""
    rng = np.random.default_rng(seed)
    blocks = []
    for i, (in_ch, cin_ch) in enumerate(_block_channels(cfg)):
        sq, sqc = in_ch * 2, cin_ch * 2
        net_cfg = _flow_net_cfg(cfg, sq, sqc)
        block = {"flows": [
            {"actnorm": {
                "loc": (0.1 * rng.standard_normal((sq,))).astype(np.float32),
                "scale": np.exp(0.05 * rng.standard_normal((sq,))
                                ).astype(np.float32)},
             "coupling": _coupling_net_tree(rng, net_cfg)}
            for _ in range(cfg.n_flow)]}
        if cfg.split_at(i):
            block["prior"] = _coupling_net_tree(rng, _prior_net_cfg(sq, sqc))
        blocks.append(block)
    return {"blocks": blocks,
            "upsample_conv": _upsample_tree(rng, cfg.upsample_scales)}
