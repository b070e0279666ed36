"""What the ranks of the multi-rank tests run (``tests/torch_world.py``), and
the runs the tests hold them against. Imports no JAX: the ranks cannot.

``parallel_modules`` (a world of 4): the mesh, the sharded codebook search,
the tensor-parallel decode and its server, the sequence-parallel teacher
and the DCP checkpoint. ``data_parallel`` (a world of 2): the data-parallel
train steps, an Experiment and the vocoder CLI's ``--data_parallel``. ``run_*`` are the steps' runs, called by the
ranks with a mesh and by the tests with ``mesh=None`` on the global batch.
"""
import os

import numpy as np
import torch

from vqvae_speech_tpu_torch import convert
from vqvae_speech_tpu_torch.parallel.mesh import (
    MeshConfiguration,
    all_gather_rows,
    axis_rank,
    make_mesh,
    mesh_shape,
    replicate,
    shard_batch,
)


def _tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ---------------- world of 4: the parallel modules ----------------

def parallel_modules(rank, size, inputs, work):
    from vqvae_speech_tpu_torch.parallel.sharded_vq import (
        place_sharded_codebook,
        sharded_vq_search,
    )

    out = {}
    m22 = make_mesh(2, 2, device="cpu")
    m14 = make_mesh(1, 4, device="cpu")
    m41 = make_mesh(device="cpu")
    out["shapes"] = [mesh_shape(m) for m in (m22, m14, m41)]
    out["mesh_configuration"] = []
    for cfg in ({"use_data_parallel": True}, {"use_data_parallel": False},
                {"use_data_parallel": True, "num_model_shards": 2}):
        mc = MeshConfiguration.load_from_configuration(cfg, device="cpu")
        out["mesh_configuration"].append(
            (mc.data_axis_size, mc.use_data_parallel, mc.mesh is not None,
             mc.backend))
    x = np.arange(32, dtype=np.float32).reshape(16, 2)
    out["shard"] = shard_batch({"x": x}, m41)["x"]
    out["shard_22"] = shard_batch({"x": x}, m22)["x"]
    try:
        shard_batch({"x": np.zeros((6, 2), np.float32)}, m41)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    t = torch.full((3,), float(rank))
    out["replicated"] = replicate({"t": t}, m22)["t"].numpy()
    z = torch.full((2, 3), float(rank), requires_grad=True)
    gathered = all_gather_rows(z, m41)
    (gathered.sum(1) * torch.arange(1.0, 9.0)).sum().mul(rank + 1).backward()
    out["gathered"] = gathered.detach().numpy()
    out["gather_grad"] = z.grad.numpy()

    for name, mesh in (("vq2", m22), ("vq4", m14)):
        flat, cb = (torch.from_numpy(a) for a in inputs[name])
        idx, mins = sharded_vq_search(flat, place_sharded_codebook(cb, mesh),
                                      mesh)
        out[name] = (idx.numpy(), mins.numpy())

    out["tp"] = _tensor_parallel(inputs["tp"], {"2way": m22, "4way": m14})
    out["sp"] = _sequence_parallel(inputs["sp"], m41, rank)
    out["dcp"] = _dcp(inputs["dcp"], work)
    return out


def _wavenet(case):
    from vqvae_speech_tpu_torch.models.wavenet.model import (
        WaveNet,
        WaveNetConfig,
    )

    cfg = WaveNetConfig(**case["cfg"])
    return convert.load_wavenet_params(WaveNet(cfg), case["params"]), cfg


def _tensor_parallel(cases, meshes):
    from vqvae_speech_tpu_torch.models.wavenet.incremental import (
        wavenet_incremental_generate,
    )
    from vqvae_speech_tpu_torch.parallel.tp_decode import (
        wavenet_incremental_generate_tp,
    )
    from vqvae_speech_tpu_torch.serve import BucketedSynthesisServer

    out = {}
    for name, case in cases.items():
        module, cfg = _wavenet(case)
        g = None if case["g"] is None else torch.as_tensor(case["g"])
        outs, emitted = wavenet_incremental_generate_tp(
            module, cfg, case["T"], meshes[case["mesh"]], c=case["c"], g=g,
            weight_quant=case["weight_quant"])
        _, single = wavenet_incremental_generate(
            module, cfg, case["T"], c=case["c"], g=g, sample=False,
            weight_quant=case["weight_quant"])
        out[name] = (outs.numpy(), emitted.numpy(), single.numpy())
    # the server routes to the decode when the model axis is > 1
    case = cases["4way"]
    conds = [np.asarray(case["c"][0][:n]) for n in (4, 3, 6)]
    waves = {}
    for key, mesh in (("tp", meshes["4way"]), ("single", None)):
        server = BucketedSynthesisServer(case["params"], _wavenet(case)[1],
                                         frame_buckets=(3, 6), max_batch=2,
                                         mesh=mesh, device="cpu")
        waves[key] = [r.wave for r in server.synthesize(conds)]
    out["server"] = waves
    refused = []
    for kw in ({"sample": True}, {"compute_dtype": torch.bfloat16},
               {"weight_quant": "int8_block"}):
        try:
            BucketedSynthesisServer(case["params"], _wavenet(case)[1],
                                    mesh=meshes["4way"], device="cpu", **kw)
            refused.append(None)
        except ValueError as e:
            refused.append(str(e))
    out["server_refused"] = refused
    return out


def _sequence_parallel(case, mesh, rank):
    from vqvae_speech_tpu_torch.models.clarinet import GaussianWaveNetConfig
    from vqvae_speech_tpu_torch.parallel.sp_vocoder import (
        sp_gaussian_wavenet_core,
        sp_teacher_loss,
    )
    from vqvae_speech_tpu_torch.train.vocoder import tree_leaves

    out = {}
    n = 4
    for key in ("core", "loss"):
        cfg = GaussianWaveNetConfig(**case[key]["cfg"])
        x, c = (torch.from_numpy(case[key][k]) for k in ("x", "c"))
        per = x.shape[1] // n
        x, c = (a[:, rank * per:(rank + 1) * per] for a in (x, c))
        tree = convert.tensor_tree(case[key]["params"], "cpu",
                                   requires_grad=True)
        params = convert.resolve_gaussian_wavenet(tree, cfg)
        if key == "core":
            with torch.no_grad():
                out["core"] = sp_gaussian_wavenet_core(params, cfg, x, c,
                                                       mesh).numpy()
            continue
        loss = sp_teacher_loss(params, cfg, x, c, mesh)
        leaves = tree_leaves(tree)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        for g in grads:
            torch.distributed.all_reduce(g)
        out["loss"] = float(loss.detach())
        out["grads"] = [g.numpy() for g in grads]
    cfg = GaussianWaveNetConfig(**case["halo"]["cfg"])
    params = convert.resolve_gaussian_wavenet(
        convert.tensor_tree(case["halo"]["params"], "cpu"), cfg)
    try:
        sp_gaussian_wavenet_core(params, cfg, torch.zeros(1, 32, 1),
                                 torch.zeros(1, 32, 6), mesh)
        out["halo"] = None
    except ValueError as e:
        out["halo"] = str(e)
    return out


def _dcp(case, work):
    from vqvae_speech_tpu_torch.models import ConvVQVAE
    from vqvae_speech_tpu_torch.train.dcp_checkpoint import (
        latest_checkpoint_epoch_dcp,
        load_checkpoint_dcp,
        save_checkpoint_dcp,
    )
    from vqvae_speech_tpu_torch.train.trainer import make_optimizer

    params, state = convert.numpy_params(case["cfg"], seed=0)
    model = convert.load_jax_params(ConvVQVAE.from_config(case["cfg"]),
                                    params, state)
    opt = make_optimizer(1e-3).init(model.parameters())
    for moments in (opt.mu, opt.nu, opt.nu_max):
        for m in moments:
            m.normal_(generator=torch.Generator().manual_seed(m.numel()))
    opt.count = 7
    params, state = convert.export_jax_params(model)
    opt_state = convert.export_jax_opt_state(model, opt)
    root = os.path.join(work, "dcp")
    for epoch in (0, 2):
        save_checkpoint_dcp(root, "tiny", epoch, params, state, opt_state,
                            [{"loss": 1.5}], [3.0])
    epoch, path = latest_checkpoint_epoch_dcp(root, "tiny")
    plain = load_checkpoint_dcp(root, "tiny")
    payload = {"params": params, "model_state": state, "opt_state": opt_state}
    target = _zeros_like(payload)
    into = load_checkpoint_dcp(root, "tiny", epoch=1, target=target)
    saved = _leaves(payload)

    def equal(got):
        return [np.array_equal(np.asarray(a), b.numpy())
                for a, b in zip(saved, _leaves(_payload(got)))]

    return {"epoch": epoch, "path": os.path.relpath(path, root),
            "meta": (plain["experiment_name"], plain["epoch"],
                     plain["train_res_recon_error"],
                     plain["train_res_perplexity"]),
            "plain_equal": equal(plain), "into_equal": equal(into),
            "in_place": all(a is b for a, b in zip(_leaves(target),
                                                   _leaves(_payload(into)))),
            "leaves": len(saved)}


def _payload(restored):
    return {k: restored[k] for k in ("params", "model_state", "opt_state")}


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _zeros_like(tree):
    """A tree of zero tensors of the leaves' shapes and dtypes."""
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(torch.as_tensor(np.asarray(tree)))


# ---------------- world of 2: the data-parallel steps ----------------

class CodeRecorder:
    """Each forward's global codes, read from the quantizer's output."""

    def __init__(self, vq):
        self.codes = []
        vq.register_forward_hook(
            lambda m, i, o: self.codes.append(o.indices[:, 0].numpy().copy()))


def _state_arrays(model, opt_state):
    return {"params": [p.detach().numpy().copy() for p in model.parameters()],
            "buffers": {k: v.numpy().copy()
                        for k, v in model.named_buffers()},
            "moments": [m.numpy().copy() for moments in
                        (opt_state.mu, opt_state.nu, opt_state.nu_max)
                        for m in moments]}


def run_conv_steps(cfg, batches, mesh, seed=0):
    from vqvae_speech_tpu_torch.models import ConvVQVAE
    from vqvae_speech_tpu_torch.train.trainer import (
        create_train_state,
        make_optimizer,
        make_train_step,
    )

    params, state = convert.numpy_params(cfg, seed)
    model = convert.load_jax_params(ConvVQVAE.from_config(cfg), params, state)
    opt = make_optimizer(cfg["learning_rate"])
    tstate = create_train_state(model, opt, device="cpu", seed=seed + 1)
    step = make_train_step(cfg, opt, mesh)
    codes = CodeRecorder(model.vq)
    metrics = []
    for batch in batches:
        tstate, m = step(tstate, _tensors(shard_batch(batch, mesh)))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"codes": codes.codes, "metrics": metrics,
            "state": _state_arrays(model, tstate.opt_state)}


def run_wavenet_steps(cfg, batches, mesh, seed=0):
    from vqvae_speech_tpu_torch.models.wavenet_vqvae import WaveNetVQVAE
    from vqvae_speech_tpu_torch.train.wavenet_trainer import (
        create_wavenet_train_state,
        make_wavenet_train_step,
    )
    from vqvae_speech_tpu_torch.train.trainer import make_optimizer

    params, state, wcfg = convert.numpy_wavenet_vqvae_params(
        cfg, cfg["num_speakers"], seed)
    model = convert.load_wavenet_vqvae_params(
        WaveNetVQVAE(cfg, cfg["num_speakers"]), params, state)
    opt = make_optimizer(cfg["learning_rate"])
    tstate = create_wavenet_train_state(model, opt, device="cpu",
                                        seed=seed + 1)
    step = make_wavenet_train_step(cfg, wcfg, opt, mesh=mesh)
    codes = CodeRecorder(model.vq)
    metrics = []
    for batch in batches:
        tstate, m = step(tstate, _tensors(shard_batch(batch, mesh)))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"codes": codes.codes, "metrics": metrics,
            "state": _state_arrays(model, tstate.opt_state)}


def _vocoder_cfgs():
    from argparse import Namespace

    from vqvae_speech_tpu_torch import vocoder_main

    tiny = Namespace(tiny=True)
    return (vocoder_main.teacher_cfg_for(tiny),
            vocoder_main.student_cfg_for(tiny),
            vocoder_main.flow_cfg_for(tiny))


def run_vocoder_steps(kind, batches, mesh, seed=0):
    from vqvae_speech_tpu_torch.models.flowavenet import actnorm_initialize
    from vqvae_speech_tpu_torch.train import vocoder

    tcfg, scfg, fcfg = _vocoder_cfgs()
    if kind == "teacher":
        params = convert.numpy_gaussian_wavenet_params(tcfg, seed)
        opt = vocoder.make_vocoder_optimizer(1e-3, 10.0)
        step = vocoder.make_teacher_train_step(tcfg, opt, mesh=mesh)
    elif kind == "student":
        teacher = convert.numpy_gaussian_wavenet_params(tcfg, seed + 7)
        params = convert.numpy_student_init(scfg, seed)
        opt = vocoder.make_vocoder_optimizer(1e-3, 10.0)
        step = vocoder.make_student_train_step(tcfg, scfg, teacher, opt,
                                               mesh=mesh, device="cpu")
    else:
        first = _tensors(batches[0])
        params = actnorm_initialize(
            convert.tensor_tree(convert.numpy_flowavenet_init(fcfg, seed),
                                "cpu"), fcfg, first["x"], first["c"])
        opt = vocoder.make_vocoder_optimizer(1e-3, 1.0, halve_every=200_000)
        step = vocoder.make_flow_train_step(fcfg, opt, mesh=mesh)
    state = vocoder.create_vocoder_state(params, opt, device="cpu", seed=seed)
    replicate([state.params, state.ema_params], mesh)
    losses, terms = [], []
    for batch in batches:
        state, out = step(state, _tensors(shard_batch(batch, mesh)))
        loss, aux = out if isinstance(out, tuple) else (out, {})
        losses.append(float(loss))
        terms.append({k: float(v) for k, v in aux.items()})
    return {"losses": losses, "terms": terms,
            "params": [p.detach().numpy().copy()
                       for p in vocoder.tree_leaves(state.params)],
            "ema": [p.numpy().copy()
                    for p in vocoder.tree_leaves(state.ema_params)]}


def run_experiment(spec_path, store_root):
    """One epoch of the spec's first experiment on the CPU; returns this
    process's calls of ``save_checkpoint`` (epochs) and the losses."""
    from vqvae_speech_tpu_torch.train import experiment, trainer
    from vqvae_speech_tpu_torch.train.checkpoint import (
        merge_checkpoint_losses,
    )

    saves = []
    save = trainer.save_checkpoint

    def recording(path, name, epoch, *args, **kwargs):
        saves.append(epoch)
        return save(path, name, epoch, *args, **kwargs)

    trainer.save_checkpoint = recording
    try:
        exp = experiment.Experiments.load(spec_path, data_root=store_root,
                                          device="cpu").experiments[0]
        trainer_ = exp.build_trainer()
        mesh = trainer_._mesh
        trainer_.train()
    finally:
        trainer.save_checkpoint = save
    losses, _ = merge_checkpoint_losses(exp.experiments_path, exp.name)
    return {"saves": saves, "losses": losses, "path": exp.experiments_path,
            "data_parallel": mesh is not None}


def run_vocoder_cli(data_root, checkpoint_dir):
    """One epoch of ``vocoder_main train-teacher --data_parallel --tiny`` on
    the CPU; returns this process's ``VocoderTrainer.save`` calls (epoch,
    or "best"). Under a process group the CLI closes it at its end."""
    from vqvae_speech_tpu_torch import vocoder_main
    from vqvae_speech_tpu_torch.train import vocoder

    saves = []
    save = vocoder.VocoderTrainer.save

    def recording(self, epoch, loss, best=False):
        saves.append("best" if best else epoch)
        return save(self, epoch, loss, best)

    vocoder.VocoderTrainer.save = recording
    try:
        code = vocoder_main.main([
            "train-teacher", "--data_root", data_root, "--checkpoint_dir",
            checkpoint_dir, "--batch_size", "2", "--tiny", "--device", "cpu",
            "--data_parallel", "--epochs", "1"])
    finally:
        vocoder.VocoderTrainer.save = save
    return {"code": code, "saves": saves}


def data_parallel(rank, size, inputs, work):
    mesh = make_mesh(device="cpu")
    out = {"data_rank": axis_rank(mesh, "data")}
    for name, cfg in inputs["conv"].items():
        out[name] = run_conv_steps(cfg, inputs["conv_batches"], mesh)
    out["wavenet"] = run_wavenet_steps(inputs["wavenet"],
                                       inputs["wavenet_batches"], mesh)
    for kind in ("teacher", "student", "flow"):
        out[kind] = run_vocoder_steps(kind, inputs["vocoder_batches"], mesh)
    out["experiment"] = run_experiment(*inputs["experiment"])
    # last: the CLI closes the process group
    out["vocoder_cli"] = run_vocoder_cli(*inputs["vocoder_cli"])
    return out
