"""A train step driven back to back over a pool of seeded crops on the card.

The program: the configuration's train step as its trainer builds it
(``make_train_step`` on a ``ConvVQVAE``), with optax's amsgrad at the
configuration's rate, f32 with TF32 off as the trainer sets it, on weights
the benchmark makes from the seed. Set-up builds the one train state and drives it through its
first ``warm_steps`` steps with the window's own call, each on another
batch of the pool; the window then dispatches steps back to back, each on
the pool's next batch, and synchronises once when it closes.

The check follows the first three steps in the plain reference, on the
same batches from the same weights: each step's loss, every leaf's
gradient norm as the optimizer got it (its first moment after step 1 over
1 - b1) and every leaf's change after step 3, each against the
reference's, the worst leaf taken.
"""
import time

import torch

from h100bench import trace as tr
from h100bench.reference import plain

_B1 = 0.9


def jax_path(name):
    """A port parameter's name -> the path of its leaf in the JAX layout."""
    out = []
    for part in name.split("."):
        out.append(int(part) if part.isdigit() else
                   {"weight": "w", "bias": "b"}.get(part, part))
    return tuple(out)


class Cell:
    # the program's spans are read over 20 steps (h100bench/program_spans.py)
    SEGMENT_CALLS = 20

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.t = ctx.cfg, ctx.traffic
        self.dev = torch.device(ctx.device)

    # ---- set-up ----

    def _pool(self):
        cfg, t = self.cfg, self.t
        gen = torch.Generator(device=self.dev).manual_seed(self.ctx.seed + 7)
        n, B = t["pool_batches"], cfg["batch_size"]
        T, C = cfg["input_features_dim"], cfg["input_features_filters"] * 3
        feats = torch.randn((n, B, T, C), generator=gen, device=self.dev)
        return [{"input_features": feats[i], "output_features": feats[i]}
                for i in range(n)]

    def setup(self):
        from vqvae_speech_tpu_torch import convert
        from vqvae_speech_tpu_torch.models.conv_vqvae import ConvVQVAE
        from vqvae_speech_tpu_torch.train import trainer

        cfg, ref = self.cfg, self.ctx.ref
        plain.precision(tf32=False)
        t0 = time.perf_counter()
        self.p0, host = plain.make_tree(ref.param_spec(cfg), self.ctx.seed,
                                        self.dev)
        self.ctx.note("setup_weights_s", time.perf_counter() - t0)
        optimizer = trainer.make_optimizer(cfg["learning_rate"])
        model = convert.load_jax_params(ConvVQVAE.from_config(cfg), host, {})
        self.state = trainer.create_train_state(
            model, optimizer, device=self.dev, seed=self.ctx.seed)
        self.step = trainer.make_train_step(cfg, optimizer)
        self.names = [n for n, _ in model.named_parameters()]
        with torch.no_grad():
            start = [q.detach().clone() for q in model.parameters()]
        self.pool = self._pool()
        self.i = 0
        self.ctx.note("setup_model_s", time.perf_counter() - t0)
        self.losses, self.grad_norms, self.change_norms = [], None, None
        for s in range(self.t["warm_steps"]):
            metrics = self._one()
            if s < 3:
                self.losses.append(metrics["loss"])
            if s == 0:
                self.grad_norms = torch.stack(
                    [(m / (1 - _B1)).norm() for m in self.state.opt_state.mu])
            if s == 2:
                with torch.no_grad():
                    self.change_norms = torch.stack(
                        [(q - q0).norm() for q, q0 in
                         zip(self.state.model.parameters(), start)])
        del start
        self._sync()
        self.ctx.note("setup_first_steps_s", time.perf_counter() - t0)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def _one(self):
        batch = self.pool[self.i % len(self.pool)]
        self.i += 1
        self.state, metrics = self.step(self.state, batch)
        return metrics

    # ---- the window ----

    def window(self, seconds):
        self._sync()
        t0 = time.perf_counter()
        steps = 0
        while time.perf_counter() - t0 < seconds:
            with tr.span("train_step"):
                self._one()
            steps += 1
        self._sync()
        wall = time.perf_counter() - t0
        examples = steps * self.cfg["batch_size"]
        self.ctx.note("steps", steps)
        return {"metrics": {"train_examples_per_s": examples / wall},
                "attempted": examples, "failed": 0}

    def drive_segment(self, n):
        for _ in range(n):
            self._one()

    def trace(self):
        if self.dev.type != "cuda":
            return None
        n = self.t["trace_steps"]
        with tr.window() as traced:
            for _ in range(n):
                with tr.span("train_step"):
                    self._one()
        self.trace_stats = {"steps": n}
        return traced

    def trace_gaps(self):
        with tr.window(host=True) as traced:
            for _ in range(max(1, self.t["trace_steps"] // 4)):
                with tr.span("train_step"):
                    self._one()
        return traced.gaps

    def step_flops(self):
        from h100bench import roofline as rf
        cfg, B = self.cfg, self.cfg["batch_size"]
        T = cfg["input_features_dim"]
        fin = cfg["input_features_filters"] * 3
        first = rf.conv_flops(fin, cfg["num_hiddens"], 3, T, B)
        return rf.train_flops(rf.conv_vqvae_forward_flops(cfg, T, B), first)

    # ---- the check ----

    def release(self):
        del self.state, self.step

    def _reference(self, tf32, half=False, frozen=False):
        """Three reference steps from the same weights on the same batches:
        (losses, first-step gradient norms, change norms after step 3),
        the norms in the program's parameter order. ``half`` leaves out
        half of each batch and ``frozen`` every update (faults the check
        must see)."""
        cfg, ref = self.cfg, self.ctx.ref
        plain.precision(tf32=tf32)
        paths = [jax_path(n) for n in self.names]
        p = {}
        for path, leaf in plain.leaves(self.p0):
            plain.put(p, path, leaf.detach().clone().requires_grad_(True))
        params = [plain.get(p, path) for path in paths]
        opt = plain.amsgrad_init(params)
        losses, gnorms = [], None
        for s in range(3):
            batch = self.pool[s % len(self.pool)]
            if half:
                batch = {k: v[:max(1, v.shape[0] // 2)] for k, v in batch.items()}
            loss, _ = ref.loss(p, cfg, batch)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = [torch.zeros_like(q) if g is None else g
                     for q, g in zip(params, grads)]
            if s == 0:
                gnorms = torch.stack([g.norm() for g in grads])
            plain.amsgrad_update(params, grads, opt,
                                 0.0 if frozen else cfg["learning_rate"])
            losses.append(loss.detach())
        with torch.no_grad():
            change = torch.stack([(q - plain.get(self.p0, path)).norm()
                                  for q, path in zip(params, paths)])
        plain.precision(tf32=False)
        return torch.stack(losses), gnorms, change

    @staticmethod
    def _leaf_gaps(prog, refn, keep=None):
        """Each leaf's gap of norms over max(its reference norm, the median
        leaf's); leaves not kept read 0."""
        gap = (prog - refn).abs() / torch.maximum(refn, refn.median())
        if keep is not None:
            gap = torch.where(keep, gap, torch.zeros_like(gap))
        return gap

    def check(self, control=False):
        """The numbers compared; ``control`` puts the reference in the
        program's place: in TF32 (True or "tf32"), on half of each batch
        ("half_batch"), or leaving the state unchanged ("unchanged")."""
        r_loss, r_grad, r_change = self._reference(tf32=False)
        if control:
            p_loss, p_grad, p_change = self._reference(
                tf32=control in (True, "tf32"), half=control == "half_batch",
                frozen=control == "unchanged")
        else:
            p_loss = torch.stack(self.losses).float()
            p_grad, p_change = self.grad_norms, self.change_norms
        loss_gap = float(((p_loss - r_loss).abs() / r_loss.abs()).max())
        grad = self._leaf_gaps(p_grad, r_grad)
        # leaves whose reference gradient is nought to rounding move under
        # amsgrad by round-off alone: left out of the change by this rule
        moving = r_grad >= 1e-3 * r_grad.median()
        change = self._leaf_gaps(p_change, r_change, moving)
        self.ctx.note("grad_gap_leaf", self.names[int(grad.argmax())])
        self.ctx.note("change_gap_leaf", self.names[int(change.argmax())])
        self.ctx.note("leaves_left_out", int((~moving).sum()))
        self.ctx.note("losses", [float(x) for x in p_loss])
        self.vectors = dict(getattr(self, "vectors", None) or {}, names=self.names)
        tag = ("program" if not control else
               "control" if control is True else str(control))
        self.vectors[tag] = {
            "grad": p_grad.tolist(), "change": p_change.tolist(),
            "ref_grad": r_grad.tolist(), "ref_change": r_change.tolist(),
            "loss": p_loss.tolist(), "ref_loss": r_loss.tolist()}
        return {"loss_gap": loss_gap, "grad_gap": float(grad.max()),
                "grad_gap_median_leaf": float(grad.median()),
                "change_gap": float(change.max()),
                "change_gap_median_leaf": float(change[moving].median())}
