"""Continuous AR synthesis under a closed loop of clients.

The program: ``ContinuousSynthesisServer`` (f32, greedy) with the
traffic's slots, chunk and frame capacity, on a WaveNet whose weights the
benchmark makes from the seed. Every client submits its next request as
soon as its last completes, so with as many clients as slots every request
is admitted at the next ``step()``.

A request is ``frames`` frames of local conditioning (every length of the
traffic's range equally often, in an order drawn from the seed): ``frames +
1`` codes drawn from the seed, looked up in the seeded codebook and mixed by the
configuration's kernel-2 conv (the benchmark's own input preparation, in
plain PyTorch), and a speaker drawn from the traffic's ``speakers``.

The window: ``step()`` / ``collect()`` / ``submit()`` back to back for
``seconds``. Per step the harness counts the samples it delivered to live
streams (a chunk a stream, the last one partial) and stamps each stream's
chunk; a stream's gap is the time since its previous chunk, its first chunk
not counted. The check: a sample, drawn from the seed, of the requests that
completed in the window (the longest with them) is run through the
reference teacher-forced on its own served bins; the number is the widest
gap by which a served bin's logit lies below the reference's best.
"""
import time

import numpy as np
import torch

from h100bench import trace as tr
from h100bench.reference import plain


class Cell:
    # the program's spans are read over 6 chunks (h100bench/program_spans.py)
    SEGMENT_CALLS = 6

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.t = ctx.cfg, ctx.traffic
        self.dev = torch.device(ctx.device)

    # ---- set-up ----

    def setup(self):
        from vqvae_speech_tpu_torch.models.wavenet_decoder import (
            wavenet_config_from)
        from vqvae_speech_tpu_torch.serve import ContinuousSynthesisServer

        cfg, t, ref = self.cfg, self.t, self.ctx.ref
        plain.precision(tf32=False)
        spec = (ref.wavenet_spec(cfg)
                + [(("codebook",), (cfg["num_embeddings"],
                                    cfg["embedding_dim"]), "uniform",
                    1.0 / cfg["num_embeddings"])]
                + plain.conv_spec(("decoder", "conv_1"), cfg["embedding_dim"],
                                  cfg["local_condition_dim"], 2))
        t0 = time.perf_counter()
        self.params, host = plain.make_tree(spec, self.ctx.seed, self.dev)
        self.ctx.note("setup_weights_s", time.perf_counter() - t0)
        self.wcfg = wavenet_config_from(cfg, cfg["num_speakers"])
        wave_tree = {k: v for k, v in host.items()
                     if k not in ("codebook", "decoder")}
        self.server = ContinuousSynthesisServer(
            wave_tree, self.wcfg, slots=t["slots"], chunk_size=t["chunk"],
            max_frames=t["max_frames"], device=self.dev)
        self.up = self.server.model.upsample_factor
        self.ctx.note("setup_server_s", time.perf_counter() - t0)
        self._make_requests()
        self.inflight = {}      # rid -> [request index, remaining, last stamp]
        self.next_req = 0
        self.results = {}       # rid -> (request index, served bins)
        for _ in range(t["clients"]):
            self._submit()
        for _ in range(t["warm_steps"]):
            self._step(time.perf_counter(), None)
        self.results.clear()
        self._sync()
        self.ctx.note("setup_warm_s", time.perf_counter() - t0)

    def _make_requests(self):
        cfg, t = self.cfg, self.t
        rng = np.random.default_rng(self.ctx.seed)
        n = t["pool"]
        # every seed the same multiset of lengths, in its own order
        lo, hi = t["frames"]
        frames = rng.permutation(lo + np.arange(n) % (hi - lo + 1))
        codes = rng.integers(0, cfg["num_embeddings"],
                             (n, t["frames"][1] + 1))
        self.speakers = rng.integers(0, t["speakers"], n)
        with torch.no_grad():
            book = self.params["codebook"][torch.as_tensor(codes,
                                                           device=self.dev)]
            lc = self.ctx.ref.mix({"decoder": self.params["decoder"]}, book)
        self.conds = [lc[i, :frames[i]].contiguous() for i in range(n)]
        self.frames = frames

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def _submit(self):
        i = self.next_req % len(self.conds)
        self.next_req += 1
        rid = self.server.submit(self.conds[i], int(self.speakers[i]))
        self.inflight[rid] = [i, int(self.frames[i]) * self.up, None]
        return rid

    def _step(self, t_prev, rec):
        """One ``step()``; with ``rec`` (the window's record) counts the
        delivered samples and the streams' gaps."""
        admitted = sum(1 for v in self.inflight.values() if v[2] is None)
        with tr.span("step"):
            done = self.server.step()
        now = time.perf_counter()
        chunk = self.t["chunk"]
        delivered = 0
        for rid, v in self.inflight.items():
            delivered += min(v[1], chunk)
            v[1] -= chunk
            if rec is not None and v[2] is not None:
                rec["gaps"].append(now - v[2])
            v[2] = now
        if rec is not None:
            rec["samples"] += delivered
            rec["steps"].append((now - t_prev, admitted))
        for rid in done:
            with tr.span("collect"):
                res = self.server.collect(rid)
            i = self.inflight.pop(rid)[0]
            if rec is not None:
                self.results[rid] = (i, res.wave)
            with tr.span("submit"):
                self._submit()
        return now, delivered

    # ---- the window ----

    def window(self, seconds):
        rec = {"samples": 0, "gaps": [], "steps": []}
        self._sync()
        t0 = t_prev = time.perf_counter()
        while t_prev - t0 < seconds:
            t_prev, _ = self._step(t_prev, rec)
        wall = t_prev - t0
        self.rec = rec
        self.rec["slot_steps"] = (len(rec["steps"]) * self.t["slots"]
                                  * self.t["chunk"])
        self.ctx.note("gaps_counted", len(rec["gaps"]))
        self.ctx.note("chunks", len(rec["steps"]))
        self.ctx.note("requests_completed", len(self.results))
        return {"metrics": {
            "ar_samples_per_s": rec["samples"] / wall,
            "ar_chunk_gap_p95_ms": 1e3 * float(np.percentile(rec["gaps"], 95))},
            "attempted": len(self.results), "failed": 0}

    def _traced_steps(self, n, stats=None):
        t_prev = time.perf_counter()
        for _ in range(n):
            fresh = [v for v in self.inflight.values() if v[2] is None]
            if stats is not None:
                stats["admitted_samples"] += sum(
                    int(self.frames[v[0]]) * self.up for v in fresh)
            t_prev, delivered = self._step(t_prev, None)
            if stats is not None:
                stats["samples"] += delivered

    def drive_segment(self, n):
        self._traced_steps(n)

    def trace(self):
        """A few more steps of the loop under the profiler."""
        if self.dev.type != "cuda":
            return None
        from vqvae_speech_tpu_torch.ops._kernels import wavenet_step_cuda
        k2_before = wavenet_step_cuda.launches
        n = self.t["trace_steps"]
        stats = {"samples": 0, "admitted_samples": 0}
        with tr.window() as traced:
            self._traced_steps(n, stats)
        stats["steps"] = n * self.t["chunk"]
        stats["k2_launches"] = wavenet_step_cuda.launches - k2_before
        self.trace_stats = stats
        return traced

    def trace_gaps(self):
        with tr.window(host=True) as traced:
            self._traced_steps(1)
        return traced.gaps

    # ---- the check ----

    def release(self):
        del self.server
        self.inflight.clear()

    def sample(self):
        """The requests the check compares: ``check_requests`` drawn from the
        seed among those completed in the window, and the longest."""
        rids = sorted(self.results)
        if not rids:
            return []
        rng = np.random.default_rng(self.ctx.seed + 1)
        pick = set(rng.choice(rids, min(len(rids), self.t["check_requests"]),
                              replace=False).tolist())
        pick.add(max(rids, key=lambda r: len(self.results[r][1])))
        return sorted(pick)

    def check(self, control=False):
        """{"logit_gap": ...}: the widest gap, over every position of the
        sampled streams, between the reference's best logit and the logit
        of the bin the program served. With ``control`` the served bins are
        those the reference picks in TF32."""
        ref, p = self.ctx.ref, self.params
        wave_p = {k: v for k, v in p.items()
                  if k not in ("codebook", "decoder")}
        worst, tokens = 0.0 if self.results else None, 0
        for rid in self.sample():
            i, served = self.results[rid]
            served = torch.as_tensor(served, device=self.dev).long()
            cond = self.conds[i]
            spk = torch.tensor(int(self.speakers[i]), device=self.dev)
            plain.precision(tf32=False)
            logits = ref.served_logits(wave_p, self.cfg, cond, spk, served)
            picked = served
            if control:
                plain.precision(tf32=True)
                picked = ref.served_logits(wave_p, self.cfg, cond, spk,
                                           served).argmax(-1)
                plain.precision(tf32=False)
            gap = (logits.max(-1).values
                   - logits.gather(1, picked[:, None])[:, 0]).max()
            worst = max(worst, float(gap))
            tokens += served.numel()
        self.ctx.note("tokens_compared", tokens)
        return {"logit_gap": worst}
