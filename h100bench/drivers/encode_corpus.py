"""Bulk encoding of a corpus staged on the card.

The program: ``BucketedEncodeServer.encode_batch`` (MFCC+D+DD features,
the normalizer, the encoder, the pre-VQ conv and the codebook search) at
the traffic's batch, on weights and a normalizer the benchmark makes from
the seed. The corpus: ``batches`` launches' worth of waves, generated on
the card in set-up and zero-padded to their bucket, a bucket's launches
holding one shape. Every seed gets the same multiset of lengths (evenly
spaced over each bucket's range) and of launches a bucket, in an order
and with contents drawn from the seed.

The window dispatches launches back to back, cycling through the corpus;
every ``group`` launches their codes go to the host through a pinned
buffer, and the host waits for a group's copy only after dispatching the
next group. The frames counted are the 10 ms MFCC frames of each wave's
true length, for launches whose codes reached the host in the window.

The check recomputes, for a sample of the window's launches drawn from
the seed (one of each bucket among them), every row's distances to the
codebook in the reference, and takes the widest gap by which the distance
of the code the program returned exceeds the nearest one, over the
launch's mean nearest distance.
"""
import time

import numpy as np
import torch

from h100bench import trace as tr
from h100bench.reference import plain


class Cell:
    # the program's spans are read over 12 launches
    # (h100bench/program_spans.py)
    SEGMENT_CALLS = 12

    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg, self.t = ctx.cfg, ctx.traffic
        self.dev = torch.device(ctx.device)

    def setup(self):
        from vqvae_speech_tpu_torch.serve import BucketedEncodeServer

        cfg, t, ref = self.cfg, self.t, self.ctx.ref
        plain.precision(tf32=False)
        t0 = time.perf_counter()
        self.params, host = plain.make_tree(ref.param_spec(cfg), self.ctx.seed,
                                            self.dev)
        C = cfg["input_features_filters"] * 3
        gen = torch.Generator(device=self.dev).manual_seed(self.ctx.seed + 3)
        self.normalizer = {
            "train_mean": torch.randn(C, generator=gen, device=self.dev),
            "train_std": torch.rand(C, generator=gen, device=self.dev) + 0.5}
        buckets = t["buckets"]
        self.server = BucketedEncodeServer(
            host, {}, cfg, wave_buckets=buckets, max_batch=t["batch"],
            normalizer={k: v.cpu().numpy()
                        for k, v in self.normalizer.items()},
            device=self.dev)
        self.ctx.note("setup_server_s", time.perf_counter() - t0)
        self._corpus(gen)
        self.ctx.note("setup_corpus_s", time.perf_counter() - t0)
        # one launch of each bucket: the kernels built, cuDNN's plans made
        for b in sorted(set(self.bucket_of)):
            self.server.encode_batch(self.waves[self.bucket_of.index(b)])
        self._sync()
        self.ctx.note("setup_warm_s", time.perf_counter() - t0)

    def _corpus(self, gen):
        t = self.t
        rng = np.random.default_rng(self.ctx.seed)
        buckets, B = t["buckets"], t["batch"]
        per = t["batches_per_bucket"]
        lo = [t["shortest"]] + buckets[:-1]
        self.bucket_of, self.waves, self.frames = [], [], []
        order = rng.permutation(len(buckets) * per)
        for j in order:
            bi, k = divmod(int(j), per)
            b = buckets[bi]
            # evenly spaced lengths over (lo, b], shuffled across launches
            grid = np.linspace(lo[bi] + 1, b, per * B).round().astype(int)
            lens = grid[np.arange(B) * per + k]
            wave = torch.randn((B, b), generator=gen, device=self.dev) * 0.1
            mask = (torch.arange(b, device=self.dev)[None, :]
                    < torch.as_tensor(lens, device=self.dev)[:, None])
            self.waves.append(wave * mask)
            self.bucket_of.append(b)
            self.frames.append(int(sum(plain.n_frames(int(n)) for n in lens)))

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def _launch(self, j):
        with tr.span("encode_batch"):
            return self.server.encode_batch(self.waves[j % len(self.waves)])

    def _drain(self, pending, done):
        """Wait for a group's copy to land; keep its codes."""
        event, host, js, shapes = pending
        if event is not None:
            event.synchronize()
        at = 0
        for j, shape in zip(js, shapes):
            n = int(np.prod(shape))
            done[j] = host[at:at + n].view(shape).numpy().copy()
            at += n

    def window(self, seconds):
        group = self.t["group"]
        cuda = self.dev.type == "cuda"
        done, pending = {}, None
        self._sync()
        t0 = time.perf_counter()
        j = 0
        while time.perf_counter() - t0 < seconds:
            codes = [self._launch(j + g) for g in range(group)]
            flat = torch.cat([c.reshape(-1) for c in codes])
            host = torch.empty(flat.shape, dtype=flat.dtype,
                               pin_memory=cuda)
            host.copy_(flat, non_blocking=cuda)
            event = torch.cuda.Event() if cuda else None
            if event is not None:
                event.record()
            if pending is not None:
                self._drain(pending, done)
            pending = (event, host, list(range(j, j + group)),
                       [tuple(c.shape) for c in codes])
            j += group
        self._drain(pending, done)
        wall = time.perf_counter() - t0
        self.codes = done
        frames = sum(self.frames[i % len(self.waves)] for i in done)
        self.ctx.note("launches", len(done))
        return {"metrics": {"encode_frames_per_s": frames / wall},
                "attempted": len(done) * self.t["batch"], "failed": 0}

    def drive_segment(self, n):
        base = len(self.codes)
        for g in range(n):
            self._launch(base + g)

    def trace(self):
        if self.dev.type != "cuda":
            return None
        from vqvae_speech_tpu_torch.ops._kernels import vq_search_cuda
        k1_before = vq_search_cuda.launches
        n = self.t["trace_launches"]
        base = len(self.codes)
        with tr.window() as traced:
            for g in range(n):
                self._launch(base + g)
        self.trace_stats = {"launches": [(base + g) % len(self.waves)
                                         for g in range(n)],
                            "k1_launches": vq_search_cuda.launches - k1_before}
        return traced

    def trace_gaps(self):
        base = len(self.codes)
        with tr.window(host=True) as traced:
            for g in range(max(1, self.t["trace_launches"] // 4)):
                self._launch(base + g)
        return traced.gaps

    def launch_shape(self, j):
        """(batch, feature frames, latent rows a launch) of launch j."""
        b = self.bucket_of[j]
        T = plain.n_frames(b)
        T2 = (T + 2 * 2 - 4) // 2 + 1
        return self.t["batch"], T, T2

    def release(self):
        del self.server

    def sample(self):
        """Launches of the window to check: one of each bucket, drawn from
        the seed, and ``check_launches`` in all."""
        rng = np.random.default_rng(self.ctx.seed + 1)
        ids = sorted(self.codes)
        picked = set()
        for b in sorted(set(self.bucket_of)):
            of_b = [i for i in ids if self.bucket_of[i % len(self.waves)] == b]
            if of_b:
                picked.add(int(rng.choice(of_b)))
        rest = [i for i in ids if i not in picked]
        extra = max(0, self.t["check_launches"] - len(picked))
        if rest and extra:
            picked |= set(rng.choice(rest, min(extra, len(rest)),
                                     replace=False).tolist())
        return sorted(picked)

    @torch.no_grad()
    def check(self, control=False):
        ref = self.ctx.ref
        worst, rows = 0.0 if self.codes else None, 0
        for i in self.sample():
            wave = self.waves[i % len(self.waves)]
            plain.precision(tf32=False)
            d = ref.code_distances(self.params, self.cfg, wave,
                                   self.normalizer)
            if control:
                plain.precision(tf32=True)
                picked = ref.code_distances(self.params, self.cfg, wave,
                                            self.normalizer).argmin(-1)
                plain.precision(tf32=False)
            else:
                picked = torch.as_tensor(self.codes[i], device=self.dev).long()
            if picked.shape != d.shape[:2]:
                return {"code_gap": float("inf")}
            chosen = d.gather(2, picked[..., None])[..., 0]
            gap = (chosen - d.min(-1).values).max()
            scale = d.min(-1).values.mean()
            worst = max(worst, float(gap / scale))
            rows += picked.numel()
        self.ctx.note("rows_compared", rows)
        return {"code_gap": worst}
