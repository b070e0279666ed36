"""Plain reference of ``vctk-wavenet``'s decoder: the WaveNet of
WaveNet-VQ-VAE (the upstream repository's configurations/vctk_wavenet.yaml)
as its AR synthesis serves it, and the kernel-2 conv that mixes
neighbouring latents into its local conditioning.

A 20-layer WaveNet (2 cycles of dilations 1..512, kernel 3, residual and
gate 768, skip 256; every conv weight-normed): the conditioning upsampled
x384 by six single-channel transposed 2-D convs (kernel 3 over channels by
the scale over time, each followed by a ReLU), a 1x1 on the mu-law one-hot
input, gated layers ``tanh(a) * sigmoid(b)`` of the causal dilated conv
plus the 1x1 projections of the local and global (128-wide speaker
embedding) conditioning, residual ``(x + out) * sqrt(1/2)``, skips summed
with the sqrt(1/2) scaling after the first layer, then ReLU, 1x1, ReLU, 1x1
to 256 logits. Weights carry the JAX package's init distributions (the
dilated conv's std scaled by the 0.95 keep rate of its dropout).
"""
import math

import torch
import torch.nn.functional as F

from h100bench.reference import plain

# the configuration keys read by this reference and by the cells on it
KEYS = ("n_layers", "n_loop", "residual_channels", "gate_channels",
        "skip_out_channels", "filter_size", "local_condition_dim",
        "global_condition_dim", "quantize", "num_speakers", "num_embeddings",
        "embedding_dim", "num_hiddens", "learning_rate", "batch_size")
UPSAMPLE_SCALES = (2, 2, 2, 2, 2, 12)
DROPOUT = 1 - 0.95


def wavenet_sizes(cfg):
    return dict(layers=cfg["n_layers"], stacks=cfg["n_loop"],
                C=cfg["residual_channels"], G=cfg["gate_channels"],
                S=cfg["skip_out_channels"], k=cfg["filter_size"],
                cin=cfg["local_condition_dim"],
                gin=cfg["global_condition_dim"], Q=cfg["quantize"],
                speakers=cfg["num_speakers"])


def wavenet_spec(cfg, prefix=()):
    s = wavenet_sizes(cfg)

    def wn(path, cin, cout, k, dropout=0.0):
        return plain.conv_spec(prefix + path, cin, cout, k, wn=True,
                               std=math.sqrt((1.0 - dropout) / (k * cin)))

    spec = wn(("first_conv",), s["Q"], s["C"], 1)
    for l in range(s["layers"]):
        at = ("conv_layers", l)
        spec += (wn(at + ("conv",), s["C"], s["G"], s["k"], DROPOUT)
                 + wn(at + ("conv1x1_out",), s["G"] // 2, s["C"], 1)
                 + wn(at + ("conv1x1_skip",), s["G"] // 2, s["S"], 1)
                 + wn(at + ("conv1x1c",), s["cin"], s["G"], 1)
                 + wn(at + ("conv1x1g",), s["gin"], s["G"], 1))
    spec += (wn(("last_conv_1",), s["S"], s["S"], 1)
             + wn(("last_conv_2",), s["S"], s["Q"], 1)
             + [(prefix + ("embed_speakers", "table"),
                 (s["speakers"], s["gin"]), "normal", 0.1)])
    for i, sc in enumerate(UPSAMPLE_SCALES):
        at = prefix + ("upsample_conv", i)
        spec += [(at + ("v",), (3, sc, 1, 1), "fill", 1.0 / 3),
                 (at + ("g",), (1,), "wn_g_all", None),
                 (at + ("b",), (1,), "zeros", None)]
    return spec


def upsample(p, c_btc):
    """(B, Tc, cin) -> (B, Tc * 384, cin)."""
    x = c_btc.transpose(1, 2)[:, None]
    for stage, sc in zip(p["upsample_conv"], UPSAMPLE_SCALES):
        v = stage["v"]
        w = (stage["g"] * v / v.square().sum().sqrt()).permute(2, 3, 0, 1)
        x = F.relu(F.conv_transpose2d(x, w, stage["b"], stride=(1, sc),
                                      padding=(1, 0)))
    return x[:, 0].transpose(1, 2)


def wavenet(p, cfg, x_onehot, c_btc, speakers):
    """Teacher-forced logits (B, T, Q) of one-hot inputs (B, T, Q), local
    conditioning (B, Tc, cin) at the latent rate and speaker ids (B,)."""
    s = wavenet_sizes(cfg)
    T = x_onehot.shape[1]
    c = upsample(p, c_btc)[:, :T].transpose(1, 2)
    g = p["embed_speakers"]["table"][speakers.long()][:, :, None]
    h = plain.conv1d(x_onehot.transpose(1, 2), p["first_conv"])
    per_stack = s["layers"] // s["stacks"]
    half = math.sqrt(0.5)
    skips = None
    for l, lp in enumerate(p["conv_layers"]):
        d = 2 ** (l % per_stack)
        residual = h
        a = plain.conv1d(F.pad(h, ((s["k"] - 1) * d, 0)), lp["conv"],
                         dilation=d)
        a = a + plain.conv1d(c, lp["conv1x1c"]) + plain.conv1d(g, lp["conv1x1g"])
        ga, gb = a.chunk(2, dim=1)
        z = torch.tanh(ga) * torch.sigmoid(gb)
        h = (plain.conv1d(z, lp["conv1x1_out"]) + residual) * half
        sk = plain.conv1d(z, lp["conv1x1_skip"])
        skips = sk if skips is None else (skips + sk) * half
    out = F.relu(plain.conv1d(F.relu(skips), p["last_conv_1"]))
    return plain.conv1d(out, p["last_conv_2"]).transpose(1, 2)


def mix(p, codes_or_latents):
    """The kernel-2 mixer: (B, T_lat, D) -> (B, T_lat - 1, 768)."""
    return plain.conv1d(codes_or_latents.transpose(1, 2),
                        p["decoder"]["conv_1"]).transpose(1, 2)


@torch.no_grad()
def served_logits(p, cfg, cond, speaker, served):
    """Teacher-forced logits (n, Q) over one served stream: the input is
    mu-law bin 127, then the stream's own bins; ``cond`` (frames, cin) the
    request's local conditioning, ``served`` (n,) its bins."""
    Q = cfg["quantize"]
    inp = torch.cat([torch.tensor([127], device=served.device),
                     served[:-1].long()])
    x = F.one_hot(inp, Q).float()[None]
    return wavenet(p, cfg, x, cond[None], speaker.reshape(1))[0]
