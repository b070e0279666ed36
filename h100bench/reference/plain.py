"""Plain PyTorch pieces the configurations' references share.

Everything here works on a parameter tree in the JAX package's layout (a
nested dict of f32 tensors: a conv kernel is (K, Cin, Cout), a transposed
conv's (K, Cout, Cin), a weight-normed conv holds ``v``, ``g`` and ``b``),
which the benchmark makes from the seed and hands, as the same raw values,
to the program's loader and to these functions. Nothing here imports the
program: the layer equations are written out from the model descriptions
(the Chorowski et al. 2019 encoder, the VQ-VAE quantizer, van den Oord et
al.'s WaveNet, python_speech_features' MFCC), each in a few plain calls.
"""
import math

import numpy as np
import torch
import torch.nn.functional as F

F32_EPS = float(np.finfo(np.float32).eps)


# ---- the benchmark's weights ----

def make_tree(spec, seed: int, device):
    """Fill a parameter tree from ``spec`` (a list of (path, shape, init,
    scale)) with two draws of a generator on ``device`` seeded with
    ``seed``: one normal and one uniform block for all leaves. ``init`` is
    ``normal`` (scale = std), ``uniform`` (scale = bound), ``wn_g`` (the
    norm of the preceding ``v`` over all axes but the last: the weight is
    then ``v`` itself), ``wn_g_all`` (the norm over every axis), ``fill``
    (the constant ``scale``) or ``zeros``. Returns (tree of device tensors,
    tree of numpy arrays) that share one flat buffer each."""
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    total = sum(sizes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    flat = torch.empty(total, device=device)
    at, leaves, last_v = 0, [], None
    for (path, shape, init, scale), n in zip(spec, sizes):
        seg = flat[at:at + n]
        if init == "normal":
            seg.copy_(normal[at:at + n] * scale)
            last_v = seg.view(shape)
        elif init == "uniform":
            seg.copy_((uniform[at:at + n] * 2.0 - 1.0) * scale)
            last_v = seg.view(shape)
        elif init == "wn_g":
            seg.copy_(last_v.square().sum(tuple(range(last_v.dim() - 1)))
                      .sqrt().reshape(-1))
        elif init == "wn_g_all":
            seg.copy_(last_v.square().sum().sqrt().reshape(-1))
        elif init == "fill":
            seg.fill_(scale)
            last_v = seg.view(shape)
        elif init == "zeros":
            seg.zero_()
        else:
            raise ValueError(f"unknown init {init!r}")
        leaves.append((path, seg.view(shape)))
        at += n
    del normal, uniform
    host = flat.cpu().numpy()
    dev_tree, host_tree, at = {}, {}, 0
    for (path, t), n in zip(leaves, sizes):
        put(dev_tree, path, t)
        put(host_tree, path, host[at:at + n].reshape(t.shape))
        at += n
    return dev_tree, host_tree


def put(tree, path, value):
    node = tree
    for i, key in enumerate(path[:-1]):
        nxt = path[i + 1]
        if isinstance(node, list):
            while len(node) <= key:
                node.append(None)
            if node[key] is None:
                node[key] = [] if isinstance(nxt, int) else {}
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    if isinstance(node, list):
        while len(node) <= path[-1]:
            node.append(None)
    node[path[-1]] = value


def leaves(tree, prefix=()):
    """(path, tensor) of every leaf of a nested dict/list tree."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, value in items:
        if isinstance(value, (dict, list)):
            yield from leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def conv_spec(path, cin, cout, k, *, bias=True, wn=False, std=None):
    """A conv's leaves: the JAX init's shapes (kernel (k, cin, cout)); a
    plain kernel and bias uniform in +-1/sqrt(cin * k) (nn/conv.py's
    conv1d_init), a weight-normed one v ~ N(0, std) with g = ||v||."""
    shape = (k, cin, cout)
    bound = 1.0 / math.sqrt(cin * k)
    if wn:
        out = [(path + ("v",), shape, "normal",
                std if std is not None else math.sqrt(2.0 / (cin * k))),
               (path + ("g",), (cout,), "wn_g", None)]
    else:
        out = [(path + ("w",), shape, "uniform", bound)]
    if bias:
        out.append((path + ("b",), (cout,), "zeros" if wn else "uniform",
                    bound))
    return out


def conv_t_spec(path, cin, cout, k):
    """A plain transposed conv (kernel (k, cout, cin), bias (cout,))."""
    bound = 1.0 / math.sqrt(cout * k)
    return [(path + ("w",), (k, cout, cin), "uniform", bound),
            (path + ("b",), (cout,), "uniform", bound)]


# ---- layers on the JAX layout ----

def conv_weight(p) -> torch.Tensor:
    """(Cout, Cin, K) from a conv's leaves (weight norm resolved over the
    kernel's (K, Cin) axes, one magnitude an output channel)."""
    if "v" in p:
        v = p["v"]
        w = p["g"] * v / v.square().sum((0, 1), keepdim=True).sqrt()
    else:
        w = p["w"]
    return w.permute(2, 1, 0)


def conv1d(x_bct, p, *, padding=0, stride=1, dilation=1):
    return F.conv1d(x_bct, conv_weight(p), p.get("b"), stride=stride,
                    padding=padding, dilation=dilation)


def conv_t1d(x_bct, p, *, padding=0):
    """A transposed conv: JAX's (K, Cout, Cin) kernel is torch's
    (Cin, Cout, K) once its axes are reversed."""
    return F.conv_transpose1d(x_bct, p["w"].permute(2, 1, 0), p["b"],
                              padding=padding)


def residual_stack(x, p, n_layers):
    """One residual block (ReLU, conv k3 p1, ReLU, conv k1; no biases)
    applied ``n_layers`` times with the same weights, then a ReLU."""
    for _ in range(n_layers):
        h = conv1d(F.relu(x), p["block"]["conv1"], padding=1)
        x = x + conv1d(F.relu(h), p["block"]["conv2"])
    return F.relu(x)


def encoder(x_bct, p, n_res):
    """The Chorowski 2019 encoder: conv k3, conv k3 + skip, conv k4 s2 p2,
    two conv k3 + skip, the tied residual stack + skip; ReLU after each."""
    x1 = F.relu(conv1d(x_bct, p["conv_1"], padding=1))
    x = F.relu(conv1d(x1, p["conv_2"], padding=1)) + x1
    x3 = F.relu(conv1d(x, p["conv_3"], padding=2, stride=2))
    x4 = F.relu(conv1d(x3, p["conv_4"], padding=1)) + x3
    x5 = F.relu(conv1d(x4, p["conv_5"], padding=1)) + x4
    return residual_stack(x5, p["residual_stack"], n_res) + x5


def flatten_ctb(z_bct, D):
    """The reference repository's codebook rows: the (B, C, T) latents
    permuted to (C, T, B) and cut into rows of D."""
    return z_bct.permute(1, 2, 0).reshape(-1, D)


def unflatten_ctb(rows, B, C, T):
    return rows.reshape(C, T, B).permute(2, 0, 1)


def distances(rows, codebook):
    """(N, D), (K, D) -> (N, K) squared L2 distances, expanded as the
    VQ-VAE reference implementation computes them: |z|^2 + |e|^2 - 2 z.e."""
    return (rows.square().sum(1, keepdim=True) + codebook.square().sum(1)
            - 2.0 * rows @ codebook.t())


def vq_gradient(z_bct, codebook, commitment):
    """The gradient VQ: nearest code by L2 over the (C, T, B) rows, losses
    q_latent + beta * e_latent, straight-through output (B, C, T).
    Returns (quantized_st, vq_loss, indices)."""
    B, C, T = z_bct.shape
    D = codebook.shape[1]
    rows = flatten_ctb(z_bct, D)
    with torch.no_grad():
        idx = torch.argmin(distances(rows, codebook), dim=1)
    q = unflatten_ctb(codebook[idx], B, C, T)
    e_latent = torch.mean((q.detach() - z_bct) ** 2)
    q_latent = torch.mean((q - z_bct.detach()) ** 2)
    vq_loss = q_latent + commitment * e_latent
    return z_bct + (q - z_bct).detach(), vq_loss, idx


# ---- features: python_speech_features' MFCC, batched ----

def _hz2mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, np.float64) / 700.0)


def _mel2hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, np.float64) / 2595.0) - 1.0)


def mel_filterbank(nfilt=26, nfft=512, rate=16000):
    mels = np.linspace(_hz2mel(0.0), _hz2mel(rate / 2), nfilt + 2)
    bins = np.floor((nfft + 1) * _mel2hz(mels) / rate).astype(np.int64)
    fb = np.zeros((nfilt, nfft // 2 + 1))
    for j in range(nfilt):
        lo, mid, hi = bins[j], bins[j + 1], bins[j + 2]
        fb[j, lo:mid] = (np.arange(lo, mid) - lo) / (mid - lo)
        fb[j, mid:hi] = (hi - np.arange(mid, hi)) / (hi - mid)
    return fb


def n_frames(n_samples, frame_len=400, step=160):
    if n_samples <= frame_len:
        return 1
    return 1 + int(math.ceil((n_samples - frame_len) / step))


def _delta(feat, N=2):
    T = feat.shape[-2]
    padded = torch.cat([feat[..., :1, :].expand(*feat.shape[:-2], N, -1),
                        feat,
                        feat[..., -1:, :].expand(*feat.shape[:-2], N, -1)],
                       dim=-2)
    out = sum(n * (padded[..., N + n:N + n + T, :]
                   - padded[..., N - n:N - n + T, :])
              for n in range(1, N + 1))
    return out / (2.0 * sum(n * n for n in range(1, N + 1)))


def mfcc_delta(signal, rate=16000, numcep=13, nfilt=26, nfft=512):
    """(B, S) -> (B, T, 3 * numcep): MFCC (pre-emphasis 0.97, 25 ms frames
    every 10 ms, zero-padded tail, |rfft|^2 / nfft, 26 mel filters, log,
    orthonormal DCT-II, lifter 22, log energy in c0), then its delta and
    delta-delta over +-2 frames with the edges repeated."""
    x = torch.cat([signal[:, :1], signal[:, 1:] - 0.97 * signal[:, :-1]], 1)
    flen, step = int(0.025 * rate), int(0.010 * rate)
    T = n_frames(x.shape[1], flen, step)
    x = F.pad(x, (0, (T - 1) * step + flen - x.shape[1]))
    frames = x.unfold(1, flen, step)
    pspec = torch.fft.rfft(frames, n=nfft).abs().square() / nfft
    energy = pspec.sum(-1)
    energy = torch.where(energy == 0, F32_EPS, energy)
    fb = torch.as_tensor(mel_filterbank(nfilt, nfft, rate), dtype=x.dtype,
                         device=x.device)
    feat = pspec @ fb.t()
    feat = torch.where(feat == 0, F32_EPS, feat)
    k = np.arange(numcep)[None, :]
    i = np.arange(nfilt)[:, None]
    dct = np.cos(np.pi * k * (2 * i + 1) / (2 * nfilt)) * np.sqrt(2.0 / nfilt)
    dct[:, 0] = np.sqrt(1.0 / nfilt)
    lifter = 1.0 + 11.0 * np.sin(np.pi * np.arange(numcep) / 22.0)
    cep = torch.log(feat) @ torch.as_tensor(dct * lifter[None, :],
                                            dtype=x.dtype, device=x.device)
    cep = torch.cat([torch.log(energy)[..., None], cep[..., 1:]], -1)
    d = _delta(cep)
    return torch.cat([cep, d, _delta(d)], -1)


# ---- optax's amsgrad, leaf by leaf ----

def amsgrad_init(params):
    return {"count": 0,
            "mu": [torch.zeros_like(p) for p in params],
            "nu": [torch.zeros_like(p) for p in params],
            "nu_max": [torch.zeros_like(p) for p in params]}


@torch.no_grad()
def amsgrad_update(params, grads, state, lr, b1=0.9, b2=0.999, eps=1e-8):
    """optax.amsgrad: the running maximum over the bias-corrected second
    moment, the step lr * mu_hat / (sqrt(nu_max) + eps)."""
    state["count"] += 1
    t = np.float32(state["count"])
    bc1 = float(np.float32(1) - np.float32(b1) ** t)
    bc2 = float(np.float32(1) - np.float32(b2) ** t)
    for p, g, mu, nu, nm in zip(params, grads, state["mu"], state["nu"],
                                state["nu_max"]):
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1 - b2)
        torch.maximum(nm, nu / bc2, out=nm)
        p.sub_(lr * (mu / bc1) / (nm.sqrt() + eps))


def precision(tf32: bool):
    """Set the f32 path: TF32 off (the configurations' f32) or on (the
    controls' lower precision), for cuBLAS and cuDNN alike."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
