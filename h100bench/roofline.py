"""Operations, bytes and FLOPs from shapes, and the chip's published peaks.

The peaks are NVIDIA's published figures for the H100 SXM (dense, no
sparsity, at the full 700 W): 67 TFLOP/s in f32 outside the tensor cores,
which is where the f32 configurations run (TF32 off), 495 TFLOP/s in TF32
and 989 TFLOP/s in bf16 on the tensor cores, and 3.35 TB/s of HBM3. A
kernel's bound is the larger of its operations over the peak of the unit
and precision it computes in (f32 unless a reader says otherwise) and its
bytes over the memory peak, with every input byte read once and every
output byte written once. A whole step's FLOPs count the model's
multiply-adds as two operations each.
"""
import math

PEAK_F32_FLOPS = 67e12
PEAK_TF32_TENSOR_FLOPS = 495e12
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
F32 = 4
BF16 = 2


def bound_seconds(flops: float, nbytes: float, peak: float = PEAK_F32_FLOPS):
    """(seconds, "operations" or "bytes"): the least time the chip could
    take, its operations at ``peak`` FLOP/s."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---- K1: the codebook search ----

def k1_counts(N: int, K: int, D: int):
    """(flops, bytes) of one search of N rows against K codes of width D:
    the N x K distances' products; the rows and the codebook read, the
    indices, quantized rows, counts and dw written."""
    flops = 2 * N * K * D
    nbytes = F32 * (N * D + K * D + N + N * D + K + K * D)
    return flops, nbytes


def k1_bound(N: int, K: int, D: int) -> float:
    return bound_seconds(*k1_counts(N, K, D))[0]


# ---- K2: the decode step's layer stack ----

def k2_counts(layers: int, k: int, C: int, G: int, S: int, B: int):
    """(flops, bytes) of one decode step of B streams through L gated
    layers: per layer and stream the k-tap conv (k * C * G), the skip
    (G/2 * S) and residual (G/2 * C) projections; the weights and biases
    read once, each stream's input, taps and conditioning read, its
    per-layer outputs, skip sum and last output written."""
    h = G // 2
    per_layer = k * C * G + h * S + h * C
    flops = 2 * layers * per_layer * B
    weights = layers * (per_layer + G + S + C)
    acts_in = B * (C + layers * (k - 1) * C + layers * G)
    acts_out = B * (layers * C + S + C)
    return flops, F32 * (weights + acts_in + acts_out)


def k2_bound(layers, k, C, G, S, B) -> float:
    return bound_seconds(*k2_counts(layers, k, C, G, S, B))[0]


# ---- K3: a one-pass vocoder's resblock chain ----

def k3_counts(layers: int, k: int, C: int, G: int, S: int, cin: int, T: int,
              bf16: bool = False):
    """(flops, bytes) of one chain of L gated layers over T rows: per layer
    and row the gate's products, the k-tap conv and the conditioning 1x1
    into 2G channels ((k * C + cin) * 2G), and the GLU's G outputs projected
    to the residual and the skip (G * (C + S)); x, the upsampled
    conditioning and the weights read once, x and the skip sum written
    once. At ``bf16`` x, the conditioning, the weights and the written x
    are bf16, the biases and the skip f32."""
    flops = 2 * T * layers * ((k * C + cin) * 2 * G + G * (C + S))
    weights = layers * (2 * k * C * G + 2 * cin * G + G * (C + S))
    biases = layers * (2 * G + C + S)
    if not bf16:
        return flops, F32 * (T * (C + cin) + weights + biases + T * (C + S))
    return flops, (BF16 * (T * (C + cin) + weights + T * C)
                   + F32 * (biases + T * S))


# ---- whole steps ----

def conv_flops(cin, cout, k, t_out, batch=1):
    return 2 * cin * cout * k * t_out * batch


def _stack_flops(C, R, T, n):
    return n * (conv_flops(C, R, 3, T) + conv_flops(R, C, 1, T))


def encoder_flops(fin, hid, res, T, n_res):
    """The Chorowski encoder on T feature frames (one example); returns
    (flops, latent frames)."""
    T2 = (T + 2 * 2 - 4) // 2 + 1
    f = (conv_flops(fin, hid, 3, T) + conv_flops(hid, hid, 3, T)
         + conv_flops(hid, hid, 4, T2) + 2 * conv_flops(hid, hid, 3, T2)
         + _stack_flops(hid, res, T2, n_res))
    return f, T2


def conv_vqvae_forward_flops(cfg, T: int, batch: int) -> float:
    """Forward FLOPs of the convolutional VQ-VAE at T frames a example."""
    hid, D, K = cfg["num_hiddens"], cfg["embedding_dim"], cfg["num_embeddings"]
    fin = cfg["input_features_filters"] * 3
    fout = cfg["output_features_filters"] * 3
    enc, T2 = encoder_flops(fin, hid, hid, T, cfg["num_residual_layers"])
    f = enc + conv_flops(hid, D, 3, T2) + 2 * T2 * K * D
    T4 = 2 * T2
    f += (conv_flops(D, hid, 3, T2) + _stack_flops(hid, cfg["residual_channels"],
                                                    T4, cfg["num_residual_layers"])
          + conv_flops(hid, hid, 3, T4) + conv_flops(hid, hid, 3, T4)
          + conv_flops(hid, fout, 2, T4 + 2))
    return f * batch


def train_flops(forward: float, first_conv: float) -> float:
    """Forward + backward: the backward computes each weight's gradient
    and each activation's (twice the forward) except the input's."""
    return 3 * forward - first_conv


def decode_sample_flops(cfg) -> float:
    """One decode step of one stream: the layer stack (the conditioning is
    projected at admission) and the head; the input is a row gather."""
    C, G, S, k = (cfg["residual_channels"], cfg["gate_channels"],
                  cfg["skip_out_channels"], cfg["filter_size"])
    h = G // 2
    return (2 * cfg["n_layers"] * (k * C * G + h * S + h * C)
            + 2 * (S * S + S * cfg["quantize"]))


def upsample_flops(cfg, n_samples: int, scales=(2, 2, 2, 2, 2, 12)) -> float:
    """Upsampling one request's conditioning to n samples: six transposed
    2-D convs whose every output takes 3 taps (kernel 3 over channels,
    stride = kernel over time), over the 768 channels."""
    total, rate = 0, 1
    for s in scales:
        rate *= s
        total += rate
    return 2 * 3 * cfg["local_condition_dim"] * n_samples * total / rate


def admission_flops(cfg, n_samples: int) -> float:
    """Admitting a request of n samples: the upsampling, then the
    conditioning projected into every layer (cin x G a layer and
    sample)."""
    cin, G = cfg["local_condition_dim"], cfg["gate_channels"]
    return upsample_flops(cfg, n_samples) + 2 * cfg["n_layers"] * cin * G * n_samples


def mfcc_flops_per_frame(nfft=512, nfilt=26, numcep=13) -> float:
    """A real FFT (2.5 n log2 n), the power spectrum, the filterbank, the
    DCT and the deltas of one feature frame."""
    return (2.5 * nfft * math.log2(nfft) + 3 * (nfft // 2 + 1)
            + 2 * (nfft // 2 + 1) * nfilt + 2 * nfilt * numcep + 40 * numcep)


def encode_flops(cfg, T_feat: int, batch: int) -> float:
    """Features, encoder, pre-VQ conv and the search of one launch."""
    hid, D, K = cfg["num_hiddens"], cfg["embedding_dim"], cfg["num_embeddings"]
    enc, T2 = encoder_flops(cfg["input_features_filters"] * 3, hid, hid,
                            T_feat, cfg["num_residual_layers"])
    return batch * (T_feat * mfcc_flops_per_frame() + enc
                    + conv_flops(hid, D, 3, T2) + 2 * T2 * K * D)
