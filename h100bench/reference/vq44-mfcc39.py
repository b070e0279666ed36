"""Plain reference of ``vq44-mfcc39``: the convolutional VQ-VAE on MFCC+D+DD
features (the reference repository's vctk_features.yaml, experiment
baseline-64 of experiments_vq44-mfcc39-batch_sizes.json).

encoder (Chorowski 2019, 768 hidden, tied residual stack of 2) -> conv k3
to D=64 -> the gradient VQ over (C, T, B) rows (K=44, q_latent + 0.25 *
e_latent, straight-through) -> conv k3 -> nearest x2 -> tied residual stack
-> transposed convs k3 p1, k3 p0, k2 p0 -> trimmed to the input's frames;
loss MSE(reconstruction, target features) + the VQ loss. f32, no weight
norm (use_kaiming_normal: false), no jitter, no speaker conditioning.
"""
import torch
import torch.nn.functional as F

from h100bench.reference import plain

# the configuration keys read by this reference and by the cells on it
KEYS = ("num_hiddens", "embedding_dim", "num_embeddings",
        "input_features_filters", "augment_input_features",
        "output_features_filters", "augment_output_features",
        "residual_channels", "num_residual_layers", "commitment_cost",
        "sampling_rate", "input_features_dim", "learning_rate", "batch_size")


def param_spec(cfg):
    hid, D, K = cfg["num_hiddens"], cfg["embedding_dim"], cfg["num_embeddings"]
    fin = cfg["input_features_filters"] * (3 if cfg["augment_input_features"]
                                           else 1)
    fout = cfg["output_features_filters"] * (
        3 if cfg["augment_output_features"] else 1)
    res = cfg["residual_channels"]

    def stack(path, c, r):
        return (plain.conv_spec(path + ("block", "conv1"), c, r, 3, bias=False)
                + plain.conv_spec(path + ("block", "conv2"), r, c, 1,
                                  bias=False))

    enc = ("encoder",)
    spec = (plain.conv_spec(enc + ("conv_1",), fin, hid, 3)
            + plain.conv_spec(enc + ("conv_2",), hid, hid, 3)
            + plain.conv_spec(enc + ("conv_3",), hid, hid, 4)
            + plain.conv_spec(enc + ("conv_4",), hid, hid, 3)
            + plain.conv_spec(enc + ("conv_5",), hid, hid, 3)
            + stack(enc + ("residual_stack",), hid, hid)
            + plain.conv_spec(("pre_vq_conv",), hid, D, 3)
            + [(("vq", "codebook"), (K, D), "uniform", 1.0 / K)])
    dec = ("decoder",)
    spec += (plain.conv_spec(dec + ("conv_1",), D, hid, 3)
             + stack(dec + ("residual_stack",), hid, res)
             + plain.conv_t_spec(dec + ("conv_trans_1",), hid, hid, 3)
             + plain.conv_t_spec(dec + ("conv_trans_2",), hid, hid, 3)
             + plain.conv_t_spec(dec + ("conv_trans_3",), hid, fout, 2))
    return spec


def latents(p, cfg, feats_btc):
    """(B, T, C_in) features -> (B, D, T') pre-VQ latents."""
    h = plain.encoder(feats_btc.transpose(1, 2), p["encoder"],
                      cfg["num_residual_layers"])
    return plain.conv1d(h, p["pre_vq_conv"], padding=1)


def loss(p, cfg, batch):
    """The training loss of one batch: (loss, reconstruction MSE)."""
    x = batch["input_features"]
    z = latents(p, cfg, x)
    q, vq_loss, _ = plain.vq_gradient(z, p["vq"]["codebook"],
                                      cfg["commitment_cost"])
    d = p["decoder"]
    h = plain.conv1d(q, d["conv_1"], padding=1)
    h = torch.repeat_interleave(h, 2, dim=2)
    h = plain.residual_stack(h, d["residual_stack"],
                             cfg["num_residual_layers"])
    h = F.relu(plain.conv_t1d(h, d["conv_trans_1"], padding=1))
    h = F.relu(plain.conv_t1d(h, d["conv_trans_2"], padding=0))
    recon = plain.conv_t1d(h, d["conv_trans_3"], padding=0)
    recon = recon[:, :, :x.shape[1]].transpose(1, 2)
    mse = torch.mean((recon - batch["output_features"]) ** 2)
    return vq_loss + mse, mse


def features(cfg, waves, normalizer):
    """(B, S) waves -> normalized (B, T, 39) MFCC+D+DD features."""
    f = plain.mfcc_delta(waves, cfg["sampling_rate"],
                         cfg["input_features_filters"])
    if normalizer is not None:
        f = (f - normalizer["train_mean"]) / normalizer["train_std"]
    return f


def code_distances(p, cfg, waves, normalizer):
    """Each wave's latent rows on batch-1 semantics (a (1, D, T') tensor's
    (C, T, B) rows are its D x T' buffer cut into rows of D) and their
    distances to every code: (B, T', K)."""
    z = latents(p, cfg, features(cfg, waves, normalizer))
    B, D, T = z.shape
    rows = z.reshape(B * T, D)
    return plain.distances(rows, p["vq"]["codebook"]).reshape(B, T, -1)
