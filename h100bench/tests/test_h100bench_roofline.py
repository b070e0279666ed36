"""The yardstick's counts against hand counts and against the bounds the
port's kernel table gives (K2 at vctk_wavenet width and 64 streams, K1 at
the flagship's N=1536, K=44, D=64)."""
import pytest

from h100bench import roofline as rf


def test_k2_bound_at_vctk_wavenet_width_and_64_streams():
    flops, nbytes = rf.k2_counts(20, 3, 768, 768, 256, 64)
    # a layer: 3 taps of 768 x 768, then 384 x 256 and 384 x 768
    assert flops == 2 * 20 * (3 * 768 * 768 + 384 * 256 + 384 * 768) * 64
    t, kind = rf.bound_seconds(flops, nbytes)
    assert kind == "operations"
    assert t * 1e3 == pytest.approx(0.0826, abs=5e-5)


def test_k2_bound_at_eight_streams_is_the_weights():
    t, kind = rf.bound_seconds(*rf.k2_counts(20, 3, 768, 768, 256, 8))
    assert kind == "bytes" and t * 1e3 == pytest.approx(0.0523, abs=5e-5)


def test_k1_bound_at_the_flagship_shape():
    flops, nbytes = rf.k1_counts(1536, 44, 64)
    assert flops == 2 * 1536 * 44 * 64
    # rows and codebook in; indices, quantized rows, counts, dw out
    assert nbytes == 4 * (1536 * 64 * 2 + 44 * 64 * 2 + 1536 + 44)
    t, kind = rf.bound_seconds(flops, nbytes)
    assert kind == "bytes" and t * 1e3 == pytest.approx(0.00024, abs=5e-6)


def test_conv_and_encoder_counts():
    assert rf.conv_flops(2, 3, 4, 5, 6) == 2 * 2 * 3 * 4 * 5 * 6
    f, T2 = rf.encoder_flops(39, 768, 768, 47, 2)
    assert T2 == 24
    hand = (2 * 39 * 768 * 3 * 47 + 2 * 768 * 768 * 3 * 47
            + 2 * 768 * 768 * 4 * 24 + 2 * 2 * 768 * 768 * 3 * 24
            + 2 * (2 * 768 * 768 * 3 * 24 + 2 * 768 * 768 * 24))
    assert f == hand


def test_flagship_step_is_about_4_5_gflop_an_example():
    cfg = {"num_hiddens": 768, "embedding_dim": 64, "num_embeddings": 44,
           "input_features_filters": 13, "output_features_filters": 13,
           "residual_channels": 768, "num_residual_layers": 2}
    fwd = rf.conv_vqvae_forward_flops(cfg, 47, 1)
    assert 1.4e9 < fwd < 1.6e9
    assert rf.train_flops(fwd, 0) == 3 * fwd


def test_decode_and_upsampling_counts():
    cfg = {"residual_channels": 768, "gate_channels": 768,
           "skip_out_channels": 256, "filter_size": 3, "quantize": 256,
           "local_condition_dim": 768, "n_layers": 20}
    # the layer stack as K2 computes it, and the head's two 1x1s
    assert rf.decode_sample_flops(cfg) == \
        rf.k2_counts(20, 3, 768, 768, 256, 1)[0] + 2 * (256 * 256 + 256 * 256)
    # stage outputs 2, 4, 8, 16, 32 and 384 a frame: 446 / 384 of n
    assert rf.upsample_flops(cfg, 384) == pytest.approx(2 * 3 * 768 * 446)
    assert rf.admission_flops(cfg, 384) == pytest.approx(
        2 * 3 * 768 * 446 + 2 * 20 * 768 * 768 * 384)


def test_k3_bf16_bound_of_the_student_chain():
    """The ClariNet student's chain (L=6, k=3, C=128, G=256, S=128, cin=80)
    at T=20480: the kernel table's tensor bound at the bf16 peak, and its
    bytes at bf16."""
    flops, nbytes = rf.k3_counts(6, 3, 128, 256, 128, 80, 20480, bf16=True)
    assert flops == 2 * 20480 * 6 * ((3 * 128 + 80) * 512 + 256 * 256)
    t, kind = rf.bound_seconds(flops, nbytes, rf.PEAK_BF16_TENSOR_FLOPS)
    assert kind == "operations" and t * 1e3 == pytest.approx(0.0753, abs=5e-5)
    assert nbytes / rf.PEAK_HBM_BYTES * 1e3 == pytest.approx(0.0083, abs=5e-5)


def test_k3_f32_bounds_of_the_student_chain():
    """The same chain in f32: the f32 bound, and three TF32 products a f32
    product at the TF32 peak (the error-compensated design's least time)."""
    flops, nbytes = rf.k3_counts(6, 3, 128, 256, 128, 80, 20480)
    t, kind = rf.bound_seconds(flops, nbytes)
    assert kind == "operations" and t * 1e3 == pytest.approx(1.1118, abs=5e-5)
    t, _ = rf.bound_seconds(3 * flops, nbytes, rf.PEAK_TF32_TENSOR_FLOPS)
    assert t * 1e3 == pytest.approx(0.4515, abs=5e-5)
