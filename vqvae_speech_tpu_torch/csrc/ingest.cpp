// Native host-side ingest kernels: RMS silence trim, mu-law encode,
// peak normalization.  These are the per-utterance CPU hot spots of the
// corpus export path (the reference runs them in Python/numpy inside
// DataLoader worker processes; here they are vectorized C++ called via
// ctypes, shared-memory, no worker processes).
//
// A copy of the repository's native/ingest.cpp for the PyTorch port, which
// builds it at first use (vqvae_speech_tpu_torch/native.py) with the same
// flags into vqvae_speech_tpu_torch/build/:
//   g++ -O3 -march=native -shared -fPIC -o libingest.so ingest.cpp
#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>

extern "C" {

// Center-padded framewise RMS trim (librosa.effects.trim semantics, mirrors
// vqvae_speech_tpu_torch/data/audio.py:trim_silence).  Writes [start, end) sample
// bounds; returns 0 on success.
int rms_trim_bounds(const float* y, int64_t n, int frame_length,
                    int hop_length, float top_db, int64_t* out_start,
                    int64_t* out_end) {
    if (n <= 0) { *out_start = 0; *out_end = 0; return 0; }
    const int pad = frame_length / 2;
    const int64_t padded = n + 2 * pad;
    const int64_t n_frames = 1 + (padded - frame_length) / hop_length;

    // prefix sums of squares over the zero-padded signal
    // frame i covers padded indices [i*hop, i*hop+frame_length)
    double ref = 0.0;
    double* rms = new double[n_frames];
    for (int64_t i = 0; i < n_frames; ++i) {
        const int64_t lo = i * hop_length - pad;        // unpadded index
        const int64_t hi = lo + frame_length;
        const int64_t a = std::max<int64_t>(lo, 0);
        const int64_t b = std::min<int64_t>(hi, n);
        double acc = 0.0;
        for (int64_t j = a; j < b; ++j) acc += (double)y[j] * y[j];
        rms[i] = std::sqrt(acc / frame_length);
        ref = std::max(ref, rms[i]);
    }
    if (ref <= 0.0) { *out_start = 0; *out_end = n; delete[] rms; return 0; }
    const double threshold = ref * std::pow(10.0, -top_db / 20.0);
    int64_t first = -1, last = -1;
    for (int64_t i = 0; i < n_frames; ++i) {
        if (rms[i] > threshold) { if (first < 0) first = i; last = i; }
    }
    delete[] rms;
    if (first < 0) { *out_start = 0; *out_end = 0; return 0; }
    *out_start = first * hop_length;
    *out_end = std::min<int64_t>(n, (last + 1) * hop_length);
    return 0;
}

// Mu-law companding into [0, mu-1] integer bins (mirrors
// vqvae_speech_tpu/ops/mu_law.py, reference src/speech_utils/mu_law.py:34-39).
void mu_law_encode(const float* x, int64_t n, int mu, int32_t* out) {
    const float log1p_mu = std::log1p((float)mu);
    const float half_mu = mu / 2.0f;
    for (int64_t i = 0; i < n; ++i) {
        const float v = x[i];
        const float s = (v > 0.f) - (v < 0.f);
        const float y = s * std::log1p(mu * std::fabs(v)) / log1p_mu;
        int32_t idx = (int32_t)std::floor((y + 1.0f) * half_mu);
        out[i] = std::min(std::max(idx, -1), mu - 1);
    }
}

// In-place peak normalization; returns the peak.
float peak_normalize(float* x, int64_t n) {
    float peak = 0.f;
    for (int64_t i = 0; i < n; ++i) peak = std::max(peak, std::fabs(x[i]));
    if (peak > 0.f) {
        const float inv = 1.0f / peak;
        for (int64_t i = 0; i < n; ++i) x[i] *= inv;
    }
    return peak;
}

// int16 PCM -> float32 in [-1, 1]
void pcm16_to_float(const int16_t* x, int64_t n, float* out) {
    const float scale = 1.0f / 32767.0f;
    for (int64_t i = 0; i < n; ++i) out[i] = x[i] * scale;
}

// Pitch-preserving WSOLA time stretch (mirrors
// vqvae_speech_tpu/data/noise_injector.py:wsola_time_stretch — the
// algorithm behind sox's `tempo` effect the reference shells out to,
// reference src/dataset/spectrogram_parser.py:117-129).
//
// out must have room for (n_frames - 1) * (N/2) + N samples, where
// N = round(win_ms * rate / 1000) rounded down to even (min 4) and
// n_frames = max((int)((n - N - tol) / (N/2 * tempo)), 1).
// Returns the produced length (after tail trim and target clamp),
// or -1 when the input is returned unchanged (caller copies).
//
// tempo/win_ms/tol_ms are doubles so this n_frames expression is the
// SAME double arithmetic the Python caller sizes `out` with — a float32
// tempo here could truncate to a larger n_frames and overrun the buffer.
int64_t wsola_time_stretch(const float* x, int64_t n, double tempo,
                           int rate, double win_ms, double tol_ms,
                           float* out) {
    int N = (int)std::lround(win_ms * rate / 1000.0) & ~1;
    if (N < 4) N = 4;
    if (std::fabs(tempo - 1.0) < 1e-6 || n <= N) return -1;
    const int Hs = N / 2;
    const double Ha = (double)Hs * tempo;
    int tol = (int)std::lround(tol_ms * rate / 1000.0);
    if (tol < 1) tol = 1;

    int64_t n_frames = (int64_t)(((double)n - N - tol) / Ha);
    if (n_frames < 1) n_frames = 1;
    const int64_t out_len = (n_frames - 1) * Hs + N;

    float* win = new float[N];
    for (int i = 0; i < N; ++i)
        win[i] = 0.5f - 0.5f * (float)std::cos(2.0 * M_PI * i / (N - 1));
    float* norm = new float[out_len];
    std::memset(norm, 0, out_len * sizeof(float));
    std::memset(out, 0, out_len * sizeof(float));

    int64_t seg_start = 0;
    for (int i = 0; i < N; ++i) { out[i] = win[i] * x[i]; norm[i] = win[i]; }
    for (int64_t k = 1; k < n_frames; ++k) {
        // numpy mirror: x[seg_start+Hs : seg_start+Hs+N] CLAMPS at the
        // input end (slow tempos push the continuation template past n),
        // so the correlation runs over the truncated template length
        const float* natural = x + seg_start + Hs;
        const int nat_len =
            (int)std::min<int64_t>(N, n - (seg_start + Hs));
        // python int(round(k * Ha)) rounds half-to-even: nearbyint does
        // too under the default FE_TONEAREST mode
        const int64_t nominal = (int64_t)std::nearbyint(k * Ha);
        int64_t lo = std::max<int64_t>(nominal - tol, 0);
        int64_t hi = std::min<int64_t>(nominal + tol, n - N);
        if (hi <= lo) {
            seg_start = std::max<int64_t>(
                std::min<int64_t>(nominal, n - N), 0);
        } else {
            double best = -1e300;
            int64_t best_i = lo;
            for (int64_t s = lo; s <= hi; ++s) {
                double acc = 0.0;
                const float* seg = x + s;
                for (int i = 0; i < nat_len; ++i)
                    acc += (double)seg[i] * natural[i];
                if (acc > best) { best = acc; best_i = s; }
            }
            seg_start = best_i;
        }
        const int64_t pos = k * Hs;
        const float* seg = x + seg_start;
        for (int i = 0; i < N; ++i) {
            out[pos + i] += win[i] * seg[i];
            norm[pos + i] += win[i];
        }
    }
    int64_t covered = -1;
    for (int64_t i = 0; i < out_len; ++i) {
        out[i] /= std::max(norm[i], 1e-6f);
        if (norm[i] >= 0.1f) covered = i;
    }
    delete[] win;
    delete[] norm;
    int64_t produced = covered + 1;
    const int64_t target = (int64_t)std::nearbyint((double)n / tempo);
    if (target < produced) produced = target;
    return produced;
}

}  // extern "C"
