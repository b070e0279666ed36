"""Synthetic phoneme corpus: formant-structured segments with TextGrids.

A copy of ``vqvae_speech_tpu/data/synthetic_phonemes.py`` (numpy and scipy;
the port imports nothing of the JAX package), writing the same files byte
for byte (tests/test_torch_synthetic_phonemes.py).

Generates a VCTK-shaped corpus (wav48/<spk>/<utt>.wav +
phonemes/<spk>/<utt>.TextGrid) where each utterance is a sequence of
"phoneme" segments drawn from a fixed inventory of distinct spectral timbres
(formant-like harmonic profiles).  Because the groundtruth unit boundaries
and identities are known exactly, the FULL quality pipeline — export ->
train -> empirical alignments -> ARI/AMI/NMI against TextGrids — can be
validated end-to-end with a meaningful expected signal: a working VQ-VAE
must produce codes that align with the timbre segments far better than
chance (the reference can only demonstrate this with the real VCTK corpus,
which is not shipped).
"""
import os

import numpy as np
from scipy.io import wavfile

# phoneme inventory: (formant-ish harmonic frequencies Hz, amplitudes)
PHONEME_SPECS = {
    "AA": ((200, 700, 1200), (1.0, 0.7, 0.3)),
    "IY": ((250, 2200, 3000), (1.0, 0.5, 0.25)),
    "UW": ((300, 870, 2240), (1.0, 0.6, 0.2)),
    "EH": ((500, 1800, 2500), (1.0, 0.6, 0.3)),
    "SH": ((2500, 3500, 4500), (0.5, 0.6, 0.5)),  # noise-dominant
}


def _segment(name, dur_samples, rate, rng, noise=0.02):
    freqs, amps = PHONEME_SPECS[name]
    t = np.arange(dur_samples) / rate
    sig = np.zeros(dur_samples)
    phase = rng.uniform(0, 2 * np.pi, len(freqs))
    for f, a, p in zip(freqs, amps, phase):
        sig += a * np.sin(2 * np.pi * f * t + p)
    if name == "SH":
        sig = 0.3 * sig + 0.7 * rng.standard_normal(dur_samples)
    sig *= 0.8 / max(np.abs(sig).max(), 1e-6)
    # short fade in/out to avoid clicks
    ramp = min(80, dur_samples // 4)
    env = np.ones(dur_samples)
    if ramp > 0:
        env[:ramp] = np.linspace(0, 1, ramp)
        env[-ramp:] = np.linspace(1, 0, ramp)
    return sig * env + noise * rng.standard_normal(dur_samples)


def build_phoneme_corpus(root, num_speakers=2, utts_per_speaker=8,
                         utt_seconds=0.6, rate=16000, seed=0):
    """Write the corpus tree; returns (dset_path, phonemes list)."""
    rng = np.random.default_rng(seed)
    dset = os.path.join(root, "raw", "VCTK-Corpus")
    phonemes = list(PHONEME_SPECS)
    for s in range(num_speakers):
        spk = f"p{300 + s}"
        wav_dir = os.path.join(dset, "wav48", spk)
        tg_dir = os.path.join(dset, "phonemes", spk)
        txt_dir = os.path.join(dset, "txt", spk)
        for d in (wav_dir, tg_dir, txt_dir):
            os.makedirs(d, exist_ok=True)
        for u in range(utts_per_speaker):
            name = f"{spk}_{u:03d}"
            total = int(utt_seconds * rate)
            segs, marks = [], []
            pos = 0
            while pos < total:
                ph = phonemes[rng.integers(len(phonemes))]
                dur = int(rng.uniform(0.08, 0.2) * rate)
                dur = min(dur, total - pos)
                segs.append(_segment(ph, dur, rate, rng))
                marks.append((pos / rate, (pos + dur) / rate, ph))
                pos += dur
            sig = np.concatenate(segs)
            wavfile.write(os.path.join(wav_dir, name + ".wav"), rate,
                          (np.clip(sig, -1, 1) * 32767).astype(np.int16))
            _write_textgrid(os.path.join(tg_dir, name + ".TextGrid"),
                            marks, total / rate)
            with open(os.path.join(txt_dir, name + ".txt"), "w") as f:
                f.write(" ".join(m[2] for m in marks) + "\n")
    return dset, phonemes


# ---------------- rich (full-rank, speech-like) corpus ----------------
#
# The flat corpus above is LOW-RANK by construction: each phoneme is a fixed
# 3-sinusoid chord varying only in phase, so MFCC trajectories are near
# piecewise-constant and a wide encoder has a large null space to drift in
# (round-2 postmortem: gradient-VQ latent drift at width >= 256).  The rich
# generator below synthesizes source-filter speech-like segments instead:
#
# * voiced phonemes are an f0 harmonic series (per-speaker f0 base, a random
#   per-utterance declination contour + vibrato) shaped by a formant
#   resonance envelope (Peterson-Barney-ish targets),
# * per-SEGMENT formant jitter (+-8%) and per-SPEAKER vocal-tract scaling
#   (+-8%) give full-rank within-class variation,
# * fricatives are band-shaped noise with jittered band edges, nasals a
#   damped low-formant series,
# * every segment gets a random attack/decay amplitude envelope + slow AM.
#
# 37-phoneme inventory (RICH_PHONEMES below: vowels, liquids, diphthongs,
# nasals, fricatives, voiced fricatives, stops — shape-matched to the
# reference's real task of 44 codes vs ~40 phones); same corpus tree +
# TextGrid contract as the flat generator, so the entire
# export/align/cluster gate runs unchanged.

# voiced vowels: (F1, F2, F3) Hz formant targets
VOWEL_FORMANTS = {
    "AA": (700, 1220, 2600),
    "AE": (660, 1720, 2410),
    "AH": (640, 1190, 2390),
    "AO": (570, 840, 2410),
    "AX": (500, 1500, 2500),
    "EH": (530, 1840, 2480),
    "ER": (490, 1350, 1690),
    "IH": (390, 1990, 2550),
    "IY": (270, 2290, 3010),
    "UH": (440, 1020, 2240),
    "UW": (300, 870, 2240),
}
# liquids/glides: vowel-like resonants (RR's hallmark is the very low F3)
LIQUID_FORMANTS = {
    "LL": (350, 1050, 2800),
    "RR": (310, 1060, 1380),
    "WW": (290, 610, 2150),
    "YY": (260, 2070, 3020),
}
# diphthongs: formant glide from one vowel target to another
DIPHTHONGS = {
    "AY": ("AA", "IY"), "AW": ("AA", "UW"), "OY": ("AO", "IY"),
    "EY": ("EH", "IY"), "OW": ("AO", "UW"),
}
# nasals: low F1, heavily damped upper structure
NASAL_FORMANTS = {
    "NN": (250, 1000, 2200),
    "MM": (250, 1100, 2150),
    "NG": (280, 1300, 2000),
}
# fricatives: noise band (lo, hi) Hz
FRICATIVE_BANDS = {
    "SH": (1800, 5200), "SS": (3800, 7600), "FF": (1100, 7000),
    "TH": (1300, 7800), "HH": (500, 6500),
}
# voiced fricatives: harmonic source mixed with the noise band
VOICED_FRICATIVE_BANDS = {
    "ZZ": (3800, 7600), "VV": (1100, 7000), "ZH": (1800, 5200),
}
# stops: closure -> burst (band-emphasised noise); voiced ones add a
# low-frequency voice bar during closure
STOP_SPECS = {
    "PP": ((600, 1800), False), "TT": ((2500, 6500), False),
    "KK": ((1400, 3600), False), "BB": ((600, 1800), True),
    "DD": ((2500, 6500), True), "GG": ((1400, 3600), True),
}

# 37 classes — structurally comparable to the reference's real task
# (44 codes vs the ~40-phone VCTK inventory), so ARI no longer punishes
# an unavoidable 4-way split of a 12-phone inventory across 44 codes.
RICH_PHONEMES = (list(VOWEL_FORMANTS) + list(LIQUID_FORMANTS)
                 + list(DIPHTHONGS) + list(NASAL_FORMANTS)
                 + list(FRICATIVE_BANDS) + list(VOICED_FRICATIVE_BANDS)
                 + list(STOP_SPECS))


def _formant_envelope(freqs, formants, bws, amps):
    """Resonance-bump spectral envelope evaluated at ``freqs``."""
    env = np.zeros_like(freqs, dtype=np.float64)
    for f0, bw, a in zip(formants, bws, amps):
        env += a / (1.0 + ((freqs - f0) / (bw / 2.0)) ** 2)
    return env


def _voiced_segment(formants, dur, rate, rng, f0_start, f0_end,
                    damped=False, formants_end=None):
    """Harmonic series at a gliding f0, shaped by the formant envelope.

    ``formants_end`` synthesizes a diphthong: per-harmonic amplitudes
    crossfade linearly from the ``formants`` envelope to the
    ``formants_end`` envelope over the segment."""
    t = np.arange(dur) / rate
    # linear f0 glide + 5 Hz vibrato; phase = 2*pi*integral(f0)
    f0_t = np.linspace(f0_start, f0_end, dur)
    f0_t = f0_t * (1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * t
                                       + rng.uniform(0, 2 * np.pi)))
    phase0 = 2 * np.pi * np.cumsum(f0_t) / rate
    n_harm = int((rate / 2 - 200) // max(f0_start, f0_end))
    n_harm = max(3, min(n_harm, 40))
    harm_idx = np.arange(1, n_harm + 1)
    mean_f0 = 0.5 * (f0_start + f0_end)
    bws = [80.0, 120.0, 180.0]
    amps = [1.0, 0.6, 0.3]
    if damped:
        amps = [1.0, 0.25, 0.1]
    tilt = harm_idx.astype(np.float64) ** (-0.5 if not damped else -1.0)

    def envelope(fmts):
        e = _formant_envelope(harm_idx * mean_f0, fmts, bws, amps)
        # gentle spectral tilt, stronger for damped (nasal) timbres
        return e / max(e.max(), 1e-6) * tilt

    env_a = envelope(formants)
    env_b = envelope(formants_end) if formants_end is not None else None
    sig = np.zeros(dur)
    u = np.linspace(0.0, 1.0, dur)
    for i, k in enumerate(harm_idx):
        a = env_a[i]
        if env_b is None:
            if a < 1e-4:
                continue
            amp = a
        else:
            b = env_b[i]
            if a < 1e-4 and b < 1e-4:
                continue
            amp = (1.0 - u) * a + u * b   # formant glide
        sig += amp * np.sin(k * phase0 + rng.uniform(0, 2 * np.pi))
    return sig


def _fricative_segment(band, dur, rate, rng):
    """FFT band-shaped noise with soft (raised-cosine) band edges."""
    noise = rng.standard_normal(dur)
    spec = np.fft.rfft(noise)
    freqs = np.fft.rfftfreq(dur, 1.0 / rate)
    lo, hi = band
    roll = 300.0
    gain = np.clip((freqs - (lo - roll)) / roll, 0, 1) * \
        np.clip(((hi + roll) - freqs) / roll, 0, 1)
    return np.fft.irfft(spec * gain, dur)


def _jittered_formants(base, spk, rng):
    return [f * spk["vt_scale"] * rng.uniform(0.92, 1.08) for f in base]


def _jittered_band(band, rate, rng):
    lo, hi = band
    j = rng.uniform(0.9, 1.1, 2)
    return (lo * j[0], min(hi * j[1], rate / 2 - 200))


def _stop_segment(name, dur, rate, rng, spk):
    """Closure (silence / voice bar) -> burst (band noise, fast decay) ->
    brief aspiration tail."""
    band, voiced = STOP_SPECS[name]
    n_clo = int(0.5 * dur)
    # the utterance assembler truncates the final segment to whatever
    # remains, so every piece must clamp to the (possibly tiny) dur
    n_burst = min(max(8, int(0.22 * dur)), dur - n_clo)
    n_asp = max(0, dur - n_clo - n_burst)
    closure = np.zeros(n_clo)
    if voiced and n_clo > 0:
        # voice bar: low-frequency murmur through the closure
        f0 = spk["f0"] * rng.uniform(0.85, 1.0)
        tt = np.arange(n_clo) / rate
        closure = 0.18 * np.sin(2 * np.pi * f0 * tt
                                + rng.uniform(0, 2 * np.pi))
    burst = _fricative_segment(_jittered_band(band, rate, rng),
                               n_burst, rate, rng)
    burst *= np.exp(-np.linspace(0, 5.0, n_burst))       # sharp transient
    asp = np.zeros(n_asp)
    if n_asp > 0:
        asp = 0.25 * _fricative_segment((500, 5500), n_asp, rate, rng)
        asp *= np.exp(-np.linspace(0, 3.0, n_asp))
    return np.concatenate([closure, burst, asp])


def _rich_segment(name, dur, rate, rng, spk, noise=0.01):
    """One phoneme segment with per-segment formant/band jitter and a
    random amplitude envelope."""
    if name in FRICATIVE_BANDS:
        sig = _fricative_segment(
            _jittered_band(FRICATIVE_BANDS[name], rate, rng), dur, rate, rng)
    elif name in VOICED_FRICATIVE_BANDS:
        # harmonic source (neutral vocal tract) under the noise band
        f0a = spk["f0"] * rng.uniform(0.85, 1.1)
        voiced = _voiced_segment(
            _jittered_formants((500, 1500, 2500), spk, rng), dur, rate,
            rng, f0a, f0a * rng.uniform(0.9, 1.0), damped=True)
        fric = _fricative_segment(
            _jittered_band(VOICED_FRICATIVE_BANDS[name], rate, rng),
            dur, rate, rng)
        v = voiced / max(np.abs(voiced).max(), 1e-6)
        f = fric / max(np.abs(fric).max(), 1e-6)
        sig = 0.55 * v + 0.5 * f
    elif name in STOP_SPECS:
        sig = _stop_segment(name, dur, rate, rng, spk)
    elif name in DIPHTHONGS:
        va, vb = DIPHTHONGS[name]
        f0a = spk["f0"] * rng.uniform(0.85, 1.15)
        sig = _voiced_segment(
            _jittered_formants(VOWEL_FORMANTS[va], spk, rng), dur, rate,
            rng, f0a, f0a * rng.uniform(0.85, 1.05),
            formants_end=_jittered_formants(VOWEL_FORMANTS[vb], spk, rng))
    else:
        damped = name in NASAL_FORMANTS
        base = (NASAL_FORMANTS if damped
                else LIQUID_FORMANTS if name in LIQUID_FORMANTS
                else VOWEL_FORMANTS)[name]
        formants = _jittered_formants(base, spk, rng)
        f0a = spk["f0"] * rng.uniform(0.85, 1.15)
        f0b = f0a * rng.uniform(0.85, 1.05)   # mild declination
        sig = _voiced_segment(formants, dur, rate, rng, f0a, f0b,
                              damped=damped)
    sig = sig * (0.8 / max(np.abs(sig).max(), 1e-6))
    # random attack/decay envelope + slow AM
    atk = int(rng.uniform(0.1, 0.35) * dur)
    dec = int(rng.uniform(0.1, 0.35) * dur)
    env = np.ones(dur)
    if atk > 0:
        env[:atk] = np.linspace(0.2, 1.0, atk)
    if dec > 0:
        env[-dec:] = np.linspace(1.0, 0.3, dec)
    am = 1.0 + 0.15 * np.sin(2 * np.pi * rng.uniform(2, 8)
                             * np.arange(dur) / rate
                             + rng.uniform(0, 2 * np.pi))
    level = rng.uniform(0.5, 1.0)
    return sig * env * am * level + noise * rng.standard_normal(dur)


def build_rich_phoneme_corpus(root, num_speakers=8, utts_per_speaker=50,
                              utt_seconds=0.6, rate=16000, seed=0):
    """Full-rank speech-like corpus; same tree/TextGrid contract as
    ``build_phoneme_corpus``.  Returns (dset_path, phonemes list)."""
    rng = np.random.default_rng(seed)
    dset = os.path.join(root, "raw", "VCTK-Corpus")
    for s in range(num_speakers):
        spk_name = f"p{300 + s}"
        spk = {
            "f0": rng.uniform(90, 230),
            "vt_scale": rng.uniform(0.92, 1.08),
        }
        wav_dir = os.path.join(dset, "wav48", spk_name)
        tg_dir = os.path.join(dset, "phonemes", spk_name)
        txt_dir = os.path.join(dset, "txt", spk_name)
        for d in (wav_dir, tg_dir, txt_dir):
            os.makedirs(d, exist_ok=True)
        for u in range(utts_per_speaker):
            name = f"{spk_name}_{u:03d}"
            total = int(utt_seconds * rate)
            segs, marks = [], []
            pos = 0
            while pos < total:
                ph = RICH_PHONEMES[rng.integers(len(RICH_PHONEMES))]
                dur = int(rng.uniform(0.07, 0.18) * rate)
                dur = min(dur, total - pos)
                seg = _rich_segment(ph, dur, rate, rng, spk)
                # short crossfade-ish ramps to avoid clicks
                ramp = min(60, dur // 4)
                if ramp > 0:
                    seg[:ramp] *= np.linspace(0, 1, ramp)
                    seg[-ramp:] *= np.linspace(1, 0, ramp)
                segs.append(seg)
                marks.append((pos / rate, (pos + dur) / rate, ph))
                pos += dur
            sig = np.concatenate(segs)
            sig = sig / max(np.abs(sig).max(), 1e-6) * 0.85
            wavfile.write(os.path.join(wav_dir, name + ".wav"), rate,
                          (np.clip(sig, -1, 1) * 32767).astype(np.int16))
            _write_textgrid(os.path.join(tg_dir, name + ".TextGrid"),
                            marks, total / rate)
            with open(os.path.join(txt_dir, name + ".txt"), "w") as f:
                f.write(" ".join(m[2] for m in marks) + "\n")
    return dset, list(RICH_PHONEMES)


def _write_textgrid(path, marks, xmax):
    lines = [
        'File type = "ooTextFile"', 'Object class = "TextGrid"', "",
        "xmin = 0", f"xmax = {xmax}", "tiers? <exists>", "size = 2",
        "item []:",
    ]
    for tier_i, (tier_name, intervals) in enumerate((
            ("words", [(0.0, xmax, "utt")]), ("phonemes", marks)), start=1):
        lines += [
            f"    item [{tier_i}]:",
            '        class = "IntervalTier"',
            f'        name = "{tier_name}"',
            "        xmin = 0", f"        xmax = {xmax}",
            f"        intervals: size = {len(intervals)}",
        ]
        for k, (a, b, mark) in enumerate(intervals, start=1):
            lines += [
                f"        intervals [{k}]:",
                f"            xmin = {a}", f"            xmax = {b}",
                f'            text = "{mark}"',
            ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
