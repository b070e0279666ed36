"""Native (C++) host-side ingest kernels with a numpy fallback.

Counterpart of ``vqvae_speech_tpu/native/__init__.py``. Builds
``csrc/ingest.cpp`` (a copy of the repository's ``native/ingest.cpp``) with
the same ``g++ -O3 -march=native -shared -fPIC`` into
``vqvae_speech_tpu_torch/build/libingest.so`` on first use, and exposes the
per-utterance CPU hot spots of corpus export (RMS silence trim, mu-law
encode, peak normalization) and the WSOLA time stretch of the augmentation as
ctypes calls over numpy buffers; ``available()`` says whether it loaded, and
without it each function takes the port's own numpy path (``data/audio.py``,
``ops/mu_law.py``).

Unlike the JAX package, the port's data path does not route through it:
``data/audio.py`` and ``data/vctk.py`` keep their numpy trim, peak and
mu-law, which give the same bits, and ``data/noise_injector.py``'s WSOLA
takes the C++ form only when asked (``use_native=True``), since on an H100
host it was the slower of the two (PERF.md).
"""
import ctypes
import os
import subprocess
import tempfile

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_PATH = os.path.join(_PKG_DIR, "csrc", "ingest.cpp")
_BUILD_DIR = os.path.join(_PKG_DIR, "build")
_SO_PATH = os.path.join(_BUILD_DIR, "libingest.so")

_lib = None
_tried = False


def _build():
    """Compile into a temporary file and rename it into place, so that a
    process loading the library never sees a half-written one."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-o", tmp, _SRC_PATH],
            check=True, capture_output=True)
        os.replace(tmp, _SO_PATH)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.isfile(_SO_PATH)
                or os.path.getmtime(_SO_PATH) < os.path.getmtime(_SRC_PATH)):
            _build()
        lib = ctypes.CDLL(_SO_PATH)
    except (OSError, subprocess.CalledProcessError):
        # no g++, or a library that does not load: the numpy paths serve
        return None
    lib.rms_trim_bounds.restype = ctypes.c_int
    lib.rms_trim_bounds.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64)]
    lib.mu_law_encode.restype = None
    lib.mu_law_encode.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32)]
    lib.peak_normalize.restype = ctypes.c_float
    lib.peak_normalize.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    # tempo/win_ms/tol_ms cross as doubles: wsola_time_stretch_native sizes
    # the output buffer from float64 arithmetic, and the C++ side must
    # reproduce the exact same n_frames (a float32-degraded tempo can
    # truncate to one MORE frame and write past the buffer)
    lib.wsola_time_stretch.restype = ctypes.c_int64
    lib.wsola_time_stretch.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_double,
        ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_float)]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def rms_trim_bounds(y: np.ndarray, frame_length: int = 2048,
                    hop_length: int = 512, top_db: float = 20.0):
    """(start, end) sample bounds of the non-silent region."""
    lib = _load()
    y = np.ascontiguousarray(y, np.float32)
    if lib is None:
        from vqvae_speech_tpu_torch.data.audio import trim_silence

        _, bounds = trim_silence(y, top_db, frame_length, hop_length)
        return bounds
    start = ctypes.c_int64()
    end = ctypes.c_int64()
    lib.rms_trim_bounds(_fptr(y), y.size, frame_length, hop_length,
                        ctypes.c_float(top_db), ctypes.byref(start),
                        ctypes.byref(end))
    return int(start.value), int(end.value)


def mu_law_encode_native(x: np.ndarray, mu: int = 256) -> np.ndarray:
    """int32 mu-law bins of a float waveform, bit-equal to
    ``ops.mu_law_encode``."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float32)
    if lib is None:
        import torch

        from vqvae_speech_tpu_torch.ops.mu_law import mu_law_encode

        return mu_law_encode(torch.from_numpy(x), mu).numpy()
    out = np.empty(x.shape, np.int32)
    lib.mu_law_encode(_fptr(x), x.size, mu,
                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def peak_normalize(x: np.ndarray) -> np.ndarray:
    """Returns a peak-normalized copy (scaled by the f32 reciprocal of the
    peak, as ``data/audio.py::load_and_preprocess`` scales)."""
    lib = _load()
    x = np.ascontiguousarray(x, np.float32).copy()
    if lib is None:
        peak = np.abs(x).max() if x.size else np.float32(0)
        return x * (np.float32(1) / peak) if peak > 0 else x
    lib.peak_normalize(_fptr(x), x.size)
    return x


def wsola_time_stretch_native(x: np.ndarray, tempo: float,
                              sample_rate: int = 16000,
                              win_ms: float = 25.0, tol_ms: float = 7.5):
    """Native WSOLA; returns None when the native lib is unavailable (the
    caller falls back to the numpy implementation in data/noise_injector)."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    N = max(int(round(win_ms * sample_rate / 1000.0)) & ~1, 4)
    if abs(tempo - 1.0) < 1e-6 or x.size <= N:
        return x.copy()
    Hs = N // 2
    Ha = Hs * tempo
    tol = max(int(round(tol_ms * sample_rate / 1000.0)), 1)
    n_frames = max(int((x.size - N - tol) / Ha), 1)
    out = np.zeros((n_frames - 1) * Hs + N, np.float32)
    produced = lib.wsola_time_stretch(
        _fptr(x), x.size, ctypes.c_double(tempo), sample_rate,
        ctypes.c_double(win_ms), ctypes.c_double(tol_ms), _fptr(out))
    if produced < 0:
        return x.copy()
    return out[:produced]
