"""Build and bind the hand-written CUDA kernels in ``csrc/``.

The kernels have a plain C interface: ``nvcc`` compiles each source into a
shared library under ``vqvae_speech_tpu_torch/build/`` at first use (a few
seconds; no PyTorch headers), and ``ctypes`` loads it. Nothing here runs at
import time, so the module imports on machines without ``nvcc`` or a GPU.

Each launching wrapper checks device, dtype, contiguity and shapes, allocates
its outputs with ``torch.empty``, launches on the current CUDA stream, raises
if the launch reported an error, and counts its launches in a plain integer
attribute (``vq_search_cuda.launches``, ``wavenet_step_cuda.launches``
for every launch of the decode step, prepared or not,
``fused_block_chain_cuda.launches``, ``fused_block_chain_tiled_cuda.launches``,
``fused_block_chain_nc_cuda.launches``).
"""
import ctypes
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def build(name: str, force: bool = False) -> str:
    """Compile ``csrc/{name}.cu`` to ``build/lib{name}.so`` if it is missing,
    older than its source, or ``force``; returns nvcc's -Xptxas -v report
    ('' when the library was already current)."""
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    out = os.path.join(BUILD_DIR, f"lib{name}.so")
    if (not force and os.path.isfile(out)
            and os.path.getmtime(out) >= os.path.getmtime(src)):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic publish: concurrent builders never see a torn file
    return proc.stderr


def _library(name: str, bind) -> ctypes.CDLL:
    """Build (if needed) and load ``lib{name}.so`` once per process;
    ``bind(lib)`` declares its functions' argtypes and restypes."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(os.path.join(BUILD_DIR, f"lib{name}.so"))
            bind(lib)
            _libs[name] = lib
        return lib


def _bind_vq_search(lib: ctypes.CDLL) -> None:
    lib.vq_search_smem_bytes.argtypes = [ctypes.c_int]
    lib.vq_search_smem_bytes.restype = ctypes.c_size_t
    ptr = ctypes.c_void_p
    # z, codebook, N, K, D, idx, q, counts, dw, stream
    lib.vq_search_f32.argtypes = [ptr, ptr, ctypes.c_int64, ctypes.c_int,
                                  ctypes.c_int, ptr, ptr, ptr, ptr, ptr]
    lib.vq_search_f32.restype = ctypes.c_int


_MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use


def vq_search_cuda(flat: torch.Tensor, codebook: torch.Tensor):
    """Fused codebook search (csrc/vq_search.cu) on CUDA f32 tensors.

    flat (N, D), codebook (K, D) -> (indices (N,) int32, quantized (N, D),
    counts (K,), dw (K, D)), all f32 except the indices.
    """
    for name, t in (("flat", flat), ("codebook", codebook)):
        if not t.is_cuda:
            raise ValueError(f"vq_search_cuda: {name} must be a CUDA tensor")
        if t.dtype != torch.float32:
            raise ValueError(f"vq_search_cuda: {name} must be float32, "
                             f"got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"vq_search_cuda: {name} must be a contiguous "
                             f"2-D tensor, got shape {tuple(t.shape)}")
    if flat.device != codebook.device:
        raise ValueError("vq_search_cuda: flat and codebook on different "
                         f"devices ({flat.device} vs {codebook.device})")
    N, D = flat.shape
    K, Dc = codebook.shape
    if Dc != D or N == 0 or K == 0:
        raise ValueError(f"vq_search_cuda: bad shapes flat {tuple(flat.shape)}"
                         f" codebook {tuple(codebook.shape)}")
    if N >= 1 << 24:
        raise ValueError("vq_search_cuda: counts are exact only below 2^24 rows")
    lib = _library("vq_search", _bind_vq_search)
    if lib.vq_search_smem_bytes(D) > _MAX_SMEM:
        raise ValueError(f"vq_search_cuda: embedding_dim {D} too wide for one "
                         "block's shared memory")
    dev = flat.device
    idx = torch.empty((N,), dtype=torch.int32, device=dev)
    q = torch.empty((N, D), dtype=torch.float32, device=dev)
    counts = torch.empty((K,), dtype=torch.float32, device=dev)
    dw = torch.empty((K, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vq_search_f32(flat.data_ptr(), codebook.data_ptr(), N, K, D,
                                idx.data_ptr(), q.data_ptr(),
                                counts.data_ptr(), dw.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"vq_search_cuda: launch failed with CUDA error {err}")
    vq_search_cuda.launches += 1
    return idx, q, counts, dw


vq_search_cuda.launches = 0


def _bind_wavenet_step(lib: ctypes.CDLL) -> None:
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    # L, k, B, C, G, S, *bytes
    lib.wavenet_step_scratch_bytes.argtypes = (
        [i32] * 6 + [ctypes.POINTER(ctypes.c_size_t)])
    lib.wavenet_step_scratch_bytes.restype = i32
    # wtap, bias, wskip, bskip, wout, bout, L, k, B, C, G, S, legacy,
    # x_out, skip, x_all, scratch, *handle
    lib.wavenet_step_prepare.argtypes = (
        [ptr] * 6 + [i32] * 7 + [ptr] * 4 + [ctypes.POINTER(ptr)])
    lib.wavenet_step_prepare.restype = i32
    # handle, x0, taps, cond, stamps, stream
    lib.wavenet_step_run.argtypes = [ptr] * 6
    lib.wavenet_step_run.restype = i32
    lib.wavenet_step_describe.argtypes = [ptr, ctypes.POINTER(i32)]
    lib.wavenet_step_describe.restype = None
    lib.wavenet_step_release.argtypes = [ptr]
    lib.wavenet_step_release.restype = None


WAVENET_STEP_MAX_BATCH = 32
_STEP_WEIGHTS = ("wtap", "bias", "wskip", "bskip", "wout", "bout")


def _check_step_tensor(name, t, dev):
    if not t.is_cuda or (dev is not None and t.device != dev):
        raise ValueError(f"wavenet_step_cuda: {name} must be a CUDA tensor"
                         f"{'' if dev is None else f' on {dev}'}, got "
                         f"{t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"wavenet_step_cuda: {name} must be float32, "
                         f"got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"wavenet_step_cuda: {name} must be contiguous")


class PreparedWaveNetStep:
    """The decode-step kernel (csrc/wavenet_step.cu) bound to one layer
    stack's weights and one batch size: everything that does not change from
    step to step is checked, planned and allocated here, ONCE.

    ``step(x0, taps, cond)`` then checks its three tensors, passes their
    pointers and launches the one cooperative kernel on the current stream;
    it returns (x (B, C), skip (B, S), x_all (L, B, C)).

    The three outputs and the scratch are allocated once and REUSED by every
    call: a call overwrites what the previous call returned. That is safe
    for a caller that consumes (or copies) a step's outputs with work
    enqueued on the same stream before it makes the next call, as the
    decode loop does; one that keeps a step's outputs clones them.
    """

    def __init__(self, wtap, bias, wskip, bskip, wout, bout, batch: int,
                 legacy: bool = False):
        weights = dict(wtap=wtap, bias=bias, wskip=wskip, bskip=bskip,
                       wout=wout, bout=bout)
        self._handle = None
        dev = wtap.device if wtap.is_cuda else None
        for name, t in weights.items():
            _check_step_tensor(name, t, dev)
            # the weight matrices are copied in 16-byte pieces
            if name in ("wtap", "wskip", "wout") and t.data_ptr() % 16:
                raise ValueError(f"wavenet_step_cuda: {name} must be 16-byte "
                                 "aligned")
        if wtap.dim() != 4:
            raise ValueError(f"wavenet_step_cuda: wtap must be (L, k, C, G), "
                             f"got {tuple(wtap.shape)}")
        L, k, C, G = wtap.shape
        B = int(batch)
        S = wskip.shape[-1]
        want = dict(bias=(L, G), wskip=(L, G // 2, S), bskip=(L, S),
                    wout=(L, G // 2, C), bout=(L, C))
        for name, shape in want.items():
            if tuple(weights[name].shape) != shape:
                raise ValueError(f"wavenet_step_cuda: {name} has shape "
                                 f"{tuple(weights[name].shape)}, expected "
                                 f"{shape}")
        if not 1 <= B <= WAVENET_STEP_MAX_BATCH:
            raise ValueError(f"wavenet_step_cuda: batch {B} outside 1.."
                             f"{WAVENET_STEP_MAX_BATCH}")
        if L < 1 or k < 1 or G % 8 or C % 4 or S % 4 or min(C, G, S) < 1:
            raise ValueError("wavenet_step_cuda: needs L, k >= 1, G % 8 == 0, "
                             f"C % 4 == 0 and S % 4 == 0; got L={L} k={k} "
                             f"C={C} G={G} S={S}")
        self.device = dev
        self.shapes = dict(x0=(B, C), taps=(L, k - 1, B, C), cond=(L, B, G))
        self._weights = weights       # kept alive: the handle holds pointers
        self._lib = lib = _library("wavenet_step", _bind_wavenet_step)
        dims = (L, k, B, C, G, S)
        with torch.cuda.device(dev):
            nbytes = ctypes.c_size_t()
            self._raise(lib.wavenet_step_scratch_bytes(
                *dims, ctypes.byref(nbytes)), dims)
            self.x_out = torch.empty((B, C), dtype=torch.float32, device=dev)
            self.skip = torch.empty((B, S), dtype=torch.float32, device=dev)
            self.x_all = torch.empty((L, B, C), dtype=torch.float32,
                                     device=dev)
            self._scratch = torch.empty((nbytes.value,), dtype=torch.uint8,
                                        device=dev)
            handle = ctypes.c_void_p()
            self._raise(lib.wavenet_step_prepare(
                *(weights[n].data_ptr() for n in _STEP_WEIGHTS), *dims,
                int(bool(legacy)), self.x_out.data_ptr(),
                self.skip.data_ptr(), self.x_all.data_ptr(),
                self._scratch.data_ptr(), ctypes.byref(handle)), dims)
        self._handle = handle

    @staticmethod
    def _raise(err, dims):
        if err == -1:
            raise ValueError("wavenet_step_cuda: a block's slice of the "
                             f"inputs does not fit shared memory at (L, k, B,"
                             f" C, G, S) = {dims}")
        if err == -2:
            raise ValueError("wavenet_step_cuda: more column tiles than the "
                             f"device runs blocks at (L, k, B, C, G, S) = "
                             f"{dims}")
        if err != 0:
            raise RuntimeError(f"wavenet_step_cuda: CUDA error {err} at "
                               f"(L, k, B, C, G, S) = {dims}")

    def describe(self) -> dict:
        """The launch's shape: blocks, shared-memory bytes a block, and the
        (tiles, slices, rows a slice) of the gate and the projection."""
        out = (ctypes.c_int * 8)()
        self._lib.wavenet_step_describe(self._handle, out)
        return dict(zip(("blocks", "smem_bytes", "gate_tiles", "gate_slices",
                         "gate_rows", "proj_tiles", "proj_slices",
                         "proj_rows"), out))

    def __call__(self, x0, taps, cond, stamps=None):
        """One step. ``stamps``, an int64 CUDA tensor of (blocks, 2L, 4, 2),
        receives every block's stamps of each phase (start, inputs staged,
        products done, partial sums stored), each as (global nanosecond
        timer, the SM's cycle counter)."""
        dev = self.device
        if stamps is not None and (
                stamps.dtype != torch.int64 or stamps.device != dev
                or not stamps.is_contiguous()
                or stamps.numel() < self.describe()["blocks"] * 16
                * self.shapes["cond"][0]):
            raise ValueError("wavenet_step_cuda: stamps must be a contiguous "
                             "int64 tensor of (blocks, 2L, 4, 2) on the "
                             "device")
        for name, t in (("x0", x0), ("taps", taps), ("cond", cond)):
            _check_step_tensor(name, t, dev)
            if tuple(t.shape) != self.shapes[name]:
                raise ValueError(f"wavenet_step_cuda: {name} has shape "
                                 f"{tuple(t.shape)}, expected "
                                 f"{self.shapes[name]}")
        if torch.cuda.current_device() == dev.index:
            err = self._launch(x0, taps, cond, stamps)
        else:
            with torch.cuda.device(dev):
                err = self._launch(x0, taps, cond, stamps)
        if err != 0:
            raise RuntimeError("wavenet_step_cuda: launch failed with CUDA "
                               f"error {err}")
        wavenet_step_cuda.launches += 1
        return self.x_out, self.skip, self.x_all

    def _launch(self, x0, taps, cond, stamps):
        return self._lib.wavenet_step_run(
            self._handle, x0.data_ptr(), taps.data_ptr(), cond.data_ptr(),
            None if stamps is None else stamps.data_ptr(),
            torch.cuda.current_stream(self.device).cuda_stream)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.wavenet_step_release(self._handle)
            self._handle = None


def wavenet_step_cuda(x0, taps, cond, wtap, bias, wskip, bskip, wout, bout,
                      legacy: bool = False):
    """Fused GLU layer stack for one decode step (csrc/wavenet_step.cu) on
    CUDA f32 tensors; the contract of ``ops.wavenet_step.glu_stack_step``.
    Prepares the step for these weights, runs it once and hands over the
    freshly allocated outputs; a decode loop prepares once instead
    (``PreparedWaveNetStep``).

    x0 (B, C), taps (L, k-1, B, C), cond (L, B, G), wtap (L, k, C, G),
    bias (L, G), wskip (L, G/2, S), bskip (L, S), wout (L, G/2, C),
    bout (L, C) -> (x (B, C), skip (B, S), x_all (L, B, C)).
    """
    if x0.dim() != 2:
        raise ValueError(f"wavenet_step_cuda: x0 must be (B, C), got shape "
                         f"{tuple(x0.shape)}")
    step = PreparedWaveNetStep(wtap, bias, wskip, bskip, wout, bout,
                               x0.shape[0], legacy)
    return step(x0, taps, cond)


wavenet_step_cuda.launches = 0


def _bind_fused_resblock(lib: ctypes.CDLL) -> None:
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    lib.fused_chain_smem_bytes.argtypes = [i32]
    lib.fused_chain_smem_bytes.restype = ctypes.c_size_t
    # T, C, G, cin, L, k, path, *floats, *split
    lib.fused_chain_scratch_floats.argtypes = (
        [i32] * 7 + [ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(i32)])
    lib.fused_chain_scratch_floats.restype = i32
    # x, c, wf, wg, wfc, wgc, wres, wskip, bf, bg, bres, bskip, T, C, G, S,
    # cin, L, k, path, [dilations,] x_out, skip, scratch, stream
    chain = [ptr] * 12 + [i32] * 8
    for name in ("fused_chain_f32", "fused_chain_tiled_f32"):
        getattr(lib, name).argtypes = chain + [ptr] * 4
        getattr(lib, name).restype = i32
    lib.fused_chain_nc_f32.argtypes = (chain + [ctypes.POINTER(i32)]
                                       + [ptr] * 4)
    lib.fused_chain_nc_f32.restype = i32


FUSED_CHAIN_MAX_TAPS = 8
FUSED_CHAIN_MAX_LAYERS = 64
# The chain kernels' two decompositions. "auto" is what every caller gets:
# the shapes and the device's SM count decide (chains of at most two 64-row
# tiles an SM take the split path). The other two
# force one, for tests and measurements of both sides of that switch.
FUSED_CHAIN_PATHS = {"auto": 0, "rows": 1, "split": 2}
_STACKED = ("wf", "wg", "wfc", "wgc", "wres", "wskip", "bf", "bg", "bres",
            "bskip")


def _fused_chain_launch(name, entry, x, c_up, stacked, dilations=None,
                        path="auto"):
    """Check the arguments of one fused chain, allocate its outputs and
    scratch (the buffer x ping-pongs through and, on the split path, the
    partial sums and the gated output) and run the C entry point ``entry``
    of csrc/fused_resblock.cu on the current stream. x (T, C), c_up
    (T, cin), stacked as ``ops.fused_resblock.stack_block_weights`` ->
    (x (T, C), skip (T, S))."""
    if path not in FUSED_CHAIN_PATHS:
        raise ValueError(f"{name}: path must be one of "
                         f"{sorted(FUSED_CHAIN_PATHS)}, got {path!r}")
    args = dict(x=x, c_up=c_up, **{n: stacked[n] for n in _STACKED})
    dev = x.device
    for arg, t in args.items():
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor on {dev}, "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        # everything but the conditioning is read or written as float4
        if arg != "c_up" and t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    if x.dim() != 2 or c_up.dim() != 2 or stacked["wf"].dim() != 4:
        raise ValueError(f"{name}: x must be (T, C), c_up (T, cin) and wf "
                         f"(L, k, C, G); got {tuple(x.shape)}, "
                         f"{tuple(c_up.shape)}, {tuple(stacked['wf'].shape)}")
    T, C = x.shape
    cin = c_up.shape[1]
    L, k, _, G = stacked["wf"].shape
    S = stacked["wskip"].shape[-1]
    want = dict(c_up=(T, cin), wf=(L, k, C, G), wg=(L, k, C, G),
                wfc=(L, cin, G), wgc=(L, cin, G), wres=(L, G, C),
                wskip=(L, G, S), bf=(L, G), bg=(L, G), bres=(L, C),
                bskip=(L, S))
    for arg, shape in want.items():
        if tuple(args[arg].shape) != shape:
            raise ValueError(f"{name}: {arg} has shape "
                             f"{tuple(args[arg].shape)}, expected {shape}")
    if (T < 1 or cin < 1 or not 1 <= k <= FUSED_CHAIN_MAX_TAPS
            or not 1 <= L <= FUSED_CHAIN_MAX_LAYERS
            or C % 4 or G % 4 or S % 4 or min(C, G, S) < 4):
        raise ValueError(
            f"{name}: needs T, cin >= 1, 1 <= k <= {FUSED_CHAIN_MAX_TAPS}, "
            f"1 <= L <= {FUSED_CHAIN_MAX_LAYERS} and C, G, S positive "
            f"multiples of 4; got T={T} cin={cin} k={k} L={L} C={C} G={G} "
            f"S={S}")
    reach = (max(dilations) if dilations is not None else k ** (L - 1))
    if (k - 1) * reach >= 2 ** 31 or T * max(C, S, cin) >= 2 ** 62:
        raise ValueError(f"{name}: dilation {reach} out of range")
    lib = _library("fused_resblock", _bind_fused_resblock)
    if lib.fused_chain_smem_bytes(G) > _MAX_SMEM:
        raise ValueError(f"{name}: gate width {G} too wide for one block's "
                         "shared memory")
    x_out = torch.empty((T, C), dtype=torch.float32, device=dev)
    skip = torch.empty((T, S), dtype=torch.float32, device=dev)
    extra = []
    if dilations is not None:
        if len(dilations) != L or min(dilations) < 1:
            raise ValueError(f"{name}: needs {L} positive dilations, got "
                             f"{tuple(dilations)}")
        extra = [(ctypes.c_int * L)(*(int(d) for d in dilations))]
    path_id = FUSED_CHAIN_PATHS[path]
    with torch.cuda.device(dev):
        n_floats, split = ctypes.c_size_t(), ctypes.c_int()
        err = lib.fused_chain_scratch_floats(
            T, C, G, cin, L, k, path_id, ctypes.byref(n_floats),
            ctypes.byref(split))
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err} sizing the scratch")
        scratch = torch.empty((n_floats.value,), dtype=torch.float32,
                              device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(
            *(t.data_ptr() for t in args.values()), T, C, G, S, cin, L, k,
            path_id, *extra, x_out.data_ptr(), skip.data_ptr(),
            scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    _fused_chain_launch.last_split = bool(split.value)
    return x_out, skip


# whether the last chain launched took the split path (for tests and reports)
_fused_chain_launch.last_split = False


def fused_block_chain_tiled_cuda(x, c_up, stacked, path="auto"):
    """The causal gated-resblock chain (dilation k**l) on CUDA f32 tensors,
    as the IAF student serves it; the contract of
    ``ops.fused_resblock.fused_block_chain_tiled``."""
    out = _fused_chain_launch("fused_block_chain_tiled_cuda",
                              "fused_chain_tiled_f32", x, c_up, stacked,
                              path=path)
    fused_block_chain_tiled_cuda.launches += 1
    return out


fused_block_chain_tiled_cuda.launches = 0


def fused_block_chain_cuda(x, c_up, stacked, path="auto"):
    """The causal chain over the whole T; the contract of
    ``ops.fused_resblock.fused_block_chain``."""
    out = _fused_chain_launch("fused_block_chain_cuda", "fused_chain_f32",
                              x, c_up, stacked, path=path)
    fused_block_chain_cuda.launches += 1
    return out


fused_block_chain_cuda.launches = 0


def fused_block_chain_nc_cuda(x, c_up, stacked, dilations, path="auto"):
    """The non-causal chain with one dilation a layer; the contract of
    ``ops.fused_resblock.fused_block_chain_nc``."""
    out = _fused_chain_launch("fused_block_chain_nc_cuda",
                              "fused_chain_nc_f32", x, c_up, stacked,
                              tuple(dilations), path=path)
    fused_block_chain_nc_cuda.launches += 1
    return out


fused_block_chain_nc_cuda.launches = 0
