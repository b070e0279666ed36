"""Build and bind the hand-written CUDA kernels in ``csrc/``.

The kernels have a plain C interface: ``nvcc`` compiles each source into a
shared library under ``vqvae_speech_tpu_torch/build/`` at first use (a few
seconds; no PyTorch headers), and ``ctypes`` loads it. Nothing here runs at
import time, so the module imports on machines without ``nvcc`` or a GPU.

Each launching wrapper checks device, dtype, contiguity and shapes, allocates
its outputs with ``torch.empty``, launches on the current CUDA stream, raises
if the launch reported an error, and counts its launches in a plain integer
attribute (``vq_search_cuda.launches``, ``wavenet_step_cuda.launches``,
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
    lib.wavenet_step_scratch_bytes.argtypes = [i32] * 6
    lib.wavenet_step_scratch_bytes.restype = ctypes.c_size_t
    # x0, taps, cond, wtap, bias, wskip, bskip, wout, bout, L, k, B, C, G, S,
    # legacy, x_out, skip, x_all, scratch, stream
    lib.wavenet_step_f32.argtypes = [ptr] * 9 + [i32] * 7 + [ptr] * 5
    lib.wavenet_step_f32.restype = ctypes.c_int


WAVENET_STEP_MAX_BATCH = 32


def wavenet_step_cuda(x0, taps, cond, wtap, bias, wskip, bskip, wout, bout,
                      legacy: bool = False):
    """Fused GLU layer stack for one decode step (csrc/wavenet_step.cu) on
    CUDA f32 tensors; the contract of ``ops.wavenet_step.glu_stack_step``.

    x0 (B, C), taps (L, k-1, B, C), cond (L, B, G), wtap (L, k, C, G),
    bias (L, G), wskip (L, G/2, S), bskip (L, S), wout (L, G/2, C),
    bout (L, C) -> (x (B, C), skip (B, S), x_all (L, B, C)).
    """
    args = dict(x0=x0, taps=taps, cond=cond, wtap=wtap, bias=bias,
                wskip=wskip, bskip=bskip, wout=wout, bout=bout)
    dev = x0.device
    for name, t in args.items():
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"wavenet_step_cuda: {name} must be a CUDA tensor "
                             f"on {dev}, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"wavenet_step_cuda: {name} must be float32, "
                             f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"wavenet_step_cuda: {name} must be contiguous")
        # the weight matrices are read as float4
        if name in ("wtap", "wskip", "wout") and t.data_ptr() % 16:
            raise ValueError(f"wavenet_step_cuda: {name} must be 16-byte "
                             "aligned")
    if wtap.dim() != 4:
        raise ValueError(f"wavenet_step_cuda: wtap must be (L, k, C, G), got "
                         f"{tuple(wtap.shape)}")
    L, k, C, G = wtap.shape
    B = x0.shape[0]
    S = wskip.shape[-1]
    want = dict(x0=(B, C), taps=(L, k - 1, B, C), cond=(L, B, G),
                bias=(L, G), wskip=(L, G // 2, S), bskip=(L, S),
                wout=(L, G // 2, C), bout=(L, C))
    for name, shape in want.items():
        if tuple(args[name].shape) != shape:
            raise ValueError(f"wavenet_step_cuda: {name} has shape "
                             f"{tuple(args[name].shape)}, expected {shape}")
    if not 1 <= B <= WAVENET_STEP_MAX_BATCH:
        raise ValueError(f"wavenet_step_cuda: batch {B} outside 1.."
                         f"{WAVENET_STEP_MAX_BATCH}")
    if L < 1 or k < 1 or G % 8 or C % 4 or S % 4 or min(C, G, S) < 1:
        raise ValueError("wavenet_step_cuda: needs L, k >= 1, G % 8 == 0, "
                         f"C % 4 == 0 and S % 4 == 0; got L={L} k={k} C={C} "
                         f"G={G} S={S}")
    lib = _library("wavenet_step", _bind_wavenet_step)
    x_out = torch.empty((B, C), dtype=torch.float32, device=dev)
    skip = torch.empty((B, S), dtype=torch.float32, device=dev)
    x_all = torch.empty((L, B, C), dtype=torch.float32, device=dev)
    scratch = torch.empty(
        (lib.wavenet_step_scratch_bytes(L, k, B, C, G, S),),
        dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wavenet_step_f32(
            *(t.data_ptr() for t in args.values()), L, k, B, C, G, S,
            int(bool(legacy)), x_out.data_ptr(), skip.data_ptr(),
            x_all.data_ptr(), scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"wavenet_step_cuda: launch failed with CUDA error "
                           f"{err}")
    wavenet_step_cuda.launches += 1
    return x_out, skip, x_all


wavenet_step_cuda.launches = 0


def _bind_fused_resblock(lib: ctypes.CDLL) -> None:
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    lib.fused_chain_smem_bytes.argtypes = [i32]
    lib.fused_chain_smem_bytes.restype = ctypes.c_size_t
    # x, c, wf, wg, wfc, wgc, wres, wskip, bf, bg, bres, bskip, T, C, G, S,
    # cin, L, k, [dilations,] x_out, skip, scratch, stream
    chain = [ptr] * 12 + [i32] * 7
    for name in ("fused_chain_f32", "fused_chain_tiled_f32"):
        getattr(lib, name).argtypes = chain + [ptr] * 4
        getattr(lib, name).restype = i32
    lib.fused_chain_nc_f32.argtypes = (chain + [ctypes.POINTER(i32)]
                                       + [ptr] * 4)
    lib.fused_chain_nc_f32.restype = i32


FUSED_CHAIN_MAX_TAPS = 8
FUSED_CHAIN_MAX_LAYERS = 64
_STACKED = ("wf", "wg", "wfc", "wgc", "wres", "wskip", "bf", "bg", "bres",
            "bskip")


def _fused_chain_launch(name, entry, x, c_up, stacked, dilations=None):
    """Check the arguments of one fused chain, allocate its outputs and run
    the C entry point ``entry`` of csrc/fused_resblock.cu on the current
    stream. x (T, C), c_up (T, cin), stacked as
    ``ops.fused_resblock.stack_block_weights`` -> (x (T, C), skip (T, S))."""
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
    scratch = torch.empty((T, C), dtype=torch.float32, device=dev)
    extra = []
    if dilations is not None:
        if len(dilations) != L or min(dilations) < 1:
            raise ValueError(f"{name}: needs {L} positive dilations, got "
                             f"{tuple(dilations)}")
        extra = [(ctypes.c_int * L)(*(int(d) for d in dilations))]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, entry)(
            *(t.data_ptr() for t in args.values()), T, C, G, S, cin, L, k,
            *extra, x_out.data_ptr(), skip.data_ptr(), scratch.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    return x_out, skip


def fused_block_chain_tiled_cuda(x, c_up, stacked):
    """The causal gated-resblock chain (dilation k**l) on CUDA f32 tensors,
    as the IAF student serves it; the contract of
    ``ops.fused_resblock.fused_block_chain_tiled``."""
    out = _fused_chain_launch("fused_block_chain_tiled_cuda",
                              "fused_chain_tiled_f32", x, c_up, stacked)
    fused_block_chain_tiled_cuda.launches += 1
    return out


fused_block_chain_tiled_cuda.launches = 0


def fused_block_chain_cuda(x, c_up, stacked):
    """The causal chain over the whole T; the contract of
    ``ops.fused_resblock.fused_block_chain``."""
    out = _fused_chain_launch("fused_block_chain_cuda", "fused_chain_f32",
                              x, c_up, stacked)
    fused_block_chain_cuda.launches += 1
    return out


fused_block_chain_cuda.launches = 0


def fused_block_chain_nc_cuda(x, c_up, stacked, dilations):
    """The non-causal chain with one dilation a layer; the contract of
    ``ops.fused_resblock.fused_block_chain_nc``."""
    out = _fused_chain_launch("fused_block_chain_nc_cuda",
                              "fused_chain_nc_f32", x, c_up, stacked,
                              tuple(dilations))
    fused_block_chain_nc_cuda.launches += 1
    return out


fused_block_chain_nc_cuda.launches = 0
