"""Build and bind the hand-written CUDA kernels in ``csrc/``.

The kernels have a plain C interface: ``nvcc`` compiles each source into a
shared library under ``vqvae_speech_tpu_torch/build/`` at first use (a few
seconds; no PyTorch headers), and ``ctypes`` loads it. Nothing here runs at
import time, so the module imports on machines without ``nvcc`` or a GPU.

Each launching wrapper checks device, dtype, contiguity and shapes, allocates
its outputs with ``torch.empty``, launches on the current CUDA stream, raises
if the launch reported an error, and counts its launches in a plain integer
attribute (``vq_search_cuda.launches``, ``wavenet_step_cuda.launches``
for every launch of the decode step, prepared or not, and
``wavenet_step_cuda.wide_launches`` for those of more than 32 streams,
``fused_block_chain_cuda.launches``, ``fused_block_chain_tiled_cuda.launches``,
``fused_block_chain_nc_cuda.launches`` and the bf16 forms'
``fused_block_chain_bf16_cuda.launches``,
``fused_block_chain_tiled_bf16_cuda.launches``,
``fused_block_chain_nc_bf16_cuda.launches``).
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
    ptr = ctypes.c_void_p
    # N, K, D, *out (5 int64)
    lib.vq_search_plan.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(ctypes.c_int64)]
    lib.vq_search_plan.restype = ctypes.c_int
    # z, codebook, N, K, D, idx, q, counts, dw, scratch, stream
    lib.vq_search_f32.argtypes = [ptr, ptr, ctypes.c_int64, ctypes.c_int,
                                  ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr]
    lib.vq_search_f32.restype = ctypes.c_int


_VQ_PLAN_FIELDS = ("fused", "device_kernels", "blocks", "smem_bytes",
                   "scratch_floats")
_vq_plans = {}     # (device index, N, K, D) -> plan dict


def vq_search_plan(N: int, K: int, D: int, device) -> dict:
    """How csrc/vq_search.cu will run a search of this shape on ``device``:
    ``fused`` (one launch with the statistics, by the rule on (K, D) in the
    source header), ``device_kernels`` a search (1 or 2), the persistent
    grid's ``blocks``, ``smem_bytes`` a block and ``scratch_floats``. Raises
    when no block can hold the embedding width."""
    device = torch.device(device)
    key = (device.index, N, K, D)
    plan = _vq_plans.get(key)
    if plan is None:
        lib = _library("vq_search", _bind_vq_search)
        out = (ctypes.c_int64 * len(_VQ_PLAN_FIELDS))()
        with torch.cuda.device(device):
            if lib.vq_search_plan(N, K, D, out):
                raise ValueError(f"vq_search_cuda: embedding_dim {D} too wide "
                                 "for one block's shared memory")
        plan = _vq_plans[key] = dict(zip(_VQ_PLAN_FIELDS, out))
    return plan


def vq_search_cuda(flat: torch.Tensor, codebook: torch.Tensor):
    """Fused codebook search (csrc/vq_search.cu) on CUDA f32 tensors.

    flat (N, D), codebook (K, D) -> (indices (N,) int32, quantized (N, D),
    counts (K,), dw (K, D)), all f32 except the indices.

    Outputs and the kernel's scratch (the blocks' partial statistics) come
    from ``torch.empty`` on the current stream: no host sync, nothing to
    initialise, and the caching allocator keeps two streams' launches apart.
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
    if D == 64 and codebook.data_ptr() % 16:
        raise ValueError("vq_search_cuda: a 64-wide codebook is copied in "
                         "16-byte pieces and must be 16-byte aligned")
    dev = flat.device
    plan = vq_search_plan(N, K, D, dev)
    lib = _library("vq_search", _bind_vq_search)
    idx = torch.empty((N,), dtype=torch.int32, device=dev)
    q = torch.empty((N, D), dtype=torch.float32, device=dev)
    counts = torch.empty((K,), dtype=torch.float32, device=dev)
    dw = torch.empty((K, D), dtype=torch.float32, device=dev)
    scratch = torch.empty((plan["scratch_floats"],), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.vq_search_f32(flat.data_ptr(), codebook.data_ptr(), N, K, D,
                                idx.data_ptr(), q.data_ptr(),
                                counts.data_ptr(), dw.data_ptr(),
                                scratch.data_ptr(), stream)
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


# streams a launch of the step kernel computes; a larger batch is launched
# in groups of this many, each streaming the weights again
WAVENET_STEP_GROUP = 64
# a launch of more streams than this counts in wavenet_step_cuda.wide_launches
WAVENET_STEP_NARROW = 32
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
    pointers and launches the cooperative kernel on the current stream,
    once for every group of ``WAVENET_STEP_GROUP`` streams
    (``launches_per_step``; the groups read the batch in place, through its
    stride); it returns (x (B, C), skip (B, S), x_all (L, B, C)). Any
    ``batch`` >= 1 is taken.

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
        if B < 1:
            raise ValueError(f"wavenet_step_cuda: batch {B} < 1")
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
        info = self.describe()
        self.launches_per_step = info["launches"]
        # launches of a step that carry more than WAVENET_STEP_NARROW streams
        self.wide_launches_per_step = (
            (info["launches"] - 1) * (info["streams"] > WAVENET_STEP_NARROW)
            + (info["last_streams"] > WAVENET_STEP_NARROW))

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
        """The first group's launch shape: blocks, shared-memory bytes a
        block, the (tiles, slices, rows a slice) of the gate and the
        projection; ``launches``, the launches a step; ``streams`` and
        ``last_streams``, the streams the first and the last launch take."""
        out = (ctypes.c_int * 11)()
        self._lib.wavenet_step_describe(self._handle, out)
        return dict(zip(("blocks", "smem_bytes", "gate_tiles", "gate_slices",
                         "gate_rows", "proj_tiles", "proj_slices",
                         "proj_rows", "launches", "streams", "last_streams"),
                        out))

    def __call__(self, x0, taps, cond, stamps=None):
        """One step. ``stamps``, an int64 CUDA tensor of (blocks, 2L, 4, 2),
        receives every block's stamps of each phase (start, inputs staged,
        products done, partial sums stored) of the first group's launch,
        each as (global nanosecond timer, the SM's cycle counter)."""
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
        wavenet_step_cuda.launches += self.launches_per_step
        wavenet_step_cuda.wide_launches += self.wide_launches_per_step
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
wavenet_step_cuda.wide_launches = 0


def _bind_fused_resblock(lib: ctypes.CDLL) -> None:
    i32, ptr = ctypes.c_int, ctypes.c_void_p
    # T, C, G, cin, L, k, path, bf16, *floats, *split
    lib.fused_chain_scratch_floats.argtypes = (
        [i32] * 8 + [ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(i32)])
    lib.fused_chain_scratch_floats.restype = i32
    # wf, wg, wfc, wgc, wres, wskip, C, G, S, cin, L, k, wgate_hi, wgate_lo,
    # wproj_hi, wproj_lo, stream
    lib.fused_chain_prepare_f32.argtypes = [ptr] * 6 + [i32] * 6 + [ptr] * 5
    lib.fused_chain_prepare_f32.restype = i32
    # wf, wg, wfc, wgc, wres, wskip, C, G, S, cin, L, k, wgate, wproj, stream
    lib.fused_chain_prepare_bf16.argtypes = [ptr] * 6 + [i32] * 6 + [ptr] * 3
    lib.fused_chain_prepare_bf16.restype = i32
    # a, b_hi, b_lo, M, N, K, out, stream
    lib.fused_chain_matmul_f32.argtypes = [ptr] * 3 + [i32] * 3 + [ptr] * 2
    lib.fused_chain_matmul_f32.restype = i32
    # a, b, M, N, K, out, stream
    lib.fused_chain_matmul_bf16.argtypes = [ptr] * 2 + [i32] * 3 + [ptr] * 2
    lib.fused_chain_matmul_bf16.restype = i32
    # x, c, wgate_hi, wgate_lo, wproj_hi, wproj_lo, bf, bg, bres, bskip, T, C,
    # G, S, cin, L, k, path, [dilations,] x_out, skip, scratch, stream; the
    # bf16 forms take one wgate and one wproj
    for dtype, n_weights in (("f32", 4), ("bf16", 2)):
        chain = [ptr] * (n_weights + 6) + [i32] * 8
        for name in ("fused_chain", "fused_chain_tiled"):
            getattr(lib, f"{name}_{dtype}").argtypes = chain + [ptr] * 4
            getattr(lib, f"{name}_{dtype}").restype = i32
        getattr(lib, f"fused_chain_nc_{dtype}").argtypes = (
            chain + [ctypes.POINTER(i32)] + [ptr] * 4)
        getattr(lib, f"fused_chain_nc_{dtype}").restype = i32


FUSED_CHAIN_MAX_TAPS = 8
FUSED_CHAIN_MAX_LAYERS = 64
# The chain kernels' two decompositions. "auto" is what every caller gets:
# the shapes and the device's SM count decide (chains whose row-tiled gate
# launch would have under half a block an SM take the split path). The
# other two force one, for tests and measurements of both sides of that
# switch.
FUSED_CHAIN_PATHS = {"auto": 0, "rows": 1, "split": 2}
_STACKED = ("wf", "wg", "wfc", "wgc", "wres", "wskip", "bf", "bg", "bres",
            "bskip")
_BIASES = ("bf", "bg", "bres", "bskip")


def _check_chain_tensor(name, arg, t, dev, aligned=True,
                        dtype=torch.float32):
    if not t.is_cuda or (dev is not None and t.device != dev):
        raise ValueError(f"{name}: {arg} must be a CUDA tensor"
                         f"{'' if dev is None else f' on {dev}'}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {arg} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name}: {arg} must be 16-byte aligned")


class PreparedFusedChain:
    """One chain's weights bound to the chain kernels
    (csrc/fused_resblock.cu): everything that does not change from call to
    call is checked, laid out and allocated here, ONCE.

    The f32 kernels multiply on the tensor cores in error-compensated TF32
    and read the weights as the B operand, which must have the reduction
    index contiguous and comes split into a hi and a lo part. So the stacked
    arrays of ``ops.fused_resblock.stack_block_weights`` are transposed and
    split by a small kernel into ``wgate`` (2, L, 2G, k*C8 + cin8) and
    ``wproj`` (2, L, C+S, G8) (index 0 hi, 1 lo; x8 = x rounded up to 8;
    the layout of ``ops.fused_resblock.prepared_chain_weights_torch``):
    ``nbytes`` more device memory, twice the chain's weights. bf16 weights
    (``dtype``) keep the layout unsplit, (1, L, ...): the bf16 kernels take
    one product a product.

    ``run(...)`` then checks x and c_up and launches.
    """

    def __init__(self, stacked, name="fused_block_chain_cuda"):
        weights = {n: stacked[n] for n in _STACKED}
        wf = weights["wf"]
        dev = wf.device if wf.is_cuda else None
        dtype = wf.dtype if wf.dtype == torch.bfloat16 else torch.float32
        for arg, t in weights.items():
            _check_chain_tensor(name, arg, t, dev,
                                dtype=torch.float32 if arg in _BIASES
                                else dtype)
        if wf.dim() != 4:
            raise ValueError(f"{name}: wf must be (L, k, C, G), got "
                             f"{tuple(wf.shape)}")
        L, k, C, G = wf.shape
        cin = weights["wfc"].shape[1] if weights["wfc"].dim() == 3 else 0
        S = weights["wskip"].shape[-1]
        want = dict(wf=(L, k, C, G), wg=(L, k, C, G), wfc=(L, cin, G),
                    wgc=(L, cin, G), wres=(L, G, C), wskip=(L, G, S),
                    bf=(L, G), bg=(L, G), bres=(L, C), bskip=(L, S))
        for arg, shape in want.items():
            if tuple(weights[arg].shape) != shape:
                raise ValueError(f"{name}: {arg} has shape "
                                 f"{tuple(weights[arg].shape)}, expected "
                                 f"{shape}")
        if (cin < 1 or not 1 <= k <= FUSED_CHAIN_MAX_TAPS
                or not 1 <= L <= FUSED_CHAIN_MAX_LAYERS
                or C % 4 or G % 4 or S % 4 or min(C, G, S) < 4):
            raise ValueError(
                f"{name}: needs cin >= 1, 1 <= k <= {FUSED_CHAIN_MAX_TAPS}, "
                f"1 <= L <= {FUSED_CHAIN_MAX_LAYERS} and C, G, S positive "
                f"multiples of 4; got cin={cin} k={k} L={L} C={C} G={G} "
                f"S={S}")
        self.device = dev
        self.dtype = dtype
        self.layers, self.kernel_size = L, k
        self.dims = dict(L=L, k=k, C=C, G=G, S=S, cin=cin)
        self._biases = [weights[n] for n in _BIASES]
        self._lib = lib = _library("fused_resblock", _bind_fused_resblock)
        bf16 = dtype == torch.bfloat16
        parts = 1 if bf16 else 2
        with torch.cuda.device(dev):
            self.wgate = torch.empty(
                (parts, L, 2 * G, k * (-(-C // 8) * 8) + -(-cin // 8) * 8),
                dtype=dtype, device=dev)
            self.wproj = torch.empty((parts, L, C + S, -(-G // 8) * 8),
                                     dtype=dtype, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream
            sources = (weights[n].data_ptr() for n in _STACKED[:6])
            if bf16:
                err = lib.fused_chain_prepare_bf16(
                    *sources, C, G, S, cin, L, k, self.wgate.data_ptr(),
                    self.wproj.data_ptr(), stream)
            else:
                err = lib.fused_chain_prepare_f32(
                    *sources, C, G, S, cin, L, k, self.wgate[0].data_ptr(),
                    self.wgate[1].data_ptr(), self.wproj[0].data_ptr(),
                    self.wproj[1].data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"{name}: preparing the weights failed with "
                               f"CUDA error {err}")
        self.nbytes = self.wgate.element_size() * (self.wgate.numel()
                                                   + self.wproj.numel())
        self._plans = {}    # (T, path id) -> (scratch floats, split path?)

    def _plan(self, name, T, path_id):
        plan = self._plans.get((T, path_id))
        if plan is None:
            d = self.dims
            n_floats, split = ctypes.c_size_t(), ctypes.c_int()
            err = self._lib.fused_chain_scratch_floats(
                T, d["C"], d["G"], d["cin"], d["L"], d["k"], path_id,
                int(self.dtype == torch.bfloat16), ctypes.byref(n_floats),
                ctypes.byref(split))
            if err != 0:
                raise RuntimeError(f"{name}: CUDA error {err} sizing the "
                                   "scratch")
            plan = self._plans[(T, path_id)] = (n_floats.value,
                                                bool(split.value))
        return plan

    def run(self, name, entry, x, c_up, dilations=None, path="auto"):
        """Run the C entry point ``entry`` (its f32 or bf16 form, by the
        weights' dtype) on the current stream: x (T, C), c_up (T, cin) ->
        (x (T, C) in the weights' dtype, skip (T, S) f32), freshly
        allocated."""
        if path not in FUSED_CHAIN_PATHS:
            raise ValueError(f"{name}: path must be one of "
                             f"{sorted(FUSED_CHAIN_PATHS)}, got {path!r}")
        dev, d, dtype = self.device, self.dims, self.dtype
        # the conditioning may start at any element: its rows are copied one
        # element at a time unless they are 16-byte aligned
        _check_chain_tensor(name, "x", x, dev, dtype=dtype)
        _check_chain_tensor(name, "c_up", c_up, dev, aligned=False,
                            dtype=dtype)
        if x.dim() != 2 or x.shape[1] != d["C"] or x.shape[0] < 1:
            raise ValueError(f"{name}: x has shape {tuple(x.shape)}, expected "
                             f"(T >= 1, {d['C']})")
        T = x.shape[0]
        if tuple(c_up.shape) != (T, d["cin"]):
            raise ValueError(f"{name}: c_up has shape {tuple(c_up.shape)}, "
                             f"expected {(T, d['cin'])}")
        L, k = d["L"], d["k"]
        reach = max(dilations) if dilations is not None else k ** (L - 1)
        if ((k - 1) * reach >= 2 ** 31
                or T * max(d["C"], d["S"], d["cin"], 2 * d["G"]) >= 2 ** 31):
            raise ValueError(f"{name}: T={T} or dilation {reach} out of range")
        extra = []
        if dilations is not None:
            if len(dilations) != L or min(dilations) < 1:
                raise ValueError(f"{name}: needs {L} positive dilations, got "
                                 f"{tuple(dilations)}")
            extra = [(ctypes.c_int * L)(*(int(v) for v in dilations))]
        path_id = FUSED_CHAIN_PATHS[path]
        bf16 = dtype == torch.bfloat16
        with torch.cuda.device(dev):
            n_floats, split = self._plan(name, T, path_id)
            x_out = torch.empty((T, d["C"]), dtype=dtype, device=dev)
            skip = torch.empty((T, d["S"]), dtype=torch.float32, device=dev)
            scratch = torch.empty((n_floats,), dtype=torch.float32, device=dev)
            weights = ([self.wgate.data_ptr(), self.wproj.data_ptr()] if bf16
                       else [self.wgate[0].data_ptr(), self.wgate[1].data_ptr(),
                             self.wproj[0].data_ptr(),
                             self.wproj[1].data_ptr()])
            err = getattr(self._lib, f"{entry}_{'bf16' if bf16 else 'f32'}")(
                x.data_ptr(), c_up.data_ptr(), *weights,
                *(b.data_ptr() for b in self._biases), T, d["C"], d["G"],
                d["S"], d["cin"], L, k, path_id, *extra, x_out.data_ptr(),
                skip.data_ptr(), scratch.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
        _fused_chain_launch.last_split = split
        return x_out, skip


def _fused_chain_launch(name, entry, x, c_up, stacked, dilations=None,
                        path="auto", dtype=torch.float32):
    """Run one fused chain on the current stream. ``stacked`` is a
    ``PreparedFusedChain``, or the dictionary of
    ``ops.fused_resblock.stack_block_weights``, which is prepared here for
    this one call; its weights must be of ``dtype``, the wrapper's own.
    x (T, C), c_up (T, cin) -> (x (T, C), skip (T, S))."""
    if not isinstance(stacked, PreparedFusedChain):
        stacked = PreparedFusedChain(stacked, name)
    if stacked.dtype != dtype:
        raise ValueError(f"{name}: takes {dtype} weights, got "
                         f"{stacked.dtype}")
    return stacked.run(name, entry, x, c_up, dilations, path)


# whether the last chain launched took the split path (for tests and reports)
_fused_chain_launch.last_split = False


def tf32x3_matmul_cuda(a, b_hi, b_lo):
    """a (M, K) @ b^T through the chain kernels' main loop alone, b given as
    its split parts (N, K rounded up to 8) as
    ``ops.fused_resblock.split_tf32`` makes them: a check of the loop
    against a library product, not a path of the port."""
    name = "tf32x3_matmul_cuda"
    for arg, t in (("a", a), ("b_hi", b_hi), ("b_lo", b_lo)):
        _check_chain_tensor(name, arg, t, a.device if a.is_cuda else None)
    M, K = a.shape
    N, K8 = b_hi.shape
    if b_lo.shape != b_hi.shape or K8 != -(-K // 8) * 8 or min(M, N, K) < 1:
        raise ValueError(f"{name}: a {tuple(a.shape)} against b_hi "
                         f"{tuple(b_hi.shape)}, b_lo {tuple(b_lo.shape)}")
    lib = _library("fused_resblock", _bind_fused_resblock)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.fused_chain_matmul_f32(
            a.data_ptr(), b_hi.data_ptr(), b_lo.data_ptr(), M, N, K,
            out.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    return out


def bf16_matmul_cuda(a, b):
    """a (M, K) @ b^T in f32 through the bf16 chain kernels' main loop
    alone, a and b (N, K rounded up to 8) bf16: a check of the loop against
    a library product, not a path of the port."""
    name = "bf16_matmul_cuda"
    for arg, t in (("a", a), ("b", b)):
        _check_chain_tensor(name, arg, t, a.device if a.is_cuda else None,
                            dtype=torch.bfloat16)
    M, K = a.shape
    N, K8 = b.shape
    if K8 != -(-K // 8) * 8 or min(M, N, K) < 1 or K % 8:
        raise ValueError(f"{name}: a {tuple(a.shape)} against b "
                         f"{tuple(b.shape)} (K a multiple of 8)")
    lib = _library("fused_resblock", _bind_fused_resblock)
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = lib.fused_chain_matmul_bf16(
            a.data_ptr(), b.data_ptr(), M, N, K, out.data_ptr(),
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    return out


def fused_block_chain_tiled_cuda(x, c_up, stacked, path="auto"):
    """The causal gated-resblock chain (dilation k**l) on CUDA f32 tensors,
    as the IAF student serves it; the contract of
    ``ops.fused_resblock.fused_block_chain_tiled``."""
    out = _fused_chain_launch("fused_block_chain_tiled_cuda",
                              "fused_chain_tiled", x, c_up, stacked,
                              path=path)
    fused_block_chain_tiled_cuda.launches += 1
    return out


fused_block_chain_tiled_cuda.launches = 0


def fused_block_chain_cuda(x, c_up, stacked, path="auto"):
    """The causal chain over the whole T; the contract of
    ``ops.fused_resblock.fused_block_chain``."""
    out = _fused_chain_launch("fused_block_chain_cuda", "fused_chain",
                              x, c_up, stacked, path=path)
    fused_block_chain_cuda.launches += 1
    return out


fused_block_chain_cuda.launches = 0


def fused_block_chain_nc_cuda(x, c_up, stacked, dilations, path="auto"):
    """The non-causal chain with one dilation a layer; the contract of
    ``ops.fused_resblock.fused_block_chain_nc``."""
    out = _fused_chain_launch("fused_block_chain_nc_cuda",
                              "fused_chain_nc", x, c_up, stacked,
                              tuple(dilations), path=path)
    fused_block_chain_nc_cuda.launches += 1
    return out


fused_block_chain_nc_cuda.launches = 0


# The bf16 forms (csrc/fused_resblock.cu, fused_chain_*_bf16): x, c_up and
# the weights bf16, the biases f32; x comes back bf16, skip f32. One bf16
# wgmma product a product, f32 sums.


def fused_block_chain_tiled_bf16_cuda(x, c_up, stacked, path="auto"):
    """The causal chain (dilation k**l) on CUDA bf16 tensors, as the IAF
    student serves it at bf16; the contract of
    ``ops.fused_resblock.fused_block_chain_tiled`` at bf16."""
    out = _fused_chain_launch("fused_block_chain_tiled_bf16_cuda",
                              "fused_chain_tiled", x, c_up, stacked,
                              path=path, dtype=torch.bfloat16)
    fused_block_chain_tiled_bf16_cuda.launches += 1
    return out


fused_block_chain_tiled_bf16_cuda.launches = 0


def fused_block_chain_bf16_cuda(x, c_up, stacked, path="auto"):
    """The causal chain over the whole T at bf16; the contract of
    ``ops.fused_resblock.fused_block_chain`` at bf16."""
    out = _fused_chain_launch("fused_block_chain_bf16_cuda", "fused_chain",
                              x, c_up, stacked, path=path,
                              dtype=torch.bfloat16)
    fused_block_chain_bf16_cuda.launches += 1
    return out


fused_block_chain_bf16_cuda.launches = 0


def fused_block_chain_nc_bf16_cuda(x, c_up, stacked, dilations, path="auto"):
    """The non-causal chain with one dilation a layer at bf16; the contract
    of ``ops.fused_resblock.fused_block_chain_nc`` at bf16."""
    out = _fused_chain_launch("fused_block_chain_nc_bf16_cuda",
                              "fused_chain_nc", x, c_up, stacked,
                              tuple(dilations), path=path,
                              dtype=torch.bfloat16)
    fused_block_chain_nc_bf16_cuda.launches += 1
    return out


fused_block_chain_nc_bf16_cuda.launches = 0
