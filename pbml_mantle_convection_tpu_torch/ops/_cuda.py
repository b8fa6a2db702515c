"""Build and load the package's hand-written CUDA kernels.

The sources under ``csrc/`` have a plain C interface. At first use each
``.cu`` file is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a``, the objects are linked into one shared library
under ``build/cuda_kernels/`` beside the package (a directory git
ignores), and the library is loaded with ``ctypes``. The library's name
carries a hash of the sources and flags, so an edited source never loads
a stale build. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("layer_stack.cu", "trunk.cu", "epilogue.cu", "advect.cu",
           "slice_attention.cu", "dense_attention.cu",
           "projection_conv.cu", "dense_gemm.cu")
HEADERS = ("pmc_common.cuh", "blc_layer.cuh")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cuda_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double
_IP = ctypes.POINTER(ctypes.c_int)
SLICE_TYPES = ("f32", "f64", "bf16", "f16")
# C entry points: name → argument types (every one returns a cudaError_t)
_SIGNATURES = {
    "pmc_layer_stacks": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                         _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "pmc_trunk": [_P, _P, _P, _I, _P, _I, _P, _P, _P, _P,
                  _P, _P, _P, _P, _P, _P, _P, _P,
                  _I, _I, _I, _I, _I, _I, _P],
    "pmc_curl_advect_epilogue": [_P, _P, _P, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _P, _I,
                                 _I, _I, _F, _F, _F, _F, _P],
    # the launch floor (csrc/epilogue.cu): blocks, threads, mode
    "pmc_empty": [_I, _I, _I, _P],
    # float32 and float64 instances of csrc/advect.cu
    **{f"pmc_advect_{t}": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                           _I, _P, _I, _I, _I, _D, _D, _D, _I, _I, _P]
       for t in ("f32", "f64")},
    # the float32, float64, bfloat16 and float16 instances of
    # csrc/slice_attention.cu
    **{f"pmc_slice_{k}_plan_{t}": [_I, _I, _I, _I, _IP, _IP]
       for t in SLICE_TYPES for k in ("pool", "deslice")},
    **{f"pmc_slice_pool_{t}": [_P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L,
                               _I, _I, _I, _I, _P]
       for t in SLICE_TYPES},
    **{f"pmc_slice_deslice_{t}": [_P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L,
                                  _I, _I, _I, _I, _P]
       for t in SLICE_TYPES},
    # csrc/dense_attention.cu: q, k, v, out, B, H, N, the (b, h, n) strides
    # of q, k, v and out, the scale times log2(e), the stream
    "pmc_dense_attention": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _L,
                            _L, _L, _L, _L, _L, _L, _L, _F, _P],
    # csrc/projection_conv.cu: the image, the packed weights, b0, b1, y0,
    # y1, B, H, W, C, C_out, the stream
    "pmc_projection_conv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # csrc/dense_gemm.cu: x, the packed weight, the bias, y, M, K, N, gelu,
    # the stream
    "pmc_dense_gemm": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


def _source_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[Path, float, str]:
    """Compile the kernels if this source version has no library yet.

    Returns (library path, seconds spent building — 0 when it existed,
    the compilers' ``-Xptxas -v`` report).
    """
    so = BUILD_DIR / f"libpmc_kernels_{_source_key()}.so"
    log = so.with_suffix(".log")
    if so.exists():
        return so, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (src + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                 str(CSRC / src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        report = []
        failed = []
        for src, _, p in procs:
            out, _ = p.communicate()
            report.append(f"== {src}\n{out}")
            if p.returncode:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n"
                               + "\n".join(report))
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:4], "-shared", "-o", str(tmp_so),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        text = "\n".join(report)
        log.write_text(text)
        os.replace(tmp_so, so)
    return so, time.perf_counter() - t0, text


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    so, _, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pmc_error_string.argtypes = [ctypes.c_int]
    lib.pmc_error_string.restype = ctypes.c_char_p
    lib.pmc_work_items.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.pmc_work_items.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def work_items(H: int, W: int, zero_pad: bool = False) -> int:
    """Blocks of one layer launch over an H × W field (the rows of its
    per-block GroupNorm scratch), of the zero-padded instance when
    ``zero_pad``, else of the learned-boundary one."""
    return library().pmc_work_items(H, W, int(zero_pad))


# fields one layer launch takes (csrc/pmc_common.cuh::kMaxLevels)
MAX_LEVELS = 5
# the most blocks of a cooperative launch (epilogue.cu, advect.cu) that
# their grid-wide join's scratch holds; the C side caps the grid here and
# at the blocks the card holds at once (a few hundred of 512 threads on an
# H100), and the threads loop over the points past it
JOIN_BLOCKS = 4096


@functools.lru_cache(maxsize=None)
def counters(device: torch.device) -> torch.Tensor:
    """The layer kernels' ticket counters on ``device``: zeroed once, and
    zero again after every launch (the last block of a field resets its
    counter). Launches that use them run on one stream at a time."""
    return torch.zeros(MAX_LEVELS, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def join_scratch(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The energy kernels' per-block values of their grid-wide join
    (csrc/epilogue.cu, csrc/advect.cu) on ``device``: 2 · JOIN_BLOCKS
    values, allocated at the first call (make it before a CUDA-graph
    capture) and rewritten by every launch before it reads them, so a
    replay needs no reset. Launches that use them run on one stream at a
    time."""
    return torch.empty(2 * JOIN_BLOCKS, dtype=dtype, device=device)


def raise_on_error(err: int, name: str) -> None:
    if err:
        msg = library().pmc_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype,
               shape=None) -> None:
    """What every kernel takes: a contiguous tensor of ``dtype`` on the
    card, of the expected shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


def check_cuda_f32(name: str, t: torch.Tensor, shape=None) -> None:
    check_cuda(name, t, torch.float32, shape)


def packed_once(owner, pack, *weights):
    """``pack(*weights)``, kept on ``owner`` (its ``_packed``, under the
    key ``_packed_key``) for as long as the weights stay the same: made at
    the first call, and again only when a weight is replaced or written in
    place (its storage or its version counter moves)."""
    key = tuple((w.data_ptr(), w._version) for w in weights)
    if owner._packed_key != key:
        owner._packed, owner._packed_key = pack(*weights), key
    return owner._packed


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
