"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``.  The build happens at
first use, never at import, into ``REPRO_TORCH_BUILD_DIR`` (default
``src/repro_torch/_build``, which git ignores); a library's file name
carries a digest of its sources and flags, so an edited source rebuilds.
:func:`build` compiles several sources in parallel (one ``nvcc`` each).

``LAUNCHES`` counts kernel launches by name: each wrapper adds one where it
launches its kernel, and nowhere else, so a run can show that its path
went through the kernels (the CPU plain versions never touch it).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"

# one shared library per source file; the header is part of every digest
SOURCES = {
    "w1a8_gemv": "w1a8_gemv.cu",
    "int8_matmul": "int8_matmul.cu",
    "w1a8_matmul": "w1a8_matmul.cu",
    "decoupled_matmul": "decoupled_matmul.cu",
    "rmsnorm_quant": "rmsnorm_quant.cu",
    "paged_attention": "paged_attention.cu",
}
HEADERS = ("gemv_common.cuh", "gemv_mma.cuh", "tile_gemm.cuh", "wgmma_pipe.cuh")

# IEEE division and rounding throughout: no --use_fast_math (gamma and the
# epilogue scales must equal the plain versions' bit for bit)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

LAUNCHES: collections.Counter = collections.Counter()

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    LAUNCHES.clear()


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parent.parent / "_build"


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named kernel libraries that are not built yet, all
    ``nvcc`` processes at once.  Returns {name: seconds} for those built;
    raises with the compiler's output if one fails."""
    import time

    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [exe, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    seconds, failed = {}, []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        seconds[n] = time.perf_counter() - t0
        if p.returncode:
            os.unlink(tmp)
            failed.append(f"--- nvcc {SOURCES[n]} (exit {p.returncode})\n{log}")
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The loaded library of ``name`` (built on first use), with
    ``argtypes`` set from ``signatures`` and every function returning the
    ``cudaError_t`` of its launch as an int."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device_index: int) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on the device."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def device_index(t: "torch.Tensor") -> int:
    """The CUDA device index of ``t``; raises for any other device."""
    idx = t.get_device()
    if idx < 0 or not t.is_cuda:
        raise ValueError(f"no kernel for device {t.device}")
    return idx


def on_device(t: "torch.Tensor", dtype, device: int, what: str) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on CUDA device
    ``device`` (the launch checks every pointer it passes)."""
    if t.dtype != dtype or t.get_device() != device or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} tensor on cuda:{device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def scalar_ptr(t: "torch.Tensor", device: int, what: str) -> int:
    """Device pointer of a one-element float32 tensor on ``device`` (the
    kernels read scales through device pointers: no host sync)."""
    if t.numel() != 1:
        raise ValueError(f"{what} must have one element, got {tuple(t.shape)}")
    on_device(t, torch.float32, device, what)
    return t.data_ptr()


# the float types the prefill-tier and attention kernels read or write, by
# launch code
FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def float_code(dtype, what: str) -> int:
    """The launch code of a float type the kernels take; raises for others."""
    if dtype not in FLOAT_CODES:
        raise ValueError(f"{what} must be float32 or bfloat16, got {dtype}")
    return FLOAT_CODES[dtype]
