"""Builds the port's CUDA kernels and binds them through ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, and one more ``nvcc`` call links the objects into one shared
library with a plain C interface; nothing includes PyTorch's headers. It
runs at first use, into ``lvd_tpu_torch/_build/<hash>/`` (listed in
``.gitignore``), keyed by a hash of the sources and flags, and leaves no lock
file: the library is written under a temporary name and renamed.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "liblvd_kernels.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# C entry points and their argument types (pointers and the stream as void*;
# the int before the stream is the element type, DTYPE_CODES, or for kernels
# K-M ops/norms.DTYPE_CODES, which adds fp16).
SIGNATURES = {
    "lvd_attention_packed": [_P] * 5 + [_I] * 5 + [_F, _I, _I, _P],
    "lvd_temporal_pair": [_P] * 13 + [_I] * 5 + [_L] * 3 + [_F] + [_I] * 4 + [_I, _P],
    "lvd_geglu": [_P] * 6 + [_I] * 8 + [_I, _P],
    "lvd_geglu_stream": [_P] * 7 + [_I] * 8 + [_I, _P],
    "lvd_temp_conv": [_P] * 6 + [_I] * 11 + [_I, _P],
    "lvd_attention_packed_bwd": [_P] * 10 + [_I] * 5 + [_F, _I, _I, _P],
    "lvd_temporal_pair_bwd": [_P] * 14 + [_I] * 5 + [_L] * 3 + [_F] + [_I] * 3 + [_I, _P],
    "lvd_geglu_bwd": [_P] * 6 + [_I] * 8 + [_I, _P],
    "lvd_geglu_bwd_tf32": [_P] * 7 + [_I] * 7 + [_P],
    "lvd_geglu_bwd_round": [_P, _P, _L, _P],
    "lvd_linear": [_P] * 4 + [_I] * 4 + [_I, _P],
    "lvd_conv3x3": [_P] * 6 + [_I] * 10 + [_I, _P],
    "lvd_gn_stats": [_P] * 7 + [_I] * 11 + [_F, _F] + [_I, _I, _P],
    "lvd_gn_apply": [_P] * 4 + [_I] * 10 + [_I, _P],
    "lvd_layer_norm": [_P] * 4 + [_I] * 3 + [_F] + [_I, _I, _P],
}
# Entry points that return a byte count instead of a CUDA error code (a
# workspace size, or the dynamic shared memory of kernels A-I).
SIZE_QUERIES = {"lvd_temporal_pair_workspace": [_I] * 6,
                "lvd_temporal_pair_bwd_workspace": [_I] * 6,
                "lvd_temporal_pair_bwd_smem": [_I],
                "lvd_attention_packed_smem": [_I] * 3,
                "lvd_attention_packed_bwd_smem": [_I] * 4,
                "lvd_linear_smem": [_I],
                "lvd_conv3x3_smem": [_I] * 5,
                "lvd_geglu_smem": [_I] * 3,
                "lvd_geglu_bwd_smem": [_I] * 2,
                "lvd_temporal_pair_smem": [_I],
                "lvd_temp_conv_smem": [_I] * 2}

# The element types the kernels take, by the code their entry points read.
DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}

# Filled by build(): seconds the nvcc calls took (None when cached) and their log.
build_info: dict = {"seconds": None, "log": "", "path": None}


def sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("lvd_tpu_torch: nvcc not found (set CUDA_HOME)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compiles the kernels unless a library for these sources exists."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    build_info["path"] = str(lib_path)
    if lib_path.exists():
        log = out_dir / "build.log"
        build_info["log"] = log.read_text() if log.exists() else ""
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objects = [out_dir / f"{src.stem}.{os.getpid()}.o" for src in sources()]
    compiles = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for src, obj in zip(sources(), objects)]
    logs = [f"== {src.name}\n{proc.communicate()[0]}" for src, proc in zip(sources(), compiles)]
    failed = [src.name for src, proc in zip(sources(), compiles) if proc.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    build_info["seconds"] = time.perf_counter() - t0
    build_info["log"] = "\n".join(logs)
    (out_dir / "build.log").write_text(build_info["log"])
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"lvd_tpu_torch: nvcc failed on {failed}:\n{build_info['log']}")
    os.replace(tmp, lib_path)
    return lib_path


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    handle = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, argtypes in SIZE_QUERIES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong
    handle.lvd_error_string.argtypes = [ctypes.c_int]
    handle.lvd_error_string.restype = ctypes.c_char_p
    return handle


def check(err: int, name: str) -> None:
    if err != 0:
        msg = lib().lvd_error_string(err).decode()
        raise RuntimeError(f"lvd_tpu_torch: {name} launch failed: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def refuse_grad(name: str, *tensors) -> None:
    """A raw kernel launch is not differentiable: it raises when autograd
    would record it (grad mode on and an input requiring grad). The kernel
    wrappers reach their launches only inside a ``torch.autograd.Function``,
    whose forward and backward run with grad mode off."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: a raw kernel launch on a tensor that requires grad; "
                           "call it through its autograd.Function wrapper")


def dtype_code(t: torch.Tensor, name: str) -> int:
    """The entry points' code for t's type: bf16 or fp32; any other raises."""
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{name}: the kernels take bf16 or fp32, got {t.dtype}")
    return code


def kernel_input(t: torch.Tensor, dtype: torch.dtype, name: str) -> torch.Tensor:
    """Validates a CUDA tensor for a kernel: type, device, contiguity and
    alignment (the kernels load 16-byte vectors and 32-byte WMMA tiles).
    ``dtype`` is the type this operand must have (the stream's bf16 or fp32,
    or fp32 for statistics)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype or dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: expected {dtype} (bf16 or fp32), got {t.dtype}")
    t = t.contiguous()
    if t.data_ptr() % 256:
        t = t.clone()
    return t
