"""Builds the port's CUDA kernels and binds them through ctypes.

One ``nvcc`` call compiles every ``csrc/*.cu`` into one shared library with a
plain C interface; nothing includes PyTorch's headers, so the build takes
seconds. It runs at first use, into ``lvd_tpu_torch/_build/<hash>/`` (listed
in ``.gitignore``), keyed by a hash of the sources and flags, and leaves no
lock file: the library is written under a temporary name and renamed.

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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# C entry points and their argument types (pointers and the stream as void*).
SIGNATURES = {
    "lvd_attention_packed": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "lvd_temporal_pair": [_P] * 12 + [_I] * 5 + [_L] * 3 + [_F, _P],
    "lvd_geglu": [_P] * 6 + [_I] * 4 + [_P],
    "lvd_temp_conv": [_P] * 6 + [_I] * 4 + [_P],
    "lvd_attention_packed_bwd": [_P] * 10 + [_I] * 5 + [_F, _P],
    "lvd_temporal_pair_bwd": [_P] * 14 + [_I] * 5 + [_L] * 3 + [_F, _P],
    "lvd_geglu_bwd": [_P] * 6 + [_I] * 4 + [_P],
}
# Entry points that return a byte count instead of a CUDA error code.
SIZE_QUERIES = {"lvd_temporal_pair_bwd_workspace": [_I] * 4}

# Filled by build(): seconds the nvcc call took (None when cached) and its log.
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
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_info["seconds"] = time.perf_counter() - t0
    build_info["log"] = proc.stdout + proc.stderr
    (out_dir / "build.log").write_text(build_info["log"])
    if proc.returncode != 0:
        raise RuntimeError(
            f"lvd_tpu_torch: nvcc failed ({proc.returncode}):\n{build_info['log']}"
        )
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


def params_need_grad(tree) -> bool:
    """Whether autograd would record a gradient for any tensor of a param
    tree (the backward kernels compute input gradients only)."""
    if not torch.is_grad_enabled():
        return False
    if isinstance(tree, dict):
        return any(params_need_grad(v) for v in tree.values())
    return isinstance(tree, torch.Tensor) and tree.requires_grad


def kernel_input(t: torch.Tensor, dtype: torch.dtype, name: str) -> torch.Tensor:
    """Validates a CUDA tensor for a kernel: type, device, contiguity and
    alignment (the kernels load 16-byte vectors and 32-byte WMMA tiles)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    t = t.contiguous()
    if t.data_ptr() % 256:
        t = t.clone()
    return t
