"""ctypes binding of the port's native GIF encoder (counterpart of
lvd_tpu/utils/native.py).

``csrc/host/gifenc.cc`` (a copy of lvd_tpu's native/gifenc.cc: a fixed
6x7x6 color cube, Floyd-Steinberg dithering, LZW) is built on first use
with ``g++ -O2 -shared -fPIC`` into ``lvd_tpu_torch/_build/host/<hash>/``
(listed in ``.gitignore``, beside the kernels), keyed by a hash of the
source, written under a temporary name and renamed. ``LVD_DISABLE_NATIVE=1``
(lvd_tpu's switch, read at the first use as lvd_tpu reads it) selects PIL;
otherwise a failed build or load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "host" / "gifenc.cc"
BUILD_ROOT = _PKG / "_build" / "host"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_STATE: dict = {}


def build() -> Path:
    """Compiles the encoder unless a library for this source exists."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    lib_path = BUILD_ROOT / h / "libgifenc.so"
    if lib_path.exists():
        return lib_path
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"libgifenc.so.{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True,
                          text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"lvd_tpu_torch: {cxx} failed on {SOURCE.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def _load():
    """The bound library, or None under ``LVD_DISABLE_NATIVE=1``."""
    with _LOCK:
        if "lib" not in _STATE:
            lib = None
            if os.environ.get("LVD_DISABLE_NATIVE") != "1":
                lib = ctypes.CDLL(str(build()))
                lib.gif_encode.restype = ctypes.c_int
                lib.gif_encode.argtypes = [ctypes.POINTER(ctypes.c_uint8)] + [ctypes.c_int] * 5 \
                    + [ctypes.c_char_p]
            _STATE["lib"] = lib
        return _STATE["lib"]


def gif_encode(path: str, frames, fps: int = 8, dither: bool = True) -> bool:
    """Encodes (F, H, W, 3) uint8 frames to a looping GIF. False when the
    encoder is switched off or the frames are not RGB (the caller writes
    with PIL then); raises when it fails."""
    import numpy as np

    lib = _load()
    frames = np.ascontiguousarray(np.asarray(frames, dtype=np.uint8))
    if lib is None or frames.ndim != 4 or frames.shape[-1] != 3:
        return False
    f, h, w, _ = frames.shape
    rc = lib.gif_encode(frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), f, h, w,
                        max(int(round(100 / fps)), 1), 1 if dither else 0, path.encode())
    if rc != 0:
        raise RuntimeError(f"lvd_tpu_torch: the native GIF encoder failed ({rc}) on {path}")
    return True
