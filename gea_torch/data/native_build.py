"""Builds the native C++ JPEG loader and binds it with ctypes (port of
`gea/data/native_build.py`).

`gea_torch/csrc/loader.cpp` is a byte-for-byte copy of `gea`'s
`gea/data/native/loader.cpp` (a test holds the two equal). It is compiled
with `gea`'s command, `g++ -O2 -shared -fPIC -std=c++17 ... -ljpeg
-lpthread`, against the system libjpeg, at the first `load_library()`,
never at import, into `build/gea_torch_loader/` at the root of the
checkout, beside the CUDA kernels' `build/gea_torch_kernels/`. The file
name carries a hash of the source and the command, so an edited source is
rebuilt. Where `g++` or libjpeg is missing, or the build fails (its stderr
is printed), `load_library()` returns None, as `gea`'s does, and the
callers use PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

SRC = Path(__file__).resolve().parent.parent / "csrc" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gea_torch_loader"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
# Seconds the last build took (None when the library was already built).
build_seconds: Optional[float] = None


def library_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes() + " ".join(GXX_FLAGS + LIBS).encode()).hexdigest()
    return BUILD_DIR / f"loader-{digest[:12]}.so"


def _build(path: Path) -> bool:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(SRC), *LIBS, "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if res.returncode != 0:
        print(f"[gea_torch] native loader build failed:\n{res.stderr[:2000]}")
        return False
    os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0
    return True


def load_library() -> Optional[ctypes.CDLL]:
    """The bound library, built on first use; None where it cannot be
    built or loaded (then once and for all in this process, as in `gea`)."""
    global _lib, _tried
    with _lock:
        if _lib is not None:
            return _lib
        if _tried:
            return None
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            print(f"[gea_torch] native loader dlopen failed: {e}")
            return None
        lib.gea_decode_square.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.gea_decode_square.restype = ctypes.c_int
        lib.gea_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int64,
        ]
        lib.gea_loader_create.restype = ctypes.c_void_p
        lib.gea_loader_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
        lib.gea_loader_next.restype = ctypes.c_int
        lib.gea_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.gea_loader_destroy.restype = None
        _lib = lib
        return _lib
