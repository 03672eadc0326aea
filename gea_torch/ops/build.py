"""Builds the port's CUDA C++ kernels and loads them with ctypes.

Each source under `gea_torch/csrc/` is compiled by `nvcc` into its own
shared library with a plain C interface, for `sm_90a` (Hopper), into
`build/gea_torch_kernels/` at the root of the checkout; the sources share
the headers `csrc/*.cuh`. Nothing is built at
import: the first call of `load(name)` (or `build_all()`) builds, with one
`nvcc` process per source, all started together. A library's file name
carries a hash of its source, the headers and the flags, so an edited
source or header is rebuilt.

Every C entry point returns `cudaGetLastError()` after its launch;
`check(lib, rc, what)` turns a non-zero code into a RuntimeError.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gea_torch_kernels"
SOURCES = ("lis", "lis_bwd", "seed", "seed_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

SMEM_LIMIT = 232448  # shared memory a block may use on Hopper

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the port's "
            "CUDA kernels are built on a host with the CUDA toolkit"
        )
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel; return
    the library paths. Raises with nvcc's output if a build fails."""
    paths = {name: library_path(name) for name in SOURCES}
    missing = {n: p for n, p in paths.items() if not p.exists()}
    if not missing:
        return paths
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in missing.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOGS[name] = out
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n{out}")
        else:
            os.replace(tmp, missing[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        lib.gea_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gea_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.gea_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy of it if its data does not start on a 16-byte
    boundary: the kernels copy operands in 16-byte pieces."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def check_cuda_inputs(what: str, *tensors) -> None:
    """Every input of a kernel on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{what}: inputs on {t.device} and {dev}")
