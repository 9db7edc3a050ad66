"""Build the Hopper kernels from `csrc/` with nvcc and bind them with ctypes.

The kernels are plain-C entry points compiled into one shared library:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o libmadai_kernels_<hash>.so csrc/*.cu

The build runs at first use (never at import), from the package's own
sources, into `madaiemulator_tpu_torch/_kernels_build/`. The file name
carries a hash of the sources and flags, so an edited source rebuilds and an
unchanged one loads in milliseconds. `--use_fast_math` is deliberately
absent: the kernels' expf/sqrtf must stay IEEE-accurate for parity with the
float32 reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

_PKG = pathlib.Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernels_build"
SOURCES = ("pairwise.cu", "cholesky.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lib = None
build_seconds = None  # wall time of the nvcc run in this process, if any


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the Hopper "
        "kernels are built from source at first use"
    )


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libmadai_kernels_{h.hexdigest()[:16]}.so"


def _compile(out: pathlib.Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        # atomic: a concurrent process sees the old state or the whole file
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built on first call; argtypes declared."""
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.madai_pairwise_covariance.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr,
    ]
    lib.madai_pairwise_covariance.restype = i32
    lib.madai_cholesky.argtypes = [ptr, ptr, i32, i32, ptr]
    lib.madai_cholesky.restype = i32
    lib.madai_error_string.argtypes = [i32]
    lib.madai_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = lib.madai_error_string(err).decode()
        raise RuntimeError(f"{what}: kernel launch failed: CUDA error {err} ({msg})")
