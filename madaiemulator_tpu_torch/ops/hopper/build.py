"""Build the Hopper kernels from `csrc/` with nvcc and bind them with ctypes.

The kernels are plain-C entry points compiled into one shared library:
one nvcc per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c csrc/<name>.cu -o <name>.o

then one link, `nvcc -shared -o libmadai_kernels_<hash>.so *.o`. K2 and K3
share their device code through the header `csrc/chol_cluster.cuh`.

The build runs at first use (never at import), from the package's own
sources, into `madaiemulator_tpu_torch/_kernels_build/`. The file name
carries a hash of every file under `csrc/` (headers included) and of the
flags, so an edited source or header rebuilds and an
unchanged one loads in milliseconds. `--use_fast_math` is deliberately
absent: the kernels' expf/sqrtf must stay IEEE-accurate for parity with the
float32 reference.

`load_skewed` builds a second, test-only library of K2 and K3 with
`-DMADAI_CLUSTER_SKEW_NS=<ns>`: every CTA of a cluster but rank 0 waits that
long before it loads a diagonal block that the cluster wrote (the hook in
`csrc/chol_cluster.cuh`). Its outputs must be bitwise equal to `load`'s; a
difference is a cross-CTA race. Only the checks (`chip_smoke.py`,
`tests/test_torch_cuda.py`, `tools/cluster_skew.py`) call it: the wrappers
load `load`'s library alone, which is compiled without the define.
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
SOURCES = ("pairwise.cu", "cholesky.cu", "panel_factor.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)
# The skewed build: the sources on the cluster device code, and the wait of
# every CTA but rank 0 before a diagonal-block load, in ns (many times the
# 32-column factor chain that rank 0 runs on the block meanwhile).
SKEW_SOURCES = ("cholesky.cu", "panel_factor.cu")
SKEW_NS = 20000

_lib = None
_skewed = None
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


def _skew_flags() -> tuple:
    return NVCC_FLAGS + (f"-DMADAI_CLUSTER_SKEW_NS={SKEW_NS}",)


def library_path(csrc: pathlib.Path = CSRC,
                 skewed: bool = False) -> pathlib.Path:
    """Where the library built from `csrc` lives: the name changes when any
    source or header there (`*.cu`, `*.cuh`) or a flag changes. `skewed`:
    the test-only build of `load_skewed`."""
    flags = _skew_flags() if skewed else NVCC_FLAGS
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(p for p in csrc.iterdir()
                    if p.suffix in (".cu", ".cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    stem = "libmadai_skewed" if skewed else "libmadai_kernels"
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def _run(procs) -> None:
    """Wait for every nvcc process; raise with the output of the first that
    failed."""
    failed = None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")


def _compile(out: pathlib.Path, sources=SOURCES, flags=NVCC_FLAGS) -> float:
    """Build `sources` with `flags` into the library `out`; returns the
    seconds it took."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, s.replace(".cu", ".o")) for s in sources]
        cmds = [[nvcc, *flags, "-c", str(CSRC / s), "-o", o]
                for s, o in zip(sources, objs)]
        _run([(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True))
              for c in cmds])
        lib = os.path.join(tmp, out.name)
        link = [nvcc, *flags[:2], "-shared", "-o", lib, *objs]
        _run([(link, subprocess.Popen(link, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))])
        # atomic: a concurrent process sees the old state or the whole file
        os.replace(lib, out)
    return time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built on first call; argtypes declared."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    path = library_path()
    if not path.exists():
        build_seconds = _compile(path)
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.madai_pairwise_covariance.argtypes = [
        ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr,
    ]
    lib.madai_pairwise_covariance.restype = i32
    lib.madai_error_string.argtypes = [i32]
    lib.madai_error_string.restype = ctypes.c_char_p
    _declare_cluster(lib)
    _lib = lib
    return lib


def load_skewed() -> ctypes.CDLL:
    """Test-only: K2 and K3 (`madai_cholesky`, `madai_panel_factor`) built
    with `-DMADAI_CLUSTER_SKEW_NS=SKEW_NS`, on first call, into a library of
    its own (`library_path(skewed=True)`); argtypes declared. The checks
    launch its entry points directly and compare with the wrappers'
    outputs; no wrapper loads it."""
    global _skewed
    if _skewed is not None:
        return _skewed
    path = library_path(skewed=True)
    if not path.exists():
        _compile(path, SKEW_SOURCES, _skew_flags())
    lib = ctypes.CDLL(str(path))
    _declare_cluster(lib)
    _skewed = lib
    return lib


def _declare_cluster(lib: ctypes.CDLL) -> None:
    """argtypes of K2's and K3's entry points and of the cluster helpers
    (csrc/cholesky.cu, csrc/panel_factor.cu)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.madai_cholesky.argtypes = [ptr, ptr, i32, i32, ptr]
    lib.madai_cholesky.restype = i32
    lib.madai_panel_factor.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
    lib.madai_panel_factor.restype = i32
    lib.madai_cluster_size.argtypes = [i32, i32]
    lib.madai_cluster_size.restype = i32
    lib.madai_cholesky_max_active_clusters.argtypes = [i32]
    lib.madai_cholesky_max_active_clusters.restype = i32


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        msg = lib.madai_error_string(err).decode()
        raise RuntimeError(f"{what}: kernel launch failed: CUDA error {err} ({msg})")
