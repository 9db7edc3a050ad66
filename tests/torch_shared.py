"""What the port's CPU tests share within one pytest process.

Every CPU test file of the port (`tests/test_torch_*.py` but
test_torch_cuda.py, whose tests run on the card) imports this module.
Importing it runs torch's CPU operators on one intra-op thread: the suite
runs six xdist workers on an 8-core machine, and at the tests' small
shapes torch's default pool of one thread per core spins against the
other workers instead of working (on such a machine, beside the rest of
the suite, the 40-point SGPR fit of tests/test_torch_snapshot_npz.py took
27.8 s at 8 threads and 0.27 s at 1).

`native_build` builds native/ (the shared library and `madai_query`) once
per process, into the session's temporary directory, never into
native/build, which tests/test_native.py may be building in another
worker.
"""

import pathlib
import shutil
import subprocess

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
_NATIVE = {}


def native_build(tmp_path_factory) -> pathlib.Path:
    """The directory holding this process's build of native/."""
    if "dir" not in _NATIVE:
        if shutil.which("g++") is None or shutil.which("make") is None:
            pytest.skip("no C++ toolchain")
        out = tmp_path_factory.mktemp("native_build")
        subprocess.run(["make", "-C", str(ROOT / "native"), f"BUILD={out}"],
                       check=True, capture_output=True, timeout=300)
        _NATIVE["dir"] = out
    return _NATIVE["dir"]
