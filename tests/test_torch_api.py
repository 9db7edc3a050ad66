"""The port's package-level API, its R-binding array API (`compat`) and its
profiling utilities, on the CPU: `__all__` is the JAX package's minus the
XLA-only `enable_compile_cache`, a star import gives exactly those names,
importing the package builds no kernel, `call_estimate` /
`call_emulate_at_list` match the JAX functions at float64 (the same
restarts fed to both), and `trace` / `sync` / `timed` keep the JAX
utilities' contract.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madaiemulator_tpu
import madaiemulator_tpu_torch
from madaiemulator_tpu import compat as jcompat
from madaiemulator_tpu.models import fit as jfit
from madaiemulator_tpu.ops import kernels as jk
from madaiemulator_tpu_torch import compat as tcompat
from madaiemulator_tpu_torch.models import fit as tfit
from madaiemulator_tpu_torch.ops import kernels as tk
from madaiemulator_tpu_torch.utils import profiling
import torch_shared  # noqa: F401


def test_all_is_the_jax_api_minus_the_compile_cache():
    want = [n for n in madaiemulator_tpu.__all__
            if n != "enable_compile_cache"]
    assert madaiemulator_tpu_torch.__all__ == want
    assert madaiemulator_tpu_torch.__version__ == madaiemulator_tpu.__version__
    ns = {}
    exec("from madaiemulator_tpu_torch import *", ns)
    assert sorted(k for k in ns if k != "__builtins__") == sorted(want)
    for name in want:
        assert getattr(madaiemulator_tpu_torch, name) is not None


def test_import_builds_no_kernel_and_imports_no_jax():
    """A fresh interpreter: importing the package (and every public name)
    leaves the kernel library unloaded, imports no jax, and turns TF32
    off."""
    code = (
        "import sys\n"
        "from madaiemulator_tpu_torch import *\n"
        "from madaiemulator_tpu_torch.ops.hopper import build\n"
        "import torch\n"
        "assert build._lib is None, 'kernels built at import'\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', "
        "'madaiemulator_tpu.')) for m in sys.modules)\n"
        "assert torch.backends.cuda.matmul.allow_tf32 is False\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout == "ok\n", out.stderr


@pytest.fixture
def same_starts(monkeypatch):
    """Both packages' fits start from the same unconstrained u0."""
    u0 = np.array([[0.3, -0.5, -0.4], [-0.6, 0.2, 0.8], [1.0, -1.2, 0.1]])
    monkeypatch.setattr(jfit, "sample_restarts", lambda *a, **k: jk.GPParams(
        jnp.asarray(u0[:, 0]), jnp.asarray(u0[:, 1]), jnp.asarray(u0[:, 2:])))
    monkeypatch.setattr(tfit, "sample_restarts", lambda *a, **k: tk.GPParams(
        torch.tensor(u0[:, 0]), torch.tensor(u0[:, 1]),
        torch.tensor(u0[:, 2:])))


def test_compat_matches_jax(same_starts):
    """tests/test_compat.py's 1-D sin (an unscaled design) with noise, so
    the fitted nugget stays off its floor: the fitted thetas, then the
    posterior at 20 points given them, against the JAX functions at
    float64."""
    X = np.linspace(0, 10, 30)[:, None]
    y = np.sin(X[:, 0]) + 0.05 * np.random.default_rng(1).standard_normal(30)
    want = jcompat.call_estimate(X, y, n_restarts=3, max_steps=40, seed=1)
    got = tcompat.call_estimate(X, y, n_restarts=3, max_steps=40, seed=1,
                                device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert got.shape == (3,) and np.all(got > 0)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    pts = np.linspace(0.5, 9.5, 20)[:, None]
    mj, vj = jcompat.call_emulate_at_list(X, y, got, pts)
    mt, vt = tcompat.call_emulate_at_list(X, y, got, pts, device="cpu")
    assert mt.shape == vt.shape == (20,)
    np.testing.assert_allclose(mt, mj, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(vt, vj, rtol=1e-9, atol=1e-14)


def test_compat_sin_rmse():
    """tests/test_compat.py's noiseless case with the port's own restarts:
    rmse under 1e-2, variances >= 0."""
    X = np.linspace(0, 10, 30)[:, None]
    y = np.sin(X[:, 0])
    th = tcompat.call_estimate(X, y, n_restarts=3, max_steps=40, seed=1,
                               device="cpu")
    pts = np.linspace(0.5, 9.5, 20)[:, None]
    m, v = tcompat.call_emulate_at_list(X, y, th, pts, device="cpu")
    assert np.sqrt(np.mean((m - np.sin(pts[:, 0])) ** 2)) < 1e-2
    assert np.all(v >= 0)


def test_compat_float32_and_errors():
    X = np.random.default_rng(0).uniform(size=(12, 2))
    y = X @ np.array([1.0, -2.0])
    th = tcompat.call_estimate(X, y, n_restarts=2, max_steps=5,
                               dtype=torch.float32, device="cpu")
    assert th.dtype == np.float32 and th.shape == (4,)
    m, v = tcompat.call_emulate_at_list(X, y, np.ones(4), X[:3],
                                        dtype=torch.float32, device="cpu")
    assert m.dtype == np.float32 and m.shape == (3,)
    with pytest.raises(ValueError):
        tcompat.call_estimate(np.zeros((5, 2)), np.zeros(4), device="cpu")


def test_profiling_trace_sync_timed(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)) as prof:
        a = torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None and float(a[0, 0]) == 64.0
    files = list(logdir.iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    assert files[0].stat().st_size > 0
    profiling.sync({"x": (3, [torch.zeros(2, 3)])})
    profiling.sync(1.5)  # no tensor leaf: nothing to wait for
    calls = []

    def fn(k):
        calls.append(k)
        return torch.full((2,), float(k)), None

    best, out = profiling.timed(fn, 7, reps=2, warmup=1)
    assert calls == [7, 7, 7] and 0.0 <= best < 60.0
    assert torch.equal(out[0], torch.full((2,), 7.0))
