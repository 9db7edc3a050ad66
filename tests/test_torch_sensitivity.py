"""The port's Sobol sensitivity analysis (`madaiemulator_tpu_torch.models.
sensitivity`) against the JAX package's on the CPU at float64: the Saltelli
indices and the main-effect curves with JAX's draws injected through the
port's draw helpers (`_saltelli_uniform`, `_base_uniform`), the Ishigami
closed forms with the port's own draws, chunked against unchunked, both
emulator adapters, and the CLI's `sensitivity --main_effects` against the
JAX CLI's output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu import cli as jcli
from madaiemulator_tpu.io import snapshot as jsnap
from madaiemulator_tpu.models import sensitivity as jsens
from madaiemulator_tpu.models.gp import GPData as JData
from madaiemulator_tpu.ops import kernels as jk
from madaiemulator_tpu.utils import config as jcfg
from madaiemulator_tpu_torch import cli as tcli
from madaiemulator_tpu_torch.io import snapshot as tsnap
from madaiemulator_tpu_torch.models import gp as tgp
from madaiemulator_tpu_torch.models import multivariate as tmv
from madaiemulator_tpu_torch.models import sensitivity as tsens
from madaiemulator_tpu_torch.ops import kernels as tk
from madaiemulator_tpu_torch.utils import config as tcfg
import torch_shared  # noqa: F401

CPU = torch.device("cpu")
# the same float64 estimators on the same evaluations, up to summation order
RTOL = 1e-9


def _close(got, want, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _jax_draws(monkeypatch):
    """Route the port's draw helpers to jax.random's draws from the key of
    the generator's seed: what the JAX functions draw from that key."""
    def saltelli(gen, n, d, dtype, device):
        ka, kb = jax.random.split(jax.random.key(gen.initial_seed()))
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        return tuple(torch.tensor(np.asarray(jax.random.uniform(
            k, (n, d), dtype=jdt)), device=device) for k in (ka, kb))

    def base(gen, n, d, dtype, device):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        return torch.tensor(np.asarray(jax.random.uniform(
            jax.random.key(gen.initial_seed()), (n, d), dtype=jdt)),
            device=device)

    monkeypatch.setattr(tsens, "_saltelli_uniform", saltelli)
    monkeypatch.setattr(tsens, "_base_uniform", base)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _ishigami(U, xp):
    """Ishigami on [0,1]^3 mapped to [-pi, pi]^3 (a=7, b=0.1); xp is the
    array module (jnp or torch)."""
    X = (U - 0.5) * (2.0 * np.pi)
    return (xp.sin(X[:, 0]) + 7.0 * xp.sin(X[:, 1]) ** 2
            + 0.1 * X[:, 2] ** 4 * xp.sin(X[:, 0]))


def _multi(U, xp):
    """A (m, 2) output: observable indices come out per column."""
    return xp.stack([2.0 * U[:, 0] + U[:, 1] ** 2,
                     xp.sin(3.0 * U[:, 1]) * U[:, 0]], 1)


@pytest.mark.parametrize("fn,chunk", [(_ishigami, 500), (_multi, None)])
def test_sobol_matches_jax_with_jax_draws(fn, chunk, monkeypatch):
    """The same Saltelli design (JAX's A and B) through both estimators;
    the port's host chunks against JAX's padded lax.map."""
    _jax_draws(monkeypatch)
    d, n = 3, 1024
    want = jsens.sobol_indices(lambda U: fn(U, jnp), d, jax.random.key(4),
                               n=n, query_chunk=chunk, dtype=jnp.float64)
    got = tsens.sobol_indices(lambda U: fn(U, torch), d, _gen(4), n=n,
                              query_chunk=chunk, dtype=torch.float64,
                              device=CPU)
    assert isinstance(got, tsens.SobolResult)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        _close(a, b)


def test_sobol_ishigami_analytic():
    """The estimators against the Ishigami closed forms, with the port's
    own draws (the JAX test's sample size and tolerance)."""
    a, b = 7.0, 0.1
    pi = np.pi
    V1 = 0.5 * (1 + b * pi ** 4 / 5) ** 2
    V2 = a ** 2 / 8
    V13 = b ** 2 * pi ** 8 * (1 / 18 - 1 / 50)
    V = V1 + V2 + V13
    res = tsens.sobol_indices(lambda U: _ishigami(U, torch), 3, _gen(0),
                              n=32768, dtype=torch.float64, device=CPU)
    _close(res.first, [V1 / V, V2 / V, 0.0], rtol=0, atol=0.02)
    _close(res.total, [(V1 + V13) / V, V2 / V, V13 / V], rtol=0, atol=0.02)
    _close(res.variance, V, rtol=0.05)


def test_sobol_chunked_matches_unchunked():
    """Chunking evaluates the same rows: the results are the same (the last
    chunk is short, not padded)."""
    f = lambda U: _ishigami(U, torch)  # noqa: E731
    r1 = tsens.sobol_indices(f, 3, _gen(1), n=2048, query_chunk=None,
                             device=CPU)
    r2 = tsens.sobol_indices(f, 3, _gen(1), n=2048, query_chunk=500,
                             device=CPU)
    assert r1.first.dtype == torch.float32
    for a, b in zip(r1, r2):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_sobol_zero_variance_gives_zero_indices():
    res = tsens.sobol_indices(lambda U: torch.ones(U.shape[0]), 2, _gen(0),
                              n=64, device=CPU)
    assert float(res.variance) == 0.0
    assert torch.equal(res.first, torch.zeros(2))
    assert torch.equal(res.total, torch.zeros(2))


@pytest.mark.parametrize("fn", [_ishigami, _multi])
def test_main_effects_matches_jax_with_jax_draws(fn, monkeypatch):
    _jax_draws(monkeypatch)
    gj, ej = jsens.main_effects(lambda U: fn(U, jnp), 3, jax.random.key(5),
                                grid=9, n=300, query_chunk=1000,
                                dtype=jnp.float64)
    gt, et = tsens.main_effects(lambda U: fn(U, torch), 3, _gen(5), grid=9,
                                n=300, query_chunk=1000, dtype=torch.float64,
                                device=CPU)
    assert et.shape == ej.shape
    _close(gt, gj)
    _close(et, ej)


def test_main_effects_linear():
    """E[f | x0 = v] = 2 v + 0.5 and E[f | x1 = v] = 1 + v for
    f = 2 x0 + x1 on [0,1]^2 (the JAX test's case, the port's draws)."""
    gv, eff = tsens.main_effects(lambda U: 2.0 * U[:, 0] + U[:, 1], 2,
                                 _gen(4), grid=11, n=20000,
                                 dtype=torch.float64, device=CPU)
    _close(eff[0], 2.0 * gv + 0.5, rtol=0, atol=0.02)
    _close(eff[1], 1.0 + gv, rtol=0, atol=0.02)


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    """A dense multivariate emulator (N=24, d=2, t=3 -> r=2; fixed thetas)
    as a text snapshot that both packages read."""
    rng = np.random.default_rng(21)
    N, D = 24, 2
    X = rng.uniform(1.0, 3.0, size=(N, D))
    Y = np.stack([np.sin(2 * X[:, 0]) + X[:, 1], X[:, 0] * X[:, 1],
                  np.cos(X[:, 1])], 1) + 0.02 * rng.standard_normal((N, 3))
    pca, Z = tmv.pca_decompose(Y, 0.95)
    r = Z.shape[1]
    mins, ranges = X.min(0), X.max(0) - X.min(0)
    arrays = dict(
        mins=mins, ranges=ranges, X=(X - mins) / ranges, Z=Z,
        ymean=pca.ymean, ystd=pca.ystd, eigenvalues=pca.eigenvalues, U=pca.U,
        log_amp=np.log(np.linspace(0.8, 1.2, r)),
        log_nugget=np.log(np.linspace(2e-3, 5e-3, r)),
        log_ls=np.log(np.tile([0.4, 0.6], (r, 1))))
    cfg = tcfg.GPConfig(nparams=D, regression_order=1)
    emu = tmv.emulator_from_numpy(arrays, cfg, CPU, build_states=False)
    state = str(tmp_path_factory.mktemp("sens") / "state.txt")
    tsnap.write_snapshot(state, emu, ["a", "b"], ["o0", "o1", "o2"])
    return dict(state=state, ej=jsnap.read_snapshot(state)[0],
                et=tsnap.read_snapshot(state, device=CPU)[0])


def test_adapters_match_jax(snap, monkeypatch):
    """multivariate_mean_fn over the snapshot's emulator and gp_mean_fn over
    one GP (fixed thetas), each through sobol_indices with JAX's draws."""
    _jax_draws(monkeypatch)
    want = jsens.sobol_indices(jsens.multivariate_mean_fn(snap["ej"]), 2,
                               jax.random.key(7), n=256, dtype=jnp.float64)
    got = tsens.sobol_indices(tsens.multivariate_mean_fn(snap["et"]), 2,
                              _gen(7), n=256, dtype=torch.float64,
                              device=CPU)
    assert got.first.shape == (2, 3)
    for a, b in zip(got, want):
        _close(a, b)

    rng = np.random.default_rng(3)
    X = rng.uniform(size=(20, 2))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2
    pj = jk.GPParams(jnp.asarray(0.2), jnp.asarray(np.log(1e-3)),
                     jnp.asarray(np.log([0.4, 0.7])))
    pt = tk.GPParams(*(torch.tensor(np.asarray(a)) for a in pj))
    fj = jsens.gp_mean_fn(pj, JData(X=jnp.asarray(X), y=jnp.asarray(y)),
                          jcfg.GPConfig(nparams=2, regression_order=1))
    ft = tsens.gp_mean_fn(pt, tgp.GPData(X=torch.tensor(X),
                                         y=torch.tensor(y)),
                          tcfg.GPConfig(nparams=2, regression_order=1))
    Xq = rng.uniform(size=(9, 2))
    _close(ft(torch.tensor(Xq)), fj(jnp.asarray(Xq)))
    want = jsens.main_effects(fj, 2, jax.random.key(8), grid=5, n=64,
                              dtype=jnp.float64)
    got = tsens.main_effects(ft, 2, _gen(8), grid=5, n=64,
                             dtype=torch.float64, device=CPU)
    _close(got[1], want[1])


def test_cli_sensitivity_matches_jax_cli(snap, tmp_path, monkeypatch,
                                         capsys):
    """`sensitivity --main_effects` on the snapshot: the Sobol table and the
    main-effects file of the port's CLI (JAX's draws injected: seed for the
    Saltelli design, seed + 1 for the base design) against the JAX CLI's,
    headers and names equal, values at RTOL."""
    _jax_draws(monkeypatch)
    monkeypatch.setenv("MADAI_COMPILE_CACHE", "off")
    outs = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        sob, eff = tmp_path / name / "sobol.txt", tmp_path / name / "me.txt"
        argv = ["sensitivity", snap["state"], "--n", "128", "--seed", "3",
                "--output", "sobol.txt", "--main_effects", "me.txt", "--grid",
                "5", "--effects_n", "32", "--query_chunk", "100"]
        if name == "torch":
            argv += ["--device", "cpu"]
        assert main(argv) == 0
        err = capsys.readouterr().err
        outs[name] = (sob.read_text().splitlines(),
                      eff.read_text().splitlines(), err)
    (sj, ej, errj), (st, et, errt) = outs["jax"], outs["torch"]
    assert errt == errj
    for a, b in ((st, sj), (et, ej)):
        assert len(a) == len(b) and a[0] == b[0]
    assert sj[0] == "# Sobol indices: param observable first total"
    assert len(sj) == 1 + 2 * 3 and len(ej) == 1 + 5
    assert ej[0].endswith("v a:o0 a:o1 a:o2 b:o0 b:o1 b:o2")
    for a, b in zip(st[1:], sj[1:]):
        assert a.split()[:2] == b.split()[:2]
        _close([float(v) for v in a.split()[2:]],
               [float(v) for v in b.split()[2:]])
    _close(np.loadtxt(et[1:]), np.loadtxt(ej[1:]))


def test_cli_sensitivity_needs_cuda_by_default(snap, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tcli.main(["sensitivity", snap["state"]]) == 2
    assert capsys.readouterr().err == "error: CUDA device not available\n"
