"""The port's serve slice end to end on the CPU: goldens, snapshots shared
with the JAX package in both directions, `emulator_from_numpy` on a JAX
emulator, and the `interactive_mode` pipe against the JAX CLI.
"""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu.io import snapshot as jsnap
from madaiemulator_tpu.models import multivariate as jmv
from madaiemulator_tpu_torch import cli as tcli
from madaiemulator_tpu_torch.io import snapshot as tsnap
from madaiemulator_tpu_torch.models import multivariate as tmv
from madaiemulator_tpu_torch.utils import config as tcfg
from torch_mf_fixture import mf_emulator
import torch_shared  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
CASES = sorted(p.name for p in GOLDEN.iterdir() if p.is_dir())
MV = str(GOLDEN / "multivar_pca" / "state.txt")
CPU = torch.device("cpu")


@pytest.mark.parametrize("case", CASES)
def test_goldens_through_port_f64(case):
    d = GOLDEN / case
    q = np.loadtxt(d / "queries.txt", ndmin=2)
    e = np.loadtxt(d / "expected.txt", ndmin=2)
    emu, _, _ = tsnap.read_snapshot(str(d / "state.txt"), device=CPU)
    t = emu.n_outputs
    mean, var = tmv.predict_multivariate(emu, q)
    assert mean.dtype == torch.float64
    scale = max(1.0, float(np.abs(e[:, :t]).max()))
    np.testing.assert_allclose(mean.numpy(), e[:, :t], rtol=1e-6,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(var.numpy(), e[:, t:], rtol=1e-6, atol=1e-12)


def _queries(emu_j, m, seed):
    lo = np.asarray(emu_j.scaling.mins)
    span = np.asarray(emu_j.scaling.ranges)
    return lo + span * np.random.default_rng(seed).uniform(size=(m, lo.size))


def _predict_both(emu_t, emu_j, q):
    mt, vt = tmv.predict_multivariate(emu_t, q)
    mj, vj = jmv.predict_multivariate(emu_j, jnp.asarray(q))
    return (mt.numpy(), vt.numpy()), (np.asarray(mj), np.asarray(vj))


def _prior_var(emu_t):
    """Largest observable prior variance of a port emulator."""
    p = emu_t.params
    kss = (torch.exp(p.log_amp) + torch.exp(p.log_nugget))[:, None]
    return tmv.reconstruct_observables(torch.zeros_like(kss), kss,
                                       emu_t.pca)[1].max().item()


def _assert_same(a, b, emu_t, rtol=1e-8):
    """(mean, var) pairs from two float64 implementations. The goldens sit
    at nugget ~1e-9 (condition ~1e10), so two correct float64 programs
    differ by ~1e-9 of the mean scale; variances cancel against the prior
    variance and are compared at that scale."""
    (ma, va), (mb, vb) = a, b
    np.testing.assert_allclose(ma, mb, rtol=rtol, atol=rtol * np.abs(mb).max())
    np.testing.assert_allclose(va, vb, rtol=rtol, atol=rtol * _prior_var(emu_t))


def test_snapshot_cross_reads_both_ways(tmp_path):
    """JAX writes / the port reads, the port writes / JAX reads: equal
    predictions, and both writers emit the same bytes."""
    emu_j, pn, on = jsnap.read_snapshot(MV)
    jpath, tpath = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jsnap.write_snapshot(jpath, emu_j, pn, on)
    emu_t, pn_t, on_t = tsnap.read_snapshot(jpath, device=CPU)
    assert (pn_t, on_t) == (pn, on)
    q = _queries(emu_j, 16, 0)
    _assert_same(*_predict_both(emu_t, emu_j, q), emu_t)
    tsnap.write_snapshot(tpath, emu_t, pn_t, on_t)
    assert pathlib.Path(tpath).read_text() == pathlib.Path(jpath).read_text()
    emu_j2, _, _ = jsnap.read_snapshot(tpath)
    _assert_same(*_predict_both(emu_t, emu_j2, q), emu_t)


def test_noise_snapshot_v2_cross_reads(tmp_path):
    emu_j, pn, on = jsnap.read_snapshot(MV)
    n, r = emu_j.Z.shape
    noise = np.random.default_rng(1).uniform(1e-4, 1e-3, size=(n, r))
    path = str(tmp_path / "v2.txt")
    jsnap.write_snapshot(path, emu_j._replace(noise=jnp.asarray(noise)), pn, on)
    assert pathlib.Path(path).read_text().startswith(f"{tsnap.MAGIC} 2\n")
    emu_t, _, _ = tsnap.read_snapshot(path, device=CPU)
    emu_j2, _, _ = jsnap.read_snapshot(path)
    np.testing.assert_array_equal(emu_t.noise.numpy(), noise)
    q = _queries(emu_j, 12, 2)
    _assert_same(*_predict_both(emu_t, emu_j2, q), emu_t)
    tpath = str(tmp_path / "t2.txt")
    tsnap.write_snapshot(tpath, emu_t, pn, on)
    assert pathlib.Path(tpath).read_text() == pathlib.Path(path).read_text()


@pytest.mark.parametrize("head,what", [
    ("MADAIEMULATOR_TPU_SNAPSHOT_MF 1\n", "multi-fidelity"),
    ("MADAIEMULATOR_TPU_SNAPSHOT_SGPR 1\n", "sparse"),
])
def test_unported_snapshots_raise(tmp_path, head, what):
    """Both other grammars are read now (each case checks its own):
    read_snapshot_auto returns the sparse or the multi-fidelity emulator,
    which serves what was written, and the dense reader points to the
    grammar's own reader."""
    p = tmp_path / "s.txt"
    if what == "multi-fidelity":
        from madaiemulator_tpu_torch.models import multifidelity as tmfm

        emu = mf_emulator(multivariate=False)
        tsnap.write_snapshot_auto(str(p), emu)
        assert p.read_text().startswith(head)
        got, _, _ = tsnap.read_snapshot_auto(str(p), device=CPU)
        q = np.random.default_rng(6).uniform(1.0, 3.0, size=(4, 2))
        for a, b in zip(tmfm.predict_multifidelity(got, q),
                        tmfm.predict_multifidelity(emu, q)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)
        with pytest.raises(ValueError, match="read_snapshot_multifidelity"):
            tsnap.read_snapshot(str(p), device=CPU)
    elif what == "sparse":
        from madaiemulator_tpu_torch.models import sparse as ts

        rng = np.random.default_rng(6)
        X = rng.uniform(size=(20, 2))
        Y = np.stack([np.sin(3 * X[:, 0]), X[:, 1] ** 2], axis=1)
        emu = ts.fit_multivariate_sparse(
            torch.Generator().manual_seed(0), torch.tensor(X),
            torch.tensor(Y), tcfg.GPConfig(nparams=2, n_restarts=2,
                                           max_opt_steps=3), inducing=5)
        tsnap.write_snapshot_auto(str(p), emu)
        assert p.read_text().startswith(head)
        got, _, _ = tsnap.read_snapshot_auto(str(p), device=CPU)
        q = rng.uniform(size=(4, 2))
        for a, b in zip(ts.predict_multivariate_sparse(got, q),
                        ts.predict_multivariate_sparse(emu, q)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)
        with pytest.raises(ValueError, match="read_snapshot_sparse"):
            tsnap.read_snapshot(str(p), device=CPU)
    else:
        p.write_text(head + "covariance matern32\n")
        with pytest.raises(ValueError, match=what):
            tsnap.read_snapshot(str(p), device=CPU)
    with pytest.raises(ValueError, match="npz"):
        tsnap.read_snapshot(str(tmp_path / "s.npz"), device=CPU)


def test_emulator_from_numpy_of_jax_emulator():
    emu_j, _, _ = jsnap.read_snapshot(MV)
    arrays = {
        "mins": emu_j.scaling.mins, "ranges": emu_j.scaling.ranges,
        "X": emu_j.X, "Z": emu_j.Z, "ymean": emu_j.pca.ymean,
        "ystd": emu_j.pca.ystd, "eigenvalues": emu_j.pca.eigenvalues,
        "U": emu_j.pca.U, "log_amp": emu_j.params.log_amp,
        "log_nugget": emu_j.params.log_nugget, "log_ls": emu_j.params.log_ls,
        "noise": emu_j.noise,
    }
    arrays = {k: None if v is None else np.asarray(v) for k, v in arrays.items()}
    cj = emu_j.config
    cfg = tcfg.GPConfig(
        nparams=cj.nparams,
        covariance=tcfg.CovarianceFamily(cj.covariance.value),
        regression_order=cj.regression_order,
        power_exp_alpha=cj.power_exp_alpha,
        predict_variance_includes_nugget=cj.predict_variance_includes_nugget,
    )
    emu_t = tmv.emulator_from_numpy(arrays, cfg, device=CPU)
    assert bool(emu_t.states.ok.all())
    q = _queries(emu_j, 32, 3)
    _assert_same(*_predict_both(emu_t, emu_j, q), emu_t)


def test_pca_and_reconstruction_match_jax():
    rng = np.random.default_rng(4)
    Y = rng.standard_normal((30, 3)) @ rng.standard_normal((3, 6))
    pj, zj = jmv.pca_decompose(Y, 0.95)
    pt, zt = tmv.pca_decompose(Y, 0.95)
    np.testing.assert_allclose(zt, np.asarray(zj), rtol=1e-12, atol=1e-14)
    for a, b in zip(pt, pj):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-12, atol=1e-14)
    r = zt.shape[1]
    m = rng.standard_normal((r, 5))
    v = rng.uniform(size=(r, 5))
    pca_t = tmv.PCAState(*(torch.from_numpy(np.asarray(a)) for a in pt))
    got = tmv.reconstruct_observables(torch.from_numpy(m), torch.from_numpy(v),
                                      pca_t)
    want = jmv.reconstruct_observables(jnp.asarray(m), jnp.asarray(v), pj)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    return env


def test_cli_pipe_matches_jax_cli():
    """One port server (--device cpu) and one JAX server on the same golden
    and the same stdin (three points, then a partial one): same header,
    same values, same trailing-token warning."""
    q = np.loadtxt(GOLDEN / "multivar_pca" / "queries.txt", ndmin=2)[:3]
    stdin = "\n".join(" ".join(f"{v:.17g}" for v in p) for p in q) + "\n0.5\n"
    runs = [
        subprocess.run(
            [sys.executable, "-m", mod, "interactive_mode", MV] + extra,
            input=stdin, capture_output=True, text=True, timeout=300,
            cwd=ROOT, env=_env(),
        )
        for mod, extra in (("madaiemulator_tpu_torch.cli", ["--device", "cpu"]),
                           ("madaiemulator_tpu.cli", []))
    ]
    (port, ref) = runs
    assert port.returncode == 0 and ref.returncode == 0, port.stderr + ref.stderr
    p_lines, r_lines = port.stdout.splitlines(), ref.stdout.splitlines()
    head = 1 + 3 + 1 + 2 * 6
    assert p_lines[:head] == r_lines[:head]
    assert len(p_lines) == len(r_lines) == head + 3 * 12
    got = np.asarray(p_lines[head:], float).reshape(3, 12)
    want = np.asarray(r_lines[head:], float).reshape(3, 12)
    emu_t, _, _ = tsnap.read_snapshot(MV, device=CPU)
    _assert_same((got[:, :6], got[:, 6:]), (want[:, :6], want[:, 6:]), emu_t)
    warn = "warning: 1 trailing token(s) ignored (partial point)"
    assert warn in port.stderr and warn in ref.stderr


class _Stdin:
    def __init__(self, fd):
        self._fd = fd

    def fileno(self):
        return self._fd


def _serve_in_process(monkeypatch, capsys, text, argv):
    r, w = os.pipe()
    os.write(w, text.encode())
    os.close(w)
    monkeypatch.setattr(sys, "stdin", _Stdin(r))
    try:
        rc = tcli.main(["interactive_mode"] + argv)
    finally:
        os.close(r)
    return rc, capsys.readouterr()


def test_cli_bad_token_exits_1(monkeypatch, capsys):
    rc, out = _serve_in_process(monkeypatch, capsys, "0.1 abc 0.3\n",
                                [MV, "--device", "cpu"])
    assert rc == 1
    assert "error: bad query token" in out.err


def test_cli_float32_batch_answers(monkeypatch, capsys):
    q = np.random.default_rng(5).uniform(size=(5, 3))
    text = "\n".join(" ".join(map(str, p)) for p in q) + "\n"
    rc, out = _serve_in_process(monkeypatch, capsys, text,
                                [MV, "--device", "cpu", "--dtype", "float32"])
    assert rc == 0, out.err
    vals = np.asarray(out.out.splitlines()[1 + 3 + 1 + 12:], float)
    assert vals.shape == (5 * 12,) and np.isfinite(vals).all()


def test_cli_errors_exit_2(monkeypatch, capsys, tmp_path):
    rc, out = _serve_in_process(monkeypatch, capsys, "", [MV])  # cuda default
    if not torch.cuda.is_available():
        assert rc == 2
        assert out.err.strip() == "error: CUDA device not available"
        assert out.out == ""
    # a multi-fidelity snapshot serves dense only (as in the JAX CLI)
    mf = tmp_path / "mf.txt"
    tsnap.write_snapshot_auto(str(mf), mf_emulator(multivariate=False))
    rc, out = _serve_in_process(monkeypatch, capsys, "",
                                [str(mf), "--device", "cpu",
                                 "--serve_method", "fast"])
    assert rc == 2 and "serve dense only" in out.err


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import madaiemulator_tpu_torch.cli, madaiemulator_tpu_torch.io.snapshot\n"
        "import madaiemulator_tpu_torch.models.multivariate\n"
        "import madaiemulator_tpu_torch.models.fit\n"
        "import madaiemulator_tpu_torch.models.sparse\n"
        "import madaiemulator_tpu_torch.models.diagnostics\n"
        "import madaiemulator_tpu_torch.models.design\n"
        "import madaiemulator_tpu_torch.models.multifidelity\n"
        "import madaiemulator_tpu_torch.models.calibrate\n"
        "import madaiemulator_tpu_torch.io.experiment\n"
        "import madaiemulator_tpu_torch.parallel.ensemble\n"
        "import madaiemulator_tpu_torch.ops.hopper.build\n"
        "import madaiemulator_tpu_torch.ops.hopper.cholesky\n"
        "import madaiemulator_tpu_torch.ops.hopper.pairwise\n"
        "import madaiemulator_tpu_torch.ops.hopper.panel\n"
        "import chip_smoke\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'madaiemulator_tpu' not in sys.modules\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT, env=_env())
    assert r.returncode == 0, r.stderr
