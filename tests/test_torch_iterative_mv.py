"""The port's matrix-free multivariate emulator against the JAX package's on
the CPU at float64: `fit_multivariate_iterative` from the same starts,
`predict_multivariate_iterative` (cached states and one-shot), the
iterative emulator's snapshot written by each package and served
iteratively by the other (text byte for byte, .npz key for key), the CLI's
`estimate_thetas --fit_method=iterative` and `interactive_mode
--serve_method=iterative`, and the iterative exits.

Both fits run in exact-probe mode (probes = rank = lanczos_iters = N), so
their objectives are the same function; the restarts are fixed by replacing
each package's `sample_restarts`.
"""

import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu import cli as jcli
from madaiemulator_tpu.io import snapshot as jsnap
from madaiemulator_tpu.models import fit as jfit
from madaiemulator_tpu.models import multivariate as jmv
from madaiemulator_tpu.ops import kernels as jk
from madaiemulator_tpu.utils import config as jcfg
from madaiemulator_tpu_torch import cli as tcli
from madaiemulator_tpu_torch.io import modelfile as tmf
from madaiemulator_tpu_torch.io import snapshot as tsnap
from madaiemulator_tpu_torch.models import fit as tfit
from madaiemulator_tpu_torch.models import multivariate as tmv
from madaiemulator_tpu_torch.ops import kernels as tk
from madaiemulator_tpu_torch.utils import config as tcfg
import torch_shared  # noqa: F401

CPU = torch.device("cpu")
N, D, T, R, STEPS = 24, 2, 3, 2, 2
# the same objective in both packages at float64: the fitted thetas agree to
# the rounding of the likelihood gradients carried through 2 LBFGS steps
FIT_RTOL = 1e-7
RTOL_V = 1e-8  # served means and variances, and the fit's LMLs
EXACT = dict(rank=N, probes=N, lanczos_iters=N, cg_tol=1e-12,
             cg_max_iters=300, seed=0)


def _data():
    rng = np.random.default_rng(20)
    X = rng.uniform(0.0, 2.0, size=(N, D))
    lat = np.stack([np.sin(2.0 * X[:, 0]), X[:, 1] ** 2], axis=1)
    Y = lat @ rng.standard_normal((2, T)) + 0.02 * rng.standard_normal((N, T))
    noise = rng.uniform(1e-4, 4e-4, size=N)
    u0 = rng.uniform(-1.5, 1.5, size=(R, 2 + D))
    Xs = rng.uniform(0.0, 2.0, size=(7, D))
    return X, Y, noise, u0, Xs


def _close(got, want, rtol=RTOL_V, atol=1e-13):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def fits():
    """Both packages' iterative fits of one problem (r = 2 components, one
    noise variance per point) from the same starts."""
    X, Y, noise, u0, Xs = _data()
    cj = jcfg.GPConfig(nparams=D, regression_order=1, n_restarts=R,
                       max_opt_steps=STEPS)
    ct = tcfg.GPConfig(nparams=D, regression_order=1, n_restarts=R,
                       max_opt_steps=STEPS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfit, "sample_restarts", lambda *a, **k: jk.GPParams(
            jnp.asarray(u0[:, 0]), jnp.asarray(u0[:, 1]),
            jnp.asarray(u0[:, 2:])))
        mp.setattr(tfit, "sample_restarts", lambda *a, **k: tk.GPParams(
            torch.tensor(u0[:, 0]), torch.tensor(u0[:, 1]),
            torch.tensor(u0[:, 2:])))
        ej = jmv.fit_multivariate_iterative(
            jax.random.key(0), jnp.asarray(X), jnp.asarray(Y), cj,
            noise=jnp.asarray(noise), value_linesearch=False, **EXACT)
        et = tmv.fit_multivariate_iterative(
            torch.Generator().manual_seed(0), torch.tensor(X),
            torch.tensor(Y), ct, noise=torch.tensor(noise),
            value_linesearch=False, **EXACT)
    return {"jax": ej, "torch": et, "Xs": Xs, "X": X, "Y": Y}


def test_fit_multivariate_iterative_matches_jax(fits):
    ej, et = fits["jax"], fits["torch"]
    assert isinstance(et, tmv.IterativeMultivariateEmulator)
    assert et.n_components == ej.n_components == 2
    for a, b in ((et.X, ej.X), (et.Z, ej.Z), (et.noise, ej.noise),
                 *zip(et.pca, ej.pca), *zip(et.scaling, ej.scaling)):
        _close(a, b, rtol=1e-12)
    _close(et.restart_log_likelihoods, ej.restart_log_likelihoods)
    for a, b in zip(et.params, ej.params):
        _close(a, b, rtol=FIT_RTOL, atol=1e-9)
    assert bool(torch.isfinite(et.restart_log_likelihoods).all())


def _jax_serve(emu, Xs, **kw):
    """The JAX package's cached-state serve of Xs, as one jitted program
    (the emulator a constant of it)."""
    def serve(q):
        states = jmv.precompute_iterative_multivariate(emu, rank=N,
                                                       cg_tol=1e-12,
                                                       cg_max_iters=300)
        return jmv.predict_multivariate_iterative(emu, q, states=states, **kw)

    return jax.jit(serve)(jnp.asarray(Xs))


@pytest.mark.parametrize("method", ["exact", "precond"])
def test_predict_multivariate_iterative_matches_jax(fits, method):
    """The same (JAX-fitted) emulator served by both packages from cached
    states, and by the port's one-shot path."""
    ej, Xs = fits["jax"], fits["Xs"]
    et = tmv.emulator_from_numpy(_arrays(ej), tcfg.GPConfig(
        nparams=D, regression_order=1), device=CPU, build_states=False)
    mj, vj = _jax_serve(ej, Xs, variance_method=method, query_chunk=3)
    states = tmv.precompute_iterative_multivariate(et, rank=N, cg_tol=1e-12,
                                                   cg_max_iters=300)
    mt, vt = tmv.predict_multivariate_iterative(
        et, Xs, states=states, variance_method=method, query_chunk=3)
    assert mt.shape == (7, T) and vt.shape == (7, T)
    _close(mt, mj)
    _close(vt, vj)
    m1, v1 = tmv.predict_multivariate_iterative(
        et, Xs, rank=N, cg_tol=1e-12, cg_max_iters=300,
        variance_method=method)
    _close(m1, mt, rtol=1e-12)
    # another query_chunk: the variance cancels against a prior variance of
    # ~1, so its rounding is held at that scale
    _close(v1, vt, rtol=1e-10, atol=1e-12)


def _arrays(emu_j) -> dict:
    """The leaves of a JAX iterative emulator as `emulator_from_numpy`
    takes them."""
    s, p, prm = emu_j.scaling, emu_j.pca, emu_j.params
    return {k: np.asarray(v) for k, v in dict(
        mins=s.mins, ranges=s.ranges, ymean=p.ymean, ystd=p.ystd,
        eigenvalues=p.eigenvalues, U=p.U, X=emu_j.X, Z=emu_j.Z,
        log_amp=prm.log_amp, log_nugget=prm.log_nugget, log_ls=prm.log_ls,
        noise=emu_j.noise).items()}


@pytest.fixture(scope="module")
def snapshots(fits, tmp_path_factory):
    """The JAX-fitted emulator written by the JAX writer; that text read by
    each package as an iterative emulator and written again by each, text
    and .npz."""
    tmp = tmp_path_factory.mktemp("iter_snap")
    names = (["alpha", "beta"], ["o1", "o2", "o3"])
    paths = {k: str(tmp / k) for k in ("jax.txt", "jax.npz", "torch.txt",
                                       "torch.npz")}
    jsnap.write_snapshot(paths["jax.txt"], fits["jax"], *names)
    ej, _, _ = jsnap.read_snapshot(paths["jax.txt"], build_states=False)
    jsnap.write_snapshot_npz(paths["jax.npz"], ej, *names)
    emu, pn, on = tsnap.read_snapshot(paths["jax.txt"], device=CPU,
                                      build_states=False)
    assert (pn, on) == tuple(names)
    tsnap.write_snapshot(paths["torch.txt"], emu, pn, on)
    tsnap.write_snapshot_npz(paths["torch.npz"], emu, pn, on)
    return paths, emu


def test_iterative_snapshot_same_bytes_and_keys(snapshots):
    paths, emu = snapshots
    assert isinstance(emu, tmv.IterativeMultivariateEmulator)
    text = pathlib.Path(paths["torch.txt"]).read_bytes()
    assert text == pathlib.Path(paths["jax.txt"]).read_bytes()
    assert text.startswith(b"MADAIEMULATOR_TPU_SNAPSHOT 2\n")  # noise block
    with np.load(paths["jax.npz"]) as zj, np.load(paths["torch.npz"]) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype, k
            np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    # the .npz reads back as the same emulator
    back, _, _ = tsnap.read_snapshot_auto(paths["jax.npz"], device=CPU,
                                          build_states=False)
    for a, b in zip(back, emu):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)


def test_iterative_snapshot_served_by_the_other_package(snapshots, fits):
    """The port serves the JAX-written snapshot iteratively, the JAX package
    the port-written one: the same answers."""
    paths, _ = snapshots
    Xs = fits["Xs"]
    et, _, _ = tsnap.read_snapshot_auto(paths["jax.npz"], device=CPU,
                                        build_states=False)
    ej, _, _ = jsnap.read_snapshot_auto(paths["torch.txt"],
                                        build_states=False)
    assert isinstance(ej, jmv.IterativeMultivariateEmulator)
    states = tmv.precompute_iterative_multivariate(et, rank=N, cg_tol=1e-12,
                                                   cg_max_iters=300)
    mt, vt = tmv.predict_multivariate_iterative(et, Xs, states=states)
    mj, vj = _jax_serve(ej, Xs)
    _close(mt, mj)
    _close(vt, vj)


def test_gradient_snapshot_refuses_the_matrix_free_container():
    """A version-3 (gradient) state has no matrix-free form: both packages'
    stateless assembly raise the same ValueError."""
    rng = np.random.default_rng(21)
    n, r = 6, 1
    arrays = {"mins": np.zeros(D), "ranges": np.ones(D), "ymean": np.zeros(1),
              "ystd": np.ones(1), "eigenvalues": np.ones(r),
              "U": np.ones((1, r)), "X": rng.uniform(size=(n, D)),
              "Z": rng.standard_normal((n, r)), "log_amp": np.zeros(r),
              "log_nugget": np.full(r, -5.0), "log_ls": np.zeros((r, D)),
              "dZ": rng.standard_normal((n, D, r))}
    with pytest.raises(ValueError) as et:
        tmv.emulator_from_numpy(arrays, tcfg.GPConfig(nparams=D), device=CPU,
                                build_states=False)
    j = {k: jnp.asarray(v) for k, v in arrays.items()}
    with pytest.raises(ValueError) as ej:
        jsnap._assemble_multivariate(
            (j["mins"], j["ranges"]), j["X"], j["Z"],
            (j["ymean"], j["ystd"], j["eigenvalues"], j["U"]),
            jk.GPParams(j["log_amp"], j["log_nugget"], j["log_ls"]),
            jcfg.GPConfig(nparams=D), None, j["dZ"], None, False)
    assert str(et.value) == str(ej.value)


class _Stdin:
    def __init__(self, fd):
        self._fd = fd

    def fileno(self):
        return self._fd


def _serve(monkeypatch, capsys, text, argv):
    r, w = os.pipe()
    os.write(w, text.encode())
    os.close(w)
    monkeypatch.setattr(sys, "stdin", _Stdin(r))
    try:
        rc = tcli.main(["interactive_mode"] + argv)
    finally:
        os.close(r)
    return rc, capsys.readouterr()


def _model(tmp, fits):
    model = str(tmp / "model.txt")
    tmf.write_model_file(model, fits["X"], fits["Y"])
    return model


def test_cli_iterative_fit_and_serve(fits, tmp_path, monkeypatch, capsys):
    """estimate_thetas --fit_method=iterative writes the snapshot of the
    in-process fit with the same flags; interactive_mode
    --serve_method=iterative answers as predict_multivariate_iterative from
    states built with the same flags."""
    model = _model(tmp_path, fits)
    state = str(tmp_path / "state.txt")
    rc = tcli.main(["estimate_thetas", model, state, "--device", "cpu",
                    "--fit_method", "iterative", "--regression_order", "1",
                    "--restarts", "2", "--steps", "2", "--rank", str(N),
                    "--probes", str(N), "--lanczos_iters", str(N),
                    "--cg_tol", "1e-12", "--cg_max_iters", "300",
                    "--logdet_method", "mbcg", "--seed", "3", "--quiet"])
    cap = capsys.readouterr()
    assert rc == 0, cap.err
    emu, _, _ = tsnap.read_snapshot(state, device=CPU, build_states=False)
    want = tmv.fit_multivariate_iterative(
        torch.Generator().manual_seed(3), torch.tensor(fits["X"]),
        torch.tensor(fits["Y"]),
        tcfg.GPConfig(nparams=D, regression_order=1, n_restarts=2,
                      max_opt_steps=2),
        logdet_method="mbcg", vg_batch=1, **dict(EXACT, seed=3))
    for a, b in zip(emu.params, want.params):
        _close(a, b, rtol=1e-15)

    Xs = fits["Xs"]
    stdin = "\n".join(" ".join(f"{v:.17g}" for v in p) for p in Xs) + "\n"
    for method in ("exact", "precond"):
        rc, cap = _serve(monkeypatch, capsys, stdin, [
            state, "--device", "cpu", "--serve_method", "iterative",
            "--variance_method", method, "--query_chunk", "4",
            "--variance_rhs", "2"])
        assert rc == 0, cap.err
        vals = np.asarray(cap.out.splitlines()[1 + D + 1 + 2 * T:],
                          float).reshape(len(Xs), 2 * T)
        states = tmv.precompute_iterative_multivariate(emu)
        m, v = tmv.predict_multivariate_iterative(
            emu, Xs, states=states, variance_method=method)
        _close(vals[:, :T], m.numpy(), rtol=1e-12)
        _close(vals[:, T:], v.numpy(), rtol=1e-9, atol=1e-15)


def _v3_state(tmp) -> str:
    """A version-3 (gradient-enhanced) snapshot, written by the port."""
    rng = np.random.default_rng(22)
    n, r = 6, 1
    t = lambda a: torch.tensor(a)  # noqa: E731
    emu = tmv.MultivariateEmulator(
        scaling=tmv.DesignScaling(t(np.zeros(D)), t(np.ones(D))),
        X=t(rng.uniform(size=(n, D))), Z=t(rng.standard_normal((n, r))),
        pca=tmv.PCAState(t(np.zeros(1)), t(np.full(1, 2.0)), t(np.ones(r)),
                         t(np.ones((1, r)))),
        params=tk.GPParams(t(np.zeros(r)), t(np.full(r, -5.0)),
                           t(np.zeros((r, D)))),
        states=None, config=tcfg.GPConfig(nparams=D),
        dZ=t(rng.standard_normal((n, D, r))))
    path = str(tmp / "v3.txt")
    tsnap.write_snapshot(path, emu)
    return path


EXITS = {
    # the sparse tuning flags: honoured by --inducing, ignored without it
    # (the JAX CLI's rule), so these two commands now run
    "row_chunk": ["--fit_method", "iterative", "--row_chunk", "8"],
    "inducing_opt_steps": ["--inducing_opt_steps", "5"],
    "iterative_gradients_file": ["--fit_method", "iterative",
                                 "--gradients_file", "grads.txt"],
    "iterative_alpha_grid": ["--fit_method", "iterative",
                             "--alpha_grid", "1.5,2.0"],
    "v3_served_iteratively": None,
}


@pytest.mark.parametrize("what", sorted(EXITS))
def test_iterative_exits_2_with_one_line(what, fits, tmp_path, capsys,
                                         monkeypatch):
    """What the matrix-free route cannot take exits 2 with one error line
    and writes nothing; where the JAX CLI exits too, with its line."""
    monkeypatch.chdir(tmp_path)
    if EXITS[what] is None:
        state = _v3_state(tmp_path)
        rc, cap = _serve(monkeypatch, capsys, "0.5 0.5\n", [
            state, "--device", "cpu", "--serve_method", "iterative"])
        err = cap.err.splitlines()
        assert rc == 2 and cap.out == "" and len(err) == 1
        assert "gradient-enhanced" in err[0]
        monkeypatch.setattr(sys, "stdin", _Stdin(0))
        assert jcli.main(["interactive_mode", state, "--serve_method",
                          "iterative"]) == 2
        assert capsys.readouterr().err.splitlines() == err
        return
    model = _model(tmp_path, fits)
    np.savetxt(tmp_path / "grads.txt", np.zeros((N * T, D)))
    argv = ["estimate_thetas", model, "s.txt", "--restarts", "1", "--steps",
            "1", "--quiet"] + EXITS[what]
    if what in ("row_chunk", "inducing_opt_steps"):
        assert tcli.main(argv + ["--device", "cpu"]) == 0
        assert capsys.readouterr().err == ""
        assert (tmp_path / "s.txt").read_text().startswith(tsnap.MAGIC)
        return
    assert tcli.main(argv + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and err[0].startswith("error: "), err
    assert not (tmp_path / "s.txt").exists()
    if what == "iterative_gradients_file":
        assert jcli.main(argv) == 2
        assert capsys.readouterr().err.splitlines() == err
