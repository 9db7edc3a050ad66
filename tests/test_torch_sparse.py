"""The port's sparse GP (SGPR, `madaiemulator_tpu_torch.models.sparse`)
against the JAX package's on the CPU at float64: the greedy-maximin
selector, the streamed summaries, the ELBO and its gradient in (params, Z)
(one-shot and in row chunks, with noise, gradient rows and REML), the serve
state and predict, the lock-step fit from the same starts with the Adam
refinement of the inducing points, the multivariate fit and serve, the
sparse snapshot written by each package and read by the other (text byte
for byte, .npz key for key), and the CLI's sparse paths.

Every JAX reference is one jitted program, and the JAX fit is compiled once
(`fits`): its multivariate fit runs every component through one jitted
`fit_sgpr`, the same function the port's `fit_multivariate_sparse` runs
through `fit_sgpr`.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu import cli as jcli
from madaiemulator_tpu.io import snapshot as jsnap
from madaiemulator_tpu.models import design as jdesign
from madaiemulator_tpu.models import sparse as js
from madaiemulator_tpu.models.gp import GPData as JData
from madaiemulator_tpu.ops import kernels as jk
from madaiemulator_tpu.utils import config as jcfg
from madaiemulator_tpu_torch import cli as tcli
from madaiemulator_tpu_torch.io import modelfile as tmf
from madaiemulator_tpu_torch.io import snapshot as tsnap
from madaiemulator_tpu_torch.models import design as tdesign
from madaiemulator_tpu_torch.models import fit as tfit
from madaiemulator_tpu_torch.models import multivariate as tmv
from madaiemulator_tpu_torch.models import sparse as ts
from madaiemulator_tpu_torch.models.gp import GPData as TData
from madaiemulator_tpu_torch.ops import kernels as tk
from madaiemulator_tpu_torch.utils import config as tcfg
from madaiemulator_tpu_torch.utils.designs import apply_scaling
import torch_shared  # noqa: F401

CPU = torch.device("cpu")
N, D, M, T = 40, 2, 8, 3
# values and summaries: the same float64 arithmetic up to summation order
RTOL_V = 1e-10
# gradients and fitted parameters: through autodiff of an m x m Cholesky,
# and (fits) through 3 L-BFGS steps and 3 Adam steps of the same objective
RTOL_G = 1e-8
R, STEPS, ADAM = 2, 3, 3


def _close(got, want, rtol=RTOL_V, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _problem():
    rng = np.random.default_rng(31)
    X = rng.uniform(size=(N, D))
    y = np.sin(3 * X[:, 0]) + 0.5 * X[:, 1] + 0.01 * rng.standard_normal(N)
    noise = rng.uniform(1e-4, 1e-3, size=N)
    dY = np.stack([3 * np.cos(3 * X[:, 0]), np.full(N, 0.5)], axis=1)
    dY_noise = rng.uniform(1e-3, 2e-3, size=(N, D))
    Y = np.stack([y, X[:, 0] * X[:, 1], np.cos(2 * X[:, 1])], axis=1)
    Y = Y + 0.01 * rng.standard_normal(Y.shape)
    Xq = rng.uniform(size=(9, D))
    return dict(X=X, y=y, noise=noise, dY=dY, dY_noise=dY_noise, Y=Y, Xq=Xq,
                theta=(0.2, -3.5, np.array([-1.0, -0.7])))


P = _problem()


def _params(kind):
    a, g, ls = P["theta"]
    if kind == "jax":
        return jk.GPParams(jnp.asarray(a), jnp.asarray(g), jnp.asarray(ls))
    return tk.GPParams(torch.tensor(a, dtype=torch.float64),
                       torch.tensor(g, dtype=torch.float64),
                       torch.tensor(ls))


def _data(kind, noise=False, grad=False):
    f = jnp.asarray if kind == "jax" else torch.tensor
    cls = JData if kind == "jax" else TData
    return cls(X=f(P["X"]), y=f(P["y"]),
               noise=f(P["noise"]) if noise else None,
               dY=f(P["dY"]) if grad else None,
               dY_noise=f(P["dY_noise"]) if grad else None)


def _configs(**kw):
    return (jcfg.GPConfig(nparams=D, regression_order=1, **kw),
            tcfg.GPConfig(nparams=D, regression_order=1, **kw))


def test_greedy_maximin_picks_the_same_points():
    """Uniform weights (the inducing selector) and random ones: the same
    indices in the same order, the same scores."""
    X = P["X"]
    w = np.random.default_rng(2).uniform(0.1, 1.0, size=N)
    greedy = jax.jit(jdesign._greedy_maximin, static_argnums=2)
    for weights in (np.ones(N), w):
        ij, sj = greedy(jnp.asarray(X), jnp.asarray(weights), M)
        it, st = tdesign._greedy_maximin(torch.tensor(X),
                                         torch.tensor(weights), M)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        _close(st, sj)
    # select_inducing is the uniform-weight selection's rows (as in JAX)
    Zt = ts.select_inducing(torch.tensor(X), M)
    np.testing.assert_array_equal(Zt.numpy(), X[np.asarray(greedy(
        jnp.asarray(X), jnp.ones(N), M)[0])])
    assert ts.select_inducing(torch.tensor(X), N).shape == (N, D)


CASES = {
    "plain": dict(noise=False, grad=False, reml=False),
    "noise_reml": dict(noise=True, grad=False, reml=True),
    "gradients": dict(noise=True, grad=True, reml=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_system_elbo_and_gradient_match_jax(case):
    """`_sgpr_system`'s summaries, the ELBO and its gradient in (params, Z)
    against the jitted JAX ones (one-shot), and the port's row-chunked
    route (N=40 in chunks of 16: one padded chunk) against both."""
    kw = CASES[case]
    cj, ct = _configs(reml=kw["reml"])
    dj, dt = _data("jax", kw["noise"], kw["grad"]), _data(
        "torch", kw["noise"], kw["grad"])
    Zt = ts.select_inducing(dt.X, M)

    def ref(p, Z):
        v, g = jax.value_and_grad(
            lambda p, Z: js.elbo(p, dj, cj, Z), argnums=(0, 1))(p, Z)
        return v, g, js._sgpr_system(p, dj, cj, Z)

    vj, (gpj, gZj), sysj = jax.jit(ref)(_params("jax"),
                                        jnp.asarray(Zt.numpy()))
    want_g = [*gpj, gZj]
    for rc in (None, 16):
        leaves = [t.clone().requires_grad_(True) for t in _params("torch")]
        Z = Zt.clone().requires_grad_(True)
        v = ts.elbo(tk.GPParams(*leaves), dt, ct, Z, row_chunk=rc)
        grads = torch.autograd.grad(v, leaves + [Z])
        _close(v.item(), vj)
        for g, w in zip(grads, want_g):
            _close(g, w, rtol=RTOL_G, atol=1e-10)
        with torch.no_grad():
            syst = ts._sgpr_system(_params("torch"), dt, ct, Zt, row_chunk=rc)
        assert bool(syst.ok)
        for name in ("Lm", "LB", "LA", "beta", "c", "E", "quad", "logdet",
                     "trace"):
            _close(getattr(syst, name), getattr(sysj, name), atol=1e-10)


def test_elbo_batched_lanes_and_failure():
    """A (B,) lane batch of params equals the lanes one by one; a lane
    whose K_mm cannot factor (a NaN amplitude) is -inf while the others
    stay finite."""
    _, ct = _configs()
    dt = _data("torch", noise=True)
    Z = ts.select_inducing(dt.X, M)
    a, g, ls = P["theta"]
    lanes = tk.GPParams(torch.tensor([a, a + 0.5, a]),
                        torch.tensor([g, g - 1.0, g]),
                        torch.tensor(np.stack([ls, ls + 0.3, ls])))
    batched = ts.elbo(lanes, dt, ct, Z, row_chunk=16)
    for b in range(3):
        one = ts.elbo(tk.GPParams(*(t[b] for t in lanes)), dt, ct, Z)
        _close(batched[b], one)
    bad = lanes._replace(log_amp=lanes.log_amp.index_fill(
        0, torch.tensor([1]), float("nan")))
    out = ts.elbo(bad, dt, ct, Z)
    assert out[1] == -torch.inf and bool(torch.isfinite(out[[0, 2]]).all())


def test_precompute_and_predict_match_jax():
    """sgpr_precompute + predict_sgpr (noise, nugget in the variance)."""
    cj, ct = _configs(predict_variance_includes_nugget=True)
    dj, dt = _data("jax", noise=True), _data("torch", noise=True)
    Zt = ts.select_inducing(dt.X, M)
    Xq = P["Xq"]

    def ref(p, Z, q):
        st = js.sgpr_precompute(p, dj, cj, Z, row_chunk=16)
        return st, js.predict_sgpr(st, p, cj, q)

    stj, (mj, vj) = jax.jit(ref)(_params("jax"), jnp.asarray(Zt.numpy()),
                                 jnp.asarray(Xq))
    st = ts.sgpr_precompute(_params("torch"), dt, ct, Zt, row_chunk=16)
    mt, vt = ts.predict_sgpr(st, _params("torch"), ct, torch.tensor(Xq))
    for name in ("Lm", "LB", "c", "beta", "LA", "E"):
        _close(getattr(st, name), getattr(stj, name), atol=1e-10)
    _close(mt, mj)
    _close(vt, vj, atol=1e-12)
    assert bool(st.ok) and not st.Lm.requires_grad


@pytest.fixture(scope="module")
def fits():
    """Both packages' sparse multivariate fits of one problem (r
    components, noise, backtracking L-BFGS from the same starts, then the
    Adam refinement of the inducing points), the JAX one compiled once."""
    rng = np.random.default_rng(4)
    u0 = rng.uniform(-0.8, 0.8, size=(R, 2 + D))
    u0[:, 1] = rng.uniform(0.0, 0.8, size=R)  # nuggets away from the floor
    cj, ct = _configs(n_restarts=R, max_opt_steps=STEPS,
                      linesearch="backtracking")
    kw = dict(pca_variance=0.999, inducing=M, inducing_opt_steps=ADAM)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(js, "sample_restarts", lambda *a, **k: jk.GPParams(
            jnp.asarray(u0[:, 0]), jnp.asarray(u0[:, 1]),
            jnp.asarray(u0[:, 2:])))
        mp.setattr(tfit, "sample_restarts", lambda *a, **k: tk.GPParams(
            torch.tensor(u0[:, 0]), torch.tensor(u0[:, 1]),
            torch.tensor(u0[:, 2:])))
        ej = js.fit_multivariate_sparse(
            jax.random.key(0), jnp.asarray(P["X"]), jnp.asarray(P["Y"]), cj,
            noise=jnp.asarray(P["noise"]), **kw)
        et = ts.fit_multivariate_sparse(
            torch.Generator().manual_seed(0), torch.tensor(P["X"]),
            torch.tensor(P["Y"]), ct, noise=torch.tensor(P["noise"]), **kw)
        # the port's fit_sgpr alone on component 0, without the refinement
        # (the multivariate fit above refines every component)
        Xs = apply_scaling(torch.tensor(P["X"]), et.scaling)
        one = ts.fit_sgpr(torch.Generator(), TData(
            X=Xs, y=_scores(et)[:, 0],
            noise=tmv.project_noise(torch.tensor(P["noise"]), et.pca)[:, 0]),
            ct, inducing=M, row_chunk=16)
    return {"jax": ej, "torch": et, "one": one, "Xs": Xs}


def _scores(emu):
    return tmv.project_scores(torch.tensor(P["Y"]), emu.pca)


def test_fit_multivariate_sparse_matches_jax(fits):
    """The fitted hyperparameters, inducing points (after 3 Adam steps, as
    optax.adam moves them) and serve states of every component."""
    ej, et = fits["jax"], fits["torch"]
    assert ts.is_sparse(et) and not ts.is_sparse(fits["one"])
    assert et.n_components == ej.n_components == 3
    assert et.n_outputs == T
    for a, b in (*zip(et.pca, ej.pca), *zip(et.scaling, ej.scaling)):
        _close(a, b, rtol=1e-12)
    _close(et.Z, ej.Z)  # the shared selection (each component refines its own)
    for a, b in zip(et.params, ej.params):
        _close(a, b, rtol=RTOL_G, atol=1e-10)
    for name in ("Z", "Lm", "LB", "c", "beta", "LA", "E"):
        _close(getattr(et.states, name), getattr(ej.states, name),
               rtol=RTOL_G, atol=1e-9)
    assert bool(et.states.ok.all())
    one = fits["one"]
    assert one.restart_elbos.shape == (R,) and one.stats["n_vg_calls"] > 0
    assert float(one.elbo) == float(one.restart_elbos.max())


def test_predict_multivariate_sparse_matches_jax(fits):
    ej, et = fits["jax"], fits["torch"]
    mj, vj = jax.jit(lambda q: js.predict_multivariate_sparse(ej, q))(
        jnp.asarray(P["Xq"]))
    mt, vt = ts.predict_multivariate_sparse(et, P["Xq"])
    assert mt.shape == vt.shape == (9, T)
    _close(mt, mj, rtol=RTOL_G, atol=1e-10)
    _close(vt, vj, rtol=RTOL_G, atol=1e-12)


def test_fit_sgpr_host_and_restart_chunk(fits):
    """fit_sgpr_host runs fit_gp_host on the ELBO; restart_chunk=1 runs the
    lanes one group at a time with the same result as one batch."""
    _, ct = _configs(n_restarts=R, max_opt_steps=STEPS,
                     linesearch="backtracking")
    Xs, one = fits["Xs"], fits["one"]
    data = TData(X=Xs, y=_scores(fits["torch"])[:, 0])
    u0 = np.random.default_rng(5).uniform(-0.5, 0.5, size=(R, 2 + D))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfit, "sample_restarts", lambda *a, **k: tk.GPParams(
            torch.tensor(u0[:, 0]), torch.tensor(u0[:, 1]),
            torch.tensor(u0[:, 2:])))
        a = ts.fit_sgpr(torch.Generator(), data, ct, inducing=one.Z)
        b = ts.fit_sgpr(torch.Generator(), data, ct, inducing=one.Z,
                        restart_chunk=1)
        h = ts.fit_sgpr_host(torch.Generator(), data, ct, inducing=M,
                             row_chunk=16, vg_batch=1)
    _close(b.restart_elbos, a.restart_elbos)
    for x, y in zip(b.params, a.params):
        _close(x, y)
    assert h.stats["n_vg_calls"] > 0 and bool(h.state.ok)
    _close(h.elbo, ts.elbo(h.params, data, ct, h.Z).detach())
    starts = tfit._u_to_params(tfit._unflatten(torch.tensor(u0)),
                               *tfit._bounds_arrays(ct, torch.float64))
    assert float(h.elbo) >= float(ts.elbo(starts, data, ct, h.Z).max())


# --- snapshots: both packages, both encodings ------------------------------


def test_sparse_snapshots_cross_read(fits, tmp_path):
    """The JAX-fitted emulator written by the JAX package, read by the port
    and written again: the same bytes (text), the same keys, dtypes and
    values (.npz); the port's own emulator, written by the port, read by
    the JAX package as the same container (text: the %.17g round trip)."""
    ej, et = fits["jax"], fits["torch"]
    names = (["a", "b"], ["o0", "o1", "o2"])
    jtxt, ttxt = tmp_path / "j.txt", tmp_path / "t.txt"
    jsnap.write_snapshot_sparse(str(jtxt), ej, *names)
    e1, pn, on = tsnap.read_snapshot_auto(str(jtxt), device=CPU)
    assert ts.is_sparse(e1) and (pn, on) == names
    tsnap.write_snapshot_auto(str(ttxt), e1, pn, on)
    assert ttxt.read_bytes() == jtxt.read_bytes()
    jnpz, tnpz = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jsnap.write_snapshot_sparse_npz(jnpz, ej, *names)
    e1, pn, on = tsnap.read_snapshot_auto(jnpz, device=CPU)
    tsnap.write_snapshot_auto(tnpz, e1, pn, on)
    with np.load(jnpz) as a, np.load(tnpz) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # the port's own fit, written by the port, read by the JAX package: the
    # same container (whose serve was held to JAX's above)
    tsnap.write_snapshot_sparse(str(ttxt), et, *names)
    tsnap.write_snapshot_sparse_npz(tnpz, et, *names)
    for path in (str(ttxt), tnpz):
        ej2, pn, on = jsnap.read_snapshot_auto(path)
        assert (pn, on) == names
        # the grammar stores the shared Z only (each component's own
        # refined Z in states.Z is not persisted, as in the JAX package)
        _close(ej2.states.Z, et.Z.expand(3, M, D), rtol=0, atol=0)
        for a, b in ((et.Z, ej2.Z), *zip(et.params, ej2.params),
                     *zip(et.pca, ej2.pca), *zip(et.scaling, ej2.scaling),
                     *zip(et.states[1:], ej2.states[1:])):
            _close(a, b, rtol=1e-14, atol=1e-15)
    with pytest.raises(ValueError, match="sparse"):
        tsnap.read_snapshot(str(ttxt), device=CPU)
    with pytest.raises(ValueError, match="sparse"):
        tsnap.read_snapshot_npz(tnpz, device=CPU)


def test_sparse_snapshot_refuses_failed_factorizations(fits, tmp_path):
    et = fits["torch"]
    bad = et._replace(states=et.states._replace(
        ok=torch.tensor([True, False, True])))
    for path in ("s.txt", "s.npz"):
        with pytest.raises(ValueError, match=r"component\(s\) \[1\]"):
            tsnap.write_snapshot_auto(str(tmp_path / path), bad)
        assert not (tmp_path / path).exists()


# --- the CLI ----------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """estimate_thetas --inducing through the port's CLI on a model file."""
    tmp = tmp_path_factory.mktemp("sparse_cli")
    model = str(tmp / "model.txt")
    tmf.write_model_file(model, P["X"], P["Y"])
    state = str(tmp / "state.txt")
    rc = tcli.main(["estimate_thetas", model, state, "--inducing", str(M),
                    "--restarts", "2", "--steps", "3", "--regression_order",
                    "1", "--row_chunk", "16", "--inducing_opt_steps", "2",
                    "--device", "cpu", "--quiet"])
    return rc, tmp, model, state


def test_cli_estimate_serve_print_convert(cli_run, capsys, monkeypatch):
    """The sparse snapshot the port's CLI wrote: print_thetas and convert
    print and write what the JAX CLI does on it; interactive_mode answers
    what the in-process predict does."""
    rc, tmp, _, state = cli_run
    assert rc == 0
    assert pathlib.Path(state).read_text().startswith(tsnap.MAGIC_SGPR)
    monkeypatch.setenv("MADAI_COMPILE_CACHE", "off")
    out = []
    for main in (jcli.main, tcli.main):
        capsys.readouterr()
        assert main(["print_thetas", state]) == 0
        out.append(capsys.readouterr().out)
    assert out[0] == out[1] and out[0].startswith("# 3 component(s)")
    conv = []
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        dest = str(tmp / f"conv_{name}.npz")
        assert main(["convert", state, dest]) == 0
        back = str(tmp / f"back_{name}.txt")
        assert main(["convert", dest, back]) == 0
        conv.append(pathlib.Path(back).read_bytes())
        err = capsys.readouterr().err
        assert "sparse (SGPR), 3 component(s), m=8 inducing" in err
    assert conv[0] == conv[1] == pathlib.Path(state).read_bytes()
    emu, _, _ = tsnap.read_snapshot_auto(state, device=CPU)
    mean, var = ts.predict_multivariate_sparse(emu, P["Xq"])
    stdin = "\n".join(" ".join(f"{v:.17g}" for v in q) for q in P["Xq"])
    served = _serve(monkeypatch, capsys, stdin + "\n", [state])
    want = np.concatenate([mean.numpy(), var.numpy()], axis=1)
    np.testing.assert_array_equal(served, want)


class _Stdin:
    def __init__(self, fd):
        self._fd = fd

    def fileno(self):
        return self._fd


def _serve(monkeypatch, capsys, text, argv):
    import os

    r, w = os.pipe()
    os.write(w, text.encode())
    os.close(w)
    monkeypatch.setattr(sys, "stdin", _Stdin(r))
    try:
        capsys.readouterr()
        assert tcli.main(["interactive_mode"] + argv + ["--device",
                                                        "cpu"]) == 0
    finally:
        os.close(r)
    lines = capsys.readouterr().out.splitlines()
    head = 1 + D + 1 + 2 * T
    return np.asarray(lines[head:], float).reshape(-1, 2 * T)


@pytest.mark.parametrize("what", ["iterative", "alpha_grid", "fast_serve",
                                  "iterative_serve"])
def test_cli_sparse_exits_with_the_jax_line(what, cli_run, capsys,
                                            monkeypatch, tmp_path):
    """What the sparse path excludes exits 2 with the JAX CLI's line."""
    _, _, model, state = cli_run
    monkeypatch.chdir(tmp_path)
    if what.endswith("serve"):
        method = "fast" if what == "fast_serve" else "iterative"
        lines = []
        for main in (tcli.main, jcli.main):
            monkeypatch.setattr(sys, "stdin", _Stdin(0))
            argv = ["interactive_mode", state, "--serve_method", method]
            assert main(argv + (["--device", "cpu"]
                                if main is tcli.main else [])) == 2
            lines.append(capsys.readouterr().err.splitlines())
        assert lines[0] == lines[1] and len(lines[0]) == 1
        return
    extra = (["--fit_method", "iterative"] if what == "iterative"
             else ["--alpha_grid", "1.5,2.0"])
    argv = ["estimate_thetas", model, "s.txt", "--inducing", "4"] + extra
    assert tcli.main(argv + ["--device", "cpu"]) == 2
    err = capsys.readouterr().err.splitlines()
    assert err == ["error: --inducing (sparse SGPR) excludes "
                   "--fit_method=iterative and --alpha_grid "
                   "(models/sparse.py)"]
    assert not (tmp_path / "s.txt").exists()
