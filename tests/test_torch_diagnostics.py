"""The port's validation diagnostics (`madaiemulator_tpu_torch.models.
diagnostics`) against the JAX package's on the CPU at float64: closed-form
LOO (and against brute-force refits), the multivariate LOO on the served
states and by refactoring, the validation summary, the posterior
covariance and joint draws (dense and matrix-free; JAX's normal draws
injected through `_normal_draws`), the matrix-free holdout (JAX's
permutation injected through `_permutation`), a sparse emulator's training
residuals, and the `validate` CLI's printed summary against the JAX CLI's
in every branch.

The emulators are built from fixed arrays (no fit): a dense one with a
noise block, served by both packages from the same text snapshot.
"""

import contextlib
import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu import cli as jcli
from madaiemulator_tpu.io import snapshot as jsnap
from madaiemulator_tpu.models import diagnostics as jdiag
from madaiemulator_tpu.models import multivariate as jmv
from madaiemulator_tpu.models.gp import GPData as JData
from madaiemulator_tpu.ops import kernels as jk
from madaiemulator_tpu.utils import config as jcfg
from madaiemulator_tpu_torch import cli as tcli
from madaiemulator_tpu_torch.io import modelfile as tmf
from madaiemulator_tpu_torch.io import snapshot as tsnap
from madaiemulator_tpu_torch.models import diagnostics as tdiag
from madaiemulator_tpu_torch.models import gp as tgp
from madaiemulator_tpu_torch.models import multivariate as tmv
from madaiemulator_tpu_torch.models import sparse as ts
from madaiemulator_tpu_torch.ops import kernels as tk
from madaiemulator_tpu_torch.utils import config as tcfg
import torch_shared  # noqa: F401

CPU = torch.device("cpu")
N, D, T, S = 24, 2, 3, 5
# LOO, covariances, summaries: the same float64 algebra up to summation
# order and two LAPACK builds
RTOL = 1e-10
# through PCG solves at cg_tol 1e-12 (the holdout, the matrix-free
# covariance) and through an eigendecomposition (the draws)
RTOL_ITER = 1e-8
# the closed form against N brute-force refits (the JAX test's tolerance)
RTOL_BRUTE = 1e-8
EXACT = dict(rank=N, cg_tol=1e-12, cg_max_iters=300)


def _close(got, want, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    """A dense multivariate emulator (r = 2 of t = 3, a noise block) as a
    text snapshot and its model file; each package reads the snapshot."""
    rng = np.random.default_rng(12)
    X = rng.uniform(1.0, 3.0, size=(N, D))
    Y = np.stack([np.sin(2 * X[:, 0]) + X[:, 1], X[:, 0] * X[:, 1],
                  np.cos(X[:, 1])], axis=1) + 0.02 * rng.standard_normal(
                      (N, T))
    pca, Z = tmv.pca_decompose(Y, 0.95)
    r = Z.shape[1]
    mins, ranges = X.min(0), X.max(0) - X.min(0)
    arrays = dict(
        mins=mins, ranges=ranges, X=(X - mins) / ranges, Z=Z,
        ymean=pca.ymean, ystd=pca.ystd, eigenvalues=pca.eigenvalues, U=pca.U,
        log_amp=np.log(np.linspace(0.8, 1.2, r)),
        log_nugget=np.log(np.linspace(2e-3, 5e-3, r)),
        log_ls=np.log(np.tile([0.4, 0.6], (r, 1))),
        noise=rng.uniform(1e-4, 5e-4, size=(N, r)))
    cfg = tcfg.GPConfig(nparams=D, regression_order=1)
    emu = tmv.emulator_from_numpy(arrays, cfg, CPU, build_states=False)
    tmp = tmp_path_factory.mktemp("diag")
    state, model = str(tmp / "state.txt"), str(tmp / "model.txt")
    tsnap.write_snapshot(state, emu, ["a", "b"], ["o0", "o1", "o2"])
    tmf.write_model_file(model, X, Y, param_names=["a", "b"],
                         output_names=["o0", "o1", "o2"])
    ej, _, _ = jsnap.read_snapshot(state)
    et, _, _ = tsnap.read_snapshot(state, device=CPU)
    it, _, _ = tsnap.read_snapshot(state, device=CPU, build_states=False)
    Xq = rng.uniform(1.0, 3.0, size=(7, D))
    return dict(tmp=tmp, state=state, model=model, ej=ej, et=et, it=it,
                Xq=Xq, Y=Y, r=r)


def test_loo_cv_matches_jax_and_bruteforce():
    """One GP at N=12: the port's closed form against the JAX package's and
    against refitting the GLS mean on each size-(N-1) subset."""
    rng = np.random.default_rng(3)
    n = 12
    X = rng.uniform(size=(n, D))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2
    pj = jk.GPParams(jnp.asarray(0.3), jnp.asarray(np.log(1e-2)),
                     jnp.full((D,), np.log(0.5)))
    pt = tk.GPParams(*(torch.tensor(np.asarray(a)) for a in pj))
    cj = jcfg.GPConfig(nparams=D, regression_order=1)
    ct = tcfg.GPConfig(nparams=D, regression_order=1)
    want = jax.jit(lambda X, y: jdiag.loo_cv(pj, JData(X=X, y=y), cj))(
        jnp.asarray(X), jnp.asarray(y))
    data = tgp.GPData(X=torch.tensor(X), y=torch.tensor(y))
    got = tdiag.loo_cv(pt, data, ct)
    assert bool(got.ok)
    for a, b in zip(got, want):
        _close(a, b)
    for i in range(n):
        keep = torch.tensor(np.arange(n) != i)
        sub = tgp.GPData(X=data.X[keep], y=data.y[keep])
        m_i, v_i = tgp.gp_posterior(pt, sub, data.X[i:i + 1], ct)
        _close(got.mean[i], m_i[0], rtol=RTOL_BRUTE, atol=1e-10)
        _close(got.variance[i], v_i[0], rtol=RTOL_BRUTE, atol=1e-10)
    assert tdiag.loo_summary(got, data.y)["n"] == n
    with pytest.raises(ValueError, match="gradient-enhanced"):
        tdiag.loo_cv(pt, data._replace(dY=data.X), ct)


@pytest.fixture(scope="module")
def jax_loo(snap):
    return jax.jit(lambda: jdiag.loo_cv_multivariate(snap["ej"]))()


@pytest.mark.parametrize("route", ["states", "refactor"])
def test_loo_cv_multivariate_matches_jax(snap, jax_loo, route):
    """On the served states (the dense emulator) and by refactoring (the
    matrix-free container has none), batched over the components."""
    emu = snap["et"] if route == "states" else snap["it"]
    res, mean, var = tdiag.loo_cv_multivariate(emu)
    rj, mj, vj = jax_loo
    assert res.mean.shape == (snap["r"], N) and mean.shape == (N, T)
    for a, b in zip(res, rj):
        _close(a, b)
    _close(mean, mj)
    _close(var, vj)
    _close(tdiag.reconstruct_training_outputs(emu),
           jdiag.reconstruct_training_outputs(snap["ej"]))
    got = tdiag.loo_summary_multivariate(emu, interval=0.9)
    want = jdiag.loo_summary_multivariate(snap["ej"], interval=0.9)
    assert got.keys() == want.keys()
    _close([got[k] for k in got], [want[k] for k in want])


def test_validation_summary_matches_jax():
    rng = np.random.default_rng(5)
    mean, y = rng.standard_normal(50), rng.standard_normal(50)
    var = rng.uniform(0.1, 2.0, size=50)
    var[3] = 0.0  # floored, finite
    for interval in (0.5, 0.95, 0.999):
        got = tdiag.validation_summary(torch.tensor(mean), var, y, interval)
        want = jdiag.validation_summary(mean, var, y, interval)
        assert got.keys() == want.keys()
        _close([got[k] for k in got], [want[k] for k in want], rtol=1e-14)
        assert np.isfinite(got["log_pseudo_likelihood"])
    for p in (1e-4, 0.01, 0.3, 0.5, 0.975, 0.9999):
        assert tdiag._norm_ppf(p) == jdiag._norm_ppf(p)
    with pytest.raises(ValueError):
        tdiag._norm_ppf(1.0)


def _inject_normals(monkeypatch, key, r, cov):
    """`_normal_draws` replaced by JAX's draws: jax.random.normal of each
    component's key from split(key, r), as the JAX samplers draw them,
    each column flipped where torch's eigenvector of `cov` (r, m, m) has
    the other sign than jnp.linalg.eigh's (the two LAPACK builds choose
    different signs; the draw z_k U_k is the same)."""
    _, Ut = torch.linalg.eigh(torch.as_tensor(np.asarray(cov)))
    _, Uj = jnp.linalg.eigh(jnp.asarray(np.asarray(cov)))
    flip = np.sign((Ut.numpy() * np.asarray(Uj)).sum(-2))  # (r, m)

    def draws(generator, shape, dtype, device):
        z = np.stack([np.asarray(jax.random.normal(k, shape[1:]))
                      for k in jax.random.split(key, r)])
        return torch.tensor(z * flip[:, None, :], dtype=dtype, device=device)

    monkeypatch.setattr(tdiag, "_normal_draws", draws)


def test_posterior_covariance_and_draws_match_jax(snap, monkeypatch):
    """The full covariance per component (its diagonal = the served
    variance) and the joint observable-space draws with JAX's normals."""
    ej, et, Xq = snap["ej"], snap["et"], snap["Xq"]
    Xs = tmv._scaled_queries(et, Xq)
    Xsj = jnp.asarray(Xs.numpy())

    def ref():
        one = lambda st, p, z: jdiag.posterior_covariance(  # noqa: E731
            st, p, JData(X=ej.X, y=z), Xsj, ej.config)
        mc = jax.vmap(one)(ej.states, ej.params, ej.Z.T)
        return mc, jdiag.sample_multivariate_posterior(
            ej, jnp.asarray(Xq), jax.random.key(7), S)

    (mj, cj), dj = jax.jit(ref)()
    mt, ct = tdiag.posterior_covariance(et.states, et.params,
                                        tgp.GPData(X=et.X, y=et.Z.mT), Xs,
                                        et.config)
    _close(mt, mj)
    _close(ct, cj)
    _, v_pc = tmv._predict_components(et.states, et.params, et.X, et.Z, Xs,
                                      et.config)
    _close(torch.diagonal(ct, dim1=-2, dim2=-1), v_pc)
    _inject_normals(monkeypatch, jax.random.key(7), snap["r"], ct)
    draws = tdiag.sample_multivariate_posterior(et, Xq, torch.Generator(), S)
    assert draws.shape == (S, Xq.shape[0], T)
    _close(draws, dj, rtol=RTOL_ITER, atol=1e-10)
    # a failed state's covariance is NaN, not a confident wrong matrix
    ok = torch.ones(snap["r"], dtype=torch.bool)
    ok[1] = False
    bad = et.states._replace(ok=ok)
    _, cb = tdiag.posterior_covariance(bad, et.params,
                                       tgp.GPData(X=et.X, y=et.Z.mT), Xs,
                                       et.config)
    assert bool(torch.isnan(cb[1]).all()) and bool(torch.isfinite(cb[0]).all())


def _inject_permutation(monkeypatch, seed):
    monkeypatch.setattr(tdiag, "_permutation", lambda generator, n: np.asarray(
        jax.random.permutation(jax.random.key(seed), n)))


BRANCHES = {
    "loo": [],
    "model_file": ["--model_file", "MODEL", "--interval", "0.9"],
    "output": ["--output", "TABLE"],
    "holdout": ["--holdout", "6", "--matrix_free", "--rank", str(N),
                "--cg_tol", "1e-12", "--cg_max_iters", "300", "--output",
                "TABLE"],
    "sparse": ["--model_file", "MODEL", "--output", "TABLE"],
}


def _validate(main, branch, snap, sparse_snap, table):
    """One `validate` run of a CLI: (stdout, the --output table's lines)."""
    state = sparse_snap if branch == "sparse" else snap["state"]
    argv = ["validate", state] + [
        {"MODEL": snap["model"], "TABLE": table}.get(a, a)
        for a in BRANCHES[branch]]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv + (["--device", "cpu"] if main is tcli.main else []))
    assert rc == 0
    lines = (pathlib.Path(table).read_text().splitlines()
             if "TABLE" in BRANCHES[branch] else None)
    return out.getvalue(), lines


@pytest.fixture(scope="module")
def jax_runs(snap, sparse_snap, tmp_path_factory):
    """The JAX CLI's `validate` in every branch, once (its holdout with the
    permutation of key(0)): {branch: (stdout, table lines)}. Its tables
    are also the references of the library holdout and the sparse
    training residuals (they print the held-out / training-point means and
    variances, "%.17g")."""
    tmp = tmp_path_factory.mktemp("jax_validate")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MADAI_COMPILE_CACHE", "off")
        return {b: _validate(jcli.main, b, snap, sparse_snap,
                             str(tmp / f"{b}.txt")) for b in BRANCHES}


def _table(lines, t=T):
    """(mean (M, t), variance (M, t), truth (M, t)) of a validate table."""
    a = np.loadtxt(lines[1:], ndmin=2)
    return a[:, :t], a[:, t:2 * t], a[:, 2 * t:]


def test_holdout_cv_matches_jax(snap, jax_runs, monkeypatch):
    """The matrix-free holdout of the iterative container with JAX's
    permutation of key(0): the JAX CLI's held-out means and variances."""
    _inject_permutation(monkeypatch, 0)
    ht, mt, vt = tdiag.holdout_cv_multivariate(snap["it"], torch.Generator(),
                                               6, **EXACT)
    np.testing.assert_array_equal(
        ht, np.asarray(jax.random.permutation(jax.random.key(0), N))[:6])
    mj, vj, _ = _table(jax_runs["holdout"][1])
    _close(mt, mj, rtol=RTOL_ITER, atol=1e-10)
    _close(vt, vj, rtol=RTOL_ITER, atol=1e-12)
    s = tdiag.holdout_summary_multivariate(snap["it"], torch.Generator(), 6,
                                           **EXACT)
    assert s["n"] == 6 * T
    with pytest.raises(ValueError, match="n_holdout"):
        tdiag.holdout_cv_multivariate(snap["it"], torch.Generator(), N)


def test_posterior_covariance_iterative_matches_jax(snap, monkeypatch):
    """The matrix-free covariance of every component (col_chunk 3 of 7
    queries) against the JAX one and the dense one, and the matrix-free
    joint draws with JAX's normals."""
    ej, it, Xq = snap["ej"], snap["it"], snap["Xq"]
    it_j = jmv.IterativeMultivariateEmulator(
        scaling=ej.scaling, X=ej.X, Z=ej.Z, pca=ej.pca, params=ej.params,
        config=ej.config, noise=ej.noise)

    def ref():
        sts = jmv.precompute_iterative_multivariate(it_j, **EXACT)
        return (jdiag.posterior_covariance_iterative(
            sts[0], it_j.component_data(0), jnp.asarray(
                tmv._scaled_queries(it, Xq).numpy()), col_chunk=3),
            jdiag.sample_multivariate_posterior_iterative(
                it_j, sts, jnp.asarray(Xq), jax.random.key(9), S,
                col_chunk=3))

    (mj, cj), dj = jax.jit(ref)()
    states = tmv.precompute_iterative_multivariate(it, **EXACT)
    mt, ct = tdiag.posterior_covariance_iterative(
        states[0], it.component_data(0), tmv._scaled_queries(it, Xq),
        col_chunk=3)
    _close(mt, mj, rtol=RTOL_ITER, atol=1e-10)
    _close(ct, cj, rtol=RTOL_ITER, atol=1e-10)
    _, cd = tdiag.posterior_covariance(
        snap["et"].states, snap["et"].params,
        tgp.GPData(X=it.X, y=it.Z.mT), tmv._scaled_queries(it, Xq),
        it.config)
    _close(ct, cd[0], rtol=RTOL_ITER, atol=1e-10)
    covs = torch.stack([tdiag.posterior_covariance_iterative(
        states[i], it.component_data(i), tmv._scaled_queries(it, Xq),
        col_chunk=3)[1] for i in range(snap["r"])])
    _inject_normals(monkeypatch, jax.random.key(9), snap["r"], covs)
    draws = tdiag.sample_multivariate_posterior_iterative(
        it, states, Xq, torch.Generator(), S, col_chunk=3)
    _close(draws, dj, rtol=RTOL_ITER, atol=1e-9)


@pytest.fixture(scope="module")
def sparse_snap(snap):
    """A small sparse emulator fitted by the port, as a text snapshot."""
    mf = tmf.read_model_file(snap["model"])
    cfg = tcfg.GPConfig(nparams=D, regression_order=1, n_restarts=2,
                        max_opt_steps=3)
    emu = ts.fit_multivariate_sparse(torch.Generator().manual_seed(0),
                                     torch.tensor(mf.X), torch.tensor(mf.Y),
                                     cfg, pca_variance=0.99, inducing=6)
    path = str(snap["tmp"] / "sparse.txt")
    tsnap.write_snapshot_sparse(path, emu, mf.param_names, mf.output_names)
    return path


def test_training_residuals_sparse_matches_jax(snap, sparse_snap, jax_runs):
    """A sparse emulator's training-point means and variances against the
    JAX package's (its CLI's table), and the summary against its own."""
    et, _, _ = tsnap.read_snapshot_auto(sparse_snap, device=CPU)
    X = tmf.read_model_file(snap["model"]).X
    mt, vt = tdiag.training_residuals_sparse(et, X, query_chunk=10)
    assert mt.shape == (N, T)
    mj, vj, yj = _table(jax_runs["sparse"][1])
    _close(mt, mj)
    _close(vt, vj)
    got = tdiag.training_summary_sparse(et, X, snap["Y"], interval=0.9)
    want = jdiag.validation_summary(mj, vj, yj, interval=0.9)
    _close([got[k] for k in got], [want[k] for k in want])


# --- the validate CLI -------------------------------------------------------


def _summary(text):
    """(header line, {name: value}) of a printed validate summary."""
    lines = text.splitlines()
    return lines[0], {k: float(v) for k, v in (ln.split() for ln in lines[1:])}


@pytest.mark.parametrize("branch", sorted(BRANCHES) + ["multifidelity"])
def test_validate_cli_matches_jax(branch, snap, sparse_snap, jax_runs,
                                  capsys, monkeypatch, tmp_path):
    """The port's `validate` prints the JAX CLI's summary (and writes its
    table) on the same snapshot; on a multi-fidelity snapshot, its
    per-level blocks."""
    if branch == "multifidelity":
        from madaiemulator_tpu_torch.models import multifidelity as tmfm

        rng = np.random.default_rng(13)
        X0, X1 = rng.uniform(size=(14, D)), rng.uniform(size=(7, D))
        f0 = np.sin(3 * X0[:, 0]) + X0[:, 1] + 0.02 * rng.standard_normal(14)
        f1 = np.sin(3 * X1[:, 0]) * 1.3 + 0.02 * rng.standard_normal(7)
        emu = tmfm.fit_multifidelity(
            torch.Generator().manual_seed(0), [torch.tensor(X0),
                                               torch.tensor(X1)],
            [torch.tensor(f0), torch.tensor(f1)],
            tcfg.GPConfig(nparams=D, n_restarts=2, max_opt_steps=5))
        p = str(tmp_path / "mf.txt")
        tsnap.write_snapshot_auto(p, emu)
        outs = []
        for main, extra in ((jcli.main, []), (tcli.main, ["--device",
                                                         "cpu"])):
            assert main(["validate", p] + extra) == 0
            outs.append(capsys.readouterr().out.splitlines())
        assert len(outs[1]) == len(outs[0]) == 2 * 9
        for lt, lj in zip(*outs[::-1]):
            if lj.startswith("#"):
                assert lt == lj
            else:
                assert lt.split()[0] == lj.split()[0]
                _close(float(lt.split()[1]), float(lj.split()[1]),
                       rtol=RTOL_ITER)
        return
    _inject_permutation(monkeypatch, 0)
    out, table = _validate(tcli.main, branch, snap, sparse_snap,
                           str(tmp_path / "t.txt"))
    (hj, sj), (ht, st) = _summary(jax_runs[branch][0]), _summary(out)
    assert ht == hj and st.keys() == sj.keys()
    _close([st[k] for k in st], [sj[k] for k in sj], rtol=RTOL_ITER)
    if table is not None:
        want = jax_runs[branch][1]
        assert table[0] == want[0]
        _close(np.loadtxt(table[1:]), np.loadtxt(want[1:]), rtol=RTOL_ITER,
               atol=1e-12)


@pytest.mark.parametrize("sparse,argv,line", [
    (False, ["--matrix_free"], "--matrix_free requires --holdout"),
    (True, ["--holdout", "4"], "--holdout/--matrix_free do not apply"),
    (True, [], "requires --model_file"),
])
def test_validate_cli_exits_2(sparse, argv, line, snap, sparse_snap, capsys):
    state = sparse_snap if sparse else snap["state"]
    assert tcli.main(["validate", state, "--device", "cpu"] + argv) == 2
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and line in err[0]
