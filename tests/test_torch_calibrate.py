"""The port's in-process calibration (`madaiemulator_tpu_torch.models.
calibrate`) and experiment file on the CPU against the JAX package at
float64: the log-posterior over each emulator kind (dense states, sparse,
scalar and multivariate multi-fidelity, matrix-free with its serving cache
on "precond" and "exact" variances), with diagonal and full experimental
covariances, the discrepancy scale and a log-prior; history matching and
the convergence diagnostics; the
CLI's `calibrate` in process; and one statistical check of the port's own
generator. The samplers under JAX's draws are
tests/test_torch_calibrate_samplers.py's.

Every emulator is read by both packages from one snapshot file, so both
hold the same numbers. Each JAX reference is one jitted program.
"""

import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu.io import experiment as jexp
from madaiemulator_tpu.io import snapshot as jsnap
from madaiemulator_tpu.models import calibrate as jcal
from madaiemulator_tpu.models import multivariate as jmv
from madaiemulator_tpu_torch import cli as tcli
from madaiemulator_tpu_torch.io import experiment as texp
from madaiemulator_tpu_torch.io import snapshot as tsnap
from madaiemulator_tpu_torch.models import calibrate as tcal
from madaiemulator_tpu_torch.models import multifidelity as tmfm
from madaiemulator_tpu_torch.models import multivariate as tmv
from madaiemulator_tpu_torch.models import sparse as tsp
from madaiemulator_tpu_torch.utils import config as tcfg
import torch_shared  # noqa: F401

CPU = torch.device("cpu")
# log-posteriors and chains: the same float64 algebra up to summation order
RTOL = 1e-10
# through PCG solves (the matrix-free "exact" variance)
RTOL_ITER = 1e-8
N, D, T = 16, 2, 3
W, STEPS = 8, 10
EXACT = dict(rank=N, cg_tol=1e-12, cg_max_iters=200)


def _close(got, want, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _t(a):
    return torch.tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _truth(X):
    return np.stack([np.sin(2 * X[:, 0]) + X[:, 1], X[:, 0] * X[:, 1],
                     np.cos(X[:, 1])], axis=1)


def build_emulators(tmp, kinds):
    """The emulator kinds asked for, written by the port and read by both
    packages: {kind: (JAX emulator, port emulator)}; "iterative" is the
    dense snapshot read without states (its serving caches under
    "_states")."""
    rng = np.random.default_rng(21)
    X = rng.uniform(1.0, 3.0, size=(N, D))
    Y = _truth(X) + 0.02 * rng.standard_normal((N, T))
    pca, Z = tmv.pca_decompose(Y, 0.999)
    r = Z.shape[1]
    mins, ranges = X.min(0), X.max(0) - X.min(0)
    arrays = dict(
        mins=mins, ranges=ranges, X=(X - mins) / ranges, Z=Z,
        ymean=pca.ymean, ystd=pca.ystd, eigenvalues=pca.eigenvalues, U=pca.U,
        log_amp=np.log(np.linspace(0.8, 1.2, r)),
        log_nugget=np.log(np.linspace(2e-3, 5e-3, r)),
        log_ls=np.log(np.tile([0.5, 0.7], (r, 1))))
    cfg = tcfg.GPConfig(nparams=D, regression_order=1)
    paths = {k: str(tmp / f"{k}.txt") for k in ("dense", "sparse", "mf",
                                                "mf_mv") if k in kinds}
    tsnap.write_snapshot(str(tmp / "dense.txt"), tmv.emulator_from_numpy(
        arrays, cfg, CPU, build_states=False))
    fit = tcfg.GPConfig(nparams=D, regression_order=1, n_restarts=1,
                        max_opt_steps=2)
    gen = torch.Generator().manual_seed(0)
    X1 = rng.uniform(1.0, 3.0, size=(8, D))
    Y1 = 1.3 * _truth(X1) + 0.1 * X1[:, :1] + 0.02 * rng.standard_normal(
        (8, T))
    if "sparse" in kinds:
        tsnap.write_snapshot_auto(paths["sparse"], tsp.fit_multivariate_sparse(
            gen, _t(X), _t(Y), fit, pca_variance=0.999, inducing=8))
    if "mf" in kinds:
        tsnap.write_snapshot_auto(paths["mf"], tmfm.fit_multifidelity(
            gen, [_t(X), _t(X1)], [_t(Y[:, 0]), _t(Y1[:, 0])], fit))
    if "mf_mv" in kinds:
        tsnap.write_snapshot_auto(paths["mf_mv"],
                                  tmfm.fit_multivariate_multifidelity(
                                      gen, [_t(X), _t(X1)], [_t(Y), _t(Y1)],
                                      fit, pca_variance=0.999))
    out = {k: (jsnap.read_snapshot_auto(p)[0],
               tsnap.read_snapshot_auto(p, device=CPU)[0])
           for k, p in paths.items()}
    if "iterative" in kinds:
        out["iterative"] = (
            jsnap.read_snapshot(str(tmp / "dense.txt"),
                                build_states=False)[0],
            tsnap.read_snapshot(str(tmp / "dense.txt"), device=CPU,
                                build_states=False)[0])
        # the matrix-free serving caches, built once (an eager JAX PCG)
        out["_states"] = (
            jmv.precompute_iterative_multivariate(out["iterative"][0],
                                                  **EXACT),
            tmv.precompute_iterative_multivariate(out["iterative"][1],
                                                  **EXACT))
    out["_paths"] = paths
    out["_y_exp"] = _truth(np.array([[2.1, 1.7]]))[0]
    out["_exp_var"] = np.array([0.01, 0.02, 0.015])
    return out


@pytest.fixture(scope="module")
def emus(tmp_path_factory):
    return build_emulators(tmp_path_factory.mktemp("cal"),
                           ("dense", "sparse", "mf", "mf_mv", "iterative"))


def _thetas(rng, n=6, extra=False):
    x = rng.uniform(-0.1, 1.1, size=(n, D + int(extra)))
    x[0, :D] = [0.3, 0.6]  # in the box
    x[1, 0] = 1.05  # outside: -inf
    return x


def _pair_lp(emus, kind, **kw):
    """(JAX log_post jitted, port log_post) of one kind and options."""
    ej, et = emus[kind]
    y, v = emus["_y_exp"], emus["_exp_var"]
    if kind.startswith("mf") and kind != "mf_mv":
        y, v = y[:1], v[:1]
    cov = kw.pop("cov", "diag")
    if cov == "full":
        A = np.array([[1.0, 0.3, 0.1], [0.3, 1.0, 0.2], [0.1, 0.2, 1.0]])
        v = np.sqrt(v)[:, None] * A * np.sqrt(v)[None, :]
    jkw, tkw = dict(kw), dict(kw)
    if kind == "iterative":
        method = kw.get("variance_method", "precond")
        jkw["states"], tkw["states"] = emus["_states"]
        jkw["variance_method"] = tkw["variance_method"] = method
    if kw.get("log_prior"):
        jkw["log_prior"] = lambda th: -0.5 * jnp.sum((th - 2.0) ** 2, -1)
        tkw["log_prior"] = lambda th: -0.5 * ((th - 2.0) ** 2).sum(-1)
    lj = jcal.make_log_posterior(ej, _j(y), _j(v), **jkw)
    lt = tcal.make_log_posterior(et, y, v, **tkw)
    return jax.jit(lj), lt


CASES = {
    "dense_diag": ("dense", {}),
    "dense_full": ("dense", dict(cov="full")),
    "dense_discrepancy_prior": ("dense", dict(discrepancy=True,
                                              log_prior=True)),
    "sparse": ("sparse", {}),
    "mf": ("mf", dict(discrepancy=True)),
    "mf_mv": ("mf_mv", dict(cov="full")),
    "iterative_precond": ("iterative", dict(variance_method="precond")),
    "iterative_exact": ("iterative", dict(variance_method="exact")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_log_posterior_matches_jax(emus, case):
    kind, kw = CASES[case]
    lj, lt = _pair_lp(emus, kind, **dict(kw))
    x = _thetas(np.random.default_rng(4), extra=kw.get("discrepancy", False))
    want = np.asarray(lj(_j(x)))
    got = lt(_t(x)).numpy()
    assert got[1] == -np.inf and np.isfinite(got[0])
    _close(got, want, rtol=RTOL_ITER if case == "iterative_exact" else RTOL)
    _close(lt(_t(x[0])), want[0],
           rtol=RTOL_ITER if case == "iterative_exact" else RTOL)
    if case == "iterative_exact":
        # its PCG has no reverse pass (nor has JAX's while loop)
        with pytest.raises(ValueError, match="precond"):
            tcal._lp_and_grad(lt, _t(x))
        return
    # HMC's gradient: autograd through the emulator's predict (K1's cross
    # VJP on the card) against jax.grad; zero where the walker is outside
    fin = np.isfinite(want)
    gj = np.asarray(jax.jit(jax.grad(
        lambda q: jnp.sum(jnp.where(_j(fin), lj(q), 0.0))))(_j(x)))
    lp, g = tcal._lp_and_grad(lt, _t(x))
    _close(g[fin], gj[fin], rtol=1e-8, atol=1e-10)
    assert (g[~fin] == 0).all()


def test_log_posterior_rejects_bad_shapes(emus):
    _, et = emus["dense"]
    with pytest.raises(ValueError, match="exp_cov"):
        tcal.make_log_posterior(et, np.zeros(T), np.zeros((T, 2)))
    with pytest.raises(ValueError, match="scalar multi-fidelity"):
        tcal.make_log_posterior(emus["mf"][1], np.zeros(T), np.ones(T))
    with pytest.raises(ValueError, match="serving cache"):
        tcal.make_log_posterior(emus["iterative"][1], np.zeros(T), np.ones(T))


@pytest.mark.parametrize("kind", ["dense", "sparse", "mf", "mf_mv",
                                  "iterative"])
def test_implausibility_matches_jax(emus, kind):
    ej, et = emus[kind]
    y, v = emus["_y_exp"], emus["_exp_var"]
    if kind == "mf":
        y, v = y[:1], v[:1]
    x = np.random.default_rng(6).uniform(size=(5, D))
    jkw = tkw = {}
    if kind == "iterative":
        jkw, tkw = (dict(states=st) for st in emus["_states"])
    want = jax.jit(lambda q: jcal.implausibility(ej, _j(y), _j(v), q,
                                                 **jkw))(_j(x))
    _close(tcal.implausibility(et, y, v, _t(x), **tkw), want)
    if kind == "dense":
        with pytest.raises(TypeError, match="iter_kwargs"):
            tcal.implausibility(et, y, v, _t(x), rank=4)


def test_convergence_diagnostics_match_jax():
    c = np.random.default_rng(2).standard_normal((40, 6, 3)).cumsum(0)
    _close(tcal.gelman_rubin(c), jcal.gelman_rubin(c), rtol=0, atol=0)
    _close(tcal.effective_sample_size(c), jcal.effective_sample_size(c),
           rtol=0, atol=0)
    assert np.isnan(tcal.gelman_rubin(c[:3])).all()


def test_experiment_file_both_ways(tmp_path):
    vals, var = np.array([1.5, -2.25, 1e-3]), np.array([0.1, 2.0, 1e-6])
    pj, pt = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jexp.write_experiment_file(pj, vals, var)
    texp.write_experiment_file(pt, vals, var)
    assert pathlib.Path(pt).read_bytes() == pathlib.Path(pj).read_bytes()
    for a, b in zip(texp.read_experiment_file(pj), (vals, var)):
        np.testing.assert_array_equal(a, b)
    bad = tmp_path / "bad.txt"
    bad.write_text("2\n1.0 0.5\n2.0 0\n")
    with pytest.raises(ValueError, match="positive"):
        texp.read_experiment_file(str(bad))


def test_emcee_recovers_a_gaussian_with_the_ports_generator():
    """The port's own draws: emcee on a correlated 2-D Gaussian recovers its
    mean within 4 standard errors (sd / sqrt(ESS)) and each variance within
    4 of its own (var sqrt(2 / ESS))."""
    mu = torch.tensor([0.3, -1.2], dtype=torch.float64)
    S = torch.tensor([[1.0, 0.6], [0.6, 2.0]], dtype=torch.float64)
    P = torch.linalg.inv(S)

    def log_post(x):
        r = x - mu
        return -0.5 * ((r @ P) * r).sum(-1)

    gen = torch.Generator().manual_seed(123)
    x0 = mu + 0.1 * torch.randn((32, 2), generator=gen, dtype=torch.float64)
    chain, _, acc = tcal.run_emcee(gen, log_post, x0, 1500)
    kept = chain[300:].numpy()
    ess = tcal.effective_sample_size(kept)
    flat = kept.reshape(-1, 2)
    sd = np.sqrt(np.diag(S.numpy()))
    assert 0.3 < float(acc) < 0.9
    assert (np.abs(flat.mean(0) - mu.numpy()) <= 4 * sd / np.sqrt(ess)).all()
    var = flat.var(0)
    assert (np.abs(var - sd ** 2) <= 4 * sd ** 2 * np.sqrt(2 / ess)).all()


# --- the CLI ---------------------------------------------------------------


def test_cli_calibrate(emus, tmp_path, capsys):
    """calibrate over a dense and a multi-fidelity snapshot: the draws
    table (kept steps x walkers rows, a '#' header naming the parameters)
    inside the design box, the summary on stderr; the JAX CLI's exits."""
    paths = emus["_paths"]
    exp = str(tmp_path / "exp.txt")
    texp.write_experiment_file(exp, emus["_y_exp"], emus["_exp_var"])
    out = str(tmp_path / "draws.txt")
    for sampler in ("emcee", "hmc"):
        assert tcli.main(["calibrate", paths["dense"], exp, "--device",
                          "cpu", "--n_walkers", "8", "--n_steps", "12",
                          "--burn_in", "4", "--sampler", sampler,
                          "--output", out, "--seed", "2"]) == 0
        err = capsys.readouterr().err
        assert "acceptance" in err and "rhat=" in err
        lines = pathlib.Path(out).read_text().splitlines()
        assert lines[0] == "# posterior samples: param_0 param_1"
        draws = np.loadtxt(lines[1:])
        assert draws.shape == (8 * 8, D) and np.isfinite(draws).all()
        ej, _ = emus["dense"]
        lo = np.asarray(ej.scaling.mins)
        assert (draws >= lo - 1e-12).all()
        assert (draws <= lo + np.asarray(ej.scaling.ranges) + 1e-12).all()
    exp1 = str(tmp_path / "exp1.txt")
    texp.write_experiment_file(exp1, emus["_y_exp"][:1], [0.01])
    assert tcli.main(["calibrate", paths["mf"], exp1, "--device", "cpu",
                      "--n_walkers", "8", "--n_steps", "6", "--quiet",
                      "--discrepancy"]) == 0
    assert capsys.readouterr().out.startswith("# posterior samples:")
    for argv, line in (
            ([paths["mf"], exp1, "--matrix_free"], "drop --matrix_free"),
            ([paths["sparse"], exp, "--matrix_free"], "drop --matrix_free"),
            ([paths["dense"], exp1], "1 observable(s)"),
            ([paths["dense"], str(tmp_path / "none.txt")], "")):
        if "none" in argv[1]:
            pathlib.Path(argv[1]).write_text("3\n1 0\n")
        assert tcli.main(["calibrate"] + argv + ["--device", "cpu"]) == 2
        err = capsys.readouterr().err.splitlines()
        assert len(err) == 1 and err[0].startswith("error: ") and line in err[0]
    if not torch.cuda.is_available():
        assert tcli.main(["calibrate", paths["dense"], exp]) == 2
        assert capsys.readouterr().err.strip() == (
            "error: CUDA device not available")
    assert tcli.main(["calibrate", paths["dense"], exp, "--device", "cpu",
                      "--matrix_free", "--n_walkers", "8", "--n_steps", "4",
                      "--quiet", "--output", os.devnull]) == 0
