"""The port's `estimate_thetas` slice on the CPU against the JAX package:
the batched L-BFGS against optax, `fit_multivariate` (PCA, the lock-step
component x restart fit, the alpha profile), the model-file reader and
writer, the design and PCA helpers, and the CLI's `estimate_thetas`,
`print_thetas` and `convert`.

JAX PRNG keys and torch generators draw different restarts, so the fits are
compared from the same unconstrained starts u0 (numpy, from a seed), fed to
both packages by replacing each `sample_restarts`. The JAX fits are jitted
with that u0 traced in, so every JAX fit of this module uses its own shapes
and one u0 per shape. All comparisons are float64.
"""

import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from madaiemulator_tpu import cli as jcli
from madaiemulator_tpu.io import modelfile as jmf
from madaiemulator_tpu.io import snapshot as jsnap
from madaiemulator_tpu.models import fit as jfit
from madaiemulator_tpu.models import multivariate as jmv
from madaiemulator_tpu.ops import kernels as jk
from madaiemulator_tpu.utils import config as jcfg
from madaiemulator_tpu.utils import designs as jdes
from madaiemulator_tpu_torch import cli as tcli
from madaiemulator_tpu_torch.io import modelfile as tmf
from madaiemulator_tpu_torch.io import snapshot as tsnap
from madaiemulator_tpu_torch.models import fit as tfit
from madaiemulator_tpu_torch.models import lbfgs
from madaiemulator_tpu_torch.models import multivariate as tmv
from madaiemulator_tpu_torch.ops import kernels as tk
from madaiemulator_tpu_torch.utils import config as tcfg
from madaiemulator_tpu_torch.utils import designs as tdes
import torch_shared  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden"
GOLDENS = sorted(p.name for p in GOLDEN.iterdir() if p.is_dir())
SIN1D = str(GOLDEN / "sin1d_powerexp" / "model.txt")
CPU = torch.device("cpu")


def _fixed_starts(mp, u0):
    mp.setattr(jfit, "sample_restarts", lambda *a, **k: jk.GPParams(
        jnp.asarray(u0[:, 0]), jnp.asarray(u0[:, 1]), jnp.asarray(u0[:, 2:])))
    mp.setattr(tfit, "sample_restarts", lambda *a, **k: tk.GPParams(
        torch.tensor(u0[:, 0]), torch.tensor(u0[:, 1]),
        torch.tensor(u0[:, 2:])))


# --- (a) the batched L-BFGS against optax.lbfgs ---------------------------

WALL = 1.6  # the objective is +inf for x0 > WALL


def _rosen_terms(x0, x1, where, inf):
    """Rosenbrock value and analytic gradient, +inf (gradient 0) past the
    wall; written once for both frameworks so the gradients round alike."""
    r = x1 - x0 ** 2
    v = (1 - x0) ** 2 + 100 * r ** 2
    g0 = -2 * (1 - x0) - 400 * x0 * r
    g1 = 200 * r
    wall = x0 > WALL
    return where(wall, inf, v), where(wall, 0.0, g0), where(wall, 0.0, g1)


@jax.custom_vjp
def _rosen_jax(x):
    return _rosen_terms(x[0], x[1], jnp.where, jnp.inf)[0]


def _rosen_fwd(x):
    return _rosen_jax(x), x


def _rosen_bwd(x, ct):
    _, g0, g1 = _rosen_terms(x[0], x[1], jnp.where, jnp.inf)
    return (ct * jnp.stack([g0, g1]),)


_rosen_jax.defvjp(_rosen_fwd, _rosen_bwd)

# (-1.2, 1): the classic start; (1, 1): at the minimum, every linesearch
# ends at its first trial while the other lanes iterate; (0.4, -0.3); and
# (1, 2), whose first trial step lands past the wall (+inf)
ROSEN_STARTS = np.array([[-1.2, 1.0], [1.0, 1.0], [0.4, -0.3], [1.0, 2.0]])


@pytest.mark.parametrize("linesearch", ["zoom", "backtracking"])
def test_lbfgs_matches_optax(linesearch):
    """8 lock-step steps from 4 starts reproduce optax.lbfgs under vmap,
    iterate for iterate, to rtol 1e-10 (observed 2e-11: the two frameworks
    round the objective differently in the last bits)."""
    if linesearch == "zoom":
        opt = optax.lbfgs()
    else:
        opt = optax.lbfgs(linesearch=optax.scale_by_backtracking_linesearch(
            max_backtracking_steps=25, store_grad=True))

    def run(u):
        vag = optax.value_and_grad_from_state(_rosen_jax)

        def step(carry, _):
            u, st = carry
            v, g = vag(u, state=st)
            upd, st = opt.update(g, st, u, value=v, grad=g,
                                 value_fn=_rosen_jax)
            return (optax.apply_updates(u, upd), st), None

        (u, _), _ = jax.lax.scan(step, (u, opt.init(u)), None, length=8)
        return u

    want = np.asarray(jax.jit(jax.vmap(run))(jnp.asarray(ROSEN_STARTS)))

    inf_lanes = set()

    def vg(u):
        v, g0, g1 = _rosen_terms(u[:, 0], u[:, 1], torch.where, torch.inf)
        inf_lanes.update(torch.nonzero(torch.isinf(v)).flatten().tolist())
        return v, torch.stack([g0, g1], dim=1)

    res = lbfgs.run_lbfgs(torch.tensor(ROSEN_STARTS), vg,
                          lambda u: vg(u)[0], 8, segments=(2,),
                          linesearch=linesearch)
    np.testing.assert_allclose(res.u.numpy(), want, rtol=1e-10)
    assert inf_lanes == {3}  # the wall was probed, by that lane only
    np.testing.assert_array_equal(res.u.numpy()[1], [1.0, 1.0])
    assert len(res.linesearch_evals) == 8
    assert bool(torch.isfinite(res.best_value).all())


# --- (e) fit_multivariate and the alpha profile ----------------------------

MV_N, MV_D, MV_T, MV_R, MV_STEPS = 30, 2, 5, 2, 3


@pytest.fixture(scope="module")
def mv_fits():
    """fit_multivariate at t=5 with alpha_grid=(1.5, 2.0) and alpha_refine=1
    in both packages from the same u0: 4 fits each (the grid, then 2
    golden-section probes), backtracking linesearch, R=2 x 3 steps."""
    rng = np.random.default_rng(3)
    X = rng.uniform(size=(MV_N, MV_D)) * [2.0, 3.0] + [1.0, -1.0]
    latent = np.stack([np.sin(3 * X[:, 0]), X[:, 1] ** 2, X[:, 0] * X[:, 1]],
                      axis=1)
    Y = latent @ rng.standard_normal((3, MV_T)) + 0.01 * rng.standard_normal(
        (MV_N, MV_T))
    u0 = np.concatenate([rng.uniform(-1.0, 1.0, (MV_R, 1)),
                         rng.uniform(-0.5, 1.5, (MV_R, 1)),
                         rng.uniform(-1.5, 1.5, (MV_R, MV_D))], axis=1)
    kw = dict(nparams=MV_D, n_restarts=MV_R, max_opt_steps=MV_STEPS,
              linesearch="backtracking", regression_order=1)
    grid = dict(pca_variance=0.99, alpha_grid=(1.5, 2.0), alpha_refine=1)
    with pytest.MonkeyPatch.context() as mp:
        _fixed_starts(mp, u0)
        ej = jmv.fit_multivariate(jax.random.key(0), jnp.asarray(X),
                                  jnp.asarray(Y), jcfg.GPConfig(**kw), **grid)
        et = tmv.fit_multivariate(torch.Generator().manual_seed(0),
                                  torch.tensor(X), torch.tensor(Y),
                                  tcfg.GPConfig(**kw), **grid)
    Xs = rng.uniform(size=(16, MV_D)) * [2.0, 3.0] + [1.0, -1.0]
    return ej, et, Xs


def test_fit_multivariate_matches_jax_f64(mv_fits):
    """The winning emulator: PCA to rtol 1e-10 (same numpy), params to rtol
    1e-6 and the per-restart LML to rtol 1e-8 (as fit_gp), predictions to
    rtol 1e-6 of the mean scale and of the prior variance."""
    ej, et, Xs = mv_fits
    assert et.n_components == ej.n_components >= 2
    for a, b in zip(et.pca, ej.pca):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)
    np.testing.assert_allclose(et.Z.numpy(), np.asarray(ej.Z), rtol=1e-10,
                               atol=1e-12)
    for a, b in zip(et.params, ej.params):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    np.testing.assert_allclose(et.restart_log_likelihoods.numpy(),
                               np.asarray(ej.restart_log_likelihoods),
                               rtol=1e-8)
    assert et.restart_log_likelihoods.shape == (et.n_components, MV_R)
    mt, vt = tmv.predict_multivariate(et, Xs)
    mj, vj = jmv.predict_multivariate(ej, jnp.asarray(Xs))
    scale = np.abs(np.asarray(mj)).max()
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-6,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-6,
                               atol=1e-6 * np.asarray(vj).max())


def test_alpha_grid_picks_same_alpha(mv_fits):
    ej, et, _ = mv_fits
    assert et.config.power_exp_alpha == ej.config.power_exp_alpha


def test_fit_multivariate_rejects_unported():
    """noise= and gradients= are ported (tests/test_torch_gradients.py);
    what fit_multivariate still refuses, it refuses with the JAX package's
    ValueErrors: gradient noise without gradients, and noise or gradients
    of the wrong shape."""
    X, Y = torch.zeros(4, 1, dtype=torch.float64), torch.ones(4, 2,
                                                              dtype=torch.float64)
    Y[:, 1] = torch.arange(4)
    cfg = tcfg.GPConfig(nparams=1)
    for kw, what in ((dict(gradient_noise=torch.ones(4, 1, 2)),
                      "without gradients"),
                     (dict(noise=torch.ones(4, 3)), "noise must be"),
                     (dict(gradients=torch.ones(4, 2)), "gradients must be")):
        with pytest.raises(ValueError, match=what):
            tmv.fit_multivariate(torch.Generator(), X, Y, cfg, **kw)


# --- (f) the model file ----------------------------------------------------


@pytest.mark.parametrize("case", GOLDENS)
def test_model_file_writer_byte_identical(case):
    """Both writers give the golden model file back byte for byte, and the
    port's reader returns what the JAX reader returns."""
    path = GOLDEN / case / "model.txt"
    mj = jmf.read_model_file(str(path))
    mt = tmf.read_model_file(str(path))
    assert (mt.param_names, mt.output_names) == (mj.param_names,
                                                 mj.output_names)
    np.testing.assert_array_equal(mt.X, mj.X)
    np.testing.assert_array_equal(mt.Y, mj.Y)
    bufs = []
    for writer in (jmf.write_model_file, tmf.write_model_file):
        buf = io.StringIO()
        writer(buf, mj.X, mj.Y, mj.param_names, mj.output_names)
        bufs.append(buf.getvalue())
    assert bufs[0] == bufs[1] == path.read_text()


BAD_MODEL_FILES = {
    "empty": "",
    "zero_params": "0\n",
    "truncated": "2\na\nb\n1\ny\n3\n0.1 0.2\n",
    "bad_count": "1\na\nx\n",
    "bad_float": "1\na\n1\ny\n1\nnope 1\n",
    "zero_points": "1\na\n1\ny\n0\n",
}


@pytest.mark.parametrize("name", sorted(BAD_MODEL_FILES))
def test_model_file_reader_errors_match(name):
    text = BAD_MODEL_FILES[name]
    errors = []
    for reader in (jmf.read_model_file, tmf.read_model_file):
        with pytest.raises(ValueError) as e:
            reader(io.StringIO(text))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_is_multifidelity_model_file(tmp_path):
    mf = tmp_path / "mf.txt"
    mf.write_text("# comment\nMULTIFIDELITY 2\n")
    for path in (str(mf), SIN1D):
        assert (tmf.is_multifidelity_model_file(path)
                == jmf.is_multifidelity_model_file(path))
    assert tmf.is_multifidelity_model_file(str(mf))


# --- (g) designs and PCA helpers -------------------------------------------


def test_project_scores_and_unapply_scaling_match_jax():
    """project_scores of the training outputs gives pca_decompose's Z, and
    both helpers agree with the JAX package to rtol 1e-12."""
    rng = np.random.default_rng(5)
    Y = rng.standard_normal((20, 4)) @ rng.standard_normal((4, 6))
    pca, Z = tmv.pca_decompose(Y, 0.999)
    jpca, _ = jmv.pca_decompose(Y, 0.999)
    zt = tmv.project_scores(torch.tensor(Y), pca)
    zj = jmv.project_scores(jnp.asarray(Y), jpca)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(zt.numpy(), Z, rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match="outputs must be"):
        tmv.project_scores(torch.zeros(3, 5), pca)
    X = rng.uniform(-2.0, 3.0, size=(9, 3))
    st = tdes.fit_scaling(torch.tensor(X))
    sj = jdes.fit_scaling(jnp.asarray(X))
    Xs = rng.uniform(size=(5, 3))
    np.testing.assert_allclose(
        tdes.unapply_scaling(torch.tensor(Xs), st).numpy(),
        np.asarray(jdes.unapply_scaling(jnp.asarray(Xs), sj)), rtol=1e-12)
    np.testing.assert_allclose(
        tdes.apply_scaling(tdes.unapply_scaling(torch.tensor(Xs), st),
                           st).numpy(), Xs, rtol=1e-12, atol=1e-15)


def test_latin_hypercube_properties():
    """One point per stratum of every axis, inside the unit box, the same
    design from the same seed and another from another seed."""
    n, d = 17, 4
    pts = tdes.latin_hypercube(torch.Generator().manual_seed(3), n, d)
    assert pts.shape == (n, d) and pts.dtype == torch.float64
    assert bool(((pts >= 0) & (pts < 1)).all())
    for j in range(d):
        strata = torch.floor(pts[:, j] * n).long()
        assert sorted(strata.tolist()) == list(range(n))
    again = tdes.latin_hypercube(torch.Generator().manual_seed(3), n, d)
    other = tdes.latin_hypercube(torch.Generator().manual_seed(4), n, d)
    assert torch.equal(pts, again) and not torch.equal(pts, other)
    assert tdes.latin_hypercube(torch.Generator(), 5, 2,
                                dtype=torch.float32).dtype == torch.float32


# --- (h) the CLI against the JAX CLI ---------------------------------------

CLI_ARGS = ["--regression_order", "1", "--restarts", "2", "--steps", "4",
            "--linesearch", "backtracking", "--quiet"]


@pytest.fixture(scope="module")
def cli_states(tmp_path_factory):
    """estimate_thetas on the sin1d golden model file through both CLIs
    (in process, --device cpu for the port) from the same u0."""
    tmp = tmp_path_factory.mktemp("cli")
    u0 = np.array([[0.3, 0.5, -0.4], [-0.6, 1.0, 0.8]])
    paths = {"jax": str(tmp / "jax.txt"), "torch": str(tmp / "torch.txt")}
    with pytest.MonkeyPatch.context() as mp:
        _fixed_starts(mp, u0)
        mp.setenv("MADAI_COMPILE_CACHE", "off")
        assert jcli.main(["estimate_thetas", SIN1D, paths["jax"]]
                         + CLI_ARGS) == 0
        assert tcli.main(["estimate_thetas", SIN1D, paths["torch"],
                          "--device", "cpu"] + CLI_ARGS) == 0
    return tmp, paths


def _numbers(path):
    toks = []
    for line in pathlib.Path(path).read_text().splitlines():
        for tok in line.split("#", 1)[0].split():
            try:
                toks.append(float(tok))
            except ValueError:
                toks.append(tok)
    return toks


def test_cli_snapshots_hold_same_numbers(cli_states):
    """The two snapshots agree token for token, numbers to rtol 1e-8."""
    _, paths = cli_states
    a, b = _numbers(paths["jax"]), _numbers(paths["torch"])
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, float):
            np.testing.assert_allclose(y, x, rtol=1e-8, atol=1e-14)
        else:
            assert x == y


def test_cli_snapshots_serve_across_packages(cli_states):
    """Each package serves the other's snapshot; the four answers agree to
    rtol 1e-6 (the snapshots agree to ~1e-10)."""
    _, paths = cli_states
    q = np.loadtxt(GOLDEN / "sin1d_powerexp" / "queries.txt", ndmin=2)
    answers = []
    for path in (paths["jax"], paths["torch"]):
        emu_t, _, _ = tsnap.read_snapshot(path, device=CPU)
        emu_j, _, _ = jsnap.read_snapshot(path)
        answers.append([x.numpy() for x in tmv.predict_multivariate(emu_t, q)])
        answers.append([np.asarray(x) for x in
                        jmv.predict_multivariate(emu_j, jnp.asarray(q))])
    for mean, var in answers[1:]:
        np.testing.assert_allclose(mean, answers[0][0], rtol=1e-6, atol=1e-8)
        np.testing.assert_allclose(var, answers[0][1], rtol=1e-6, atol=1e-12)


def test_cli_print_thetas_and_convert_match(cli_states, capsys,
                                            monkeypatch):
    """print_thetas prints the JAX CLI's text, and convert writes the JAX
    CLI's bytes, on the same snapshot."""
    tmp, paths = cli_states
    monkeypatch.setenv("MADAI_COMPILE_CACHE", "off")
    out = []
    for main in (jcli.main, tcli.main):
        capsys.readouterr()
        assert main(["print_thetas", paths["torch"]]) == 0
        out.append(capsys.readouterr().out)
    assert out[0] == out[1] and out[0].startswith("# 1 component(s)")
    conv = []
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        dest = str(tmp / f"converted_{name}.txt")
        assert main(["convert", paths["jax"], dest]) == 0
        conv.append(pathlib.Path(dest).read_bytes())
    assert conv[0] == conv[1] == pathlib.Path(paths["jax"]).read_bytes()


# --- (i) what is not yet ported exits 2 with one line ----------------------


def _mf_file(tmp_path):
    """A two-level scalar MULTIFIDELITY model file (level 1 nested)."""
    p = str(tmp_path / "mf.txt")
    x0 = np.linspace(0.0, 1.0, 9)[:, None]
    x1 = x0[::2]
    y0 = np.sin(6 * x0[:, 0])
    tmf.write_multifidelity_model_file(
        p, [x0, x1], [y0, 1.5 * y0[::2] + 0.2 * x1[:, 0]], [y0[::2]])
    return p


def _sgpr_state(tmp_path):
    """A sparse (SGPR) snapshot of the 1-D sin model, by the port's CLI."""
    p = str(tmp_path / "sgpr.txt")
    assert tcli.main(["estimate_thetas", SIN1D, p, "--inducing", "8",
                      "--restarts", "2", "--steps", "2", "--device", "cpu",
                      "--quiet"]) == 0
    return p


def _mf_state(tmp_path, name="mf_state.txt"):
    """A multi-fidelity snapshot (text, or .npz by extension) of
    `_mf_file`, by the port's CLI."""
    p = str(tmp_path / name)
    assert tcli.main(["estimate_thetas", _mf_file(tmp_path), p, "--restarts",
                      "2", "--steps", "2", "--device", "cpu",
                      "--quiet"]) == 0
    return p


def _mf_npz_state(tmp_path):
    return _mf_state(tmp_path, "mf.npz")


UNPORTED = {
    # the sparse fit is ported; what it excludes exits 2 with JAX's line
    "fit_method": lambda tmp: ["estimate_thetas", SIN1D, "s.txt",
                               "--fit_method", "iterative", "--inducing",
                               "8"],
    "inducing": lambda tmp: ["estimate_thetas", SIN1D, "s.txt",
                             "--inducing", "8"],
    "cholesky_blocked": lambda tmp: ["estimate_thetas", SIN1D, "s.txt",
                                     "--cholesky_method", "blocked"],
    "npz_state": lambda tmp: ["print_thetas", _mf_npz_state(tmp)],
    "multifidelity": lambda tmp: ["estimate_thetas", _mf_file(tmp), "s.txt"],
    "print_thetas_sgpr": lambda tmp: ["print_thetas", _sgpr_state(tmp)],
    "convert_sgpr": lambda tmp: ["convert", _sgpr_state(tmp), "o.txt"],
    "convert_to_npz": lambda tmp: ["convert", _mf_state(tmp), "o.npz"],
    # the JAX CLI's sparse tuning flags, honoured by the sparse fit
    "tuning_inducing_opt_steps": lambda tmp: [
        "estimate_thetas", SIN1D, "s.txt", "--inducing", "8",
        "--inducing_opt_steps", "1"],
    "tuning_row_chunk": lambda tmp: [
        "estimate_thetas", SIN1D, "s.txt", "--inducing", "8", "--row_chunk",
        "8"],
}
# the cases whose commands are ported now: each checks that it works (the
# sparse, multi-fidelity and blocked-factor fits write their snapshots;
# print_thetas prints what the JAX CLI prints; convert rewrites the
# snapshot's bytes, or its .npz key for key as the JAX CLI does)
PORTED_NOW = ("inducing", "print_thetas_sgpr", "convert_sgpr",
              "tuning_inducing_opt_steps", "tuning_row_chunk",
              "multifidelity", "npz_state", "convert_to_npz",
              "cholesky_blocked")


@pytest.mark.parametrize("what", sorted(UNPORTED))
def test_unported_exits_2_with_one_line(what, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = UNPORTED[what](tmp_path)
    if argv[0] == "estimate_thetas":
        argv += ["--device", "cpu"]
    if what in PORTED_NOW:
        if argv[0] == "estimate_thetas":
            argv += ["--restarts", "2", "--steps", "2"]
        capsys.readouterr()
        assert tcli.main(argv) == 0
        out = capsys.readouterr().out
        mf = what in ("multifidelity", "npz_state", "convert_to_npz")
        if argv[0] == "estimate_thetas":
            magic = (tsnap.MAGIC if what == "cholesky_blocked" else
                     tsnap.MAGIC_MF if mf else tsnap.MAGIC_SGPR)
            assert (tmp_path / "s.txt").read_text().startswith(
                magic + " 1\n")
        elif argv[0] == "print_thetas":
            monkeypatch.setenv("MADAI_COMPILE_CACHE", "off")
            assert jcli.main(argv) == 0
            assert out == capsys.readouterr().out
            assert out.startswith("# 2 fidelity level(s)" if mf
                                  else "# 1 component(s)")
        elif mf:
            monkeypatch.setenv("MADAI_COMPILE_CACHE", "off")
            assert jcli.main(["convert", argv[1], "j.npz"]) == 0
            with np.load(tmp_path / "o.npz") as zt, \
                    np.load(tmp_path / "j.npz") as zj:
                assert sorted(zt.files) == sorted(zj.files)
                for k in zj.files:
                    np.testing.assert_array_equal(zt[k], zj[k])
        else:
            assert ((tmp_path / "o.txt").read_bytes()
                    == pathlib.Path(argv[1]).read_bytes())
        return
    assert tcli.main(argv) == 2
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and err[0].startswith("error: ")
    if what == "fit_method":
        assert err == ["error: --inducing (sparse SGPR) excludes "
                       "--fit_method=iterative and --alpha_grid "
                       "(models/sparse.py)"]
    else:
        assert "not" in err[0] and "ported" in err[0]
    assert not (tmp_path / "s.txt").exists()
