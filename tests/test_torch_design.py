"""The port's sequential design (`madaiemulator_tpu_torch.models.design`)
against the JAX package's on the CPU at float64, with JAX's Latin-hypercube
pool injected through the port's draw helper (`_candidate_pool`): the
active-variance batch and the NROY wave on the dense and the matrix-free
emulator (the sparse and multi-fidelity ones: test_torch_design_kinds.py),
the partial-viable case without duplicate picks, and the CLI's `design`
(both methods, and --matrix_free) against the JAX CLI's output, with the
exit-2 routes.

The emulators are served by both packages from the same snapshot: a dense
one with fixed thetas (N=36, d=2, t=3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu import cli as jcli
from madaiemulator_tpu.io import snapshot as jsnap
from madaiemulator_tpu.models import design as jdes
from madaiemulator_tpu.models.calibrate import implausibility as jimp
from madaiemulator_tpu.utils import designs as jdesigns
from madaiemulator_tpu_torch import cli as tcli
from madaiemulator_tpu_torch.io import experiment as texp
from madaiemulator_tpu_torch.io import snapshot as tsnap
from madaiemulator_tpu_torch.models import design as tdes
from madaiemulator_tpu_torch.models import multivariate as tmv
from madaiemulator_tpu_torch.utils import config as tcfg
import torch_shared  # noqa: F401

CPU = torch.device("cpu")
N, D, T = 36, 2, 3
POOL, N_NEW = 256, 8
# scores: the same float64 moments up to summation order (matrix-free: PCG
# at cg_tol 1e-12)
RTOL = 1e-9
ITER = dict(rank=8, cg_tol=1e-12, cg_max_iters=300)


def _sim(X):
    return np.stack([np.sin(2 * X[:, 0]) + X[:, 1], X[:, 0] * X[:, 1],
                     np.cos(X[:, 1])], 1)


def _jax_pool(monkeypatch):
    """The port's pool helper draws JAX's Latin hypercube from the key of
    the generator's seed (what the JAX functions draw from that key)."""
    def pool(gen, n, d, dtype):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        return torch.tensor(np.asarray(jdesigns.latin_hypercube(
            jax.random.key(gen.initial_seed()), n, d, dtype=jdt)))

    monkeypatch.setattr(tdes, "_candidate_pool", pool)


NAMES = (["a", "b"], ["o0", "o1", "o2"])


def _read_both(path, **kw):
    """(JAX emulator, port emulator) of one snapshot."""
    return (jsnap.read_snapshot_auto(path, **kw)[0],
            tsnap.read_snapshot_auto(path, device=CPU, **kw)[0])


@pytest.fixture(scope="module")
def snaps(tmp_path_factory):
    """The dense emulator (fixed thetas) as a snapshot, also read without
    serve states (the matrix-free emulator), and its gradient-enhanced (v3)
    twin: {"emus": {kind: (JAX emulator, port emulator)}, "paths": {kind:
    snapshot}, "tmp": directory}."""
    tmp = tmp_path_factory.mktemp("design")
    rng = np.random.default_rng(31)
    X = rng.uniform(1.0, 3.0, size=(N, D))
    Y = _sim(X) + 0.02 * rng.standard_normal((N, T))
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
    paths = {k: str(tmp / f"{k}.txt") for k in ("dense", "v3")}
    tsnap.write_snapshot(paths["dense"], tmv.emulator_from_numpy(
        arrays, cfg, CPU, build_states=False), *NAMES)
    dZ = 0.1 * rng.standard_normal((N, D, r))
    tsnap.write_snapshot(paths["v3"], tmv.emulator_from_numpy(
        {**arrays, "dZ": dZ}, cfg, CPU), *NAMES)
    emus = {"dense": _read_both(paths["dense"]),
            "matrix_free": _read_both(paths["dense"], build_states=False)}
    return dict(emus=emus, paths=paths, tmp=tmp)


KINDS = ("dense", "matrix_free")


def _observed(kind):
    """(y_exp, exp_var) for a kind: its simulator at (2.1, 1.7) (the
    multi-fidelity fixture's top level is 1.2 f + 0.1 + 0.2 x0, its f's
    last observable x1^2)."""
    a, b = 2.1, 1.7
    y = _sim(np.array([[a, b]]))[0]
    if kind.startswith("mf"):
        y = 1.2 * np.array([y[0], y[1], b ** 2]) + 0.1 + 0.2 * a
    if kind == "mf_scalar":
        y = y[:1]
    return y, np.full(y.shape, 0.2 ** 2)


def _same(got, want):
    # identical picks: the same pool rows mapped to natural space alike
    np.testing.assert_array_equal(got.points, np.asarray(want.points))
    # (relative to the largest: a variance is a difference of O(prior)
    # terms, so the smallest scores carry the largest's absolute error)
    ws = np.asarray(want.scores)
    np.testing.assert_allclose(got.scores, ws, rtol=RTOL,
                               atol=RTOL * np.abs(ws).max())
    np.testing.assert_allclose(got.pool_fraction_viable,
                               want.pool_fraction_viable, rtol=RTOL)
    assert isinstance(got.points, np.ndarray)
    assert got.points.shape == (N_NEW, D) and got.scores.shape == (N_NEW,)


def check_active_variance(kind, ej, et, monkeypatch):
    _jax_pool(monkeypatch)
    kw = ITER if kind == "matrix_free" else {}
    want = jdes.active_variance_design(jax.random.key(1), ej, n_new=N_NEW,
                                       pool_size=POOL, **kw)
    got = tdes.active_variance_design(torch.Generator().manual_seed(1), et,
                                      n_new=N_NEW, pool_size=POOL, **kw)
    _same(got, want)
    assert got.pool_fraction_viable == 1.0


def check_nroy_wave(kind, ej, et, monkeypatch):
    _jax_pool(monkeypatch)
    kw = ITER if kind == "matrix_free" else {}
    y, v = _observed(kind)
    want = jdes.nroy_wave_design(jax.random.key(2), ej, y, v, n_new=N_NEW,
                                 pool_size=POOL, **kw)
    got = tdes.nroy_wave_design(torch.Generator().manual_seed(2), et, y,
                                np.diag(v), n_new=N_NEW, pool_size=POOL,
                                **kw)
    _same(got, want)
    assert 0.0 < got.pool_fraction_viable < 1.0


@pytest.mark.parametrize("kind", KINDS)
def test_active_variance_design_matches_jax(kind, snaps, monkeypatch):
    check_active_variance(kind, *snaps["emus"][kind], monkeypatch)


@pytest.mark.parametrize("kind", KINDS)
def test_nroy_wave_design_matches_jax(kind, snaps, monkeypatch):
    check_nroy_wave(kind, *snaps["emus"][kind], monkeypatch)


def test_nroy_partial_viable_no_duplicates(snaps):
    """0 < #viable < n_new (tests/test_design.py:156): the two viable pool
    points are picked, and the rest fall through to distinct,
    least-implausible-leaning points; the JAX package picks the same."""
    ej, et = snaps["emus"]["dense"]
    y, v = _observed("dense")
    v = np.full(3, 0.05 ** 2)
    pool = np.asarray(jax.random.uniform(jax.random.key(11), (512, D),
                                         dtype=jnp.float64))
    imp = np.asarray(jimp(ej, y, v, jnp.asarray(pool)))
    srt = np.sort(imp)
    thr = float(0.5 * (srt[1] + srt[2]))
    want = jdes.nroy_wave_design(jax.random.key(5), ej, y, v, n_new=6,
                                 pool=jnp.asarray(pool), threshold=thr)
    got = tdes.nroy_wave_design(torch.Generator().manual_seed(5), et, y, v,
                                n_new=6, pool=pool, threshold=thr)
    np.testing.assert_array_equal(got.points, np.asarray(want.points))
    assert np.isclose(got.pool_fraction_viable, 2.0 / 512.0)
    pts = got.points
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    assert d2.min() > 1e-10
    sc = et.scaling
    sel = (pts - sc.mins.numpy()) / sc.ranges.numpy()
    for i in np.argsort(imp)[:2]:
        assert ((sel - pool[i]) ** 2).sum(-1).min() < 1e-20
    assert np.asarray(jimp(ej, y, v, jnp.asarray(sel))).mean() < np.median(
        imp)


def _run(main, argv, tmp, name, monkeypatch, capsys):
    (tmp / name).mkdir(exist_ok=True)
    monkeypatch.chdir(tmp / name)
    rc = main(argv)
    return rc, capsys.readouterr()


# the module's pool size and batch: the JAX CLI reuses the executables the
# tests above compiled
CLI_CASES = {
    "variance": ["--method", "variance", "--seed", "3"],
    "nroy": ["--method", "nroy", "--threshold", "3", "--seed", "4"],
    "variance_matrix_free": ["--matrix_free", "--rank", "8", "--cg_tol",
                             "1e-12", "--cg_max_iters", "300"],
}


@pytest.mark.parametrize("case", sorted(CLI_CASES))
def test_cli_design_matches_jax_cli(case, snaps, monkeypatch, capsys):
    """`design` on the dense snapshot: the port's output file and stderr
    (JAX's pool injected) against the JAX CLI's."""
    _jax_pool(monkeypatch)
    monkeypatch.setenv("MADAI_COMPILE_CACHE", "off")
    tmp = snaps["tmp"]
    exp = str(tmp / "exp.txt")
    y, v = _observed("dense")
    texp.write_experiment_file(exp, y, v)
    argv = ["design", snaps["paths"]["dense"], "--output", "pts.txt",
            "--experiment_file", exp, "--n_new", str(N_NEW), "--pool_size",
            str(POOL)] + CLI_CASES[case]
    outs = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", tcli.main, ["--device", "cpu"])):
        rc, cap = _run(main, argv + extra, tmp, f"{case}_{name}",
                       monkeypatch, capsys)
        assert rc == 0
        outs[name] = ((tmp / f"{case}_{name}" / "pts.txt").read_text(),
                      cap.err)
    assert outs["torch"] == outs["jax"]
    assert outs["torch"][0].startswith("# proposed runs: a b\n")


def _write(tmp, name, text):
    p = tmp / name
    p.write_text(text)
    return str(p)


EXIT2 = {
    "nroy_without_experiment_file": lambda s: [
        "design", s["paths"]["dense"], "--method", "nroy"],
    "bad_experiment_file": lambda s: [
        "design", s["paths"]["dense"], "--method", "nroy",
        "--experiment_file", _write(s["tmp"], "bad.txt", "3\n1 0.1\n")],
    "observable_count": lambda s: [
        "design", s["paths"]["dense"], "--method", "nroy",
        "--experiment_file", _write(s["tmp"], "two.txt",
                                    "2\n1 0.1\n2 0.1\n")],
    "v3_matrix_free": lambda s: ["design", s["paths"]["v3"],
                                 "--matrix_free"],
}


def check_exit_2(case, argv, monkeypatch, capsys):
    """The JAX CLI refuses argv with exit 2 and the port's alike, with one
    `error:` line."""
    monkeypatch.setenv("MADAI_COMPILE_CACHE", "off")
    assert jcli.main(argv) == 2
    want = capsys.readouterr().err.splitlines()
    assert tcli.main(argv + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err.splitlines()
    assert len(got) == 1 and got[0].startswith("error: ")
    if case == "sparse_matrix_free":
        assert got[0].endswith("serve state; drop --matrix_free")
    elif case != "v3_matrix_free":
        assert got == want[-1:]


@pytest.mark.parametrize("case", sorted(EXIT2) + ["no_cuda"])
def test_cli_design_exit_2(case, snaps, monkeypatch, capsys):
    """Each route the JAX CLI refuses with exit 2 is refused alike by the
    port's; without a card `--device cuda` (the default) exits 2."""
    if case == "no_cuda":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert tcli.main(["design", snaps["paths"]["dense"]]) == 2
        assert capsys.readouterr().err == (
            "error: CUDA device not available\n")
        return
    check_exit_2(case, EXIT2[case](snaps), monkeypatch, capsys)
