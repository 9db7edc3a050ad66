"""The port's multi-fidelity slice on the CPU against the JAX package at
float64: `fit_multifidelity` from the same starts (a nested level and a
non-nested one); the
MULTIFIDELITY model file and the multi-fidelity snapshot grammars (text
byte for byte, .npz key for key, both ways); the per-level LOO twins; and
the CLI in process (estimate_thetas on a MULTIFIDELITY model file,
interactive_mode, validate, convert, print_thetas). The extra GLS columns
themselves are tests/test_torch_h_extra.py's; the multivariate emulator runs
these checks in tests/test_torch_multifidelity_mv.py.

Both packages' `sample_restarts` are replaced by one fixed u0 (numpy, from
a seed), so the fits start from the same points. Each JAX reference is one
jitted program; the JAX fits are compiled once per level shape (the
module-scoped `fits`).
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
from madaiemulator_tpu.io import modelfile as jmf
from madaiemulator_tpu.io import snapshot as jsnap
from madaiemulator_tpu.models import diagnostics as jdiag
from madaiemulator_tpu.models import fit as jfit
from madaiemulator_tpu.models import multifidelity as jmfm
from madaiemulator_tpu.ops import kernels as jk
from madaiemulator_tpu.utils import config as jcfg
from madaiemulator_tpu_torch import cli as tcli
from madaiemulator_tpu_torch.io import modelfile as tmf
from madaiemulator_tpu_torch.io import snapshot as tsnap
from madaiemulator_tpu_torch.models import diagnostics as tdiag
from madaiemulator_tpu_torch.models import fit as tfit
from madaiemulator_tpu_torch.models import multifidelity as tmfm
from madaiemulator_tpu_torch.ops import kernels as tk
from madaiemulator_tpu_torch.utils import config as tcfg
import torch_shared  # noqa: F401

CPU = torch.device("cpu")
# values, gradients and predictions: the same float64 algebra up to
# summation order and two LAPACK builds
RTOL = 1e-10
# fitted parameters and rho after a few L-BFGS steps from the same starts
RTOL_FIT = 1e-8
R, STEPS = 2, 4
D = 2
# one u0 for every fit of the module (the jitted JAX fit traces it in)
U0 = np.random.default_rng(31).uniform(-1.0, 1.0, size=(R, 2 + D))


def _close(got, want, rtol=RTOL, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _t(a):
    return torch.tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _cfgs(**kw):
    kw = dict(nparams=D, regression_order=1, **kw)
    return jcfg.GPConfig(**kw), tcfg.GPConfig(**kw)


# --- (b) the multi-fidelity fits from the same starts ---------------------


def _fixed_starts(mp):
    mp.setattr(jfit, "sample_restarts", lambda *a, **k: jk.GPParams(
        _j(U0[:, 0]), _j(U0[:, 1]), _j(U0[:, 2:])))
    mp.setattr(tfit, "sample_restarts", lambda *a, **k: tk.GPParams(
        _t(U0[:, 0]), _t(U0[:, 1]), _t(U0[:, 2:])))


def _levels(t=None):
    """Three levels, cheapest first: level 1 nested in level 0 (its lower
    values observed), level 2 not (the recursive mean is its column)."""
    rng = np.random.default_rng(5)
    X0 = rng.uniform(1.0, 3.0, size=(26, D))
    X1 = X0[::3][:8]
    # levels 1 and 2 share their size: one JAX compile serves both
    X2 = rng.uniform(1.0, 3.0, size=(8, D))

    def f0(X):
        base = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]
        if t is None:
            return base
        return np.stack([base * (1 + 0.3 * j) + 0.2 * j * X[:, 1] ** 2
                         for j in range(t)], axis=1)

    def f1(X):
        return 1.4 * f0(X) + 0.3 * np.cos(X[:, :1] if t else X[:, 0])

    def f2(X):
        return 0.8 * f1(X) + 0.1 * (X[:, 1:2] if t else X[:, 1]) ** 2

    def noisy(Y):
        # observation noise keeps the fitted nuggets away from the float64
        # conditioning floor, where two LAPACK builds part ways
        return Y + 0.02 * rng.standard_normal(Y.shape)

    return ([X0, X1, X2], [noisy(f0(X0)), noisy(f1(X1)), noisy(f2(X2))],
            [noisy(f0(X1)), None])


@pytest.fixture(scope="module")
def name():
    """The kind of emulator this module checks: "scalar" here;
    tests/test_torch_multifidelity_mv.py runs the same checks on "mv"."""
    return "scalar"


@pytest.fixture(scope="module")
def fits(name):
    """The module kind's 3-level fit by both packages from U0 (backtracking
    linesearch: half the JAX compile of zoom): (JAX emulator, port
    emulator, designs)."""
    mp = pytest.MonkeyPatch()
    _fixed_starts(mp)
    try:
        jc, tc = _cfgs(n_restarts=R, max_opt_steps=STEPS,
                       linesearch="backtracking")
        t = None if name == "scalar" else 3
        designs, targets, lower = _levels(t)
        lowj = [None if a is None else _j(a) for a in lower]
        lowt = [None if a is None else _t(a) for a in lower]
        if t is None:
            ej = jmfm.fit_multifidelity(
                jax.random.key(0), [_j(X) for X in designs],
                [_j(y) for y in targets], jc, lower_values=lowj)
            et = tmfm.fit_multifidelity(
                torch.Generator(), [_t(X) for X in designs],
                [_t(y) for y in targets], tc, lower_values=lowt)
        else:
            ej = jmfm.fit_multivariate_multifidelity(
                jax.random.key(0), [_j(X) for X in designs],
                [_j(y) for y in targets], jc, pca_variance=0.999,
                lower_values=lowj)
            et = tmfm.fit_multivariate_multifidelity(
                torch.Generator(), [_t(X) for X in designs],
                [_t(y) for y in targets], tc, pca_variance=0.999,
                lower_values=lowt)
    finally:
        mp.undo()
    return ej, et, designs


def test_fit_matches_jax_from_the_same_starts(fits, name):
    """Every level's fitted thetas and rho (the last GLS coefficient) at
    1e-8; the lower-level column of the non-nested level (the recursive
    mean) and the predictions at every level at 1e-8."""
    ej, et, designs = fits
    assert et.n_levels == 3
    for k, (lj, lt) in enumerate(zip(ej.levels, et.levels)):
        for a, b in zip(lt.params, lj.params):
            _close(a, b, rtol=RTOL_FIT, atol=1e-9)
        _close(lt.rho, lj.rho, rtol=RTOL_FIT, atol=1e-10)
        if k > 0:
            beta = (lt.state if name == "scalar" else lt.states).beta
            _close(lt.rho, beta[..., -1], rtol=0, atol=0)
            H = lt.data.h_extra if name == "scalar" else lt.H
            Hj = lj.data.h_extra if name == "scalar" else lj.H
            _close(H, Hj, rtol=RTOL_FIT, atol=1e-10)
    assert float(et.rho.abs().min()) > 0.1
    q = np.random.default_rng(7).uniform(1.0, 3.0, size=(9, D))
    # the top level recurses through the others
    if name == "scalar":
        pj = jmfm.predict_multifidelity(ej, _j(q))
        pt = tmfm.predict_multifidelity(et, q)
    else:
        pj = jmfm.predict_multivariate_multifidelity(ej, _j(q))
        pt = tmfm.predict_multivariate_multifidelity(et, q)
    for a, b in zip(pt, pj):
        _close(a, b, rtol=RTOL_FIT, atol=1e-9)
    with pytest.raises(ValueError, match="out of range"):
        tmfm.predict_multifidelity(et, q, level=3) if name == "scalar" \
            else tmfm.predict_multivariate_multifidelity(et, q, level=3)


def test_fit_validates_its_inputs():
    tc = tcfg.GPConfig(nparams=D)
    X = torch.zeros((4, D), dtype=torch.float64)
    y = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="mismatch"):
        tmfm.fit_multifidelity(torch.Generator(), [X, X], [y], tc)
    with pytest.raises(ValueError, match="lower_values"):
        tmfm.fit_multifidelity(torch.Generator(), [X, X], [y, y], tc,
                               lower_values=[None, None])
    with pytest.raises(ValueError, match="must be"):
        tmfm.fit_multivariate_multifidelity(torch.Generator(), [X], [y], tc)


# --- (c) the model file and the snapshots ---------------------------------


@pytest.mark.parametrize("kind", ["scalar", "mv"])
def test_model_file_both_ways(kind, tmp_path):
    """The port's writer writes the JAX writer's bytes; each package reads
    what the other wrote, to the same arrays."""
    designs, targets, lower = _levels(None if kind == "scalar" else 3)
    kw = (dict(output_name="yy") if kind == "scalar"
          else dict(output_names=["a", "b", "c"]))
    pj, pt = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jmf.write_multifidelity_model_file(pj, designs, targets, lower,
                                       ["p", "q"], **kw)
    tmf.write_multifidelity_model_file(pt, designs, targets, lower,
                                       ["p", "q"], **kw)
    assert pathlib.Path(pt).read_bytes() == pathlib.Path(pj).read_bytes()
    assert tmf.is_multifidelity_model_file(pt)
    a, b = tmf.read_multifidelity_model_file(pj), \
        jmf.read_multifidelity_model_file(pt)
    assert (a.param_names, a.output_names, a.nlevels, a.noutputs) == (
        b.param_names, b.output_names, b.nlevels, b.noutputs)
    for x, y in zip(a.designs + a.targets, b.designs + b.targets):
        np.testing.assert_array_equal(x, y)
    assert a.lower_values[1] is None and b.lower_values[1] is None
    np.testing.assert_array_equal(a.lower_values[0], b.lower_values[0])
    bad = tmp_path / "bad.txt"
    bad.write_text("MULTIFIDELITY\n2\n1\np\ny\n1 1\n0.5\n1.0\n")
    with pytest.raises(ValueError, match="level 0"):
        tmf.read_multifidelity_model_file(str(bad))


def _mf_names(name):
    return (["p", "q"], ["y"] if name == "scalar" else ["a", "b", "c"])


def test_snapshots_both_ways(fits, name, tmp_path):
    """Text: a JAX-written snapshot read by the port and written back is
    the same bytes, and the port's own is read by the JAX package and
    written back to the same bytes; .npz: the two writers agree key for
    key; the emulators read from either serve what the writer's served."""
    ej, et, designs = fits
    pn, on = _mf_names(name)
    p = {k: str(tmp_path / k) for k in ("j.txt", "t.txt", "t2.txt", "j2.txt",
                                         "j.npz", "t.npz")}
    jsnap.write_snapshot_auto(p["j.txt"], ej, pn, on)
    tsnap.write_snapshot_auto(p["t.txt"], et, pn, on)
    head = pathlib.Path(p["t.txt"]).read_text().split("\n", 1)[0]
    assert head == f"{tsnap.MAGIC_MF} {1 if name == 'scalar' else 2}"
    from_j, pn2, on2 = tsnap.read_snapshot_auto(p["j.txt"], device=CPU)
    assert (pn2, on2) == (pn, on)
    tsnap.write_snapshot_auto(p["t2.txt"], from_j, pn, on)
    assert (pathlib.Path(p["t2.txt"]).read_bytes()
            == pathlib.Path(p["j.txt"]).read_bytes())
    from_t, _, _ = jsnap.read_snapshot_auto(p["t.txt"])
    jsnap.write_snapshot_auto(p["j2.txt"], from_t, pn, on)
    assert (pathlib.Path(p["j2.txt"]).read_bytes()
            == pathlib.Path(p["t.txt"]).read_bytes())
    # both .npz writers on the emulator each package read from one text
    jsnap.write_snapshot_auto(p["j.npz"],
                              jsnap.read_snapshot_auto(p["j.txt"])[0], pn, on)
    tsnap.write_snapshot_auto(p["t.npz"], from_j, pn, on)
    with np.load(p["j.npz"]) as zj, np.load(p["t.npz"]) as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype, k
            np.testing.assert_array_equal(zj[k], zt[k], err_msg=k)
    npz_t, _, _ = tsnap.read_snapshot_auto(p["j.npz"], device=CPU)
    npz_j, _, _ = jsnap.read_snapshot_auto(p["t.npz"])
    for a, b in zip(npz_j.levels, from_j.levels):
        for x, y in zip(a.params, b.params):
            _close(x, y, rtol=0, atol=0)
        _close(a.rho, b.rho, rtol=0, atol=0)
    q = np.random.default_rng(9).uniform(1.0, 3.0, size=(6, D))
    predict_t = (tmfm.predict_multifidelity if name == "scalar"
                 else tmfm.predict_multivariate_multifidelity)
    predict_j = (jmfm.predict_multifidelity if name == "scalar"
                 else jmfm.predict_multivariate_multifidelity)
    want = predict_j(ej, _j(q))
    for got in (predict_t(from_j, q), predict_t(npz_t, q)):
        for a, b in zip(got, want):
            _close(a, b, rtol=1e-9, atol=1e-12)
    with pytest.raises(ValueError, match="read_snapshot_multifidelity"):
        tsnap.read_snapshot(p["t.txt"], device=CPU)
    with pytest.raises(ValueError, match="read_snapshot_multifidelity_npz"):
        tsnap.read_snapshot_npz(p["t.npz"], device=CPU)


# --- (d) the per-level LOO twins ------------------------------------------


def test_loo_twins_match_jax(fits, name):
    ej, et, _ = fits
    if name == "scalar":
        got, want = tdiag.loo_cv_multifidelity(et), \
            jdiag.loo_cv_multifidelity(ej)
        for a, b in zip(got, want):
            for x, y in zip(a, b):
                _close(x, y, rtol=RTOL_FIT, atol=1e-9)
        for a, b in zip(tdiag.loo_summary_multifidelity(et),
                        jdiag.loo_summary_multifidelity(ej)):
            assert a.keys() == b.keys()
            _close([a[k] for k in a], [b[k] for k in b], rtol=1e-6)
        return
    got, want = tdiag.loo_cv_multifidelity_mv(et), \
        jdiag.loo_cv_multifidelity_mv(ej)
    for k, ((rt, mt, vt), (rj, mj, vj)) in enumerate(zip(got, want)):
        for x, y in zip(rt, rj):
            _close(x, y, rtol=RTOL_FIT, atol=1e-9)
        _close(mt, mj, rtol=RTOL_FIT, atol=1e-9)
        _close(vt, vj, rtol=RTOL_FIT, atol=1e-9)
        _close(tdiag.reconstruct_level_targets_mv(et, k),
               jdiag.reconstruct_level_targets_mv(ej, k), rtol=RTOL_FIT)


# --- (e) the CLI in process -----------------------------------------------


class _Stdin:
    def __init__(self, fd):
        self._fd = fd

    def fileno(self):
        return self._fd


def _serve(mp, capsys, text, argv):
    r, w = os.pipe()
    os.write(w, text.encode())
    os.close(w)
    mp.setattr(sys, "stdin", _Stdin(r))
    try:
        rc = tcli.main(["interactive_mode"] + argv)
    finally:
        os.close(r)
    return rc, capsys.readouterr()


@pytest.fixture(scope="module")
def cli_states(fits, name, tmp_path_factory):
    """The module kind's MULTIFIDELITY model file and the port-fitted
    emulator's snapshot (the same file for both CLIs)."""
    tmp = tmp_path_factory.mktemp("mf_cli")
    designs, targets, lower = _levels(None if name == "scalar" else 3)
    pn, on = _mf_names(name)
    model = str(tmp / f"{name}_model.txt")
    kw = (dict(output_name=on[0]) if name == "scalar"
          else dict(output_names=on))
    tmf.write_multifidelity_model_file(model, designs, targets, lower,
                                       pn, **kw)
    state = str(tmp / f"{name}_state.txt")
    tsnap.write_snapshot_auto(state, fits[1], pn, on)
    return model, state


def test_cli_estimate_thetas_multifidelity(cli_states, name, tmp_path,
                                           capsys):
    """estimate_thetas on a MULTIFIDELITY model file writes the
    multi-fidelity snapshot (text, and .npz by extension), reports every
    level and rho, and equals the library fit with the CLI's flags."""
    model, _ = cli_states
    state = str(tmp_path / "s.txt")
    argv = ["estimate_thetas", model, state, "--device", "cpu",
            "--restarts", "2", "--steps", "3", "--regression_order", "1",
            "--seed", "4", "--pca_variance", "0.999"]
    assert tcli.main(argv) == 0
    err = capsys.readouterr().err
    assert "level 2: N=8, rho=" in err and "fidelity level(s)" in err
    got, _, _ = tsnap.read_snapshot_auto(state, device=CPU)
    mf = tmf.read_multifidelity_model_file(model)
    cfg = tcfg.GPConfig(nparams=D, regression_order=1, n_restarts=2,
                        max_opt_steps=3)
    gen = torch.Generator().manual_seed(4)
    args = ([_t(X) for X in mf.designs], [_t(y) for y in mf.targets], cfg)
    lower = [None if a is None else _t(a) for a in mf.lower_values]
    if name == "scalar":
        want = tmfm.fit_multifidelity(gen, *args, lower_values=lower)
    else:
        want = tmfm.fit_multivariate_multifidelity(
            gen, *args, pca_variance=0.999, lower_values=lower)
    for a, b in zip(got.levels, want.levels):
        for x, y in zip(a.params, b.params):
            _close(x, y, rtol=1e-12)
    assert tcli.main(argv[:2] + [str(tmp_path / "s.npz")] + argv[3:]
                     + ["--quiet"]) == 0
    assert tsnap.read_snapshot_auto(str(tmp_path / "s.npz"),
                                    device=CPU)[0].n_levels == 3


@pytest.mark.parametrize("flag", ["--noise_file=n.txt", "--inducing=4",
                                  "--fit_method=iterative"])
def test_cli_estimate_thetas_multifidelity_exclusions(cli_states, flag,
                                                      tmp_path, capsys):
    model, _ = cli_states
    assert tcli.main(["estimate_thetas", model, str(tmp_path / "s.txt"),
                      "--device", "cpu", flag]) == 2
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and err[0].startswith("error: ")
    assert not (tmp_path / "s.txt").exists()


def test_cli_serve_print_convert_validate_match_jax(cli_states, name,
                                                    tmp_path, capsys,
                                                    monkeypatch):
    """On the same multi-fidelity snapshot the port's interactive_mode
    answers the JAX CLI's predictions, and print_thetas, convert and
    validate (with --output) print and write what the JAX CLI does."""
    monkeypatch.setenv("MADAI_COMPILE_CACHE", "off")
    _, state = cli_states
    q = np.random.default_rng(11).uniform(1.0, 3.0, size=(5, D))
    text = "\n".join(" ".join(f"{v:.17g}" for v in p) for p in q) + "\n"
    rc, cap = _serve(monkeypatch, capsys, text, [state, "--device", "cpu"])
    assert rc == 0, cap.err
    ej, _, _ = jsnap.read_snapshot_auto(state)
    lines = cap.out.splitlines()
    t = 1 if name == "scalar" else 3
    head = 1 + D + 1 + 2 * t
    assert lines[:D + 1] == [str(D), "p", "q"]
    vals = np.asarray(lines[head:], float).reshape(5, 2 * t)
    if name == "scalar":
        m, v = jmfm.predict_multifidelity(ej, _j(q))
        want = np.stack([m, v], axis=1)
    else:
        want = np.concatenate(jmfm.predict_multivariate_multifidelity(
            ej, _j(q)), axis=1)
    _close(vals, want, rtol=1e-9, atol=1e-12)
    rc, cap = _serve(monkeypatch, capsys, "", [state, "--device", "cpu",
                                               "--serve_method", "fast"])
    assert rc == 2 and "multi-fidelity snapshots serve dense only" in cap.err
    for argv in (["print_thetas", state],
                 ["validate", state, "--output", "TABLE"]):
        outs = []
        for main, tag in ((jcli.main, "j"), (tcli.main, "t")):
            a = [x.replace("TABLE", str(tmp_path / f"{tag}.tab"))
                 for x in argv]
            assert main(a + (["--device", "cpu"] if main is tcli.main
                             and a[0] == "validate" else [])) == 0
            outs.append(capsys.readouterr().out)
        if argv[0] == "print_thetas":
            assert outs[1] == outs[0]
            continue
        lj, lt = outs[0].splitlines(), outs[1].splitlines()
        assert [ln.split()[0] for ln in lt] == [ln.split()[0] for ln in lj]
        assert [ln for ln in lt if ln.startswith("#")] == \
            [ln for ln in lj if ln.startswith("#")]
        num = [ln.split()[1] for ln in lt if not ln.startswith("#")]
        numj = [ln.split()[1] for ln in lj if not ln.startswith("#")]
        _close(np.asarray(num, float), np.asarray(numj, float), rtol=1e-6)
        tab = [(tmp_path / f"{x}.tab").read_text().splitlines()
               for x in "jt"]
        assert tab[1][0] == tab[0][0]
        _close(np.loadtxt(tab[1][1:]), np.loadtxt(tab[0][1:]), rtol=1e-6,
               atol=1e-9)
    for ext in ("npz", "txt"):
        outs = []
        for main, tag in ((jcli.main, "j"), (tcli.main, "t")):
            dest = str(tmp_path / f"c{tag}.{ext}")
            src = state if ext == "npz" else str(tmp_path / f"c{tag}.npz")
            assert main(["convert", src, dest]) == 0
            outs.append(capsys.readouterr().err)
        assert outs[1] == outs[0].replace("cj.", "ct.")
    assert ((tmp_path / "ct.txt").read_bytes()
            == (tmp_path / "cj.txt").read_bytes()
            == pathlib.Path(state).read_bytes())
    for bad in (["--holdout", "3"], ["--model_file", state]):
        assert tcli.main(["validate", state, "--device", "cpu"] + bad) == 2
        assert capsys.readouterr().err.startswith("error: ")
