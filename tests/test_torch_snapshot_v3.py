"""Snapshot grammar version 3 (gradient-enhanced emulators) between the
port (madaiemulator_tpu_torch/io/snapshot.py) and the JAX package, as text
and as .npz, in both directions; a port-written v3 snapshot served by the
native C++ library (`native/`) and its `madai_query` pipe binary; and the
port's CLI end to end: `estimate_thetas --noise_file --gradients_file` ->
v3 snapshot -> `print_thetas`, `convert`, `interactive_mode`. All float64
on the CPU.

One emulator, fitted by the port on N=12 points in d=2 with t=3 outputs,
their gradients, noise and gradient noise; one JAX compile of the v3
serve-state build and of its predict, in module-scoped fixtures.
"""

import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu import cli as jcli
from madaiemulator_tpu import native
from madaiemulator_tpu.io import snapshot as jsnap
from madaiemulator_tpu.models import multivariate as jmv
from madaiemulator_tpu_torch import cli as tcli
from madaiemulator_tpu_torch.io import modelfile as tmf
from madaiemulator_tpu_torch.io import snapshot as tsnap
from madaiemulator_tpu_torch.models import multivariate as tmv
from madaiemulator_tpu_torch.utils import config as tcfg
import torch_shared

CPU = torch.device("cpu")
N, D, T = 12, 2, 3
PNAMES, ONAMES = ["a", "b"], ["o0", "o1", "o2"]
# One package serving the same float64 arrays from two encodings.
SAME_RTOL = 1e-12
# The port against the JAX package or the native library on one snapshot:
# float64 implementations with other summation orders, through a joint
# factorization at cond ~1e5.
CROSS_RTOL = 1e-10


def _problem(seed=3):
    """Outputs of three smooth functions and their exact gradients w.r.t.
    the raw inputs, with known per-point noise."""
    rng = np.random.default_rng(seed)
    X = 1.0 + 2.0 * rng.uniform(size=(N, D))
    x0, x1 = X[:, 0], X[:, 1]
    Y = np.stack([np.sin(x0) + x1, x0 * x1, np.cos(x1)], 1)
    G = np.stack([np.stack([np.cos(x0), np.ones(N)], 1),
                  np.stack([x1, x0], 1),
                  np.stack([np.zeros(N), -np.sin(x1)], 1)], 2)  # (N, d, t)
    noise = rng.uniform(1e-4, 1e-3, N)
    gnoise = rng.uniform(1e-4, 1e-3, (N, D, T))
    return X, Y, G, noise, gnoise


def _queries(m=5, seed=4):
    return 1.0 + 2.0 * np.random.default_rng(seed).uniform(size=(m, D))


@pytest.fixture(scope="module")
def snap(tmp_path_factory):
    X, Y, G, noise, gnoise = _problem()
    cfg = tcfg.GPConfig(nparams=D, regression_order=1, n_restarts=2,
                        max_opt_steps=6)
    emu = tmv.fit_multivariate(
        torch.Generator().manual_seed(0), torch.tensor(X), torch.tensor(Y),
        cfg, pca_variance=0.999, noise=torch.tensor(noise),
        gradients=torch.tensor(G), gradient_noise=torch.tensor(gnoise))
    tmp = tmp_path_factory.mktemp("v3")
    paths = {k: str(tmp / f"torch.{k}") for k in ("txt", "npz")}
    tsnap.write_snapshot(paths["txt"], emu, PNAMES, ONAMES)
    # from here on the emulator as the text holds it (the thetas round-trip
    # through exp / "%.17g" / log), which both packages read
    emu, _, _ = tsnap.read_snapshot(paths["txt"], device=CPU)
    tsnap.write_snapshot_npz(paths["npz"], emu, PNAMES, ONAMES)
    emu_j, _, _ = jsnap.read_snapshot(paths["txt"])
    jpaths = {k: str(tmp / f"jax.{k}") for k in ("txt", "npz")}
    jsnap.write_snapshot(jpaths["txt"], emu_j, PNAMES, ONAMES)
    jsnap.write_snapshot_npz(jpaths["npz"], emu_j, PNAMES, ONAMES)
    q = _queries()
    want = [np.asarray(a) for a in jmv.predict_multivariate(emu_j,
                                                            jnp.asarray(q))]
    got = [a.numpy() for a in tmv.predict_multivariate(emu, q)]
    return dict(emu=emu, emu_j=emu_j, paths=paths, jpaths=jpaths, q=q,
                want=want, got=got, tmp=tmp)


def _prior_var(emu) -> float:
    """The largest prior variance of an observable: the scale the posterior
    variances cancel against (they sit far below it at the data)."""
    amp = (emu.params.log_amp.exp() + emu.params.log_nugget.exp()).numpy()
    pca = emu.pca
    v = (pca.U.numpy() ** 2 * (pca.eigenvalues.numpy() * amp)[None, :]).sum(1)
    return float((v * pca.ystd.numpy() ** 2).max())


def _assert_pred(got, want, rtol, vscale=None):
    """Means to rtol; variances to rtol of the prior variance vscale."""
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        scale = np.abs(b).max() if i == 0 or vscale is None else vscale
        np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                                   atol=rtol * scale)


def test_port_writes_version_3(snap):
    emu = snap["emu"]
    assert emu.dZ.shape == emu.dZ_noise.shape == (N, D, emu.n_components)
    head = pathlib.Path(snap["paths"]["txt"]).read_text().splitlines()
    assert head[0] == "MADAIEMULATOR_TPU_SNAPSHOT 3"
    assert head[6:9] == ["has_noise 1", "has_gradients 1",
                         "has_gradient_noise 1"]


def test_v3_text_writers_byte_identical(snap):
    assert (pathlib.Path(snap["jpaths"]["txt"]).read_bytes()
            == pathlib.Path(snap["paths"]["txt"]).read_bytes())


def test_v3_npz_writers_agree_key_for_key(snap):
    with np.load(snap["paths"]["npz"]) as a, \
            np.load(snap["jpaths"]["npz"]) as b:
        assert sorted(a.files) == sorted(b.files)
        assert {"noise_pc", "dZ_pc", "dZ_noise_pc"} <= set(a.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_v3_serves_from_jax(snap):
    """The JAX package's predictions on the port-written text (read in the
    fixture) and .npz against the port's own."""
    pv = _prior_var(snap["emu"])
    _assert_pred(snap["got"], snap["want"], CROSS_RTOL, pv)
    emu_j, _, _ = jsnap.read_snapshot_npz(snap["paths"]["npz"])
    got = jmv.predict_multivariate(emu_j, jnp.asarray(snap["q"]))
    _assert_pred(got, snap["want"], SAME_RTOL, pv)


@pytest.mark.parametrize("enc", ["txt", "npz"])
def test_jax_v3_serves_from_port(snap, enc):
    emu, pnames, onames = tsnap.read_snapshot_auto(snap["jpaths"][enc],
                                                   device=CPU)
    assert (pnames, onames) == (PNAMES, ONAMES)
    for name in ("noise", "dZ", "dZ_noise"):
        np.testing.assert_array_equal(getattr(emu, name).numpy(),
                                      getattr(snap["emu"], name).numpy())
    pv = _prior_var(emu)
    got = [a.numpy() for a in tmv.predict_multivariate(emu, snap["q"])]
    _assert_pred(got, snap["got"], SAME_RTOL, pv)
    _assert_pred(got, snap["want"], CROSS_RTOL, pv)
    g = tmv.predict_multivariate_gradient(emu, snap["q"])
    gj = jmv.predict_multivariate_gradient(snap["emu_j"],
                                           jnp.asarray(snap["q"]))
    _assert_pred(g, gj, CROSS_RTOL)


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """This process's private build of native/ (the library and
    madai_query)."""
    return torch_shared.native_build(tmp_path_factory)


def test_port_v3_serves_from_native(native_lib, snap, monkeypatch):
    """A port-written v3 snapshot through libmadai_emu.so and madai_query:
    the port's predictions to 1e-10 (variances at the scale of the prior
    variance they cancel against)."""
    state = snap["paths"]["txt"]
    q = snap["q"]
    mean, var = snap["got"]
    pv = _prior_var(snap["emu"])
    monkeypatch.setattr(native, "_LIB_PATH", native_lib / "libmadai_emu.so")
    monkeypatch.setattr(native, "_lib", None)
    ne = native.NativeEmulator(state)
    assert ne.nparams == D and ne.noutputs == T
    for i in range(q.shape[0]):
        mc, vc = ne.query(q[i])
        np.testing.assert_allclose(mc, mean[i], rtol=CROSS_RTOL)
        np.testing.assert_allclose(vc, var[i], rtol=CROSS_RTOL,
                                   atol=CROSS_RTOL * pv)
    stdin = "\n".join(" ".join(f"{v:.17g}" for v in p) for p in q) + "\n"
    r = subprocess.run([str(native_lib / "madai_query"), state], input=stdin,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    head = 1 + D + 1 + 2 * T
    vals = np.asarray(r.stdout.splitlines()[head:], float).reshape(-1, 2 * T)
    np.testing.assert_allclose(vals[:, :T], mean, rtol=CROSS_RTOL)
    np.testing.assert_allclose(vals[:, T:], var, rtol=CROSS_RTOL,
                               atol=CROSS_RTOL * pv)


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


def _cli_files(tmp, G=None, noise=None):
    X, Y, G0, noise0, _ = _problem()
    model = str(tmp / "model.txt")
    tmf.write_model_file(model, X, Y, PNAMES, ONAMES)
    grads = str(tmp / "grads.txt")
    G = G0 if G is None else G
    # per point, per output, the d partials
    np.savetxt(grads, np.transpose(G, (0, 2, 1)).reshape(-1, D))
    nf = str(tmp / "noise.txt")
    np.savetxt(nf, noise0 if noise is None else noise)
    return model, grads, nf


def test_estimate_thetas_noise_gradients_end_to_end(snap, monkeypatch,
                                                    capsys):
    """The port's CLI from a model file, a noise file and a gradients file
    to a v3 snapshot that print_thetas, convert (text -> .npz -> text,
    byte for byte) and interactive_mode (dense) take, and that the JAX
    package serves alike; --serve_method=fast refuses it with one line."""
    tmp = snap["tmp"]
    model, grads, nf = _cli_files(tmp)
    state = str(tmp / "cli_state.txt")
    rc = tcli.main(["estimate_thetas", model, state, "--device", "cpu",
                    "--regression_order", "1", "--restarts", "2", "--steps",
                    "5", "--noise_file", nf, "--gradients_file", grads])
    cap = capsys.readouterr()
    assert rc == 0, cap.err
    assert pathlib.Path(state).read_text().startswith(
        "MADAIEMULATOR_TPU_SNAPSHOT 3\n")
    emu, _, _ = tsnap.read_snapshot(state, device=CPU)
    G = _problem()[2]
    np.testing.assert_allclose(emu.dZ.numpy(), tmv.project_gradients(
        G, emu.pca, emu.scaling).numpy(), rtol=1e-12)
    assert emu.dZ_noise is None and emu.noise is not None

    assert tcli.main(["print_thetas", state]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 + emu.n_components
    npz, back = str(tmp / "cli.npz"), str(tmp / "cli_back.txt")
    assert tcli.main(["convert", state, npz]) == 0
    assert tcli.main(["convert", npz, back]) == 0
    capsys.readouterr()
    assert pathlib.Path(back).read_bytes() == pathlib.Path(state).read_bytes()

    q = _queries(4, 9)
    stdin = "\n".join(" ".join(f"{v:.17g}" for v in p) for p in q) + "\n"
    rc, cap = _serve(monkeypatch, capsys, stdin, [state, "--device", "cpu"])
    assert rc == 0, cap.err
    vals = np.asarray(cap.out.splitlines()[1 + D + 1 + 2 * T:],
                      float).reshape(4, 2 * T)
    mean, var = (a.numpy() for a in tmv.predict_multivariate(emu, q))
    np.testing.assert_allclose(vals[:, :T], mean, rtol=1e-15)
    np.testing.assert_allclose(vals[:, T:], var, rtol=1e-15)
    emu_j, _, _ = jsnap.read_snapshot(state)
    _assert_pred((mean, var), jmv.predict_multivariate(emu_j, jnp.asarray(q)),
                 CROSS_RTOL, _prior_var(emu))
    rc, cap = _serve(monkeypatch, capsys, stdin,
                     [state, "--device", "cpu", "--serve_method", "fast"])
    err = cap.err.splitlines()
    assert rc == 2 and len(err) == 1 and "gradient-enhanced" in err[0]
    assert cap.out == ""


@pytest.mark.parametrize("case", ["noise_count", "noise_negative",
                                  "gradients_count", "matern32"])
def test_estimate_thetas_file_errors_match_jax_cli(case, tmp_path, capsys):
    """Bad --noise_file / --gradients_file inputs, and gradients with a
    once-differentiable kernel: exit 2 and one error line, the JAX CLI's
    line, in both CLIs; no state file."""
    model, grads, nf = _cli_files(
        tmp_path,
        G=np.zeros((N - 1, D, T)) if case == "gradients_count" else None,
        noise={"noise_count": np.ones(N + 1),
               "noise_negative": -np.ones(N)}.get(case))
    extra = {"matern32": ["--covariance_fn", "matern32", "--gradients_file",
                          grads],
             "gradients_count": ["--gradients_file", grads]}.get(
                 case, ["--noise_file", nf])
    lines = {}
    for name, main, dev in (("jax", jcli.main, []),
                            ("torch", tcli.main, ["--device", "cpu"])):
        state = tmp_path / f"{name}.txt"
        rc = main(["estimate_thetas", model, str(state), "--restarts", "1",
                   "--steps", "1", "--quiet"] + dev + extra)
        err = capsys.readouterr().err.splitlines()
        assert rc == 2 and not state.exists(), (name, err)
        assert len(err) == 1 and err[0].startswith("error: "), (name, err)
        lines[name] = err[0]
    assert lines["torch"] == lines["jax"]
