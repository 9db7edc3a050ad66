"""Dense .npz snapshots between the port (madaiemulator_tpu_torch/io/
snapshot.py) and the JAX package in both directions, the port's CLI on
.npz, and port-written snapshots served by the native C++ library
(`native/`, through `madaiemulator_tpu.native` as tests/test_native.py
loads it) and its `madai_query` pipe binary. All float64 on the CPU.
"""

import functools
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
from madaiemulator_tpu_torch.io import snapshot as tsnap
from madaiemulator_tpu_torch.models import multivariate as tmv
from madaiemulator_tpu_torch.models import sparse as ts
from madaiemulator_tpu_torch.utils import config as tcfg
from torch_mf_fixture import mf_emulator
import torch_shared

ROOT = pathlib.Path(__file__).resolve().parents[1]
MV = str(ROOT / "tests" / "golden" / "multivar_pca" / "state.txt")
CPU = torch.device("cpu")
# One package serving the same float64 arrays read from two encodings: the
# same arithmetic on the same numbers.
SAME_RTOL = 1e-12
# The port and the native C++ library on one snapshot: two float64
# implementations with different summation orders, at thetas fitted to
# noisy data (nugget well above the float64 rounding of the Gram).
NATIVE_RTOL = 1e-10
KEYS = ("mins", "ranges", "ymean", "ystd", "eigenvalues", "U", "X", "Z",
        "log_amp", "log_nugget", "log_ls")


def _queries(emu, m=9, seed=4):
    lo = emu.scaling.mins.numpy()
    span = emu.scaling.ranges.numpy()
    return lo + span * np.random.default_rng(seed).uniform(size=(m, lo.size))


def _with_noise(emu_t):
    """The golden emulator with a PC-space noise block (grammar version
    2)."""
    n, r = emu_t.Z.shape
    noise = np.random.default_rng(2).uniform(1e-4, 1e-3, size=(n, r))
    arrays = {k: v.numpy() for k, v in zip(KEYS, (
        emu_t.scaling.mins, emu_t.scaling.ranges, emu_t.pca.ymean,
        emu_t.pca.ystd, emu_t.pca.eigenvalues, emu_t.pca.U, emu_t.X,
        emu_t.Z, *emu_t.params))}
    arrays["noise"] = noise
    return tmv.emulator_from_numpy(arrays, emu_t.config, device=CPU)


@pytest.fixture(scope="module", params=[False, True], ids=["v1", "v2_noise"])
def pair(request, tmp_path_factory):
    """The golden emulator (and its noisy twin) written as .npz by each
    package from the same arrays."""
    tmp = tmp_path_factory.mktemp("npz")
    emu_t, pnames, onames = tsnap.read_snapshot(MV, device=CPU)
    if request.param:
        emu_t = _with_noise(emu_t)
    text = str(tmp / "state.txt")
    tsnap.write_snapshot(text, emu_t, pnames, onames)
    emu_j, _, _ = jsnap.read_snapshot(text)
    paths = {"torch": str(tmp / "torch.npz"), "jax": str(tmp / "jax.npz")}
    tsnap.write_snapshot_npz(paths["torch"], emu_t, pnames, onames)
    jsnap.write_snapshot_npz(paths["jax"], emu_j, pnames, onames)
    return dict(emu_t=emu_t, emu_j=emu_j, text=text, names=(pnames, onames),
                noise=request.param, **paths)


def test_npz_writers_agree_key_for_key(pair):
    with np.load(pair["torch"]) as a, np.load(pair["jax"]) as b:
        assert sorted(a.files) == sorted(b.files)
        assert ("noise_pc" in a.files) == pair["noise"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_npz_serves_from_jax(pair):
    emu, pnames, onames = jsnap.read_snapshot_npz(pair["torch"])
    assert (pnames, onames) == pair["names"]
    q = _queries(pair["emu_t"])
    got = jmv.predict_multivariate(emu, jnp.asarray(q))
    want = jmv.predict_multivariate(pair["emu_j"], jnp.asarray(q))
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=SAME_RTOL, atol=1e-300)


def test_jax_npz_serves_from_port(pair):
    emu, pnames, onames = tsnap.read_snapshot_npz(pair["jax"], device=CPU)
    assert (pnames, onames) == pair["names"]
    assert (emu.noise is not None) == pair["noise"]
    q = _queries(pair["emu_t"])
    got = tmv.predict_multivariate(emu, q)
    want = tmv.predict_multivariate(pair["emu_t"], q)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=SAME_RTOL,
                                   atol=1e-300)


def test_auto_routes_by_extension(pair, tmp_path):
    emu, _, _ = tsnap.read_snapshot_auto(pair["torch"], device=CPU,
                                         build_states=False)
    # the stateless container is the matrix-free emulator, as in JAX
    assert isinstance(emu, tmv.IterativeMultivariateEmulator)
    out = str(tmp_path / "again.npz")
    tsnap.write_snapshot_auto(out, emu, *pair["names"])
    back = str(tmp_path / "again.txt")
    tsnap.write_snapshot_auto(back, emu, *pair["names"])
    assert (pathlib.Path(back).read_bytes()
            == pathlib.Path(pair["text"]).read_bytes())
    with np.load(out) as a, np.load(pair["jax"]) as b:
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_convert_text_npz_text_matches_jax_cli(tmp_path, capsys):
    """convert text -> .npz -> text: the port's CLI writes what the JAX
    CLI writes, byte for byte in text and key for key in .npz."""
    out = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        npz = str(tmp_path / f"{name}.npz")
        txt = str(tmp_path / f"{name}.txt")
        assert main(["convert", MV, npz]) == 0
        assert main(["convert", npz, txt]) == 0
        out[name] = (npz, pathlib.Path(txt).read_bytes())
    capsys.readouterr()
    assert out["torch"][1] == out["jax"][1] == pathlib.Path(MV).read_bytes()
    with np.load(out["torch"][0]) as a, np.load(out["jax"][0]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


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


def test_interactive_mode_on_npz_matches_text(pair, monkeypatch, capsys):
    q = _queries(pair["emu_t"], m=4)
    stdin = "\n".join(" ".join(f"{v:.17g}" for v in p) for p in q) + "\n"
    rc_t, text = _serve(monkeypatch, capsys, stdin,
                        [pair["text"], "--device", "cpu"])
    rc_n, npz = _serve(monkeypatch, capsys, stdin,
                       [pair["torch"], "--device", "cpu"])
    assert rc_t == rc_n == 0, text.err + npz.err
    assert npz.out == text.out
    assert len(npz.out.splitlines()) == 1 + 3 + 1 + 12 + 4 * 12


@functools.cache
def _sparse_emulator():
    """A small sparse (SGPR) emulator fitted by the port (float64, CPU),
    fitted once per process."""
    rng = np.random.default_rng(9)
    X = rng.uniform(1.0, 3.0, size=(40, 2))
    Y = np.stack([np.sin(2 * X[:, 0]) + X[:, 1], X[:, 0] * X[:, 1],
                  np.cos(X[:, 1])], axis=1)
    Y = Y + 0.02 * rng.standard_normal(Y.shape)
    cfg = tcfg.GPConfig(nparams=2, regression_order=1, n_restarts=2,
                        max_opt_steps=10)
    return ts.fit_multivariate_sparse(
        torch.Generator().manual_seed(0), torch.tensor(X), torch.tensor(Y),
        cfg, pca_variance=0.999, inducing=12)


def _npz_grammar(tmp_path, what):
    """An .npz snapshot of another grammar than the dense one: a real
    multi-fidelity (version 2) or sparse one."""
    p = str(tmp_path / "state.npz")
    if what == "sparse":
        tsnap.write_snapshot_sparse_npz(p, _sparse_emulator(), ["a", "b"],
                                        ["o0", "o1", "o2"])
        return p
    tsnap.write_snapshot_multifidelity_mv_npz(
        p, mf_emulator(multivariate=True), ["a", "b"], ["o0", "o1", "o2"])
    return p


@pytest.mark.parametrize("command", ["print_thetas", "interactive_mode",
                                     "convert"])
@pytest.mark.parametrize("what", ["multi-fidelity", "sparse"])
def test_unported_npz_grammars_exit_2(tmp_path, capsys, monkeypatch, command,
                                      what):
    """Both other grammars' .npz snapshots (ported) run on every command:
    print_thetas prints, interactive_mode serves, convert writes the
    grammar's text form. The dense .npz reader refuses both grammars by
    name."""
    state = _npz_grammar(tmp_path, what)
    if command == "interactive_mode":
        rc, cap = _serve(monkeypatch, capsys, "1.5 2.5\n",
                         [state, "--device", "cpu"])
        assert len(cap.out.splitlines()) == 1 + 2 + 1 + 6 + 6
    else:
        argv = [state] + ([str(tmp_path / "o.txt")]
                          if command == "convert" else [])
        rc = tcli.main([command] + argv)
        cap = capsys.readouterr()
    assert rc == 0, cap.err
    if command == "print_thetas":
        assert cap.out.startswith("# 3 component(s)" if what == "sparse"
                                  else "# 2 fidelity level(s) x 3 "
                                  "component(s)")
    if command == "convert":
        assert (tmp_path / "o.txt").read_text().startswith(
            tsnap.MAGIC_SGPR + " 1\n" if what == "sparse"
            else tsnap.MAGIC_MF + " 2\n")
    with pytest.raises(ValueError, match=what):
        tsnap.read_snapshot_npz(state, device=CPU)


# --- a port-written snapshot served by native/ ------------------------------


@pytest.fixture(scope="module")
def native_lib(tmp_path_factory):
    """This process's private build of native/ (the library and
    madai_query)."""
    return torch_shared.native_build(tmp_path_factory)


@pytest.fixture(scope="module")
def port_snapshot(tmp_path_factory):
    """A multivariate emulator fitted by the port (float64, CPU) on noisy
    data and written by the port's text writer; the v2 twin carries a
    PC-space noise block."""
    rng = np.random.default_rng(8)
    X = rng.uniform(1.0, 3.0, size=(30, 2))
    Y = np.stack([np.sin(2 * X[:, 0]) + X[:, 1], X[:, 0] * X[:, 1],
                  X[:, 1] ** 2], axis=1)
    Y = Y + 0.02 * rng.standard_normal(Y.shape)
    cfg = tcfg.GPConfig(nparams=2, regression_order=1, n_restarts=2,
                        max_opt_steps=20)
    emu = tmv.fit_multivariate(torch.Generator().manual_seed(0),
                               torch.tensor(X), torch.tensor(Y), cfg,
                               pca_variance=0.999)
    tmp = tmp_path_factory.mktemp("port_state")
    paths = {}
    for name, e in (("v1", emu), ("v2_noise", _with_noise(emu))):
        paths[name] = str(tmp / f"{name}.txt")
        tsnap.write_snapshot(paths[name], e, ["a", "b"], ["o0", "o1", "o2"])
    return emu, paths


@pytest.mark.parametrize("version", ["v1", "v2_noise"])
def test_port_snapshot_serves_from_native(native_lib, port_snapshot,
                                          monkeypatch, version):
    """Through libmadai_emu.so (madaiemulator_tpu.native's ctypes binding,
    pointed at the private build) and through the madai_query pipe binary:
    the port's own predictions on the same snapshot to 1e-10."""
    emu0, paths = port_snapshot
    state = paths[version]
    emu, _, _ = tsnap.read_snapshot(state, device=CPU)
    q = _queries(emu0, m=6)
    mean, var = (a.numpy() for a in tmv.predict_multivariate(emu, q))
    vscale = float(var.max())

    monkeypatch.setattr(native, "_LIB_PATH", native_lib / "libmadai_emu.so")
    monkeypatch.setattr(native, "_lib", None)
    ne = native.NativeEmulator(state)
    assert ne.nparams == 2 and ne.noutputs == 3
    for i in range(q.shape[0]):
        mc, vc = ne.query(q[i])
        np.testing.assert_allclose(mc, mean[i], rtol=NATIVE_RTOL)
        np.testing.assert_allclose(vc, var[i], rtol=NATIVE_RTOL,
                                   atol=NATIVE_RTOL * vscale)

    stdin = "\n".join(" ".join(f"{v:.17g}" for v in p) for p in q) + "\n"
    r = subprocess.run([str(native_lib / "madai_query"), state], input=stdin,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    head = 1 + 2 + 1 + 6
    assert lines[:head] == ["2", "a", "b", "6", "mean_o0", "mean_o1",
                            "mean_o2", "variance_o0", "variance_o1",
                            "variance_o2"]
    vals = np.asarray(lines[head:], float).reshape(q.shape[0], 6)
    np.testing.assert_allclose(vals[:, :3], mean, rtol=NATIVE_RTOL)
    np.testing.assert_allclose(vals[:, 3:], var, rtol=NATIVE_RTOL,
                               atol=NATIVE_RTOL * vscale)


def test_port_sparse_snapshot_serves_from_native(native_lib, monkeypatch,
                                                 tmp_path):
    """A sparse (SGPR) snapshot written by the port, served by
    libmadai_emu.so and madai_query: the port's predictions to 1e-10."""
    emu = _sparse_emulator()
    state = str(tmp_path / "sgpr.txt")
    tsnap.write_snapshot_sparse(state, emu, ["a", "b"], ["o0", "o1", "o2"])
    served, _, _ = tsnap.read_snapshot_auto(state, device=CPU)
    q = 1.2 + 1.6 * np.random.default_rng(3).uniform(size=(6, 2))
    mean, var = (a.numpy() for a in ts.predict_multivariate_sparse(served,
                                                                   q))
    vscale = float(var.max())
    monkeypatch.setattr(native, "_LIB_PATH", native_lib / "libmadai_emu.so")
    monkeypatch.setattr(native, "_lib", None)
    ne = native.NativeEmulator(state)
    assert ne.nparams == 2 and ne.noutputs == 3
    for i in range(q.shape[0]):
        mc, vc = ne.query(q[i])
        np.testing.assert_allclose(mc, mean[i], rtol=NATIVE_RTOL)
        np.testing.assert_allclose(vc, var[i], rtol=NATIVE_RTOL,
                                   atol=NATIVE_RTOL * vscale)
    stdin = "\n".join(" ".join(f"{v:.17g}" for v in p) for p in q) + "\n"
    r = subprocess.run([str(native_lib / "madai_query"), state], input=stdin,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    vals = np.asarray(r.stdout.splitlines()[10:], float).reshape(-1, 6)
    np.testing.assert_allclose(vals[:, :3], mean, rtol=NATIVE_RTOL)
    np.testing.assert_allclose(vals[:, 3:], var, rtol=NATIVE_RTOL,
                               atol=NATIVE_RTOL * vscale)


@pytest.mark.parametrize("version", ["v1", "v2"])
def test_port_multifidelity_snapshot_serves_from_native(native_lib,
                                                        monkeypatch,
                                                        tmp_path, version):
    """A multi-fidelity snapshot written by the port (version 1 scalar,
    version 2 multivariate), served by libmadai_emu.so and madai_query:
    the port's recursive predictions at the top level to 1e-10."""
    from madaiemulator_tpu_torch.models import multifidelity as tmfm

    state = str(tmp_path / "mf.txt")
    if version == "v1":
        emu, outs = mf_emulator(multivariate=False), ["o0"]
        tsnap.write_snapshot_auto(state, emu, ["a", "b"], outs)
    else:
        emu, outs = mf_emulator(multivariate=True), ["o0", "o1", "o2"]
        tsnap.write_snapshot_auto(state, emu, ["a", "b"], outs)
    served, _, _ = tsnap.read_snapshot_auto(state, device=CPU)
    q = 1.2 + 1.6 * np.random.default_rng(3).uniform(size=(6, 2))
    if version == "v1":
        m, v = tmfm.predict_multifidelity(served, q)
        mean, var = m.numpy()[:, None], v.numpy()[:, None]
    else:
        mean, var = (a.numpy() for a in
                     tmfm.predict_multivariate_multifidelity(served, q))
    vscale = float(var.max())
    monkeypatch.setattr(native, "_LIB_PATH", native_lib / "libmadai_emu.so")
    monkeypatch.setattr(native, "_lib", None)
    ne = native.NativeEmulator(state)
    t = len(outs)
    assert ne.nparams == 2 and ne.noutputs == t
    for i in range(q.shape[0]):
        mc, vc = ne.query(q[i])
        np.testing.assert_allclose(mc, mean[i], rtol=NATIVE_RTOL)
        np.testing.assert_allclose(vc, var[i], rtol=NATIVE_RTOL,
                                   atol=NATIVE_RTOL * vscale)
    stdin = "\n".join(" ".join(f"{v:.17g}" for v in p) for p in q) + "\n"
    r = subprocess.run([str(native_lib / "madai_query"), state], input=stdin,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    head = 1 + 2 + 1 + 2 * t
    assert lines[:head] == (["2", "a", "b", str(2 * t)]
                            + [f"mean_{s}" for s in outs]
                            + [f"variance_{s}" for s in outs])
    vals = np.asarray(lines[head:], float).reshape(q.shape[0], 2 * t)
    np.testing.assert_allclose(vals[:, :t], mean, rtol=NATIVE_RTOL)
    np.testing.assert_allclose(vals[:, t:], var, rtol=NATIVE_RTOL,
                               atol=NATIVE_RTOL * vscale)
