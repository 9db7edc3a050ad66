"""GEMM-only fast serving on the port (madaiemulator_tpu_torch/models/gp.py
`FastPredictorState` .. `predict_fast`, models/multivariate.py
`precompute_fast_multivariate` / `predict_multivariate_fast`, and
`interactive_mode --serve_method=fast`) against the JAX package and against
the port's dense route, float64 on the CPU (float32 on the CPU for the
`tri_inv_block` route against the dense route).

One synthetic emulator, N=40 in d=3 with t=4 outputs at a nugget of 1e-4 x
amp, written by the port and read by both packages; one JAX compile of each
fast function, in module-scoped fixtures.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu.io import snapshot as jsnap
from madaiemulator_tpu.models import gp as jgp
from madaiemulator_tpu.models import multivariate as jmv
from madaiemulator_tpu.ops import kernels as jk
from madaiemulator_tpu.utils import config as jcfg
from madaiemulator_tpu_torch import cli as tcli
from madaiemulator_tpu_torch.io import snapshot as tsnap
from madaiemulator_tpu_torch.models import gp as tgp
from madaiemulator_tpu_torch.models import multivariate as tmv
from madaiemulator_tpu_torch.ops import kernels as tk
from madaiemulator_tpu_torch.utils import config as tcfg
import torch_shared  # noqa: F401

CPU = torch.device("cpu")
N, D, T, M = 40, 3, 4, 25
# The two packages on the same float64 states: the same products in other
# summation orders (cond ~1e5 at nugget 1e-4).
JAX_RTOL = 1e-10
# Fast against dense in one package: an explicit inverse applied by a GEMM
# against a substitution, both float64 (the JAX package's own parity
# bounds, tests/test_gp.py:298).
DENSE_MEAN_RTOL = 1e-9
DENSE_VAR_RTOL = 1e-7
# float32: tri_inv_block's inverse against the substitution, at the scale of
# the mean and of the prior variance.
F32_TOL = 1e-3


def _arrays(rng):
    X = rng.uniform(size=(N, D))
    lat = np.stack([np.sin(3 * X[:, 0]) + X[:, 1], X[:, 1] * X[:, 2],
                    np.cos(2 * X[:, 2])], axis=1)
    Y = lat @ rng.standard_normal((3, T)) + 1e-3 * rng.standard_normal((N, T))
    pca, Z = tmv.pca_decompose(Y, 0.999)
    r = Z.shape[1]
    return dict(mins=np.full(D, -1.0), ranges=np.full(D, 2.0), X=X, Z=Z,
                ymean=pca.ymean, ystd=pca.ystd, eigenvalues=pca.eigenvalues,
                U=pca.U, log_amp=np.zeros(r), log_nugget=np.full(r, -9.2),
                log_ls=np.log(rng.uniform(0.3, 0.6, (r, D))))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(21)
    cfg = tcfg.GPConfig(nparams=D, regression_order=1)
    emu_t = tmv.emulator_from_numpy(_arrays(rng), cfg, device=CPU)
    state = str(tmp_path_factory.mktemp("fast") / "state.txt")
    tsnap.write_snapshot(state, emu_t)
    emu_j, _, _ = jsnap.read_snapshot(state)
    q = -1.0 + 2.0 * rng.uniform(size=(M, D))
    fast_j = jmv.precompute_fast_multivariate(emu_j)
    fast_t = tmv.precompute_fast_multivariate(emu_t)
    want = jmv.predict_multivariate_fast(emu_j, fast_j, jnp.asarray(q))
    got = tmv.predict_multivariate_fast(emu_t, fast_t, q)
    return dict(emu_t=emu_t, emu_j=emu_j, state=state, q=q, fast_t=fast_t,
                fast_j=fast_j, want=[np.asarray(a) for a in want],
                got=[a.numpy() for a in got])


def test_fast_states_match_jax(case):
    for name in ("Linv", "LAinv"):
        a = getattr(case["fast_t"], name).numpy()
        b = np.asarray(getattr(case["fast_j"], name))
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=JAX_RTOL * np.abs(b).max(),
                                   err_msg=name)
        assert np.array_equal(a, np.tril(a))


def test_predict_multivariate_fast_matches_jax(case):
    (mt, vt), (mj, vj) = case["got"], case["want"]
    assert mt.shape == vt.shape == (M, T)
    np.testing.assert_allclose(mt, mj, rtol=JAX_RTOL)
    np.testing.assert_allclose(vt, vj, rtol=JAX_RTOL,
                               atol=JAX_RTOL * np.abs(vj).max())


def test_predict_multivariate_fast_matches_dense(case):
    mt, vt = case["got"]
    md, vd = (a.numpy() for a in tmv.predict_multivariate(case["emu_t"],
                                                          case["q"]))
    np.testing.assert_allclose(mt, md, rtol=DENSE_MEAN_RTOL)
    np.testing.assert_allclose(vt, vd, rtol=DENSE_VAR_RTOL,
                               atol=1e-12 * np.abs(vd).max())


def _scalar(case, dtype=torch.float64):
    """Component 0 of the emulator as one GP, in both packages."""
    e = case["emu_t"]
    pt = tk.GPParams(*(a[0].to(dtype) for a in e.params))
    dt = tgp.GPData(X=e.X.to(dtype), y=e.Z[:, 0].to(dtype))
    pj = jk.GPParams(*(jnp.asarray(a[0].numpy()) for a in e.params))
    dj = jgp.GPData(X=jnp.asarray(e.X.numpy()), y=jnp.asarray(e.Z[:, 0]))
    Xs = (case["q"] + 1.0) / 2.0
    return pt, dt, pj, dj, Xs


@pytest.mark.parametrize("chunk", [None, 7])
def test_predict_fast_matches_jax_and_dense(case, chunk):
    """One GP, unchunked and in query chunks of 7 (the last one partial):
    against the JAX predict_fast at the same chunking and the port's dense
    route."""
    pt, dt, pj, dj, Xs = _scalar(case)
    ct = tcfg.GPConfig(nparams=D, regression_order=1,
                       predict_query_chunk=chunk)
    cj = jcfg.GPConfig(nparams=D, regression_order=1,
                       predict_query_chunk=chunk)
    fp = tgp.precompute_fast_predictor(pt, dt, ct)
    mt, vt = tgp.predict_fast(fp, pt, dt, torch.tensor(Xs), ct)
    mj, vj = jax.jit(
        lambda p, d, x: jgp.predict_fast(
            jgp.precompute_fast_predictor(p, d, cj), p, d, x, cj),
    )(pj, dj, jnp.asarray(Xs))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=JAX_RTOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=JAX_RTOL,
                               atol=JAX_RTOL * float(np.abs(vj).max()))
    md, vd = tgp.predict_from_precomputed(fp.base, pt, dt, torch.tensor(Xs),
                                          ct)
    np.testing.assert_allclose(mt.numpy(), md.numpy(), rtol=DENSE_MEAN_RTOL)
    np.testing.assert_allclose(vt.numpy(), vd.numpy(), rtol=DENSE_VAR_RTOL,
                               atol=1e-12)


def test_predict_fast_float32_tri_inv_route(case):
    """float32 forms Linv and LAinv by tri_inv_block (the plain products on
    the CPU): against the float32 dense route."""
    pt, dt, _, _, Xs = _scalar(case, torch.float32)
    ct = tcfg.GPConfig(nparams=D, regression_order=1)
    fp = tgp.precompute_fast_predictor(pt, dt, ct)
    q = torch.tensor(Xs, dtype=torch.float32)
    mt, vt = tgp.predict_fast(fp, pt, dt, q, ct)
    md, vd = tgp.predict_from_precomputed(fp.base, pt, dt, q, ct)
    scale = max(1.0, md.abs().max().item())
    assert (mt - md).abs().max().item() <= F32_TOL * scale
    assert (vt - vd).abs().max().item() <= F32_TOL  # prior variance 1


def test_predict_fast_rejects_gradient_data(case):
    pt, dt, _, _, Xs = _scalar(case)
    ct = tcfg.GPConfig(nparams=D, regression_order=1)
    fp = tgp.precompute_fast_predictor(pt, dt, ct)
    with pytest.raises(ValueError, match="gradient-enhanced"):
        tgp.predict_fast(fp, pt, dt._replace(dY=torch.zeros(N, D,
                                                            dtype=torch.float64)),
                         torch.tensor(Xs), ct)
    with pytest.raises(ValueError, match="h_extra"):
        tgp.predict_fast(fp, pt, dt._replace(h_extra=dt.X), torch.tensor(Xs),
                         ct)
    e = case["emu_t"]
    with pytest.raises(ValueError, match="gradient-enhanced"):
        tmv.precompute_fast_multivariate(e._replace(dZ=torch.zeros(N, D, 1)))


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


def test_interactive_mode_fast_equals_dense(case, monkeypatch, capsys):
    """The pipe protocol with --serve_method=fast: the same header, and
    answers equal to the dense route's to the fast-vs-dense bounds."""
    stdin = "\n".join(" ".join(f"{v:.17g}" for v in p)
                      for p in case["q"]) + "\n"
    outs = {}
    for method in ("dense", "fast"):
        rc, cap = _serve(monkeypatch, capsys, stdin,
                         [case["state"], "--device", "cpu", "--serve_method",
                          method])
        assert rc == 0, cap.err
        outs[method] = cap.out.splitlines()
    head = 1 + D + 1 + 2 * T
    assert outs["fast"][:head] == outs["dense"][:head]
    fast, dense = (np.asarray(outs[k][head:], float).reshape(M, 2 * T)
                   for k in ("fast", "dense"))
    np.testing.assert_allclose(fast[:, :T], dense[:, :T],
                               rtol=DENSE_MEAN_RTOL)
    np.testing.assert_allclose(fast[:, T:], dense[:, T:],
                               rtol=DENSE_VAR_RTOL,
                               atol=1e-12 * np.abs(dense[:, T:]).max())
    # and the in-process fast answers
    np.testing.assert_allclose(fast[:, :T], case["got"][0],
                               rtol=1e-12)


def test_fast_state_is_batched_over_components(case):
    """precompute_fast_multivariate inverts every component's factor in one
    batched call: each member equals its component's own inversion."""
    e = case["emu_t"]
    for i in range(e.n_components):
        st_i = tgp.GPPosteriorState(*(a[i] for a in e.states))
        one = tgp.fast_predictor_from_state(st_i)
        assert torch.equal(one.Linv, case["fast_t"].Linv[i])
        assert torch.equal(one.LAinv, case["fast_t"].LAinv[i])
