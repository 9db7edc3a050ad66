"""The port's matrix-free GP (madaiemulator_tpu_torch/models/iterative.py)
against the JAX package's (madaiemulator_tpu/models/iterative.py) on the
CPU at float64, case for case with tests/test_iterative.py: the same seeded
numpy inputs go through both.

The two packages draw their random probes from different generators, so a
stochastic estimate is compared either in exact-probe mode (probes >= N:
canonical-basis probes) or with the JAX package's own draws handed to the
port's `_draw_probes` (the same fold_in recipe, as numpy). Each JAX
likelihood reference is one jitted value-and-gradient taking the data as an
argument, built once per module; every other JAX reference is jitted too
(a jitted call compiles once, where the same call run eagerly compiles
each of its loops and operations apart, several times slower).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu.models import fit as jfit
from madaiemulator_tpu.models import gp as jgp
from madaiemulator_tpu.models import iterative as ji
from madaiemulator_tpu.ops import kernels as jk
from madaiemulator_tpu.utils import config as jcfg
from madaiemulator_tpu_torch.models import fit as tfit
from madaiemulator_tpu_torch.models import gp as tgp
from madaiemulator_tpu_torch.models import iterative as ti
from madaiemulator_tpu_torch.ops import kernels as tk
from madaiemulator_tpu_torch.utils import config as tcfg
import torch_shared  # noqa: F401

CPU = torch.device("cpu")
# the issue's parity tolerances at float64: values, gradients (relative)
RTOL_V, RTOL_G = 1e-8, 1e-7
EXACT = dict(seed=0, cg_tol=1e-12, cg_max_iters=400)


def _problem(n, d=2, nugget=1e-2, seed=0, noise=False):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    y = np.sin(3 * X[:, 0]) + 0.5 * X[:, 1] + 0.05 * rng.standard_normal(n)
    nz = 10.0 ** rng.uniform(-3, -1, size=n) if noise else None
    theta = (np.log(1.3), np.log(nugget), np.log(np.array([0.6, 0.9])[:d]))
    return X, y, nz, theta


def _jax(X, y, nz, theta, reml=False):
    cfg = jcfg.GPConfig(nparams=X.shape[1], regression_order=1, reml=reml)
    data = jgp.GPData(X=jnp.asarray(X), y=jnp.asarray(y),
                      noise=None if nz is None else jnp.asarray(nz))
    return cfg, data, jk.GPParams(*(jnp.asarray(t) for t in theta))


def _torch(X, y, nz, theta, reml=False):
    cfg = tcfg.GPConfig(nparams=X.shape[1], regression_order=1, reml=reml)
    data = tgp.GPData(X=torch.tensor(X), y=torch.tensor(y),
                      noise=None if nz is None else torch.tensor(nz))
    return cfg, data, tk.GPParams(*(torch.tensor(t) for t in theta))


def _close(got, want, rtol=RTOL_V, atol=1e-13):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _jit(fn, *args):
    """fn(*args) as one jitted JAX program."""
    return jax.jit(fn)(*args)


def _value_and_grad(f, params):
    leaves = [t.clone().requires_grad_(True) for t in params]
    v = f(tk.GPParams(*leaves))
    return v.item(), [g.numpy() for g in torch.autograd.grad(v, leaves)]


def _jax_draws(seed, stream, n, probes, rank):
    """The JAX package's probes, as `_draw_probes` hands them over:
    key(seed) for SLQ, fold_in(key, 1) for the backward's Hutchinson
    probes, split(fold_in(key, 2)) for the mBCG normals."""
    key = jax.random.key(seed)
    if stream == "mbcg":
        k1, k2 = jax.random.split(jax.random.fold_in(key, 2))
        return (np.asarray(jax.random.normal(k1, (rank, probes),
                                             jnp.float64)),
                np.asarray(jax.random.normal(k2, (n, probes), jnp.float64)))
    if stream == "hutchinson":
        key = jax.random.fold_in(key, 1)
    return (np.asarray(jnp.where(jax.random.bernoulli(key, 0.5, (n, probes)),
                                 1.0, -1.0)),)


@pytest.mark.parametrize("noise", [False, True])
def test_gram_matvec_matches_jax(noise):
    X, y, nz, th = _problem(37, noise=noise)
    cj, dj, pj = _jax(X, y, nz, th)
    ct, dt, pt = _torch(X, y, nz, th)
    V = np.random.default_rng(1).standard_normal((37, 3))
    want = _jit(lambda X, p, V, nz: ji.gram_matvec(X, p, cj, V, row_chunk=8,
                                                   noise=nz),
                dj.X, pj, jnp.asarray(V), dj.noise)
    got = ti.gram_matvec(dt.X, pt, ct, torch.tensor(V), row_chunk=8,
                         noise=dt.noise)
    _close(got, want)
    C = tk.gram_matrix(dt.X, pt, ct).numpy() + (np.diag(nz) if noise
                                                  else 0.0)
    _close(got, C @ V)
    # the vector form and the default chunk
    _close(ti.gram_matvec(dt.X, pt, ct, torch.tensor(V[:, 0]),
                          noise=dt.noise), C @ V[:, 0])


def test_pivoted_cholesky_same_pivots():
    X, y, nz, th = _problem(40)
    cj, dj, pj = _jax(X, y, nz, th)
    ct, dt, pt = _torch(X, y, nz, th)
    K = tk.cross_covariance(dt.X, dt.X, pt, ct).numpy()
    Lj = np.asarray(_jit(lambda X, p: ji.pivoted_cholesky(X, p, cj, 40),
                         dj.X, pj))
    for rank, tol in [(10, 0.5), (40, 1e-6)]:
        Lt = ti.pivoted_cholesky(dt.X, pt, ct, rank).numpy()
        # the same pivots in the same order: the columns agree one by one
        # (a rank-k factor is the first k columns of a longer one). At full
        # rank the last columns are residuals of ~1e-9 where the kernel is
        # exhausted, so they are held to RTOL_V x max|L|.
        _close(Lt, Lj[:, :rank], atol=RTOL_V * np.abs(Lj).max())
        err = np.abs(0.5 * (K + K.T) - Lt @ Lt.T).max() / np.abs(K).max()
        assert err < tol, (rank, err)


def test_pcg_matches_jax():
    X, y, nz, th = _problem(45)
    cj, dj, pj = _jax(X, y, nz, th)
    ct, dt, pt = _torch(X, y, nz, th)
    B = np.random.default_rng(2).standard_normal((45, 4))
    da = float(np.exp(th[1]))

    def jax_pcg(X, p, B):
        pre = ji.make_preconditioner(ji.pivoted_cholesky(X, p, cj, 20),
                                     jnp.asarray(da))
        return ji.pcg_solve(lambda V: ji.gram_matvec(X, p, cj, V), B, pre,
                            tol=1e-10)

    Xj, relj, itj = _jit(jax_pcg, dj.X, pj, jnp.asarray(B))
    pre_t = ti.make_preconditioner(ti.pivoted_cholesky(dt.X, pt, ct, 20),
                                   torch.tensor(da, dtype=torch.float64))
    mv_t = lambda V: ti.gram_matvec(dt.X, pt, ct, V)  # noqa: E731
    Xt, relt, itt = ti.pcg_solve(mv_t, torch.tensor(B), pre_t, tol=1e-10)
    assert itt == int(itj)
    _close(Xt, Xj)
    assert float(relt.max()) < 1e-10 and float(np.max(relj)) < 1e-10
    C = tk.gram_matrix(dt.X, pt, ct).numpy()
    _close(Xt, np.linalg.solve(C, B), rtol=1e-6, atol=1e-8)
    # plain CG reaches the same solution in more iterations
    X0, rel0, it0 = ti.pcg_solve(mv_t, torch.tensor(B), None, tol=1e-10)
    assert float(rel0.max()) < 1e-10 and itt <= it0
    _close(X0, Xt, rtol=1e-6, atol=1e-8)


def test_pcg_freezes_on_indefinite_preconditioner_apply():
    """rz <= 0 (an indefinite applied P^-1) is breakdown: every column
    freezes at its initial iterate with rel ~ 1, as in the JAX package."""
    n = 16
    B = np.random.default_rng(3).standard_normal((n, 3))
    # Lk Lk^T = 2 I but M_chol = sqrt(0.5) I: solve(V) = -3 V
    lying = [mod.Preconditioner(Lk=f(np.sqrt(2.0) * np.eye(n)),
                                sigma2=f(np.asarray(1.0)),
                                M_chol=f(np.sqrt(0.5) * np.eye(n)))
             for mod, f in ((ji, jnp.asarray), (ti, torch.tensor))]
    Xj, relj, itj = _jit(lambda B, pre: ji.pcg_solve(
        lambda V: 2.0 * V, B, pre, tol=1e-10, max_iters=64),
        jnp.asarray(B), lying[0])
    Xt, relt, itt = ti.pcg_solve(lambda V: 2.0 * V, torch.tensor(B),
                                 lying[1], tol=1e-10, max_iters=64)
    np.testing.assert_array_equal(Xt.numpy(), 0.0)
    assert bool((relt >= 0.99).all()) and itt <= 2
    assert itt == int(itj)
    _close(Xt, Xj)
    _close(relt, relj)


@pytest.mark.parametrize("ridge", ["scalar", "vector"])
def test_preconditioner_solve_and_logdet(ridge):
    rng = np.random.default_rng(4)
    n, k = 33, 8
    Lk = rng.standard_normal((n, k)) * 0.7
    s2 = 0.3 if ridge == "scalar" else 10.0 ** rng.uniform(-3, 0, size=n)
    V = rng.standard_normal((n, 2))
    pj = _jit(lambda L, s, V: (lambda pre: (pre, pre.solve(V), pre.logdet(),
                                            pre.ridge_sqrt()))(
        ji.make_preconditioner(L, s)), jnp.asarray(Lk), jnp.asarray(s2),
        jnp.asarray(V))
    pt = ti.make_preconditioner(torch.tensor(Lk),
                                torch.tensor(s2, dtype=torch.float64))
    _close(pt.sigma2, pj[0].sigma2, rtol=0)
    _close(pt.solve(torch.tensor(V)), pj[1])
    _close(pt.logdet(), pj[2])
    _close(pt.ridge_sqrt(), pj[3])
    P = Lk @ Lk.T + np.diag(np.broadcast_to(pt.sigma2.numpy(), (n,)))
    _close(pt.solve(torch.tensor(V)), np.linalg.solve(P, V), atol=1e-10)
    _close(pt.logdet(), np.linalg.slogdet(P)[1], rtol=1e-10)


def test_preconditioner_conditioning_floor():
    """The ridge floor lambda_1 / max_cond: raised where the capacitance
    would be ill-conditioned, untouched otherwise, as in the JAX package."""
    rng = np.random.default_rng(5)
    Lk = rng.standard_normal((40, 6)) * 30.0
    for s2, cond in ((1e-9, None), (1e-9, 1e6), (0.5, None)):
        pj = _jit(lambda L, s: ji.make_preconditioner(L, s, cond),
                  jnp.asarray(Lk), jnp.asarray(s2))
        pt = ti.make_preconditioner(torch.tensor(Lk),
                                    torch.tensor(s2, dtype=torch.float64),
                                    cond)
        _close(pt.sigma2, pj.sigma2)
        _close(pt.M_chol, pj.M_chol)
    assert float(pt.sigma2) == 0.5


def test_slq_logdet_exact_mode():
    X, y, nz, th = _problem(32)
    cj, dj, pj = _jax(X, y, nz, th)
    ct, dt, pt = _torch(X, y, nz, th)
    want = _jit(lambda X, p: ji.slq_logdet(
        lambda V: ji.gram_matvec(X, p, cj, V), 32, jax.random.key(0),
        probes=32, lanczos_iters=32, dtype=jnp.float64), dj.X, pj)
    got = ti.slq_logdet(lambda V: ti.gram_matvec(dt.X, pt, ct, V), 32, 0,
                        probes=32, lanczos_iters=32, dtype=torch.float64,
                        device=CPU)
    _close(got, want)
    C = tk.gram_matrix(dt.X, pt, ct).numpy()
    _close(got, np.linalg.slogdet(C)[1], rtol=1e-6)


def test_mbcg_quadrature_matches_lanczos_and_jax():
    """CG-derived tridiagonals (no preconditioner, full iterations) give the
    direct Lanczos quadrature z^T log(C) z, and the JAX package's
    quadrature from the same CG coefficients."""
    X, y, nz, th = _problem(40)
    cj, dj, pj = _jax(X, y, nz, th)
    ct, dt, pt = _torch(X, y, nz, th)
    mv = lambda V: ti.gram_matvec(dt.X, pt, ct, V)  # noqa: E731
    Z = np.where(np.random.default_rng(6).uniform(size=(40, 4)) < 0.5,
                 -1.0, 1.0)
    a, b = ti._lanczos_tridiag_batched(mv, torch.tensor(Z), 40)
    direct = ti._tridiag_quadrature(a, b, torch.tensor((Z * Z).sum(0)))
    _, _, _, (At, Bt, steps) = ti.pcg_solve(mv, torch.tensor(Z), None,
                                            tol=1e-30, max_iters=40,
                                            track_tridiag=True)
    w = torch.tensor((Z * Z).sum(0))
    quads = ti.mbcg_quadrature(At, Bt, steps, w)
    _close(quads, direct, rtol=1e-6)
    _close(quads, _jit(ji.mbcg_quadrature, *(jnp.asarray(t.numpy()) for t in
                                             (At, Bt, steps, w))))
    C = tk.gram_matrix(dt.X, pt, ct).numpy()
    exact = np.linalg.slogdet(C)[1]
    assert abs(quads.mean().item() - exact) < 0.15 * max(abs(exact), 10.0)


# ML on a homogeneous nugget; REML with per-point noise (the vector-ridge
# preconditioner and the REML term of the backward in one case)
_LML_CASES = {"ml": (False, False), "noise_reml": (True, True)}


@pytest.fixture(scope="module")
def jax_lml():
    """One jitted JAX value-and-gradient per (REML, noise, estimator)
    setting, the data an argument."""
    cache = {}

    def get(reml, cfg, **kw):
        key = (reml, tuple(sorted(kw.items())))
        if key not in cache:
            cache[key] = jax.jit(jax.value_and_grad(
                lambda p, d: ji.lml_iterative(p, d, cfg, **kw)))
        return cache[key]

    return get


@pytest.mark.parametrize("case", sorted(_LML_CASES))
def test_lml_iterative_exact_probes_matches_jax(case, jax_lml):
    """Exact-probe mode (probes = rank = lanczos_iters = N): value and
    gradient against the JAX package, and against the dense likelihood."""
    reml, noise = _LML_CASES[case]
    n = 30
    X, y, nz, th = _problem(n, noise=noise)
    cj, dj, pj = _jax(X, y, nz, th, reml)
    ct, dt, pt = _torch(X, y, nz, th, reml)
    kw = dict(EXACT, rank=n, probes=n, lanczos_iters=n)
    vj, gj = jax_lml(reml, cj, **kw)(pj, dj)
    vt, gt = _value_and_grad(lambda p: ti.lml_iterative(p, dt, ct, **kw), pt)
    _close(vt, vj)
    for a, b in zip(gt, jax.tree.leaves(gj)):
        _close(a, b, rtol=RTOL_G)
    _close(vt, tgp.log_marginal_likelihood(pt, dt, ct).item(), rtol=1e-9)


@pytest.mark.parametrize("logdet", ["slq", "mbcg"])
def test_lml_iterative_stochastic_with_jax_probes(logdet, jax_lml,
                                                  monkeypatch):
    """Stochastic probes (8 of N=40, rank 8): with the JAX package's draws
    injected, the SLQ / mBCG value and the Hutchinson gradient match."""
    monkeypatch.setattr(ti, "_draw_probes", _jax_draws)
    n = 40
    X, y, nz, th = _problem(n, seed=7)
    cj, dj, pj = _jax(X, y, nz, th)
    ct, dt, pt = _torch(X, y, nz, th)
    kw = dict(seed=3, rank=8, probes=8, lanczos_iters=12, cg_tol=1e-12,
              cg_max_iters=200, logdet_method=logdet)
    vj, gj = jax_lml(False, cj, **kw)(pj, dj)
    vt, gt = _value_and_grad(lambda p: ti.lml_iterative(p, dt, ct, **kw), pt)
    _close(vt, vj)
    for a, b in zip(gt, jax.tree.leaves(gj)):
        _close(a, b, rtol=RTOL_G)


def test_lml_iterative_row_chunk_invariant():
    """row_chunk is a memory cap: value and gradient do not depend on it."""
    n = 36
    X, y, nz, th = _problem(n)
    ct, dt, pt = _torch(X, y, nz, th)
    kw = dict(EXACT, rank=n, probes=n, lanczos_iters=n)
    ref = _value_and_grad(lambda p: ti.lml_iterative(p, dt, ct, **kw), pt)
    chk = _value_and_grad(lambda p: ti.lml_iterative(p, dt, ct, row_chunk=8,
                                                     **kw), pt)
    _close(chk[0], ref[0], rtol=1e-10)
    for a, b in zip(chk[1], ref[1]):
        _close(a, b, rtol=1e-8)


def test_lml_iterative_gate_and_rejections():
    """A solve that cannot converge in its budget is walled off at -inf;
    gradient data and a mesh that is not a Mesh are refused; extra GLS
    basis columns (h_extra, the multi-fidelity column) train as in the
    dense LML."""
    X, y, nz, th = _problem(24)
    ct, dt, pt = _torch(X, y, nz, th)
    ll = ti.lml_iterative(pt, dt, ct, rank=2, probes=4, cg_tol=1e-14,
                          cg_max_iters=2)
    assert ll.item() == -np.inf
    batch = tk.GPParams(*(torch.stack([t, t]) for t in pt))
    both = ti.lml_iterative(batch, dt, ct, rank=24, probes=24, **EXACT)
    assert both.shape == (2,) and both[0].item() == both[1].item()
    with pytest.raises(ValueError, match="gradient-enhanced"):
        ti.lml_iterative(pt, dt._replace(dY=torch.zeros(24, 2)), ct)
    with pytest.raises(ValueError, match="gradient-enhanced"):
        ti.fit_gp_iterative(torch.Generator(), dt._replace(
            dY=torch.zeros(24, 2)), ct)
    with pytest.raises(TypeError, match="mesh"):
        ti.lml_iterative(pt, dt, ct, mesh=object())
    dh = dt._replace(h_extra=torch.cos(3 * dt.X[:, :1]))
    _close(ti.lml_iterative(pt, dh, ct, rank=24, probes=24, **EXACT),
           tgp.log_marginal_likelihood(pt, dh, ct), rtol=1e-8)
    with pytest.raises(ValueError, match="logdet_method"):
        ti.lml_iterative(pt, dt, ct, logdet_method="bogus")


@pytest.fixture(scope="module")
def served():
    """One problem (N=42) served by both packages: the JAX one-shot
    predict_iterative at full rank (exact, then precond variances) and the
    JAX precond variances at rank 20."""
    X, y, nz, th = _problem(42)
    Xs = np.random.default_rng(8).uniform(size=(11, 2))
    cj, dj, pj = _jax(X, y, nz, th)
    kw = dict(cg_tol=1e-12, cg_max_iters=400, query_chunk=4)

    def jax_serve(p, d, Xs):
        full = ji.precompute_iterative_predictor(p, d, cj, rank=42,
                                                 cg_tol=1e-12,
                                                 cg_max_iters=400)
        return {
            "exact": ji.predict_iterative(p, d, Xs, cj, state=full, **kw),
            "precond": ji.predict_iterative(p, d, Xs, cj, state=full,
                                            variance_method="precond", **kw),
            "precond_r20": ji.predict_iterative(p, d, Xs, cj, rank=20,
                                                variance_method="precond",
                                                **kw),
        }

    return (X, y, nz, th), Xs, _jit(jax_serve, pj, dj, jnp.asarray(Xs))


@pytest.mark.parametrize("method", ["exact", "precond", "precond_r20"])
def test_predict_iterative_matches_jax_and_dense(method, served):
    prob, Xs, jax_out = served
    ct, dt, pt = _torch(*prob)
    rank = 20 if method == "precond_r20" else 42
    m, v = ti.predict_iterative(
        pt, dt, torch.tensor(Xs), ct, rank=rank, cg_tol=1e-12,
        cg_max_iters=400, query_chunk=4,
        variance_method=method.split("_")[0])
    _close(m, jax_out[method][0])
    _close(v, jax_out[method][1])
    md, vd = tgp.gp_posterior(pt, dt, torch.tensor(Xs), ct)
    _close(m, md, rtol=1e-8, atol=1e-10)
    if method == "precond_r20":
        # a lower bound (P <= C: the ridge is the plain nugget here)
        assert bool((v <= vd + 1e-10).all())
        assert float(vd.sub(v).max()) > 1e-8
    else:
        _close(v, vd, rtol=1e-6, atol=1e-12)


def test_predict_from_state_matches_oneshot(served, monkeypatch):
    """Serving from the cached state equals the one-shot path and never
    rebuilds the preconditioner."""
    prob, Xs, _ = served
    ct, dt, pt = _torch(*prob)
    Xs1 = torch.tensor(Xs)
    kw = dict(rank=32, cg_tol=1e-10, cg_max_iters=300)
    m_ref, v_ref = ti.predict_iterative(pt, dt, Xs1, ct, query_chunk=4, **kw)
    state = ti.precompute_iterative_predictor(pt, dt, ct, **kw)

    def no_rebuild(*a, **k):
        raise AssertionError("serving from state rebuilt the preconditioner")

    monkeypatch.setattr(ti, "pivoted_cholesky", no_rebuild)
    m1, v1 = ti.predict_iterative_from_state(state, dt, Xs1, query_chunk=4)
    _close(m1, m_ref, rtol=1e-12)
    _close(v1, v_ref, rtol=1e-12)
    m3, _ = ti.predict_iterative(pt, dt, Xs1, ct, query_chunk=4, state=state)
    _close(m3, m_ref, rtol=1e-12)
    m4, v4 = ti.predict_iterative_from_state(state, dt, Xs1,
                                             with_variance=False)
    assert v4 is None
    _close(m4, m_ref, rtol=1e-12)
    with pytest.raises(ValueError, match="variance_method"):
        ti.predict_iterative_from_state(state, dt, Xs1,
                                        variance_method="bogus")


def test_predict_chunking_invariant(served):
    """query_chunk and variance_rhs are memory caps: the answers (exact and
    precond variances) do not depend on them; predict_iterative_host is the
    same serve."""
    prob, Xs, _ = served
    ct, dt, pt = _torch(*prob)
    Xs1 = torch.tensor(Xs)
    state = ti.precompute_iterative_predictor(pt, dt, ct, rank=32,
                                              cg_tol=1e-10, cg_max_iters=300)
    for method in ("exact", "precond"):
        m_ref, v_ref = ti.predict_iterative_from_state(
            state, dt, Xs1, query_chunk=11, variance_rhs=11,
            variance_method=method)
        for qc, rhs in ((11, 4), (11, 3), (5, 1), (3, 128)):
            m, v = ti.predict_iterative_from_state(
                state, dt, Xs1, query_chunk=qc, variance_rhs=rhs,
                variance_method=method)
            _close(m, m_ref, rtol=1e-12)
            _close(v, v_ref, rtol=1e-9, atol=1e-12)
        m, v = ti.predict_iterative_host(state, dt, Xs1, chunk=5,
                                         variance_method=method)
        _close(m, m_ref, rtol=1e-12)
        _close(v, v_ref, rtol=1e-9, atol=1e-12)


def test_predict_iterative_with_noise_matches_jax():
    X, y, nz, th = _problem(34, noise=True)
    Xs = np.random.default_rng(9).uniform(size=(7, 2))
    cj, dj, pj = _jax(X, y, nz, th)
    ct, dt, pt = _torch(X, y, nz, th)
    def jax_serve(p, d, Xs):
        sj = ji.precompute_iterative_predictor(p, d, cj, rank=34,
                                               cg_tol=1e-12, cg_max_iters=400)
        return (sj.pre.sigma2, sj.alpha, sj.beta, sj.CiH, sj.LA,
                ji.predict_iterative_from_state(sj, d, Xs))

    *sj, (mj, vj) = _jit(jax_serve, pj, dj, jnp.asarray(Xs))
    st = ti.precompute_iterative_predictor(pt, dt, ct, rank=34, cg_tol=1e-12,
                                           cg_max_iters=400)
    for a, b in zip((st.pre.sigma2, st.alpha, st.beta, st.CiH, st.LA), sj):
        _close(a, b, atol=1e-12)
    mt, vt = ti.predict_iterative_from_state(st, dt, torch.tensor(Xs))
    _close(mt, mj)
    _close(vt, vj)


def test_fit_gp_iterative_from_jax_starts(monkeypatch):
    """fit_gp_iterative against the JAX package's from the same
    unconstrained starts (exact-probe objective, N=24, 2 restarts x 3
    LBFGS steps): the host LBFGS is the same numpy in both, so the
    trajectories agree to the likelihood's rounding."""
    n, R = 24, 2
    X, y, nz, th = _problem(n, seed=10)
    u0 = np.random.default_rng(11).uniform(-1.5, 1.5, size=(R, 4))
    monkeypatch.setattr(jfit, "sample_restarts", lambda *a, **k: jk.GPParams(
        jnp.asarray(u0[:, 0]), jnp.asarray(u0[:, 1]), jnp.asarray(u0[:, 2:])))
    monkeypatch.setattr(tfit, "sample_restarts", lambda *a, **k: tk.GPParams(
        torch.tensor(u0[:, 0]), torch.tensor(u0[:, 1]),
        torch.tensor(u0[:, 2:])))
    cj, dj, _ = _jax(X, y, nz, th)
    ct, dt, _ = _torch(X, y, nz, th)
    cj = jcfg.GPConfig(nparams=2, regression_order=1, n_restarts=R)
    ct = tcfg.GPConfig(nparams=2, regression_order=1, n_restarts=R)
    kw = dict(max_steps=3, seed=0, rank=n, probes=n, lanczos_iters=n,
              cg_tol=1e-12, cg_max_iters=300, value_linesearch=False)
    rj = ji.fit_gp_iterative(jax.random.key(0), dj, cj, **kw)
    rt = ti.fit_gp_iterative(torch.Generator().manual_seed(0), dt, ct, **kw)
    _close(rt.restart_log_likelihoods, rj.restart_log_likelihoods)
    for a, b in zip(rt.restart_params, rj.restart_params):
        _close(a, b, rtol=1e-7, atol=1e-9)
    for key in ("n_vg_calls", "n_v_calls", "n_steps"):
        assert rt.stats[key] == rj.stats[key], key
    assert np.isfinite(rt.log_likelihood.item())
    _close(rt.log_likelihood,
           tgp.log_marginal_likelihood(rt.params, dt, ct).item(), rtol=1e-9)
