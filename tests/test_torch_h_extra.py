"""The extra GLS columns of the port's GP core (`GPData.h_extra` and the
query-side `hs_extra`, the basis column whose coefficient is a
multi-fidelity level's rho) on the CPU against the JAX package at float64:
the LML value and its closed-form gradient, predict (whole, in chunks, over
a component batch), the sparse ELBO and predict, and the matrix-free LML.
Each JAX reference is one jitted program.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu.models import gp as jgp
from madaiemulator_tpu.models import iterative as jit_
from madaiemulator_tpu.models import sparse as jsp
from madaiemulator_tpu.ops import kernels as jk
from madaiemulator_tpu.utils import config as jcfg
from madaiemulator_tpu_torch.models import gp as tgp
from madaiemulator_tpu_torch.models import iterative as tit
from madaiemulator_tpu_torch.models import sparse as tsp
from madaiemulator_tpu_torch.ops import kernels as tk
from madaiemulator_tpu_torch.utils import config as tcfg
import torch_shared  # noqa: F401

# the same float64 algebra up to summation order and two LAPACK builds
RTOL = 1e-10
D = 2


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


def _params(rng, b=()):
    a = np.log(rng.uniform(0.5, 2.0, size=b))
    g = np.log(rng.uniform(1e-3, 1e-2, size=b))
    ls = np.log(rng.uniform(0.2, 0.6, size=b + (D,)))
    return (jk.GPParams(_j(a), _j(g), _j(ls)),
            tk.GPParams(_t(a), _t(g), _t(ls)))


def _problem(rng, n, q=1):
    X = rng.uniform(size=(n, D))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 + 0.01 * rng.standard_normal(n)
    h = np.cos(2 * X[:, 0])[:, None] + 0.1 * rng.standard_normal((n, q))
    return X, y, h



@pytest.mark.parametrize("reml", [False, True])
def test_lml_value_and_gradient_with_h_extra(reml):
    """The closed-form LML backward carries the extra columns through the
    GLS envelope: value and gradient against jax.grad of the JAX LML (two
    extra columns), and against the port's own autodiff LML."""
    rng = np.random.default_rng(1)
    X, y, h = _problem(rng, 20, q=2)
    jc, tc = _cfgs(reml=reml)
    pj, pt = _params(rng)
    dj = jgp.GPData(X=_j(X), y=_j(y), h_extra=_j(h))
    dt = tgp.GPData(X=_t(X), y=_t(y), h_extra=_t(h))
    vj, gj = jax.jit(jax.value_and_grad(
        lambda p: jgp.log_marginal_likelihood(p, dj, jc)))(pj)
    leaves = [a.clone().requires_grad_(True) for a in pt]
    vt = tgp.log_marginal_likelihood(tk.GPParams(*leaves), dt, tc)
    gt = torch.autograd.grad(vt, leaves)
    _close(vt.detach(), vj)
    for a, b in zip(gt, gj):
        _close(a, b, atol=1e-10)
    leaves2 = [a.clone().requires_grad_(True) for a in pt]
    va = tgp.log_marginal_likelihood_ad(tk.GPParams(*leaves2), dt, tc)
    for a, b in zip(torch.autograd.grad(va, leaves2), gt):
        _close(a, b, atol=1e-10)
    # rho is the LAST GLS coefficient: the columns come after the basis
    st = tgp._factor(dt, pt, tc)
    stj = jax.jit(lambda p: jgp._factor(dj, p, jc))(pj)
    assert st.beta.shape == (1 + D + 2,)
    _close(st.beta, stj.beta)


def test_predict_with_hs_extra_chunked_and_batched():
    """predict_from_precomputed with hs_extra, whole and in query chunks
    whose last one is short (the JAX package pads it with the first
    queries), against the JAX predict; a component batch (r, N, 1) equals
    its members one by one; the JAX package's rejections stand."""
    rng = np.random.default_rng(2)
    X, y, h = _problem(rng, 18)
    Xs = rng.uniform(size=(11, D))
    hs = np.cos(2 * Xs[:, 0])[:, None]
    jc, tc = _cfgs()
    pj, pt = _params(rng)
    dj = jgp.GPData(X=_j(X), y=_j(y), h_extra=_j(h))
    dt = tgp.GPData(X=_t(X), y=_t(y), h_extra=_t(h))
    st = tgp.precompute_predictor(pt, dt, tc)
    for chunk in (None, 4):
        jcc = dataclasses.replace(jc, predict_query_chunk=chunk)
        tcc = dataclasses.replace(tc, predict_query_chunk=chunk)
        mj, vj = jax.jit(lambda p, q, hq: jgp.gp_posterior(
            p, dj, q, jcc, hs_extra=hq))(pj, _j(Xs), _j(hs))
        mt, vt = tgp.predict_from_precomputed(st, pt, dt, _t(Xs), tcc,
                                              hs_extra=_t(hs))
        _close(mt, mj)
        _close(vt, vj)
    # a batch of two components on one design, each its own column
    y2 = np.stack([y, 2 * y])
    h2 = np.stack([h, -h])
    hs2 = np.stack([hs, -hs])
    p2 = tk.GPParams(*(torch.stack([a, a * 1.1]) for a in pt))
    db = tgp.GPData(X=_t(X), y=_t(y2), h_extra=_t(h2))
    stb = tgp.precompute_predictor(p2, db, tc)
    mb, vb = tgp.predict_from_precomputed(stb, p2, db, _t(Xs), tc,
                                          hs_extra=_t(hs2))
    for i in range(2):
        pi = tk.GPParams(*(a[i] for a in p2))
        di = tgp.GPData(X=_t(X), y=_t(y2[i]), h_extra=_t(h2[i]))
        mi, vi = tgp.gp_posterior(pi, di, _t(Xs), tc, hs_extra=_t(hs2[i]))
        _close(mb[i], mi, rtol=1e-12)
        _close(vb[i], vi, rtol=1e-12)
    with pytest.raises(ValueError, match="hs_extra"):
        tgp.predict_from_precomputed(st, pt, dt, _t(Xs), tc)
    with pytest.raises(ValueError, match="h_extra and dY"):
        tgp.training_basis(dt._replace(dY=_t(X)), tc)
    with pytest.raises(ValueError, match="h_extra"):
        tgp.predict_gradient(st, pt, dt, _t(Xs), tc)


def test_sparse_and_matrix_free_with_h_extra():
    """The extra columns in the sparse ELBO (one-shot and row-chunked, the
    padded rows zero) and its predict, and in the matrix-free LML
    (exact-probe mode), against the JAX package's."""
    rng = np.random.default_rng(3)
    X, y, h = _problem(rng, 21)
    Xs = rng.uniform(size=(5, D))
    hs = np.cos(2 * Xs[:, 0])[:, None]
    jc, tc = _cfgs()
    pj, pt = _params(rng)
    Z = X[::3]
    dj = jgp.GPData(X=_j(X), y=_j(y), h_extra=_j(h))
    dt = tgp.GPData(X=_t(X), y=_t(y), h_extra=_t(h))

    def ref(p):
        st = jsp.sgpr_precompute(p, dj, jc, _j(Z))
        return (jsp.elbo(p, dj, jc, _j(Z)),
                jsp.predict_sgpr(st, p, jc, _j(Xs), hs_extra=_j(hs)))

    ej, (mj, vj) = jax.jit(ref)(pj)
    for chunk in (None, 8):
        _close(tsp.elbo(pt, dt, tc, _t(Z), row_chunk=chunk), ej)
    st = tsp.sgpr_precompute(pt, dt, tc, _t(Z), row_chunk=8)
    mt, vt = tsp.predict_sgpr(st, pt, tc, _t(Xs), hs_extra=_t(hs))
    _close(mt, mj)
    _close(vt, vj)
    exact = dict(rank=21, probes=21, cg_tol=1e-12, cg_max_iters=200)
    lj = jax.jit(lambda p: jit_.lml_iterative(p, dj, jc, **exact))(pj)
    _close(tit.lml_iterative(pt, dt, tc, **exact), lj, rtol=1e-8)
    _close(tit.lml_iterative(pt, dt, tc, **exact),
           tgp.log_marginal_likelihood(pt, dt, tc), rtol=1e-8)
