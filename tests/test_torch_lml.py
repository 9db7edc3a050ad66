"""The port's likelihood and large-N factorization (madaiemulator_tpu_torch
ops/linalg, ops/kernels VJPs, models/gp LML) against the JAX package on the
CPU. The same numpy inputs, made from a seed, go through both.

float64 runs the library path on both sides: the closed-form LML gradient
agrees with `jax.grad(log_marginal_likelihood)` to rtol 1e-8. float32 runs
the kernel path: the port's plain K1 / K2 / K3 against the JAX package's
Pallas kernels in interpret mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu.models import gp as jgp
from madaiemulator_tpu.ops import kernels as jk
from madaiemulator_tpu.ops import linalg as jl
from madaiemulator_tpu.utils import config as jcfg
from madaiemulator_tpu_torch.models import gp as tgp
from madaiemulator_tpu_torch.ops import kernels as tk
from madaiemulator_tpu_torch.ops import linalg as tl
from madaiemulator_tpu_torch.utils import config as tcfg


def _spd(seed, n, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    return (A @ A.T + n * np.eye(n)).astype(dtype)


def test_left_cholesky_k3_matches_jax_pallas_interpret():
    """left_cholesky(diag="pallas") (plain K3 per panel, L21 as one GEMM)
    against the JAX route through pallas_panel_factor in interpret mode."""
    A = _spd(0, 256, np.float32)
    want = np.asarray(jl.left_cholesky(jnp.asarray(A), block=128,
                                       diag="pallas_interpret"))
    got = tl.left_cholesky(torch.from_numpy(A), block=128, diag="pallas")
    # two f32 factorizations of a cond ~ 10 matrix
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert torch.equal(got, torch.tril(got))


def test_left_cholesky_k3_batched_and_non_spd():
    A = np.stack([_spd(1, 128, np.float32), _spd(2, 128, np.float32)])
    A[1, 64:, 64:] -= 300.0 * np.eye(64, dtype=np.float32)  # second panel fails
    L = tl.left_cholesky(torch.from_numpy(A), block=64, diag="pallas")
    assert tl.chol_ok(L).tolist() == [True, False]
    L0 = tl.left_cholesky(torch.from_numpy(A[:1]), block=64, diag="pallas")
    assert torch.equal(L[0], L0[0])
    with pytest.raises(ValueError, match="diag"):
        tl.left_cholesky(torch.from_numpy(A), block=64, diag="pallas_interpret")


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5), (np.float64, 1e-12)])
def test_tri_inv_block_matches_jax(dtype, tol):
    L = np.linalg.cholesky(_spd(3, 160)).astype(dtype)
    want = np.asarray(jax.jit(lambda t: jl.tri_inv_block(t, base=32))(
        jnp.asarray(L)))
    got = tl.tri_inv_block(torch.from_numpy(L), base=32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())
    # batched over (*B): each member equals its own inverse
    Lb = torch.from_numpy(np.stack([L, 2.0 * L]))
    gb = tl.tri_inv_block(Lb, base=32)
    assert torch.allclose(gb[0], got) and torch.allclose(gb[1], got / 2)


def _chol_loss(L):
    return torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum() + (
        L * torch.cos(L)).sum()


@pytest.mark.parametrize("route", ["pallas_cholesky_diff", "left_xla",
                                   "left_pallas"])
def test_murray_backward_matches_autograd(route):
    """The Murray backward of K2 and of left_cholesky against torch autograd
    through torch.linalg.cholesky (tests/test_linalg.py:60,112)."""
    dtype = torch.float32 if route != "left_xla" else torch.float64
    A = torch.from_numpy(_spd(4, 128)).to(dtype)
    A = torch.stack([A, A + torch.eye(128, dtype=dtype)]).requires_grad_()
    fact = {
        "pallas_cholesky_diff": tl.pallas_cholesky_diff,
        "left_xla": lambda M: tl.left_cholesky(M, block=32),
        "left_pallas": lambda M: tl.left_cholesky(M, block=64, diag="pallas"),
    }[route]
    (want,) = torch.autograd.grad(_chol_loss(torch.linalg.cholesky(A)), A)
    (got,) = torch.autograd.grad(_chol_loss(fact(A)), A)
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=tol * want.abs().max().item())


def _problem(seed=0, n=20, d=2, order=1, family="power_exponential",
             dtype=torch.float64, batch=None, noise=False, **cfg_kw):
    """setup_problem of tests/test_gp.py in both packages, optionally with
    a batch of parameter sets (one per member) and per-point noise."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    y = np.sin(3 * X[:, 0]) + 0.5 * X[:, 1] + 0.05 * rng.standard_normal(n)
    fam = tcfg.COVARIANCE_CLI_NAMES[family]
    k = fam.num_length_scales(d)
    shape = () if batch is None else (batch,)
    amp = np.log(rng.uniform(0.8, 1.6, size=shape))
    nug = np.log(rng.uniform(1e-3, 1e-2, size=shape))
    ls = np.log(rng.uniform(0.5, 1.0, size=shape + (k,)))
    nz = 10.0 ** rng.uniform(-4, -1, size=n) if noise else None
    npdt = np.float64 if dtype == torch.float64 else np.float32
    base = dict(nparams=d, regression_order=order,
                covariance=jcfg.COVARIANCE_CLI_NAMES[family])
    base.update(cfg_kw)
    cj = jcfg.GPConfig(**base)
    ct = tcfg.GPConfig(**{**base, "covariance": fam,
                          "gram_method": base.get("gram_method", "xla"),
                          "cholesky_method": base.get("cholesky_method",
                                                      "xla")})
    pj = jk.GPParams(*(jnp.asarray(np.asarray(a, npdt)) for a in (amp, nug, ls)))
    pt = tk.GPParams(*(torch.tensor(np.asarray(a, npdt), requires_grad=True)
                       for a in (amp, nug, ls)))
    dj = jgp.GPData(X=jnp.asarray(X.astype(npdt)), y=jnp.asarray(y.astype(npdt)),
                    noise=None if nz is None else jnp.asarray(nz.astype(npdt)))
    dt = tgp.GPData(X=torch.tensor(X.astype(npdt)), y=torch.tensor(y.astype(npdt)),
                    noise=None if nz is None else torch.tensor(nz.astype(npdt)))
    return cj, ct, pj, pt, dj, dt


def _jax_value_and_grad(pj, dj, cj, batched):
    f = jax.value_and_grad(lambda p, d: jgp.log_marginal_likelihood(p, d, cj))
    if batched:
        f = jax.vmap(f, in_axes=(0, None))
    return jax.jit(f)(pj, dj)


LML_CASES = {
    "order0": dict(order=0),
    "order1": dict(order=1),
    "order0_reml": dict(order=0, reml=True),
    "order1_reml": dict(order=1, reml=True),
    "matern52_iso": dict(family="matern52"),
    "noise_reml": dict(noise=True, reml=True),
    "batch3": dict(batch=3, reml=True),
}


@pytest.mark.parametrize("case", list(LML_CASES))
def test_closed_form_gradient_matches_jax_f64(case):
    kw = LML_CASES[case]
    cj, ct, pj, pt, dj, dt = _problem(**kw)
    llj, gj = _jax_value_and_grad(pj, dj, cj, "batch" in kw)
    ll = tgp.log_marginal_likelihood(pt, dt, ct)
    g = torch.autograd.grad(ll.sum(), pt)
    np.testing.assert_allclose(ll.detach().numpy(), np.asarray(llj),
                               rtol=1e-10)
    for a, b in zip(g, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8,
                                   atol=1e-12)
    # plain autodiff through the factorization gives the same gradient
    g_ad = torch.autograd.grad(tgp.log_marginal_likelihood_ad(pt, dt, ct).sum(),
                               pt)
    for a, b in zip(g, g_ad):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-8,
                                   atol=1e-12)


@pytest.mark.parametrize("reml", [False, True])
def test_kernel_path_f32_lml_matches_jax_pallas(reml):
    """float32 on the kernel path: the port's plain K1 (with its library
    VJP) and K2 against gram_method="pallas", cholesky_method="pallas",
    pallas_interpret=True in the JAX package."""
    cj, ct, pj, pt, dj, dt = _problem(
        n=40, d=3, dtype=torch.float32, reml=reml, gram_method="pallas",
        cholesky_method="pallas", pallas_interpret=True)
    llj, gj = _jax_value_and_grad(pj, dj, cj, False)
    ll = tgp.log_marginal_likelihood(pt, dt, ct)
    g = torch.autograd.grad(ll, pt)
    # f32 value: the two f32 evaluations differ by ~1e-6 of the logdet and
    # constant terms (~145 here), which cancel to a value of ~17, so 1e-5
    # of the value; gradients: the cancellation in
    # 0.5 a^T dC a - 0.5 tr(C^-1 dC) at cond ~ 1e3
    np.testing.assert_allclose(ll.item(), float(llj), rtol=1e-4)
    gmax = max(np.abs(np.asarray(b)).max() for b in gj)
    for a, b in zip(g, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-3 * gmax)


def test_k3_route_lml_matches_library_route_f32():
    """`_factor` at N > pallas_cholesky_max_n with cholesky_method="pallas"
    runs left_cholesky(diag="pallas") (plain K3); its LML and gradient
    equal the library route's at float32 tolerance."""
    _, ct, _, pt, _, dt = _problem(n=100, d=3, dtype=torch.float32,
                                   gram_method="pallas")
    k3 = dataclasses.replace(ct, cholesky_method="pallas",
                             pallas_cholesky_max_n=32, cholesky_block=64)
    ll3 = tgp.log_marginal_likelihood(pt, dt, k3)
    g3 = torch.autograd.grad(ll3, pt)
    ll = tgp.log_marginal_likelihood(pt, dt, ct)
    g = torch.autograd.grad(ll, pt)
    np.testing.assert_allclose(ll3.item(), ll.item(), rtol=1e-4)
    gmax = max(b.abs().max().item() for b in g)
    for a, b in zip(g3, g):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-3 * gmax)


def test_non_spd_gives_neg_inf_and_nan_gradient():
    """A member made indefinite (negative known noise) scores -inf with a
    NaN gradient; the other member of the batch is untouched."""
    cj, ct, pj, pt, dj, dt = _problem(batch=2)
    noise = torch.zeros(2, 20, dtype=torch.float64)
    noise[1] = -50.0
    ll = tgp.log_marginal_likelihood(pt, dt._replace(noise=noise), ct)
    g = torch.autograd.grad(ll.sum(), pt)
    assert ll[1].item() == -np.inf and np.isfinite(ll[0].item())
    for a in g:
        assert bool(torch.isnan(a[1]).all()) and bool(torch.isfinite(a[0]).all())
    llj, gj = _jax_value_and_grad(jk.GPParams(*(a[1] for a in pj)),
                                  dj._replace(noise=jnp.full(20, -50.0)), cj,
                                  False)
    assert float(llj) == -np.inf
    assert all(bool(jnp.isnan(a).all()) for a in gj)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_precompute_predictor_safe_and_posterior_match_jax(dtype):
    f32 = dtype == torch.float32
    kw = dict(gram_method="pallas", cholesky_method="pallas",
              pallas_interpret=True) if f32 else {}
    cj, ct, pj, pt, dj, dt = _problem(n=40, d=3, dtype=dtype, **kw)
    pt = tk.GPParams(*(a.detach() for a in pt))
    sj = jgp.precompute_predictor_safe(pj, dj, cj)
    st = tgp.precompute_predictor_safe(pt, dt, ct)
    rtol, atol = (1e-4, 1e-5) if f32 else (1e-10, 1e-12)
    for name in ("L", "alpha", "beta", "LA", "Linv_H"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)),
                                   rtol=rtol * (30 if name != "L" else 1),
                                   atol=atol * (30 if name != "L" else 1))
    Xq = np.random.default_rng(9).uniform(0.1, 0.9, size=(13, 3))
    npdt = np.float32 if f32 else np.float64
    mt, vt = tgp.gp_posterior(pt, dt, torch.tensor(Xq.astype(npdt)), ct)
    mj, vj = jax.jit(lambda p, d, q: jgp.gp_posterior(p, d, q, cj))(
        pj, dj, jnp.asarray(Xq.astype(npdt)))
    tol = 1e-3 if f32 else 1e-10
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=tol, atol=tol)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=tol, atol=tol)
