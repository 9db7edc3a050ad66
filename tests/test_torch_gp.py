"""The port's GP core (madaiemulator_tpu_torch ops/kernels, ops/linalg,
models/gp) against the JAX package on the CPU.

float64 runs the library path on both sides and agrees to rtol 1e-10.
float32 runs the kernel path: the port's plain K1 / K2 against JAX with
gram_method="pallas", cholesky_method="pallas", pallas_interpret=True, at
the tolerances of tests/test_pallas.py. Inputs are numpy arrays from a seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu.models import gp as jgp
from madaiemulator_tpu.ops import kernels as jk
from madaiemulator_tpu.utils import config as jcfg
from madaiemulator_tpu_torch.models import gp as tgp
from madaiemulator_tpu_torch.ops import kernels as tk
from madaiemulator_tpu_torch.ops import linalg as tl
from madaiemulator_tpu_torch.utils import config as tcfg
import torch_shared  # noqa: F401

FAMILIES = ["power_exponential", "matern32", "matern52", "matern32_ard",
            "matern52_ard"]


def _configs(family, order=1, alpha=2.0, **kw):
    """The same GPConfig in both packages (the port's defaults differ only
    in gram_method / cholesky_method, so those are always given)."""
    base = dict(regression_order=order, power_exp_alpha=alpha,
                gram_method="xla", cholesky_method="xla")
    base.update(kw)
    j = jcfg.GPConfig(nparams=3, covariance=jcfg.COVARIANCE_CLI_NAMES[family],
                      **base)
    t = tcfg.GPConfig(nparams=3, covariance=tcfg.COVARIANCE_CLI_NAMES[family],
                      **base)
    return j, t


def _params(cfg_j, seed, dtype, batch=None):
    rng = np.random.default_rng(seed)
    k = cfg_j.num_length_scales
    shape = () if batch is None else (batch,)
    amp = np.log(rng.uniform(0.5, 2.0, size=shape))
    nug = np.log(rng.uniform(1e-3, 1e-2, size=shape))
    ls = np.log(rng.uniform(0.3, 0.8, size=shape + (k,)))
    npdt = np.float64 if dtype == torch.float64 else np.float32
    j = jk.GPParams(*(jnp.asarray(np.asarray(a, npdt)) for a in (amp, nug, ls)))
    t = tk.GPParams(*(torch.tensor(np.asarray(a, npdt)) for a in (amp, nug, ls)))
    return j, t


def _data(seed, n, d, dtype, batch=None):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, d))
    ys = [np.sin(3 * X[:, 0] + k) + X[:, -1] ** 2 for k in range(batch or 1)]
    y = np.stack(ys) if batch else ys[0]
    npdt = np.float64 if dtype == torch.float64 else np.float32
    return X.astype(npdt), y.astype(npdt)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("family", FAMILIES)
def test_cross_and_gram_match_jax_f64(family):
    cj, ct = _configs(family)
    pj, pt = _params(cj, 1, torch.float64)
    rng = np.random.default_rng(2)
    X1, X2 = rng.uniform(size=(30, 3)), rng.uniform(size=(11, 3))
    _close(tk.cross_covariance(_t(X1), _t(X2), pt, ct),
           jk.cross_covariance(_j(X1), _j(X2), pj, cj), rtol=1e-10)
    _close(tk.gram_matrix(_t(X1), pt, ct), jk.gram_matrix(_j(X1), pj, cj),
           rtol=1e-10)


def test_power_exp_alpha_not_two_matches_jax_f64():
    """alpha != 2 takes the library power-distance path on both sides."""
    cj, ct = _configs("power_exponential", alpha=1.5)
    pj, pt = _params(cj, 3, torch.float64)
    X = np.random.default_rng(4).uniform(size=(25, 3))
    _close(tk.gram_matrix(_t(X), pt, ct), jk.gram_matrix(_j(X), pj, cj),
           rtol=1e-10)
    _close(tk.kdiag(_t(X), pt, ct), jk.kdiag(_j(X), pj, cj), rtol=1e-12)


@pytest.mark.parametrize("family", FAMILIES)
def test_kernel_path_f32_matches_jax_pallas(family):
    """gram_method="pallas": the port's plain K1 vs JAX's Pallas kernel in
    interpret mode (tests/test_pallas.py:153-165 tolerances)."""
    cj, ct = _configs(family, gram_method="pallas", pallas_interpret=True)
    pj, pt = _params(cj, 5, torch.float32)
    X = np.random.default_rng(6).uniform(size=(50, 3)).astype(np.float32)
    Xq = np.random.default_rng(7).uniform(size=(9, 3)).astype(np.float32)
    K = tk.gram_matrix(_t(X), pt, ct)
    _close(K, jk.gram_matrix(_j(X), pj, cj), rtol=2e-5, atol=1e-6)
    assert torch.equal(K, K.T)  # no re-symmetrization on the kernel path
    _close(tk.cross_covariance(_t(X), _t(Xq), pt, ct),
           jk.cross_covariance(_j(X), _j(Xq), pj, cj), rtol=2e-5, atol=1e-6)


def test_routing_follows_jax_eligibility():
    _, ct = _configs("power_exponential", gram_method="pallas")
    assert tk._pallas_eligible(ct, torch.float32)
    assert not tk._pallas_eligible(ct, torch.float64)
    assert not tk._pallas_eligible(dataclasses.replace(ct, power_exp_alpha=1.5),
                                   torch.float32)
    assert tk._pallas_family(_configs("matern52_ard")[1]) == "matern52"


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_regression_basis_matches_jax(order):
    X = np.random.default_rng(order).uniform(size=(7, 3))
    _close(tgp.regression_basis(_t(X), order),
           jgp.regression_basis(_j(X), order), rtol=0)


@pytest.mark.parametrize("n", [10, 5000])
def test_effective_jitter_frac_matches_jax(n):
    cj, ct = _configs("matern32")
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        assert tk.effective_jitter_frac(n, tdt, ct) == jk.effective_jitter_frac(
            n, jdt, cj)


def test_config_validation_and_defaults():
    c = tcfg.GPConfig(nparams=2)
    assert (c.gram_method, c.cholesky_method) == ("pallas", "pallas")
    assert tcfg.GPConfig(nparams=2, cholesky_method="blocked"
                         ).cholesky_method == "blocked"
    with pytest.raises(ValueError, match="unknown cholesky_method"):
        tcfg.GPConfig(nparams=2, cholesky_method="cuda")
    with pytest.raises(ValueError):
        tcfg.GPConfig(nparams=2, gram_method="cuda")
    with pytest.raises(ValueError):
        tcfg.GPConfig(nparams=0)
    assert tcfg.GPConfig(nparams=4, covariance=tcfg.CovarianceFamily.MATERN32
                         ).num_thetas == 3


def _states(family, dtype, seed=8, batch=None, **kw):
    cj, ct = _configs(family, **kw)
    pj, pt = _params(cj, seed, dtype, batch=batch)
    X, y = _data(seed, 40, 3, dtype, batch=batch)
    dj = jgp.GPData(X=_j(X), y=_j(y))
    dt = tgp.GPData(X=_t(X), y=_t(y))
    return cj, ct, pj, pt, dj, dt


@pytest.mark.parametrize("family", ["power_exponential", "matern52_ard"])
def test_precompute_and_predict_match_jax_f64(family):
    cj, ct, pj, pt, dj, dt = _states(family, torch.float64)
    sj = jgp.precompute_predictor(pj, dj, cj)
    st = tgp.precompute_predictor(pt, dt, ct)
    for name in ("L", "alpha", "beta", "LA", "Linv_H"):
        _close(getattr(st, name), getattr(sj, name), rtol=1e-10, atol=1e-12)
    assert bool(st.ok) and bool(sj.ok)
    Xq = np.random.default_rng(9).uniform(size=(13, 3))
    mt, vt = tgp.predict_from_precomputed(st, pt, dt, _t(Xq), ct)
    mj, vj = jgp.predict_from_precomputed(sj, pj, dj, _j(Xq), cj)
    _close(mt, mj, rtol=1e-10, atol=1e-12)
    _close(vt, vj, rtol=1e-10, atol=1e-12)


def test_kernel_path_f32_factor_and_posterior_match_jax_pallas():
    """cholesky_method="pallas" (plain K2 vs pallas_cholesky interpret) and
    the posterior (tests/test_pallas.py:190-227 tolerances)."""
    cj, ct, pj, pt, dj, dt = _states(
        "power_exponential", torch.float32, gram_method="pallas",
        cholesky_method="pallas", pallas_interpret=True)
    sj = jgp._factor(dj, pj, cj)
    st = tgp._factor(dt, pt, ct)
    assert bool(sj.ok) and bool(st.ok)
    _close(st.L, sj.L, rtol=1e-4, atol=1e-5)
    Xq = np.random.default_rng(10).uniform(0.1, 0.9, size=(9, 3)).astype(
        np.float32)
    mt, vt = tgp.predict_from_precomputed(st, pt, dt, _t(Xq), ct)
    mj, vj = jgp.predict_from_precomputed(sj, pj, dj, _j(Xq), cj)
    _close(mt, mj, rtol=1e-3, atol=1e-4)
    _close(vt, vj, rtol=5e-3, atol=1e-5)


def test_left_cholesky_route_matches_library():
    """pallas above pallas_cholesky_max_n routes to left_cholesky (padded to
    cholesky_block): with library panels at float64, where it agrees with
    the library factor, and with kernel K3 on every panel at float32, where
    it agrees with the JAX package's left-looking factor."""
    _, ct, _, pt, _, dt = _states("matern32", torch.float64)
    left = dataclasses.replace(ct, cholesky_method="pallas",
                               pallas_cholesky_max_n=16, cholesky_block=16)
    st = tgp._factor(dt, pt, left)
    ref = tgp._factor(dt, pt, ct)
    _close(st.L, ref.L.numpy(), rtol=1e-12, atol=1e-13)
    cj, ct, pj, pt, dj, dt = _states("matern32", torch.float32)
    k3 = dataclasses.replace(ct, cholesky_method="pallas",
                             pallas_cholesky_max_n=16, cholesky_block=32)
    sj = jgp._factor(dj, pj, dataclasses.replace(
        cj, cholesky_method="left", cholesky_block=32))
    st = tgp._factor(dt, pt, k3)
    assert bool(st.ok) and bool(sj.ok)
    _close(st.L, sj.L, rtol=1e-4, atol=1e-5)


def test_non_spd_gives_not_ok_like_jax():
    """A Gram made indefinite (negative known noise) fails in both packages;
    the failed member keeps finite, gated state."""
    cj, ct, pj, pt, dj, dt = _states("power_exponential", torch.float64)
    noise = -np.full(40, 50.0)
    sj = jgp._factor(dj._replace(noise=_j(noise)), pj, cj)
    st = tgp._factor(dt._replace(noise=_t(noise)), pt, ct)
    assert not bool(sj.ok) and not bool(st.ok)
    assert bool(torch.isfinite(st.alpha).all())


def test_failed_cholesky_ex_member_is_nan():
    A = torch.eye(5, dtype=torch.float64).repeat(3, 1, 1)
    A[1, 2, 2] = -1.0
    L = tl.xla_cholesky(A)
    assert tl.chol_ok(L).tolist() == [True, False, True]
    assert bool(torch.isnan(L[1]).all())
    assert torch.equal(L[0], torch.eye(5, dtype=torch.float64))


def test_batched_serve_matches_per_component_at_high_condition():
    """The port's analogue of test_vmapped_serve_matches_unvmapped_at_high_
    condition: one batched (r, N, N) precompute + predict equals the r
    unbatched programs, on the float32 kernel path at nugget ~1e-7."""
    n, d = 96, 2
    rng = np.random.default_rng(0)
    Xn = rng.uniform(size=(n, d))
    Z = np.stack([np.sin(4 * Xn[:, 0]) + Xn[:, 1],
                  (Xn[:, 1] - 0.3) ** 2 + 0.5 * Xn[:, 0],
                  np.cos(3 * Xn[:, 0]) * Xn[:, 1]], axis=0)
    X = torch.tensor(Xn, dtype=torch.float32)
    Y = torch.tensor(Z, dtype=torch.float32)
    Xq = torch.tensor(rng.uniform(size=(24, d)), dtype=torch.float32)
    cfg = tcfg.GPConfig(nparams=d, regression_order=1)  # kernel defaults
    pb = tk.GPParams(
        log_amp=torch.log(torch.tensor([0.15, 0.36, 1.5])),
        log_nugget=torch.log(torch.tensor([3e-8, 2e-7, 1e-6])),
        log_ls=torch.log(torch.tensor([[0.73, 0.45], [0.45, 0.71],
                                       [0.56, 0.49]])),
    )
    st = tgp.precompute_predictor(pb, tgp.GPData(X=X, y=Y), cfg)
    mb, vb = tgp.predict_from_precomputed(st, pb, tgp.GPData(X=X, y=Y), Xq, cfg)
    for i in range(3):
        pi = tk.GPParams(*(a[i] for a in pb))
        di = tgp.GPData(X=X, y=Y[i])
        si = tgp.precompute_predictor(pi, di, cfg)
        mu, vu = tgp.predict_from_precomputed(si, pi, di, Xq, cfg)
        _close(mb[i], mu.numpy(), rtol=0, atol=5e-3)
        _close(vb[i], vu.numpy(), rtol=1e-2, atol=5e-3)


def test_query_chunking_is_exact():
    _, ct, _, pt, _, dt = _states("matern52", torch.float64)
    st = tgp.precompute_predictor(pt, dt, ct)
    Xq = torch.tensor(np.random.default_rng(11).uniform(size=(25, 3)))
    m1, v1 = tgp.predict_from_precomputed(st, pt, dt, Xq, ct)
    m2, v2 = tgp.predict_from_precomputed(
        st, pt, dt, Xq, dataclasses.replace(ct, predict_query_chunk=7))
    _close(m2, m1.numpy(), rtol=1e-14, atol=1e-15)
    _close(v2, v1.numpy(), rtol=1e-14, atol=1e-15)


def test_unported_data_fields_raise():
    """dY (tests/test_torch_gradients.py) on a once-differentiable kernel
    raises the JAX package's ValueError. h_extra is ported
    (tests/test_torch_h_extra.py): its columns follow the polynomial basis,
    and it cannot be combined with dY."""
    _, ct, _, pt, _, dt = _states("matern32", torch.float64)
    with pytest.raises(ValueError, match="twice differentiable"):
        tgp._factor(dt._replace(dY=dt.X), pt, ct)
    H = tgp.training_basis(dt._replace(h_extra=dt.X), ct)
    base = tgp.training_basis(dt, ct)
    assert torch.equal(H, torch.cat([base, dt.X], dim=-1))
    with pytest.raises(ValueError, match="h_extra and dY"):
        tgp.training_basis(dt._replace(h_extra=dt.X, dY=dt.X), ct)


def test_pad_spd_and_thetas_roundtrip():
    A = torch.eye(3, dtype=torch.float64) * 2.0
    Ap, n0 = tl.pad_spd(A, 4)
    assert n0 == 3 and Ap.shape == (4, 4) and Ap[3, 3] == 1.0
    th = torch.tensor([[1.5, 1e-3, 0.2, 0.4]], dtype=torch.float64)
    back = tk.params_to_thetas(tk.thetas_to_params(th))
    _close(back, th.numpy(), rtol=1e-14)
    j = jk.params_to_thetas(jk.thetas_to_params(jnp.asarray(th[0].numpy())))
    _close(back[0], j, rtol=1e-14)
    assert jax.config.jax_enable_x64  # the f64 parity above ran in x64


def _ladder_case(device):
    """Two components at float32 with no jitter floor. The second (ls 3,
    nugget 1e-12) is numerically rank-deficient, and a known noise of -5e-5
    on its diagonal makes it indefinite at the base jitter (it cannot
    factor) but SPD once the ladder adds 1e-4 x amp."""
    rng = np.random.default_rng(0)
    X = torch.tensor(rng.uniform(size=(60, 2)), dtype=torch.float32,
                     device=device)
    y = torch.stack([torch.sin(3 * X[:, 0]), X[:, 1] ** 2])
    p = tk.GPParams(
        log_amp=torch.zeros(2, device=device),
        log_nugget=torch.log(torch.tensor([1e-3, 1e-12], device=device)),
        log_ls=torch.log(torch.tensor([[0.3, 0.3], [3.0, 3.0]], device=device)),
    )
    noise = torch.zeros(2, 60, device=device)
    noise[1] = -5e-5
    return (p, tgp.GPData(X=X, y=y, noise=noise),
            tcfg.GPConfig(nparams=2, jitter=0.0))


def test_jitter_ladder_rescues_only_the_failed_component(caplog):
    p, data, cfg = _ladder_case("cpu")
    base = tgp._factor(data, p, cfg)
    assert base.ok.tolist() == [True, False]
    st = tgp.precompute_predictor(p, data, cfg)
    assert st.ok.tolist() == [True, True]
    for a, b in zip(st[:-1], base[:-1]):
        assert torch.equal(a[0], b[0])  # the SPD member keeps its state
    rung = tgp._factor(data, p, dataclasses.replace(cfg, jitter=1e-4))
    assert torch.equal(st.L[1], rung.L[1])
    assert "remain non-SPD" not in caplog.text
