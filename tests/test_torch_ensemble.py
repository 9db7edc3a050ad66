"""The port's ensemble fit and serve (madaiemulator_tpu_torch/parallel/
ensemble.py, BASELINE config 5) against the JAX package's on the CPU, at
float64 on the library path (the kernels' plain versions are not reached at
float64), at E=3 members, N=12 points, d=2, R=2 restarts, 5 L-BFGS steps.

JAX PRNG keys and torch generators draw different restarts, so the JAX
comparison feeds both packages the same unconstrained starts u0 (numpy, from
a seed) through `fit_ensemble_from_starts`. The starts are drawn where C(theta)
is well conditioned (amplitude 0.02-50, nugget >= 1e-5 x amp): at a nugget
of 1e-8 x amp two float64 LAPACK builds differ by ~5e-9 in the objective
and the zoom linesearch amplifies it (tests/test_torch_fit.py). One JAX
compile of each function, in a module-scoped fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu.ops import kernels as jk
from madaiemulator_tpu.parallel import ensemble as jens
from madaiemulator_tpu.utils import config as jcfg
from madaiemulator_tpu_torch.models import fit as tfit
from madaiemulator_tpu_torch.ops import kernels as tk
from madaiemulator_tpu_torch.parallel import ensemble as tens
from madaiemulator_tpu_torch.utils import config as tcfg
import torch_shared  # noqa: F401

E, N, D, R, STEPS, M = 3, 12, 2, 2, 5, 7
# float64 parity with the JAX package: both run optax's L-BFGS with the zoom
# linesearch on the same iterates, so they agree to the rounding of the
# likelihood and its gradient.
LML_RTOL = 1e-10
PARAMS_RTOL = 1e-8
PREDICT_RTOL = 1e-10
# inside the port: a lane's trajectory does not depend on which other lanes
# share its batch
SAME_RTOL = 1e-12


def _u0(rng, shape):
    return np.concatenate([rng.uniform(-1.0, 1.0, shape + (1,)),
                           rng.uniform(-0.5, 1.5, shape + (1,)),
                           rng.uniform(-1.5, 1.5, shape + (D,))], axis=-1)


def _tparams(a):
    return tk.GPParams(torch.tensor(a[..., 0]), torch.tensor(a[..., 1]),
                       torch.tensor(a[..., 2:]))


@pytest.fixture(scope="module")
def case():
    # config 5's recipe (bench/bench_ensemble.py:42-49) at a small size
    rng = np.random.default_rng(5)
    X = rng.uniform(size=(E, N, D))
    f = rng.uniform(1.0, 4.0, size=(E, 1))
    y = np.sin(f * X[..., 0]) + X[..., 1] ** 2
    Xs = rng.uniform(size=(E, M, D))
    u0 = _u0(rng, (E, R))
    cj = jcfg.GPConfig(nparams=D, regression_order=1, n_restarts=R,
                       max_opt_steps=STEPS)
    ct = tcfg.GPConfig(nparams=D, regression_order=1, n_restarts=R,
                       max_opt_steps=STEPS)
    Xt, yt = torch.tensor(X), torch.tensor(y)
    rj = jens.fit_ensemble_from_starts(
        jk.GPParams(jnp.asarray(u0[..., 0]), jnp.asarray(u0[..., 1]),
                    jnp.asarray(u0[..., 2:])),
        jnp.asarray(X), jnp.asarray(y), cj, STEPS)
    rt = tens.fit_ensemble_from_starts(_tparams(u0), Xt, yt, ct, STEPS)
    # predict at the same (JAX-fitted) params in both packages
    pj = jax.tree.map(np.asarray, rj.params)
    mj, vj = jens.predict_ensemble(rj.params, jnp.asarray(X), jnp.asarray(y),
                                   jnp.asarray(Xs), cj)
    mt, vt = tens.predict_ensemble(
        tk.GPParams(*(torch.tensor(a) for a in pj)), Xt, yt,
        torch.tensor(Xs), ct)
    return dict(X=X, y=y, Xt=Xt, yt=yt, u0=u0, ct=ct, rj=rj, rt=rt,
                pred_j=(np.asarray(mj), np.asarray(vj)),
                pred_t=(mt.numpy(), vt.numpy()))


def test_fit_ensemble_from_starts_matches_jax_f64(case):
    rj, rt = case["rj"], case["rt"]
    assert rt.restart_log_likelihoods.shape == (E, R)
    np.testing.assert_allclose(rt.restart_log_likelihoods.numpy(),
                               np.asarray(rj.restart_log_likelihoods),
                               rtol=LML_RTOL)
    np.testing.assert_allclose(rt.log_likelihood.numpy(),
                               np.asarray(rj.log_likelihood), rtol=LML_RTOL)
    for a, b in zip(rt.params, rj.params):
        assert a.shape[0] == E
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=PARAMS_RTOL)
    for a, b in zip(rt.restart_params, rj.restart_params):
        assert a.shape[:2] == (E, R)
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=PARAMS_RTOL)
    st = rt.stats
    assert st["n_steps"] == STEPS
    assert st["n_vg_calls"] >= 1 + st["linesearch_evals"]


@pytest.mark.parametrize("member", range(E))
def test_member_matches_single_member_fit(case, member):
    """Member e of the ensemble is what the port's fit_one_start gives on
    member e alone, from its R starts."""
    u0, ct, rt = case["u0"], case["ct"], case["rt"]
    best_u, best_negll = tfit.fit_one_start(
        _tparams(u0[member]), case["Xt"][member], case["yt"][member], ct,
        STEPS)
    np.testing.assert_allclose(-best_negll.numpy(),
                               rt.restart_log_likelihoods[member].numpy(),
                               rtol=SAME_RTOL)
    lo, hi = tfit._bounds_arrays(ct, torch.float64)
    for a, b in zip(tfit._u_to_params(best_u, lo, hi), rt.restart_params):
        np.testing.assert_allclose(a.numpy(), b[member].numpy(),
                                   rtol=SAME_RTOL)


def _fit(case, **kw):
    return tens.fit_ensemble(torch.Generator().manual_seed(3), case["Xt"],
                             case["yt"], case["ct"], **kw)


@pytest.fixture(scope="module")
def whole(case):
    return _fit(case)


def test_fit_ensemble_draws_each_members_starts_in_order(case, whole):
    """fit_ensemble draws sample_restarts once per member, in member order,
    and runs them as fit_ensemble_from_starts would."""
    g = torch.Generator().manual_seed(3)
    draws = [tfit.sample_restarts(g, case["ct"], R, dtype=torch.float64)
             for _ in range(E)]
    u0 = tk.GPParams(*(torch.stack(a) for a in zip(*draws)))
    ref = tens.fit_ensemble_from_starts(u0, case["Xt"], case["yt"],
                                        case["ct"], STEPS)
    assert torch.equal(whole.restart_log_likelihoods,
                       ref.restart_log_likelihoods)
    assert np.isfinite(whole.log_likelihood.numpy()).all()


@pytest.mark.parametrize("kw", [dict(ensemble_chunk=1),
                                dict(restart_split=1),
                                dict(ensemble_chunk=1, restart_split=1)],
                         ids=["ensemble_chunk", "restart_split", "both"])
def test_chunk_and_split_match_one_batch(case, whole, kw):
    """ensemble_chunk (sequential groups of members) and restart_split
    (sequential parts of the restarts, merged by a per-member argmax) run
    the same starts as one wide batch and give its result."""
    part = _fit(case, **kw)
    np.testing.assert_allclose(part.restart_log_likelihoods.numpy(),
                               whole.restart_log_likelihoods.numpy(),
                               rtol=SAME_RTOL)
    np.testing.assert_allclose(part.log_likelihood.numpy(),
                               whole.log_likelihood.numpy(), rtol=SAME_RTOL)
    for a, b in zip(part.params, whole.params):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=SAME_RTOL)
    for a, b in zip(part.restart_params, whole.restart_params):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=SAME_RTOL)
    groups = E if "ensemble_chunk" in kw else 1
    parts = R if "restart_split" in kw else 1
    assert part.stats["n_steps"] == groups * parts * STEPS


def test_ensemble_chunk_must_divide_e(case):
    with pytest.raises(ValueError, match="not divisible by ensemble_chunk"):
        _fit(case, ensemble_chunk=2)


def test_mesh_is_not_ported(case, whole):
    """A mesh argument must be a parallel.mesh.Mesh (anything else is
    refused); a virtual mesh, one shard a member, gives the one batch's
    fit and serve (tests/test_torch_mesh.py holds it against JAX's)."""
    with pytest.raises(TypeError, match="mesh"):
        _fit(case, mesh=object())
    with pytest.raises(TypeError, match="mesh"):
        tens.predict_ensemble(case["rt"].params, case["Xt"], case["yt"],
                              case["Xt"], case["ct"], mesh=object())
    mesh = tens.make_mesh(devices=["cpu"] * E)
    res = _fit(case, mesh=mesh)
    for a, b in zip(res[:4], whole[:4]):
        for u, v in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=SAME_RTOL)
    got = tens.predict_ensemble(case["rt"].params, case["Xt"], case["yt"],
                                case["Xt"], case["ct"], mesh=mesh)
    want = tens.predict_ensemble(case["rt"].params, case["Xt"], case["yt"],
                                 case["Xt"], case["ct"])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=SAME_RTOL,
                                   atol=1e-14)


def test_predict_ensemble_matches_jax_f64(case):
    (mj, vj), (mt, vt) = case["pred_j"], case["pred_t"]
    assert mt.shape == (E, M) and vt.shape == (E, M)
    np.testing.assert_allclose(mt, mj, rtol=PREDICT_RTOL, atol=1e-12)
    np.testing.assert_allclose(vt, vj, rtol=PREDICT_RTOL, atol=1e-12)


def test_float32_lanes_take_k1_and_k2_once_per_evaluation(case, monkeypatch):
    """At float32 every objective evaluation is ONE K1 call on the (E x R,
    N, d) per-lane designs and ONE K2 call on the (E x R, N, N) Grams (on
    the CPU the wrappers run their plain versions); predict_ensemble adds
    two K1 calls (Gram, cross) and one K2 call at batch E."""
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1

    calls = {"k1": [], "k2": []}

    def spy(name, fn):
        def run(A, *args, **kw):
            calls[name].append(tuple(A.shape))
            return fn(A, *args, **kw)
        return run

    monkeypatch.setattr(k1, "pairwise_covariance",
                        spy("k1", k1.pairwise_covariance))
    monkeypatch.setattr(k2, "cholesky", spy("k2", k2.cholesky))
    Xt, yt = case["Xt"].float(), case["yt"].float()
    res = tens.fit_ensemble(torch.Generator().manual_seed(3), Xt, yt,
                            case["ct"])
    n_evals = res.stats["n_vg_calls"] + res.stats["n_v_calls"]
    assert calls["k1"] == [(E * R, N, D)] * n_evals
    assert calls["k2"] == [(E * R, N, N)] * n_evals
    assert np.isfinite(res.log_likelihood.numpy()).all()
    mean, var = tens.predict_ensemble(res.params, Xt, yt, Xt[:, :M], case["ct"])
    assert calls["k1"][n_evals:] == [(E, N, D), (E, N, D)]
    assert calls["k2"][n_evals:] == [(E, N, N)]
    assert mean.dtype == torch.float32 and mean.shape == (E, M)
    assert bool(torch.isfinite(mean).all() and (var >= 0).all())
