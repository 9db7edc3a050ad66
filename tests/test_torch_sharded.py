"""The port's row-sharded matrix-free GP (parallel/iterative_sharded.py and
`mesh=` through models/iterative.py), data-parallel SGPR
(parallel/sparse_sharded.py) and walker sharding (models/calibrate.py)
against the JAX functions on the 8-virtual-device CPU mesh of
tests/conftest.py, and against the port's own unsharded runs, at float64.

The port's meshes are virtual: 8 slots on the CPU. Stochastic estimates
take the JAX package's own probes through `_draw_probes`
(tests/test_torch_iterative.py's `_jax_draws`). The samplers are held to
the port's unsharded chains from the same generator seed, at the JAX
test's tolerance (tests/test_calibrate.py:630-676). Each JAX reference is
jitted once (module-scoped fixtures).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu.models import gp as jgp
from madaiemulator_tpu.models import iterative as ji
from madaiemulator_tpu.models import sparse as jsp
from madaiemulator_tpu.ops import kernels as jk
from madaiemulator_tpu.parallel import iterative_sharded as jits
from madaiemulator_tpu.parallel import sparse_sharded as jss
from madaiemulator_tpu.utils import config as jcfg
from madaiemulator_tpu_torch.io import snapshot as tsnap
from madaiemulator_tpu_torch.models import calibrate as tcal
from madaiemulator_tpu_torch.models import gp as tgp
from madaiemulator_tpu_torch.models import iterative as ti
from madaiemulator_tpu_torch.models import sparse as tsp
from madaiemulator_tpu_torch.ops import kernels as tk
from madaiemulator_tpu_torch.parallel import iterative_sharded as tits
from madaiemulator_tpu_torch.parallel import mesh as tmesh
from madaiemulator_tpu_torch.parallel import sparse_sharded as tss
from madaiemulator_tpu_torch.utils import config as tcfg
from test_torch_iterative import _jax_draws
from torch_mesh_fixture import conditioned_golden
import torch_shared  # noqa: F401

CPU8 = ["cpu"] * 8
# the JAX tests' tolerances (tests/test_iterative_sharded.py,
# tests/test_sparse.py:434-474, tests/test_calibrate.py:643-644)
MATVEC_RTOL = 1e-9
LML_RTOL, GRAD_RTOL = 1e-8, 1e-6
ELBO_RTOL = 1e-9
CHAIN = dict(rtol=2e-5, atol=1e-6)
THETA = (np.log(1.3), np.log(1e-2), np.log(np.array([0.6, 0.9])))


def _problem(n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, 2))
    y = np.sin(3 * X[:, 0]) + 0.5 * X[:, 1] + 0.05 * rng.standard_normal(n)
    nz = 10.0 ** rng.uniform(-3, -1, size=n)
    return X, y, nz


def _cfgs():
    return (jcfg.GPConfig(nparams=2, regression_order=1),
            tcfg.GPConfig(nparams=2, regression_order=1))


def _jp():
    return jk.GPParams(*(jnp.asarray(t) for t in THETA))


def _tp():
    return tk.GPParams(*(torch.tensor(t) for t in THETA))


def _close(got, want, rtol, atol=1e-13):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def jmesh():
    return jits.make_rows_mesh(8)


@pytest.fixture(scope="module")
def tmesh8():
    return tits.make_rows_mesh(devices=CPU8)


def test_rows_mesh_validates(tmesh8):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tits.make_rows_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tss.make_rows_mesh(2)
    assert tss.make_rows_mesh(devices=["cpu"] * 3).shape == {"rows": 3}
    # 52 rows on 8 slots: 7 a block (the JAX layout pads to 56)
    assert [b[1:] for b in tits.row_blocks(52, tmesh8)] == [
        (7 * i, min(7 * i + 7, 52)) for i in range(8)]


@pytest.mark.parametrize("n,noise", [(52, False), (64, False), (52, True)])
def test_sharded_gram_matvec_matches_jax(jmesh, tmesh8, n, noise):
    """52 rows: 7 a shard and a short last block (JAX pads it); each block
    in chunks of 4 rows, the last one ragged."""
    X, _, nz = _problem(n)
    cj, ct = _cfgs()
    V = np.random.default_rng(1).standard_normal((n, 3))
    want = jax.jit(lambda X, V, nz: jits.sharded_gram_matvec(
        X, _jp(), cj, V, jmesh, row_chunk=4, noise=nz))(
        jnp.asarray(X), jnp.asarray(V), jnp.asarray(nz) if noise else None)
    got = tits.sharded_gram_matvec(torch.tensor(X), _tp(), ct,
                                   torch.tensor(V), tmesh8, row_chunk=4,
                                   noise=torch.tensor(nz) if noise else None)
    _close(got, want, MATVEC_RTOL, atol=1e-12)
    C = tk.gram_matrix(torch.tensor(X), _tp(), ct).numpy()
    _close(got, (C + (np.diag(nz) if noise else 0.0)) @ V, MATVEC_RTOL,
           atol=1e-12)
    one = tits.sharded_gram_matvec(torch.tensor(X), _tp(), ct,
                                   torch.tensor(V[:, 0]), tmesh8,
                                   noise=torch.tensor(nz) if noise else None)
    assert one.shape == (n,)
    _close(one, got[:, 0], MATVEC_RTOL, atol=1e-12)


def test_pcg_and_slq_sharded_match(tmesh8):
    """pcg_solve_sharded against the direct solve and the port's unsharded
    PCG; slq_logdet_sharded in exact-probe mode against slogdet (the JAX
    tests' cases, tests/test_iterative_sharded.py:66-90)."""
    X, _, _ = _problem(56)
    _, ct = _cfgs()
    Xt, p = torch.tensor(X), _tp()
    C = tk.gram_matrix(Xt, p, ct).numpy()
    B = np.random.default_rng(2).standard_normal((56, 2))
    got, rel, _ = tits.pcg_solve_sharded(Xt, p, ct, torch.tensor(B), tmesh8,
                                         precond_rank=20, tol=1e-11,
                                         max_iters=300, row_chunk=7)
    _close(got, np.linalg.solve(C, B), 1e-6, atol=1e-8)
    assert float(rel.max()) < 1e-11
    pre = ti.make_preconditioner(ti.pivoted_cholesky(Xt, p, ct, 20),
                                 ti._ridge(p, tgp.GPData(X=Xt, y=Xt[:, 0]),
                                           ct))
    ref, _, _ = ti.pcg_solve(lambda V: ti.gram_matvec(Xt, p, ct, V),
                             torch.tensor(B), pre, tol=1e-11, max_iters=300)
    _close(got, ref, 1e-9, atol=1e-12)
    X32 = Xt[:32]
    est = tits.slq_logdet_sharded(X32, p, ct, tmesh8, seed=0, probes=32,
                                  lanczos_iters=32)
    C32 = tk.gram_matrix(X32, p, ct).numpy()
    assert np.isclose(est.item(), np.linalg.slogdet(C32)[1], rtol=1e-6)


@pytest.fixture(scope="module")
def lml_refs(jmesh):
    """JAX's sharded value and gradient (tests/test_iterative_sharded.py's
    case: n=40, rank 20, 12 probes, 24 Lanczos steps)."""
    X, y, _ = _problem(40)
    cj, _ = _cfgs()
    data = jgp.GPData(X=jnp.asarray(X), y=jnp.asarray(y))
    kw = dict(seed=0, rank=20, probes=12, lanczos_iters=24, cg_tol=1e-11,
              cg_max_iters=300)
    v, g = jax.jit(jax.value_and_grad(
        lambda pp, d: ji.lml_iterative(pp, d, cj, mesh=jmesh, **kw)))(
        _jp(), data)
    return X, y, kw, float(v), [np.asarray(a) for a in jax.tree.leaves(g)]


def _vg(f):
    leaves = [t.clone().requires_grad_(True) for t in _tp()]
    v = f(tk.GPParams(*leaves))
    return v.item(), [g.numpy() for g in torch.autograd.grad(v, leaves)]


def test_lml_iterative_on_mesh_matches_jax(lml_refs, tmesh8, monkeypatch):
    monkeypatch.setattr(ti, "_draw_probes", _jax_draws)
    X, y, kw, vj, gj = lml_refs
    _, ct = _cfgs()
    data = tgp.GPData(X=torch.tensor(X), y=torch.tensor(y))
    v1, g1 = _vg(lambda p: ti.lml_iterative(p, data, ct, mesh=tmesh8, **kw))
    v0, g0 = _vg(lambda p: ti.lml_iterative(p, data, ct, **kw))
    _close(v1, vj, LML_RTOL)
    _close(v1, v0, LML_RTOL)
    for a, b, c in zip(g1, gj, g0):
        _close(a, b, GRAD_RTOL)
        _close(a, c, GRAD_RTOL)
    # the serving precompute and the fit take the mesh too
    st1 = ti.precompute_iterative_predictor(_tp(), data, ct, rank=20,
                                            cg_tol=1e-11, cg_max_iters=300,
                                            mesh=tmesh8)
    st0 = ti.precompute_iterative_predictor(_tp(), data, ct, rank=20,
                                            cg_tol=1e-11, cg_max_iters=300)
    _close(st1.alpha, st0.alpha, 1e-8, atol=1e-10)
    fit = lambda **m: ti.fit_gp_iterative(
        torch.Generator().manual_seed(0), data, ct, n_restarts=1,
        max_steps=1, rank=20, probes=12, lanczos_iters=24, cg_tol=1e-11,
        cg_max_iters=300, **m)
    _close(fit(mesh=tmesh8).log_likelihood, fit().log_likelihood, 1e-8)


@pytest.fixture(scope="module")
def sparse_case(jmesh):
    """JAX's sharded ELBO without noise, with noise and with gradient rows
    (tests/test_sparse.py:434-474's cases at n=64, m=12), and its
    gradient in params."""
    rng = np.random.default_rng(3)
    n = 64
    X = rng.uniform(0, 1, (n, 2))
    y = np.sin(3 * X[:, 0]) + 0.5 * X[:, 1]
    nz = 10.0 ** rng.uniform(-4, -2, size=n)
    dY = np.stack([3 * np.cos(3 * X[:, 0]), 0.5 * np.ones(n)], axis=1)
    cj, _ = _cfgs()
    Z = np.asarray(jsp.select_inducing(jnp.asarray(X), 12))
    datas = {"plain": dict(), "noise": dict(noise=nz), "grad": dict(dY=dY)}
    vals = {k: float(jss.elbo_sharded(
        _jp(), jgp.GPData(X=jnp.asarray(X), y=jnp.asarray(y),
                          **{a: jnp.asarray(b) for a, b in kw.items()}),
        cj, jnp.asarray(Z), jmesh)) for k, kw in datas.items()}
    g = jax.jit(jax.grad(lambda pp: jsp.elbo(
        pp, jgp.GPData(X=jnp.asarray(X), y=jnp.asarray(y)), cj,
        jnp.asarray(Z))))(_jp())
    return X, y, Z, datas, vals, [np.asarray(a) for a in jax.tree.leaves(g)]


@pytest.mark.parametrize("kind", ["plain", "noise", "grad"])
def test_elbo_sharded_matches_jax(sparse_case, tmesh8, kind):
    X, y, Z, datas, vals, _ = sparse_case
    _, ct = _cfgs()
    data = tgp.GPData(X=torch.tensor(X), y=torch.tensor(y),
                      **{a: torch.tensor(b) for a, b in datas[kind].items()})
    got = tss.elbo_sharded(_tp(), data, ct, torch.tensor(Z), tmesh8)
    _close(got.item(), vals[kind], ELBO_RTOL)
    # row_chunk inside each shard: 8 rows a shard in chunks of 3
    chunked = tss.elbo_sharded(_tp(), data, ct, torch.tensor(Z), tmesh8,
                               row_chunk=3)
    _close(chunked.item(), vals[kind], ELBO_RTOL)
    shards = tss.shard_data_rows(data, tmesh8)
    assert len(shards) == 8 and all(s.X.shape == (8, 2) for s in shards)
    assert all((s.dY is None) == ("dY" not in datas[kind]) for s in shards)


@pytest.mark.parametrize("row_chunk", [None, 3])
def test_elbo_sharded_gradient(sparse_case, tmesh8, row_chunk):
    """Differentiable in (params, Z) across the shards, whole or in
    checkpointed row chunks within each shard."""
    X, y, Z, _, _, gj = sparse_case
    _, ct = _cfgs()
    data = tgp.GPData(X=torch.tensor(X), y=torch.tensor(y))
    Zt = torch.tensor(Z, requires_grad=True)
    leaves = [t.clone().requires_grad_(True) for t in _tp()]
    e = tss.elbo_sharded(tk.GPParams(*leaves), data, ct, Zt, tmesh8,
                         row_chunk=row_chunk)
    grads = torch.autograd.grad(e, leaves + [Zt])
    for a, b in zip(grads, gj):
        _close(a.numpy(), b, GRAD_RTOL, atol=1e-10)
    Z0 = torch.tensor(Z, requires_grad=True)
    e0 = tsp.elbo(_tp(), data, ct, Z0)
    (gz,) = torch.autograd.grad(e0, Z0)
    _close(grads[-1].numpy(), gz.numpy(), GRAD_RTOL, atol=1e-10)
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        tss.shard_data_rows(data._replace(X=data.X[:60], y=data.y[:60]),
                            tmesh8)


@pytest.fixture(scope="module")
def posterior(tmp_path_factory):
    emu, _, _ = tsnap.read_snapshot(
        conditioned_golden(tmp_path_factory.mktemp("sharded")),
        device=torch.device("cpu"))
    from madaiemulator_tpu_torch.models.multivariate import (
        predict_multivariate,
    )

    mid = (emu.scaling.mins + 0.45 * emu.scaling.ranges)[None]
    y_exp = predict_multivariate(emu, mid)[0][0].numpy()
    lp = tcal.make_log_posterior(emu, y_exp, np.full(y_exp.size, 0.05 ** 2))
    x0 = tcal.init_walkers(torch.Generator().manual_seed(9), emu, lp, 16)
    return emu, y_exp, lp, x0


@pytest.mark.parametrize("sampler,kw", [
    ("emcee", dict()), ("rwm", dict()), ("hmc", dict(n_leapfrog=3)),
    ("pt", dict(n_rungs=3))])
def test_sharded_walkers_match_unsharded(posterior, tmesh8, sampler, kw):
    run = {"emcee": tcal.run_emcee, "rwm": tcal.run_rwm,
           "hmc": tcal.run_hmc, "pt": tcal.run_parallel_tempering}[sampler]
    _, _, lp, x0 = posterior
    a = run(torch.Generator().manual_seed(1), lp, x0, 12, **kw)
    b = run(torch.Generator().manual_seed(1), lp, x0, 12, mesh=tmesh8,
            axis_name="rows", **kw)
    _close(b[0], a[0], **CHAIN)
    _close(b[1], a[1], **CHAIN)
    _close(float(b[2]), float(a[2]), 1e-6)


def test_calibrate_on_mesh(posterior):
    """Through the calibrate driver (mesh in sampler_kwargs); a walker mesh
    over other devices than the chain's needs the log-posterior's replicas
    (`on_device`), which a plain callable lacks."""
    emu, y_exp, lp, x0 = posterior
    var = np.full(y_exp.size, 0.05 ** 2)
    run = lambda **m: tcal.calibrate(torch.Generator().manual_seed(4), emu,
                                     y_exp, var, n_walkers=16, n_steps=12,
                                     burn_in=4, **m)
    want = run()
    got = run(mesh=tmesh.Mesh(CPU8, ("walkers",)))
    assert got.samples.shape == (8, 16, 3)
    _close(got.samples, want.samples, **CHAIN)
    assert got.acceptance == want.acceptance
    assert lp.on_device(torch.device("cpu")) is lp
    two = tmesh.Mesh([torch.device("cpu"), torch.device("meta")], ("w",))
    with pytest.raises(ValueError, match="make_log_posterior"):
        tcal._shard_walkers(lambda x: x[:, 0], two)(x0)
