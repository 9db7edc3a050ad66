"""The port's device mesh (madaiemulator_tpu_torch/parallel/mesh.py) and the
paths laid over it that the ensemble and the dense factor use: make_mesh,
fit_ensemble / fit_ensemble_from_starts over (ensemble) and (ensemble,
restart) meshes, predict_ensemble, predict_queries_sharded and
left_cholesky_sharded, against the JAX functions on the 8-virtual-device
CPU mesh of tests/conftest.py, at float64.

The port's meshes here are virtual: 8 slots on the CPU, the counterpart of
--xla_force_host_platform_device_count=8. JAX PRNG keys and torch
generators draw different restarts, so the JAX comparison feeds both
packages the same starts (numpy) through fit_ensemble_from_starts, as
tests/test_torch_ensemble.py does; one JAX compile per function, in
module-scoped fixtures.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from madaiemulator_tpu.io import snapshot as jsnap
from madaiemulator_tpu.ops import kernels as jk
from madaiemulator_tpu.ops import linalg as jlinalg
from madaiemulator_tpu.parallel import ensemble as jens
from madaiemulator_tpu.utils import config as jcfg
from madaiemulator_tpu_torch.io import snapshot as tsnap
from madaiemulator_tpu_torch.models import multivariate as tmv
from madaiemulator_tpu_torch.ops import kernels as tk
from madaiemulator_tpu_torch.ops import linalg as tlinalg
from madaiemulator_tpu_torch.parallel import ensemble as tens
from madaiemulator_tpu_torch.parallel import mesh as tmesh
from madaiemulator_tpu_torch.utils import config as tcfg
from torch_mesh_fixture import conditioned_golden
import torch_shared  # noqa: F401

E, N, D, R, STEPS, M = 4, 12, 2, 2, 3, 7
CPU8 = ["cpu"] * 8
# the JAX tests' tolerances (tests/test_ensemble.py:66-82, :159-176,
# tests/test_linalg.py:131-141)
LML_RTOL = 1e-6
PREDICT_RTOL = 1e-10
FACTOR_RTOL = 1e-9


def _u0(rng, shape):
    return np.concatenate([rng.uniform(-1.0, 1.0, shape + (1,)),
                           rng.uniform(-0.5, 1.5, shape + (1,)),
                           rng.uniform(-1.5, 1.5, shape + (D,))], axis=-1)


def _tparams(a):
    return tk.GPParams(torch.tensor(a[..., 0]), torch.tensor(a[..., 1]),
                       torch.tensor(a[..., 2:]))


def _jparams(a):
    return jk.GPParams(jnp.asarray(a[..., 0]), jnp.asarray(a[..., 1]),
                       jnp.asarray(a[..., 2:]))


@pytest.fixture(scope="module")
def case():
    # config 5's recipe (bench/bench_ensemble.py:42-49) at a small size
    rng = np.random.default_rng(12)
    X = rng.uniform(size=(E, N, D))
    f = rng.uniform(1.0, 4.0, size=(E, 1))
    y = np.sin(f * X[..., 0]) + X[..., 1] ** 2
    Xs = rng.uniform(size=(E, M, D))
    u0 = _u0(rng, (E, R))
    # the backtracking linesearch: half the JAX compile of the zoom's
    cj = jcfg.GPConfig(nparams=D, regression_order=1, n_restarts=R,
                       max_opt_steps=STEPS, linesearch="backtracking")
    ct = tcfg.GPConfig(nparams=D, regression_order=1, n_restarts=R,
                       max_opt_steps=STEPS, linesearch="backtracking")
    # JAX: starts at P(ensemble, restart), designs at P(ensemble), as
    # tests/test_ensemble.py:190-206 places them
    jm = jens.make_mesh(E, restart_shards=2)
    put = lambda a, spec: jax.device_put(a, NamedSharding(jm, spec))
    rj = jens.fit_ensemble_from_starts(
        jax.tree.map(lambda a: put(a, P("ensemble", "restart")),
                     _jparams(u0)),
        put(jnp.asarray(X), P("ensemble")), put(jnp.asarray(y), P("ensemble")),
        cj, STEPS)
    pj = jax.tree.map(np.asarray, rj.params)
    mj, vj = jens.predict_ensemble(rj.params, jnp.asarray(X), jnp.asarray(y),
                                   jnp.asarray(Xs), cj,
                                   mesh=jens.make_mesh(4))
    return dict(X=torch.tensor(X), y=torch.tensor(y), Xs=torch.tensor(Xs),
                u0=u0, ct=ct, rj=rj, pj=pj,
                pred_j=(np.asarray(mj), np.asarray(vj)))


def test_make_mesh_validates():
    with pytest.raises(ValueError, match="not divisible"):
        tens.make_mesh(devices=CPU8, restart_shards=3)
    with pytest.raises(ValueError, match="n_devices=4"):
        tens.make_mesh(4, devices=CPU8)
    with pytest.raises(ValueError, match="empty"):
        tens.make_mesh(devices=[])
    if not torch.cuda.is_available():
        # no visible device: a mesh raises, it never falls back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tens.make_mesh()
    mesh = tens.make_mesh(devices=CPU8, restart_shards=2)
    assert mesh.shape == {"ensemble": 4, "restart": 2} and mesh.size == 8
    assert mesh.axis_names == (tens.ENSEMBLE_AXIS, tens.RESTART_AXIS)
    assert mesh.first == torch.device("cpu") and len(mesh.distinct) == 1
    assert len(mesh.axis_devices("restart")) == 2


@pytest.mark.parametrize("restart_shards", [1, 2])
def test_fit_ensemble_from_starts_on_mesh_matches_jax(case, restart_shards):
    mesh = tens.make_mesh(devices=["cpu"] * E,
                          restart_shards=restart_shards)
    rt = tens.fit_ensemble_from_starts(_tparams(case["u0"]), case["X"],
                                       case["y"], case["ct"], STEPS,
                                       mesh=mesh)
    np.testing.assert_allclose(rt.log_likelihood.numpy(),
                               np.asarray(case["rj"].log_likelihood),
                               rtol=LML_RTOL)
    np.testing.assert_allclose(rt.restart_log_likelihoods.numpy(),
                               np.asarray(case["rj"].restart_log_likelihoods),
                               rtol=LML_RTOL)
    assert rt.restart_params.log_ls.shape == (E, R, D)
    shards = rt.stats["shards"]
    assert len(shards) == E
    assert rt.stats["n_vg_calls"] == sum(s["n_vg_calls"] for s in shards)


def _fit_generator(case, **kw):
    return tens.fit_ensemble(torch.Generator().manual_seed(7), case["X"],
                             case["y"], case["ct"], **kw)


@pytest.fixture(scope="module")
def whole(case):
    return _fit_generator(case)


@pytest.mark.parametrize("restart_shards", [1, 2])
def test_fit_ensemble_on_mesh_equals_one_batch(case, whole, restart_shards):
    """The starts are drawn before the split, and a lane's trajectory does
    not depend on its batch: every layout gives one batch's fit, and
    ensemble_chunk keeps working inside each shard."""
    got = _fit_generator(case, mesh=tens.make_mesh(
        devices=["cpu"] * 4, restart_shards=restart_shards),
        ensemble_chunk=restart_shards)
    np.testing.assert_allclose(got.log_likelihood.numpy(),
                               whole.log_likelihood.numpy(), rtol=1e-12)
    for a, b in zip(got.params, whole.params):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)


def test_predict_ensemble_on_mesh_matches_jax(case):
    mesh = tens.make_mesh(devices=["cpu"] * 4)
    mt, vt = tens.predict_ensemble(_tparams(np.concatenate(
        [case["pj"].log_amp[:, None], case["pj"].log_nugget[:, None],
         case["pj"].log_ls], axis=-1)), case["X"], case["y"], case["Xs"],
        case["ct"], mesh=mesh)
    mj, vj = case["pred_j"]
    assert mt.shape == (E, M)
    np.testing.assert_allclose(mt.numpy(), mj, rtol=PREDICT_RTOL, atol=1e-12)
    np.testing.assert_allclose(vt.numpy(), vj, rtol=PREDICT_RTOL, atol=1e-12)


@pytest.fixture(scope="module")
def snapshot_pair(tmp_path_factory):
    path = conditioned_golden(tmp_path_factory.mktemp("mesh"))
    emu_j, _, _ = jsnap.read_snapshot(path)
    emu_t, _, _ = tsnap.read_snapshot(path, device=torch.device("cpu"))
    return emu_j, emu_t


@pytest.mark.parametrize("m", [19, 2])  # 19: not % 8; 2: fewer than the axis
def test_predict_queries_sharded_matches_jax(snapshot_pair, m):
    emu_j, emu_t = snapshot_pair
    lo, span = np.asarray(emu_j.scaling.mins), np.asarray(emu_j.scaling.ranges)
    q = lo + span * np.random.default_rng(m).uniform(size=(m, lo.size))
    mt, vt = tens.predict_queries_sharded(emu_t, q,
                                          mesh=tens.make_mesh(devices=CPU8))
    assert mt.shape == (m, emu_t.n_outputs)
    if m > 8:  # one JAX compile: the m < axis case is held to the port's
        # one-batch serve, as tests/test_ensemble.py:159 holds JAX's
        mj, vj = jens.predict_queries_sharded(emu_j, jnp.asarray(q),
                                              mesh=jens.make_mesh(8))
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-8,
                                   atol=1e-14)
    local = tmv.predict_multivariate(emu_t, q)
    np.testing.assert_allclose(mt.numpy(), local[0].numpy(), rtol=1e-10)
    np.testing.assert_allclose(vt.numpy(), local[1].numpy(), rtol=1e-8,
                               atol=1e-14)


def test_mesh_map_runs_each_shard_in_order():
    """Mesh.map runs the shards from the calling thread in shard order, in
    the caller's grad mode, and a shard's error reaches the caller."""
    mesh = tens.make_mesh(devices=CPU8)
    seen = mesh.map(["cpu"] * 3, lambda i: (i, torch.is_grad_enabled(),
                                            threading.current_thread()),
                    [0, 1, 2])
    assert [s[0] for s in seen] == [0, 1, 2] and all(s[1] for s in seen)
    assert all(s[2] is threading.current_thread() for s in seen)
    with torch.no_grad():
        assert not any(g for _, g, _ in mesh.map(
            ["cpu"] * 2, lambda i: (i, torch.is_grad_enabled(), 0), [0, 1]))

    def boom(i):
        if i == 1:
            raise RuntimeError("shard 1 failed")
        return i

    with pytest.raises(RuntimeError, match="shard 1 failed"):
        mesh.map(["cpu"] * 3, boom, [0, 1, 2])
    assert tmesh.blocks(10, 4) == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert tmesh.blocks(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    wrapped = tmesh.split(torch.arange(3), 4, wrap=True)
    assert [t.tolist() for t in wrapped] == [[0], [1], [2], [0]]


def test_left_cholesky_sharded_matches_jax():
    rng = np.random.default_rng(0)
    n, block = 256, 64
    B = rng.standard_normal((n, n))
    A = B @ B.T / n + np.eye(n)
    jmesh = JMesh(np.asarray(jax.devices()[:8]), ("rows",))
    Lj = np.asarray(jlinalg.left_cholesky_sharded(jnp.asarray(A), jmesh,
                                                  block=block))
    mesh = tmesh.Mesh(CPU8, ("rows",))
    At = torch.tensor(A)
    Lt = tlinalg.left_cholesky_sharded(At, mesh, block=block)
    np.testing.assert_allclose(Lt.numpy(), Lj, rtol=FACTOR_RTOL, atol=1e-14)
    np.testing.assert_allclose(Lt.numpy(), np.linalg.cholesky(A),
                               rtol=FACTOR_RTOL, atol=1e-14)
    # each shard holds its own rows of the factor: 32 of them, so every
    # 64-wide diagonal block spans two shards
    owners, Ls = tlinalg._left_cholesky_shards(At, mesh, "rows", block,
                                               "highest")
    assert [(r0, r1) for _, r0, r1 in owners] == [(32 * i, 32 * i + 32)
                                                 for i in range(8)]
    for (_, r0, r1), L in zip(owners, Ls):
        np.testing.assert_allclose(L.numpy(), np.linalg.cholesky(A)[r0:r1],
                                   rtol=FACTOR_RTOL, atol=1e-14)
    # differentiable: the Murray backward, as left_cholesky
    Ag = At.clone().requires_grad_(True)
    tlinalg.left_cholesky_sharded(Ag, mesh, block=block).sum().backward()
    Ar = At.clone().requires_grad_(True)
    tlinalg.left_cholesky(Ar, block=block).sum().backward()
    np.testing.assert_allclose(Ag.grad.numpy(), Ar.grad.numpy(), rtol=1e-9,
                               atol=1e-12)
    with pytest.raises(ValueError, match="pad_spd"):
        tlinalg.left_cholesky_sharded(At[:200, :200], mesh, block=block)
