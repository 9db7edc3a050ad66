"""Plain versions of the Hopper kernels K1 / K2 / K3 (madaiemulator_tpu_torch,
ops/hopper/) against the JAX package's Pallas kernels in interpret mode, on
the CPU. The same inputs, made with numpy from a seed, go through both.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py);
here every wrapper takes its plain version, because its tensors lie on the
CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu.ops.pallas.cholesky import (
    pallas_cholesky,
    pallas_panel_factor,
)
from madaiemulator_tpu.ops.pallas.pairwise import pairwise_covariance
from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
from madaiemulator_tpu_torch.ops.hopper import panel as k3
import torch_shared  # noqa: F401


def _k1_inputs(seed, n1, n2, d, gram):
    rng = np.random.default_rng(seed)
    U = (rng.uniform(size=(n1, d)) / 0.4).astype(np.float32)
    V = U if gram else (rng.uniform(size=(n2, d)) / 0.4).astype(np.float32)
    return U, V


@pytest.mark.parametrize("add_diag", [False, True])
@pytest.mark.parametrize("family", k1.FAMILIES)
def test_plain_k1_matches_pallas_interpret(family, add_diag):
    # Gram (with the diagonal add) or cross block, ragged against bm = bn = 16
    U, V = _k1_inputs(3, 40, 33, 3, gram=add_diag)
    amp, g = np.float32(1.3), np.float32(0.25)
    want = pairwise_covariance(
        jnp.asarray(U), jnp.asarray(V), amp, g, family=family,
        add_diag=add_diag, bm=16, bn=16, interpret=True,
    )
    got = k1.pairwise_covariance(
        torch.from_numpy(U)[None], torch.from_numpy(V)[None],
        torch.tensor([amp]), torch.tensor([g]), family, add_diag,
    )[0]
    # two f32 distance forms (direct difference vs ||u||^2+||v||^2-2u.v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    if add_diag:
        assert torch.equal(got, got.T)  # bitwise symmetric by construction


def test_plain_k1_batches_components():
    """One batched call equals per-component calls (batch = PCA axis)."""
    rng = np.random.default_rng(4)
    U = torch.tensor(rng.uniform(size=(3, 20, 4)), dtype=torch.float32)
    amp = torch.tensor([0.5, 1.0, 2.0])
    g = torch.tensor([1e-3, 1e-2, 1e-1])
    out = k1.pairwise_covariance(U, U, amp, g, "matern52", True)
    for b in range(3):
        one = k1.pairwise_covariance(U[b:b + 1], U[b:b + 1], amp[b:b + 1],
                                     g[b:b + 1], "matern52", True)
        assert torch.equal(out[b], one[0])


@pytest.mark.parametrize("family", k1.FAMILIES)
def test_plain_k1_matches_pallas_interpret_d8(family):
    """Config 4's width, d = 8: a Gram with the diagonal add, ragged against
    bm = bn = 16."""
    U, _ = _k1_inputs(8, 40, 40, 8, gram=True)
    amp, g = np.float32(0.8), np.float32(0.05)
    want = pairwise_covariance(
        jnp.asarray(U), jnp.asarray(U), amp, g, family=family,
        add_diag=True, bm=16, bn=16, interpret=True,
    )
    Ut = torch.from_numpy(U)[None]
    got = k1.pairwise_covariance(Ut, Ut, torch.tensor([amp]),
                                 torch.tensor([g]), family, True)[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(got, got.T)


def test_k1_gram_hands_the_wrapper_one_tensor(monkeypatch):
    """The Gram path passes ONE tensor as U and V (the kernel's triangle
    route), also when U's batch is broadcast from the parameters; a cross
    call passes two, even on the same points, and no diag_add; with or
    without autograd the values are the same."""
    from madaiemulator_tpu_torch.ops import kernels
    from madaiemulator_tpu_torch.utils.config import GPConfig

    seen = []
    real = k1.pairwise_covariance

    def spy(U, V, amp, diag_add, family, add_diag):
        seen.append((U, V, diag_add, add_diag))
        return real(U, V, amp, diag_add, family, add_diag)

    monkeypatch.setattr(k1, "pairwise_covariance", spy)
    rng = np.random.default_rng(9)
    X = torch.tensor(rng.uniform(size=(30, 4)), dtype=torch.float32)
    cfg = GPConfig(nparams=4)
    shared_ls = kernels.GPParams(  # length scales shared: U broadcast
        log_amp=torch.tensor([0.0, 0.3, -0.2]),
        log_nugget=torch.full((3,), -4.0),
        log_ls=torch.full((4,), -1.0))
    own_ls = shared_ls._replace(log_ls=torch.full((3, 4), -1.0))
    for p in (shared_ls, own_ls):
        K = kernels.gram_matrix(X, p, cfg)
        U, V, g, add = seen[-1]
        assert V is U and U.shape == (3, 30, 4) and add and g is not None
        assert torch.equal(K, kernels.gram_matrix(X, own_ls, cfg))
    kernels.cross_covariance(X, X, own_ls, cfg)
    U, V, g, add = seen[-1]
    assert V is not U and g is None and not add
    # with inputs that need a gradient the autograd.Function runs (its
    # library-math VJP is tested through the LML gradient) and gives the
    # same values
    p = kernels.GPParams(*(t.clone().requires_grad_() for t in own_ls))
    Kg = kernels.gram_matrix(X, p, cfg)
    assert seen[-1][1] is seen[-1][0]
    assert type(Kg.grad_fn).__name__ == "_K1GramBackward"
    assert torch.equal(Kg.detach(), K)


def test_k1_wrapper_routes_cpu_to_plain_and_rejects():
    U = torch.rand(2, 9, 3)
    amp = torch.ones(2)
    before = k1.launches
    got = k1.pairwise_covariance(U, U, amp, amp, "matern32", True)
    assert torch.equal(got, k1.pairwise_covariance_plain(U, U, amp, amp,
                                                         "matern32", True))
    assert k1.launches == before  # no kernel ran on the CPU
    with pytest.raises(ValueError):
        k1.pairwise_covariance(U, U, amp, amp, family="cauchy")
    meta = torch.empty(2, 9, 3, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k1.pairwise_covariance(meta, meta, amp, amp)


def _spd_batch(seed, b, n):
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((b, n, n)).astype(np.float32)
    return G @ G.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)


def test_plain_k2_matches_pallas_interpret():
    A = _spd_batch(5, 3, 128)
    want = jax.vmap(lambda a: pallas_cholesky(a, panel=64, interpret=True))(
        jnp.asarray(A)
    )
    got = k2.cholesky(torch.from_numpy(A))
    scale = np.abs(np.asarray(want)).max()
    # both f32 factors of cond ~ 10 matrices: agreement at f32 level
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * scale)
    assert torch.equal(got, torch.tril(got))


@pytest.mark.parametrize("n", [1, 31, 33, 100])
def test_plain_k2_ragged_sizes_match_float64(n):
    """n needs no padding: panels of 32 with a ragged last panel."""
    A = _spd_batch(n, 2, n)
    L = k2.cholesky(torch.from_numpy(A)).double().numpy()
    L64 = np.linalg.cholesky(A.astype(np.float64))
    assert np.abs(L - L64).max() <= 1e-5 * np.abs(L64).max()


def test_plain_k2_non_spd_gives_nan_not_garbage():
    A = _spd_batch(6, 3, 70)
    A[1] -= 400.0 * np.eye(70, dtype=np.float32)  # indefinite member
    before = k2.launches
    L = k2.cholesky(torch.from_numpy(A))
    assert k2.launches == before
    finite = torch.isfinite(L).flatten(1).all(1).tolist()
    assert finite == [True, False, True]
    assert torch.isnan(L[1]).any()
    with pytest.raises(ValueError, match="unsupported device"):
        k2.cholesky(torch.empty(1, 4, 4, device="meta"))


@pytest.mark.parametrize("b", [128, 256])
def test_plain_k3_matches_pallas_interpret(b):
    """(L, L^-1) of one panel against pallas_panel_factor in interpret mode
    (tests/test_pallas.py:107-116 inputs and bounds)."""
    A = _spd_batch(b, 1, b)
    Lj, invj = pallas_panel_factor(jnp.asarray(A[0]), panel=64,
                                   interpret=True)
    L, Linv = k3.panel_factor(torch.from_numpy(A))
    Lj, invj = np.asarray(Lj), np.asarray(invj)
    # two f32 factorizations / inverses of a cond ~ 10 matrix
    np.testing.assert_allclose(L[0].numpy(), Lj, rtol=0,
                               atol=1e-5 * np.abs(Lj).max())
    np.testing.assert_allclose(Linv[0].numpy(), invj, rtol=0,
                               atol=1e-5 * np.abs(invj).max())
    eye = Linv[0].double().numpy() @ L[0].double().numpy()
    assert np.abs(eye - np.eye(b)).max() <= 1e-4
    assert torch.equal(L, torch.tril(L)) and torch.equal(Linv, torch.tril(Linv))


def test_plain_k3_non_spd_nan_and_wrapper_checks():
    A = _spd_batch(7, 3, 96)
    A[2] -= 400.0 * np.eye(96, dtype=np.float32)  # indefinite member
    A[0] = np.tril(A[0]) + 1e30 * np.triu(np.ones((96, 96), np.float32), 1)
    before = k3.launches
    L, Linv = k3.panel_factor(torch.from_numpy(A))
    assert k3.launches == before  # no kernel ran on the CPU
    for out in (L, Linv):
        assert torch.isfinite(out).flatten(1).all(1).tolist() == [
            True, True, False]
        assert torch.isnan(out[2]).any()
    # only the lower triangle is read: member 0 equals its symmetric twin
    sym = torch.from_numpy(np.tril(A[0]) + np.tril(A[0], -1).T)[None]
    L0, Linv0 = k3.panel_factor(sym)
    assert torch.equal(L[0], L0[0]) and torch.equal(Linv[0], Linv0[0])
    with pytest.raises(ValueError, match="multiple of 32"):
        k3.panel_factor(torch.eye(40)[None])
    with pytest.raises(ValueError, match="unsupported device"):
        k3.panel_factor(torch.empty(1, 32, 32, device="meta"))


def test_library_path_follows_every_file_under_csrc(tmp_path):
    """The build is keyed by a hash of all sources AND headers: an edited
    header must not load a stale library."""
    import shutil

    from madaiemulator_tpu_torch.ops.hopper import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    assert build.library_path(csrc) == build.library_path()
    names = sorted(f.name for f in csrc.iterdir())
    assert any(n.endswith(".cuh") for n in names)
    assert set(build.SOURCES) <= set(names)
    seen = {build.library_path(csrc)}
    for name in names:
        f = csrc / name
        text = f.read_text()
        f.write_text(text + "// edited\n")
        seen.add(build.library_path(csrc))
        f.write_text(text)
    assert len(seen) == len(names) + 1
    assert build.library_path(csrc) == build.library_path()
