"""Hopper kernels K1 (pairwise covariance), K2 (batched Cholesky) and K3
(panel factor and inverse) on the card, against their plain-PyTorch versions
and a float64 reference.

Every test here needs an NVIDIA GPU and nvcc; on a machine without them each
skips with its reason. This file imports no jax, so it runs on a machine
that has only torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
from madaiemulator_tpu_torch.ops.hopper import panel as k3

pytestmark = pytest.mark.cuda

# K1 against its plain version: the distance is computed with the same fp32
# operations in the same order, so only expf may differ (<= 2 ulp of values
# at most amp + diag_add ~ 1.3).
K1_ATOL = 1e-6
# K2 against the plain version and against a float64 factor, relative to
# max |L|: both are float32 factorizations of Grams with cond <= ~1e4.
K2_RTOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _points(rng, b, n, d, ls=0.3):
    return torch.tensor(rng.uniform(size=(b, n, d)) / ls, dtype=torch.float32)


@pytest.mark.parametrize("family", k1.FAMILIES)
@pytest.mark.parametrize("n1,n2,d", [(512, 512, 6), (512, 1024, 6),
                                      (500, 37, 3), (70, 33, 40)])
def test_k1_matches_plain(dev, family, n1, n2, d):
    rng = np.random.default_rng(n1 + n2 + d)
    B = 4
    U = _points(rng, B, n1, d).to(dev)
    V = U if n1 == n2 else _points(rng, B, n2, d).to(dev)
    amp = torch.tensor([1.0, 0.5, 1.3, 2.0], device=dev)
    g = torch.tensor([1e-3, 1e-2, 0.1, 0.25], device=dev)
    add = n1 == n2
    got = k1.pairwise_covariance(U, V, amp, g, family, add)
    want = k1.pairwise_covariance_plain(U, V, amp, g, family, add)
    torch.cuda.synchronize()
    assert got.shape == (B, n1, n2)
    err = (got - want).abs().max().item()
    assert err <= K1_ATOL * 2.0, err
    if add:
        assert torch.equal(got, got.mT)  # bitwise symmetric Gram


def test_k1_counts_launches_and_rejects(dev):
    U = torch.rand(1, 8, 2, device=dev)
    one = torch.ones(1, device=dev)
    before = k1.launches
    k1.pairwise_covariance(U, U, one, one, "matern32", True)
    assert k1.launches == before + 1
    with pytest.raises(TypeError):
        k1.pairwise_covariance(U.double(), U.double(), one.double(),
                               one.double())
    with pytest.raises(ValueError):
        k1.pairwise_covariance(U.mT, U.mT, one, one)
    with pytest.raises(ValueError):
        k1.pairwise_covariance(U, U, one, one, family="cauchy")


def _grams(rng, B, n, d=6):
    U = _points(rng, B, n, d)
    amp = torch.ones(B)
    return k1.pairwise_covariance_plain(U, U, amp, torch.full((B,), 0.1),
                                        "power_exponential", True)


@pytest.mark.parametrize("n", [1, 31, 64, 100, 128, 500, 512, 1024])
def test_k2_matches_plain_and_f64(dev, n):
    rng = np.random.default_rng(n)
    A = _grams(rng, 4, n)
    Ad = A.to(dev)
    L = k2.cholesky(Ad)
    Lp = k2.cholesky_plain(Ad)
    L64 = torch.linalg.cholesky(A.double())
    torch.cuda.synchronize()
    scale = L64.abs().max().item()
    assert torch.equal(L, torch.tril(L))
    assert (L.cpu().double() - L64).abs().max().item() <= K2_RTOL * scale
    assert (L - Lp).abs().max().item() <= K2_RTOL * scale


def test_k2_non_spd_gives_nan(dev):
    rng = np.random.default_rng(1)
    A = _grams(rng, 3, 200).to(dev)
    A[1] -= 5.0 * torch.eye(200, device=dev)  # indefinite
    before = k2.launches
    L = k2.cholesky(A)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    bad = ~torch.isfinite(L).flatten(1).all(1)
    assert bad.tolist() == [False, True, False]
    assert torch.isnan(L[1]).any()


def test_jitter_ladder_on_the_card(dev):
    """A component that K2 cannot factor (NaN) is refactored with a larger
    jitter by the serve precompute; the SPD one keeps its state."""
    from madaiemulator_tpu_torch.models import gp
    from madaiemulator_tpu_torch.ops.kernels import GPParams
    from madaiemulator_tpu_torch.utils.config import GPConfig

    rng = np.random.default_rng(0)
    X = torch.tensor(rng.uniform(size=(60, 2)), dtype=torch.float32,
                     device=dev)
    y = torch.stack([torch.sin(3 * X[:, 0]), X[:, 1] ** 2])
    p = GPParams(
        log_amp=torch.zeros(2, device=dev),
        log_nugget=torch.log(torch.tensor([1e-3, 1e-12], device=dev)),
        log_ls=torch.log(torch.tensor([[0.3, 0.3], [3.0, 3.0]], device=dev)),
    )
    noise = torch.zeros(2, 60, device=dev)
    noise[1] = -5e-5  # indefinite at the base jitter, SPD at the first rung
    data = gp.GPData(X=X, y=y, noise=noise)
    cfg = GPConfig(nparams=2, jitter=0.0)
    before = k2.launches
    base = gp._factor(data, p, cfg)
    assert base.ok.tolist() == [True, False]
    st = gp.precompute_predictor(p, data, cfg)
    torch.cuda.synchronize()
    assert st.ok.tolist() == [True, True]
    assert k2.launches - before >= 3  # base + base again + one rung
    assert torch.equal(st.L[0], base.L[0])


@pytest.mark.parametrize("b", [32, 128, 512, 1024])
def test_k3_matches_plain_and_f64(dev, b):
    """K3 (L, L^-1) against its plain version and a float64 factor, to
    K2_RTOL x max|L| (max|L^-1| for the inverse); |L^-1 L - I| <= 1e-4 (the
    JAX bound, tests/test_pallas.py:116); zeros above the diagonal."""
    rng = np.random.default_rng(b)
    A = _grams(rng, 2, b)
    L, Linv = k3.panel_factor(A.to(dev))
    Lp, Linvp = k3.panel_factor_plain(A.to(dev))
    L64 = torch.linalg.cholesky(A.double())
    torch.cuda.synchronize()
    scale, iscale = L64.abs().max().item(), Linvp.abs().max().item()
    assert torch.equal(L, torch.tril(L)) and torch.equal(Linv, torch.tril(Linv))
    assert (L.cpu().double() - L64).abs().max().item() <= K2_RTOL * scale
    assert (L - Lp).abs().max().item() <= K2_RTOL * scale
    assert (Linv - Linvp).abs().max().item() <= K2_RTOL * iscale
    eye = Linv.double() @ L.double()
    assert (eye - torch.eye(b, dtype=torch.float64, device=dev)).abs().max(
    ).item() <= 1e-4


def test_k3_non_spd_gives_nan_in_the_failed_member_only(dev):
    rng = np.random.default_rng(2)
    A = _grams(rng, 3, 256).to(dev)
    A[1] -= 5.0 * torch.eye(256, device=dev)  # indefinite
    before = k3.launches
    L, Linv = k3.panel_factor(A)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    for out in (L, Linv):
        assert torch.isfinite(out).flatten(1).all(1).tolist() == [
            True, False, True]
        assert torch.isnan(out[1]).any()


def test_k3_refuses_what_it_does_not_take(dev):
    A = torch.eye(64, device=dev)[None].repeat(2, 1, 1)
    with pytest.raises(TypeError):
        k3.panel_factor(A.double())
    with pytest.raises(ValueError, match="contiguous"):
        k3.panel_factor(A.mT)
    with pytest.raises(ValueError, match="multiple of 32"):
        k3.panel_factor(torch.eye(40, device=dev)[None])
    with pytest.raises(ValueError):
        k3.panel_factor(A[0])


def test_large_n_factor_goes_through_k3(dev):
    """`_factor` above pallas_cholesky_max_n with cholesky_method="pallas"
    runs the left-looking factorization with K3 on every panel, and its
    factor matches the library route's."""
    import dataclasses

    from madaiemulator_tpu_torch.models import gp
    from madaiemulator_tpu_torch.ops.kernels import GPParams
    from madaiemulator_tpu_torch.utils.config import GPConfig

    rng = np.random.default_rng(3)
    X = torch.tensor(rng.uniform(size=(1500, 4)), dtype=torch.float32,
                     device=dev)
    y = torch.sin(3 * X[:, 0]) + X[:, 1] ** 2
    p = GPParams(log_amp=torch.zeros((), device=dev),
                 log_nugget=torch.log(torch.tensor(1e-2, device=dev)),
                 log_ls=torch.log(torch.full((4,), 0.5, device=dev)))
    cfg = GPConfig(nparams=4, cholesky_block=512)
    before = k3.launches
    st = gp._factor(gp.GPData(X=X, y=y), p, cfg)
    torch.cuda.synchronize()
    assert k3.launches - before == 3  # N padded to 1536 = 3 panels of 512
    ref = gp._factor(gp.GPData(X=X, y=y), p,
                     dataclasses.replace(cfg, cholesky_method="xla"))
    assert bool(st.ok) and bool(ref.ok)
    scale = ref.L.abs().max().item()
    assert (st.L - ref.L).abs().max().item() <= K2_RTOL * scale
