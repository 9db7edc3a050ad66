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


def _k1_inputs(rng, B, n1, n2, d, gram):
    U = _points(rng, B, n1, d)
    V = U if gram else _points(rng, B, n2, d)
    amp = torch.tensor(rng.uniform(0.5, 2.0, B), dtype=torch.float32)
    g = torch.tensor(rng.uniform(1e-3, 0.3, B), dtype=torch.float32)
    return U, V, amp, g


@pytest.mark.parametrize("family", k1.FAMILIES)
@pytest.mark.parametrize("d", [1, 3, 6, 8, 16, 32, 33, 40])
def test_k1_every_width(dev, family, d):
    """Every template width of the kernel and the runtime loop beyond 32
    (33, 40: two stages), batch 3: on 128-tiles a Gram (triangle route, 135
    tiles, ragged 1100 = 8 x 128 + 76) and a cross whose n2 = 701 is not a
    multiple of 4 (4-byte stores); on 64-tiles (128-tiles for fewer than
    half the SMs) the same at 129 x 129 and 129 x 37."""
    rng = np.random.default_rng(d)
    for n1, n2, gram in ((1100, 1100, True), (1100, 701, False),
                         (129, 129, True), (129, 37, False)):
        U, V, amp, g = (t.to(dev) for t in _k1_inputs(rng, 3, n1, n2, d, gram))
        got = k1.pairwise_covariance(U, V, amp, g, family, gram)
        want = k1.pairwise_covariance_plain(U, V, amp, g, family, gram)
        torch.cuda.synchronize()
        assert got.shape == (3, n1, n2)
        assert (got - want).abs().max().item() <= K1_ATOL * 2.0
        if gram:
            assert torch.equal(got, got.mT)


@pytest.mark.parametrize("n", [1, 37, 127, 129, 500])
def test_k1_ragged_sizes(dev, n):
    """Ragged n on both routes: the Gram, and one query (n2 = 1, the
    serve path's single request), batch 3."""
    rng = np.random.default_rng(n)
    for n2, gram in ((n, True), (1, False)):
        U, V, amp, g = (t.to(dev) for t in _k1_inputs(rng, 3, n, n2, 6, gram))
        got = k1.pairwise_covariance(U, V, amp, g, "matern52", gram)
        want = k1.pairwise_covariance_plain(U, V, amp, g, "matern52", gram)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= K1_ATOL * 2.0
        if gram:
            assert torch.equal(got, got.mT)


def test_k1_more_tiles_than_the_grid(dev):
    """(3, 4100, 4100): 33 tile rows, 561 triangle tiles per member, 1,683
    in all, several per CTA of the persistent grid; and the cross of the
    same points, 3,267 tiles."""
    rng = np.random.default_rng(11)
    U, _, amp, g = (t.to(dev) for t in _k1_inputs(rng, 3, 4100, 4100, 8, True))
    tri = k1.pairwise_covariance(U, U, amp, g, "power_exponential", True)
    want = k1.pairwise_covariance_plain(U, U, amp, g, "power_exponential",
                                        True)
    torch.cuda.synchronize()
    assert (tri - want).abs().max().item() <= K1_ATOL * 2.0
    assert torch.equal(tri, tri.mT)
    del want
    # the full route (distinct tensors, same points) gives the same bits:
    # the mirrored entries are (b - a)^2 sums, equal to (a - b)^2 exactly
    full = k1.pairwise_covariance(U, U.clone(), amp, g, "power_exponential",
                                  True)
    assert torch.equal(tri, full)


def test_k1_cross_takes_no_diag_add(dev):
    U = torch.rand(2, 40, 5, device=dev)
    V = torch.rand(2, 70, 5, device=dev)
    amp = torch.ones(2, device=dev)
    got = k1.pairwise_covariance(U, V, amp, None, "matern32")
    want = k1.pairwise_covariance_plain(U, V, amp, None, "matern32")
    assert (got - want).abs().max().item() <= K1_ATOL * 2.0
    with pytest.raises(ValueError, match="needs diag_add"):
        k1.pairwise_covariance(U, U, amp, None, "matern32", True)


@pytest.mark.parametrize("n1,n2", [(300, 200), (2000, 1000)])
@pytest.mark.parametrize("gram", [True, False])
def test_k1_repeat_bitwise_and_side_stream(dev, gram, n1, n2):
    """20 calls bitwise equal, and a call on a non-default stream equal to
    them, on 64-tiles (300) and on 128-tiles (2000)."""
    rng = np.random.default_rng(12)
    U, V, amp, g = (t.to(dev) for t in _k1_inputs(rng, 4, n1, n2, 8, gram))
    first = k1.pairwise_covariance(U, V, amp, g, "power_exponential", gram)
    for _ in range(19):
        again = k1.pairwise_covariance(U, V, amp, g, "power_exponential", gram)
        assert torch.equal(first, again)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got = k1.pairwise_covariance(U, V, amp, g, "power_exponential", gram)
    side.synchronize()
    assert torch.equal(first, got)


def _grams(rng, B, n, d=6):
    U = _points(rng, B, n, d)
    amp = torch.ones(B)
    return k1.pairwise_covariance_plain(U, U, amp, torch.full((B,), 0.1),
                                        "power_exponential", True)


@pytest.mark.parametrize("n", [1, 31, 33, 64, 100, 128, 500, 512, 1024])
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


def _k2_k3(A):
    """K2's factor and, where the side allows it, K3's pair."""
    out = (k2.cholesky(A),)
    return out + k3.panel_factor(A) if A.shape[-1] % 32 == 0 else out


@pytest.mark.parametrize("B,n", [(4, 512), (1, 1024), (4, 500), (2, 480)])
def test_k2_k3_repeat_bitwise(dev, B, n):
    """One launch of co-operating CTAs: a race between them would show as a
    difference between calls on the same input."""
    A = _grams(np.random.default_rng(n), B, n).to(dev)
    first = _k2_k3(A)
    for _ in range(19):
        again = _k2_k3(A)
        assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.parametrize("B,n,C", [(32, 512, 2), (16, 512, 4),
                                   (4, 512, 16)])
def test_k2_k3_skewed_build_bitwise(dev, B, n, C):
    """The test-only skewed build, in which every CTA but rank 0 waits
    before each diagonal-block load, gives the production build's bits: no
    CTA's store overtakes another CTA's load of the same addresses."""
    from madaiemulator_tpu_torch.ops.hopper import build
    from madaiemulator_tpu_torch.tools import cluster_skew

    assert build.load().madai_cluster_size(B, n) == C
    r = cluster_skew.compare(cluster_skew.gram(B, n, B * n, dev))
    assert r["C"] == C
    for out in ("K2 L", "K3 L", "K3 Linv"):
        assert r[out]["equal"], (out, r[out])


@pytest.mark.parametrize("B,n", [(40, 256), (300, 128)])
def test_k2_k3_more_clusters_than_the_card_holds(dev, B, n):
    A = _grams(np.random.default_rng(B), B, n)
    L, L3, Linv = _k2_k3(A.to(dev))
    L64 = torch.linalg.cholesky(A.double())
    torch.cuda.synchronize()
    scale = L64.abs().max().item()
    assert (L.cpu().double() - L64).abs().max().item() <= K2_RTOL * scale
    assert (L3.cpu().double() - L64).abs().max().item() <= K2_RTOL * scale
    eye = torch.eye(n, dtype=torch.float64, device=dev)
    assert (Linv.double() @ L3.double() - eye).abs().max().item() <= 1e-4
    assert torch.equal(L, torch.tril(L)) and torch.equal(Linv, torch.tril(Linv))


def test_k2_k3_on_a_side_stream(dev):
    A = _grams(np.random.default_rng(5), 4, 512).to(dev)
    want = _k2_k3(A)
    torch.cuda.synchronize()
    side = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(side):
        got = _k2_k3(A)
    side.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(want, got))


@pytest.mark.parametrize("B,n,want", [
    (4, 512, 16),    # the multivariate serve path: r = 4 components
    (1, 512, 16),    # config 4: one diagonal panel of cholesky_block = 512
    (2, 512, 16),    # the fit: both restarts' panels in one batch
    (1, 1024, 16),   # cholesky_block = 1024
    (32, 512, 2),    # a fit-loop batch: the batch alone fills the card
    (40, 256, 2), (300, 128, 1), (4, 33, 2), (4, 32, 1), (1, 1, 1),
])
def test_cluster_size_rule(dev, B, n, want):
    """CTAs per matrix of the K2 / K3 launch: one per 32 rows up to 16,
    halved while the batch would need a second wave of clusters; and the
    card can schedule a cluster of that size."""
    from madaiemulator_tpu_torch.ops.hopper import build

    lib = build.load()
    assert lib.madai_cluster_size(B, n) == want
    assert lib.madai_cholesky_max_active_clusters(want) > 0


def test_k2_reads_only_the_lower_triangle(dev):
    A = _grams(np.random.default_rng(6), 2, 160).to(dev)
    poisoned = torch.tril(A) + 1e30 * torch.triu(torch.ones_like(A), 1)
    assert torch.equal(k2.cholesky(A), k2.cholesky(poisoned))
    for x, y in zip(k3.panel_factor(A), k3.panel_factor(poisoned)):
        assert torch.equal(x, y)


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


@pytest.mark.parametrize("b", [32, 64, 96, 128, 512, 1024])
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


@pytest.mark.parametrize("B", [16, 20])
def test_k2_at_the_fit_batch(dev, B):
    """K2 at the config-3 fit's (components x restarts, 512, 512) batches
    against its plain version and float64."""
    rng = np.random.default_rng(B)
    A = _grams(rng, B, 512)
    Ad = A.to(dev)
    L = k2.cholesky(Ad)
    Lp = k2.cholesky_plain(Ad)
    L64 = torch.linalg.cholesky(A.double())
    torch.cuda.synchronize()
    scale = L64.abs().max().item()
    assert (L.cpu().double() - L64).abs().max().item() <= K2_RTOL * scale
    assert (L - Lp).abs().max().item() <= K2_RTOL * scale


def _fit_problem(dev, n=128, d=3, R=16):
    from madaiemulator_tpu_torch.models import gp

    rng = np.random.default_rng(7)
    X = rng.uniform(size=(n, d))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 - 0.5 * X[:, 2]
    data = gp.GPData(X=torch.tensor(X, dtype=torch.float32, device=dev),
                     y=torch.tensor(y, dtype=torch.float32, device=dev))
    return data, R


def test_fit_gp_kernels_match_library_route(dev):
    """fit_gp at float32 on K1 + K2 and on the library route from the same
    restarts (16 lanes of (128, 128) Grams, 8 LBFGS steps): the best thetas
    of each, scored by the float64 LML, agree to 1e-3 of the value, and the
    kernel route launches K1 and K2 once per objective evaluation."""
    import dataclasses

    from madaiemulator_tpu_torch.models import fit, gp
    from madaiemulator_tpu_torch.utils.config import GPConfig

    data, R = _fit_problem(dev)
    cfg = GPConfig(nparams=3, regression_order=1, n_restarts=R,
                   max_opt_steps=8)
    lib = dataclasses.replace(cfg, gram_method="xla", cholesky_method="xla")
    k1_0, k2_0 = k1.launches, k2.launches
    rk = fit.fit_gp(torch.Generator().manual_seed(0), data, cfg)
    torch.cuda.synchronize()
    n_evals = rk.stats["n_vg_calls"] + rk.stats["n_v_calls"]
    assert k1.launches - k1_0 == n_evals
    assert k2.launches - k2_0 == n_evals
    rl = fit.fit_gp(torch.Generator().manual_seed(0), data, lib)
    d64 = gp.GPData(X=data.X.double(), y=data.y.double())

    def ll64(p):
        p = type(p)(*(a.double() for a in p))
        with torch.no_grad():
            return gp.log_marginal_likelihood(p, d64, cfg).item()

    a, b = ll64(rk.params), ll64(rl.params)
    assert np.isfinite(a) and np.isfinite(b)
    assert abs(a - b) <= 1e-3 * abs(b), (a, b)


# --- BASELINE config 5: K1 and K2 at the ensemble's shapes ------------------


@pytest.mark.parametrize("B", [8192, 2048])
def test_k2_at_the_ensemble_batch(dev, B):
    """K2 at config 5's (E x R = 8192, 64, 64) fit batch and (E = 2048, 64,
    64) predict batch (one CTA per matrix at these batches): against its
    plain version and float64, lower triangular, 20 calls bitwise equal."""
    A = _grams(np.random.default_rng(B), B, 64)
    Ad = A.to(dev)
    L = k2.cholesky(Ad)
    Lp = k2.cholesky_plain(Ad)
    L64 = torch.linalg.cholesky(A.double())
    torch.cuda.synchronize()
    scale = L64.abs().max().item()
    assert torch.equal(L, torch.tril(L))
    assert (L.cpu().double() - L64).abs().max().item() <= K2_RTOL * scale
    assert (L - Lp).abs().max().item() <= K2_RTOL * scale
    for _ in range(19):
        assert torch.equal(k2.cholesky(Ad), L)


@pytest.mark.parametrize("route,B,n1,n2", [("gram", 8192, 64, 64),
                                           ("cross", 2048, 64, 256)])
def test_k1_at_the_ensemble_batch(dev, route, B, n1, n2):
    """K1 at config 5's per-lane Gram (8192 lanes, each on its own (64, 4)
    design) and predict's cross-covariance (2048 members x 256 queries),
    d = 4, against its plain version."""
    gram = route == "gram"
    rng = np.random.default_rng(B + n2)
    U, V, amp, g = (t.to(dev) for t in _k1_inputs(rng, B, n1, n2, 4, gram))
    got = k1.pairwise_covariance(U, V, amp, g, "power_exponential", gram)
    want = k1.pairwise_covariance_plain(U, V, amp, g, "power_exponential",
                                        gram)
    torch.cuda.synchronize()
    assert got.shape == (B, n1, n2)
    assert (got - want).abs().max().item() <= K1_ATOL * 2.0
    if gram:
        assert torch.equal(got, got.mT)


def test_fit_ensemble_on_the_card(dev):
    """A small float32 fit_ensemble on K1 + K2 (E = 16 members x R = 2
    restarts, N = 32, d = 4, 6 steps) and predict_ensemble: one K1 and one
    K2 launch per objective evaluation over all 32 lanes, two K1 and one K2
    in predict; every member finite; the float32 best thetas scored by the
    float64 LML within 1e-2 of the float64 fit's best from the same starts
    (the float32 jitter floor on both). After 6 steps neither trajectory
    has converged, so the two sit apart by float32 noise: the plain
    versions on the CPU measured up to 7.1e-4 (16 members); a broken or
    misrouted fit is off by O(1)."""
    import dataclasses

    from madaiemulator_tpu_torch.models import fit, gp
    from madaiemulator_tpu_torch.ops import kernels
    from madaiemulator_tpu_torch.parallel import ensemble
    from madaiemulator_tpu_torch.utils.config import GPConfig

    E, R, N, d = 16, 2, 32, 4
    rng = np.random.default_rng(3)
    X = rng.uniform(size=(E, N, d))
    f = rng.uniform(1.0, 4.0, size=(E, 1))
    y = np.sin(f * X[..., 0]) + X[..., 1] ** 2
    Xt = torch.tensor(X, dtype=torch.float32, device=dev)
    yt = torch.tensor(y, dtype=torch.float32, device=dev)
    cfg = GPConfig(nparams=d, regression_order=1, n_restarts=R,
                   max_opt_steps=6)
    k1_0, k2_0 = k1.launches, k2.launches
    res = ensemble.fit_ensemble(torch.Generator().manual_seed(0), Xt, yt,
                                cfg)
    mean, var = ensemble.predict_ensemble(res.params, Xt, yt, Xt[:, :8], cfg)
    torch.cuda.synchronize()
    n_evals = res.stats["n_vg_calls"] + res.stats["n_v_calls"]
    assert k1.launches - k1_0 == n_evals + 2
    assert k2.launches - k2_0 == n_evals + 1
    assert bool(torch.isfinite(res.log_likelihood).all())
    assert mean.shape == (E, 8) and bool(torch.isfinite(mean).all())

    g = torch.Generator().manual_seed(0)
    draws = [fit.sample_restarts(g, cfg, R) for _ in range(E)]
    u0 = kernels.GPParams(*(torch.stack(a).double().to(dev)
                            for a in zip(*draws)))
    cfg64 = dataclasses.replace(
        cfg, jitter=kernels.effective_jitter_frac(N, torch.float32, cfg))
    X64, y64 = Xt.double(), yt.double()
    r64 = ensemble.fit_ensemble_from_starts(u0, X64, y64, cfg64, 6)
    with torch.no_grad():
        at32 = gp.log_marginal_likelihood(
            kernels.GPParams(*(a.double() for a in res.params)),
            gp.GPData(X=X64, y=y64), cfg64)
    best = r64.log_likelihood
    short = ((best - at32) / best.abs().clamp(min=1.0)).max().item()
    assert short <= 1e-2, short


# --- the update-precision tiers and the gradient path's K3 batch -----------


def test_3xtf32_gemm_beats_one_tf32_pass(dev):
    """`linalg.matmul_tier` on the card, against the float64 product: the
    3xTF32 tier ("high") sits far below one TF32 pass ("default", ~2^-11
    relative) and near full FP32 ("highest"); the process flag is off
    again after each call."""
    from madaiemulator_tpu_torch.ops import linalg

    rng = np.random.default_rng(31)
    a = torch.tensor(rng.standard_normal((1024, 2048)), dtype=torch.float32,
                     device=dev)
    b = torch.tensor(rng.standard_normal((2048, 512)), dtype=torch.float32,
                     device=dev)
    want = a.double() @ b.double()
    err = {}
    for tier in linalg.TIERS:
        got = linalg.matmul_tier(a, b, tier)
        err[tier] = ((got.double() - want).abs().max()
                     / want.abs().max()).item()
        assert torch.backends.cuda.matmul.allow_tf32 is False
    assert err["default"] > 1e-5, err  # TF32 really ran
    assert err["high"] < err["default"] / 30, err
    assert err["high"] < 10 * err["highest"] + 1e-6, err


def test_tf32_context_restores_the_flags_on_an_exception(dev):
    from madaiemulator_tpu_torch.ops import linalg

    a = torch.ones(64, 64, device=dev)
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32,
              torch.get_float32_matmul_precision())
    with pytest.raises(RuntimeError, match="inside"):
        with linalg.tf32_matmul():
            assert torch.backends.cuda.matmul.allow_tf32 is True
            a @ a
            raise RuntimeError("inside")
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision()) == before
    assert before[0] is False


def test_left_cholesky_high_tier_on_the_card(dev):
    """The "high" tier (3xTF32 history and rows-below GEMMs, K3 panels) of
    a well-conditioned Gram against its float64 factor, within the
    "highest" tier's 5e-4 x max|L| gate; one TF32 pass is further off."""
    from madaiemulator_tpu_torch.ops import linalg

    rng = np.random.default_rng(32)
    U = _points(rng, 1, 2048, 6).to(dev)
    A = k1.pairwise_covariance_plain(U, U, torch.ones(1, device=dev),
                                     torch.ones(1, device=dev),
                                     "power_exponential", True)
    L64 = torch.linalg.cholesky(A.double())
    err = {}
    for tier in linalg.TIERS:
        L = linalg.left_cholesky(A, block=512, update_precision=tier,
                                 diag="pallas")
        err[tier] = ((L.double() - L64).abs().max()
                     / L64.abs().max()).item()
    assert err["highest"] <= 5e-5 and err["high"] <= 5e-4, err
    assert err["high"] < err["default"], err


def test_k3_at_the_gradient_batch(dev):
    """K3 at (16, 512, 512), the gradient path's lane batch (4 components x
    4 restarts of a 3,584-row joint Gram, block 512): against its plain
    version and a float64 factor, as test_k3_matches_plain_and_f64."""
    rng = np.random.default_rng(16)
    A = _grams(rng, 16, 512)
    before = k3.launches
    L, Linv = k3.panel_factor(A.to(dev))
    Lp, Linvp = k3.panel_factor_plain(A.to(dev))
    L64 = torch.linalg.cholesky(A.double())
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    scale, iscale = L64.abs().max().item(), Linvp.abs().max().item()
    assert (L.cpu().double() - L64).abs().max().item() <= K2_RTOL * scale
    assert (L - Lp).abs().max().item() <= K2_RTOL * scale
    assert (Linv - Linvp).abs().max().item() <= K2_RTOL * iscale
    eye = torch.eye(512, dtype=torch.float64, device=dev)
    assert (Linv.double() @ L.double() - eye).abs().max().item() <= 1e-4


@pytest.mark.parametrize("n1,n2", [(2048, 4096), (4096, 1)])
def test_k1_at_the_matrix_free_shapes(dev, n1, n2):
    """The matrix-free path's K1 calls at a reduced N: a row-chunk tile of
    the matvec (2048 rows against every point) and a pivot column of the
    pivoted Cholesky (every point against one), batch 1, d = 8."""
    rng = np.random.default_rng(n1 + n2)
    X = _points(rng, 1, 4096, 8, ls=0.35).to(dev)
    U, V = X[:, :n1].contiguous(), X[:, 4096 - n2:].contiguous()
    amp = torch.ones(1, device=dev)
    got = k1.pairwise_covariance(U, V, amp, None, "power_exponential")
    want = k1.pairwise_covariance_plain(U, V, amp, None, "power_exponential")
    torch.cuda.synchronize()
    assert got.shape == (1, n1, n2)
    assert (got - want).abs().max().item() <= K1_ATOL * 2.0


def test_lml_iterative_float32_on_the_card_vs_float64(dev):
    """The matrix-free likelihood at float32 on the card (K1 tiles) against
    float64 on the CPU (library math), exact-probe mode at N=256, the
    float32 jitter floor on both: the value and the gradient."""
    import dataclasses

    from madaiemulator_tpu_torch.models import iterative
    from madaiemulator_tpu_torch.models.gp import GPData
    from madaiemulator_tpu_torch.ops import kernels
    from madaiemulator_tpu_torch.utils.config import GPConfig

    n, d = 256, 4
    rng = np.random.default_rng(5)
    X = rng.uniform(size=(n, d))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 + 0.05 * rng.standard_normal(n)
    cfg = GPConfig(nparams=d, regression_order=1)
    cfg = dataclasses.replace(
        cfg, jitter=kernels.effective_jitter_frac(n, torch.float32, cfg))
    theta = (0.0, np.log(1e-2), np.log(0.3))
    kw = dict(rank=n, probes=n, lanczos_iters=n, cg_tol=1e-5,
              cg_max_iters=400)

    def value_and_grad(dtype, device):
        leaves = [torch.tensor(t, dtype=dtype, device=device)
                  .expand(s).clone().requires_grad_(True)
                  for t, s in zip(theta, ((), (), (d,)))]
        data = GPData(X=torch.tensor(X, dtype=dtype, device=device),
                      y=torch.tensor(y, dtype=dtype, device=device))
        ll = iterative.lml_iterative(kernels.GPParams(*leaves), data, cfg,
                                     **kw)
        grads = torch.autograd.grad(ll, leaves)
        return ll.item(), torch.cat([g.reshape(-1) for g in grads]).cpu()

    before = k1.launches
    ll32, g32 = value_and_grad(torch.float32, dev)
    assert k1.launches > before  # the tiles went through the kernel
    ll64, g64 = value_and_grad(torch.float64, torch.device("cpu"))
    # the LML (~28 nats) cancels terms of ~1e3, so its error is held per
    # point. Measured on an NVIDIA H100 80GB HBM3 (700 W): 3.6e-5 nats a
    # point (a float32 Lanczos run of 256 steps), the gradient 6.6e-7 x
    # max|g64|; the gates are ~3x and ~15x those
    per_point = abs(ll32 - ll64) / n
    err = (g32.double() - g64).abs().max().item() / g64.abs().max().item()
    print(f"float32 on the card vs float64: ll {ll32} vs {ll64}, "
          f"{per_point:.3g} nats a point; gradient {err:.3g} x max|g64|")
    assert per_point <= 1e-4, (ll32, ll64)
    assert err <= 1e-5, (err, g32, g64)


@pytest.mark.parametrize("n2", [65536, 512, 4096])
def test_k1_at_the_sparse_shapes(dev, n2):
    """K1 at the SGPR path's shapes (d = 4): k(Z, X_c) of a 65,536-row
    chunk, k(Z, Z) and a 4,096-query serve block, m = 512 inducing
    points."""
    rng = np.random.default_rng(n2)
    U = _points(rng, 1, 512, 4).to(dev)
    V = _points(rng, 1, n2, 4).to(dev)
    amp = torch.tensor([0.7], device=dev)
    got = k1.pairwise_covariance(U, V, amp, None, "power_exponential")
    want = k1.pairwise_covariance_plain(U, V, amp, None, "power_exponential")
    torch.cuda.synchronize()
    assert got.shape == (1, 512, n2)
    assert (got - want).abs().max().item() <= K1_ATOL * 2.0


def test_elbo_float32_on_the_card_vs_float64(dev):
    """The SGPR ELBO at float32 on the card (K1 row chunks, each
    checkpointed) against float64 on the CPU (library math), the same Z:
    the value and the gradient in (params, Z)."""
    from madaiemulator_tpu_torch.models import sparse
    from madaiemulator_tpu_torch.models.gp import GPData
    from madaiemulator_tpu_torch.ops import kernels
    from madaiemulator_tpu_torch.utils.config import GPConfig

    n, d, m = 8192, 4, 128
    rng = np.random.default_rng(9)
    X = rng.uniform(size=(n, d))
    y = (np.sin(4 * X[:, 0]) + 0.5 * np.cos(3 * X[:, 1]) + X[:, 2] * X[:, 3]
         + 0.05 * rng.standard_normal(n))
    cfg = GPConfig(nparams=d, regression_order=1)
    Z = sparse.select_inducing(torch.tensor(X), m)
    theta = (0.0, np.log(1e-2), np.log(0.3))

    def value_and_grad(dtype, device):
        leaves = [torch.tensor(t, dtype=dtype, device=device)
                  .expand(s).clone().requires_grad_(True)
                  for t, s in zip(theta, ((), (), (d,)))]
        Zl = Z.to(device=device, dtype=dtype).requires_grad_(True)
        data = GPData(X=torch.tensor(X, dtype=dtype, device=device),
                      y=torch.tensor(y, dtype=dtype, device=device))
        ll = sparse.elbo(kernels.GPParams(*leaves), data, cfg, Zl,
                         row_chunk=2048)
        grads = torch.autograd.grad(ll, leaves + [Zl])
        return ll.item(), [g.double().cpu() for g in grads]

    before = k1.launches
    ll32, g32 = value_and_grad(torch.float32, dev)
    # k(Z, Z), then each of the 4 chunks forward and in its recompute
    assert k1.launches == before + 1 + 2 * 4
    ll64, g64 = value_and_grad(torch.float64, torch.device("cpu"))
    per_point = abs(ll32 - ll64) / n
    errs = [(a - b).abs().max().item() / b.abs().max().item()
            for a, b in zip(g32, g64)]
    print(f"ELBO float32 on the card vs float64: {ll32} vs {ll64}, "
          f"{per_point:.3g} nats a point; gradients {errs} x max|g64|")
    # the ELBO's quadratic term cancels sums of ~1e5 nats here, so the
    # value is held per point. Measured on an NVIDIA H100 80GB HBM3 (700
    # W): 3.5e-4 nats a point, the gradients (amp, nugget, ls, Z) 1.0e-4,
    # 1.1e-4, 1.5e-5, 6.8e-5 x max|g64|; the gates are ~3x and ~5x those
    assert per_point <= 1e-3, (ll32, ll64)
    assert max(errs) <= 5e-4, errs


def _heavy_ion(rng, n):
    """chip_smoke.py's bench/bench_multivariate.py simulator (d=6, t=8):
    (X, Y, the noiseless f)."""
    from chip_smoke import _heavy_ion_like

    return _heavy_ion_like(rng, n, 6, 8, with_simulator=True)


def test_multifidelity_on_the_card_vs_float64(dev, tmp_path):
    """A two-level multivariate multi-fidelity fit at float32 on the card:
    the cheap level (N=1,100) factors on the K3 route, the expensive one
    (N=256) on K2, every evaluation one K1 Gram; then its snapshot at a
    well-conditioned check theta (amp 1, nugget 1e-2, ls 0.5 on every level
    and component: at the fitted nuggets a float32 serve is conditioning-
    limited) served at float32 on the card against float64 on the CPU
    (library math)."""
    from madaiemulator_tpu_torch.io.snapshot import (
        read_snapshot_auto,
        write_snapshot_auto,
    )
    from madaiemulator_tpu_torch.models import multifidelity as mfm
    from madaiemulator_tpu_torch.utils.config import GPConfig

    rng = np.random.default_rng(13)
    X1, Y1, f = _heavy_ion(rng, 256)
    X0 = rng.uniform(size=(1100, 6))
    Y0 = 0.8 * f(X0) + 0.3 * np.sin(3 * X0[:, :1])
    cfg = GPConfig(nparams=6, regression_order=1, n_restarts=2,
                   max_opt_steps=5)
    T = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)  # noqa
    before = (k1.launches, k2.launches, k3.launches)
    emu = mfm.fit_multivariate_multifidelity(
        torch.Generator().manual_seed(0), [T(X0), T(X1)], [T(Y0), T(Y1)],
        cfg, pca_variance=0.99)
    e0, e1 = (s["n_vg_calls"] + s["n_v_calls"] for s in emu.fit_stats)
    assert k3.launches - before[2] == 3 * (e0 + 1)  # 3 panels of 512
    assert k2.launches - before[1] == e1 + 1
    assert k1.launches - before[0] == (e0 + 1) + 1 + (e1 + 1)
    assert torch.isfinite(emu.rho).all()
    path = str(tmp_path / "mf.npz")
    write_snapshot_auto(path, emu)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    for k in range(2):
        r = arrays[f"log_amp_{k}"].shape[0]
        arrays[f"log_amp_{k}"] = np.zeros(r, np.float32)
        arrays[f"log_nugget_{k}"] = np.full(r, np.log(1e-2), np.float32)
        arrays[f"log_ls_{k}"] = np.full((r, 6), np.log(0.5), np.float32)
    np.savez(path, **arrays)
    e32, _, _ = read_snapshot_auto(path, device=dev, dtype=torch.float32)
    e64, _, _ = read_snapshot_auto(path, device=torch.device("cpu"),
                                   dtype=torch.float64)
    Xq = rng.uniform(size=(300, 6))
    m32, v32 = mfm.predict_multivariate_multifidelity(e32, Xq)
    m64, v64 = mfm.predict_multivariate_multifidelity(e64, Xq)
    dm = (m32.double().cpu() - m64).abs().max().item() / m64.abs().max().item()
    dv = (v32.double().cpu() - v64).abs().max().item() / v64.abs().max().item()
    print(f"multi-fidelity serve float32 on the card vs float64: mean "
          f"{dm:.3g} x scale, variance {dv:.3g} x max var")
    # measured on an NVIDIA H100 80GB HBM3 (700 W): 3.3e-5 and 4.1e-4 (4.2e-5
    # and 4.9e-4 on an earlier draw of the data); the gates are ~5x and ~4x
    # the larger
    assert dm <= 2e-4 and dv <= 2e-3, (dm, dv)


def test_calibrate_on_the_card_vs_float64(dev, tmp_path):
    """The calibration log-posterior at float32 on the card against float64
    on the CPU at the same walker positions; emcee launches K1 exactly
    twice a step plus the start; HMC's gradients through K1's cross VJP
    are finite, a walker outside the box included."""
    import dataclasses

    from madaiemulator_tpu_torch.io.snapshot import (
        read_snapshot,
        write_snapshot,
    )
    from madaiemulator_tpu_torch.models import calibrate as cal
    from madaiemulator_tpu_torch.models.multivariate import (
        emulator_from_numpy,
        fit_multivariate,
    )
    from madaiemulator_tpu_torch.ops import kernels
    from madaiemulator_tpu_torch.utils.config import GPConfig

    rng = np.random.default_rng(14)
    X, Y, f = _heavy_ion(rng, 300)
    cfg = GPConfig(nparams=6, regression_order=1, n_restarts=2,
                   max_opt_steps=10)
    emu = fit_multivariate(torch.Generator().manual_seed(0),
                           torch.tensor(X, dtype=torch.float64),
                           torch.tensor(Y, dtype=torch.float64), cfg,
                           pca_variance=0.99)
    path = str(tmp_path / "state.txt")
    write_snapshot(path, emu)
    e32, _, _ = read_snapshot(path, device=dev, dtype=torch.float32)
    # float64 with the float32 jitter floor, as chip_smoke.py's config-3
    # comparisons set it
    jit32 = kernels.effective_jitter_frac(300, torch.float32, e32.config)
    arrays = dict(X=e32.X, Z=e32.Z, mins=e32.scaling.mins,
                  ranges=e32.scaling.ranges, ymean=e32.pca.ymean,
                  ystd=e32.pca.ystd, eigenvalues=e32.pca.eigenvalues,
                  U=e32.pca.U, log_amp=e32.params.log_amp,
                  log_nugget=e32.params.log_nugget,
                  log_ls=e32.params.log_ls)
    e64 = emulator_from_numpy(
        {k: v.double().cpu().numpy() for k, v in arrays.items()},
        dataclasses.replace(e32.config, jitter=jit32),
        device=torch.device("cpu"))
    y_exp = f(X[3:4])[0] + 0.05 * rng.standard_normal(8)
    var = np.full(8, 0.05 ** 2)
    lp32 = cal.make_log_posterior(e32, y_exp, var)
    lp64 = cal.make_log_posterior(e64, y_exp, var)
    g = torch.Generator(device=dev).manual_seed(0)
    x0 = cal.init_walkers(g, e32, lp32, 32)
    before = k1.launches
    chain, lps, acc = cal.run_emcee(g, lp32, x0, 20)
    assert k1.launches == before + 2 * 20 + 1
    assert 0.0 < float(acc) < 1.0
    pos = chain[-5:].reshape(-1, 6)
    a = lp32(pos).double().cpu()
    b = lp64(pos.double().cpu())
    diff = (a - b).abs().max().item()
    print(f"log-posterior float32 on the card vs float64: max {diff:.3g} "
          f"nats over {pos.shape[0]} positions (|lp| <= "
          f"{b.abs().max().item():.3g})")
    # measured on an NVIDIA H100 80GB HBM3 (700 W): 0.041 nats (0.13 on an
    # earlier draw of the data); the gate is ~4x the larger
    assert diff <= 0.5, diff
    x = torch.cat([pos[:3], torch.tensor([[1.2, 0.5, 0.5, 0.5, 0.5, 0.5]],
                                         device=dev)])
    lp, grad = cal._lp_and_grad(lp32, x)
    assert torch.isneginf(lp[3]) and torch.isfinite(grad).all()
    assert (grad[3] == 0).all() and (grad[:3] != 0).any()
    out = cal.run_hmc(g, lp32, x0, 5, n_leapfrog=4)
    assert torch.isfinite(out[1]).all()


def test_blocked_cholesky_on_the_card_vs_float64(dev):
    """cholesky_method="blocked" (library math: the trailing GEMMs at the
    update tier, float32 trsm by tri_inv_block + GEMM) on the card against
    the float64 factor of the same float32 SPD matrix (cond ~2), at
    "highest" and "high"; and its Murray gradient against cholesky_ex's."""
    from madaiemulator_tpu_torch.ops import linalg

    gen = torch.Generator(device=dev).manual_seed(0)
    n = 2048
    A = torch.randn(n, n, generator=gen, device=dev) / n ** 0.5
    M = 4.0 * torch.eye(n, device=dev) + A @ A.mT
    L64 = torch.linalg.cholesky(M.double())
    for tier, tol in (("highest", 5e-5), ("high", 5e-4)):
        L = linalg.blocked_cholesky_opt(M, block=512, update_precision=tier)
        err = (L.double() - L64).abs().max().item() / L64.abs().max().item()
        print(f"blocked {tier}: {err:.3g} x max|L|")
        assert err <= tol, (tier, err)
    W = torch.randn(n, n, generator=gen, device=dev, dtype=torch.float64)
    grads = []
    for fn in (lambda X: linalg.blocked_cholesky_opt(X, block=512),
               torch.linalg.cholesky):
        X = M.double().requires_grad_(True)
        (fn(X) * W).sum().backward()
        grads.append(X.grad)
    gerr = (grads[0] - grads[1]).abs().max() / grads[1].abs().max()
    assert gerr.item() <= 1e-9, gerr.item()


def _card_emulators(dev, n=256, d=4, t=5):
    """A dense multivariate emulator with fixed thetas at float32 on the
    card and at float64 on the CPU (the float32 jitter floor on both)."""
    import dataclasses

    from madaiemulator_tpu_torch.models.multivariate import (
        emulator_from_numpy,
        pca_decompose,
    )
    from madaiemulator_tpu_torch.ops import kernels
    from madaiemulator_tpu_torch.utils.config import GPConfig

    rng = np.random.default_rng(5)
    X = rng.uniform(size=(n, d))
    Y = np.stack([np.sin(3 * X[:, i % d]) + X[:, (i + 1) % d] ** 2
                  for i in range(t)], 1)
    pca, Z = pca_decompose(Y, 0.99)
    r = Z.shape[1]
    arrays = dict(mins=np.zeros(d), ranges=np.ones(d), X=X, Z=Z,
                  ymean=pca.ymean, ystd=pca.ystd,
                  eigenvalues=pca.eigenvalues, U=pca.U,
                  log_amp=np.zeros(r), log_nugget=np.full(r, np.log(1e-3)),
                  log_ls=np.full((r, d), np.log(0.4)))
    cfg = GPConfig(nparams=d, regression_order=1)
    cfg = dataclasses.replace(cfg, jitter=kernels.effective_jitter_frac(
        n, torch.float32, cfg))
    return (emulator_from_numpy(arrays, cfg, dev, dtype=torch.float32),
            emulator_from_numpy(arrays, cfg, torch.device("cpu")))


def test_design_and_sensitivity_on_the_card(dev):
    """active_variance_design and sobol_indices over a float32 emulator on
    the card: one K1 cross covariance per pool and per query chunk, no K2;
    the points inside the design box; the Sobol indices within 1e-3 of a
    float64 emulator's on the same (float32) Saltelli draws."""
    from madaiemulator_tpu_torch.models import design, sensitivity

    e32, e64 = _card_emulators(dev)
    before = (k1.launches, k2.launches)
    prop = design.active_variance_design(torch.Generator().manual_seed(0),
                                         e32, 8, pool_size=1024)
    assert (k1.launches - before[0], k2.launches - before[1]) == (1, 0)
    assert prop.points.shape == (8, 4)
    assert np.all((prop.points >= 0) & (prop.points <= 1))
    before = k1.launches
    res32 = sensitivity.sobol_indices(sensitivity.multivariate_mean_fn(e32),
                                      4, torch.Generator().manual_seed(1),
                                      n=512, query_chunk=1024)
    assert k1.launches - before == 3  # 512 x 6 rows in chunks of 1,024
    res64 = sensitivity.sobol_indices(sensitivity.multivariate_mean_fn(e64),
                                      4, torch.Generator().manual_seed(1),
                                      n=512, query_chunk=1024, device="cpu")
    for a, b in zip(res32[:2], res64[:2]):
        err = (a.double().cpu() - b).abs().max().item()
        assert err <= 1e-3, err


def test_compat_on_the_card(dev):
    """tests/test_compat.py's 1-D sin through call_estimate and
    call_emulate_at_list on the card, at float64 and at float32."""
    from madaiemulator_tpu_torch import compat

    X = np.linspace(0, 10, 30)[:, None]
    y = np.sin(X[:, 0])
    pts = np.linspace(0.5, 9.5, 20)[:, None]
    for dtype in (None, torch.float32):
        th = compat.call_estimate(X, y, n_restarts=3, max_steps=40, seed=1,
                                  dtype=dtype)
        m, v = compat.call_emulate_at_list(X, y, th, pts, dtype=dtype)
        rmse = float(np.sqrt(np.mean((m - np.sin(pts[:, 0])) ** 2)))
        print(f"compat {dtype}: thetas {th}, rmse {rmse:.3g}")
        assert rmse < 1e-2 and np.all(v >= 0), (dtype, rmse)


def test_virtual_mesh_on_the_card(dev):
    """A virtual 2-shard mesh on cuda:0: the row-sharded matvec equals the
    unsharded one bitwise where the shards' blocks are whole chunks (the
    same K1 tiles and GEMMs), K1 launching once a chunk a shard; the
    ensemble fit over it equals the one-batch fit."""
    from madaiemulator_tpu_torch.models import iterative
    from madaiemulator_tpu_torch.ops.kernels import GPParams
    from madaiemulator_tpu_torch.parallel import ensemble, iterative_sharded
    from madaiemulator_tpu_torch.utils.config import GPConfig

    rng = np.random.default_rng(16)
    n, chunk = 4096, 512
    X = torch.tensor(rng.uniform(size=(n, 4)), dtype=torch.float32,
                     device=dev)
    p = GPParams(*(torch.tensor(v, dtype=torch.float32, device=dev)
                   for v in (0.0, np.log(0.1), np.log([0.4] * 4))))
    cfg = GPConfig(nparams=4, regression_order=1)
    V = torch.tensor(rng.standard_normal((n, 3)), dtype=torch.float32,
                     device=dev)
    mesh = iterative_sharded.make_rows_mesh(devices=[dev, dev])
    before = k1.launches
    got = iterative_sharded.sharded_gram_matvec(X, p, cfg, V, mesh,
                                                row_chunk=chunk)
    assert k1.launches - before == n // chunk
    want = iterative.gram_matvec(X, p, cfg, V, row_chunk=chunk)
    torch.cuda.synchronize()
    assert got.device == dev and torch.equal(got, want)

    E, N = 64, 32
    Xb = torch.tensor(rng.uniform(size=(E, N, 2)), dtype=torch.float32,
                      device=dev)
    yb = torch.sin(3 * Xb[..., 0]) + Xb[..., 1] ** 2
    ecfg = GPConfig(nparams=2, regression_order=1, n_restarts=2,
                    max_opt_steps=8)
    whole = ensemble.fit_ensemble(torch.Generator().manual_seed(0), Xb, yb,
                                  ecfg)
    before = (k1.launches, k2.launches)
    sharded = ensemble.fit_ensemble(torch.Generator().manual_seed(0), Xb, yb,
                                    ecfg, mesh=ensemble.make_mesh(
                                        devices=[dev, dev]))
    evals = sharded.stats["n_vg_calls"] + sharded.stats["n_v_calls"]
    assert (k1.launches - before[0], k2.launches - before[1]) == (evals,
                                                                  evals)
    a, b = whole.log_likelihood.cpu(), sharded.log_likelihood.cpu()
    assert torch.isfinite(a).all()
    # a float32 linesearch branch may flip on one ulp: most members equal
    share = ((a - b).abs() <= 1e-4 * a.abs()).double().mean().item()
    assert share >= 0.9, share
