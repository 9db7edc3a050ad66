"""The port's update-precision tiers (madaiemulator_tpu_torch/ops/linalg.py,
models/gp.py) against the JAX package on the CPU: the tier choice from the
condition bound, `left_cholesky` at every tier, the closed-form LML backward
that follows the "high" tier, and `estimate_thetas --update_precision`.

On the CPU every tier computes in full precision, in both packages (JAX's
CPU backend ignores matmul precision; the port's `matmul_tier` runs TF32
only on the card), so these tests check the wiring. The 3xTF32 arithmetic
is checked here through `tf32_split` / `tf32x3`, whose products run in full
FP32 on the CPU; its accuracy with TF32 on is `tests/test_torch_cuda.py`'s.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu.models import gp as jgp
from madaiemulator_tpu.ops import kernels as jk
from madaiemulator_tpu.ops import linalg as jl
from madaiemulator_tpu.utils import config as jcfg
from madaiemulator_tpu_torch import cli as tcli
from madaiemulator_tpu_torch.io import snapshot as tsnap
from madaiemulator_tpu_torch.models import gp as tgp
from madaiemulator_tpu_torch.ops import kernels as tk
from madaiemulator_tpu_torch.ops import linalg as tl
from madaiemulator_tpu_torch.utils import config as tcfg
import torch_shared  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
SIN1D = str(ROOT / "tests" / "golden" / "sin1d_powerexp" / "model.txt")
CPU = torch.device("cpu")
TIERS = ("default", "high", "highest")


def _spd(seed, n, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    return (A @ A.T + n * np.eye(n)).astype(dtype)


# the kappa grid spans both sides of both thresholds and the tol scaling
KAPPAS = (1.0, 1e3, 9.9e3, 1e4, 1.01e4, 1.99e4, 2e4, 2.01e4, 1e5, 4e4, 1e7)


@pytest.fixture
def jax_threshold(monkeypatch):
    """The port's rule with the JAX package's threshold (2e4, measured on
    the v5e): the port's own, 1e4, is a deliberate difference measured on
    the H100 (ops/linalg.HIGH_TIER_KAPPA_MAX)."""
    assert tl.HIGH_TIER_KAPPA_MAX == 1e4
    monkeypatch.setattr(tl, "HIGH_TIER_KAPPA_MAX", 2e4)


@pytest.mark.parametrize("tol", [1e-3, 2e-3, 1e-4])
def test_choose_update_precision_matches_jax(tol, jax_threshold):
    for k in KAPPAS:
        assert tl.choose_update_precision(k, tol) == \
            jl.choose_update_precision(k, tol), (k, tol)
    # the port never picks the one-pass TF32 tier on its own
    assert {tl.choose_update_precision(k) for k in KAPPAS} == {"high",
                                                                "highest"}


def test_choose_update_precision_port_threshold():
    """With the port's own threshold: "high" up to 1e4 x tol / 1e-3."""
    for k in KAPPAS:
        for tol in (1e-3, 2e-3):
            want = "high" if k <= 1e4 * tol / 1e-3 else "highest"
            assert tl.choose_update_precision(k, tol) == want, (k, tol)


def test_gp_kappa_bound_matches_jax():
    for n, amp, g in [(100, 1.0, 1e-2), (16384, 2.5, 1.0), (7, 1e-3, 0.0),
                      (512, 1.0, 1e-8)]:
        assert tl.gp_kappa_bound(n, amp, g) == jl.gp_kappa_bound(n, amp, g)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_resolve_update_precision_matches_jax(dtype, jax_threshold):
    """"auto" over a grid of (amp, nugget) at both dtypes (float32 adds the
    jitter floor to the nugget); other settings pass through; a batch of
    params resolves by its largest bound."""
    n = 40
    cj = jcfg.GPConfig(nparams=2, cholesky_update_precision="auto")
    ct = tcfg.GPConfig(nparams=2, cholesky_update_precision="auto")
    picks = []
    for amp in (0.5, 1.0, 3.0):
        for nug in (1e-6, 1e-3, 1e-2, 1.0):
            a, g = np.asarray(np.log(amp), dtype), np.asarray(np.log(nug),
                                                              dtype)
            pj = jk.GPParams(jnp.asarray(a), jnp.asarray(g),
                             jnp.zeros(2, dtype))
            pt = tk.GPParams(torch.tensor(a), torch.tensor(g),
                             torch.zeros(2, dtype=torch.float64))
            want = jgp.resolve_update_precision(pj, n, cj)
            got = tgp.resolve_update_precision(pt, n, ct)
            assert (got.cholesky_update_precision
                    == want.cholesky_update_precision), (amp, nug)
            picks.append(got.cholesky_update_precision)
    assert set(picks) == {"high", "highest"}
    fixed = dataclasses.replace(ct, cholesky_update_precision="default")
    assert tgp.resolve_update_precision(pt, n, fixed) is fixed
    batch = tk.GPParams(torch.zeros(2, dtype=torch.float64),
                        torch.log(torch.tensor([1.0, 1e-6])),
                        torch.zeros(2, 2, dtype=torch.float64))
    assert tgp.resolve_update_precision(batch, n, ct) \
        .cholesky_update_precision == "highest"


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("diag,dtype,tol", [("xla", np.float64, 1e-12),
                                            ("xla", np.float32, 1e-5),
                                            ("pallas", np.float32, 1e-5)])
def test_left_cholesky_tiers_match_jax(tier, diag, dtype, tol):
    """Each tier on both panel routes against the JAX left_cholesky at the
    same tier (float32 on the port's "pallas" route: the plain K3 per
    panel, against the JAX library-panel route), on a batch of two."""
    A = np.stack([_spd(4, 192), _spd(5, 192)]).astype(dtype)
    got = tl.left_cholesky(torch.from_numpy(A), block=64,
                           update_precision=tier, diag=diag)
    for i in range(2):
        want = np.asarray(jl.left_cholesky(jnp.asarray(A[i]), block=64,
                                           update_precision=tier))
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max())
    assert torch.equal(got, torch.tril(got))


def test_left_cholesky_trsm_precision_and_bad_tier():
    A = torch.from_numpy(_spd(6, 128, np.float32))
    ref = tl.left_cholesky(A, block=32)
    for tp in TIERS:
        got = tl.left_cholesky(A, block=32, update_precision="highest",
                               trsm_precision=tp)
        assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max()
    with pytest.raises(ValueError, match="tier"):
        tl.left_cholesky(A, block=32, update_precision="bf16")
    with pytest.raises(ValueError, match="tier"):
        tl.matmul_tier(A, A, "HIGH")


def test_tf32_split_and_3xtf32_product():
    """hi is a rounded to the nearest TF32 value (float32's low 13
    mantissa bits clear, the remainder at most half their weight, of either
    sign) and hi + lo == a exactly; the three-term product of the splits,
    in full FP32 here, matches the float64 product to float32's
    accuracy."""
    rng = np.random.default_rng(7)
    a = torch.tensor(rng.standard_normal((96, 80)), dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((80, 64)), dtype=torch.float32)
    hi, lo = tl.tf32_split(a)
    assert int((hi.view(torch.int32) & 8191).abs().max()) == 0
    assert torch.equal(hi + lo, a)
    assert (lo.abs() <= 2.0 ** -11 * a.abs()).all()
    assert (lo > 0).any() and (lo < 0).any()
    assert torch.equal(tl.tf32_round(hi), hi)
    # round half away from zero: 1 + 2^-11 (half a TF32 ulp) rounds up
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12])
    assert tl.tf32_round(x).tolist() == [1.0 + 2.0 ** -10,
                                         -(1.0 + 2.0 ** -10), 1.0]
    want = a.double() @ b.double()
    err = ((tl.tf32x3(a, b).double() - want).abs().max()
           / want.abs().max()).item()
    assert err <= 1e-6, err  # observed ~1e-7
    # and every tier of matmul_tier on the CPU is the full-precision product
    for tier in TIERS:
        assert torch.equal(tl.matmul_tier(a, b, tier), a @ b)


def test_tf32_context_restores_the_flag():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    with tl.tf32_matmul():
        assert torch.backends.cuda.matmul.allow_tf32 is True
    assert torch.backends.cuda.matmul.allow_tf32 is False
    with pytest.raises(RuntimeError, match="inside"):
        with tl.tf32_matmul():
            raise RuntimeError("inside")
    assert torch.backends.cuda.matmul.allow_tf32 is False


def _problem(n=20, d=2):
    """tests/test_gp.py's setup_problem."""
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(n, d))
    y = np.sin(3 * X[:, 0]) + 0.5 * X[:, 1] + 0.05 * rng.standard_normal(n)
    p = tk.GPParams(torch.tensor(np.log(1.3)), torch.tensor(np.log(1e-3)),
                    torch.tensor(np.log([0.6, 0.9])))
    return tcfg.GPConfig(nparams=d, regression_order=1), \
        tgp.GPData(X=torch.tensor(X), y=torch.tensor(y)), p


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_bwd_follows_high_update_tier(dtype):
    """The port of tests/test_gp.py:116: at the "high" tier (the left-
    looking factor at block 8, the backward's Linv and Cinv at 3xTF32 on
    the card) the closed-form gradient matches plain autodiff on a benign
    operand, to the JAX test's rtol 1e-4 (float64) and to float32's
    accuracy at float32 (the CPU computes every tier in full precision)."""
    cfg, data, p = _problem()
    data = tgp.GPData(X=data.X.to(dtype), y=data.y.to(dtype))
    p = tk.GPParams(*(a.to(dtype) for a in p))
    cfg_high = dataclasses.replace(cfg, cholesky_method="left",
                                   cholesky_block=8,
                                   cholesky_update_precision="high")

    def grad(fn, c):
        q = tk.GPParams(*(a.detach().requires_grad_() for a in p))
        return torch.autograd.grad(fn(q, data, c), q)

    g_high = grad(tgp.log_marginal_likelihood, cfg_high)
    g_ad = grad(tgp.log_marginal_likelihood_ad, cfg)
    rtol, atol = (1e-4, 1e-7) if dtype == torch.float64 else (2e-3, 1e-4)
    for a, b in zip(g_ad, g_high):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=rtol, atol=atol)


def test_estimate_thetas_update_precision_high_exits_0(tmp_path, capsys):
    """--update_precision at every tier: exit 0 and a snapshot that serves.
    At this N the factorization is the library's whole-matrix one and the
    tier reaches the closed-form backward ("high": Linv and Cinv by
    `matmul_tier`); on the CPU every tier gives the thetas of "highest"."""
    states = {}
    for tier in ("high", "highest", "auto", "default"):
        state = str(tmp_path / f"{tier}.txt")
        rc = tcli.main(["estimate_thetas", SIN1D, state, "--device", "cpu",
                        "--restarts", "2",
                        "--steps", "4", "--update_precision", tier,
                        "--quiet"])
        assert rc == 0, capsys.readouterr().err
        states[tier] = tsnap.read_snapshot(state, device=CPU)[0]
    base = states["highest"].params
    for tier in ("high", "auto", "default"):
        for a, b in zip(states[tier].params, base):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)
