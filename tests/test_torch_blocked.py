"""The port's right-looking blocked Cholesky (`cholesky_method="blocked"`,
`madaiemulator_tpu_torch.ops.linalg`) against the JAX package's on the CPU:
`blocked_cholesky_opt` at float64 and at float32 at each update tier, its
Murray gradient against the library factor's, `blocked_cholesky`,
`_unblocked_cholesky`, both precise solves, the leading batch axes, the
failure semantics, the GP likelihood on the "blocked" route, and the CLI's
`estimate_thetas --cholesky_method=blocked` above `cholesky_block` against
the JAX CLI's snapshot (the same restarts fed to both).
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madaiemulator_tpu import cli as jcli
from madaiemulator_tpu.io import modelfile as jmf
from madaiemulator_tpu.models import fit as jfit
from madaiemulator_tpu.models import gp as jgp
from madaiemulator_tpu.ops import kernels as jk
from madaiemulator_tpu.ops import linalg as jlin
from madaiemulator_tpu.utils import config as jcfg
from madaiemulator_tpu_torch import cli as tcli
from madaiemulator_tpu_torch.models import fit as tfit
from madaiemulator_tpu_torch.models import gp as tgp
from madaiemulator_tpu_torch.ops import kernels as tk
from madaiemulator_tpu_torch.ops import linalg as tlin
from madaiemulator_tpu_torch.utils import config as tcfg
import torch_shared  # noqa: F401

N, B = 96, 32
# float64: the same arithmetic up to summation order
RTOL64 = 1e-12
# float32, relative to max|L|: two float32 factorizations in another
# summation order at cond ~1e3
RTOL32 = 2e-5


def _spd(n=N, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)) / np.sqrt(n)
    return (A @ A.T + 0.05 * np.eye(n)).astype(dtype)


def _close(got, want, rtol=RTOL64):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("diag", ["xla", "unblocked"])
def test_blocked_cholesky_opt_float64_matches_jax(diag):
    A = _spd()
    want = jlin.blocked_cholesky_opt(jnp.asarray(A), block=B, diag=diag)
    got = tlin.blocked_cholesky_opt(torch.tensor(A), block=B, diag=diag)
    _close(got, want)
    _close(got @ got.mT, A)


@pytest.mark.parametrize("tier", tlin.TIERS)
def test_blocked_cholesky_opt_float32_tiers_match_jax(tier):
    """float32: the panel trsm by tri_inv_block + one GEMM, the trailing
    GEMMs at the tier (on the CPU every tier computes in full precision in
    both packages)."""
    A = _spd(seed=1, dtype=np.float32)
    want = jlin.blocked_cholesky_opt(jnp.asarray(A), block=B,
                                     update_precision=tier)
    got = tlin.blocked_cholesky_opt(torch.tensor(A), block=B,
                                    update_precision=tier)
    assert got.dtype == torch.float32
    _close(got, want, RTOL32)


def test_blocked_cholesky_opt_gradient_matches_library():
    """The Murray backward against the library factor's autograd, for a
    loss touching every entry of L."""
    A = torch.tensor(_spd(seed=2))
    W = torch.tensor(np.random.default_rng(3).standard_normal((N, N)))
    grads = []
    for fn in (lambda M: tlin.blocked_cholesky_opt(M, block=B),
               torch.linalg.cholesky):
        M = A.clone().requires_grad_(True)
        (fn(M) * W).sum().backward()
        grads.append(M.grad)
    _close(grads[0], grads[1], 1e-10)


def test_blocked_cholesky_batch_and_failure():
    """Leading batch axes as left_cholesky takes them; a non-SPD member
    comes back NaN (chol_ok False) without touching the other."""
    A = torch.stack([torch.tensor(_spd(seed=4)), torch.tensor(_spd(seed=5))])
    L = tlin.blocked_cholesky_opt(A, block=B)
    for i in range(2):
        _close(L[i], tlin.blocked_cholesky_opt(A[i], block=B), 1e-14)
    bad = A.clone()
    bad[1, 40, 40] = -5.0
    ok = tlin.chol_ok(tlin.blocked_cholesky_opt(bad, block=B))
    assert ok.tolist() == [True, False]
    with pytest.raises(ValueError):
        tlin.blocked_cholesky_opt(A[..., :90, :90], block=B)
    with pytest.raises(ValueError):
        tlin.blocked_cholesky_opt(A, block=B, update_precision="low")


def test_blocked_and_unblocked_cholesky_match_jax():
    A = _spd(seed=6)
    _close(tlin.blocked_cholesky(torch.tensor(A), block=B),
           jlin.blocked_cholesky(jnp.asarray(A), block=B))
    _close(tlin._unblocked_cholesky(torch.tensor(A[:B, :B])),
           jlin._unblocked_cholesky(jnp.asarray(A[:B, :B])))
    _close(tlin.cholesky(torch.tensor(A), "blocked", block=B),
           np.linalg.cholesky(A))
    with pytest.raises(ValueError):
        tlin.cholesky(torch.tensor(A), "pallas")


@pytest.mark.parametrize("n,rhs", [(N, (N, 5)), (80, (80,))])
def test_precise_solves_match_jax(n, rhs):
    """Block substitution with the diagonal blocks inverted (n = 80 pads to
    96 with an identity tail), matrix and vector right-hand sides."""
    L = np.linalg.cholesky(_spd(n, seed=7))
    Bm = np.random.default_rng(8).standard_normal(rhs)
    for tfn, jfn, solve in (
            (tlin.solve_lower_precise, jlin.solve_lower_precise, L),
            (tlin.solve_upper_t_precise, jlin.solve_upper_t_precise, L.T)):
        got = tfn(torch.tensor(L), torch.tensor(Bm), block=B)
        _close(got, jfn(jnp.asarray(L), jnp.asarray(Bm), block=B))
        _close(got, np.linalg.solve(solve, Bm), 1e-10)


def _gp_case(n=80):
    rng = np.random.default_rng(9)
    X = rng.uniform(size=(n, 2))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2
    p = dict(log_amp=0.1, log_nugget=np.log(1e-3), log_ls=np.log([0.3, 0.5]))
    return X, y, p


def test_lml_blocked_route_matches_jax():
    """The GLS likelihood and its gradient with the Gram factored by the
    blocked route (N=80 > cholesky_block=32: padded to 96, 3 panels)."""
    X, y, p = _gp_case()
    kw = dict(nparams=2, regression_order=1, cholesky_method="blocked",
              cholesky_block=B)
    cj, ct = jcfg.GPConfig(**kw), tcfg.GPConfig(**kw)
    pj = jk.GPParams(*(jnp.asarray(p[k]) for k in jk.GPParams._fields))
    vj, gj = jax.jit(jax.value_and_grad(
        lambda q: jgp.log_marginal_likelihood(q, jgp.GPData(
            X=jnp.asarray(X), y=jnp.asarray(y)), cj)))(pj)
    pt = tk.GPParams(*(torch.tensor(np.asarray(a), requires_grad=True)
                       for a in pj))
    data = tgp.GPData(X=torch.tensor(X), y=torch.tensor(y))
    vt = tgp.log_marginal_likelihood(pt, data, ct)
    gt = torch.autograd.grad(vt, pt)
    np.testing.assert_allclose(vt.item(), float(vj), rtol=1e-10)
    for a, b in zip(gt, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8)
    with torch.no_grad():
        lib = tgp.log_marginal_likelihood(
            pt, data, tcfg.GPConfig(**{**kw, "cholesky_method": "xla"}))
    np.testing.assert_allclose(vt.item(), lib.item(), rtol=1e-10)


def test_config_accepts_blocked():
    assert tcfg.GPConfig(nparams=2,
                         cholesky_method="blocked").cholesky_method == (
                             "blocked")


def _numbers(path):
    toks = []
    for line in pathlib.Path(path).read_text().splitlines():
        for tok in line.split("#", 1)[0].split():
            try:
                toks.append(float(tok))
            except ValueError:
                toks.append(tok)
    return toks


def test_cli_estimate_thetas_blocked_matches_jax_cli(tmp_path, monkeypatch):
    """estimate_thetas --cholesky_method=blocked at N=520 > cholesky_block
    (512: two panels of the padded 1,024) through both CLIs in process from
    the same restarts: the snapshots agree token for token, numbers to
    rtol 1e-8."""
    rng = np.random.default_rng(10)
    X = rng.uniform(size=(520, 2))
    Y = (np.sin(3 * X[:, 0]) + X[:, 1] ** 2
         + 0.01 * rng.standard_normal(520))[:, None]
    model = str(tmp_path / "model.txt")
    jmf.write_model_file(model, X, Y)
    u0 = np.array([[0.3, -0.5, -0.4, 0.2]])
    monkeypatch.setattr(jfit, "sample_restarts", lambda *a, **k: jk.GPParams(
        jnp.asarray(u0[:, 0]), jnp.asarray(u0[:, 1]), jnp.asarray(u0[:, 2:])))
    monkeypatch.setattr(tfit, "sample_restarts", lambda *a, **k: tk.GPParams(
        torch.tensor(u0[:, 0]), torch.tensor(u0[:, 1]),
        torch.tensor(u0[:, 2:])))
    monkeypatch.setenv("MADAI_COMPILE_CACHE", "off")
    args = ["--cholesky_method", "blocked", "--restarts", "1", "--steps",
            "3", "--regression_order", "1", "--quiet"]
    paths = {k: str(tmp_path / f"{k}.txt") for k in ("jax", "torch")}
    assert jcli.main(["estimate_thetas", model, paths["jax"]] + args) == 0
    assert tcli.main(["estimate_thetas", model, paths["torch"], "--device",
                      "cpu"] + args) == 0
    a, b = _numbers(paths["jax"]), _numbers(paths["torch"])
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, float):
            np.testing.assert_allclose(y, x, rtol=1e-8, atol=1e-14)
        else:
            assert x == y
