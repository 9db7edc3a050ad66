"""The float64 reference agrees with the port's plain CPU path in float64
at a tiny N: the log-likelihood, its gradient, and the posterior."""

import math

import pytest
import torch

from madaiemulator_tpu_torch.models import gp
from madaiemulator_tpu_torch.ops.kernels import GPParams
from madaiemulator_tpu_torch.utils.config import GPConfig

from portbench.harness import data as data_lib
from portbench.reference import gp_f64 as ref

N, D = 48, 3


@pytest.fixture(scope="module")
def problem():
    X, y = data_lib.make({"kind": "sin_plus_square", "n": N, "d": D,
                          "freq_lo": 3.0, "freq_hi": 3.0}, 7, "cpu")
    X, y = X.double(), y.double()
    # the port's float64 path adds no jitter of its own: give it the
    # reference's float32 floor so both factor the same C
    cfg = GPConfig(nparams=D, regression_order=1, jitter=ref.jitter_frac(N))
    log = (torch.tensor([0.3, -0.2]), torch.log(torch.tensor([1e-2, 3e-4])),
           torch.log(torch.tensor([[0.4, 0.7, 0.3], [0.9, 0.5, 1.3]])))
    return X, y, cfg, tuple(t.double() for t in log)


def test_lml_and_gradient(problem):
    X, y, cfg, log = problem
    leaves = [t.clone().requires_grad_(True) for t in log]
    ll = gp.log_marginal_likelihood(GPParams(*leaves), gp.GPData(X=X, y=y),
                                    cfg)
    g = torch.autograd.grad(ll.sum(), leaves)
    want = ref.lml(X, y, ref.params_from_log(*log, ar=ref.Arith()),
                   ref.Arith(block=16), grad=True)
    torch.testing.assert_close(ll, want.value, rtol=1e-10, atol=1e-9)
    got = torch.cat([g[0][:, None], g[1][:, None], g[2]], -1)
    torch.testing.assert_close(got, want.grad, rtol=1e-8, atol=1e-8)
    assert (want.grad_scale >= want.grad.abs() - 1e-12).all()


def test_posterior(problem):
    X, y, cfg, log = problem
    Xs = torch.rand((37, D), generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)
    p1 = GPParams(*(t[0] for t in log))
    st = gp.precompute_predictor_safe(p1, gp.GPData(X=X, y=y), cfg)
    mean, var = gp.predict_from_precomputed(st, p1, gp.GPData(X=X, y=y), Xs,
                                            cfg)
    ar = ref.Arith(block=16)
    p = ref.params_from_log(*(t[0] for t in log), ar=ar)
    rmean, rvar = ref.predict(ref.factor(X, y, p, ar), X, Xs, p, ar)
    torch.testing.assert_close(mean, rmean, rtol=1e-9, atol=1e-9)
    torch.testing.assert_close(var, rvar, rtol=1e-8, atol=1e-9)


def test_tf32_arithmetic_rounds_products():
    a = torch.tensor([[1.0 + 2 ** -12]])
    assert float(ref._tf32(a)) == 1.0
    assert float(ref._tf32(torch.tensor([1.0 + 2 ** -10]))) == 1.0 + 2 ** -10
    ar = ref.Arith("tf32")
    assert float(ar.mm(a, torch.ones(1, 1))) == 1.0
    assert math.isclose(float(ref.Arith().mm(a.double(),
                                             torch.ones(1, 1).double())),
                        1.0 + 2 ** -12)


def test_reference_marks_a_failed_factor_per_member():
    ar = ref.Arith("tf32", block=4)
    A = torch.eye(8).expand(2, 8, 8).clone()
    A[1, 0, 0] = -1.0
    L, bad = ref.cholesky(A, ar)
    assert bad.tolist() == [False, True]
    torch.testing.assert_close(L[0], torch.eye(8))
