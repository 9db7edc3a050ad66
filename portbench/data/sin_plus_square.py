"""The data recipe "sin_plus_square" (bench/bench_large_n.py:38-43,
bench/bench_ensemble.py:37-44): X uniform on [0, 1]^d, y = sin(f x_0) +
x_1^2, float32; one design of `n` points, or `members` designs of `n`
points each, one frequency f a member drawn uniform in [freq_lo, freq_hi]
(f = freq_lo where they agree)."""

import torch

from portbench.harness import seeds


def make(recipe: dict, seed: int, device) -> tuple:
    """(X, y) float32 on `device`: (n, d) and (n,), or (members, n, d) and
    (members, n)."""
    g = seeds.generator(seed, seeds.DATA, device=device)
    members = recipe.get("members")
    lead = () if members is None else (members,)
    n, d = recipe["n"], recipe["d"]
    X = torch.rand(lead + (n, d), generator=g, device=device)
    lo, hi = recipe["freq_lo"], recipe["freq_hi"]
    f = lo + (hi - lo) * torch.rand(lead + (1,), generator=g, device=device)
    y = torch.sin(f * X[..., 0]) + X[..., 1] ** 2
    return X, y
