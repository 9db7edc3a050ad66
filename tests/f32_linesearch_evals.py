"""Objective evaluations per L-BFGS step of the float32 `fit_multivariate`,
the port against the JAX package, both on the CPU, at BASELINE config 3
(`chip_smoke.py` phase 7: the heavy-ion-like data from `--seed`, N=512, d=6,
t=15, PCA 0.99, regression_order=1, 4 restarts x 40 steps).

Both fits start from the same restarts: the port draws them with its
`sample_restarts` (one draw per component), and the JAX fit is handed the
same draws by replacing its `sample_restarts`. The JAX side runs the JAX
package's `fit_multivariate`; its `_run_lbfgs` is replaced by a copy that
differs only in reporting each lane's `num_linesearch_steps` (optax's zoom
state) after every step through a debug callback. Under `jax.vmap` the
zoom's while loop runs until its slowest lane is done, so a step costs the
largest count over the lanes; the port's lock-step loop reports that count.
`--x64` enables JAX's 64-bit mode (as the JAX tests run; the JAX CLI leaves
it off at float32, so optax's scalars are then float32).

    python tests/f32_linesearch_evals.py [--n 512] [--steps 40] [--x64]

Prints one JSON object: per side, the evaluations of each step's linesearch
(the lock-step count), the lanes at the 20-evaluation cap per step, the
best log-likelihood per component and the wall time.
"""

import argparse
import collections
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--x64", action="store_true")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", args.x64)
    import jax.numpy as jnp
    import optax
    import torch

    import chip_smoke as cs
    from madaiemulator_tpu.models import fit as jfit
    from madaiemulator_tpu.models import multivariate as jmv
    from madaiemulator_tpu.ops import kernels as jk
    from madaiemulator_tpu.utils import config as jcfg
    from madaiemulator_tpu_torch.models import fit as tfit
    from madaiemulator_tpu_torch.models import multivariate as tmv
    from madaiemulator_tpu_torch.utils import config as tcfg

    rng = np.random.default_rng(args.seed)
    X, Y = cs._heavy_ion_like(rng, args.n, cs.C3_D, cs.C3_T)
    kw = dict(nparams=cs.C3_D, regression_order=1, n_restarts=cs.C3_R,
              max_opt_steps=args.steps)
    out = {"n": args.n, "steps": args.steps, "x64": args.x64,
           "seed": args.seed}

    # the port at float32 (plain kernel versions on the CPU), recording the
    # restarts it draws
    draws = []
    draw = tfit.sample_restarts

    def recording(*a, **k):
        p = draw(*a, **k)
        draws.append(tfit._flatten(p))
        return p

    tfit.sample_restarts = recording
    t0 = time.perf_counter()
    et = tmv.fit_multivariate(
        torch.Generator().manual_seed(args.seed),
        torch.tensor(X, dtype=torch.float32),
        torch.tensor(Y, dtype=torch.float32), tcfg.GPConfig(**kw),
        pca_variance=cs.C3_PCA)
    tfit.sample_restarts = draw
    st = et.fit_stats
    out["port"] = {
        "wall_s": time.perf_counter() - t0,
        "components": et.n_components,
        "evals_by_step": st["linesearch_evals_by_step"],
        "evals_per_step": (st["n_vg_calls"] + st["n_v_calls"])
        / st["n_steps"],
        "best_loglik": et.restart_log_likelihoods.amax(dim=1).tolist(),
    }

    # the JAX package at float32 from the same restarts: component i's fit_gp
    # gets draws[i], found by its PRNG key (fit_multivariate splits its key
    # into one per component, in order)
    r = len(draws)
    key = jax.random.key(args.seed)
    table_keys = jax.random.key_data(jax.random.split(key, r))
    table_u = jnp.asarray(np.stack(draws), dtype=jnp.float32)

    def sample(k, config, n_restarts, dtype):
        hit = jnp.all(jax.random.key_data(k) == table_keys, axis=1)
        u = table_u[jnp.argmax(hit)].astype(dtype)
        return jk.GPParams(u[:, 0], u[:, 1], u[:, 2:])

    per_step = collections.defaultdict(list)

    def record(k, n):
        per_step[int(k)].append(int(n))

    def run_lbfgs(u0, objective, max_steps, linesearch="zoom"):
        # madaiemulator_tpu/models/fit.py::_run_lbfgs with the step index in
        # the scan and one debug callback after each update
        opt = optax.lbfgs()
        value_and_grad = optax.value_and_grad_from_state(objective)
        state0 = opt.init(u0)
        v0 = objective(u0)
        big = jnp.asarray(jnp.inf, dtype=v0.dtype)

        def step(carry, k):
            u, st, best_u, best_v = carry
            v, g = value_and_grad(u, state=st)
            better = jnp.isfinite(v) & (v < best_v)
            best_u = jax.tree.map(
                lambda a, b: jnp.where(better, a, b), u, best_u)
            best_v = jnp.where(better, v, best_v)
            updates, st = opt.update(
                g, st, u, value=v, grad=g, value_fn=objective)
            jax.debug.callback(
                record, k, optax.tree.get(st, "num_linesearch_steps"))
            u = optax.apply_updates(u, updates)
            u = jax.tree.map(lambda a, b: a.astype(b.dtype), u, u0)
            return (u, st, best_u, best_v), None

        (u_f, _, best_u, best_v), _ = jax.lax.scan(
            step, (u0, state0, u0, big), jnp.arange(max_steps))
        v_f = objective(u_f)
        better = jnp.isfinite(v_f) & (v_f < best_v)
        best_u = jax.tree.map(lambda a, b: jnp.where(better, a, b), u_f,
                              best_u)
        best_v = jnp.where(better, v_f, best_v)
        return best_u, best_v

    jfit.sample_restarts = sample
    jfit._run_lbfgs = run_lbfgs
    t0 = time.perf_counter()
    ej = jmv.fit_multivariate(key, jnp.asarray(X, jnp.float32),
                              jnp.asarray(Y, jnp.float32),
                              jcfg.GPConfig(**kw), pca_variance=cs.C3_PCA)
    lls = np.asarray(ej.restart_log_likelihoods)
    wall = time.perf_counter() - t0
    steps = sorted(per_step)
    lanes = [per_step[k] for k in steps]
    out["jax"] = {
        "wall_s": wall,
        "components": int(ej.n_components),
        "lanes": len(lanes[0]) if lanes else 0,
        "evals_by_step": [max(x) for x in lanes],
        "mean_lane_evals_by_step": [float(np.mean(x)) for x in lanes],
        "lanes_at_cap_by_step": [sum(n >= 20 for n in x) for x in lanes],
        "best_loglik": lls.max(axis=1).tolist(),
    }
    for side in ("port", "jax"):
        e = out[side]["evals_by_step"]
        out[side]["linesearch_evals_per_step"] = sum(e) / max(len(e), 1)
        out[side]["steps_at_cap"] = sum(n >= 20 for n in e)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
