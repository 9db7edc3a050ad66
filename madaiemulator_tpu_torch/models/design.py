"""Sequential (adaptive) experimental design over a trained emulator (port
of madaiemulator_tpu/models/design.py).

Given a fitted emulator, choose the next batch of simulator runs by

  * **active variance learning** (`active_variance_design`): a
    space-filling candidate pool scored by total normalized predictive
    variance, the batch picked greedily with a maximin spacing factor so it
    does not collapse onto one uncertainty peak;
  * **history-matching waves** (`nroy_wave_design`): the pool screened by
    the implausibility statistic (models/calibrate.py) and the batch chosen
    maximin space-filling inside the NROY ("not ruled out yet") region.

Every emulator kind is accepted, in the JAX package's order: multi-fidelity
(the recursive predict at the highest fidelity), sparse (SGPR, the O(m^2)
serve state), dense with serve states, and matrix-free (the PCG-free
"precond" variance by default). Pool scoring is one batched predict (on the
card at float32: K1 cross covariances); the greedy selection is a host loop
over the n_new picks with every argmax left on the device
(`_greedy_maximin`, also SGPR's inducing-point selector). The candidate
pool's Latin hypercube comes from a `torch.Generator` through
`_candidate_pool`; the JAX package draws from jax.random, so the pools
differ by design.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from madaiemulator_tpu_torch.models.calibrate import (
    _is_mf,
    _is_mf_mv,
    _is_sparse,
    implausibility_from_moments,
)
from madaiemulator_tpu_torch.models.multivariate import (
    _predict_components,
    reconstruct_observables,
)
from madaiemulator_tpu_torch.utils.designs import (
    latin_hypercube,
    unapply_scaling,
)


class DesignProposal(NamedTuple):
    """A proposed batch of new simulator runs.

    points: (n_new, d) NATURAL-space parameter points to run next
    scores: (n_new,) the acquisition value of each pick (selection order)
    pool_fraction_viable: the fraction of the candidate pool passing the
        screen (1.0 for variance designs; the NROY fraction for history-
        matching waves, the number to watch shrink across waves)
    """

    points: np.ndarray
    scores: np.ndarray
    pool_fraction_viable: float


def _greedy_maximin(
    points: torch.Tensor, weights: torch.Tensor, n_new: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy weighted-maximin batch selection.

    Picks argmax(weight), then repeatedly argmax(weight * min-sq-distance
    to everything already picked), the first maximum on ties. Zero-weight
    candidates are never picked while any positive-weight candidate
    remains; a picked point's distance factor drops to 0 so it cannot
    repeat. Returns (indices (n_new,) int32, pick scores (n_new,)).

    The JAX package runs one `fori_loop` on the device; here the loop runs
    on the host over n_new steps with every argmax left on the device, so
    the loop never waits for a pick (no read-back per step).
    """
    p, d = points.shape
    mind = torch.full((p,), float(d), dtype=points.dtype,
                      device=points.device)  # max sq-dist on [0,1]^d
    sel = torch.zeros((n_new,), dtype=torch.int32, device=points.device)
    scr = torch.zeros((n_new,), dtype=points.dtype, device=points.device)
    for i in range(n_new):
        score = weights if i == 0 else weights * mind
        idx = torch.argmax(score).reshape(1)
        d2 = ((points - points.index_select(0, idx)) ** 2).sum(1)
        mind = torch.minimum(mind, d2)
        sel[i] = idx[0]
        scr[i] = score.index_select(0, idx)[0]
    return sel, scr


def _variance_weights(var: torch.Tensor, ystd: torch.Tensor) -> torch.Tensor:
    """Active-variance acquisition weight: total predictive variance with
    each observable normalized by its training-output scale (ystd (t,)), so
    no large-magnitude observable dominates. The one definition every
    emulator kind uses. var (P, t) -> (P,)."""
    w = torch.clamp(ystd.to(var.dtype), min=torch.finfo(var.dtype).tiny)
    return (var / w[None, :] ** 2).sum(-1)


def _nroy_weights(imp: torch.Tensor, threshold: float,
                  dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """NROY selection weights from implausibilities: 1 inside NROY, a small
    least-implausible-first weight outside (so that, once every viable
    candidate is picked, the remaining picks are distinct well-spaced
    least-implausible points rather than ties at 0). Returns (weights (P,),
    viable fraction)."""
    viable = (imp <= threshold).to(dtype)
    return viable + 1e-6 / (1.0 + imp), viable.mean()


def _variance_select(emu_states, emu_params, X, Z, pca, config, pool, n_new,
                     dZ=None):
    """The dense branch: component moments over the pool, the weights, the
    greedy picks."""
    m_pc, v_pc = _predict_components(emu_states, emu_params, X, Z, pool,
                                     config, dZ=dZ)
    _, var = reconstruct_observables(m_pc, v_pc, pca)  # (P, t)
    return _greedy_maximin(pool, _variance_weights(var, pca.ystd), n_new)


def _nroy_pick(mean, var, y_exp, exp_var, pool, n_new: int,
               threshold: float):
    """Implausibility over the pool's moments, the NROY weights, the greedy
    picks: (indices, scores, viable fraction, implausibilities (P,))."""
    imp = implausibility_from_moments(mean, var, y_exp, exp_var)
    weights, frac = _nroy_weights(imp, threshold, pool.dtype)
    return (*_greedy_maximin(pool, weights, n_new), frac, imp)


def _nroy_select(emu_states, emu_params, X, Z, pca, config, y_exp, exp_var,
                 pool, n_new, threshold, dZ=None):
    """The dense branch of `nroy_wave_design` (`_nroy_pick` over the
    component moments)."""
    m_pc, v_pc = _predict_components(emu_states, emu_params, X, Z, pool,
                                     config, dZ=dZ)
    mean, var = reconstruct_observables(m_pc, v_pc, pca)  # (P, t)
    return _nroy_pick(mean, var, y_exp, exp_var, pool, n_new, threshold)


def _pool_moments_iterative(emu, pool: torch.Tensor, states, iter_kwargs):
    """Observable-space (mean, var) over a scaled pool for a matrix-free
    emulator. Defaults to the PCG-free "precond" variance: acquisition only
    ranks points, and a pool-wide exact PCG is slow; pass
    variance_method="exact" to override. `states` reuses a serving cache
    (`precompute_iterative_multivariate`)."""
    from madaiemulator_tpu_torch.models.multivariate import (
        predict_multivariate_iterative,
    )

    kw = dict(iter_kwargs or {})
    kw.setdefault("variance_method", "precond")
    return predict_multivariate_iterative(
        emu, unapply_scaling(pool, emu.scaling), states=states, **kw)


def _pool_moments_sparse(emu, pool: torch.Tensor):
    """Observable-space (mean, var) over a scaled pool for a sparse (SGPR)
    emulator, against its stored serve state."""
    from madaiemulator_tpu_torch.models.sparse import (
        predict_multivariate_sparse,
    )

    return predict_multivariate_sparse(emu, unapply_scaling(pool,
                                                            emu.scaling))


def _pool_moments_mf(emu, pool: torch.Tensor):
    """Observable-space (mean, var) over a scaled pool for a multi-fidelity
    emulator: the recursive predict at the HIGHEST fidelity ((P, 1) scalar,
    (P, t) multivariate), so a design targets new high-fidelity runs."""
    from madaiemulator_tpu_torch.models.multifidelity import (
        _predict_recursive,
        _predict_recursive_mv,
    )

    if _is_mf_mv(emu):
        m_pc, v_pc = _predict_recursive_mv(emu.levels, pool, emu.config)
        return reconstruct_observables(m_pc, v_pc, emu.pca)
    m, v = _predict_recursive(emu.levels, pool, emu.config)
    return m[:, None], v[:, None]


def _mf_ystd(emu) -> torch.Tensor:
    """Output-scale normalizer: pca.ystd for multivariate multi-fidelity;
    the top level's target spread for scalar multi-fidelity (its targets
    are stored in raw units)."""
    if _is_mf_mv(emu):
        return emu.pca.ystd
    return emu.levels[-1].data.y.std(correction=0).reshape(1)


def _design_array(emu) -> torch.Tensor:
    """The scaled points that set the pool's dtype, device and dimension:
    the training design (dense, matrix-free), the inducing set (sparse), or
    the top level's design (multi-fidelity)."""
    if _is_sparse(emu):
        return emu.Z
    if _is_mf_mv(emu):
        return emu.levels[-1].X
    if _is_mf(emu):
        return emu.levels[-1].data.X
    return emu.X


def _candidate_pool(generator: torch.Generator, n: int, d: int,
                    dtype) -> torch.Tensor:
    """The (n, d) Latin-hypercube candidate pool on [0,1]^d, on the CPU."""
    return latin_hypercube(generator, n, d, dtype=dtype)


def _pool(generator, emu, pool, pool_size: int) -> torch.Tensor:
    """The scaled candidate pool on the emulator's device and dtype: the
    caller's, or a Latin hypercube drawn on the CPU and moved there once."""
    design = _design_array(emu)
    if pool is None:
        pool = _candidate_pool(generator, pool_size, design.shape[1],
                               design.dtype)
    return _like(pool, design)


def _like(a, like: torch.Tensor) -> torch.Tensor:
    """a (a tensor, or an array copied: it may be read-only) on like's
    device and dtype."""
    t = a if isinstance(a, torch.Tensor) else torch.tensor(np.asarray(a))
    return t.to(device=like.device, dtype=like.dtype)


def _proposal(emu, pool, sel, scr, frac: float) -> DesignProposal:
    pts = unapply_scaling(pool.index_select(0, sel.long()), emu.scaling)
    return DesignProposal(points=pts.cpu().numpy(), scores=scr.cpu().numpy(),
                          pool_fraction_viable=frac)


@torch.no_grad()
def active_variance_design(
    generator: torch.Generator,
    emu,
    n_new: int,
    pool_size: int = 4096,
    pool=None,
    states=None,
    **iter_kwargs,
) -> DesignProposal:
    """The next `n_new` simulator runs by batch active learning (maximum
    variance): a Latin-hypercube pool over the scaled design cube (or the
    caller's `pool`, scaled coordinates) scored by total normalized
    predictive variance in one batched predict, the batch chosen greedily
    with a maximin spacing factor. Returns natural-space points.

    A matrix-free emulator (`IterativeMultivariateEmulator`) scores through
    its serving path: `states` from `precompute_iterative_multivariate`
    reuses the training solves; iter_kwargs forward to its predict."""
    pool = _pool(generator, emu, pool, pool_size)
    n_new = int(n_new)
    if _is_mf(emu):
        _, var = _pool_moments_mf(emu, pool)
        sel, scr = _greedy_maximin(pool, _variance_weights(var,
                                                           _mf_ystd(emu)),
                                   n_new)
    elif _is_sparse(emu):
        _, var = _pool_moments_sparse(emu, pool)
        sel, scr = _greedy_maximin(pool, _variance_weights(var, emu.pca.ystd),
                                   n_new)
    elif getattr(emu, "states", None) is not None:
        sel, scr = _variance_select(emu.states, emu.params, emu.X, emu.Z,
                                    emu.pca, emu.config, pool, n_new,
                                    dZ=emu.dZ)
    else:
        _, var = _pool_moments_iterative(emu, pool, states, iter_kwargs)
        sel, scr = _greedy_maximin(pool, _variance_weights(var, emu.pca.ystd),
                                   n_new)
    return _proposal(emu, pool, sel, scr, 1.0)


@torch.no_grad()
def nroy_wave_design(
    generator: torch.Generator,
    emu,
    y_exp,
    exp_var,
    n_new: int,
    threshold: float = 3.0,
    pool_size: int = 8192,
    pool=None,
    states=None,
    **iter_kwargs,
) -> DesignProposal:
    """The next wave of simulator runs for history matching: the pool
    screened by implausibility I(theta) (max over observables; 3 sigma by
    default) and `n_new` maximin space-filling points picked INSIDE the
    NROY region. With no viable point the picks fall back to the least
    implausible points and pool_fraction_viable is 0. exp_var is (t,)
    variances or a (t, t) covariance (its diagonal is used). A matrix-free
    emulator takes `states` / iter_kwargs as in active_variance_design."""
    pool = _pool(generator, emu, pool, pool_size)
    n_new, threshold = int(n_new), float(threshold)
    exp_var, y_exp = _like(exp_var, pool), _like(y_exp, pool)
    if exp_var.ndim == 2:
        exp_var = torch.diagonal(exp_var)
    if _is_mf(emu):
        mean, var = _pool_moments_mf(emu, pool)
    elif _is_sparse(emu):
        mean, var = _pool_moments_sparse(emu, pool)
    elif getattr(emu, "states", None) is not None:
        sel, scr, frac, _ = _nroy_select(
            emu.states, emu.params, emu.X, emu.Z, emu.pca, emu.config, y_exp,
            exp_var, pool, n_new, threshold, dZ=emu.dZ)
        return _proposal(emu, pool, sel, scr, float(frac))
    else:
        mean, var = _pool_moments_iterative(emu, pool, states, iter_kwargs)
    sel, scr, frac, _ = _nroy_pick(mean, var, y_exp, exp_var, pool, n_new,
                                   threshold)
    return _proposal(emu, pool, sel, scr, float(frac))
