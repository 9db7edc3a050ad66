"""Ensembles of independent emulators, fitted and served as one batch
(port of madaiemulator_tpu/parallel/ensemble.py; BASELINE config 5).

An MCMC calibration often wants thousands of small emulators, one per
member of an ensemble of data sets. Here they are one batch:

  * `fit_ensemble` fits E scalar GPs at once. Every (member e, restart r)
    pair is one L-BFGS lane, and all E x R lanes step together in one
    lock-step batch (`models.fit.fit_one_start`): each objective evaluation
    is one batched likelihood over the lanes, each lane on its own member's
    design X[e] and targets y[e], so at float32 on the card one K1 launch
    builds all E x R Grams and one K2 launch factors them.
  * `predict_ensemble` serves the E posteriors in one batched call.

Arrays are laid out (ensemble, restart, ...) as in the JAX package, so
scaling past one device is a mesh, not a rewrite. `make_mesh` lays devices
on the (ensemble, restart) axes (`parallel.mesh.Mesh`). With a mesh, the
members are split over the `ensemble` axis and the restarts over the
`restart` axis: each shard runs its own lock-step batch on its device (one
K1 and one K2 launch a shard an evaluation), with no traffic between
shards until the argmax over restarts, which runs on the mesh's first
device where the results are gathered. `predict_queries_sharded` splits one
emulator's query batch over the `ensemble` axis. The JAX package's TPU
crash workaround (`restart_split` defaulting to 2 on TPU backends) is not
ported: `restart_split` defaults to None, one R-wide batch.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence, Tuple

import torch

from madaiemulator_tpu_torch.models.fit import (
    FitResult,
    _fit_lanes,
    _flatten_t,
    _new_stats,
    sample_restarts,
)
from madaiemulator_tpu_torch.models.gp import GPData, gp_posterior
from madaiemulator_tpu_torch.ops.kernels import GPParams
from madaiemulator_tpu_torch.parallel import mesh as mesh_lib
from madaiemulator_tpu_torch.parallel.mesh import Mesh
from madaiemulator_tpu_torch.utils.config import GPConfig

ENSEMBLE_AXIS = "ensemble"
RESTART_AXIS = "restart"


def make_mesh(
    n_devices: Optional[int] = None,
    restart_shards: int = 1,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """An (ensemble, restart) mesh over the first n_devices visible CUDA
    devices (default: all), or over `devices` when given (a device may
    repeat: a virtual mesh, several shards on one card).

    restart_shards divides the restart axis over devices too (useful when
    E is small but R is large); default 1 = pure ensemble sharding."""
    devs = mesh_lib.visible_devices(n_devices, devices, "make_mesh")
    n = len(devs)
    if restart_shards < 1 or n % restart_shards != 0:
        raise ValueError(
            f"make_mesh: n_devices={n} is not divisible by "
            f"restart_shards={restart_shards}")
    grid = [devs[i:i + restart_shards] for i in range(0, n, restart_shards)]
    return Mesh(grid, (ENSEMBLE_AXIS, RESTART_AXIS))


def _axis_sizes(mesh: Mesh) -> Tuple[int, int]:
    shape = mesh.shape
    if ENSEMBLE_AXIS not in shape:
        raise ValueError(f"the mesh has no {ENSEMBLE_AXIS!r} axis "
                         f"(axes {mesh.axis_names}): use make_mesh")
    return shape[ENSEMBLE_AXIS], shape.get(RESTART_AXIS, 1)


def _fit(u0: torch.Tensor, Xb, yb, config: GPConfig, max_steps: int,
         ensemble_chunk=None, restart_split=None, mesh=None) -> FitResult:
    """The (E, R, P) starts u0 fitted by `models.fit._fit_lanes`, lane
    (e, r) on member e's design and targets, timed into `stats`; with a
    mesh, one `_fit_lanes` a shard (`_fit_sharded`)."""
    mesh_lib.check_mesh(mesh, "fit_ensemble")
    t0 = time.perf_counter()
    if mesh is None:
        res = _fit_lanes(u0.to(device=Xb.device, dtype=yb.dtype), Xb, yb,
                         config, max_steps, group_chunk=ensemble_chunk,
                         restart_chunk=restart_split, stats=_new_stats())
    else:
        res = _fit_sharded(u0, Xb, yb, config, max_steps, ensemble_chunk,
                           restart_split, mesh)
    res.stats["fit_wall_s"] = time.perf_counter() - t0
    return res


def _fit_sharded(u0, Xb, yb, config, max_steps, ensemble_chunk,
                 restart_split, mesh: Mesh) -> FitResult:
    """Shard (i, j) of the mesh fits members block i from restarts block j
    on its device (contiguous blocks; the starts are the unsharded ones).
    The shards' restart results are gathered into (E, R) on the mesh's
    first device and the argmax over every restart of a member taken there
    (the JAX package's `_merge_fit_results`). `stats`
    sums the shards' evaluation counts and keeps each shard's under
    "shards"."""
    se, sr = _axis_sizes(mesh)
    E, R = u0.shape[:2]
    e_blocks = [b for b in mesh_lib.blocks(E, se) if b[1] > b[0]]
    r_blocks = [b for b in mesh_lib.blocks(R, sr) if b[1] > b[0]]
    jobs = [(mesh.devices[i, j] if mesh.devices.ndim == 2
             else mesh.devices[i], e, r)
            for i, e in enumerate(e_blocks) for j, r in enumerate(r_blocks)]

    def shard(dev, e, r):
        (e0, e1), (r0, r1) = e, r
        return _fit_lanes(
            u0[e0:e1, r0:r1].to(device=dev, dtype=yb.dtype),
            Xb[e0:e1].to(dev), yb[e0:e1].to(dev), config, max_steps,
            group_chunk=ensemble_chunk, restart_chunk=restart_split,
            stats=_new_stats())

    parts = mesh.map([j[0] for j in jobs], shard, *zip(*jobs))
    first = mesh.first
    lls = torch.empty((E, R), dtype=yb.dtype, device=first)
    rparams = GPParams(*(torch.empty((E, R) + a.shape[2:], dtype=a.dtype,
                                     device=first)
                         for a in parts[0].restart_params))
    for (_, (e0, e1), (r0, r1)), p in zip(jobs, parts):
        lls[e0:e1, r0:r1] = p.restart_log_likelihoods.to(first)
        for dst, src in zip(rparams, p.restart_params):
            dst[e0:e1, r0:r1] = src.to(first)
    best = torch.argmax(lls, dim=1)
    members = torch.arange(E, device=first)
    stats = _new_stats()
    for p in parts:
        for key in ("n_vg_calls", "n_v_calls", "n_steps",
                    "linesearch_evals"):
            stats[key] += p.stats[key]
    stats["shards"] = [p.stats for p in parts]
    return FitResult(
        params=GPParams(*(a[members, best] for a in rparams)),
        log_likelihood=lls[members, best],
        restart_log_likelihoods=lls,
        restart_params=rparams,
        stats=stats,
    )


def fit_ensemble_from_starts(
    u0: GPParams, Xb: torch.Tensor, yb: torch.Tensor, config: GPConfig,
    max_steps: int, mesh: Optional[Mesh] = None,
) -> FitResult:
    """Fit E GPs from explicit unconstrained starts u0, leaves (E, R, ...),
    on designs Xb (E, N, d) and targets yb (E, N), on Xb's device. The
    E x R lanes run as one `fit_one_start` batch (K1 is handed the
    (E * R, N, d) scaled designs, one contiguous block per lane); the
    argmax over restarts skips non-finite LMLs. Every FitResult field
    carries the member axis in front: params (E, ...), log_likelihood (E,),
    restart_log_likelihoods (E, R) (-inf where not finite), restart_params
    (E, R, ...); `stats` counts the objective evaluations and the wall
    time.

    `mesh` (`make_mesh`) places the starts at (ensemble, restart) and the
    designs at (ensemble), one batch a shard, the results gathered on the
    mesh's first device: the JAX package reaches the same by placing its
    inputs with P(ensemble, restart) before the call."""
    return _fit(_flatten_t(u0), Xb, yb, config, max_steps, mesh=mesh)


def fit_ensemble(
    generator: torch.Generator,
    Xb: torch.Tensor,  # (E, N, d)
    yb: torch.Tensor,  # (E, N)
    config: GPConfig,
    mesh: Optional[Mesh] = None,
    n_restarts: Optional[int] = None,
    max_steps: Optional[int] = None,
    ensemble_chunk: Optional[int] = None,
    restart_split: Optional[int] = None,
) -> FitResult:
    """Fit E independent scalar GPs at once (BASELINE config 5), on Xb's
    device, or over a device mesh.

    The starts are drawn by `models.fit.sample_restarts(generator, ...)`,
    once per member, in member order, before any sharding, chunking or
    splitting, so none of them changes them. All E x R lanes run as one
    lock-step L-BFGS batch; with a `mesh` (`make_mesh`), the members split
    over its `ensemble` axis and the restarts over its `restart` axis, one
    batch a shard on the shard's device, the results gathered on the
    mesh's first device. ensemble_chunk runs each batch's members in
    sequential groups of that size (E must be a multiple of it);
    restart_split runs the restarts in sequential parts of at most that
    many (the JAX package draws each part from a fresh key; here the parts
    split the one draw). A lane's arithmetic does not depend on which
    other lanes share its batch, except through the rounding of batched
    products of another size: so every layout gives one batch's result at
    float64, while at float32 on the card a linesearch branch can flip on
    one ulp and move a member's trajectory (the JAX package's note,
    tests/test_ensemble.py:68-72). Like the JAX function, there is no
    dead-start rescue: a lane whose start is not finite keeps LML -inf and
    loses the argmax.
    """
    R = config.n_restarts if n_restarts is None else n_restarts
    steps = config.max_opt_steps if max_steps is None else max_steps
    E = Xb.shape[0]
    if ensemble_chunk is not None and E % min(ensemble_chunk, E) != 0:
        raise ValueError(f"ensemble size E={E} not divisible by "
                         f"ensemble_chunk={ensemble_chunk}")
    t0 = time.perf_counter()
    u0 = torch.stack([
        _flatten_t(sample_restarts(generator, config, R, dtype=yb.dtype))
        for _ in range(E)])  # (E, R, P)
    res = _fit(u0, Xb, yb, config, steps, ensemble_chunk, restart_split,
               mesh)
    res.stats["fit_wall_s"] = time.perf_counter() - t0
    return res


def predict_queries_sharded(
    emu,
    Xs_raw,
    mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a large query batch of ONE trained multivariate emulator over
    the mesh's `ensemble` axis: each shard computes the cross covariances
    and solves of its slice of the queries on its device, against a copy
    of the trained state made once per distinct device. The batch is
    padded to a multiple of the axis size by wrapping its own indices (so
    even fewer queries than shards pad right), and the means and variances
    come back gathered on the mesh's first device, (m, t) each."""
    from madaiemulator_tpu_torch.models.multivariate import (
        predict_multivariate,
    )

    mesh_lib.check_mesh(mesh, "predict_queries_sharded")
    if mesh is None:
        return predict_multivariate(emu, Xs_raw)
    devs = mesh.axis_devices(ENSEMBLE_AXIS)
    Xs = torch.as_tensor(Xs_raw, dtype=emu.X.dtype, device=mesh.first)
    m = Xs.shape[0]
    shards = mesh_lib.place(mesh_lib.split(Xs, len(devs), wrap=True), devs)
    replicas = {d: mesh_lib.replicate(emu, d) for d in dict.fromkeys(devs)}
    parts = mesh.map(devs, lambda d, x: predict_multivariate(replicas[d], x),
                     devs, shards)
    mean = mesh_lib.gather([p[0] for p in parts], mesh.first)
    var = mesh_lib.gather([p[1] for p in parts], mesh.first)
    return mean[:m], var[:m]


def predict_ensemble(
    params: GPParams,  # batched (E, ...)
    Xb: torch.Tensor,  # (E, N, d)
    yb: torch.Tensor,  # (E, N)
    Xsb: torch.Tensor,  # (E, m, d) query points per member
    config: GPConfig,
    mesh: Optional[Mesh] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched posterior (means, variances), (E, m) each: one factorization
    of the E Grams and one batched predict (`models.gp.gp_posterior`; at
    float32 on the card, K1 for the Grams and the cross-covariances, K2 for
    the factors). With a `mesh`, the members split over its `ensemble`
    axis, one such call a shard (2 K1 + 1 K2 launches each), gathered on
    the mesh's first device."""
    mesh_lib.check_mesh(mesh, "predict_ensemble")
    if mesh is None:
        return gp_posterior(params, GPData(X=Xb, y=yb), Xsb, config)
    _axis_sizes(mesh)
    devs = mesh.axis_devices(ENSEMBLE_AXIS)
    jobs = [(d, e0, e1) for d, (e0, e1)
            in zip(devs, mesh_lib.blocks(Xb.shape[0], len(devs))) if e1 > e0]

    def shard(dev, e0, e1):
        p = GPParams(*(a[e0:e1].to(dev) for a in params))
        return gp_posterior(p, GPData(X=Xb[e0:e1].to(dev),
                                      y=yb[e0:e1].to(dev)),
                            Xsb[e0:e1].to(dev), config)

    parts = mesh.map([j[0] for j in jobs], shard, *zip(*jobs))
    return (mesh_lib.gather([p[0] for p in parts], mesh.first),
            mesh_lib.gather([p[1] for p in parts], mesh.first))
