"""Row-sharded matrix-free GP inference: the multi-device large-N path (port
of madaiemulator_tpu/parallel/iterative_sharded.py).

The training rows split over a 1-D mesh (`make_rows_mesh`), one contiguous
block a slot, as the JAX function pads them: ceil(N / slots) rows a block,
the last block short (the JAX package pads it with zero rows and drops
their output). Each shard builds only its own row block of C @ V, in
`row_chunk` pieces: one (row_chunk, N) K1 tile at float32 and one full-FP32
GEMM each, as `models.iterative.gram_matvec` does on one device. X and the
parameters are copied to each distinct device once a matvec closure; the
right-hand side is copied to every device each call and the row blocks are
gathered back, one all-gather a matvec, the traffic of the JAX docstring.
The pivoted-Cholesky preconditioner and the PCG vector algebra stay on the
caller's device, replicated as in JAX, and consume the sharded matvec
unchanged: they are written against a matvec closure. The likelihood's
backward shards its tile loop by the same row blocks
(`quad_form_tile_grads`): each device accumulates its partial gradient and
the partials are summed on the parameters' device.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from madaiemulator_tpu_torch.ops import kernels
from madaiemulator_tpu_torch.ops.kernels import GPParams
from madaiemulator_tpu_torch.parallel import mesh as mesh_lib
from madaiemulator_tpu_torch.parallel.mesh import Mesh
from madaiemulator_tpu_torch.utils.config import GPConfig

ROWS_AXIS = "rows"


def make_rows_mesh(n_devices: Optional[int] = None,
                   devices=None) -> Mesh:
    """A 1-D ("rows",) mesh over the first n_devices visible CUDA devices
    (default: all), or over `devices` (a device may repeat: a virtual
    mesh). Asking for more devices than are visible raises."""
    return Mesh(mesh_lib.visible_devices(n_devices, devices,
                                         "make_rows_mesh"), (ROWS_AXIS,))


def row_blocks(n: int, mesh: Mesh) -> List[Tuple[torch.device, int, int]]:
    """(device, first row, end row) of each non-empty row block: slot i
    holds rows [i L, min((i + 1) L, n)), L = ceil(n / slots)."""
    return [(dev, r0, r1) for dev, (r0, r1)
            in zip(mesh.devices.flat, mesh_lib.blocks(n, mesh.size))
            if r1 > r0]


def _chunk(n: int, mesh: Mesh, row_chunk: int) -> int:
    return min(row_chunk, -(-n // mesh.size))


def make_sharded_matvec(
    X: torch.Tensor,
    params: GPParams,
    config: GPConfig,
    mesh: Mesh,
    row_chunk: int = 2048,
    noise: Optional[torch.Tensor] = None,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Matvec closure V -> C(theta) @ V for `models.iterative`'s
    primitives (pcg_solve, slq_logdet), row-sharded over `mesh`; the
    product comes back on V's device. `noise` is an optional (n,)
    per-point observation-noise variance vector (GPData.noise); it splits
    with the rows like the diagonal term."""
    from madaiemulator_tpu_torch.models.iterative import _diag_add

    mesh_lib.check_mesh(mesh, "make_sharded_matvec")
    n = X.shape[0]
    chunk = _chunk(n, mesh, row_chunk)
    blocks = row_blocks(n, mesh)
    with torch.no_grad():
        da = _diag_add(n, params, config, X.dtype)
        diag = da if noise is None else da + noise.to(X.dtype)
        reps = {dev: (X.to(dev), GPParams(*(t.to(dev) for t in params)),
                      diag.to(dev)) for dev in mesh.distinct}

    @torch.no_grad()
    def shard(dev, r0, r1, Vs):
        Xf, prm, dg = reps[dev]
        Vf = Vs[dev]
        Xl = Xf[r0:r1]
        out = torch.cat([
            kernels.cross_covariance(Xl[i:i + chunk], Xf, prm, config) @ Vf
            for i in range(0, r1 - r0, chunk)])
        dl = dg[r0:r1, None] if dg.ndim else dg
        return out + dl * Vf[r0:r1]

    def matvec(V: torch.Tensor) -> torch.Tensor:
        vec = V.ndim == 1
        V2 = V[:, None] if vec else V
        Vs = {dev: V2.to(dev) for dev in mesh.distinct}
        parts = mesh.map([b[0] for b in blocks], shard, *zip(*blocks),
                         [Vs] * len(blocks))
        out = mesh_lib.gather(parts, V.device)
        return out[:, 0] if vec else out

    return matvec


def sharded_gram_matvec(
    X: torch.Tensor,
    params: GPParams,
    config: GPConfig,
    V: torch.Tensor,
    mesh: Mesh,
    row_chunk: int = 2048,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """C(theta) @ V with the row dimension sharded over `mesh`: each shard
    computes its row block against the full X and V, in sequential chunks
    of `row_chunk` rows (one K1 tile and one GEMM each), and the blocks
    come back concatenated on V's device, (n, m) (or (n,) for a vector
    V). `noise` is an optional (n,) per-point noise variance vector."""
    return make_sharded_matvec(X, params, config, mesh, row_chunk,
                               noise=noise)(V)


def pcg_solve_sharded(
    X: torch.Tensor,
    params: GPParams,
    config: GPConfig,
    B: torch.Tensor,
    mesh: Mesh,
    precond_rank: int = 64,
    tol: float = 1e-6,
    max_iters: int = 256,
    row_chunk: int = 2048,
    noise: Optional[torch.Tensor] = None,
):
    """Sharded C^-1 B: the pivoted-Cholesky preconditioner (built once on
    X's device, O(N k (k + d))) and batched PCG over the sharded matvec.
    Returns (X, rel_residual, iters) as `models.iterative.pcg_solve`."""
    from madaiemulator_tpu_torch.models import iterative

    da = iterative._diag_add(X.shape[0], params, config, X.dtype)
    if noise is not None:
        da = da + noise.to(X.dtype)
    Lk = iterative.pivoted_cholesky(X, params, config, precond_rank)
    pre = iterative.make_preconditioner(Lk, da)
    mv = make_sharded_matvec(X, params, config, mesh, row_chunk, noise=noise)
    return iterative.pcg_solve(mv, B, pre, tol=tol, max_iters=max_iters)


def slq_logdet_sharded(
    X: torch.Tensor,
    params: GPParams,
    config: GPConfig,
    mesh: Mesh,
    seed: int,
    probes: int = 16,
    lanczos_iters: int = 32,
    row_chunk: int = 2048,
) -> torch.Tensor:
    """log|C| by stochastic Lanczos quadrature over the sharded matvec, the
    probes drawn from `seed` (`models.iterative.slq_logdet`; the JAX
    function takes a PRNG key there)."""
    from madaiemulator_tpu_torch.models import iterative

    mv = make_sharded_matvec(X, params, config, mesh, row_chunk)
    return iterative.slq_logdet(mv, X.shape[0], seed, probes=probes,
                                lanczos_iters=lanczos_iters, dtype=X.dtype,
                                device=X.device)


def quad_form_tile_grads(params: GPParams, X: torch.Tensor,
                         config: GPConfig, W: torch.Tensor, V: torch.Tensor,
                         mesh: Mesh, row_chunk: int) -> tuple:
    """The kernel part of d/dtheta sum_j w_j^T C(theta) v_j, per leaf of
    params, with the tile loop of `models.iterative._quad_form_grad` split
    by the matvec's row blocks: each shard rebuilds its own tiles under
    autograd on its device and accumulates its partial gradient there; the
    partials are summed on the parameters' device."""
    from madaiemulator_tpu_torch.models.iterative import _tile_grads

    n = X.shape[0]
    chunk = _chunk(n, mesh, row_chunk)
    blocks = row_blocks(n, mesh)
    reps = {dev: (X.to(dev), V.to(dev)) for dev in mesh.distinct}

    def shard(dev, r0, r1):
        Xf, Vf = reps[dev]
        with torch.enable_grad():
            p = GPParams(*(t.detach().to(dev).requires_grad_(True)
                           for t in params))
            return tuple(_tile_grads(Xf[r0:r1], Xf, p, config,
                                     W[r0:r1].to(dev), Vf, chunk))

    parts = mesh.map([b[0] for b in blocks], shard, *zip(*blocks))
    return mesh_lib.sum_partials(parts, params.log_amp.device)
