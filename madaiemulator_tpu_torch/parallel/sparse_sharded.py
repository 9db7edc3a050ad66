"""Data-parallel SGPR: the multi-device path of the million-point fit (port
of madaiemulator_tpu/parallel/sparse_sharded.py).

Every summary of `models.sparse._sgpr_system` (B - I = A A^T, A H_w, A y_w,
the H_w / y_w Grams, the trace and log-diagonal terms) is a SUM over
training rows, and the inducing-side operands (Z, Lm) are small. So the
rows split over a 1-D mesh (`make_rows_mesh`), one contiguous block a
device (`shard_data_rows`), each shard runs the row-chunked, checkpointed
summary loop on its own device (one (m, row_chunk) K1 cross covariance a
chunk at float32), and the nine partial sums are summed onto Z's device,
where everything downstream (O(m^2) and O(p^2)) runs once. That sum is the
one collective, the psum the JAX package's GSPMD inserts: an (m, m) +
(m, p) + (p, p) reduction an evaluation. The ELBO stays differentiable in
(params, Z) by autograd across the devices.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from madaiemulator_tpu_torch.models import sparse
from madaiemulator_tpu_torch.models.gp import GPData
from madaiemulator_tpu_torch.ops.kernels import GPParams
from madaiemulator_tpu_torch.parallel import mesh as mesh_lib
from madaiemulator_tpu_torch.parallel.iterative_sharded import (  # noqa: F401
    ROWS_AXIS,
    make_rows_mesh,
)
from madaiemulator_tpu_torch.parallel.mesh import Mesh
from madaiemulator_tpu_torch.utils.config import GPConfig


def shard_data_rows(data: GPData, mesh: Mesh) -> List[GPData]:
    """The training rows split over the mesh: one GPData a slot, on its
    device, with X, y, noise, h_extra, dY and dY_noise split with the rows
    (the JAX function returns one row-sharded GPData instead). N must be a
    multiple of the mesh size, as in JAX; pad upstream with noise=inf rows
    if it is not (rsqrt(inf) = 0 rows are exact no-ops in every
    summary)."""
    mesh_lib.check_mesh(mesh, "shard_data_rows")
    n, size = data.X.shape[0], mesh.size
    if n % size:
        raise ValueError(f"shard_data_rows: N={n} is not a multiple of the "
                         f"mesh size {size} (pad with noise=inf rows)")
    devs = list(mesh.devices.flat)

    def parts(t):
        if t is None:
            return [None] * size
        return mesh_lib.place(mesh_lib.split(t, size), devs)

    return [GPData(*row) for row in zip(*(parts(t) for t in data))]


def elbo_sharded(
    params: GPParams,
    data: GPData,
    config: GPConfig,
    Z: torch.Tensor,
    mesh: Mesh,
    row_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Data-parallel SGPR ELBO over the row-sharded training set: the SAME
    math as `models.sparse.elbo`, its row sums computed a shard a device
    and summed on Z's device (see the module docstring); equal to the
    single-device value up to the order of that sum. Differentiable in
    (params, Z) like `elbo`. row_chunk streams each shard's rows in
    checkpointed chunks, as `elbo` does (the JAX function has none)."""
    shards = shard_data_rows(data, mesh)
    return sparse._elbo_of(
        sparse._sgpr_system(params, data, config, Z, row_chunk=row_chunk,
                            shards=(mesh, shards)), data, config)
