"""Batched ensembles and the multi-device paths (port of
madaiemulator_tpu/parallel/): `ensemble` fits and serves E scalar GPs at
once, every (member x restart) lane in one lock-step batch, over one device
or a device mesh (`mesh.Mesh`, `make_mesh`); `iterative_sharded` and
`sparse_sharded` split the training rows of the matrix-free GP and of SGPR
over a 1-D mesh."""

from madaiemulator_tpu_torch.parallel.ensemble import (
    fit_ensemble,
    fit_ensemble_from_starts,
    make_mesh,
    predict_ensemble,
    predict_queries_sharded,
)

__all__ = [
    "fit_ensemble",
    "fit_ensemble_from_starts",
    "make_mesh",
    "predict_ensemble",
    "predict_queries_sharded",
]
