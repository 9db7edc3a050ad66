"""PyTorch / CUDA port of `madaiemulator_tpu`, for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its layout
(`utils/`, `ops/`, `models/`, `io/`, `compat.py`, `cli.py`) so the
counterpart of each module sits at the same relative path, and re-exports
the same public names (`__all__`; the XLA-only `enable_compile_cache` has no
counterpart). It imports torch and numpy, never jax.

What it runs, on the card by default (`device="cpu"` / `--device cpu` on
request): the dense GP (the GLS log-marginal likelihood with its
closed-form gradient, the multi-restart L-BFGS fit, serving, the update
precision tiers, GEMM-only fast serving, noise and gradient observations),
PCA multivariate emulators, ensembles of small emulators, the matrix-free
GP past dense device memory (`models.iterative`), sparse SGPR
(`models.sparse`), multi-fidelity co-kriging (`models.multifidelity`),
validation diagnostics, in-process MCMC calibration and history matching
(`models.calibrate`), sequential design (`models.design`), Sobol
sensitivity (`models.sensitivity`), the R-binding array API (`compat`),
profiling (`utils.profiling`), every snapshot grammar (text and .npz) and
the `interactive_emulator_torch` CLI, and the multi-device paths over a
device mesh (`parallel/`: the ensemble, sharded serving, the row-sharded
matrix-free GP, data-parallel SGPR, the row-sharded factor
`ops.linalg.left_cholesky_sharded` and walker sharding).

The three TPU kernels are hand-written CUDA for sm_90a under `ops/hopper/`
+ `csrc/`, built by nvcc at first use (never at import):

    K1  pairwise covariance   <- madaiemulator_tpu/ops/pallas/pairwise.py
    K2  batched Cholesky      <- madaiemulator_tpu/ops/pallas/cholesky.py
    K3  panel factor + inverse <- madaiemulator_tpu/ops/pallas/cholesky.py

K2 and K3 are each ONE kernel launch per call: the grid is one thread-block
cluster per matrix, and the chain of 32-wide panel steps (and, in K3, the
recursive-doubling inverse after it) runs inside the kernel with cluster
barriers between dependent stages (`csrc/chol_cluster.cuh`).

Numerics: every float32 product must run in full FP32, as the JAX package
pins its dots to Precision.HIGHEST. Importing this package therefore turns
TF32 off for matmuls and cuDNN and keeps the float32 matmul precision at
"highest" (these are process-wide PyTorch flags).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from madaiemulator_tpu_torch.utils.config import (  # noqa: E402
    CovarianceFamily,
    GPConfig,
)
from madaiemulator_tpu_torch.models.gp import (  # noqa: E402
    GPData,
    gp_posterior,
    log_marginal_likelihood,
    log_marginal_likelihood_ad,
    precompute_fast_predictor,
    precompute_predictor,
    predict_fast,
    predict_from_precomputed,
    predict_gradient,
)
from madaiemulator_tpu_torch.models.fit import (  # noqa: E402
    AlphaFitResult,
    FitResult,
    fit_gp,
    fit_gp_alpha,
    fit_gp_host,
)
from madaiemulator_tpu_torch.models.iterative import (  # noqa: E402
    IterativePosteriorState,
    fit_gp_iterative,
    lml_iterative,
    precompute_iterative_predictor,
    predict_iterative,
    predict_iterative_from_state,
)
from madaiemulator_tpu_torch.models.multivariate import (  # noqa: E402
    MultivariateEmulator,
    fit_multivariate,
    predict_multivariate,
    predict_multivariate_gradient,
    project_gradients,
    project_noise,
)
from madaiemulator_tpu_torch.models.multifidelity import (  # noqa: E402
    MultiFidelityEmulator,
    MultivariateMultiFidelityEmulator,
    fit_multifidelity,
    fit_multivariate_multifidelity,
    predict_multifidelity,
    predict_multivariate_multifidelity,
)
from madaiemulator_tpu_torch.models.sparse import (  # noqa: E402
    SparseMultivariateEmulator,
    fit_multivariate_sparse,
    fit_sgpr,
    fit_sgpr_host,
    predict_multivariate_sparse,
    predict_sgpr,
)
from madaiemulator_tpu_torch.models.calibrate import (  # noqa: E402
    CalibrationResult,
    calibrate,
    implausibility,
    make_log_posterior,
    run_emcee,
    run_hmc,
    run_parallel_tempering,
    run_rwm,
)
from madaiemulator_tpu_torch.models.sensitivity import (  # noqa: E402
    SobolResult,
    gp_mean_fn,
    main_effects,
    multivariate_mean_fn,
    sobol_indices,
)
from madaiemulator_tpu_torch.models.design import (  # noqa: E402
    DesignProposal,
    active_variance_design,
    nroy_wave_design,
)
from madaiemulator_tpu_torch.models.diagnostics import (  # noqa: E402
    LOOResult,
    holdout_cv_multivariate,
    holdout_summary_multivariate,
    loo_cv,
    loo_cv_multivariate,
    loo_summary,
    loo_summary_multivariate,
    posterior_covariance,
    posterior_covariance_iterative,
    sample_multivariate_posterior,
    sample_multivariate_posterior_iterative,
    sample_posterior,
    validation_summary,
)

__version__ = "0.1.0"

__all__ = [
    "GPConfig",
    "CovarianceFamily",
    "GPData",
    "log_marginal_likelihood",
    "log_marginal_likelihood_ad",
    "gp_posterior",
    "precompute_predictor",
    "precompute_fast_predictor",
    "predict_fast",
    "predict_gradient",
    "SobolResult",
    "gp_mean_fn",
    "main_effects",
    "multivariate_mean_fn",
    "sobol_indices",
    "predict_from_precomputed",
    "fit_gp",
    "fit_gp_alpha",
    "fit_gp_host",
    "AlphaFitResult",
    "IterativePosteriorState",
    "fit_gp_iterative",
    "lml_iterative",
    "precompute_iterative_predictor",
    "predict_iterative",
    "predict_iterative_from_state",
    "FitResult",
    "MultivariateEmulator",
    "fit_multivariate",
    "project_noise",
    "project_gradients",
    "predict_multivariate_gradient",
    "MultiFidelityEmulator",
    "MultivariateMultiFidelityEmulator",
    "fit_multifidelity",
    "fit_multivariate_multifidelity",
    "predict_multifidelity",
    "predict_multivariate_multifidelity",
    "SparseMultivariateEmulator",
    "fit_multivariate_sparse",
    "fit_sgpr",
    "fit_sgpr_host",
    "predict_multivariate_sparse",
    "predict_sgpr",
    "predict_multivariate",
    "CalibrationResult",
    "calibrate",
    "implausibility",
    "make_log_posterior",
    "run_emcee",
    "run_hmc",
    "run_parallel_tempering",
    "run_rwm",
    "DesignProposal",
    "active_variance_design",
    "nroy_wave_design",
    "LOOResult",
    "holdout_cv_multivariate",
    "holdout_summary_multivariate",
    "posterior_covariance_iterative",
    "sample_multivariate_posterior_iterative",
    "loo_cv",
    "loo_cv_multivariate",
    "loo_summary",
    "loo_summary_multivariate",
    "posterior_covariance",
    "sample_posterior",
    "sample_multivariate_posterior",
    "validation_summary",
    "__version__",
]
