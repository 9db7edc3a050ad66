"""PyTorch / CUDA port of `madaiemulator_tpu`, for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its layout
(`utils/`, `ops/`, `models/`, `io/`, `cli.py`) so the counterpart of each
module sits at the same relative path. It imports torch and numpy, never jax.

Ported so far: the dense multivariate serve path (read a trained snapshot,
build the per-component serve states, answer queries:
`models.multivariate.predict_multivariate`, CLI `interactive_mode`), and the
large-N fit and serve of one GP (BASELINE config 4: the GLS log-marginal
likelihood with its closed-form gradient, `models.gp`; the host-loop LBFGS
`models.fit.fit_gp_host`; `models.gp.precompute_predictor_safe`), and the
matrix-free GP past dense device memory (`models.iterative`: PCG, SLQ /
mBCG, the Hutchinson backward; every tile by K1). The three TPU kernels on
those paths are hand-written CUDA for sm_90a under `ops/hopper/` +
`csrc/`:

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
