"""PyTorch / CUDA port of `madaiemulator_tpu`, for one NVIDIA H100.

The JAX package stays the reference; this package mirrors its layout
(`utils/`, `ops/`, `models/`, `io/`, `cli.py`) so the counterpart of each
module sits at the same relative path. It imports torch and numpy, never jax.

This slice ports the dense multivariate serve path: read a trained snapshot,
build the per-component serve states (Gram + Cholesky), and answer queries
(`models.multivariate.predict_multivariate`, CLI `interactive_mode`). The two
TPU kernels on that path are hand-written CUDA for sm_90a under
`ops/hopper/` + `csrc/`:

    K1  pairwise covariance   <- madaiemulator_tpu/ops/pallas/pairwise.py
    K2  batched Cholesky      <- madaiemulator_tpu/ops/pallas/cholesky.py

Numerics: every float32 product must run in full FP32, as the JAX package
pins its dots to Precision.HIGHEST. Importing this package therefore turns
TF32 off for matmuls and cuDNN and keeps the float32 matmul precision at
"highest" (these are process-wide PyTorch flags).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
