"""Kernel K2: batched lower Cholesky — wrapper and plain twin.

Replaces the TPU kernel `madaiemulator_tpu/ops/pallas/cholesky.py`
(`pallas_cholesky`), the VMEM-resident factorization of the serve-state and
fit-loop Grams (N <= `GPConfig.pallas_cholesky_max_n`). The CUDA source is
`csrc/cholesky.cu` on the shared device code `csrc/chol_cluster.cuh`.

What bounds it on an H100 is neither flops nor bytes but the chain of n / 32
dependent panel steps, so the design keeps a step short: ONE kernel launch
per call, one thread-block cluster of 1-16 CTAs per matrix (a fixed rule
from the batch and the side, `cluster_size_rule` in the header), the panel
chain inside the kernel with a cluster barrier where a launch boundary would
stand. Per 32-wide panel (right-looking): the diagonal block
factored by one warp of every CTA, the panel below solved by the cluster's
warps, the trailing update in 64x64 register-tiled FP32 tiles dealt over the
cluster. The matrix stays in L2-resident global memory (a 1024^2 matrix is
4 MiB; a CTA may use 227 KB of shared memory).

The plain version computes the same function, right-looking over 32-wide
panels with library calls for the solve and the update; the two differ by
float32 summation order only. Only the lower triangle of A is read, the
factor has zeros above the diagonal, and a pivot that is not positive
becomes NaN, so a non-SPD input gives NaN entries (never finite garbage):
`linalg.chol_ok` and the serve path's jitter ladder rely on that. n needs no
padding.

`cholesky` launches the kernel for CUDA tensors and raises on anything the
kernel does not take; for CPU tensors it runs `cholesky_plain`.
"""

from __future__ import annotations

import torch

PANEL = 32  # panel width, as in csrc/chol_cluster.cuh (kNB)

# Kernel launches made by `cholesky` (plain-version calls do not count).
launches = 0


def cholesky_plain(A: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch K2 on any device: A (B, n, n) -> lower L (B, n, n)."""
    M = torch.tril(A).clone()
    n = M.shape[-1]
    nan = torch.tensor(float("nan"), dtype=M.dtype, device=M.device)
    for k0 in range(0, n, PANEL):
        k1 = min(k0 + PANEL, n)
        for j in range(k0, k1):  # unblocked factor of the diagonal block
            p = M[:, j, j]
            piv = torch.where(p > 0, torch.sqrt(p.clamp(min=0)), nan)
            M[:, j, j] = piv
            M[:, j + 1:k1, j] = M[:, j + 1:k1, j] / piv[:, None]
            c = M[:, j + 1:k1, j]
            M[:, j + 1:k1, j + 1:k1] -= c[:, :, None] * c[:, None, :]
        if k1 < n:
            L11 = torch.tril(M[:, k0:k1, k0:k1])
            # L21 L11^T = A21
            L21 = torch.linalg.solve_triangular(
                L11.mT, M[:, k1:, k0:k1], upper=True, left=False
            )
            M[:, k1:, k0:k1] = L21
            M[:, k1:, k1:] -= L21 @ L21.mT
    return torch.tril(M)


def cholesky(A: torch.Tensor) -> torch.Tensor:
    """K2 on A (B, n, n), float32 and contiguous: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if A.device.type == "cpu":
        return cholesky_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"cholesky: unsupported device {A.device}")
    if A.dtype != torch.float32:
        raise TypeError(f"cholesky: A must be float32, got {A.dtype}")
    if A.ndim != 3 or A.shape[1] != A.shape[2] or not A.is_contiguous():
        raise ValueError(
            f"cholesky: A must be a contiguous (B, n, n) tensor, got "
            f"shape {tuple(A.shape)}"
        )
    B, n, _ = A.shape
    if B == 0 or n == 0:
        raise ValueError(f"cholesky: unsupported shape {tuple(A.shape)}")
    if B > 65535:
        raise ValueError(
            f"cholesky: batch {B} > 65535 matrices a launch; split the batch "
            "(fit_ensemble: ensemble_chunk or restart_split)")
    from madaiemulator_tpu_torch.ops.hopper import build

    lib = build.load()
    L = torch.empty_like(A)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.madai_cholesky(A.data_ptr(), L.data_ptr(), B, n, stream)
    build.check(lib, err, "cholesky")
    global launches
    launches += 1
    return L
