"""Kernel K3: fused panel factorization (L, L^-1) — wrapper and plain twin.

Replaces the TPU kernel `madaiemulator_tpu/ops/pallas/cholesky.py`
(`pallas_panel_factor`), which the left-looking large-N factorization
(`ops/linalg.left_cholesky`, diag="pallas") calls once per diagonal panel.
The CUDA source is `csrc/panel_factor.cu` on the shared device code
`csrc/chol_cluster.cuh`.

What bounds it on an H100, at a batch of 1-2 panels, is the chain of
dependent steps, not its 2 b^3 / 3 flops. The kernel is ONE launch per call,
one thread-block cluster of 1-16 CTAs per panel (K2's rule),
cluster barriers between dependent stages:

  1. the factor L by kernel K2's device code (`ops/hopper/cholesky.py`);
  2. L^-1 by recursive doubling: the 32x32 diagonal tiles inverted by
     forward substitution, then neighbouring inverted blocks of side
     s = 32, 64, ... merged, inv21 = -invC (L21 invA), in 64x64 FP32 tiles
     dealt over the cluster: log2(b / 32) levels of two product stages.

The plain version computes the same pair with a tile-diagonal recurrence,
inv[i,j] = -inv[i,i] sum_{k=j}^{i-1} L[i,k] inv[k,j]; the two differ by
float32 summation order only. Only the lower triangle of A is read, both
outputs are zero above the diagonal, and a pivot that is not positive gives
NaN in that member's L and L^-1 (never finite garbage), so `linalg.chol_ok`
and the serve path's jitter ladder work as with K2. Every product is full
FP32 (TF32 is off package-wide). b must be a multiple of 32.

`panel_factor` launches the kernel for CUDA tensors and raises on anything
the kernel does not take; for CPU tensors it runs `panel_factor_plain`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from madaiemulator_tpu_torch.ops.hopper import cholesky as k2

TILE = 32  # inverse tile side, as in csrc/chol_cluster.cuh (kNB)

# Kernel launches made by `panel_factor` (plain-version calls do not count).
launches = 0


def panel_factor_plain(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain-PyTorch K3 on any device: A (B, b, b) -> (L, L^-1)."""
    _check_tile(A)
    L = k2.cholesky_plain(A)
    B, b, _ = L.shape
    nb = b // TILE
    # tile views: Lt[:, i, k] is the (TILE, TILE) tile at tile row i, column k
    Lt = L.reshape(B, nb, TILE, nb, TILE).transpose(2, 3)
    Xt = torch.zeros_like(Lt)
    eye = torch.eye(TILE, dtype=L.dtype, device=L.device)
    D = Lt.diagonal(dim1=1, dim2=2).permute(0, 3, 1, 2)  # (B, nb, T, T)
    Dinv = torch.zeros_like(D)
    for i in range(TILE):  # forward substitution, all diagonal tiles at once
        contrib = (D[..., i:i + 1, :] @ Dinv)[..., 0, :]
        Dinv[..., i, :] = (eye[i] - contrib) / D[..., i, i:i + 1]
    idx = torch.arange(nb, device=L.device)
    Xt[:, idx, idx] = Dinv
    for s in range(1, nb):  # tile diagonals below the main one
        j = torch.arange(nb - s, device=L.device)
        acc = torch.zeros((B, nb - s, TILE, TILE), dtype=L.dtype,
                          device=L.device)
        for t in range(s):  # k = j + t, in the kernel's order
            acc = acc + Lt[:, j + s, j + t] @ Xt[:, j + t, j]
        Xt[:, j + s, j] = -(Dinv[:, j + s] @ acc)
    Linv = Xt.transpose(2, 3).reshape(B, b, b)
    return L, Linv


def _check_tile(A: torch.Tensor) -> None:
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(
            f"panel_factor: A must be a (B, b, b) tensor, got shape "
            f"{tuple(A.shape)}"
        )
    B, b, _ = A.shape
    if B == 0 or b == 0 or b % TILE:
        raise ValueError(
            f"panel_factor: b must be a positive multiple of {TILE}, got "
            f"shape {tuple(A.shape)}"
        )


def panel_factor(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on A (B, b, b), float32 and contiguous, b a multiple of 32: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Returns (L, L^-1), each (B, b, b)."""
    if A.device.type == "cpu":
        return panel_factor_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"panel_factor: unsupported device {A.device}")
    if A.dtype != torch.float32:
        raise TypeError(f"panel_factor: A must be float32, got {A.dtype}")
    _check_tile(A)
    if not A.is_contiguous():
        raise ValueError("panel_factor: A must be contiguous")
    B, b, _ = A.shape
    if B > 65535:
        raise ValueError(f"panel_factor: batch {B} > 65535")
    from madaiemulator_tpu_torch.ops.hopper import build

    lib = build.load()
    L = torch.empty_like(A)
    Linv = torch.empty_like(A)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.madai_panel_factor(A.data_ptr(), L.data_ptr(),
                                     Linv.data_ptr(), B, b, stream)
    build.check(lib, err, "panel_factor")
    global launches
    launches += 1
    return L, Linv
