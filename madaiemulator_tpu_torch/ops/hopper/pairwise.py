"""Kernel K1: fused pairwise covariance (Gram / cross) — wrapper and plain twin.

Replaces the TPU kernel `madaiemulator_tpu/ops/pallas/pairwise.py`
(`pairwise_covariance`). The CUDA source is `csrc/pairwise.cu`, whose header
says what bounds it on an H100 and how its design answers that.

For a batch of B components, on points already divided by their length
scales:

    out[b, i, j] = family(sum_k (U[b, i, k] - V[b, j, k])^2)
                   (+ diag_add[b] on the diagonal when add_diag)

The distance is the direct difference form. It equals the TPU kernel's
||u||^2 + ||v||^2 - 2 u.v up to float32 rounding, and for U == V it is
bitwise symmetric by construction, which `gram_matrix` relies on (it does not
re-symmetrize on this path).

`pairwise_covariance` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; for CPU tensors it runs
`pairwise_covariance_plain`, the same function in plain PyTorch with the
same operation order (so the two agree bit for bit in the distance). Handed
the same tensor as U and V, the kernel computes only the lower triangle of
tiles and mirrors it (the Gram route); distinct tensors always take the full
route. `diag_add` may be None when `add_diag` is False.

The wrapper is on the serve path's latency (one K1 call per request), so it
does as little as it can on the host: the C entry point is looked up once,
the stream is read as a raw handle, and the device guard is entered only
when U is not on the current device.
"""

from __future__ import annotations

import math

import torch

from madaiemulator_tpu_torch.ops.hopper import build  # builds at load(), not here

FAMILIES = ("power_exponential", "matern32", "matern52")

# Kernel launches made by `pairwise_covariance` (plain-version calls do not
# count): lets a run show that its main path went through the kernel.
launches = 0


def _epilogue(d2: torch.Tensor, amp: torch.Tensor, family: str) -> torch.Tensor:
    a = amp[:, None, None]
    if family == "power_exponential":
        return a * torch.exp(-0.5 * d2)
    r = torch.sqrt(d2 + 1e-36)
    if family == "matern32":
        s = math.sqrt(3.0) * r
        return a * (1.0 + s) * torch.exp(-s)
    if family == "matern52":
        s = math.sqrt(5.0) * r
        return a * (1.0 + s + s * s / 3.0) * torch.exp(-s)
    raise ValueError(f"family {family!r} not supported by the pairwise kernel")


def pairwise_covariance_plain(
    U: torch.Tensor,
    V: torch.Tensor,
    amp: torch.Tensor,
    diag_add: torch.Tensor | None,
    family: str = "power_exponential",
    add_diag: bool = False,
) -> torch.Tensor:
    """Plain-PyTorch K1 on any device: U (B, n1, d), V (B, n2, d),
    amp (B,), diag_add (B,) -> (B, n1, n2)."""
    d2 = torch.zeros(
        (U.shape[0], U.shape[1], V.shape[1]), dtype=U.dtype, device=U.device
    )
    for k in range(U.shape[2]):  # same summation order as the kernel
        df = U[:, :, None, k] - V[:, None, :, k]
        d2 = d2 + df * df
    out = _epilogue(d2, amp, family)
    if add_diag:
        n = min(U.shape[1], V.shape[1])
        idx = torch.arange(n, device=U.device)
        out[:, idx, idx] = out[:, idx, idx] + diag_add[:, None]
    return out


def _check(U, V, amp, diag_add, family, add_diag=True):
    if family not in FAMILIES:
        raise ValueError(f"family {family!r} not supported by the pairwise kernel")
    if diag_add is None and add_diag:
        raise ValueError("pairwise_covariance: add_diag needs diag_add")
    dev = U.device
    f32 = torch.float32
    for name, t, ndim in (("U", U, 3), ("V", V, 3), ("amp", amp, 1),
                          ("diag_add", diag_add, 1)):
        if t is None or (t.dtype == f32 and t.dim() == ndim
                         and t.is_contiguous() and t.device == dev):
            continue  # the one test per tensor on the serve path's latency
        if t.device != dev:
            raise ValueError(f"pairwise_covariance: {name} on {t.device}, U on {dev}")
        if t.dtype != f32:
            raise TypeError(f"pairwise_covariance: {name} must be float32, got {t.dtype}")
        raise ValueError(
            f"pairwise_covariance: {name} must be a contiguous "
            f"{ndim}-D tensor, got shape {tuple(t.shape)}"
        )
    B = U.shape[0]
    if (V.shape[0] != B or V.shape[2] != U.shape[2] or amp.shape[0] != B
            or (diag_add is not None and diag_add.shape[0] != B)):
        raise ValueError(
            "pairwise_covariance: shapes U (B, n1, d), V (B, n2, d), amp (B,), "
            f"diag_add (B,) expected; got {tuple(U.shape)}, {tuple(V.shape)}, "
            f"{tuple(amp.shape)}, "
            f"{None if diag_add is None else tuple(diag_add.shape)}"
        )
    if min(U.shape) == 0 or V.shape[1] == 0:
        raise ValueError("pairwise_covariance: empty operand")


_entry = None  # the C entry point, looked up at the first launch


def pairwise_covariance(
    U: torch.Tensor,
    V: torch.Tensor,
    amp: torch.Tensor,
    diag_add: torch.Tensor | None,
    family: str = "power_exponential",
    add_diag: bool = False,
) -> torch.Tensor:
    """K1 on U (B, n1, d), V (B, n2, d), amp (B,), diag_add (B,) or None
    when not add_diag, all float32 and contiguous: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Returns (B, n1, n2)."""
    global _entry, launches
    if U.device.type == "cpu":
        return pairwise_covariance_plain(U, V, amp, diag_add, family, add_diag)
    if U.device.type != "cuda":
        raise ValueError(f"pairwise_covariance: unsupported device {U.device}")
    _check(U, V, amp, diag_add, family, add_diag)
    if _entry is None:
        _entry = build.load().madai_pairwise_covariance
    B, n1, d = U.shape
    n2 = V.shape[1]
    out = torch.empty((B, n1, n2), dtype=torch.float32, device=U.device)
    args = (U.data_ptr(), V.data_ptr(), amp.data_ptr(),
            None if diag_add is None else diag_add.data_ptr(), out.data_ptr(),
            B, n1, n2, d, FAMILIES.index(family), int(add_diag))
    # the raw handle of the current stream: building a torch.cuda.Stream
    # costs ~10 us a call on the card's host (tools/time_pairwise.py)
    index = U.device.index
    if index == torch.cuda.current_device():
        err = _entry(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = _entry(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        build.check(build.load(), err, "pairwise_covariance")
    launches += 1
    return out
