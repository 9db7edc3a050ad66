"""The yardstick's arithmetic: the card's published peaks, the least time a
piece of work can take there, and the operations and bytes that each
kernel's and each whole step's work needs.

Every count here is taken from the shapes of the work alone: inputs read
once, outputs written once, the operations the mathematics needs. None of
it depends on how the program implements the work, so a program that
replaces a kernel leaves these counts, and the whole step's share of the
peak, standing.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and FP32 outside the tensor
# cores (the port keeps TF32 off).
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12
F32 = 4  # bytes


def bound_ms(nbytes: float, flops: float) -> tuple:
    """Least time the card could take: the larger of bytes over the memory
    rate and FP32 operations over the FP32 peak. Returns (ms, "bytes" |
    "operations")."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1(batch: int, n1: int, n2: int, d: int, gram: bool) -> tuple:
    """(bytes, flops) of K1: the (batch, n1, n2) covariances of scaled
    points in d dimensions. A Gram (n2 == n1) reads one point set and
    computes each pair of its lower triangle once; a cross block reads
    both. Amplitude and diagonal term: 2 numbers a matrix."""
    reads = batch * n1 * d + (0 if gram else batch * n2 * d) + 2 * batch
    pairs = batch * n1 * (n1 + 1) // 2 if gram else batch * n1 * n2
    return F32 * (reads + batch * n1 * n2), pairs * (3 * d + 3)


def k2(batch: int, n: int) -> tuple:
    """(bytes, flops) of K2: batch Cholesky factors of n x n: the lower
    triangle read, the whole factor written, n^3/3 operations each."""
    return (F32 * (batch * n * (n + 1) / 2 + batch * n * n),
            batch * n ** 3 / 3)


def k3(batch: int, b: int) -> tuple:
    """(bytes, flops) of K3: batch b x b diagonal panels, each factored and
    inverted: the lower triangle in, L and L^-1 out, b^3/3 operations for
    each of the two stages."""
    return (F32 * (batch * b * (b + 1) / 2 + 2 * batch * b * b),
            2 * batch * b ** 3 / 3)


def trsm(n: int, m: int) -> tuple:
    """(bytes, flops) of one lower-triangular solve L^-1 B, L n x n and B
    n x m: the triangle and B read, the solution written; n^2 m
    operations."""
    return F32 * (n * (n + 1) / 2 + 2 * n * m), float(n) * n * m


def lml_value_flops(n: int, d: int, p: int) -> float:
    """Operations of one lane's GLS log-likelihood value at n points in d
    dimensions with p regression columns: the Gram's lower triangle, the
    factor (n^3/3), and the solves against H and y."""
    return (n * (n + 1) / 2 * (3 * d + 3) + n ** 3 / 3
            + float(n) * n * (p + 1))


def lml_vg_flops(n: int, d: int, p: int) -> float:
    """Operations of one lane's value and gradient: the value, then L^-1
    (n^3/3), the symmetric product L^-T L^-1 (n^3/3), the cotangent
    (2 n^2) and its contraction with the Gram's derivatives (n^2 (3d+3)):
    n^3 and its O(n^2 d) terms in all."""
    return (lml_value_flops(n, d, p) + 2 * n ** 3 / 3 + 2.0 * n * n
            + float(n) * n * (3 * d + 3))


def serve_point_flops(n: int, d: int, p: int) -> float:
    """Operations of one query point's posterior mean and variance against
    n training points: its cross covariances (n (3d+3)), the triangular
    solve (n^2), the mean and variance sums (4n), the GLS correction
    (2np + p^2) and its mean term (2p)."""
    return (float(n) * n + n * (3 * d + 3) + 4.0 * n + 2.0 * n * p
            + p * p + 2 * p)


def share_pct(work_ms: float, device_s: float):
    """A share of the roofline in %: the least time of the work over the
    device time it took; None where the trace holds no such time."""
    if device_s <= 0:
        return None
    return 100.0 * work_ms / (device_s * 1e3)
