#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`madaiemulator_tpu_torch`) on one GPU.

Run from the repository root, on a machine with an NVIDIA H100 (sm_90a) and
nvcc:

    python3 chip_smoke.py [--seed 0]

It imports no jax. Phases, in order; any failure exits non-zero:

  1. device  — require CUDA; print the nvidia-smi name / power-limit line;
               assert the full-FP32 matmul flags (TF32 off).
  2. build   — compile the Hopper kernels from csrc/ (nvcc, first use).
  3. kernels — K1 (pairwise covariance), K2 (batched Cholesky) and K3
               (panel factor + inverse, b in {128, 512, 1024}) on the card
               against their plain-PyTorch versions, K2 and K3 also against
               a float64 factor, K3's |Linv L - I|; NaN on a non-SPD input;
               kernel, plain and library times and each kernel's bound.
  4. goldens — serve tests/golden/*/state.txt on the card: float64 (library
               path) against expected.txt at rtol 1e-6; float32 (kernel
               path) against the float32 plain-kernel path on the CPU.
  5. slice   — a synthetic snapshot at the width of the flagship multivariate
               emulator (N=512, d=6, t=15, r=4 after PCA), served in-process
               on the kernels (launch counters reset before, read after)
               against float64, then through `interactive_mode` as a
               subprocess; precompute and predict times.
  6. config4 — BASELINE config 4 at full width (N=16,384, d=8, power-
               exponential alpha=2, regression_order=1; data as
               bench/bench_large_n.py draws it): left_cholesky on both
               panel routes at blocks 512 / 1024 (residual gate on the
               bench's SPD matrix, float64 comparison on the Gram), TF32
               controls that the float32 gates must reject, the float32
               LML on each Gram x factorization route (not gated); then the
               main path through the entry points: the LML value and
               closed-form gradient, a 3-step 2-restart fit_gp_host, and
               serving 8,192 queries, each against float64; times, the
               value+grad memory peak and profiles after it.

The launch counters are set to 0 just before each main path (phase 5's
serve, phase 6's value+grad -> fit -> serve) and read just after it. Phase 5
fails if a kernel of its path never launched; phase 6 requires K3 to launch
exactly once per diagonal panel of every factorization the path makes, and
K1 once per Gram and per query chunk. Before the last line it prints one
JSON line with each kernel's launches (`launches_by_path`: each path's own
count; `launches`: config 4's where that path runs the kernel, else the
serve path's), its error against the plain version, its time, the plain
version's, the library call's (null where no single PyTorch call computes
the function) and its bound; the last line is {"ok": true, "device": ...}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# K1 against its plain version: the distance uses the same fp32 operations in
# the same order, so only expf may differ, by a few ulp of values <= ~1.3.
K1_ATOL = 2e-6
# K2 against the plain version and a float64 factor, relative to max |L|:
# float32 factorizations of Grams with condition number <= ~1e4.
K2_RTOL = 1e-4
# Goldens at float32, kernel path on the card vs plain path on the CPU: two
# float32 evaluations of a nugget ~1e-9 emulator differ by ~1e-4 of the mean
# scale (measured on the CPU between the two float32 paths); variances are
# compared at the scale of the prior variance they cancel against.
GOLDEN_F32_TOL = 1e-3
# Slice: float32 kernel path vs float64 library path (the CPU plain path
# differs from float64 by ~1e-4 of the mean scale and of the prior variance).
SLICE_F32_TOL = 1e-3
# Server answers vs the in-process float32 answers: the states are built by
# the same deterministic kernels; only the batch split of the solves differs.
SERVER_TOL = 1e-5
# K3: |Linv L - I| of a float32 panel inverse, the JAX package's bound
# (tests/test_pallas.py:116).
K3_INV_TOL = 1e-4
# Config 4 (bench/bench_large_n.py): N training points in d, M queries.
C4_N, C4_D, C4_M = 16384, 8, 8192
# The JAX bench's factor gate (bench.py:110-122): max|LL^T - M| / max|M|.
C4_RESIDUAL = 1e-5
# Config 4 at theta (amp 1, nugget 1e-2, length scales 0.5; cond ~1e5):
# float32 factor of the Gram vs the float64 factor of the same matrix,
# relative to max|L|. Conditioning-limited: measured 1.0e-4 to 1.16e-4 on
# the H100 on both panel routes alike (K3 and the library's), so the gate
# is 5x that; the TF32 control below must exceed it.
C4_GRAM_FACTOR_RTOL = 5e-4
# LML float32 (kernels) vs float64 (library) at theta: value relative to
# |ll64|, gradient relative to max|g64|. The float32 Gram's rounding
# (~eps per entry) moves logdet and the quadratic form of a cond ~1e5
# matrix by ~1e-4 of the value: measured 9.9e-5 for the value, 3.6e-4 for
# the gradient on the H100; each Gram x factorization route is printed
# beside, and the TF32 control must exceed the value gate.
C4_LML_RTOL = 5e-4
C4_GRAD_RTOL = 1e-2
# Serving at theta, float32 vs float64: mean scale and prior variance.
C4_SERVE_TOL = 1e-3
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 rate and FP32 outside the
# tensor cores (the kernels run full FP32 FFMA; TF32 is off).
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def host_ms(fn, iters: int = 5) -> float:
    """Mean wall time of fn() in ms, each call ended by a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


@contextlib.contextmanager
def _tf32():
    """TF32 on for float32 matmuls inside the block: the control run that
    shows a float32 gate rejects a lower precision."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    require(torch.backends.cuda.matmul.allow_tf32 is False, "matmul TF32 on")
    require(torch.backends.cudnn.allow_tf32 is False, "cuDNN TF32 on")
    require(torch.get_float32_matmul_precision() == "highest",
            "float32 matmul precision is not 'highest'")
    return smi


def phase_build() -> None:
    from madaiemulator_tpu_torch.ops.hopper import build

    t0 = time.perf_counter()
    build.load()
    took = time.perf_counter() - t0
    how = ("nvcc %.1f s" % build.build_seconds
           if build.build_seconds is not None else "already built")
    print(f"build: {build.library_path().name} in {took:.2f} s ({how})")


def _points(rng, b, n, d, ls, dev):
    """(b, n, d) uniform points divided by per-dimension length scales."""
    x = rng.uniform(size=(b, n, d)) / np.asarray(ls)
    return torch.tensor(x, dtype=torch.float32, device=dev)


def bound_ms(nbytes: float, flops: float) -> tuple:
    """Least time the card could take: the larger of bytes over the memory
    rate and FP32 operations over the FP32 peak (no tensor cores: TF32 is
    off). Returns (ms, "bytes" | "operations")."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_kernels(dev, rng) -> list:
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
    from madaiemulator_tpu_torch.ops.hopper import panel as k3

    B, n, m, d = 4, 512, 1024, 6
    amp = torch.tensor([1.0, 0.5, 1.3, 2.0], device=dev)
    nug = torch.tensor([1e-3, 1e-2, 0.1, 0.25], device=dev)
    iso = [0.3] * d
    ard = [0.2, 0.3, 0.4, 0.5, 0.6, 0.7]
    k1_err = 0.0
    cases = []
    for fam in k1.FAMILIES:
        cases.append((fam, n, n, d, iso))
        cases.append((fam, n, m, d, iso))
        cases.append((fam, 500, 37, d, iso))
    cases += [("matern32", n, n, d, ard), ("matern52", n, m, d, ard)]
    for fam, n1, n2, dd, ls in cases:
        U = _points(rng, B, n1, dd, ls, dev)
        V = U if n1 == n2 else _points(rng, B, n2, dd, ls, dev)
        gram = n1 == n2
        got = k1.pairwise_covariance(U, V, amp, nug, fam, gram)
        want = k1.pairwise_covariance_plain(U, V, amp, nug, fam, gram)
        torch.cuda.synchronize()
        require(got.shape == (B, n1, n2), f"K1 shape {tuple(got.shape)}")
        err = (got - want).abs().max().item()
        require(err <= K1_ATOL, f"K1 {fam} ({n1},{n2}) err {err:.3g}")
        if gram:
            require(torch.equal(got, got.mT), f"K1 {fam} Gram not symmetric")
        k1_err = max(k1_err, err)
    print(f"K1 pairwise: {len(cases)} cases (3 families + ARD Matérn; Gram "
          f"{n}x{n}, cross {n}x{m}, ragged 500x37; batch {B}) max_abs_err "
          f"{k1_err:.3g} <= {K1_ATOL}; Grams bitwise symmetric")

    Uq = _points(rng, B, n, d, iso, dev)
    Vq = _points(rng, B, m, d, iso, dev)
    zero = torch.zeros(B, device=dev)
    k1_times = {
        "gram": (
            cuda_ms(lambda: k1.pairwise_covariance(
                Uq, Uq, amp, nug, "power_exponential", True)),
            cuda_ms(lambda: k1.pairwise_covariance_plain(
                Uq, Uq, amp, nug, "power_exponential", True)),
        ),
        "cross": (
            cuda_ms(lambda: k1.pairwise_covariance(
                Uq, Vq, amp, zero, "power_exponential")),
            cuda_ms(lambda: k1.pairwise_covariance_plain(
                Uq, Vq, amp, zero, "power_exponential")),
        ),
    }
    k1_bounds = {
        "gram": bound_ms(4 * (B * n * d + 2 * B + B * n * n),
                         B * n * n * (3 * d + 3)),
        "cross": bound_ms(4 * (B * n * d + B * m * d + 2 * B + B * n * m),
                          B * n * m * (3 * d + 3)),
    }
    for what, (t_k, t_p) in k1_times.items():
        shape = f"({B},{n},{n})" if what == "gram" else f"({B},{n},{m})"
        print(f"K1 time {what} {shape}: kernel {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms, bound {k1_bounds[what][0]:.5f} ms "
              f"({k1_bounds[what][1]})")

    k2_err = 0.0
    for nn in (64, 128, 500, 512, 1024):
        U = _points(rng, B, nn, d, iso, dev)
        A = k1.pairwise_covariance_plain(
            U, U, torch.ones(B, device=dev), torch.full((B,), 0.1, device=dev),
            "power_exponential", True,
        )
        L = k2.cholesky(A)
        Lp = k2.cholesky_plain(A)
        L64 = torch.linalg.cholesky(A.double())
        torch.cuda.synchronize()
        scale = L64.abs().max().item()
        require(torch.equal(L, torch.tril(L)), f"K2 n={nn} not lower")
        e64 = (L.double() - L64).abs().max().item()
        ep = (L - Lp).abs().max().item()
        require(e64 <= K2_RTOL * scale, f"K2 n={nn} vs f64 {e64:.3g}")
        require(ep <= K2_RTOL * scale, f"K2 n={nn} vs plain {ep:.3g}")
        k2_err = max(k2_err, ep)
        print(f"K2 cholesky n={nn} batch {B}: max_abs_err vs plain {ep:.3g}, "
              f"vs float64 {e64:.3g} (max|L| {scale:.3g}, tol "
              f"{K2_RTOL} x max|L|)")
    bad = A.clone()
    bad[1] -= 5.0 * torch.eye(A.shape[-1], device=dev)
    Lbad = k2.cholesky(bad)
    torch.cuda.synchronize()
    finite = torch.isfinite(Lbad).flatten(1).all(1).tolist()
    require(finite == [True, False, True, True], f"K2 non-SPD finite {finite}")
    require(bool(torch.isnan(Lbad[1]).any()), "K2 non-SPD gave no NaN")
    print("K2 non-SPD input: NaN in the failed member only")

    A512 = k1.pairwise_covariance_plain(
        Uq, Uq, torch.ones(B, device=dev), torch.full((B,), 1e-3, device=dev),
        "power_exponential", True,
    )
    t2 = cuda_ms(lambda: k2.cholesky(A512))
    t2p = cuda_ms(lambda: k2.cholesky_plain(A512), iters=5)
    t2lib = cuda_ms(lambda: torch.linalg.cholesky_ex(A512))
    k2_bound = bound_ms(4 * (B * n * (n + 1) / 2 + B * n * n), B * n ** 3 / 3)
    print(f"K2 time ({B},{n},{n}): kernel {t2:.4f} ms, plain {t2p:.4f} ms, "
          f"torch.linalg.cholesky_ex {t2lib:.4f} ms, bound "
          f"{k2_bound[0]:.5f} ms ({k2_bound[1]})")

    k3_err = 0.0
    Bp = 2
    for b in (128, 512, 1024):
        U = _points(rng, Bp, b, d, iso, dev)
        A = k1.pairwise_covariance_plain(
            U, U, torch.ones(Bp, device=dev),
            torch.full((Bp,), 0.1, device=dev), "power_exponential", True,
        )
        L, Linv = k3.panel_factor(A)
        Lp, Linvp = k3.panel_factor_plain(A)
        L64 = torch.linalg.cholesky(A.double())
        torch.cuda.synchronize()
        scale = L64.abs().max().item()
        require(torch.equal(L, torch.tril(L))
                and torch.equal(Linv, torch.tril(Linv)),
                f"K3 b={b}: nonzero above the diagonal")
        e64 = (L.double() - L64).abs().max().item()
        ep = (L - Lp).abs().max().item()
        eye = torch.eye(b, dtype=torch.float64, device=dev)
        einv = (Linv.double() @ L.double() - eye).abs().max().item()
        require(e64 <= K2_RTOL * scale, f"K3 b={b} L vs f64 {e64:.3g}")
        require(ep <= K2_RTOL * scale, f"K3 b={b} L vs plain {ep:.3g}")
        require(einv <= K3_INV_TOL, f"K3 b={b} |Linv L - I| {einv:.3g}")
        k3_err = max(k3_err, ep)
        print(f"K3 panel_factor b={b} batch {Bp}: L max_abs_err vs plain "
              f"{ep:.3g}, vs float64 {e64:.3g} (max|L| {scale:.3g}, tol "
              f"{K2_RTOL} x max|L|); max|Linv L - I| {einv:.3g} <= "
              f"{K3_INV_TOL}; Linv vs plain "
              f"{(Linv - Linvp).abs().max().item():.3g}")
    bad = A.clone()
    bad[1] -= 5.0 * torch.eye(A.shape[-1], device=dev)
    Lbad, Linvbad = k3.panel_factor(bad)
    torch.cuda.synchronize()
    for what, out in (("L", Lbad), ("Linv", Linvbad)):
        finite = torch.isfinite(out).flatten(1).all(1).tolist()
        require(finite == [True, False], f"K3 non-SPD {what} finite {finite}")
        require(bool(torch.isnan(out[1]).any()), f"K3 non-SPD {what} no NaN")
    print("K3 non-SPD input: NaN in the failed member's L and Linv only")

    k3_times, k3_bounds = {}, {}
    for bb, b in ((2, 512), (1, 512), (1, 1024)):
        U = _points(rng, bb, b, d, iso, dev)
        A = k1.pairwise_covariance_plain(
            U, U, torch.ones(bb, device=dev),
            torch.full((bb,), 1e-3, device=dev), "power_exponential", True,
        )
        eye = torch.eye(b, device=dev).expand(bb, b, b)

        def library_pair(A=A, eye=eye):
            L, _ = torch.linalg.cholesky_ex(A)
            return torch.linalg.solve_triangular(L, eye, upper=False)

        k3_times[(bb, b)] = (
            cuda_ms(lambda: k3.panel_factor(A)),
            cuda_ms(lambda: k3.panel_factor_plain(A), iters=2, warmup=1),
            cuda_ms(library_pair),
        )
        t3, t3p, t3lib = k3_times[(bb, b)]
        # the lower triangle of A in, L and L^-1 out; b^3/3 flops each stage
        t3b = k3_bounds[(bb, b)] = bound_ms(
            4 * (bb * b * (b + 1) / 2 + 2 * bb * b * b), 2 * bb * b ** 3 / 3)
        print(f"K3 time ({bb},{b},{b}): kernel {t3:.4f} ms, plain "
              f"{t3p:.4f} ms, library pair cholesky_ex + "
              f"solve_triangular(L, I) {t3lib:.4f} ms, bound {t3b[0]:.5f} "
              f"ms ({t3b[1]})")

    # bounds at the timed shapes: K1 cross, K2 and K3 (2, 512, 512)
    k1_bound = k1_bounds["cross"]
    b3 = 512
    k3_bound = k3_bounds[(Bp, b3)]
    return [
        {"name": "pairwise_covariance", "route": "cuda",
         "source": "madaiemulator_tpu_torch/csrc/pairwise.cu",
         "replaces": "madaiemulator_tpu/ops/pallas/pairwise.py:90",
         "max_abs_err": k1_err, "ms": k1_times["cross"][0],
         "plain_ms": k1_times["cross"][1], "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": None},
        {"name": "cholesky", "route": "cuda",
         "source": "madaiemulator_tpu_torch/csrc/cholesky.cu",
         "replaces": "madaiemulator_tpu/ops/pallas/cholesky.py:210",
         "max_abs_err": k2_err, "ms": t2, "plain_ms": t2p,
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "library_ms": t2lib},
        {"name": "panel_factor", "route": "cuda",
         "source": "madaiemulator_tpu_torch/csrc/panel_factor.cu",
         "replaces": "madaiemulator_tpu/ops/pallas/cholesky.py:179",
         "max_abs_err": k3_err, "ms": k3_times[(Bp, b3)][0],
         "plain_ms": k3_times[(Bp, b3)][1], "bound_ms": k3_bound[0],
         "bound_by": k3_bound[1], "library_ms": None},
    ]


def _prior_var(emu) -> float:
    """Largest observable prior variance: the scale a predictive variance
    cancels against."""
    from madaiemulator_tpu_torch.models.multivariate import (
        reconstruct_observables,
    )

    p = emu.params
    kss = (torch.exp(p.log_amp) + torch.exp(p.log_nugget))[:, None]
    _, v = reconstruct_observables(torch.zeros_like(kss), kss, emu.pca)
    return v.max().item()


def phase_goldens(dev) -> None:
    from madaiemulator_tpu_torch.io.snapshot import read_snapshot
    from madaiemulator_tpu_torch.models.multivariate import predict_multivariate

    cases = sorted(p for p in (ROOT / "tests" / "golden").iterdir()
                   if p.is_dir())
    require(len(cases) > 0, "no golden fixtures")
    for case in cases:
        q = np.loadtxt(case / "queries.txt", ndmin=2)
        e = np.loadtxt(case / "expected.txt", ndmin=2)
        emu, _, _ = read_snapshot(str(case / "state.txt"), device=dev,
                                  dtype=torch.float64)
        t = emu.n_outputs
        mean, var = (x.cpu().numpy() for x in predict_multivariate(emu, q))
        scale = max(1.0, float(np.abs(e[:, :t]).max()))
        np.testing.assert_allclose(mean, e[:, :t], rtol=1e-6, atol=1e-6 * scale)
        np.testing.assert_allclose(var, e[:, t:], rtol=1e-6, atol=1e-12)
        emu32, _, _ = read_snapshot(str(case / "state.txt"), device=dev,
                                    dtype=torch.float32)
        cpu32, _, _ = read_snapshot(str(case / "state.txt"), device="cpu",
                                    dtype=torch.float32)
        m32, v32 = (x.cpu().double().numpy()
                    for x in predict_multivariate(emu32, q))
        mc, vc = (x.double().numpy() for x in predict_multivariate(cpu32, q))
        pv = _prior_var(cpu32)
        dm = np.abs(m32 - mc).max() / scale
        dv = np.abs(v32 - vc).max() / pv
        require(dm <= GOLDEN_F32_TOL and dv <= GOLDEN_F32_TOL,
                f"golden {case.name} float32 card vs CPU: mean {dm:.3g}, "
                f"var {dv:.3g}")
        print(f"golden {case.name}: float64 matches expected at rtol 1e-6; "
              f"float32 card vs CPU plain: mean {dm:.3g} x scale, var "
              f"{dv:.3g} x prior var; float32 vs expected (not gated): mean "
              f"{np.abs(m32 - e[:, :t]).max() / scale:.3g} x scale")


def _latin_hypercube(rng, n, d):
    perms = np.stack([rng.permutation(n) for _ in range(d)], axis=1)
    return (perms + rng.uniform(size=(n, d))) / n


def _slice_snapshot(path: str, rng) -> tuple:
    """Write a synthetic snapshot at the flagship multivariate width with the
    port's own code: N=512 Latin-hypercube points in d=6, t=15 observables
    mixed from 4 smooth latent functions, PCA at 0.99, fixed thetas
    (power-exponential, amp 1, nugget 1e-3, length scales 0.3,
    regression_order=1). Returns (natural-unit queries (1024, d), names)."""
    from madaiemulator_tpu_torch.io.snapshot import write_snapshot
    from madaiemulator_tpu_torch.models.multivariate import (
        emulator_from_numpy,
        pca_decompose,
    )
    from madaiemulator_tpu_torch.utils.config import GPConfig

    N, d, t = 512, 6, 15
    x = _latin_hypercube(rng, N, d)
    lo = rng.uniform(-1.0, 0.0, d)
    span = rng.uniform(0.5, 2.0, d)
    latent = np.stack([
        np.sin(2 * np.pi * x[:, 0] + x[:, 1]),
        np.exp(-2.0 * ((x[:, :3] - 0.5) ** 2).sum(1)),
        x[:, 3] * x[:, 4] + 0.5 * x[:, 5] ** 2,
        np.cos(3.0 * x[:, 2]) * x[:, 1],
    ], axis=1)
    Y = latent @ rng.standard_normal((4, t)) + 1e-3 * rng.standard_normal((N, t))
    pca, Z = pca_decompose(Y, 0.99)
    r = Z.shape[1]
    arrays = dict(
        mins=lo, ranges=span, X=x, Z=Z, ymean=pca.ymean, ystd=pca.ystd,
        eigenvalues=pca.eigenvalues, U=pca.U, log_amp=np.zeros(r),
        log_nugget=np.full(r, np.log(1e-3)),
        log_ls=np.full((r, d), np.log(0.3)),
    )
    emu = emulator_from_numpy(arrays, GPConfig(nparams=d, regression_order=1),
                              device="cpu", dtype=torch.float64)
    pnames = [f"p{i}" for i in range(d)]
    onames = [f"obs{j}" for j in range(t)]
    write_snapshot(path, emu, pnames, onames)
    queries = lo + span * rng.uniform(size=(1024, d))
    return queries, pnames, onames, r


def _serve_over_pipe(path, batches, d, t, header):
    """Drive `interactive_mode` on the card with one request batch at a
    time; returns the answers, (sum of batch sizes, 2t)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "madaiemulator_tpu_torch.cli",
         "interactive_mode", path, "--device", "cuda", "--dtype", "float32"],
        cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
    )
    try:
        got_header = [proc.stdout.readline() for _ in range(len(header))]
        if got_header != header:
            proc.kill()
            raise RuntimeError(f"chip_smoke: server header {got_header[:4]}"
                               f"...; stderr: {proc.stderr.read()}")
        answers = []
        for pts in batches:
            req = "".join(" ".join(f"{v:.17g}" for v in p) + "\n" for p in pts)
            # write from a thread: a large batch can fill both pipes at once
            w = threading.Thread(target=lambda s=req: (proc.stdin.write(s),
                                                       proc.stdin.flush()))
            w.start()
            vals = [float(proc.stdout.readline())
                    for _ in range(2 * t * len(pts))]
            w.join()
            answers.append(np.asarray(vals).reshape(len(pts), 2 * t))
        proc.stdin.close()
        rc = proc.wait(timeout=120)
        err = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    require(rc == 0, f"server exit {rc}: {err}")
    require(proc.stdout.read() == "", "server wrote past its answers")
    return np.concatenate(answers, axis=0)


def phase_slice(dev, rng, smi) -> dict:
    from madaiemulator_tpu_torch.io.snapshot import read_snapshot
    from madaiemulator_tpu_torch.models.multivariate import (
        _vmapped_states,
        predict_multivariate,
    )
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1

    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "state.txt")
        queries, pnames, onames, r = _slice_snapshot(path, rng)
        d, t = len(pnames), len(onames)
        print(f"slice: N=512 d={d} t={t} -> r={r} components (PCA 0.99)")

        # the main path, in-process: load (serve states) + predict 1024 points
        k1.launches = 0
        k2.launches = 0
        emu, _, _ = read_snapshot(path, device=dev, dtype=torch.float32)
        mean, var = predict_multivariate(emu, queries)
        torch.cuda.synchronize()
        launches = {"pairwise_covariance": k1.launches, "cholesky": k2.launches}
        require(all(v > 0 for v in launches.values()),
                f"main path skipped a kernel: {launches}")
        require(bool(emu.states.ok.all()), "slice serve state not SPD")
        require(mean.shape == (1024, t) and var.shape == (1024, t),
                "slice output shape")
        require(bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
                "slice output not finite")
        emu64, _, _ = read_snapshot(path, device=dev, dtype=torch.float64)
        m64, v64 = predict_multivariate(emu64, queries)
        scale = max(1.0, m64.abs().max().item())
        pv = _prior_var(emu64)
        dm = (mean.double() - m64).abs().max().item() / scale
        dv = (var.double() - v64).abs().max().item() / pv
        require(dm <= SLICE_F32_TOL and dv <= SLICE_F32_TOL,
                f"slice float32 vs float64: mean {dm:.3g}, var {dv:.3g}")
        print(f"slice in-process float32 (kernels: {launches}) vs float64: "
              f"mean {dm:.3g} x scale, var {dv:.3g} x prior var (tol "
              f"{SLICE_F32_TOL})")

        # served over the pipe, batch by batch
        batches = [queries[:1], queries[1:8], queries[8:72], queries]
        sizes = tuple(len(b) for b in batches)
        header = ([f"{d}\n"] + [f"{s}\n" for s in pnames] + [f"{2 * t}\n"]
                  + [f"mean_{s}\n" for s in onames]
                  + [f"variance_{s}\n" for s in onames])
        served = _serve_over_pipe(path, batches, d, t, header)
        ref = [predict_multivariate(emu, b) for b in batches]
        ref = np.concatenate(
            [torch.cat(mv, dim=1).cpu().double().numpy() for mv in ref])
        sm = np.abs(served[:, :t] - ref[:, :t]).max() / scale
        sv = np.abs(served[:, t:] - ref[:, t:]).max() / pv
        require(sm <= SERVER_TOL and sv <= SERVER_TOL,
                f"server vs in-process: mean {sm:.3g}, var {sv:.3g}")
        print(f"slice served over interactive_mode (batches {sizes}): header "
              f"ok; vs in-process float32 mean {sm:.3g} x scale, var "
              f"{sv:.3g} x prior var (tol {SERVER_TOL})")

        # times at the slice width, kernel path and library path
        times = {}
        for label, cfg in (
            ("kernels", emu.config),
            ("library", dataclasses.replace(emu.config, gram_method="xla",
                                            cholesky_method="xla")),
        ):
            e = emu._replace(config=cfg)
            times[label] = (
                host_ms(lambda: _vmapped_states(e.params, e.X, e.Z, cfg)),
                host_ms(lambda: predict_multivariate(e, queries)),
            )
            print(f"slice times ({label}, float32, {smi}): serve-state "
                  f"precompute (Gram + Cholesky + GLS, r={r}) "
                  f"{times[label][0]:.3f} ms; predict 1024 queries "
                  f"{times[label][1]:.3f} ms")
    return launches


def profile_once(what: str, fn, wall_ms: float, smi: str,
                 top: int = 8) -> None:
    """Run fn() once under torch.profiler; print the device time of its
    kernels, their count, the busy share (device time over `wall_ms`, the
    call's wall time measured without the profiler) and the kernels that
    take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    total = sum(dev_us(e) for e in kern)
    n = sum(e.count for e in kern)
    rows = sorted(kern, key=dev_us, reverse=True)[:top]
    print(f"config4 profile {what}: kernels {total / 1e3:.3f} ms device in "
          f"{n} launches, busy {total / 1e3 / wall_ms:.2f} of {wall_ms:.3f} "
          f"ms wall ({smi}); top: " + "; ".join(
              f"{e.key[:48]} {dev_us(e) / 1e3:.3f} ms x{e.count}"
              for e in rows))


def _c4_data(seed: int, dev):
    """BASELINE config 4 as bench/bench_large_n.py:38-43 draws it: X uniform
    in [0, 1]^8 (N = 16,384), y = sin(3 x0) + x1^2, then 8,192 uniform
    queries, all float32, from numpy with `seed`."""
    from madaiemulator_tpu_torch.models.gp import GPData

    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(C4_N, C4_D)).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) + X[:, 1] ** 2).astype(np.float32)
    Xs = rng.uniform(size=(C4_M, C4_D)).astype(np.float32)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    return GPData(X=t(X), y=t(y)), t(Xs)


def phase_config4(dev, seed: int, smi: str) -> dict:
    """BASELINE config 4 (N=16,384, d=8, power-exponential alpha = 2,
    regression_order=1) through the port's entry points on the kernels:
    factor, LML value + gradient, fit_gp_host, serve. Every check is made
    and printed; the phase fails at its end if any did not pass."""
    from madaiemulator_tpu_torch.models import fit, gp
    from madaiemulator_tpu_torch.ops import kernels, linalg
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
    from madaiemulator_tpu_torch.ops.hopper import panel as k3
    from madaiemulator_tpu_torch.utils.config import GPConfig

    failed = []

    def check(ok: bool, what: str) -> None:
        print(f"config4 check {'ok' if ok else 'FAILED'}: {what}")
        if not ok:
            failed.append(what)

    data, Xs = _c4_data(seed, dev)
    cfg = GPConfig(nparams=C4_D, regression_order=1, cholesky_block=512,
                   predict_query_chunk=1024)
    # the float64 reference evaluates the same function: the float32 jitter
    # floor is set explicitly on both sides
    jit32 = kernels.effective_jitter_frac(C4_N, torch.float32, cfg)
    cfg = dataclasses.replace(cfg, jitter=jit32)
    theta = kernels.GPParams(
        log_amp=torch.zeros((), device=dev),
        log_nugget=torch.log(torch.tensor(1e-2, device=dev)),
        log_ls=torch.log(torch.full((C4_D,), 0.5, device=dev)),
    )
    theta64 = kernels.GPParams(*(a.double() for a in theta))
    data64 = gp.GPData(X=data.X.double(), y=data.y.double())
    print(f"config4: N={C4_N} d={C4_D} power-exponential alpha=2, "
          f"regression_order=1, cholesky_block=512, predict_query_chunk=1024,"
          f" jitter {jit32:.3g} x amp on both dtypes ({smi})")

    # 1. the large-N factorization, both panel routes, two block sizes
    gen = torch.Generator(device=dev).manual_seed(seed)
    A = torch.randn(C4_N, C4_N, generator=gen, device=dev) / C4_N ** 0.5
    M = 4.0 * torch.eye(C4_N, device=dev) + A @ A.mT
    del A
    mmax = M.abs().max().item()
    C = kernels.gram_matrix(data.X, theta, cfg)
    t_gram = cuda_ms(lambda: kernels.gram_matrix(data.X, theta, cfg), iters=5)
    L64 = torch.linalg.cholesky(C.double())
    l64max = L64.abs().max().item()
    times = {"gram": t_gram}
    for block in (512, 1024):
        for diag in ("pallas", "xla"):
            L = linalg.left_cholesky(M, block=block, diag=diag)
            r = (M - L @ L.mT).abs().max().item() / mmax
            check(r < C4_RESIDUAL,
                  f"SPD 4I+AA^T/N block {block} diag={diag}: residual "
                  f"max|LL^T-M|/max|M| {r:.3g} < {C4_RESIDUAL}")
            del L
            L = linalg.left_cholesky(C, block=block, diag=diag)
            e = (L.double() - L64).abs().max().item() / l64max
            check(e <= C4_GRAM_FACTOR_RTOL,
                  f"Gram block {block} diag={diag}: factor vs float64 "
                  f"{e:.3g} x max|L| <= {C4_GRAM_FACTOR_RTOL}")
            del L
            times[f"factor_{diag}_{block}"] = host_ms(
                lambda b=block, g=diag: linalg.left_cholesky(
                    M, block=b, diag=g), iters=2)
    del M
    # control: the same factor with TF32 on for the GEMMs must fail the
    # gate, or the gate could not tell full FP32 from a lower precision
    with _tf32():
        for diag in ("pallas", "xla"):
            L = linalg.left_cholesky(C, block=512, diag=diag)
            e = (L.double() - L64).abs().max().item() / l64max
            # NaN (the factorization failed) is a rejection too
            check(not e <= C4_GRAM_FACTOR_RTOL,
                  f"TF32 control, Gram block 512 diag={diag}: factor vs "
                  f"float64 {e:.3g} x max|L|, not <= {C4_GRAM_FACTOR_RTOL} "
                  f"(the gate rejects TF32)")
            del L
    del C, L64

    # where the float32 LML's distance from float64 comes from (not gated):
    # each float32 Gram against the float64 Gram, and the LML value on each
    # Gram x factorization route
    C64 = kernels.gram_matrix(data64.X, theta64, cfg)
    c64max = C64.abs().max().item()
    with torch.no_grad():
        ll64 = gp.log_marginal_likelihood(theta64, data64, cfg).item()
    grams = {"pallas": "K1", "xla": "library"}
    chols = {"pallas": "K3 panels", "left": "library panels",
             "xla": "cholesky_ex whole"}
    for gram, gname in grams.items():
        cg = dataclasses.replace(cfg, gram_method=gram)
        dC = kernels.gram_matrix(data.X, theta, cg).double() - C64
        print(f"config4 Gram {gname} float32 vs float64: max|dC| "
              f"{dC.abs().max().item() / c64max:.3g} x max|C64|, mean dC "
              f"{dC.mean().item():.3g}, mean diag dC "
              f"{dC.diagonal().mean().item():.3g}")
        del dC
        for chol, cname in chols.items():
            c = dataclasses.replace(cg, cholesky_method=chol)
            with torch.no_grad():
                v = gp.log_marginal_likelihood(theta, data, c).item()
            print(f"config4 LML float32, Gram {gname}, factor {cname}: "
                  f"{v:.8g}, {abs(v - ll64) / abs(ll64):.3g} x |ll64| "
                  f"(ll64 {ll64:.8g})")
    del C64

    def value_and_grad(p, d):
        p = kernels.GPParams(*(a.detach().requires_grad_() for a in p))
        ll = gp.log_marginal_likelihood(p, d, cfg)
        return ll, torch.autograd.grad(ll, p)

    def flat(g):
        return torch.cat([a.reshape(-1).double() for a in g])

    def run_fit(steps):
        res = fit.fit_gp_host(torch.Generator().manual_seed(seed), data, cfg,
                              n_restarts=2, max_steps=steps)
        torch.cuda.synchronize()
        return res

    # control: the LML value and gradient with TF32 on
    with _tf32():
        ll_tf, g_tf = value_and_grad(theta, data)
    ll_tf = ll_tf.item()
    # [1] alone: the value tensor would keep the float64 factor alive
    g64 = flat(value_and_grad(theta64, data64)[1])
    g64max = g64.abs().max().item()
    ev = abs(ll_tf - ll64) / abs(ll64)
    check(not ev <= C4_LML_RTOL,
          f"TF32 control: LML {ll_tf:.8g} vs float64: {ev:.3g} x |ll64|, not"
          f" <= {C4_LML_RTOL} (the gate rejects TF32); gradient "
          f"{(flat(g_tf) - g64).abs().max().item() / g64max:.3g} x max|g64| "
          f"(not gated)")
    start = run_fit(0)  # the best of the starts, for the fit check

    # 2. the main path through the entry points, with the launch counts set
    # to 0 just before it and read just after: the LML value and closed-form
    # gradient, fit_gp_host (2 restarts x 3 steps), then serving 8,192
    # queries (precompute_predictor_safe + predict_from_precomputed)
    k1.launches = k2.launches = k3.launches = 0
    ll32, g32 = value_and_grad(theta, data)
    ll32 = ll32.detach()  # frees the factor the backward kept
    res = run_fit(3)
    st = gp.precompute_predictor_safe(theta, data, cfg)
    mean, var = gp.predict_from_precomputed(st, theta, data, Xs, cfg)
    torch.cuda.synchronize()
    launches = {"pairwise_covariance": k1.launches, "cholesky": k2.launches,
                "panel_factor": k3.launches}
    # each LML evaluation of the fit (one batch of both restarts) and the
    # serve precompute build one Gram by K1 and factor it with one K3 launch
    # per diagonal panel; predict runs K1 once per query chunk
    n_fact = 1 + res.stats["n_vg_calls"] + res.stats["n_v_calls"] + 1
    panels = -(-C4_N // cfg.cholesky_block)
    chunks = -(-C4_M // cfg.predict_query_chunk)
    check(k3.launches == panels * n_fact
          and k1.launches == n_fact + chunks,
          f"config-4 path (value+grad, fit, serve) launches {launches}: K3 "
          f"= {panels} panels x {n_fact} factorizations, K1 = {n_fact} Grams"
          f" + {chunks} query chunks")

    ll32 = ll32.item()
    g32 = flat(g32)
    ev = abs(ll32 - ll64) / abs(ll64)
    eg = (g32 - g64).abs().max().item() / g64max
    check(np.isfinite(ll32) and ev <= C4_LML_RTOL,
          f"LML float32 {ll32:.8g} vs float64 {ll64:.8g}: {ev:.3g} x |ll64| "
          f"<= {C4_LML_RTOL}")
    check(bool(torch.isfinite(g32).all()) and eg <= C4_GRAD_RTOL,
          f"LML gradient float32 vs float64: {eg:.3g} x max|g64| <= "
          f"{C4_GRAD_RTOL}; g64 {np.array2string(g64.cpu().numpy(), precision=4)}")
    best0, best3 = start.log_likelihood.item(), res.log_likelihood.item()
    check(np.isfinite(best3) and best3 >= best0,
          f"fit_gp_host 2 restarts x 3 steps: best logL {best3:.8g} >= best "
          f"start {best0:.8g}; stats {res.stats}")
    st64 = gp.precompute_predictor_safe(theta64, data64, cfg)
    m64, v64 = gp.predict_from_precomputed(st64, theta64, data64,
                                           Xs.double(), cfg)
    del st64
    scale = max(1.0, m64.abs().max().item())
    prior = 1.0 + 1e-2  # amp + nugget at theta
    dm = (mean.double() - m64).abs().max().item() / scale
    dv = (var.double() - v64).abs().max().item() / prior
    check(bool(st.ok) and mean.shape == (C4_M,)
          and bool(torch.isfinite(mean).all() and torch.isfinite(var).all())
          and dm <= C4_SERVE_TOL and dv <= C4_SERVE_TOL,
          f"serve {C4_M} queries float32 vs float64: mean {dm:.3g} x scale, "
          f"var {dv:.3g} x prior var <= {C4_SERVE_TOL}")
    # and the fitted thetas, as a user would serve them
    stf = gp.precompute_predictor_safe(res.params, data, cfg)
    mf, vf = gp.predict_from_precomputed(stf, res.params, data, Xs, cfg)
    check(bool(torch.isfinite(mf).all() and torch.isfinite(vf).all()),
          f"serve the fitted thetas: {C4_M} finite means and variances "
          f"(ok={bool(stf.ok)})")
    del stf

    # 3. times of the path's calls, after the counted run; the value+grad
    # memory peak with no serve state alive
    # one LBFGS step: the fit's wall after its first (start) evaluation,
    # which also pays the allocator's growth to the batch of 2 restarts
    times["fit_step"] = ((res.stats["fit_wall_s"] - res.stats["first_vg_wall_s"])
                         * 1e3 / max(1, res.stats["n_steps"]))
    times["predict"] = host_ms(
        lambda: gp.predict_from_precomputed(st, theta, data, Xs, cfg),
        iters=2)
    profile_once("predict", lambda: gp.predict_from_precomputed(
        st, theta, data, Xs, cfg), times["predict"], smi)
    del st
    times["precompute"] = host_ms(
        lambda: gp.precompute_predictor_safe(theta, data, cfg), iters=2)
    with torch.no_grad():
        times["value"] = host_ms(
            lambda: gp.log_marginal_likelihood(theta, data, cfg), iters=2)
    times["value_grad"] = host_ms(lambda: value_and_grad(theta, data),
                                  iters=2)
    torch.cuda.reset_peak_memory_stats(dev)
    value_and_grad(theta, data)
    torch.cuda.synchronize()
    vg_peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    for what, t in times.items():
        print(f"config4 time {what}: {t:.3f} ms ({smi})")
    gram_b = bound_ms(4 * (C4_N * C4_D + 2 + C4_N * C4_N),
                      C4_N * C4_N * (3 * C4_D + 3))
    fact_b = bound_ms(4 * (C4_N * (C4_N + 1) / 2 + C4_N * C4_N),
                      C4_N ** 3 / 3)
    print(f"config4 bounds: Gram {gram_b[0]:.4f} ms ({gram_b[1]}), "
          f"factorization {fact_b[0]:.3f} ms ({fact_b[1]})")
    print(f"config4 value+grad peak device memory {vg_peak_gib:.2f} GiB "
          f"({smi})")
    C = kernels.gram_matrix(data.X, theta, cfg)
    profile_once("factor_pallas_512", lambda: linalg.left_cholesky(
        C, block=512, diag="pallas"), times["factor_pallas_512"], smi)
    del C
    profile_once("value_grad", lambda: value_and_grad(theta, data),
                 times["value_grad"], smi)
    require(not failed, f"config4: {len(failed)} checks failed: {failed}")
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("error: CUDA device not available", file=sys.stderr)
        return 1
    import madaiemulator_tpu_torch  # noqa: F401  (sets the FP32 flags)

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    smi = phase_device()
    phase_build()
    kernels = phase_kernels(dev, rng)
    phase_goldens(dev)
    paths = {"serve_multivariate": phase_slice(dev, rng, smi),
             "config4": phase_config4(dev, args.seed, smi)}
    for k in kernels:
        by_path = {p: c.get(k["name"], 0) for p, c in paths.items()}
        k["launches_by_path"] = by_path
        k["launches"] = by_path["config4"] or by_path["serve_multivariate"]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
