#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`madaiemulator_tpu_torch`) on one GPU.

Run from the repository root, on a machine with an NVIDIA H100 (sm_90a) and
nvcc:

    python3 chip_smoke.py [--seed 0]

It imports no jax. Phases, in order; any failure exits non-zero:

  1. device  — require CUDA; print the nvidia-smi name / power-limit line;
               assert the full-FP32 matmul flags (TF32 off).
  2. build   — compile the Hopper kernels from csrc/ (nvcc, first use).
  3. kernels — K1 (pairwise covariance) and K2 (batched Cholesky) on the
               card against their plain-PyTorch versions at the serve
               path's shapes, K2 also against a float64 factor; NaN on a
               non-SPD input; kernel and plain times.
  4. goldens — serve tests/golden/*/state.txt on the card: float64 (library
               path) against expected.txt at rtol 1e-6; float32 (kernel
               path) against the float32 plain-kernel path on the CPU.
  5. slice   — a synthetic snapshot at the width of the flagship multivariate
               emulator (N=512, d=6, t=15, r=4 after PCA), served in-process
               on the kernels (launch counters reset before, read after)
               against float64, then through `interactive_mode` as a
               subprocess; precompute and predict times.

Before the last line it prints one JSON line with each kernel's launches on
the main path, its error against the plain version and both times; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
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


def phase_kernels(dev, rng) -> list:
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1

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
    for what, (t_k, t_p) in k1_times.items():
        shape = f"({B},{n},{n})" if what == "gram" else f"({B},{n},{m})"
        print(f"K1 time {what} {shape}: kernel {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms")

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
    print(f"K2 time ({B},{n},{n}): kernel {t2:.4f} ms, plain {t2p:.4f} ms, "
          f"torch.linalg.cholesky_ex {t2lib:.4f} ms")
    return [
        {"name": "pairwise_covariance", "route": "cuda",
         "source": "madaiemulator_tpu_torch/csrc/pairwise.cu",
         "replaces": "madaiemulator_tpu/ops/pallas/pairwise.py:90",
         "max_abs_err": k1_err, "ms": k1_times["cross"][0],
         "plain_ms": k1_times["cross"][1]},
        {"name": "cholesky", "route": "cuda",
         "source": "madaiemulator_tpu_torch/csrc/cholesky.cu",
         "replaces": "madaiemulator_tpu/ops/pallas/cholesky.py:210",
         "max_abs_err": k2_err, "ms": t2, "plain_ms": t2p},
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
    launches = phase_slice(dev, rng, smi)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
