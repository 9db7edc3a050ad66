"""Where config 4's float32 factor and LML error on the card comes from.

    python3 madaiemulator_tpu_torch/tools/f32_factor_error.py [--seed 0]

At config 4's data and check theta (as `chip_smoke.py` phase 6 draws them:
N=16,384 points uniform in [0, 1]^8, y = sin(3 x0) + x1^2, amp 1, nugget
1e-2, length scales 0.5, the float32 jitter floor), it prints, each against
float64 and signed:

  * for each float32 Gram -- K1 on the card, the library's on the card, K1's
    plain version on the CPU -- the port's LML on its float64 factor (the
    Gram's share of the error) and on that factor rounded to float32 (the
    solves' share);
  * each Gram factored by every route on the card (the two left-looking
    routes, the K3 route with its history product summed other ways,
    `cholesky_ex` under each linear-algebra library) and, for the card-built
    Grams, on the CPU: the factor's distance from the Gram's float64 factor,
    its log-determinant's, and the LML's; with the route's wall time on the
    K1 Gram;
  * one history-sized float32 GEMM (the float64 factor's last 512 rows
    against all of it, k = N) summed each way on the card and on the CPU.

Nothing is gated. `--device cpu` runs the card's part on the CPU with the
kernels' plain versions, at a small `--n`, to rehearse the script.
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys
import time
from unittest import mock

import numpy as np
import torch


def _left_f64_history(A: torch.Tensor, block: int) -> torch.Tensor:
    """`left_cholesky(A, block, diag="pallas")` of one matrix with each
    panel's history product in float64, rounded to float32 once."""
    from madaiemulator_tpu_torch.ops import linalg

    n = A.shape[-1]
    L = torch.zeros_like(A)
    for cj in range(0, n, block):
        Pa = A[cj:, cj:cj + block]
        if cj:
            Pa = (Pa.double() - L[cj:, :cj].double()
                  @ L[cj:cj + block, :cj].double().mT).float()
        Lkk, invK = linalg._panel_factor(Pa[:block])
        L[cj:cj + block, cj:cj + block] = Lkk
        if cj + block < n:
            L[cj + block:, cj:cj + block] = Pa[block:] @ invK.mT
    return L


def _under(setting, library: str, fn):
    """fn under torch.backends.cuda.<setting>(library), restored after."""
    def run(*args):
        prev = setting()
        setting(library)
        try:
            return fn(*args)
        finally:
            setting(prev)

    return run


def _wall_ms(fn, dev, iters: int = 2) -> float:
    fn()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        sync()
    return (time.perf_counter() - t0) * 1e3 / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    import madaiemulator_tpu_torch  # noqa: F401  (sets the FP32 flags)
    from madaiemulator_tpu_torch.models import gp
    from madaiemulator_tpu_torch.ops import kernels, linalg
    from madaiemulator_tpu_torch.utils.config import GPConfig

    dev, cpu = torch.device(args.device), torch.device("cpu")
    card = dev.type == "cuda"
    n, block, d = args.n, args.block, 8
    rng = np.random.default_rng(args.seed)
    X = rng.uniform(size=(n, d)).astype(np.float32)
    y = (np.sin(3 * X[:, 0]) + X[:, 1] ** 2).astype(np.float32)
    cfg = GPConfig(nparams=d, regression_order=1, cholesky_block=block)
    cfg = dataclasses.replace(
        cfg, jitter=kernels.effective_jitter_frac(n, torch.float32, cfg))

    def theta(device, dtype):
        return kernels.GPParams(
            log_amp=torch.zeros((), dtype=dtype, device=device),
            log_nugget=torch.log(torch.tensor(1e-2, dtype=dtype,
                                              device=device)),
            log_ls=torch.log(torch.full((d,), 0.5, dtype=dtype,
                                        device=device)))

    def data(device, dtype):
        return gp.GPData(X=torch.tensor(X, dtype=dtype, device=device),
                         y=torch.tensor(y, dtype=dtype, device=device))

    def lml(L) -> float:
        """The port's LML with the Gram's factor replaced by L."""
        with mock.patch.object(gp, "training_gram", lambda *a: L), \
                mock.patch.object(gp, "_cholesky", lambda C, c: C), \
                torch.no_grad():
            return gp.log_marginal_likelihood(
                theta(L.device, L.dtype), data(L.device, L.dtype), cfg).item()

    def logdet(L) -> float:
        return linalg.logdet_from_chol(L.double()).item()

    with torch.no_grad():
        ll64 = gp.log_marginal_likelihood(theta(dev, torch.float64),
                                          data(dev, torch.float64),
                                          cfg).item()

    def rel(ll) -> str:
        return f"{(ll - ll64) / abs(ll64):.3g}"

    def left(diag, chunk=None):
        def factor(G):
            with mock.patch.object(linalg, "HISTORY_K_CHUNK",
                                   chunk or linalg.HISTORY_K_CHUNK):
                return linalg.left_cholesky(G, block=block, diag=diag)
        return factor

    chunk = linalg.HISTORY_K_CHUNK
    on_card = {
        f"K3 left-looking (the route, history in k-chunks of {chunk})":
            left("pallas"),
        f"library-panel left-looking (the route, k-chunks of {chunk})":
            left("xla"),
        "K3 left-looking, history as one GEMM": left("pallas", n),
        "K3 left-looking, history in k-chunks of 512": left("pallas", 512),
        "K3 left-looking, float64 history": lambda G: _left_f64_history(
            G, block),
        "cholesky_ex": linalg.xla_cholesky,
    }
    if card:
        blas = torch.backends.cuda.preferred_blas_library
        solver = torch.backends.cuda.preferred_linalg_library
        on_card["K3 left-looking, history as one GEMM under cuBLASLt"] = (
            _under(blas, "cublaslt", left("pallas", n)))
        on_card["cholesky_ex under cusolver"] = _under(
            solver, "cusolver", linalg.xla_cholesky)
        on_card["cholesky_ex under magma"] = _under(
            solver, "magma", linalg.xla_cholesky)
    on_cpu = {"cholesky_ex": linalg.xla_cholesky,
              f"library-panel left-looking (k-chunks of {chunk})":
                  left("xla")}
    smi = ""
    if card:
        import subprocess

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=False).stdout.strip()
    print(f"f32 factor error: N={n} d={d} block {block}, ll64 {ll64:.10g}; "
          f"errors signed, (float32 - float64) / |ll64|; {args.device} "
          f"{smi}; CPU threads {torch.get_num_threads()}")
    t0 = time.perf_counter()
    th32 = theta(dev, torch.float32)
    X32 = torch.tensor(X, device=dev)
    grams = {
        "K1 on the card": kernels.gram_matrix(X32, th32, cfg),
        "library on the card": kernels.gram_matrix(
            X32, th32, dataclasses.replace(cfg, gram_method="xla")),
        "K1 plain on the CPU": kernels.gram_matrix(
            X32.cpu(), theta(cpu, torch.float32), cfg).to(dev),
    }
    for gname, G in grams.items():
        Lref = torch.linalg.cholesky(G.double())
        lmax = Lref.abs().max().item()
        ld_ref, ll_ref = logdet(Lref), lml(Lref)
        L = Lref.float()
        print(f"Gram {gname}: its float64 factor's LML {rel(ll_ref)} (the "
              f"Gram's share); rounded to float32, LML {rel(lml(L))} here, "
              f"{rel(lml(L.cpu()))} on the CPU")
        del L
        where = [("card", on_card, G, Lref)]
        if gname != "K1 plain on the CPU":
            where.append(("CPU", on_cpu, G.cpu(), Lref.cpu()))
        for place, routes, Gw, Lw in where:
            for rname, route in routes.items():
                L = route(Gw)
                e = (L.double() - Lw).abs().max().item() / lmax
                line = (f"Gram {gname}, {rname} on the {place}: factor vs "
                        f"float64 {e:.3g} x max|L|; logdet - float64 "
                        f"{logdet(L) - ld_ref:.4g} nats; LML {rel(lml(L))}")
                del L
                if gname == "K1 on the card" and place == "card":
                    line += (f"; {_wall_ms(lambda: route(Gw), dev):.2f} ms "
                             f"wall")
                print(line)
        if gname == "K1 on the card":
            A, B = Lref[-512:].float(), Lref.float()
            S64 = A.double() @ B.double().mT
            gemm = {"one GEMM": lambda a, b: a @ b.mT}
            if card:
                gemm["one GEMM under cuBLASLt"] = _under(
                    torch.backends.cuda.preferred_blas_library, "cublaslt",
                    gemm["one GEMM"])
            for c in (2048, 512):
                gemm[f"k in chunks of {c}"] = lambda a, b, c=c: sum(
                    a[:, k:k + c] @ b[:, k:k + c].mT
                    for k in range(0, a.shape[1], c))
            runs = [(f"{w} here", f, A, B) for w, f in gemm.items()]
            runs.append(("one GEMM on the CPU", gemm["one GEMM"], A.cpu(),
                         B.cpu()))
            for what, f, Aw, Bw in runs:
                e = f(Aw, Bw).double().to(dev) - S64
                dg = torch.diagonal(e[:, -512:])
                print(f"float32 GEMM (512 x {n}) @ ({n} x {n}), {what}, vs "
                      f"float64: max|e| {e.abs().max().item():.3g} x max|S| "
                      f"{S64.abs().max().item():.3g}; mean e "
                      f"{e.mean().item():.3g}; diagonal (sums of squares) "
                      f"mean e {dg.mean().item():.3g}, max|e| "
                      f"{dg.abs().max().item():.3g}")
                del e
            del A, B, S64
        del Lref
        if card:
            torch.cuda.empty_cache()
    print(f"f32 factor error: took {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
