"""Time kernel K1 (pairwise covariance) on the card, for one or more
checkouts of this repository within one run.

    python3 madaiemulator_tpu_torch/tools/time_pairwise.py [ROOT ...]

Each ROOT (default: this checkout) is a directory that holds a
`madaiemulator_tpu_torch` package; each is timed in a process of its own, in
the order given, so `OLD NEW NEW OLD` compares two versions of the kernel on
the same card under the same power limit. Per ROOT, at the shapes of the
main paths (power-exponential; a Gram is one tensor passed as U and V):

  * ms: CUDA-event milliseconds per call over back-to-back wrapper calls
    after 3 warm-up calls (the first builds the kernels);
  * graph: the same calls captured in one CUDA graph and replayed, so the
    small shapes show the kernel's device time and not the host's;
  * host_us: wall microseconds per call of the wrapper and of
    `ops.kernels.cross_covariance` (the serve path's caller), the median of
    5 rounds of 1,000 calls with no synchronize inside, at the serve path's
    query shapes; then the wrapper's parts at one query (its checks,
    the output's allocation, two ways to read the current stream, and the
    bare ctypes launch).
"""

from __future__ import annotations

import pathlib
import subprocess
import sys
import time

# (label, batch, n1, n2, d, Gram)
SHAPES = (
    ("gram(1,16384,16384)d8", 1, 16384, 16384, 8, True),
    ("gram(2,16384,16384)d8", 2, 16384, 16384, 8, True),
    ("cross(1,16384,1024)d8", 1, 16384, 1024, 8, False),
    ("gram(4,512,512)d6", 4, 512, 512, 6, True),
    ("cross(4,512,1024)d6", 4, 512, 1024, 6, False),
    ("cross(4,512,1)d6", 4, 512, 1, 6, False),
)
HOST_SHAPES = ((4, 512, 1024, 6), (4, 512, 1, 6))


def time_root(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import madaiemulator_tpu_torch  # noqa: F401  (turns TF32 off)
    from madaiemulator_tpu_torch.ops import kernels
    from madaiemulator_tpu_torch.ops.hopper import build
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
    from madaiemulator_tpu_torch.utils.config import GPConfig

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def ms(fn, iters):
        for _ in range(3):
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

    def graph_ms(fn, iters):
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn()  # warm-up on the capturing side stream
        torch.cuda.current_stream(dev).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        return ms(g.replay, 3) / iters

    out = []
    for label, B, n1, n2, d, gram in SHAPES:
        U = torch.rand(B, n1, d, device=dev, generator=gen) / 0.5
        V = U if gram else torch.rand(B, n2, d, device=dev, generator=gen) / 0.5
        amp = torch.ones(B, device=dev)
        g = torch.full((B,), 1e-2, device=dev)

        def call(U=U, V=V, amp=amp, g=g, gram=gram):
            return k1.pairwise_covariance(U, V, amp, g, "power_exponential",
                                          gram)

        big = n1 * n2 * B > 1 << 26
        t = ms(call, 5 if big else 50)
        tg = graph_ms(call, 5 if big else 50) if not big else t
        out.append(f"{label} ms {t:.4f} graph {tg:.4f}")
        del U, V
        torch.cuda.empty_cache()

    cfg = GPConfig(nparams=6, regression_order=1)
    host = []
    for B, n1, n2, d in HOST_SHAPES:
        X1 = torch.rand(n1, d, device=dev, generator=gen)
        X2 = torch.rand(n2, d, device=dev, generator=gen)
        params = kernels.GPParams(
            log_amp=torch.zeros(B, device=dev),
            log_nugget=torch.full((B,), -7.0, device=dev),
            log_ls=torch.full((B, d), -1.0, device=dev))
        U = kernels._scaled(X1, params, cfg)
        V = kernels._scaled(X2, params, cfg)
        amp = torch.exp(params.log_amp)
        zero = torch.zeros(B, device=dev)
        host.append((f"wrapper({B},{n1},{n2})",
                     lambda U=U, V=V, amp=amp, zero=zero:
                     k1.pairwise_covariance(U, V, amp, zero,
                                            "power_exponential")))
        host.append((f"cross_covariance({B},{n1},{n2})",
                     lambda X1=X1, X2=X2, params=params:
                     kernels.cross_covariance(X1, X2, params, cfg)))
    # the wrapper's parts at the one-query shape (the last of HOST_SHAPES)
    lib = build.load()
    res = torch.empty((B, n1, n2), device=dev)
    args = (U.data_ptr(), V.data_ptr(), amp.data_ptr(), zero.data_ptr(),
            res.data_ptr(), B, n1, n2, d, 0, 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    host += [
        ("part _check", lambda: k1._check(U, V, amp, zero,
                                          "power_exponential")),
        ("part torch.empty", lambda: torch.empty(
            (B, n1, n2), dtype=torch.float32, device=dev)),
        ("part current_stream().cuda_stream",
         lambda: torch.cuda.current_stream().cuda_stream),
        ("part raw stream", lambda: torch._C._cuda_getCurrentRawStream(0)),
        ("part ctypes launch", lambda: lib.madai_pairwise_covariance(
            *args, stream)),
    ]
    for what, fn in host:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        per = []
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(1000):
                fn()
            per.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        out.append(f"host_us {what} {sorted(per)[2]:.2f}")
    print(f"{root}: " + "; ".join(out), flush=True)


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        time_root(argv[1])
        return 0
    here = str(pathlib.Path(__file__).resolve().parents[2])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    for root in argv or [here]:
        rc = subprocess.run([sys.executable, __file__, "--one", root]).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
