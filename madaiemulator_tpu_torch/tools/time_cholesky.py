"""Time kernels K2 (batched Cholesky) and K3 (panel factor + inverse) on the
card, for one or more checkouts of this repository within one run.

    python3 madaiemulator_tpu_torch/tools/time_cholesky.py [ROOT ...]

Each ROOT (default: this checkout) is a directory that holds a
`madaiemulator_tpu_torch` package; each is timed in a process of its own, in
the order given, so `OLD NEW NEW OLD` compares two versions of the kernels on
the same card under the same power limit. One line per ROOT: CUDA-event
milliseconds per call over 50 back-to-back calls after 3 warm-up calls (the
first builds the kernels), at the shapes of the main paths: K2 at the serve
path's (4,512,512), the config-3 fit's (16,512,512), a fit-loop batch and
one large matrix; K3 at config 4's diagonal panels and the gradient path's
batch (16,512,512). Then "config4-panels": the device time of the 32 K3
launches inside one `left_cholesky` of a config-4 Gram (N=16,384 in d=8,
block 512), summed from a torch.profiler trace.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

K2_SHAPES = ((4, 512), (16, 512), (32, 512), (1, 1024), (64, 256),
             (132, 128))
K3_SHAPES = ((1, 512), (2, 512), (16, 512), (1, 1024))


def time_root(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import madaiemulator_tpu_torch  # noqa: F401  (turns TF32 off)
    from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
    from madaiemulator_tpu_torch.ops.hopper import panel as k3

    dev = torch.device("cuda", 0)

    def spd(B, n):
        G = torch.randn(B, n, n, device=dev)
        return G @ G.mT + n * torch.eye(n, device=dev)

    def ms(fn, iters=50):
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

    torch.manual_seed(0)
    out = []
    for name, fn, shapes in (("K2", k2.cholesky, K2_SHAPES),
                             ("K3", k3.panel_factor, K3_SHAPES)):
        for B, n in shapes:
            A = spd(B, n)
            out.append(f"{name}({B},{n},{n}) {ms(lambda: fn(A)):.4f}")
            del A
    out.append(f"config4-panels {config4_panels_ms(dev):.4f}")
    print(f"{root}: ms per call: " + " ".join(out), flush=True)


def config4_panels_ms(dev) -> float:
    """Device ms of K3's launches in one left_cholesky of a config-4 Gram
    (N=16,384, d=8, length scale 0.5, nugget 1e-2, block 512), warm."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from madaiemulator_tpu_torch.ops import linalg

    g = torch.Generator(device=dev).manual_seed(0)
    U = torch.rand(16384, 8, device=dev, generator=g) / 0.5
    A = torch.cdist(U, U).square_().mul_(-0.5).exp_()
    A.diagonal().add_(1e-2)
    del U

    def run():
        return linalg.left_cholesky(A, block=512, diag="pallas")

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    us = [getattr(e, "self_device_time_total",
                  getattr(e, "self_cuda_time_total", 0.0))
          for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and "panel_factor" in e.key]
    if not us:
        raise RuntimeError("no K3 launch in the profile of left_cholesky")
    return sum(us) / 1e3


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
