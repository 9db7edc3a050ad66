"""Hold kernels K2 and K3 against their test-only skewed build on the card.

    python3 -m madaiemulator_tpu_torch.tools.cluster_skew [--sass] [--repeat]

The skewed build (`build.load_skewed`, `-DMADAI_CLUSTER_SKEW_NS`) makes every
CTA of a cluster but rank 0 wait ~20 us before it loads a diagonal block
that the cluster wrote (`csrc/chol_cluster.cuh`). A kernel whose CTAs are
ordered by their cluster barriers alone computes the same bits at any such
skew; one in which a store can overtake another CTA's load of the same
addresses does not. For each main-path shape (`SHAPES`, every cluster size
the rule picks there) this prints the cluster size and, for K2's L and K3's
L and Linv, whether the skewed outputs are bitwise equal to the production
build's, and how far they are apart: the largest distance in float32 ulp
(over entries that are not NaN in either), the largest absolute difference
over max|L|, the entries that differ and the NaN entries. `--sass` also
compiles K2 and K3 without the define from `csrc/` and from a copy with the
`#ifdef MADAI_CLUSTER_SKEW_NS` blocks removed and compares their SASS: the
hook must leave the production object code as it was. `--repeat` also
calls the production K2 and K3 `LOAD_REPEATS` times at three shapes while a
second process loads the card, each call compared bitwise with the first.
The exit code is 1 if anything differed.

`chip_smoke.py` phase 3 and `tests/test_torch_cuda.py` use `compare`,
`repeat_under_load` and `CardLoad` from here; no entry point of the port
loads the skewed build. `python3 -m madaiemulator_tpu_torch.tools.
cluster_skew --load` is the card load itself: kernel K1 in a loop until its
standard input closes.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import select
import shutil
import subprocess
import sys
import tempfile
import threading

import numpy as np
import torch

from madaiemulator_tpu_torch.ops.hopper import build
from madaiemulator_tpu_torch.ops.hopper import cholesky as k2
from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
from madaiemulator_tpu_torch.ops.hopper import panel as k3

ROOT = pathlib.Path(__file__).resolve().parents[2]
# (batch, side) of the main paths, with the cluster size the rule picks:
# the multivariate serve and phase 9's joint-Gram panels (4,512) C=16;
# config 4's panels (1,512) C=16; the config-3 fit and the gradient batch
# (16,512) C=4; cholesky_block = 1024 (1,1024) C=16; a fit batch of 8
# components (8,512) C=8 and of 32 (32,512) C=2; many small matrices
# (300,128) C=1.
SHAPES = ((4, 512), (1, 512), (16, 512), (1, 1024), (8, 512), (32, 512),
          (300, 128))
# Calls of the production kernels compared bitwise under a card load, per
# (batch, side).
LOAD_REPEATS = {(4, 512): 500, (1, 512): 500, (16, 512): 200}


def gram(B: int, n: int, seed: int, dev) -> torch.Tensor:
    """(B, n, n) float32 power-exponential Grams of uniform points in d=6
    (length scale 0.3), amplitude 1, nugget 0.1."""
    x = np.random.default_rng(seed).uniform(size=(B, n, 6)) / 0.3
    U = torch.tensor(x, dtype=torch.float64)
    A = torch.exp(-0.5 * torch.cdist(U, U).square())
    A = A + 0.1 * torch.eye(n, dtype=torch.float64)
    return A.to(device=dev, dtype=torch.float32).contiguous()


def skewed_cholesky(A: torch.Tensor) -> torch.Tensor:
    """K2 of the skewed build on a CUDA float32 (B, n, n) tensor."""
    lib = build.load_skewed()
    L = torch.empty_like(A)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.madai_cholesky(A.data_ptr(), L.data_ptr(), A.shape[0],
                                 A.shape[-1], stream)
    build.check(build.load(), err, "skewed cholesky")
    return L


def skewed_panel_factor(A: torch.Tensor) -> tuple:
    """K3 of the skewed build: (L, Linv)."""
    lib = build.load_skewed()
    L, Linv = torch.empty_like(A), torch.empty_like(A)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.madai_panel_factor(A.data_ptr(), L.data_ptr(),
                                     Linv.data_ptr(), A.shape[0],
                                     A.shape[-1], stream)
    build.check(build.load(), err, "skewed panel_factor")
    return L, Linv


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """float32 bits as int64 keys whose differences count ulps."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def distance(want: torch.Tensor, got: torch.Tensor) -> dict:
    """How far `got` is from `want` (float32, same shape)."""
    kw, kg = _ordered(want), _ordered(got)
    nan = torch.isnan(want) | torch.isnan(got)
    ok = ~nan
    scale = want[ok].abs().max().item() if bool(ok.any()) else 0.0
    ulp = (kw - kg).abs()[ok]
    diff = (want - got).abs()[ok]
    return {
        "equal": torch.equal(want.view(torch.int32), got.view(torch.int32)),
        "max_ulp": int(ulp.max().item()) if ulp.numel() else 0,
        "max_rel": (diff.max().item() / scale) if diff.numel() and scale
        else 0.0,
        "differ": int((kw != kg).sum().item()),
        "nan_want": int(torch.isnan(want).sum().item()),
        "nan_got": int(torch.isnan(got).sum().item()),
    }


def compare(A: torch.Tensor) -> dict:
    """K2 and K3 of the production and the skewed builds on A: the cluster
    size and, for K2's L and K3's L and Linv, `distance`."""
    B, n = A.shape[0], A.shape[-1]
    want = (k2.cholesky(A),) + k3.panel_factor(A)
    got = (skewed_cholesky(A),) + skewed_panel_factor(A)
    torch.cuda.synchronize()
    out = {"C": build.load().madai_cluster_size(B, n)}
    for name, w, g in zip(("K2 L", "K3 L", "K3 Linv"), want, got):
        out[name] = distance(w, g)
    return out


def repeat_under_load(dev, load: "CardLoad | None" = None) -> dict:
    """K2 and K3 (production) called LOAD_REPEATS times at each shape
    while a second process runs K1 in a loop on the same card (`load`, or
    one started here); every call must be bitwise equal to the first.
    Returns {"(B,n)": {"calls": N, "C": C, "equal": bool}}."""
    out = {}
    with load or CardLoad():
        for (B, n), calls in LOAD_REPEATS.items():
            A = gram(B, n, n + B, dev)
            first = (k2.cholesky(A),) + k3.panel_factor(A)
            equal = True
            for _ in range(calls - 1):
                again = (k2.cholesky(A),) + k3.panel_factor(A)
                equal &= all(torch.equal(x, y) for x, y in zip(first, again))
            out[f"({B},{n})"] = {"calls": calls, "equal": equal,
                                 "C": build.load().madai_cluster_size(B, n)}
    return out


class CardLoad:
    """A second process on the card: K1 in a loop (a Gram at (1,8192,8192)
    d=8 and crosses at (4,512,1024) d=6). The process starts, and sets up,
    when the object is made; it loads the card inside `with`, from the
    moment `__enter__` returns, and stops on exit (or at `stop`)."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "madaiemulator_tpu_torch.tools.cluster_skew",
             "--load"], cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, bufsize=1)

    def _expect(self, word: str, timeout_s: float) -> None:
        ready, _, _ = select.select([self.proc.stdout], [], [], timeout_s)
        line = self.proc.stdout.readline() if ready else ""
        if line.strip() != word:
            self.stop()
            raise RuntimeError(f"card load: expected {word!r}, read {line!r} "
                               f"(exit {self.proc.returncode})")

    def __enter__(self):
        self._expect("ready", 120.0)
        self.proc.stdin.write("go\n")
        self.proc.stdin.flush()
        self._expect("running", 60.0)
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


def _load_loop() -> int:
    """The card load's process: set up, print "ready", wait for "go", then
    K1 in a loop until standard input closes ("running" after the first
    round)."""
    import madaiemulator_tpu_torch  # noqa: F401  (sets the FP32 flags)

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    U = torch.rand(1, 8192, 8, device=dev, generator=g) / 0.5
    Uc = torch.rand(4, 512, 6, device=dev, generator=g) / 0.3
    Vc = torch.rand(4, 1024, 6, device=dev, generator=g) / 0.3
    one, four = torch.ones(1, device=dev), torch.ones(4, device=dev)
    k1.pairwise_covariance(Uc, Vc, four, None, "power_exponential")
    torch.cuda.synchronize()
    print("ready", flush=True)
    if sys.stdin.readline().strip() != "go":
        return 0
    stop = threading.Event()
    threading.Thread(target=lambda: (sys.stdin.read(), stop.set()),
                     daemon=True).start()
    first = True
    while not stop.is_set():
        for _ in range(20):
            k1.pairwise_covariance(U, U, one, one * 1e-2, "power_exponential",
                                   True)
            k1.pairwise_covariance(Uc, Vc, four, None, "power_exponential")
        torch.cuda.synchronize()
        if first:
            print("running", flush=True)
            first = False
    return 0


def _strip_hook(text: str) -> str:
    """The source without its `#ifdef MADAI_CLUSTER_SKEW_NS` blocks."""
    return re.sub(r"#ifdef MADAI_CLUSTER_SKEW_NS\n.*?#endif\n", "", text,
                  flags=re.S)


def sass_unchanged() -> dict:
    """K2 and K3 compiled without the define, from csrc/ and from a copy
    without the hook: {source: SASS lines, equal}."""
    nvcc = build._find_nvcc()
    cuobjdump = str(pathlib.Path(nvcc).with_name("cuobjdump"))
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        bare = pathlib.Path(tmp) / "csrc"
        shutil.copytree(build.CSRC, bare)
        for f in bare.iterdir():
            f.write_text(_strip_hook(f.read_text()))
        for src in build.SKEW_SOURCES:
            sass = []
            for where in (build.CSRC, bare):
                cubin = pathlib.Path(tmp) / f"{where.parent.name}_{src}.cubin"
                subprocess.run([nvcc, *build.NVCC_FLAGS, "-cubin",
                                str(where / src), "-o", str(cubin)],
                               check=True)
                text = subprocess.run([cuobjdump, "-sass", str(cubin)],
                                      check=True, capture_output=True,
                                      text=True).stdout
                # nvcc names the anonymous namespace after a hash of the
                # source: _GLOBAL__N__<hash>_<length>_<file>_<hash>
                sass.append([re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__",
                                    ln)
                             for ln in text.splitlines()
                             if tmp not in ln and str(build.CSRC) not in ln])
            diff = [(a, b) for a, b in zip(*sass) if a != b]
            out[src] = {"lines": len(sass[0]), "equal": sass[0] == sass[1],
                        "first_difference": diff[0] if diff else None}
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--load", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--repeat", action="store_true",
                    help="also the LOAD_REPEATS calls under a card load")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: CUDA device not available", file=sys.stderr)
        return 1
    if args.load:
        return _load_loop()
    import madaiemulator_tpu_torch  # noqa: F401  (sets the FP32 flags)

    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    build.load()
    build.load_skewed()
    print(f"skewed build: {build.library_path(skewed=True).name}, "
          f"{build.SKEW_NS} ns", flush=True)
    results, all_equal = {}, True
    for B, n in SHAPES:
        r = results[f"({B},{n})"] = compare(gram(B, n, B * n, dev))
        parts = []
        for name in ("K2 L", "K3 L", "K3 Linv"):
            d = r[name]
            all_equal &= d["equal"]
            parts.append(
                f"{name} {'bitwise equal' if d['equal'] else 'DIFFERS'}: "
                f"max {d['max_ulp']} ulp, {d['max_rel']:.3g} x max|L|, "
                f"{d['differ']} entries differ, NaN {d['nan_want']} / "
                f"{d['nan_got']}")
        print(f"({B},{n},{n}) C={r['C']}: " + "; ".join(parts), flush=True)
    if args.sass:
        results["sass"] = sass_unchanged()
        print(f"SASS without the define, csrc/ vs csrc/ without the hook: "
              f"{results['sass']}", flush=True)
        all_equal &= all(v["equal"] for v in results["sass"].values())
    if args.repeat:
        results["repeat_under_load"] = rep = repeat_under_load(dev)
        print(f"under a card load (K1 in a second process): {rep}",
              flush=True)
        all_equal &= all(v["equal"] for v in rep.values())
    print(json.dumps(results))
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
