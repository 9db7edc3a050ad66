"""Run one cell of the port's benchmark once, on the card of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
--trace 0, its per-layer metrics with --trace 1), `device`, with --trace 1
`breakdown`, then `host` (the host's CPU steal, load, clock and the run's
own CPU time over the untraced window: no metric), and last `checks`, each number compared with the reference
beside its limit (also the last lines of standard error). Exits 2 without a
result where the card or the cards the cell asks for are missing, and 3
where the run loaded JAX or the JAX package, 4 where a kernel's metric that
the cell lists found none of its launches in the trace. With --trace 1
the run measures an untraced window and then a traced one, each of
--seconds (portbench/harness/cell.py).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

CHECKOUT = pathlib.Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Caches at fixed paths inside the checkout, one thread for the
    host's numeric libraries, and no JAX behind any library's back."""
    cache = CHECKOUT / "portbench" / "_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    _environment()
    sys.path.insert(0, str(CHECKOUT))
    import torch

    from portbench.harness import cell

    run = cell.new_run(args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda:0")
    chips = int(run.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell.execute(run, T_START)
    return cell.finish(run)


if __name__ == "__main__":
    sys.exit(main())
