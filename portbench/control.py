"""The readings that the limits of the checks are set from, on the card:
for each seed, one run of a cell (set-up, a window of --seconds, the
checks) and its numbers; for the control seeds, also the same numbers with
the control in the program's place: the reference in TF32 arithmetic, the
step below the float32 the configurations state. Not part of a benchmark
run.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] --control-seeds <n> [<n> ...]

Prints one JSON line a seed: {"seed", "kind": "program" | "control",
"numbers": {...}}; the program's lines also carry "correct" and the
window's time.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

CHECKOUT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(CHECKOUT))
    from portbench import run as run_mod

    run_mod._environment()
    import torch

    from portbench.harness import cell

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        t0 = time.perf_counter()
        run = cell.new_run(args.workload, seed, args.seconds, False,
                           args.device)
        state = cell.execute(run, t0)
        if seed in args.seeds:
            print(json.dumps({
                "seed": seed, "kind": "program",
                "correct": run.failed == 0 and all(c.ok for c in run.checks),
                "attempted": run.attempted, "failed": run.failed,
                "window_s": run.window_s,
                "numbers": {c.name: c.value for c in run.checks},
                "wall_s": time.perf_counter() - t0}), flush=True)
        if seed in args.control_seeds:
            print(json.dumps({"seed": seed, "kind": "control",
                              "numbers": cell.driver(run).control(run, state)}),
                  flush=True)
        del state, run
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
