"""Run `chip_smoke.py`'s phase-16 steps (the multi-device paths) over a real
mesh of every visible card, up to four, without the rest of the script.

    python3 madaiemulator_tpu_torch/tools/mesh_cards.py [--seed 0]

Needs two or more CUDA devices (for example four H100s on one host); with
fewer it exits 1. Its inputs are made short: phase 7's config-3 snapshot
by the CLI's estimate_thetas at 3 L-BFGS steps (phase 7 runs 40), and phase
10's unsharded value+grad, which the matrix-free step compares with, once.
Each step (config 5, sharded serving, the matrix-free GP, SGPR, the factor,
the walkers) then runs over the cards with phase 16's gates and launch
counts and prints its sharded and unsharded walls; the exit code is 1 if
any check failed.
"""

from __future__ import annotations

import argparse
import math
import pathlib
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    seed = ap.parse_args().seed
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from madaiemulator_tpu_torch.io.modelfile import write_model_file
    from madaiemulator_tpu_torch.models import iterative
    from madaiemulator_tpu_torch.ops import kernels
    from madaiemulator_tpu_torch.ops.hopper import pairwise as k1
    from madaiemulator_tpu_torch.utils.config import GPConfig

    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        print(f"mesh_cards: needs 2 or more CUDA devices, {n_cards} visible",
              file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = cs.phase_device()
    cs.phase_build()
    devices = [torch.device("cuda", i)
               for i in range(min(n_cards, cs.MESH_SHARDS))]
    label = f"mesh{len(devices)}cards"
    print(f"{label}: {[torch.cuda.get_device_name(i) for i in range(n_cards)]}")
    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        (work / "config3").mkdir()
        model = str(work / "config3" / "model.txt")
        X3, Y3 = cs._heavy_ion_like(np.random.default_rng(seed), cs.C3_N,
                                    cs.C3_D, cs.C3_T)
        write_model_file(model, X3, Y3)
        rc, _, err = cs._run_cli(
            ["estimate_thetas", model, str(work / "config3" / "state.txt"),
             "--dtype", "float32", "--device", "cuda", "--regression_order",
             "1", "--pca_variance", str(cs.C3_PCA), "--restarts", "4",
             "--steps", "3", "--seed", str(seed)])
        if rc != 0:
            print(f"mesh_cards: estimate_thetas exit {rc}: {err}",
                  file=sys.stderr)
            return 1
        data, _ = cs._iter_data(seed, dev)
        cfg = GPConfig(nparams=cs.I_D, regression_order=1)
        theta = kernels.GPParams(
            log_amp=torch.tensor(math.log(cs.I_AMP), device=dev),
            log_nugget=torch.tensor(math.log(cs.I_NUGGET), device=dev),
            log_ls=torch.full((cs.I_D,), math.log(cs.I_LS), device=dev))
        kw = dict(seed=0, rank=cs.I_RANK, probes=cs.I_PROBES,
                  lanczos_iters=cs.I_LANCZOS, cg_tol=cs.I_TOL,
                  cg_max_iters=cs.I_ITERS, logdet_method="mbcg",
                  row_chunk=cs.I_ROW_CHUNK)
        k1.launches = 0
        t0 = time.perf_counter()
        ll, g = cs._vg(lambda p: iterative.lml_iterative(p, data, cfg, **kw),
                       theta)
        torch.cuda.synchronize()
        iter_vg = (ll, g, k1.launches, time.perf_counter() - t0)
        del data
        failed = []

        def check(ok: bool, what: str) -> None:
            print(f"mesh check {'ok' if ok else 'FAILED'}: {what}")
            if not ok:
                failed.append(what)

        cs._mesh_ensemble(dev, devices, label, seed, smi, check, None)
        cs._mesh_serve(dev, devices, label, seed, smi, work, check, None)
        cs._mesh_iterative(dev, devices, label, seed, smi, iter_vg, check)
        cs._mesh_sparse(dev, devices, label, seed, smi, check)
        cs._mesh_factor(dev, devices, label, seed, smi, check)
        cs._mesh_walkers(dev, devices, label, seed, smi, work, check, None)
    print(f"mesh_cards wall {time.perf_counter() - t_all:.1f} s ({smi}); "
          f"{len(failed)} checks failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
