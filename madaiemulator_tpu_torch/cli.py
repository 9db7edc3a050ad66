"""`interactive_emulator_torch` command-line tool (port of
madaiemulator_tpu/cli.py: `estimate_thetas` on the dense, the matrix-free,
the sparse and the multi-fidelity path, `interactive_mode`, `print_thetas`,
`convert` and `validate` on the dense, the sparse and the multi-fidelity
snapshot, as text or as .npz by the state file's extension, `calibrate`,
`design` and `sensitivity`: every subcommand of the JAX CLI).

    interactive_emulator_torch estimate_thetas <model_file> <state_file>
        [--regression_order=N] [--covariance_fn=NAME] [--pca_variance=P]
        [--restarts=R] [--steps=S] [--seed=K] [--dtype=float64|float32]
        [--device=cuda|cpu] [--quiet] [--linesearch=zoom|backtracking]
        [--restart_chunk=C] [--alpha_grid=A1,A2,...] [--alpha_refine=K]
        [--cholesky_method=pallas|left|blocked|xla] [--gram_method=pallas|xla]
        [--update_precision=auto|default|high|highest]
        [--noise_file=PATH] [--gradients_file=PATH]
        [--fit_method=dense|iterative] [--rank=K] [--probes=P]
        [--lanczos_iters=M] [--cg_tol=T] [--cg_max_iters=I]
        [--logdet_method=slq|mbcg] [--checkpoint_path=PATH] [--vg_batch=B]
        [--inducing=M] [--inducing_opt_steps=K] [--row_chunk=C]

trains the multivariate emulator (PCA + one GP per component, every
component x restart lane in one lock-step LBFGS batch) and writes the
snapshot (.npz when the state file ends in .npz, else text; version 3 when
trained on gradients); the flags and defaults are the JAX CLI's, except
that --cholesky_method and --gram_method default to "pallas" (the Hopper
kernels at float32). --noise_file holds N or N*t observation-noise
variances; --gradients_file N*t*d output gradients w.r.t. the raw inputs
(io/modelfile.read_gradients_file). --fit_method=iterative fits each
component matrix-free (models/iterative.py: PCG with a rank --rank
pivoted-Cholesky preconditioner, an SLQ or mBCG logdet over --probes
probes, the host-loop LBFGS; --checkpoint_path writes PATH.c<i> per
component); it takes no --gradients_file and no --alpha_grid. --inducing=M
trains sparse (SGPR, models/sparse.py: M greedy-maximin inducing points, an
O(N M^2) ELBO; --row_chunk streams the N axis in chunks of C rows,
--inducing_opt_steps refines the inducing points by K Adam steps) and
writes the sparse snapshot; it composes with --noise_file and
--gradients_file and excludes --fit_method=iterative and --alpha_grid. A
MULTIFIDELITY model file (io/modelfile.read_multifidelity_model_file) trains
the AR(1) co-kriging emulator (models/multifidelity.py; scalar, or
multivariate with its `noutputs` header: one shared PCA basis), every level
dense, and writes the multi-fidelity snapshot; --noise_file,
--gradients_file, --alpha_grid, --inducing and --fit_method=iterative exit
2 there. --cholesky_method=blocked factors every Gram of more than 512
rows (GPConfig.cholesky_block) by the right-looking blocked factorization
(ops/linalg.blocked_cholesky_opt: library math on the card and on the CPU,
as in the JAX package).

    interactive_emulator_torch print_thetas <state_file>
        prints the fitted per-component hyperparameters (natural space).

    interactive_emulator_torch convert <in_state> <out_state>
        re-encodes a dense, sparse or multi-fidelity snapshot between text
        and .npz (by extension; the JAX CLI's output byte for byte in text,
        key for key in .npz).

    interactive_emulator_torch validate <state_file> [--model_file=M]
        [--interval=P] [--output=PATH] [--dtype=float64|float32]
        [--device=cuda|cpu] [--holdout=M [--matrix_free] [--seed=K]
        [--rank=K] [--cg_tol=T] [--cg_max_iters=I]]
        closed-form leave-one-out validation (models/diagnostics.py: one
        factorization a component, no refits), or with --holdout a held-out
        block predicted through the matrix-free serving path
        (--matrix_free: no dense factorization anywhere); prints rmse /
        coverage / standardized-residual moments, --output writes the
        per-point table. A sparse snapshot validates by its training
        residuals against --model_file; a multi-fidelity one by per-level
        closed-form LOO (level<k>_* lines; --holdout, --matrix_free and
        --model_file exit 2 there).

    interactive_emulator_torch calibrate <state_file> <experiment_file>
        [--n_walkers=W] [--n_steps=S] [--burn_in=B] [--thin=K]
        [--sampler=emcee|pt|rwm|hmc] [--discrepancy] [--seed=K]
        [--dtype=float64|float32] [--device=cuda|cpu] [--output=PATH]
        [--quiet] [--matrix_free [--rank=K] [--cg_tol=T]
        [--cg_max_iters=I]]
        MCMC over the emulator in process (models/calibrate.py): the
        experiment file (io/experiment.py: <noutputs>, then one "<value>
        <variance>" row per observable) against the emulator's marginalized
        Gaussian likelihood; posterior draws to --output ('-' is stdout, one
        draw a row, '#' header), a per-parameter summary with R-hat and ESS
        on stderr. --matrix_free calibrates a dense snapshot through the
        matrix-free serving cache (sparse and multi-fidelity snapshots exit
        2 with it).

    interactive_emulator_torch design <state_file> [--method=variance|nroy]
        [--experiment_file=PATH] [--n_new=K] [--pool_size=P]
        [--threshold=T] [--seed=K] [--dtype=float64|float32]
        [--device=cuda|cpu] [--output=PATH] [--quiet] [--matrix_free
        [--rank=K] [--cg_tol=T] [--cg_max_iters=I]]
        the next K simulator runs (models/design.py): a greedy maximin
        batch from a P-point Latin-hypercube pool, by predictive variance
        or (nroy) inside the region the experiment file does not rule out;
        natural-space points to --output, one a row, '#' header. Sparse and
        multi-fidelity snapshots exit 2 with --matrix_free.

    interactive_emulator_torch sensitivity <state_file> [--n=N] [--seed=K]
        [--dtype=float64|float32] [--device=cuda|cpu] [--output=PATH]
        [--main_effects=PATH [--grid=G] [--effects_n=M]] [--query_chunk=Q]
        [--quiet]
        Sobol first-order and total indices per (parameter, observable)
        from N (d + 2) emulator evaluations (models/sensitivity.py), and
        with --main_effects the main-effect curves on a G-point grid (its
        base design drawn from seed + 1).

    interactive_emulator_torch interactive_mode <state_file>
        [--dtype=float64|float32] [--device=cuda|cpu]
        [--serve_method=dense|fast|iterative] [--rank=K] [--cg_tol=T]
        [--cg_max_iters=I] [--variance_method=exact|precond]
        [--query_chunk=Q] [--variance_rhs=V]

--serve_method=fast inverts each component's factors once at start-up so
that every query batch is GEMMs only (no triangular solves);
--serve_method=iterative builds no dense factor: it builds each
component's preconditioner and training solves once at start-up and
answers each batch by PCG (--variance_method=exact, in column blocks of
--variance_rhs) or by the preconditioner's Woodbury apply ("precond"), in
chunks of --query_chunk queries. A gradient-enhanced (version 3) snapshot
serves dense only and exits 2 on either; a sparse snapshot serves from its
O(m^2) state and exits 2 on either too, and a multi-fidelity snapshot
serves its highest fidelity through the recursive dense predict (either
exits 2).
interactive_mode reads query points (nparams whitespace-separated floats)
on stdin until EOF
and writes t means then t variances per query on stdout, "%.17g", flushing
after each batch: the pipe protocol of the JAX CLI, byte for byte. Header:
nparams, param names, 2*noutputs, then the mean_* / variance_* labels.
Every complete point already buffered on the pipe is answered in one batched
call (at most 1024 points per call).

--device cuda (the default) needs a CUDA device: without one
`estimate_thetas`, `interactive_mode`, `validate`, `calibrate`, `design`
and `sensitivity` exit 2 with "error: CUDA device not available" (they
never move to the CPU by themselves). At float32 the
fit and the serve path run on the Hopper kernels; float64 (the default)
takes the library path. Also runnable as `python -m madaiemulator_tpu_torch.cli`.
"""

from __future__ import annotations

import argparse
import os
import select
import sys
from typing import List, Optional

import numpy as np

MAX_BATCH = 1024


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="interactive_emulator_torch",
        description="PyTorch/CUDA MADAI-style Gaussian-process emulator",
    )
    sub = p.add_subparsers(dest="command", required=True)

    est = sub.add_parser("estimate_thetas", help="fit hyperparameters")
    est.add_argument("model_file")
    est.add_argument("state_file")
    est.add_argument("--regression_order", type=int, default=0)
    est.add_argument("--covariance_fn", default="power_exponential")
    est.add_argument("--pca_variance", type=float, default=0.95)
    est.add_argument("--restarts", type=int, default=8)
    est.add_argument("--steps", type=int, default=100)
    est.add_argument("--seed", type=int, default=0)
    est.add_argument("--dtype", choices=["float64", "float32"], default="float64")
    est.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    est.add_argument("--quiet", action="store_true")
    # matrix-free training for N past dense device memory (models/iterative)
    est.add_argument(
        "--fit_method", choices=["dense", "iterative"], default="dense",
        help="'iterative': matrix-free PCG + SLQ/mBCG fitting (no N^2 "
        "memory)",
    )
    est.add_argument("--rank", type=int, default=64,
                     help="iterative: preconditioner rank")
    est.add_argument("--probes", type=int, default=16,
                     help="iterative: logdet / trace probe vectors")
    est.add_argument("--lanczos_iters", type=int, default=32)
    est.add_argument("--cg_tol", type=float, default=1e-5)
    est.add_argument("--cg_max_iters", type=int, default=256)
    est.add_argument(
        "--logdet_method", choices=["slq", "mbcg"], default="slq",
        help="iterative: 'mbcg' derives the logdet from the same CG pass "
        "as the solves",
    )
    est.add_argument(
        "--checkpoint_path", default=None, metavar="PATH",
        help="iterative: mid-fit checkpoint/resume (.npz; one file per PCA "
        "component, PATH.c<i>). Re-running with the same path resumes",
    )
    est.add_argument(
        "--vg_batch", type=int, default=1,
        help="iterative: restarts per objective call (evaluated one after "
        "another)",
    )
    est.add_argument(
        "--restart_chunk", type=int, default=None,
        help="run optimizer restarts in sequential groups of this size "
        "(bounds peak memory when N^2 x restarts is large)",
    )
    est.add_argument(
        "--alpha_grid", default=None, metavar="A1,A2,...",
        help="power-exponential only: profile the kernel exponent over "
        "this comma-separated grid (one shared alpha; best total logL wins)",
    )
    est.add_argument(
        "--alpha_refine", type=int, default=0, metavar="K",
        help="with --alpha_grid: K golden-section probes of the continuous "
        "alpha profile around the grid winner (each probe is one full fit)",
    )
    est.add_argument(
        "--cholesky_method", choices=["xla", "left", "blocked", "pallas"],
        default="pallas",
        help="'pallas' (default here): the Hopper kernel K2 at float32; "
        "'xla': the library; 'left': left-looking blocked; 'blocked': "
        "right-looking blocked",
    )
    est.add_argument(
        "--gram_method", choices=["xla", "pallas"], default="pallas",
        help="'pallas' (default here): the Hopper kernel K1 at float32",
    )
    est.add_argument(
        "--update_precision",
        choices=["auto", "default", "high", "highest"], default="highest",
        help="matmul tier of the large-N blocked Cholesky updates: "
        "'highest' full FP32, 'high' 3xTF32, 'default' one TF32 pass; "
        "'auto' picks from the condition bound at serve time",
    )
    est.add_argument("--linesearch", choices=["zoom", "backtracking"],
                     default="zoom")
    est.add_argument(
        "--noise_file", default=None,
        help="per-point observation-noise VARIANCES (whitespace floats): N "
        "values (one per design point, every output) or N x t values",
    )
    est.add_argument(
        "--gradients_file", default=None,
        help="observed output gradients w.r.t. the raw inputs: N*t*d "
        "floats, per point, per output, the d partials; trains a joint "
        "value+gradient GP per component (power_exponential alpha=2 or "
        "matern52[_ard]) and writes a version-3 snapshot",
    )
    est.add_argument(
        "--inducing", type=int, default=0, metavar="M",
        help="train SPARSE (SGPR, models/sparse.py): M inducing points (a "
        "greedy-maximin subset of the design) replace the N x N Gram with "
        "O(N*M^2) work; the snapshot stores the O(M^2) serve state under "
        "its own grammar. Composes with --gradients_file; excludes "
        "--fit_method=iterative / --alpha_grid",
    )
    est.add_argument(
        "--inducing_opt_steps", type=int, default=0, metavar="K",
        help="sparse: refine the inducing LOCATIONS jointly with the "
        "hyperparameters by K Adam steps on the ELBO after LBFGS",
    )
    est.add_argument(
        "--row_chunk", type=int, default=None, metavar="C",
        help="sparse: stream the N axis in C-row chunks inside every ELBO "
        "evaluation (each chunk checkpointed): live memory O(M*C), flat in "
        "N; use C=65536 with --restart_chunk=1 at N ~ 1e6",
    )

    im = sub.add_parser("interactive_mode", help="serve queries over stdin/stdout")
    im.add_argument("state_file")
    im.add_argument("--dtype", choices=["float64", "float32"], default="float64")
    im.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    im.add_argument(
        "--serve_method", choices=["dense", "fast", "iterative"],
        default="dense",
        help="'fast': GEMM-only serving (explicit triangular inverses); "
        "'iterative': matrix-free serving (no dense factorization)",
    )
    im.add_argument("--rank", type=int, default=64)
    im.add_argument("--cg_tol", type=float, default=1e-6)
    im.add_argument("--cg_max_iters", type=int, default=256)
    im.add_argument(
        "--variance_method", choices=["exact", "precond"], default="exact",
        help="iterative serving: 'precond' answers variances from the "
        "preconditioner's Woodbury apply (a PCG-free lower bound)",
    )
    im.add_argument("--query_chunk", type=int, default=128,
                    help="iterative serving: queries per cross-covariance "
                    "build")
    im.add_argument("--variance_rhs", type=int, default=128,
                    help="iterative serving, exact variances: PCG "
                    "right-hand sides per solve")

    pt = sub.add_parser("print_thetas", help="print fitted hyperparameters")
    pt.add_argument("state_file")

    cvt = sub.add_parser(
        "convert", help="convert a state file between text and npz")
    cvt.add_argument("in_state")
    cvt.add_argument("out_state")

    cal = sub.add_parser(
        "calibrate",
        help="MCMC-calibrate parameters against observed data (in-process)",
        description=(
            "Sample the parameter posterior given experimental observations "
            "using the trained emulator, in process (models/calibrate.py: "
            "one batched emulator evaluation over the walkers a move, on "
            "the device). The experiment file format is: first line "
            "<noutputs>, then one '<value> <variance>' row per observable "
            "in snapshot output order ('#' comments allowed)."
        ),
    )
    cal.add_argument("state_file")
    cal.add_argument("experiment_file")
    cal.add_argument("--n_walkers", type=int, default=64)
    cal.add_argument("--n_steps", type=int, default=1000)
    cal.add_argument("--burn_in", type=int, default=None,
                     help="steps discarded (default: n_steps/4)")
    cal.add_argument("--thin", type=int, default=1)
    cal.add_argument(
        "--sampler", choices=["emcee", "pt", "rwm", "hmc"], default="emcee",
        help="'pt' = parallel tempering (use when R-hat stays high: "
        "multimodal posteriors); 'hmc' = Hamiltonian MC with autodiff "
        "gradients through the emulator",
    )
    cal.add_argument(
        "--discrepancy", action="store_true",
        help="sample a Kennedy-O'Hagan model-discrepancy scale jointly "
        "with the parameters (reported as a fraction of each observable's "
        "training std dev)",
    )
    cal.add_argument("--seed", type=int, default=0)
    cal.add_argument("--dtype", choices=["float64", "float32"],
                     default="float64")
    cal.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    cal.add_argument(
        "--output", default="-", metavar="PATH",
        help="posterior samples destination ('-' = stdout): one draw per "
        "row, nparams columns, '#' header",
    )
    cal.add_argument("--quiet", action="store_true")
    cal.add_argument(
        "--matrix_free", action="store_true",
        help="calibrate a dense snapshot through the matrix-free serving "
        "cache (PCG-free Woodbury variance): the route past dense memory",
    )
    cal.add_argument("--rank", type=int, default=64,
                     help="matrix-free: preconditioner rank")
    cal.add_argument("--cg_tol", type=float, default=1e-6)
    cal.add_argument("--cg_max_iters", type=int, default=256)

    val = sub.add_parser(
        "validate",
        help="leave-one-out validation of a trained emulator",
        description=(
            "Closed-form leave-one-out cross-validation of the emulator in "
            "the state file (Dubrule identity: one factorization per "
            "component, no refits). By default residuals are scored "
            "against the retained-PCA reconstruction of the training "
            "outputs (GP error only); pass --model_file to score against "
            "the raw training outputs, which additionally exposes PCA "
            "truncation error (not covered by the emulator's error bars, "
            "so coverage drops if truncation is material). Sparse (SGPR) "
            "snapshots validate with training residuals against "
            "--model_file (meaningful: m << N effective dof)."
        ),
    )
    val.add_argument("state_file")
    val.add_argument(
        "--model_file", default=None, metavar="PATH",
        help="the training model file; residuals then include PCA "
        "truncation error",
    )
    val.add_argument(
        "--interval", type=float, default=0.95,
        help="central credible interval for the coverage metric",
    )
    val.add_argument(
        "--output", default=None, metavar="PATH",
        help="write the per-point LOO table (loo mean, loo variance, "
        "truth per observable; '#' header)",
    )
    val.add_argument("--dtype", choices=["float64", "float32"],
                     default="float64")
    val.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    val.add_argument(
        "--holdout", type=int, default=None, metavar="M",
        help="holdout validation instead of closed-form LOO: hold out M "
        "training points, rebuild the (matrix-free) serving state on the "
        "rest, predict the held-out block (combine with --matrix_free "
        "past dense memory)",
    )
    val.add_argument(
        "--matrix_free", action="store_true",
        help="never build dense factorizations; requires --holdout "
        "(closed-form LOO needs diag(C^-1), a dense-only quantity)",
    )
    val.add_argument("--seed", type=int, default=0,
                     help="holdout: seed of the held-out subset's draw")
    val.add_argument("--rank", type=int, default=64,
                     help="holdout: preconditioner rank")
    val.add_argument("--cg_tol", type=float, default=1e-6)
    val.add_argument("--cg_max_iters", type=int, default=256)

    des = sub.add_parser(
        "design",
        help="propose the next batch of simulator runs",
        description=(
            "Sequential experimental design over the trained emulator. "
            "--method=variance places runs at the emulator's largest "
            "normalized predictive variance (batch active learning); "
            "--method=nroy places a history-matching wave inside the "
            "not-ruled-out-yet region screened by the implausibility "
            "statistic against --experiment_file observations. Both pick "
            "a greedy weighted-maximin batch from a Latin-hypercube "
            "candidate pool scored in one batched predict. Points are "
            "written in natural parameter space, one row per run."
        ),
    )
    des.add_argument("state_file")
    des.add_argument(
        "--method", choices=["variance", "nroy"], default="variance")
    des.add_argument(
        "--experiment_file", default=None, metavar="PATH",
        help="observations for --method=nroy (calibrate's format)",
    )
    des.add_argument("--n_new", type=int, default=8,
                     help="batch size: number of runs to propose")
    des.add_argument("--pool_size", type=int, default=4096,
                     help="Latin-hypercube candidate pool size")
    des.add_argument(
        "--threshold", type=float, default=3.0,
        help="nroy: implausibility cutoff (3 = classic 3-sigma rule)",
    )
    des.add_argument("--seed", type=int, default=0)
    des.add_argument("--dtype", choices=["float64", "float32"],
                     default="float64")
    des.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    des.add_argument(
        "--output", default="-", metavar="PATH",
        help="proposed points destination ('-' = stdout)",
    )
    des.add_argument("--quiet", action="store_true")
    des.add_argument(
        "--matrix_free", action="store_true",
        help="score the candidate pool through the matrix-free (PCG) "
        "serving path instead of dense factorizations: the route at N "
        "past dense device memory",
    )
    des.add_argument("--rank", type=int, default=64,
                     help="matrix-free: preconditioner rank")
    des.add_argument("--cg_tol", type=float, default=1e-6)
    des.add_argument("--cg_max_iters", type=int, default=256)

    sen = sub.add_parser(
        "sensitivity",
        help="global sensitivity analysis (Sobol indices) of a trained "
        "emulator",
        description=(
            "Variance-based global sensitivity analysis over the trained "
            "emulator (models/sensitivity.py): Sobol first-order and total "
            "indices per input parameter (per observable), estimated from "
            "a Saltelli pick-freeze design: n*(d+2) batched emulator "
            "predictions, no simulator runs. Indices are fractions of "
            "output variance over the design box. Optionally also writes "
            "Oakley-O'Hagan main-effect curves (--main_effects)."
        ),
    )
    sen.add_argument("state_file")
    sen.add_argument("--n", type=int, default=4096,
                     help="Saltelli base-design size (n*(d+2) evaluations)")
    sen.add_argument("--seed", type=int, default=0)
    sen.add_argument("--dtype", choices=["float64", "float32"],
                     default="float64")
    sen.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    sen.add_argument(
        "--output", default="-", metavar="PATH",
        help="Sobol table destination ('-' = stdout): one row per "
        "(parameter, observable): first-order and total index",
    )
    sen.add_argument(
        "--main_effects", default=None, metavar="PATH",
        help="also write main-effect curves E[f | x_i = v]: one row per "
        "grid value v, columns = grid value then per (param, observable) "
        "curve",
    )
    sen.add_argument("--grid", type=int, default=33,
                     help="main-effects grid resolution")
    sen.add_argument("--effects_n", type=int, default=2048,
                     help="main-effects Monte Carlo samples per grid value")
    sen.add_argument("--query_chunk", type=int, default=4096)
    sen.add_argument("--quiet", action="store_true")
    return p


def _error(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 2


def cmd_estimate_thetas(args) -> int:
    import torch

    from madaiemulator_tpu_torch.io.modelfile import (
        is_multifidelity_model_file,
        read_gradients_file,
        read_model_file,
    )
    from madaiemulator_tpu_torch.io.snapshot import write_snapshot_auto
    from madaiemulator_tpu_torch.models.multivariate import (
        fit_multivariate,
        fit_multivariate_iterative,
    )
    from madaiemulator_tpu_torch.utils.config import (
        COVARIANCE_CLI_NAMES,
        GPConfig,
    )

    if args.inducing and (args.fit_method == "iterative" or args.alpha_grid):
        return _error("--inducing (sparse SGPR) excludes "
                      "--fit_method=iterative and --alpha_grid "
                      "(models/sparse.py)")
    if args.fit_method == "iterative" and args.gradients_file:
        return _error("--gradients_file needs --fit_method=dense (the "
                      "matrix-free engine has no joint value+gradient "
                      "operator)")
    if args.fit_method == "iterative" and args.alpha_grid:
        return _error("--alpha_grid needs --fit_method=dense (the alpha "
                      "profile runs the dense fit)")
    try:
        cov = COVARIANCE_CLI_NAMES[args.covariance_fn]
    except KeyError:
        return _error(f"unknown --covariance_fn={args.covariance_fn!r}; "
                      f"choose from {sorted(COVARIANCE_CLI_NAMES)}")
    alpha_grid = None
    if args.alpha_grid:
        try:
            alpha_grid = tuple(float(v) for v in args.alpha_grid.split(",")
                               if v)
        except ValueError:
            return _error(f"bad --alpha_grid={args.alpha_grid!r} "
                          "(expected comma-separated floats)")
    if args.device == "cuda" and not torch.cuda.is_available():
        return _error("CUDA device not available")
    try:
        if is_multifidelity_model_file(args.model_file):
            return _estimate_thetas_multifidelity(args, cov)
        mf = read_model_file(args.model_file)
    except (OSError, ValueError) as e:
        return _error(f"{args.model_file}: {e}")
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    dev = torch.device(args.device)
    noise = gradients = None
    if args.noise_file:
        raw = np.loadtxt(args.noise_file, dtype=np.float64)
        n, t = mf.npoints, mf.noutputs
        if raw.size not in (n, n * t):
            return _error(f"--noise_file has {raw.size} values; expected "
                          f"N={n} or N*t={n * t}")
        if float(np.min(raw)) < 0:
            return _error("--noise_file variances must be >= 0")
        noise = torch.tensor(raw.reshape(n) if raw.size == n
                             else raw.reshape(n, t), dtype=dtype, device=dev)
    if args.gradients_file:
        try:
            gradients = torch.tensor(
                read_gradients_file(args.gradients_file, mf.npoints,
                                    mf.nparams, mf.noutputs),
                dtype=dtype, device=dev)
        except ValueError as e:
            return _error(str(e))
    try:
        cfg = GPConfig(
            nparams=mf.nparams,
            covariance=cov,
            regression_order=args.regression_order,
            n_restarts=args.restarts,
            max_opt_steps=args.steps,
            cholesky_method=args.cholesky_method,
            gram_method=args.gram_method,
            cholesky_update_precision=args.update_precision,
            linesearch=args.linesearch,
        )
        X = torch.tensor(mf.X, dtype=dtype, device=dev)
        Y = torch.tensor(mf.Y, dtype=dtype, device=dev)
        gen = torch.Generator().manual_seed(args.seed)
        if args.inducing:
            return _estimate_sparse(args, mf, gen, X, Y, cfg, noise,
                                    gradients)
        if args.fit_method == "iterative":
            emu = fit_multivariate_iterative(
                gen, X, Y, cfg,
                pca_variance=args.pca_variance,
                rank=args.rank,
                probes=args.probes,
                lanczos_iters=args.lanczos_iters,
                cg_tol=args.cg_tol,
                cg_max_iters=args.cg_max_iters,
                seed=args.seed,
                vg_batch=args.vg_batch,
                logdet_method=args.logdet_method,
                checkpoint_path=args.checkpoint_path,
                noise=noise,
            )
        else:
            emu = fit_multivariate(
                gen, X, Y, cfg,
                pca_variance=args.pca_variance,
                restart_chunk=args.restart_chunk,
                alpha_grid=alpha_grid,
                alpha_refine=args.alpha_refine,
                noise=noise,
                gradients=gradients,
            )
    except ValueError as e:
        # e.g. --gradients_file with a once-differentiable kernel
        return _error(str(e))
    if not args.quiet:
        lls = emu.restart_log_likelihoods.detach().cpu().double().numpy()
        for i in range(emu.n_components):
            best = np.nanmax(np.where(np.isfinite(lls[i]), lls[i], np.nan))
            print(
                f"component {i}: best logL = {best:.6g} "
                f"({np.isfinite(lls[i]).sum()}/{lls.shape[1]} restarts finite)",
                file=sys.stderr,
            )
    write_snapshot_auto(args.state_file, emu, param_names=mf.param_names,
                        output_names=mf.output_names)
    if not args.quiet:
        print(
            f"wrote {args.state_file}: {emu.n_components} component(s), "
            f"N={mf.npoints}, d={mf.nparams}, t={mf.noutputs}",
            file=sys.stderr,
        )
    return 0


def _estimate_thetas_multifidelity(args, cov) -> int:
    """estimate_thetas on a MULTIFIDELITY model file: AR(1) co-kriging over
    the levels (models/multifidelity.py; multivariate with one shared PCA
    basis when the file has a `noutputs` header), then the multi-fidelity
    snapshot."""
    import torch

    from madaiemulator_tpu_torch.io.modelfile import (
        read_multifidelity_model_file,
    )
    from madaiemulator_tpu_torch.io.snapshot import write_snapshot_auto
    from madaiemulator_tpu_torch.models.multifidelity import (
        fit_multifidelity,
        fit_multivariate_multifidelity,
    )
    from madaiemulator_tpu_torch.utils.config import GPConfig

    if args.fit_method == "iterative":
        return _error("multi-fidelity training is dense per level (the "
                      "expensive levels are small by construction); drop "
                      "--fit_method=iterative")
    # flags the MF route cannot honor fail fast: a single --noise_file
    # cannot express per-level noise (the library API takes it per level)
    unsupported = [name for name, val in (
        ("--noise_file", args.noise_file),
        ("--gradients_file", args.gradients_file),
        ("--alpha_grid", args.alpha_grid),
        ("--inducing", args.inducing)) if val]
    if unsupported:
        return _error(f"{', '.join(unsupported)} not supported with "
                      "MULTIFIDELITY model files (per-level noise and the "
                      "other modalities go through the library API, "
                      "models/multifidelity.py)")
    try:
        mf = read_multifidelity_model_file(args.model_file)
    except ValueError as e:
        return _error(f"bad multi-fidelity model file: {e}")
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    dev = torch.device(args.device)

    def t(a):
        return None if a is None else torch.tensor(a, dtype=dtype, device=dev)

    cfg = GPConfig(
        nparams=mf.nparams,
        covariance=cov,
        regression_order=args.regression_order,
        n_restarts=args.restarts,
        max_opt_steps=args.steps,
        cholesky_method=args.cholesky_method,
        gram_method=args.gram_method,
        cholesky_update_precision=args.update_precision,
        linesearch=args.linesearch,
    )
    gen = torch.Generator().manual_seed(args.seed)
    designs = [t(X) for X in mf.designs]
    targets = [t(Y) for Y in mf.targets]
    lower = [t(lv) for lv in mf.lower_values]
    if mf.noutputs > 1:
        emu = fit_multivariate_multifidelity(
            gen, designs, targets, cfg, pca_variance=args.pca_variance,
            lower_values=lower, restart_chunk=args.restart_chunk)
        names = mf.output_names
        desc = (f"{emu.n_levels} fidelity level(s), d={mf.nparams}, "
                f"t={emu.n_outputs} -> r={emu.n_components} components")
    else:
        emu = fit_multifidelity(gen, designs, targets, cfg,
                                lower_values=lower,
                                restart_chunk=args.restart_chunk)
        names = [mf.output_name]
        desc = f"{emu.n_levels} fidelity level(s), d={mf.nparams}"
    if not args.quiet:
        for k, lv in enumerate(emu.levels):
            n_k = (lv.X if mf.noutputs > 1 else lv.data.X).shape[0]
            rho = ""
            if k > 0:
                r = lv.rho.detach().cpu().double().numpy()
                rho = (f", rho={np.array2string(r, precision=6)}"
                       if mf.noutputs > 1 else f", rho={float(r):.6g}")
            print(f"level {k}: N={n_k}{rho}", file=sys.stderr)
    write_snapshot_auto(args.state_file, emu, param_names=mf.param_names,
                        output_names=names)
    if not args.quiet:
        print(f"wrote {args.state_file}: {desc}", file=sys.stderr)
    return 0


def _estimate_sparse(args, mf, gen, X, Y, cfg, noise, gradients) -> int:
    """estimate_thetas --inducing: the sparse multivariate fit (one SGPR
    per PC on a shared inducing set) -> the sparse snapshot."""
    from madaiemulator_tpu_torch.io.snapshot import write_snapshot_auto
    from madaiemulator_tpu_torch.models.sparse import fit_multivariate_sparse

    emu = fit_multivariate_sparse(
        gen, X, Y, cfg,
        pca_variance=args.pca_variance,
        inducing=args.inducing,
        inducing_opt_steps=args.inducing_opt_steps,
        restart_chunk=args.restart_chunk,
        row_chunk=args.row_chunk,
        noise=noise,
        gradients=gradients,
    )
    write_snapshot_auto(args.state_file, emu, param_names=mf.param_names,
                        output_names=mf.output_names)
    if not args.quiet:
        print(
            f"wrote {args.state_file}: sparse (SGPR), "
            f"{emu.n_components} component(s), m={emu.Z.shape[0]} "
            f"inducing, N={mf.npoints}, d={mf.nparams}, t={mf.noutputs}",
            file=sys.stderr,
        )
    return 0


def _read_container(path: str):
    """(emulator, param names, output names) of a snapshot (text or .npz),
    on the CPU in float64: the matrix-free container, which skips the
    serve-time factorizations, or for a gradient-enhanced (version 3)
    snapshot, which has none, the dense emulator (joint systems are small
    by construction), as the JAX CLI's convert does; a sparse snapshot is
    its serve state, a multi-fidelity one its levels with their states
    rebuilt (small by construction)."""
    import torch

    from madaiemulator_tpu_torch.io.snapshot import read_snapshot_auto

    cpu = torch.device("cpu")
    try:
        return read_snapshot_auto(path, device=cpu, dtype=torch.float64,
                                  build_states=False)
    except ValueError:
        return read_snapshot_auto(path, device=cpu, dtype=torch.float64)


def _print_thetas_multifidelity(emu) -> None:
    """print_thetas of a multi-fidelity snapshot: every level's thetas and,
    from level 1 on, its rho (per component when multivariate)."""
    from madaiemulator_tpu_torch.models.multifidelity import (
        MultivariateMultiFidelityEmulator,
    )

    def nat(a):
        return np.exp(a.detach().cpu().numpy())

    if isinstance(emu, MultivariateMultiFidelityEmulator):
        print(f"# {emu.n_levels} fidelity level(s) x {emu.n_components} "
              "component(s); thetas = [amp nugget length_scales...] "
              "(+ rho for levels >= 1)")
        for k, lv in enumerate(emu.levels):
            amp, nug, ls = (nat(a) for a in lv.params)
            rho = lv.rho.detach().cpu().numpy()
            for i in range(amp.shape[0]):
                line = (f"level {k} component {i}  "
                        + " ".join(f"{v:.17g}"
                                   for v in [amp[i], nug[i], *ls[i]]))
                if k > 0:
                    line += f"  rho {rho[i]:.17g}"
                print(line)
        return
    print(f"# {emu.n_levels} fidelity level(s); thetas = "
          "[amp nugget length_scales...] (+ rho for levels >= 1)")
    for k, lv in enumerate(emu.levels):
        amp, nug, ls = (nat(a) for a in lv.params)
        line = " ".join(f"{v:.17g}" for v in [float(amp), float(nug),
                                              *ls.ravel()])
        if k > 0:
            line += f"  rho {float(lv.rho):.17g}"
        print(line)


def cmd_print_thetas(args) -> int:
    from madaiemulator_tpu_torch.models.multifidelity import is_multifidelity

    try:
        emu, _, _ = _read_container(args.state_file)
    except (OSError, ValueError) as e:
        return _error(f"{args.state_file}: {e}")
    if is_multifidelity(emu):
        _print_thetas_multifidelity(emu)
        return 0
    amp = np.exp(emu.params.log_amp.numpy())
    nug = np.exp(emu.params.log_nugget.numpy())
    ls = np.exp(emu.params.log_ls.numpy())
    print(f"# {emu.n_components} component(s); thetas = "
          "[amp nugget length_scales...]")
    for i in range(emu.n_components):
        row = [amp[i], nug[i], *ls[i]]
        print(" ".join(f"{v:.17g}" for v in row))
    return 0


def cmd_convert(args) -> int:
    from madaiemulator_tpu_torch.io.snapshot import write_snapshot_auto
    from madaiemulator_tpu_torch.models.multifidelity import (
        MultiFidelityEmulator,
        MultivariateMultiFidelityEmulator,
    )
    from madaiemulator_tpu_torch.models.sparse import is_sparse

    try:
        emu, param_names, output_names = _read_container(args.in_state)
    except (OSError, ValueError) as e:
        return _error(f"{args.in_state}: {e}")
    write_snapshot_auto(args.out_state, emu, param_names=param_names,
                        output_names=output_names)
    if isinstance(emu, MultivariateMultiFidelityEmulator):
        desc = (f"{emu.n_levels} fidelity level(s), "
                f"d={emu.levels[0].X.shape[1]}, t={emu.n_outputs} "
                f"-> r={emu.n_components} components")
    elif isinstance(emu, MultiFidelityEmulator):
        desc = (f"{emu.n_levels} fidelity level(s), "
                f"d={emu.levels[0].data.X.shape[1]}")
    elif is_sparse(emu):
        desc = (f"sparse (SGPR), {emu.n_components} component(s), "
                f"m={emu.Z.shape[0]} inducing, d={emu.Z.shape[1]}, "
                f"t={len(output_names)}")
    else:
        desc = (f"{emu.n_components} component(s), N={emu.X.shape[0]}, "
                f"d={emu.X.shape[1]}, t={len(output_names)}")
    print(f"wrote {args.out_state}: {desc}", file=sys.stderr)
    return 0


def cmd_interactive_mode(args) -> int:
    import torch

    from madaiemulator_tpu_torch.io.snapshot import read_snapshot_auto
    from madaiemulator_tpu_torch.models.multifidelity import (
        MultivariateMultiFidelityEmulator,
        is_multifidelity,
        predict_multifidelity,
        predict_multivariate_multifidelity,
    )
    from madaiemulator_tpu_torch.models.multivariate import (
        precompute_fast_multivariate,
        precompute_iterative_multivariate,
        predict_multivariate,
        predict_multivariate_fast,
        predict_multivariate_iterative,
    )
    from madaiemulator_tpu_torch.models.sparse import (
        is_sparse,
        predict_multivariate_sparse,
    )

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: CUDA device not available", file=sys.stderr)
        return 2
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    iterative = args.serve_method == "iterative"
    try:
        emu, param_names, output_names = read_snapshot_auto(
            args.state_file, device=torch.device(args.device), dtype=dtype,
            build_states=not iterative,
        )
    except ValueError as e:
        # e.g. a gradient-enhanced (v3) snapshot asked to serve iteratively
        print(f"error: {e}", file=sys.stderr)
        return 2
    predict = predict_multivariate
    if is_multifidelity(emu):
        if args.serve_method != "dense":
            print(
                "error: multi-fidelity snapshots serve dense only "
                "(per-level cross-covariance GEMM + TRSMs); drop "
                f"--serve_method={args.serve_method}",
                file=sys.stderr,
            )
            return 2
        if isinstance(emu, MultivariateMultiFidelityEmulator):
            predict = predict_multivariate_multifidelity
        else:
            def predict(e, q):
                mean, var = predict_multifidelity(e, q)
                return mean[:, None], var[:, None]  # scalar -> (m, 1)
    elif is_sparse(emu):
        if args.serve_method != "dense":
            print(
                "error: sparse (SGPR) snapshots already serve from an "
                "O(m^2) state — there is no fast/iterative variant; drop "
                f"--serve_method={args.serve_method}",
                file=sys.stderr,
            )
            return 2
        predict = predict_multivariate_sparse
    elif iterative:
        # the serving cache (preconditioners + training solves), built once
        iter_states = precompute_iterative_multivariate(
            emu, rank=args.rank, cg_tol=args.cg_tol,
            cg_max_iters=args.cg_max_iters)

        def predict(e, q):
            return predict_multivariate_iterative(
                e, q, states=iter_states,
                variance_method=args.variance_method,
                query_chunk=args.query_chunk,
                variance_rhs=args.variance_rhs)
    elif args.serve_method == "fast":
        try:
            fast_states = precompute_fast_multivariate(emu)
        except ValueError as e:
            # gradient-enhanced snapshots have no GEMM-only path
            print(f"error: {e}", file=sys.stderr)
            return 2

        def predict(e, q):
            return predict_multivariate_fast(e, fast_states, q)
    d = len(param_names)
    out = sys.stdout
    # header: expected inputs, then produced outputs
    out.write(f"{d}\n")
    for s in param_names:
        out.write(f"{s}\n")
    out.write(f"{2 * len(output_names)}\n")
    for s in output_names:
        out.write(f"mean_{s}\n")
    for s in output_names:
        out.write(f"variance_{s}\n")
    out.flush()

    fd = sys.stdin.fileno()

    def _drain_available(buf: bytes, eof: bool):
        """Read whatever is already readable without blocking."""
        while not eof:
            r, _, _ = select.select([fd], [], [], 0)
            if not r:
                break
            chunk = os.read(fd, 1 << 16)
            if not chunk:
                eof = True
                break
            buf += chunk
        return buf, eof

    def _predict_batch(pts: np.ndarray) -> np.ndarray:
        """(m, d) -> (m, 2t) [means | variances], MAX_BATCH points a call."""
        rows = []
        for i in range(0, pts.shape[0], MAX_BATCH):
            mean, var = predict(emu, pts[i:i + MAX_BATCH])
            rows.append(torch.cat([mean, var], dim=1).cpu().numpy())
        return np.concatenate(rows, axis=0)

    toks: List[str] = []
    buf = b""
    eof = False
    while True:
        if not eof:
            # block for at least one byte, then drain the rest
            chunk = os.read(fd, 1 << 16)
            if not chunk:
                eof = True
            else:
                buf = buf + chunk
                buf, eof = _drain_available(buf, eof)
        # split tokens; a trailing partial token stays in the byte buffer
        text = buf.decode()
        if not eof and text and not text[-1].isspace():
            cut = max(
                (text.rfind(c) for c in (" ", "\t", "\n", "\r")), default=-1
            )
            text, buf = text[: cut + 1], text[cut + 1 :].encode()
        else:
            buf = b""
        toks.extend(text.split())
        n_pts = len(toks) // d
        if n_pts:
            flat, toks = toks[: n_pts * d], toks[n_pts * d :]
            try:
                pts = np.asarray(
                    [float(v) for v in flat], dtype=np.float64
                ).reshape(n_pts, d)
            except ValueError as e:
                print(f"error: bad query token: {e}", file=sys.stderr)
                return 1
            vals = _predict_batch(pts)  # (n_pts, 2t)
            out.write("\n".join(f"{v:.17g}" for v in vals.ravel()) + "\n")
            out.flush()
        if eof and not buf:
            break
    if toks:
        print(
            f"warning: {len(toks)} trailing token(s) ignored (partial point)",
            file=sys.stderr,
        )
    return 0


def _write_table(path: str, head: str, names: List[str], cols) -> None:
    """The per-point table of `validate --output`: a '#' header naming the
    mean, variance and truth columns of every observable, then one row per
    point, "%.17g"."""
    labels = [f"{k}_{s}" for k in cols for s in names]
    arrays = [np.asarray(a.detach().cpu() if hasattr(a, "detach") else a)
              for a in cols.values()]
    with open(path, "w") as f:
        f.write(f"# {head}: " + " ".join(labels) + "\n")
        for i in range(arrays[0].shape[0]):
            row = np.concatenate([a[i] for a in arrays])
            f.write(" ".join(f"{v:.17g}" for v in row) + "\n")


def _validate_sparse(emu, output_names, args, dtype, dev) -> int:
    """Training-residual validation of a sparse (SGPR) snapshot against
    --model_file: the O(m^2) serve state keeps no training arrays, and an
    SGPR posterior has m << N effective degrees of freedom, so its training
    residuals measure real out-of-subspace error (its Titsias variance is
    conservative: coverage should sit at or above target)."""
    import torch

    from madaiemulator_tpu_torch.io.modelfile import read_model_file
    from madaiemulator_tpu_torch.models.diagnostics import (
        training_residuals_sparse,
        validation_summary,
    )

    if args.holdout is not None or args.matrix_free:
        return _error(
            "--holdout/--matrix_free do not apply to sparse (SGPR) "
            "snapshots — the serve state cannot be rebuilt on a subset "
            "(no training arrays); refit with fit_multivariate_sparse on "
            "the held-in subset instead")
    if args.model_file is None:
        return _error(
            "validating a sparse snapshot requires --model_file (the O(m^2) "
            "serve state carries no training outputs to score against)")
    mf = read_model_file(args.model_file)
    if mf.Y.shape[1] != len(output_names):
        return _error(f"model file holds {mf.Y.shape[1]} outputs but the "
                      f"snapshot serves {len(output_names)}")
    if mf.X.shape[1] != emu.Z.shape[1]:
        return _error(
            f"model file has {mf.X.shape[1]} parameters but the snapshot's "
            f"inducing points live in {emu.Z.shape[1]} dimensions — wrong "
            "model file for this snapshot")
    mean, var = training_residuals_sparse(
        emu, torch.tensor(mf.X, dtype=dtype, device=dev))
    Y_true = torch.tensor(mf.Y, dtype=dtype)
    s = validation_summary(mean, var, Y_true, interval=args.interval)
    m = emu.Z.shape[0]
    print(f"# sparse training-residual validation (SGPR, m={m} inducing "
          f"points — residuals measure out-of-subspace error; variance "
          f"is the conservative Titsias bound): N={mf.X.shape[0]}, "
          f"t={len(output_names)}, r={emu.n_components}")
    for k, v in s.items():
        print(f"{k} {v:.17g}")
    if args.output is not None:
        _write_table(args.output, "per-point sparse training residuals",
                     output_names, {"mean": mean, "variance": var,
                                    "true": Y_true})
    return 0


def _validate_multifidelity(emu, output_names, args) -> int:
    """Per-level closed-form LOO of a multi-fidelity snapshot: each level is
    an ordinary GP with the lower level's values as one GLS basis column,
    so the identity applies level by level with that column held fixed
    (models/diagnostics.py loo_cv_multifidelity[_mv]); a multivariate one
    is summarized in observable space against the shared-PCA
    representation of each level's stored targets."""
    from madaiemulator_tpu_torch.models.diagnostics import (
        loo_cv_multifidelity,
        loo_cv_multifidelity_mv,
        reconstruct_level_targets_mv,
        validation_summary,
    )
    from madaiemulator_tpu_torch.models.multifidelity import (
        MultivariateMultiFidelityEmulator,
    )

    if args.holdout is not None or args.matrix_free:
        return _error(
            "--holdout/--matrix_free do not apply to multi-fidelity "
            "snapshots (every level is small and dense by construction); "
            "per-level closed-form LOO is the validation route")
    mv = isinstance(emu, MultivariateMultiFidelityEmulator)
    if args.model_file is not None:
        return _error(
            "--model_file is not supported for multi-fidelity snapshots ("
            + ("levels are validated against the targets stored in the "
               "snapshot)" if mv else
               "levels are scalar-output and validated in their own target "
               "units against the level data stored in the snapshot)"))
    rows = []
    if mv:
        for k, (res, loo_mean, loo_var) in enumerate(
                loo_cv_multifidelity_mv(emu)):
            if not bool(res.ok.all()):
                print(f"error: level {k} has component(s) with no valid "
                      "factorization", file=sys.stderr)
                return 1
            Y_true = reconstruct_level_targets_mv(emu, k)
            s = validation_summary(loo_mean, loo_var, Y_true,
                                   interval=args.interval)
            print(f"# level {k} LOO validation (observable space vs "
                  f"retained-PCA reconstruction, lower-level basis columns "
                  f"held fixed): N={emu.levels[k].X.shape[0]}, "
                  f"t={emu.n_outputs}, r={emu.n_components}")
            for key, v in s.items():
                print(f"level{k}_{key} {v:.17g}")
            rows.append((k, loo_mean, loo_var, Y_true))
        head = ("# per-point LOO by level: level "
                + " ".join(f"loo_mean_{s_}" for s_ in output_names) + " "
                + " ".join(f"loo_variance_{s_}" for s_ in output_names)
                + " " + " ".join(f"true_{s_}" for s_ in output_names))
    else:
        for k, (res, lv) in enumerate(zip(loo_cv_multifidelity(emu),
                                          emu.levels)):
            if not bool(res.ok):
                print(f"error: level {k} has no valid factorization",
                      file=sys.stderr)
                return 1
            s = validation_summary(res.mean, res.variance, lv.data.y,
                                   interval=args.interval)
            print(f"# level {k} LOO validation (target units y_{k}, "
                  f"lower-level basis column held fixed): "
                  f"N={lv.data.y.shape[0]}")
            for key, v in s.items():
                print(f"level{k}_{key} {v:.17g}")
            rows.append((k, res.mean[:, None], res.variance[:, None],
                         lv.data.y[:, None]))
        head = "# per-point LOO by level: level loo_mean loo_variance true"
    if args.output is not None:
        with open(args.output, "w") as f:
            f.write(head + "\n")
            for k, *cols in rows:
                cols = [c.detach().cpu().numpy() for c in cols]
                for i in range(cols[0].shape[0]):
                    row = np.concatenate([c[i] for c in cols])
                    f.write(f"{k} " + " ".join(f"{v:.17g}" for v in row)
                            + "\n")
    return 0


def cmd_validate(args) -> int:
    import torch

    from madaiemulator_tpu_torch.io.modelfile import read_model_file
    from madaiemulator_tpu_torch.io.snapshot import read_snapshot_auto
    from madaiemulator_tpu_torch.models.diagnostics import (
        holdout_cv_multivariate,
        loo_cv_multivariate,
        reconstruct_training_outputs,
        validation_summary,
    )
    from madaiemulator_tpu_torch.models.multifidelity import is_multifidelity
    from madaiemulator_tpu_torch.models.sparse import is_sparse

    if args.matrix_free and args.holdout is None:
        return _error("--matrix_free requires --holdout M (closed-form LOO "
                      "needs diag(C^-1), a dense-only quantity)")
    if args.device == "cuda" and not torch.cuda.is_available():
        return _error("CUDA device not available")
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    dev = torch.device(args.device)
    try:
        emu, param_names, output_names = read_snapshot_auto(
            args.state_file, device=dev, dtype=dtype,
            build_states=not args.matrix_free)
    except ValueError as e:
        # a gradient-enhanced (v3) snapshot with --matrix_free
        return _error(str(e))
    if is_multifidelity(emu):
        return _validate_multifidelity(emu, output_names, args)
    if is_sparse(emu):
        return _validate_sparse(emu, output_names, args, dtype, dev)
    Y_true = None
    if args.model_file is not None:
        mf = read_model_file(args.model_file)
        if mf.Y.shape != (emu.X.shape[0], len(output_names)):
            return _error(
                f"model file holds {mf.Y.shape} outputs but the snapshot "
                f"was trained on {(emu.X.shape[0], len(output_names))}")
        Y_true = torch.tensor(mf.Y, dtype=dtype, device=dev)
    try:
        if args.holdout is not None:
            idx, loo_mean, loo_var = holdout_cv_multivariate(
                emu, torch.Generator().manual_seed(args.seed), args.holdout,
                rank=args.rank, cg_tol=args.cg_tol,
                cg_max_iters=args.cg_max_iters)
        else:
            idx = None
            res, loo_mean, loo_var = loo_cv_multivariate(emu)
            ok = res.ok.cpu().numpy()
            if not ok.all():
                raise ValueError(
                    f"component(s) {np.flatnonzero(~ok).tolist()} have no "
                    "valid factorization")
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if Y_true is None:
        Y_true = reconstruct_training_outputs(emu)
    if idx is not None:
        Y_true = Y_true[torch.tensor(idx, device=Y_true.device)]
    s = validation_summary(loo_mean, loo_var, Y_true, interval=args.interval)
    basis = ("raw training outputs (incl. PCA truncation error)"
             if args.model_file is not None
             else "retained-PCA reconstruction (GP error only)")
    kind = (f"holdout({args.holdout}) validation" if idx is not None
            else "LOO validation")
    print(f"# {kind} vs {basis}: N={emu.X.shape[0]}, "
          f"t={len(output_names)}, r={emu.n_components}")
    for k, v in s.items():
        print(f"{k} {v:.17g}")
    if args.output is not None:
        _write_table(args.output, "per-point LOO", output_names,
                     {"loo_mean": loo_mean, "loo_variance": loo_var,
                      "true": Y_true})
    return 0


def cmd_calibrate(args) -> int:
    import torch

    from madaiemulator_tpu_torch.io.experiment import read_experiment_file
    from madaiemulator_tpu_torch.io.snapshot import read_snapshot_auto
    from madaiemulator_tpu_torch.models.calibrate import calibrate
    from madaiemulator_tpu_torch.models.multifidelity import is_multifidelity
    from madaiemulator_tpu_torch.models.sparse import is_sparse

    if args.device == "cuda" and not torch.cuda.is_available():
        return _error("CUDA device not available")
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    dev = torch.device(args.device)
    try:
        emu, param_names, output_names = read_snapshot_auto(
            args.state_file, device=dev, dtype=dtype,
            build_states=not args.matrix_free)
    except ValueError as e:
        # e.g. a gradient-enhanced (v3) snapshot with --matrix_free
        return _error(str(e))
    if is_sparse(emu) and args.matrix_free:
        return _error("sparse (SGPR) snapshots already calibrate against "
                      "the O(m^2) serve state; drop --matrix_free")
    if is_multifidelity(emu) and args.matrix_free:
        return _error("multi-fidelity snapshots calibrate through the "
                      "recursive dense predict (levels are small by "
                      "construction); drop --matrix_free")
    states = None
    if args.matrix_free:
        from madaiemulator_tpu_torch.models.multivariate import (
            precompute_iterative_multivariate,
        )

        states = precompute_iterative_multivariate(
            emu, rank=args.rank, cg_tol=args.cg_tol,
            cg_max_iters=args.cg_max_iters)
    try:
        y_exp, exp_var = read_experiment_file(args.experiment_file)
    except ValueError as e:
        return _error(f"bad experiment file: {e}")
    if y_exp.shape[0] != len(output_names):
        return _error(f"experiment file has {y_exp.shape[0]} observable(s) "
                      f"but the snapshot produces {len(output_names)}")
    try:
        res = calibrate(
            torch.Generator(device=dev).manual_seed(args.seed), emu, y_exp,
            exp_var, n_walkers=args.n_walkers, n_steps=args.n_steps,
            burn_in=args.burn_in, thin=args.thin, sampler=args.sampler,
            discrepancy=args.discrepancy, states=states)
    except ValueError as e:
        return _error(str(e))
    s = res.summary()
    if not args.quiet:
        print(f"calibrate: {res.samples.shape[0] * res.samples.shape[1]} "
              f"draws ({res.samples.shape[1]} walkers x "
              f"{res.samples.shape[0]} kept steps), acceptance "
              f"{res.acceptance:.3f}", file=sys.stderr)
        for j, name in enumerate(param_names):
            print(f"  {name}: {s['mean'][j]:.6g} +- {s['std'][j]:.3g}  "
                  f"[{s['q05'][j]:.6g}, {s['q95'][j]:.6g}]  "
                  f"rhat={res.rhat[j]:.3f} ess={res.ess[j]:.0f}",
                  file=sys.stderr)
        if res.discrepancy is not None:
            dflat = res.discrepancy.reshape(-1)
            print(f"  discrepancy scale (x output std): "
                  f"{dflat.mean():.4g} +- {dflat.std():.3g}  "
                  f"[{np.quantile(dflat, 0.05):.4g}, "
                  f"{np.quantile(dflat, 0.95):.4g}]  "
                  f"rhat={res.rhat[-1]:.3f} ess={res.ess[-1]:.0f}",
                  file=sys.stderr)
        if res.rhat.max() > 1.1:
            print("warning: max R-hat > 1.1 — chains may not have "
                  "converged; increase --n_steps", file=sys.stderr)
    flat = res.samples.reshape(-1, res.samples.shape[-1])
    dest = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        dest.write("# posterior samples: " + " ".join(param_names) + "\n")
        for row in flat:
            dest.write(" ".join(f"{v:.17g}" for v in row) + "\n")
    finally:
        if dest is not sys.stdout:
            dest.close()
    return 0


def _write_rows(dest_path: str, head: str, rows) -> None:
    """A '#' header line, then one "%.17g" row a point, to dest_path ('-' =
    stdout)."""
    dest = sys.stdout if dest_path == "-" else open(dest_path, "w")
    try:
        dest.write(head + "\n")
        for row in rows:
            dest.write(" ".join(f"{v:.17g}" for v in row) + "\n")
    finally:
        if dest is not sys.stdout:
            dest.close()


def cmd_design(args) -> int:
    import torch

    from madaiemulator_tpu_torch.io.experiment import read_experiment_file
    from madaiemulator_tpu_torch.io.snapshot import read_snapshot_auto
    from madaiemulator_tpu_torch.models.design import (
        active_variance_design,
        nroy_wave_design,
    )
    from madaiemulator_tpu_torch.models.multifidelity import is_multifidelity
    from madaiemulator_tpu_torch.models.sparse import is_sparse

    if args.device == "cuda" and not torch.cuda.is_available():
        return _error("CUDA device not available")
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    try:
        emu, param_names, output_names = read_snapshot_auto(
            args.state_file, device=torch.device(args.device), dtype=dtype,
            build_states=not args.matrix_free)
    except ValueError as e:
        # e.g. a gradient-enhanced (v3) snapshot with --matrix_free
        return _error(str(e))
    if is_multifidelity(emu) and args.matrix_free:
        return _error("multi-fidelity snapshots screen pools through the "
                      "recursive dense predict (levels are small by "
                      "construction); drop --matrix_free")
    if is_sparse(emu) and args.matrix_free:
        return _error("sparse (SGPR) snapshots already screen pools against "
                      "the O(m^2) serve state; drop --matrix_free")
    iter_kwargs = (dict(rank=args.rank, cg_tol=args.cg_tol,
                        cg_max_iters=args.cg_max_iters)
                   if args.matrix_free else {})
    gen = torch.Generator().manual_seed(args.seed)
    if args.method == "nroy":
        if args.experiment_file is None:
            return _error("--method=nroy needs --experiment_file (the "
                          "observations that define implausibility)")
        try:
            y_exp, exp_var = read_experiment_file(args.experiment_file)
        except ValueError as e:
            return _error(f"bad experiment file: {e}")
        if y_exp.shape[0] != len(output_names):
            return _error(f"experiment file has {y_exp.shape[0]} "
                          f"observable(s) but the snapshot produces "
                          f"{len(output_names)}")
        prop = nroy_wave_design(
            gen, emu, y_exp, exp_var, n_new=args.n_new,
            threshold=args.threshold, pool_size=args.pool_size,
            **iter_kwargs)
        if not args.quiet:
            print(f"design: NROY wave, "
                  f"{100.0 * prop.pool_fraction_viable:.2f}% of the "
                  f"{args.pool_size}-point pool not ruled out at I <= "
                  f"{args.threshold:g}", file=sys.stderr)
            if prop.pool_fraction_viable == 0.0:
                print("warning: nothing in the pool is viable — the wave "
                      "has converged or the threshold is tight; proposing "
                      "least-implausible points instead", file=sys.stderr)
    else:
        prop = active_variance_design(gen, emu, n_new=args.n_new,
                                      pool_size=args.pool_size,
                                      **iter_kwargs)
        if not args.quiet:
            print(f"design: active-variance batch of {args.n_new} from a "
                  f"{args.pool_size}-point pool", file=sys.stderr)
    _write_rows(args.output, "# proposed runs: " + " ".join(param_names),
                prop.points)
    return 0


def _sensitivity_fn(emu):
    """(predict_fn over the scaled cube -> (m, t) means, d) of any emulator
    kind a snapshot holds."""
    from madaiemulator_tpu_torch.models.multifidelity import (
        MultiFidelityEmulator,
        MultivariateMultiFidelityEmulator,
        predict_multifidelity,
        predict_multivariate_multifidelity,
    )
    from madaiemulator_tpu_torch.models.sensitivity import (
        multivariate_mean_fn,
    )
    from madaiemulator_tpu_torch.models.sparse import (
        is_sparse,
        predict_multivariate_sparse,
    )
    from madaiemulator_tpu_torch.utils.designs import unapply_scaling

    if isinstance(emu, MultivariateMultiFidelityEmulator):
        def fn(Xs):
            return predict_multivariate_multifidelity(
                emu, unapply_scaling(Xs, emu.scaling))[0]

        return fn, emu.levels[0].X.shape[1]
    if isinstance(emu, MultiFidelityEmulator):
        def fn(Xs):
            return predict_multifidelity(
                emu, unapply_scaling(Xs, emu.scaling))[0][:, None]

        return fn, emu.levels[0].data.X.shape[1]
    if is_sparse(emu):
        def fn(Xs):
            return predict_multivariate_sparse(
                emu, unapply_scaling(Xs, emu.scaling))[0]

        return fn, emu.Z.shape[1]
    return multivariate_mean_fn(emu), emu.X.shape[1]


def cmd_sensitivity(args) -> int:
    import torch

    from madaiemulator_tpu_torch.io.snapshot import read_snapshot_auto
    from madaiemulator_tpu_torch.models.sensitivity import (
        main_effects,
        sobol_indices,
    )

    if args.device == "cuda" and not torch.cuda.is_available():
        return _error("CUDA device not available")
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    dev = torch.device(args.device)
    emu, param_names, output_names = read_snapshot_auto(
        args.state_file, device=dev, dtype=dtype)
    predict_fn, d = _sensitivity_fn(emu)
    res = sobol_indices(predict_fn, d, torch.Generator().manual_seed(
        args.seed), n=args.n, query_chunk=args.query_chunk, dtype=dtype,
        device=dev)
    first = res.first.cpu().numpy()  # (d,) or (d, t)
    total = res.total.cpu().numpy()
    if first.ndim == 1:
        first, total = first[:, None], total[:, None]
    if not args.quiet:
        print(f"sensitivity: Sobol indices from an n={args.n} Saltelli "
              f"design ({args.n * (d + 2)} emulator evaluations); "
              f"interactions = total - first", file=sys.stderr)
        for j, name in enumerate(param_names):
            print(f"  {name}: max total index {float(np.max(total[j])):.3f} "
                  f"across {first.shape[1]} observable(s)", file=sys.stderr)
    dest = sys.stdout if args.output == "-" else open(args.output, "w")
    try:
        dest.write("# Sobol indices: param observable first total\n")
        for j, name in enumerate(param_names):
            for u, out_name in enumerate(output_names):
                dest.write(f"{name} {out_name} {first[j, u]:.17g} "
                           f"{total[j, u]:.17g}\n")
    finally:
        if dest is not sys.stdout:
            dest.close()
    if args.main_effects is not None:
        gv, eff = main_effects(
            predict_fn, d, torch.Generator().manual_seed(args.seed + 1),
            grid=args.grid, n=args.effects_n, query_chunk=args.query_chunk,
            dtype=dtype, device=dev)
        gv, eff = gv.cpu().numpy(), eff.cpu().numpy()
        if eff.ndim == 2:
            eff = eff[:, :, None]  # (d, grid, t)
        cols = " ".join(f"{p}:{o}" for p in param_names for o in output_names)
        _write_rows(args.main_effects,
                    "# main effects E[f | x_i = v], x_i scaled to [0,1]: "
                    f"v {cols}",
                    ([gv[g], *eff[:, g, :].reshape(-1)]
                     for g in range(len(gv))))
        if not args.quiet:
            print(f"wrote main-effect curves to {args.main_effects}",
                  file=sys.stderr)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    commands = {
        "estimate_thetas": cmd_estimate_thetas,
        "interactive_mode": cmd_interactive_mode,
        "print_thetas": cmd_print_thetas,
        "convert": cmd_convert,
        "validate": cmd_validate,
        "calibrate": cmd_calibrate,
        "design": cmd_design,
        "sensitivity": cmd_sensitivity,
    }
    try:
        return commands[args.command](args)
    except BrokenPipeError:
        # the pipe consumer went away: the conventional quiet SIGPIPE exit
        try:
            sys.stdout.close()
        except BrokenPipeError:
            pass
        return 141


if __name__ == "__main__":
    sys.exit(main())
