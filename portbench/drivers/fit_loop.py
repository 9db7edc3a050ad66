"""Closed loop of whole fits: one fit after another through the port's fit
entry, for the whole window.

The configuration's "fit" names the entry, one of ENTRIES (another name
is refused): "fit_gp_host" (`models.fit.fit_gp_host`, one design, R
restarts in one batch) or "fit_ensemble" (`parallel.ensemble.fit_ensemble`,
E members x R restarts as one lock-step batch). The k-th fit of a run draws its starts from the
stream (seed, STARTS, k), and the data come from the seed. A traffic file
may fix either for every seed: `data_seed` takes the seed's place for the
data, `starts_seed` for the starts (a fit whose work follows float32's
rounding of its inputs needs the same inputs on every seed). The window closes at the end of the first fit
to finish at or after --seconds, so it holds whole fits only.

What the window produced is checked against the float64 reference
(portbench/reference/gp_f64.py), on the same inputs:

- lml_gap: every lane of every fit in the window, the log-likelihood the
  fit returned at the hyperparameters it reached, against the reference's
  there, over the reference's own scale of the terms that make it up
  (|1/2 quad| + |1/2 log det| + n/2 log 2 pi);
- grad_gap: the gradient of the fit's objective is not among its outputs,
  so the objective the fit calls (`models.gp.log_marginal_likelihood`, the
  same batch of lanes, the same kernels) is called once more after the
  window, at the hyperparameters the last fit reached; each component
  against the reference's, in units of float32's error bound at the lane's
  conditioning: over the lane's largest sum of the magnitudes of a
  component's data-fit and trace parts (at a fitted optimum the two cancel,
  so the gradient itself is no scale) times eps_float32 times the bound
  1 + n amp / (nugget + jitter amp) on C's condition number (a fit drives
  the nugget to its floor, where float32 rounding alone moves the gradient
  by tenths);
- nonfinite_share: the share of lanes the fits left with no finite
  log-likelihood;
- stall_share: the share of the lanes with a finite log-likelihood whose
  reference log-likelihood at the hyperparameters they reached is not
  above the reference's at the lane's start: a fit whose steps leave its
  state unchanged does not climb. The starts are the fit's own draw
  (`models.fit.sample_restarts` on a generator of the same stream, once a
  member, mapped into the configuration's boxes), read only to judge.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import time
from typing import Any, List

import torch

from portbench.harness import data as data_lib
from portbench.harness import seeds
from portbench.harness.gpconfig import gp_config
from portbench.reference import gp_f64 as ref

WARM_LS = 0.5
WARM_STEPS = 2


@dataclasses.dataclass
class State:
    cfg: Any
    X: torch.Tensor  # (n, d) or (E, n, d)
    y: torch.Tensor  # (n,) or (E, n)
    fits: List[dict] = dataclasses.field(default_factory=list)
    vg: Any = None  # (lml, grad) of the call after the window, on the host


def _fit_gp_host(gen, X, y, cfg):
    from madaiemulator_tpu_torch.models import fit
    from madaiemulator_tpu_torch.models.gp import GPData

    return fit.fit_gp_host(gen, GPData(X=X, y=y), cfg)


def _fit_ensemble(gen, X, y, cfg):
    from madaiemulator_tpu_torch.parallel import ensemble

    return ensemble.fit_ensemble(gen, X, y, cfg)


# entry name -> (the call, whether its lanes are members x restarts)
ENTRIES = {"fit_gp_host": (_fit_gp_host, False),
           "fit_ensemble": (_fit_ensemble, True)}


def _entry(run):
    name = run.config["fit"]["entry"]
    if name not in ENTRIES:
        raise ValueError(f"unknown fit entry {name!r}; known: "
                         f"{', '.join(ENTRIES)}")
    return ENTRIES[name]


def _ensemble(run) -> bool:
    return _entry(run)[1]


def _lane_data(run, st: State):
    """GPData of the fit's lanes, in the order of its restart results:
    (E * R) lanes, lane e * R + r on member e's design, for an ensemble;
    the one design shared by R lanes otherwise."""
    from madaiemulator_tpu_torch.models.gp import GPData

    if not _ensemble(run):
        return GPData(X=st.X, y=st.y)
    R = st.cfg.n_restarts
    E, n, d = st.X.shape
    return GPData(X=st.X[:, None].expand(E, R, n, d).reshape(E * R, n, d),
                  y=st.y[:, None].expand(E, R, n).reshape(E * R, n))


def _program_vg(run, st: State, log_params):
    """The fit's objective, value and gradient with respect to (log amp,
    log nugget, log ell), at lanes' log-hyperparameters (3 host tensors)."""
    from madaiemulator_tpu_torch.models import gp
    from madaiemulator_tpu_torch.ops.kernels import GPParams

    leaves = [t.detach().to(run.device, torch.float32).clone().requires_grad_(True)
              for t in log_params]
    ll = gp.log_marginal_likelihood(GPParams(*leaves), _lane_data(run, st),
                                    st.cfg)
    g = torch.autograd.grad(ll.sum(), leaves)
    return ll.detach(), torch.cat([g[0][:, None], g[1][:, None], g[2]], -1)


def _starts_stream(run, k: int) -> torch.Generator:
    """The generator fit k draws its starts from: the stream (seed, STARTS,
    k), with the traffic's `starts_seed` in the seed's place if it has
    one."""
    seed = run.traffic.get("starts_seed", run.seed)
    return seeds.generator(seed, seeds.STARTS, k % (1 << 32))


def _fit_once(run, st: State, k: int):
    return _entry(run)[0](_starts_stream(run, k), st.X, st.y, st.cfg)


def setup(run) -> State:
    X, y = data_lib.make(run.config["data"],
                         run.traffic.get("data_seed", run.seed), run.device)
    st = State(gp_config(run.config), X, y)
    # warm the cell's shapes: a value and gradient at the lane batch, then
    # a fit of WARM_STEPS steps (its value-only calls and the driver's own
    # operations) from a stream no fit of the window uses
    lanes = st.cfg.n_restarts * (X.shape[0] if _ensemble(run) else 1)
    d = X.shape[-1]
    warm = (torch.zeros(lanes), torch.full((lanes,), math.log(1e-2)),
            torch.full((lanes, d), math.log(WARM_LS)))
    _program_vg(run, st, warm)
    _fit_once(run, dataclasses.replace(
        st, cfg=dataclasses.replace(st.cfg, max_opt_steps=WARM_STEPS)), -1)
    return st


def window(run, st: State) -> None:
    """Fits k = 0, 1, ... until one finishes at or after --seconds; a
    second window (the traced one) makes the same fits again."""
    first = len(st.fits)
    t0 = time.perf_counter()
    k = 0
    while True:
        with torch.profiler.record_function("portbench.fit"):
            try:
                res = _fit_once(run, st, k)
                st.fits.append({
                    "k": k,
                    "n_vg": res.stats["n_vg_calls"],
                    "n_v": res.stats["n_v_calls"],
                    "n_steps": res.stats["n_steps"],
                    "ll": res.restart_log_likelihoods.detach().cpu()
                    .double().reshape(-1),
                    "params": [t.detach().cpu().reshape(
                        (-1,) + t.shape[2 if _ensemble(run) else 1:])
                        for t in res.restart_params],
                })
            except RuntimeError as e:  # a fit that never answers
                run.failed += 1
                print(f"fit {k} failed: {e}", file=sys.stderr)
        k += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.window_s = time.perf_counter() - t0
    run.attempted += k
    fits = st.fits[first:]
    run.record.update(
        fits=len(fits), steps_per_fit=run.config["gp"]["max_opt_steps"],
        n_vg=sum(f["n_vg"] for f in fits),
        n_v=sum(f["n_v"] for f in fits),
        n_steps=sum(f["n_steps"] for f in fits),
        lanes=int(fits[0]["ll"].numel()) if fits else 0)


def after(run, st: State) -> None:
    if not st.fits:
        return
    last = st.fits[-1]["params"]
    ll, g = _program_vg(run, st, last)
    st.vg = (ll.cpu().double(), g.cpu().double())
    if run.trace:
        # lml_vg_ms: the same call, host clock to synchronize, repeated
        # until the repeats span 0.3 s or more
        reps, t0 = 0, time.perf_counter()
        while reps < 3 or time.perf_counter() - t0 < 0.3:
            _program_vg(run, st, last)
            if run.device.type == "cuda":
                torch.cuda.synchronize(run.device)
            reps += 1
        run.record["lml_vg_ms"] = (time.perf_counter() - t0) / reps * 1e3
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


# --- the comparisons -------------------------------------------------------

def _lanes_ref(run, st: State, log_params, ar: ref.Arith, grad: bool):
    """The arithmetic's log-likelihood (and gradient) of each lane, in
    chunks that keep about 2^27 numbers a matrix batch; NaN for lanes
    where it could not factor."""
    E = st.X.shape[0] if _ensemble(run) else 1
    n = st.X.shape[-2]
    lanes = log_params[0].shape[0]
    R = lanes // E
    chunk = max(1, (1 << 27) // (n * n))
    vals, scales, grads, gscales = [], [], [], []
    for i in range(0, lanes, chunk):
        j = min(i + chunk, lanes)
        p = ref.params_from_log(*(t[i:j].to(run.device) for t in log_params),
                                ar=ar)
        if _ensemble(run):
            members = torch.arange(i, j, device=run.device) // R
            X, y = st.X[members], st.y[members]
        else:
            X, y = st.X, st.y
        out = ref.lml(X, y, p, ar, grad=grad)
        vals.append(out.value.double().cpu())
        scales.append(out.scale.double().cpu())
        if grad:
            grads.append(out.grad.double().cpu())
            gscales.append(out.grad_scale.double().cpu())
    cat = torch.cat
    return (cat(vals), cat(scales),
            cat(grads) if grad else None, cat(gscales) if grad else None)


def _gap(prog, ref_v, scale) -> float:
    """Largest |prog - ref| / scale over the entries; inf where the
    reference or the program gave no number."""
    g = (prog - ref_v).abs() / scale
    g = torch.where(torch.isfinite(g), g, torch.full_like(g, math.inf))
    return float(g.max()) if g.numel() else math.inf


def _numbers(run, st: State, program_side=None) -> dict:
    """lml_gap and grad_gap of the program's outputs, or of `program_side`
    (the control: an arithmetic evaluated in the program's place at the
    same lanes; its lanes that could not factor read inf, and the
    ".finite" numbers leave them out), against the float64 reference."""
    f64 = ref.Arith("float64", block=_block(run))
    last = st.fits[-1]["params"]
    rv, rs, rg, rgs = _lanes_ref(run, st, last, f64, grad=True)
    # normwise: each component against the lane's largest term (a
    # component whose terms underflow in float32 has no scale of its own),
    # times float32's rounding at the lane's condition bound
    kappa = ref.kappa_bound(st.X.shape[-2], ref.params_from_log(*last, ar=f64))
    rgs = (rgs.amax(-1, keepdim=True) * ref.F32_EPS
           * kappa.cpu()[:, None]).expand_as(rgs)
    if program_side is None:
        ll, g = st.vg
        ok = torch.isfinite(ll)
    else:
        ll, _, g, _ = _lanes_ref(run, st, last, program_side, grad=True)
        ok = torch.ones_like(ll, dtype=torch.bool)
    out = {"lml_gap": _gap(ll[ok], rv[ok], rs[ok]),
           "grad_gap": _gap(g[ok], rg[ok], rgs[ok])}
    if program_side is not None:
        fin = torch.isfinite(ll) & torch.isfinite(g).all(-1)
        out.update({"lml_gap.finite": _gap(ll[fin], rv[fin], rs[fin]),
                    "grad_gap.finite": _gap(g[fin], rg[fin], rgs[fin]),
                    "failed_share": float((~fin).double().mean())})
    return out


def _block(run) -> int:
    return int(run.config["gp"].get("cholesky_block", 512))


def _starts(run, st: State, k: int):
    """The log-hyperparameters fit k's lanes start from, (lanes,) leaves on
    the host: the fit's own draw from the same stream, mapped into the
    boxes of the configuration (log lo + (log hi - log lo) sigmoid(u))."""
    from madaiemulator_tpu_torch.models import fit

    gen = _starts_stream(run, k)
    E = st.X.shape[0] if _ensemble(run) else 1
    u = [fit.sample_restarts(gen, st.cfg, st.cfg.n_restarts,
                             dtype=torch.float32) for _ in range(E)]
    c = st.cfg
    boxes = (c.amp_bounds, c.nugget_bounds, c.length_scale_bounds)
    out = []
    for i, (lo, hi) in enumerate(boxes):
        leaf = torch.cat([getattr(x, x._fields[i]) for x in u])
        out.append(math.log(lo) + (math.log(hi) - math.log(lo))
                   * torch.sigmoid(leaf))
    return tuple(out)


def check(run, st: State) -> None:
    if not st.fits:
        run.failed += 1
        return
    f64 = ref.Arith("float64", block=_block(run))
    lml_gap, lanes, nonfinite, stalls, climbers = 0.0, 0, 0, 0, 0
    for f in st.fits:
        k, ll = f["k"], f["ll"]
        finite = torch.isfinite(ll)
        lanes += ll.numel()
        nonfinite += int((~finite).sum())
        rv, rs, _, _ = _lanes_ref(run, st, f["params"], f64, grad=False)
        r0 = _lanes_ref(run, st, _starts(run, st, k), f64, grad=False)[0]
        if finite.any():
            lml_gap = max(lml_gap, _gap(ll[finite], rv[finite], rs[finite]))
        climbers += int(finite.sum())
        stalls += int((finite & ~(rv > r0)).sum())
    vg = _numbers(run, st)
    run.add_check("lml_gap", max(lml_gap, vg["lml_gap"]))
    run.add_check("grad_gap", vg["grad_gap"])
    run.add_check("nonfinite_share", nonfinite / max(lanes, 1))
    run.add_check("stall_share", stalls / max(climbers, 1))


def control(run, st: State) -> dict:
    """lml_gap and grad_gap with the reference in TF32 arithmetic in the
    program's place, at the lanes the last fit reached."""
    return _numbers(run, st, program_side=ref.Arith("tf32",
                                                    block=_block(run)))
