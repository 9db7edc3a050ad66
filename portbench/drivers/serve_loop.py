"""Closed loop of query requests against one trained emulator, from one
client: each request is sent when the last one's answer is on the host.

Set-up builds the serve state once: `models.gp.precompute_predictor_safe`
at the configuration's fixed hyperparameters ("serve"). A request is
`models.gp.predict_from_precomputed` on m query points; it ends when its
means and variances are on the host. The traffic file fixes the requests:
`requests`, a list of [m, count] pairs, is one pass, the same for every
seed, which each pass sends in an order drawn from the seed. The points of a request are a
slice of a pool of `pool` uniform points drawn from the seed on the card,
at an offset drawn from the seed. The window closes at the end of the
first pass to finish at or after --seconds, so it holds whole passes: the
same work on every seed.

What the window produced is checked against the float64 reference
(portbench/reference/gp_f64.py), which builds its own serve state from the
same inputs: `sample` requests drawn from the seed and the largest one of
the window, every point of each:

- mean_gap: the largest |mean - reference| over the standard deviation of
  the training targets;
- var_gap: the largest |variance - reference| over the prior variance
  (amplitude + nugget).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, List

import torch

from portbench.harness import data as data_lib
from portbench.harness import seeds
from portbench.harness.gpconfig import gp_config
from portbench.reference import gp_f64 as ref


def sizes(traffic: dict) -> List[int]:
    """The sizes of one pass's requests: each [m, count] of `requests`
    gives count requests of m points."""
    return [int(m) for m, count in traffic["requests"] for _ in range(count)]


@dataclasses.dataclass
class State:
    cfg: Any
    X: torch.Tensor
    y: torch.Tensor
    log_params: tuple  # host float32 (log amp, log nugget, log ell)
    params: Any = None  # the program's GPParams on the card
    state: Any = None  # the program's serve state
    pool: torch.Tensor = None
    requests: List[tuple] = dataclasses.field(default_factory=list)
    answers: List[tuple] = dataclasses.field(default_factory=list)


def _predict(st: State, Xs: torch.Tensor):
    from madaiemulator_tpu_torch.models import gp

    mean, var = gp.predict_from_precomputed(
        st.state, st.params, gp.GPData(X=st.X, y=st.y), Xs, st.cfg)
    return mean.cpu(), var.cpu()


def setup(run) -> State:
    from madaiemulator_tpu_torch.models import gp
    from madaiemulator_tpu_torch.ops.kernels import GPParams

    X, y = data_lib.make(run.config["data"], run.seed, run.device)
    sv = run.config["serve"]
    d = X.shape[-1]
    log_params = (torch.tensor(math.log(sv["amp"])),
                  torch.tensor(math.log(sv["nugget"])),
                  torch.full((d,), math.log(sv["ls"])))
    st = State(gp_config(run.config), X, y, log_params)
    st.params = GPParams(*(t.to(run.device) for t in log_params))
    st.state = gp.precompute_predictor_safe(st.params, gp.GPData(X=X, y=y),
                                            st.cfg)
    tr = run.traffic
    g = seeds.generator(run.seed, seeds.QUERIES, device=run.device)
    st.pool = torch.rand((tr["pool"], d), generator=g, device=run.device)
    # warm the shapes the requests take, every one of them: the library
    # loads a kernel at its first use
    for m in sorted(set(sizes(tr))):
        _predict(st, st.pool[:m])
    return st


def window(run, st: State) -> None:
    tr = run.traffic
    ms = sizes(tr)
    order = seeds.rng(run.seed, seeds.ORDER)
    offsets = seeds.rng(run.seed, seeds.QUERIES, 1)
    first = len(st.requests)
    lat, pts = [], 0
    t0 = time.perf_counter()
    done = False
    while not done:
        for m in order.permutation(ms):
            m = int(m)
            off = int(offsets.integers(0, tr["pool"] - m + 1))
            with torch.profiler.record_function("portbench.request"):
                t_send = time.perf_counter()
                try:
                    mean, var = _predict(st, st.pool[off:off + m])
                except RuntimeError:
                    run.failed += 1
                    mean = var = None
                t_done = time.perf_counter()
            st.requests.append((m, off))
            st.answers.append((mean, var))
            lat.append(t_done - t_send)
            if mean is not None:
                pts += m
        done = time.perf_counter() - t0 >= run.seconds
    run.window_s = time.perf_counter() - t0
    run.attempted += len(st.requests) - first
    run.record.update(latencies_s=lat, points=pts,
                      sizes=[m for m, _ in st.requests[first:]])


def after(run, st: State) -> None:
    st.state = st.params = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def _sample(run, st: State) -> List[int]:
    k = int(run.workload["check"]["sample"])
    n = len(st.requests)
    pick = seeds.rng(run.seed, seeds.SAMPLE).choice(n, size=min(k, n),
                                                   replace=False)
    largest = max(range(n), key=lambda i: st.requests[i][0])
    return sorted(set(int(i) for i in pick) | {largest})


def _reference(run, st: State, idx: List[int], ar: ref.Arith):
    """The arithmetic's means and variances of the requests `idx`, from its
    own serve state (NaN where it could not factor)."""
    p = ref.params_from_log(*(t.to(run.device) for t in st.log_params),
                            ar=ar)
    rs = ref.factor(st.X, st.y, p, ar)
    out = []
    for i in idx:
        m, off = st.requests[i]
        mean, var = ref.predict(rs, st.X, st.pool[off:off + m], p, ar)
        out.append((mean.double().cpu(), var.double().cpu()))
    return out


def _numbers(run, st: State, idx, side) -> dict:
    f64 = ref.Arith("float64", block=_block(run))
    want = _reference(run, st, idx, f64)
    y_sd = float(st.y.double().std())
    prior = math.exp(float(st.log_params[0])) + math.exp(float(st.log_params[1]))
    mg = vg = 0.0
    for (m_ref, v_ref), (m, v) in zip(want, side):
        mg = max(mg, _gap(m, m_ref, y_sd))
        vg = max(vg, _gap(v, v_ref, prior))
    return {"mean_gap": mg, "var_gap": vg}


def _gap(got, want, scale) -> float:
    """Largest |got - want| / scale; inf for a missing or non-finite
    answer."""
    if got is None:
        return math.inf
    g = float((got.double() - want).abs().max()) / scale
    return g if math.isfinite(g) else math.inf


def _block(run) -> int:
    return int(run.config["gp"].get("cholesky_block", 512))


def check(run, st: State) -> None:
    if not st.requests:
        run.failed += 1
        return
    idx = _sample(run, st)
    nums = _numbers(run, st, idx, [st.answers[i] for i in idx])
    run.add_check("mean_gap", nums["mean_gap"])
    run.add_check("var_gap", nums["var_gap"])


def control(run, st: State) -> dict:
    """mean_gap and var_gap with the reference in TF32 arithmetic, from its
    own serve state, in the program's place."""
    idx = _sample(run, st)
    side = _reference(run, st, idx, ref.Arith("tf32", block=_block(run)))
    return _numbers(run, st, idx, side)
