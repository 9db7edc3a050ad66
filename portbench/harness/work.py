"""The work a cell's window asked of each kernel, from the cell's own
shapes and the window's records: what the per-layer readers hold the
trace's device times against (harness/roofline.py counts each piece). The
kernel names are those the card's trace gives the port's csrc/ kernels.
"""

from __future__ import annotations

from portbench.harness import roofline

K1 = "pairwise_kernel"  # csrc/pairwise.cu
K2 = "chol_cluster_kernel"  # csrc/cholesky.cu
K3 = "panel_factor_cluster_kernel"  # csrc/panel_factor.cu
TRSM_OP = "aten::linalg_solve_triangular"  # the library's triangular solves


class NoLaunches(RuntimeError):
    """A kernel's metric in a cell whose trace on the card holds none of
    that kernel's launches: the cell lists a metric it cannot read."""


def _card_trace(run):
    """The traced window's trace where it holds the card's activity; None
    for a run without one (a run on the CPU has nothing to read)."""
    tr = run.trace_data
    return tr if tr is not None and tr.device else None


def fit_shape(run) -> dict:
    """A fit cell's lanes (restarts x members), points n, dimensions d,
    regression columns p, restarts R and panel size b."""
    data, gp = run.config["data"], run.config["gp"]
    members = data.get("members") or 1
    R = gp["n_restarts"]
    d = data["d"]
    return {"lanes": R * members, "n": data["n"], "d": d,
            "p": 1 + gp["regression_order"] * d, "R": R,
            "b": gp.get("cholesky_block", 512)}


def serve_shape(run) -> dict:
    data, gp = run.config["data"], run.config["gp"]
    d = data["d"]
    return {"n": data["n"], "d": d, "p": 1 + gp["regression_order"] * d}


def fit_roofline(run, pattern: str, per_launch) -> float:
    """The share of its roofline of every launch of `pattern` in the traced
    window, each launch doing `per_launch` = (bytes, flops) of work."""
    tr = _card_trace(run)
    if tr is None:
        return None
    n = tr.launches(pattern)
    if n == 0:
        raise NoLaunches(f"{run.cell}: the trace holds no launch of {pattern}")
    ms = roofline.bound_ms(*per_launch)[0] * n
    return roofline.share_pct(ms, tr.device_seconds(pattern))


def serve_roofline(run, pattern_or_op: str, per_request, by_op=False):
    """The share of its roofline of the window's requests' work
    (per_request(m) = (bytes, flops) for a request of m points)."""
    tr = _card_trace(run)
    if tr is None:
        return None
    sec = (tr.device_seconds_under(pattern_or_op) if by_op
           else tr.device_seconds(pattern_or_op))
    if sec <= 0:
        raise NoLaunches(f"{run.cell}: the trace holds no device time of "
                         f"{pattern_or_op}")
    ms = sum(roofline.bound_ms(*per_request(m))[0]
             for m in run.record["sizes"])
    return roofline.share_pct(ms, sec)
