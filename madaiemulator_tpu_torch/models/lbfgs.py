"""Lock-step batched L-BFGS with optax's zoom and backtracking linesearches
(port of what `madaiemulator_tpu/models/fit.py::_run_lbfgs` takes from
optax 0.2.6: `optax.lbfgs()`, `scale_by_zoom_linesearch`,
`scale_by_backtracking_linesearch(max_backtracking_steps=25,
store_grad=True)` and `value_and_grad_from_state`).

Every lane of a (B, P) batch runs optax's algorithm on its own objective,
the way `jax.vmap` runs it in the JAX package: a linesearch loop iterates
until every lane is done, each iteration evaluates the objective once for
the whole batch (each lane at its own trial step), and a lane that is done
keeps its state through `torch.where`. Lanes are never masked by
arithmetic, so a finished lane's inf or NaN cannot leak into another.

The objective's value and gradient come from the caller as batched
functions of a (B, P) tensor in the iterate dtype. The iterate keeps that
dtype (cast back after each update); the L-BFGS memory, the stepsizes and
every linesearch scalar are float64. `segments` gives the widths of the
parameter leaves in flat order (the P columns of the batch): inner products
and norms are summed leaf by leaf, in optax's order (a pytree vdot), so
float64 runs reproduce the JAX package's iterates to rounding.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence, Tuple

import torch

# optax.lbfgs() defaults
MEMORY_SIZE = 10
# optax.scale_by_zoom_linesearch(max_linesearch_steps=20,
# initial_guess_strategy='one') with optax's default constants
ZOOM_MAX_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5  # the zoom's interval_threshold
INCREASE_FACTOR = 2.0
# optax.scale_by_backtracking_linesearch(max_backtracking_steps=25,
# store_grad=True) with optax's default constants
BT_MAX_STEPS = 25
BT_DECREASE = 0.8
BT_INCREASE = 1.5
BT_MAX_LR = 1.0

F64 = torch.float64

ValueAndGrad = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
Value = Callable[[torch.Tensor], torch.Tensor]


class LBFGSResult(NamedTuple):
    u: torch.Tensor  # (B, P) iterate after the last step
    best_u: torch.Tensor  # (B, P) best finite iterate of each lane
    best_value: torch.Tensor  # (B,) its objective value (inf if none)
    linesearch_evals: list  # objective evaluations of each step's linesearch


class _Leaves:
    """Leaf-by-leaf inner products of (B, P) batches, summed in leaf order
    (optax.tree.vdot / tree.norm over a pytree)."""

    def __init__(self, P: int, segments: Sequence[int]):
        widths = list(segments)
        if sum(widths) != P:
            raise ValueError(f"segments {widths} do not add up to P={P}")
        self.slices = []
        start = 0
        for w in widths:
            self.slices.append(slice(start, start + w))
            start += w

    def vdot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        out = None
        for s in self.slices:
            v = (a[:, s] * b[:, s]).sum(-1)
            out = v if out is None else out + v
        return out

    def norm(self, a: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.vdot(a, a))


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per lane: a where mask, else b (mask (B,), a and b (B,) or (B, P))."""
    if a.ndim > mask.ndim:
        mask = mask[:, None]
    return torch.where(mask, a, b)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (optax `_cubicmin`); NaN where it has none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0 = fb - fa - C * db
    r1 = fc - fa - C * dc
    A = (dc ** 2 * r0 + (-(db ** 2)) * r1) / denom
    B = ((-(dc ** 3)) * r0 + db ** 3 * r1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope fpa
    at a (optax `_quadmin`)."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db ** 2)
    return a - C / (2.0 * B)


def _nan_to_inf(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(x), torch.inf, x)


def _zoom_errors(stepsize, value, slope, value_init, slope_init):
    """(decrease error, curvature error) of a trial step: optax's Armijo /
    approximate-Wolfe decrease criterion and strong-Wolfe curvature, each
    clipped at 0, NaN read as inf."""
    dec = value - value_init - SLOPE_RTOL * stepsize * slope_init
    approx = slope - (2 * SLOPE_RTOL - 1.0) * slope_init
    delta_values = value - value_init - APPROX_DEC_RTOL * torch.abs(value_init)
    approx = torch.maximum(approx, delta_values)
    dec = torch.minimum(approx, dec)
    dec = _nan_to_inf(torch.clamp(dec, min=0.0))
    curv = torch.abs(slope) - CURV_RTOL * torch.abs(slope_init)
    curv = _nan_to_inf(torch.clamp(curv, min=0.0))
    return dec, curv


def _zoom_linesearch(u, d, value, grad, vg, leaves, to_iterate):
    """optax's zoom linesearch (interval search, then zoom by cubic /
    quadratic interpolation or bisection, then the safe-step fallback), in
    lock step over the lanes. Returns (stepsize, value, grad) at the
    accepted step and the number of objective evaluations."""
    B = u.shape[0]
    dev = u.device
    zeros = torch.zeros(B, dtype=F64, device=dev)
    slope = leaves.vdot(d, grad)
    s = {
        "stepsize": zeros, "value": value, "grad": grad, "slope": slope,
        "dec": torch.full_like(zeros, torch.inf),
        "found": torch.zeros(B, dtype=torch.bool, device=dev),
        "done": torch.zeros(B, dtype=torch.bool, device=dev),
        "failed": torch.zeros(B, dtype=torch.bool, device=dev),
        "low": zeros, "value_low": value, "slope_low": slope,
        "high": zeros, "value_high": value, "slope_high": slope,
        "cubic_ref": zeros, "value_cubic_ref": value,
        "safe_stepsize": zeros, "safe_value": value, "safe_grad": grad,
    }
    value_init, slope_init = value, slope
    it = 0
    while True:
        active = ~(s["done"] | s["failed"])
        if not bool(active.any()):
            break
        # the interval search's next trial: the initial guess 1, then x2
        new_step = (torch.ones_like(zeros) if it == 0
                    else INCREASE_FACTOR * s["stepsize"])
        # the zoom's next trial inside [low, high]
        low, high = s["low"], s["high"]
        value_low, slope_low = s["value_low"], s["slope_low"]
        value_high, slope_high = s["value_high"], s["slope_high"]
        cubic_ref, value_cubic_ref = s["cubic_ref"], s["value_cubic_ref"]
        delta = torch.abs(high - low)
        left = torch.minimum(high, low)
        right = torch.maximum(high, low)
        cubic_chk = 0.2 * delta
        quad_chk = 0.1 * delta
        too_small_int = delta <= STEPSIZE_PRECISION
        mc = _cubicmin(low, value_low, slope_low, high, value_high,
                       cubic_ref, value_cubic_ref)
        use_cubic = (mc > left + cubic_chk) & (mc < right - cubic_chk)
        mq = _quadmin(low, value_low, slope_low, high, value_high)
        use_quad = (~use_cubic) & (mq > left + quad_chk) & (mq < right - quad_chk)
        use_bisection = (~use_cubic) & (~use_quad)
        middle = torch.where(use_cubic, mc, cubic_ref)
        middle = torch.where(use_quad, mq, middle)
        middle = torch.where(use_bisection, (low + high) / 2.0, middle)

        found = s["found"]
        trial = torch.where(found, middle, new_step)
        v_t, g_t = vg(to_iterate(u + trial[:, None] * d))
        slope_t = leaves.vdot(g_t, d)
        dec, curv = _zoom_errors(trial, v_t, slope_t, value_init, slope_init)
        err = torch.maximum(dec, curv)
        safe_decrease = dec <= 0.0
        last = it + 1 >= ZOOM_MAX_STEPS

        # interval search (Nocedal & Wright algorithm 3.5)
        prev_step, prev_value, prev_slope = s["stepsize"], s["value"], s["slope"]
        set_high_new = (dec > 0.0) | ((v_t >= prev_value) & (it > 0))
        set_low_new = (slope_t >= 0.0) & (~set_high_new)
        search = {
            "low": torch.where(set_low_new, new_step, prev_step),
            "value_low": torch.where(set_low_new, v_t, prev_value),
            "slope_low": torch.where(set_low_new, slope_t, prev_slope),
            "high": torch.where(set_low_new, prev_step, new_step),
            "value_high": torch.where(set_low_new, prev_value, v_t),
            "slope_high": torch.where(set_low_new, prev_slope, slope_t),
            "found": set_high_new | set_low_new | (err <= 0.0),
            "done": err <= 0.0,
            "safe_stepsize": torch.where(safe_decrease, new_step,
                                         s["safe_stepsize"]),
            "safe_value": torch.where(safe_decrease, v_t, s["safe_value"]),
            "safe_grad": _where(safe_decrease, g_t, s["safe_grad"]),
        }
        search["cubic_ref"] = search["low"]
        search["value_cubic_ref"] = search["value_low"]
        search["failed"] = last & ~search["done"]

        # zoom (Nocedal & Wright algorithm 3.6)
        update_safe = safe_decrease & (v_t < s["safe_value"])
        safe_stepsize = torch.where(update_safe, middle, s["safe_stepsize"])
        set_high_mid = (dec > 0.0) | (v_t >= value_low)
        set_high_low = (slope_t * (high - low) >= 0.0) & (~set_high_mid)
        set_low_mid = ~set_high_mid
        high_moved = set_high_mid | set_high_low
        zoom = {
            "high": torch.where(set_high_low, low,
                                torch.where(set_high_mid, middle, high)),
            "value_high": torch.where(set_high_low, value_low,
                                      torch.where(set_high_mid, v_t,
                                                  value_high)),
            "slope_high": torch.where(set_high_low, slope_low,
                                      torch.where(set_high_mid, slope_t,
                                                  slope_high)),
            "low": torch.where(set_low_mid, middle, low),
            "value_low": torch.where(set_low_mid, v_t, value_low),
            "slope_low": torch.where(set_low_mid, slope_t, slope_low),
            "cubic_ref": torch.where(high_moved, high, low),
            "value_cubic_ref": torch.where(high_moved, value_high, value_low),
            "found": found,
            "done": err <= 0.0,
            "safe_stepsize": safe_stepsize,
            "safe_value": torch.where(update_safe, v_t, s["safe_value"]),
            "safe_grad": _where(update_safe, g_t, s["safe_grad"]),
        }
        zoom["failed"] = ((last | (too_small_int & (safe_stepsize > 0.0)))
                          & ~zoom["done"])

        new = {k: _where(found, zoom[k], search[k]) for k in search}
        new["stepsize"], new["value"], new["grad"] = trial, v_t, g_t
        new["slope"], new["dec"] = slope_t, dec
        # a failed lane falls back to its best step of sufficient decrease,
        # or to no step when every trial left the domain (inf / NaN)
        take_safe = new["failed"] & ((new["safe_stepsize"] > 0.0)
                                     | torch.isinf(new["dec"]))
        for k, sk in (("stepsize", "safe_stepsize"), ("value", "safe_value"),
                      ("grad", "safe_grad")):
            new[k] = _where(take_safe, new[sk], new[k])
        s = {k: _where(active, new[k], s[k]) for k in s}
        it += 1
    return s["stepsize"], s["value"], s["grad"], it


def _backtracking_linesearch(u, d, value, grad, lr_prev, vg, leaves,
                             to_iterate):
    """optax's backtracking (Armijo) linesearch with store_grad=True, in
    lock step over the lanes. Returns (learning rate, value, grad) at the
    accepted step (learning rate 0 where every trial was inf / NaN) and the
    number of objective evaluations."""
    slope = leaves.vdot(d, grad)
    lr = torch.clamp(BT_INCREASE * lr_prev, max=BT_MAX_LR)
    new_value = value
    new_grad = torch.zeros_like(grad)
    dec = torch.full_like(value, torch.inf)
    it = 0
    while True:
        active = (~(dec <= 0.0)) & (it <= BT_MAX_STEPS)
        if not bool(active.any()):
            break
        lr_t = BT_DECREASE * lr if it > 0 else lr
        v_t, g_t = vg(to_iterate(u + lr_t[:, None] * d))
        dec_t = v_t - 1.0 * value - lr_t * SLOPE_RTOL * slope
        dec_t = torch.clamp(_nan_to_inf(dec_t), min=0.0)
        # the gradient is kept at the trial that ends the lane's search
        keep_grad = (dec_t <= 0.0) | (it == BT_MAX_STEPS)
        g_t = _where(keep_grad, g_t, new_grad)
        lr = torch.where(active, lr_t, lr)
        new_value = torch.where(active, v_t, new_value)
        new_grad = _where(active, g_t, new_grad)
        dec = torch.where(active, dec_t, dec)
        it += 1
    lr = torch.where(torch.isinf(dec), 0.0, lr)
    return lr, new_value, new_grad, it


def _precondition(g, S, Y, rho, gamma, memory_idx, leaves):
    """L-BFGS two-loop recursion over the ring buffers (optax
    `_precondition_by_lbfgs`; empty slots hold zeros and weight 0)."""
    m = S.shape[0]
    order = [(memory_idx + i) % m for i in range(m)]
    vec = g
    alphas = {}
    for i in reversed(order):
        alphas[i] = rho[i] * leaves.vdot(S[i], vec)
        vec = vec + (-alphas[i])[:, None] * Y[i]
    vec = gamma[:, None] * vec
    for i in order:
        beta = rho[i] * leaves.vdot(Y[i], vec)
        vec = vec + (alphas[i] - beta)[:, None] * S[i]
    return vec


def run_lbfgs(
    u0: torch.Tensor,
    value_and_grad: ValueAndGrad,
    value: Value,
    max_steps: int,
    segments: Sequence[int],
    linesearch: str = "zoom",
) -> LBFGSResult:
    """`max_steps` L-BFGS steps on every lane of u0 (B, P), with per-lane
    best-so-far tracking, then one value-only evaluation of the last
    iterate (the JAX package's `_run_lbfgs`).

    value_and_grad(u) -> ((B,), (B, P)) and value(u) -> (B,) evaluate the
    objective of each lane at u (B, P) in u0's dtype. Step 0 evaluates the
    value and gradient once; every later step reuses what its linesearch
    found at the accepted point, re-evaluating only when a lane's stored
    value is not finite (`optax.value_and_grad_from_state`).
    """
    if linesearch not in ("zoom", "backtracking"):
        raise ValueError(f"unknown linesearch {linesearch!r}")
    dtype = u0.dtype
    dev = u0.device
    B, P = u0.shape
    leaves = _Leaves(P, segments)
    m = MEMORY_SIZE

    def to_iterate(x):
        return x.to(dtype)

    def vg64(x):
        v, g = value_and_grad(x)
        return v.to(F64), g.to(F64)

    u = u0
    S = torch.zeros((m, B, P), dtype=F64, device=dev)
    Y = torch.zeros_like(S)
    rho = torch.zeros((m, B), dtype=F64, device=dev)
    prev_u = torch.zeros((B, P), dtype=F64, device=dev)
    prev_g = torch.zeros_like(prev_u)
    ls_value = torch.full((B,), torch.inf, dtype=F64, device=dev)
    ls_grad = torch.zeros_like(prev_u)
    bt_lr = torch.ones((B,), dtype=F64, device=dev)
    best_u = u0
    best_v = torch.full((B,), torch.inf, dtype=F64, device=dev)
    evals = []
    for k in range(max_steps):
        # value_and_grad_from_state: reuse the linesearch's value and
        # gradient where its value is finite
        stale = ~torch.isfinite(ls_value)
        if bool(stale.any()):
            v_new, g_new = vg64(u)
            v = torch.where(stale, v_new, ls_value)
            g = _where(stale, g_new, ls_grad)
        else:
            v, g = ls_value, ls_grad
        better = torch.isfinite(v) & (v < best_v)
        best_u = _where(better, u, best_u)
        best_v = torch.where(better, v, best_v)

        # scale_by_lbfgs: memory update, then the preconditioned direction
        u64 = u.to(F64)
        if k > 0:
            dp = u64 - prev_u
            du = g - prev_g
            vd = leaves.vdot(du, dp)
            weight = torch.where(vd == 0.0, 0.0, 1.0 / vd)
            den = leaves.vdot(du, du)
            gamma = torch.where(den > 0.0, vd / den, 1.0)
        else:
            dp = du = torch.zeros_like(u64)
            weight = torch.zeros((B,), dtype=F64, device=dev)
            gamma = torch.clamp(1.0 / leaves.norm(g), max=1.0)
        prev = (k - 1) % m
        S[prev], Y[prev], rho[prev] = dp, du, weight
        d = -1.0 * _precondition(g, S, Y, rho, gamma, k % m, leaves)
        prev_u, prev_g = u64, g

        if linesearch == "zoom":
            lr, ls_value, ls_grad, n = _zoom_linesearch(
                u64, d, v, g, vg64, leaves, to_iterate)
        else:
            lr, ls_value, ls_grad, n = _backtracking_linesearch(
                u64, d, v, g, bt_lr, vg64, leaves, to_iterate)
            bt_lr = lr
        evals.append(n)
        u = to_iterate(u64 + lr[:, None] * d)

    v_f = value(u).to(F64)
    better = torch.isfinite(v_f) & (v_f < best_v)
    best_u = _where(better, u, best_u)
    best_v = torch.where(better, v_f, best_v)
    return LBFGSResult(u=u, best_u=best_u, best_value=best_v,
                       linesearch_evals=evals)
