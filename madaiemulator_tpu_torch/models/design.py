"""Sequential-design helpers (port of madaiemulator_tpu/models/design.py,
the part the sparse fit needs): the greedy weighted-maximin selector that
picks SGPR's inducing points from the design. The design proposals built
on it (variance and history-matching waves) are not yet ported.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _greedy_maximin(
    points: torch.Tensor, weights: torch.Tensor, n_new: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy weighted-maximin batch selection.

    Picks argmax(weight), then repeatedly argmax(weight * min-sq-distance
    to everything already picked), the first maximum on ties. Zero-weight
    candidates are never picked while any positive-weight candidate
    remains; a picked point's distance factor drops to 0 so it cannot
    repeat. Returns (indices (n_new,) int32, pick scores (n_new,)).

    The JAX package runs one `fori_loop` on the device; here the loop runs
    on the host over n_new steps with every argmax left on the device, so
    the loop never waits for a pick (no read-back per step).
    """
    p, d = points.shape
    mind = torch.full((p,), float(d), dtype=points.dtype,
                      device=points.device)  # max sq-dist on [0,1]^d
    sel = torch.zeros((n_new,), dtype=torch.int32, device=points.device)
    scr = torch.zeros((n_new,), dtype=points.dtype, device=points.device)
    for i in range(n_new):
        score = weights if i == 0 else weights * mind
        idx = torch.argmax(score).reshape(1)
        d2 = ((points - points.index_select(0, idx)) ** 2).sum(1)
        mind = torch.minimum(mind, d2)
        sel[i] = idx[0]
        scr[i] = score.index_select(0, idx)[0]
    return sel, scr
