"""Trained-emulator snapshot, dense text grammar versions 1 and 2 (port of
madaiemulator_tpu/io/snapshot.py read_snapshot / write_snapshot).

The grammar is shared with the JAX package byte for byte, so a snapshot
written by either package loads in the other:

    MADAIEMULATOR_TPU_SNAPSHOT <1|2>
    covariance <name> ; power_exp_alpha <float> ; regression_order <int>
    predict_variance_includes_nugget <0|1> ; pca_standardize <0|1>
    nparams <d> ; noutputs <t> ; npoints <N> ; ncomponents <r>
    d param names, t output names, design scaling (mins; ranges),
    PCA (ymean; ystd; eigenvalues; U t x r), scaled design X (N x d),
    PC scores Z (N x r), thetas (r x ntheta) [amp nugget ls...],
    and in version 2 the PC-space noise variances (N x r).

'#' starts a comment that runs to the end of its line; floats are written
"%.17g" so float64 round-trips exactly. Version 3 (gradients), the
multi-fidelity and sparse grammars and .npz snapshots are not yet ported and
raise ValueError.
"""

from __future__ import annotations

from typing import List, TextIO, Tuple, Union

import numpy as np
import torch

from madaiemulator_tpu_torch.models.multivariate import (
    MultivariateEmulator,
    emulator_from_numpy,
)
from madaiemulator_tpu_torch.utils.config import COVARIANCE_CLI_NAMES, GPConfig

MAGIC = "MADAIEMULATOR_TPU_SNAPSHOT"
VERSION = 1
VERSION_NOISE = 2  # version 1 + a trailing (N x r) PC-space noise block
_OTHER_MAGICS = {
    "MADAIEMULATOR_TPU_SNAPSHOT_MF": "multi-fidelity",
    "MADAIEMULATOR_TPU_SNAPSHOT_SGPR": "sparse (SGPR)",
}


def _fmt_vec(v) -> str:
    return " ".join(f"{float(x):.17g}" for x in np.asarray(v).ravel())


def _fmt_mat(M) -> str:
    return "\n".join(
        " ".join(f"{float(x):.17g}" for x in row) for row in np.asarray(M)
    )


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def write_snapshot(
    dest: Union[str, TextIO],
    emu: MultivariateEmulator,
    param_names: List[str] | None = None,
    output_names: List[str] | None = None,
) -> None:
    if isinstance(dest, str):
        with open(dest, "w") as f:
            write_snapshot(f, emu, param_names, output_names)
        return
    # derived from the state: standardize=False stores ystd = ones
    pca_standardize = bool(np.any(_np(emu.pca.ystd) != 1.0))
    n, d = emu.X.shape
    t = emu.n_outputs
    r = emu.n_components
    cfg = emu.config
    param_names = list(param_names or [f"param_{i}" for i in range(d)])
    output_names = list(output_names or [f"output_{i}" for i in range(t)])
    thetas = np.concatenate(
        [
            np.exp(_np(emu.params.log_amp))[:, None],
            np.exp(_np(emu.params.log_nugget))[:, None],
            np.exp(_np(emu.params.log_ls)),
        ],
        axis=1,
    )  # (r, ntheta), natural space, reference layout
    w = dest.write
    w(f"{MAGIC} {VERSION if emu.noise is None else VERSION_NOISE}\n")
    w(f"covariance {cfg.covariance.value}\n")
    w(f"power_exp_alpha {cfg.power_exp_alpha:.17g}\n")
    w(f"regression_order {cfg.regression_order}\n")
    w(f"predict_variance_includes_nugget {int(cfg.predict_variance_includes_nugget)}\n")
    w(f"pca_standardize {int(pca_standardize)}\n")
    w(f"nparams {d}\nnoutputs {t}\nnpoints {n}\nncomponents {r}\n")
    for s in param_names + output_names:
        w(f"{s}\n")
    w("# design scaling (mins; ranges)\n")
    w(_fmt_vec(_np(emu.scaling.mins)) + "\n")
    w(_fmt_vec(_np(emu.scaling.ranges)) + "\n")
    w("# pca: ymean; ystd; eigenvalues; U (t x r)\n")
    w(_fmt_vec(_np(emu.pca.ymean)) + "\n")
    w(_fmt_vec(_np(emu.pca.ystd)) + "\n")
    w(_fmt_vec(_np(emu.pca.eigenvalues)) + "\n")
    w(_fmt_mat(_np(emu.pca.U)) + "\n")
    w("# scaled design X (n x d)\n")
    w(_fmt_mat(_np(emu.X)) + "\n")
    w("# pc scores Z (n x r)\n")
    w(_fmt_mat(_np(emu.Z)) + "\n")
    w("# thetas per component (r x ntheta) [amp nugget ls...]\n")
    w(_fmt_mat(thetas) + "\n")
    if emu.noise is not None:
        w("# per-point PC-space observation-noise variances (n x r)\n")
        w(_fmt_mat(_np(emu.noise)) + "\n")


class _Tokens:
    """Whitespace tokens of a snapshot with '#' comments removed."""

    def __init__(self, text: str):
        self._toks = [
            tok for line in text.splitlines()
            for tok in line.split("#", 1)[0].split()
        ]
        self._pos = 0

    def take(self, k: int) -> List[str]:
        if self._pos + k > len(self._toks):
            raise ValueError("snapshot ended early")
        out = self._toks[self._pos:self._pos + k]
        self._pos += k
        return out

    def one(self) -> str:
        return self.take(1)[0]

    def expect(self, name: str) -> str:
        got = self.one()
        if got != name:
            raise ValueError(f"snapshot: expected {name!r}, got {got!r}")
        return self.one()

    def mat(self, rows: int, cols: int) -> np.ndarray:
        return np.asarray(self.take(rows * cols), dtype=np.float64).reshape(
            rows, cols
        )


def read_snapshot(
    source: Union[str, TextIO],
    device,
    dtype: torch.dtype = torch.float64,
    build_states: bool = True,
) -> Tuple[MultivariateEmulator, List[str], List[str]]:
    """Load a snapshot and rebuild the per-component serve states on
    `device` (the serve-time precompute; skipped when build_states is
    False). Returns (emulator, param_names, output_names). The config uses
    the port's defaults, so at float32 the serve path runs on the Hopper
    kernels."""
    if isinstance(source, str):
        if source.endswith(".npz"):
            raise ValueError(".npz snapshots are not yet ported")
        with open(source, "r") as f:
            return read_snapshot(f, device, dtype, build_states)
    toks = _Tokens(source.read())
    first = toks.one()
    if first in _OTHER_MAGICS:
        raise ValueError(f"{_OTHER_MAGICS[first]} snapshots are not yet ported")
    if first != MAGIC:
        raise ValueError("not a madaiemulator_tpu snapshot")
    version = int(toks.one())
    if version == 3:
        raise ValueError(
            "snapshot version 3 (gradient-enhanced) is not yet ported"
        )
    if version not in (VERSION, VERSION_NOISE):
        raise ValueError(f"unsupported snapshot version {version}")
    cov = COVARIANCE_CLI_NAMES[toks.expect("covariance")]
    alpha = float(toks.expect("power_exp_alpha"))
    order = int(toks.expect("regression_order"))
    pred_nug = bool(int(toks.expect("predict_variance_includes_nugget")))
    toks.expect("pca_standardize")  # metadata: ystd is applied directly
    d = int(toks.expect("nparams"))
    t = int(toks.expect("noutputs"))
    n = int(toks.expect("npoints"))
    r = int(toks.expect("ncomponents"))
    param_names = toks.take(d)
    output_names = toks.take(t)
    arrays = {
        "mins": toks.mat(1, d)[0],
        "ranges": toks.mat(1, d)[0],
        "ymean": toks.mat(1, t)[0],
        "ystd": toks.mat(1, t)[0],
        "eigenvalues": toks.mat(1, r)[0],
        "U": toks.mat(t, r),
        "X": toks.mat(n, d),
        "Z": toks.mat(n, r),
    }
    thetas = toks.mat(r, 2 + cov.num_length_scales(d))
    arrays["log_amp"] = np.log(thetas[:, 0])
    arrays["log_nugget"] = np.log(thetas[:, 1])
    arrays["log_ls"] = np.log(thetas[:, 2:])
    if version == VERSION_NOISE:
        arrays["noise"] = toks.mat(n, r)
    cfg = GPConfig(
        nparams=d,
        covariance=cov,
        regression_order=order,
        power_exp_alpha=alpha,
        predict_variance_includes_nugget=pred_nug,
    )
    emu = emulator_from_numpy(arrays, cfg, device=device, dtype=dtype,
                              build_states=build_states)
    return emu, param_names, output_names
