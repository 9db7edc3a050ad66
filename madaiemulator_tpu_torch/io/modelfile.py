"""Training model-file reader and writer (port of
madaiemulator_tpu/io/modelfile.py, single-fidelity grammar).

FORMAT (text, whitespace-tolerant, '#' starts a comment to end-of-line),
shared with the JAX package byte for byte:

    <nparams>
    <param name> x nparams          (one token per line)
    <noutputs>
    <output name> x noutputs
    <nmodel_points>
    design matrix                    (nmodel_points rows x nparams floats)
    training outputs                 (nmodel_points rows x noutputs floats)

All numeric payloads are free-form whitespace separated; row structure is
by count, not by line. Floats are written "%.17g", so float64 round-trips
exactly. The MULTIFIDELITY grammar is recognized (`is_multifidelity_model_file`)
but not yet ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, TextIO, Union

import numpy as np

MAGIC_MF_MODEL = "MULTIFIDELITY"


@dataclass
class ModelFile:
    param_names: List[str]
    output_names: List[str]
    X: np.ndarray  # (N, d) raw (unscaled) design
    Y: np.ndarray  # (N, t) training outputs

    @property
    def nparams(self) -> int:
        return self.X.shape[1]

    @property
    def noutputs(self) -> int:
        return self.Y.shape[1]

    @property
    def npoints(self) -> int:
        return self.X.shape[0]


def _tokens(stream: TextIO):
    for line in stream:
        for tok in line.split("#", 1)[0].split():
            yield tok


def read_model_file(source: Union[str, TextIO]) -> ModelFile:
    """Parse a model file; raises ValueError on a malformed one."""
    if isinstance(source, str):
        with open(source, "r") as f:
            return read_model_file(f)
    toks = _tokens(source)

    def next_tok() -> str:
        try:
            return next(toks)
        except StopIteration:
            raise ValueError("model file ended early") from None

    nparams = int(next_tok())
    if nparams < 1:
        raise ValueError(f"bad nparams {nparams}")
    param_names = [next_tok() for _ in range(nparams)]
    nouts = int(next_tok())
    if nouts < 1:
        raise ValueError(f"bad noutputs {nouts}")
    output_names = [next_tok() for _ in range(nouts)]
    npoints = int(next_tok())
    if npoints < 1:
        raise ValueError(f"bad nmodel_points {npoints}")
    vals = [float(next_tok()) for _ in range(npoints * nparams)]
    X = np.asarray(vals, dtype=np.float64).reshape(npoints, nparams)
    vals = [float(next_tok()) for _ in range(npoints * nouts)]
    Y = np.asarray(vals, dtype=np.float64).reshape(npoints, nouts)
    return ModelFile(param_names=param_names, output_names=output_names,
                     X=X, Y=Y)


def write_model_file(
    dest: Union[str, TextIO],
    X: np.ndarray,
    Y: np.ndarray,
    param_names: Sequence[str] | None = None,
    output_names: Sequence[str] | None = None,
) -> None:
    if isinstance(dest, str):
        with open(dest, "w") as f:
            write_model_file(f, X, Y, param_names, output_names)
        return
    X = np.atleast_2d(np.asarray(X))
    Y = np.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    n, d = X.shape
    t = Y.shape[1]
    param_names = list(param_names or [f"param_{i}" for i in range(d)])
    output_names = list(output_names or [f"output_{i}" for i in range(t)])
    w = dest.write
    w(f"{d}\n")
    for s in param_names:
        w(f"{s}\n")
    w(f"{t}\n")
    for s in output_names:
        w(f"{s}\n")
    w(f"{n}\n")
    for row in X:
        w(" ".join(f"{v:.17g}" for v in row) + "\n")
    for row in Y:
        w(" ".join(f"{v:.17g}" for v in row) + "\n")


def is_multifidelity_model_file(path: str) -> bool:
    """Peek at the first non-comment token (the CLI routes on this)."""
    with open(path, "r") as f:
        for tok in _tokens(f):
            return tok == MAGIC_MF_MODEL
    return False


def read_gradients_file(
    path: str, npoints: int, nparams: int, noutputs: int
) -> np.ndarray:
    """Observed output gradients for gradient-enhanced training
    (`estimate_thetas --gradients_file`): whitespace-separated floats,
    npoints * noutputs * nparams of them -- per design point (model-file
    row order), per output (model-file output order), the nparams partials
    d f_t / d x_a w.r.t. the RAW inputs ('#' comments allowed). Returns
    (N, d, t), the layout fit_multivariate(gradients=...) takes."""
    with open(path, "r") as f:
        vals = [float(t) for t in _tokens(f)]
    want = npoints * noutputs * nparams
    if len(vals) != want:
        raise ValueError(
            f"gradients file has {len(vals)} values; expected "
            f"N*t*d = {npoints}*{noutputs}*{nparams} = {want}"
        )
    arr = np.asarray(vals, np.float64).reshape(npoints, noutputs, nparams)
    return np.transpose(arr, (0, 2, 1))  # (N, d, t)
