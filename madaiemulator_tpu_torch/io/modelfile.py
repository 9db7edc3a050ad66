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
exactly. The MULTIFIDELITY grammar (`read_multifidelity_model_file`, the
training input of the multi-fidelity AR(1) fit) is documented at its
reader.
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


@dataclass
class MultiFidelityModelFile:
    """Training input for AR(1) co-kriging: per-level designs + targets
    (level 0 cheapest/largest, the last level is the target fidelity),
    plus optional OBSERVED lower-level outputs at each level's design
    (exact recursive co-kriging on nested designs — models/multifidelity).

    Scalar files (the original grammar) carry (N_k,) targets and one
    output name; multivariate files (the `noutputs` header) carry
    (N_k, t) targets/lower blocks and t output names.
    """

    param_names: List[str]
    output_names: List[str]  # t names; [one name] for scalar files
    designs: List[np.ndarray]  # per level: (N_k, d) raw designs
    targets: List[np.ndarray]  # per level: (N_k,) scalar / (N_k, t) mv
    lower_values: List  # len L-1; entry k-1: (N_k,)/(N_k, t) or None

    @property
    def output_name(self) -> str:
        return self.output_names[0]

    @property
    def noutputs(self) -> int:
        return len(self.output_names)

    @property
    def nparams(self) -> int:
        return self.designs[0].shape[1]

    @property
    def nlevels(self) -> int:
        return len(self.designs)


def read_multifidelity_model_file(
    source: Union[str, TextIO],
) -> MultiFidelityModelFile:
    """FORMAT (text, '#' comments; levels cheapest-first):

        MULTIFIDELITY
        [noutputs <t>]            (optional header; absent => scalar t=1)
        <nlevels>
        <nparams>
        <param name> x nparams
        <output name> x t         (one name when the header is absent)
        per level k = 0..L-1:
            <N_k> <has_lower 0|1>     (has_lower must be 0 for level 0)
            design  (N_k rows x nparams floats)
            targets (N_k floats scalar / N_k x t rows multivariate)
            lower   (same shape as targets, iff has_lower: the OBSERVED
                     level-(k-1) output at this level's design points)

    The reference has no multi-fidelity capability (SURVEY §2); this
    grammar is the training-side counterpart of the MF snapshot
    (io/snapshot.py MAGIC_MF). Scalar files (no `noutputs`) parse exactly
    as before — the multivariate extension is purely additive."""
    if isinstance(source, str):
        with open(source, "r") as f:
            return read_multifidelity_model_file(f)
    toks = _tokens(source)

    def next_tok() -> str:
        try:
            return next(toks)
        except StopIteration:
            raise ValueError("multi-fidelity model file ended early") from None

    if next_tok() != MAGIC_MF_MODEL:
        raise ValueError("not a MULTIFIDELITY model file")
    first = next_tok()
    if first == "noutputs":
        t = int(next_tok())
        if t < 1:
            raise ValueError(f"bad noutputs {t}")
        first = next_tok()
    else:
        t = 1
    nlevels = int(first)
    if nlevels < 1:
        raise ValueError(f"bad nlevels {nlevels}")
    nparams = int(next_tok())
    if nparams < 1:
        raise ValueError(f"bad nparams {nparams}")
    param_names = [next_tok() for _ in range(nparams)]
    output_names = [next_tok() for _ in range(t)]
    designs, targets, lower_values = [], [], []

    def block(nk):
        vals = [float(next_tok()) for _ in range(nk * t)]
        a = np.asarray(vals, np.float64)
        return a if t == 1 else a.reshape(nk, t)

    for k in range(nlevels):
        nk = int(next_tok())
        if nk < 1:
            raise ValueError(f"level {k}: bad npoints {nk}")
        has_lower = int(next_tok())
        if has_lower and k == 0:
            raise ValueError("level 0 cannot carry lower-level values")
        vals = [float(next_tok()) for _ in range(nk * nparams)]
        designs.append(np.asarray(vals, np.float64).reshape(nk, nparams))
        targets.append(block(nk))
        if k > 0:
            lower_values.append(block(nk) if has_lower else None)
    return MultiFidelityModelFile(
        param_names=param_names, output_names=output_names,
        designs=designs, targets=targets, lower_values=lower_values,
    )


def write_multifidelity_model_file(
    dest: Union[str, TextIO],
    designs: Sequence[np.ndarray],
    targets: Sequence[np.ndarray],
    lower_values: Sequence | None = None,
    param_names: Sequence[str] | None = None,
    output_name: str | None = None,
    output_names: Sequence[str] | None = None,
) -> None:
    """Scalar targets ((N_k,)) write the original grammar byte-for-byte;
    (N_k, t) targets with t > 1 add the `noutputs` header and row-major
    target/lower blocks. Pass output_names for multivariate files
    (output_name remains the scalar spelling)."""
    if isinstance(dest, str):
        with open(dest, "w") as f:
            write_multifidelity_model_file(
                f, designs, targets, lower_values, param_names,
                output_name, output_names,
            )
            return
    L = len(designs)
    lower_values = list(lower_values or [None] * (L - 1))
    d = np.atleast_2d(np.asarray(designs[0])).shape[1]
    param_names = list(param_names or [f"param_{i}" for i in range(d)])
    Y0 = np.asarray(targets[0])
    t = Y0.shape[1] if Y0.ndim == 2 else 1
    if output_names is None:
        output_names = (
            [output_name or "output_0"] if t == 1
            else [f"output_{j}" for j in range(t)]
        )
    output_names = list(output_names)
    if len(output_names) != t:
        raise ValueError(
            f"{len(output_names)} output names for t={t} outputs"
        )
    w = dest.write
    w(f"{MAGIC_MF_MODEL}\n")
    if t > 1:
        w(f"noutputs {t}\n")
    w(f"{L}\n{d}\n")
    for s in param_names:
        w(f"{s}\n")
    for s in output_names:
        w(f"{s}\n")
    for k in range(L):
        X = np.atleast_2d(np.asarray(designs[k]))
        low = lower_values[k - 1] if k > 0 else None
        w(f"{X.shape[0]} {int(low is not None)}\n")
        for row in X:
            w(" ".join(f"{v:.17g}" for v in row) + "\n")

        def wblock(arr):
            A = np.asarray(arr)
            if t == 1:
                w(" ".join(f"{v:.17g}" for v in A.ravel()) + "\n")
            else:
                if A.shape != (X.shape[0], t):
                    raise ValueError(
                        f"level {k}: block shape {A.shape} != "
                        f"({X.shape[0]}, {t})"
                    )
                for row in A:
                    w(" ".join(f"{v:.17g}" for v in row) + "\n")

        wblock(targets[k])
        if low is not None:
            wblock(low)


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
