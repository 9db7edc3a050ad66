"""Experiment-observation file reader/writer for CLI calibration (port of
madaiemulator_tpu/io/experiment.py; numpy only, the same grammar and the
same bytes).

The reference has no such file — its calibration consumer (the external
MADAI MCMC framework) held the experimental data itself and drove the
emulator over the pipe (SURVEY.md §3.2). The in-process `calibrate`
subcommand needs the observations as an input, so this module pins a small
local grammar in the same style as the model file (count-driven,
whitespace-tolerant, '#' comments — io/modelfile.py):

    <noutputs>
    <value> <variance>    x noutputs   (one observable per row; row order
                                        matches the snapshot's output order)

Variances must be positive (a measured observable with zero uncertainty
would make the Gaussian likelihood singular).
"""

from __future__ import annotations

from typing import TextIO, Tuple, Union

import numpy as np


def read_experiment_file(source: Union[str, TextIO]) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (values (t,), variances (t,)) as float64."""
    if isinstance(source, str):
        with open(source, "r") as f:
            return read_experiment_file(f)
    toks = []
    for line in source:
        toks.extend(line.split("#", 1)[0].split())
    it = iter(toks)

    def next_tok() -> str:
        try:
            return next(it)
        except StopIteration:
            raise ValueError("experiment file ended early") from None

    t = int(next_tok())
    if t < 1:
        raise ValueError(f"bad noutputs {t}")
    vals = np.empty(t)
    var = np.empty(t)
    for i in range(t):
        vals[i] = float(next_tok())
        var[i] = float(next_tok())
    if np.any(var <= 0):
        raise ValueError("experimental variances must be positive")
    return vals, var


def write_experiment_file(
    dest: Union[str, TextIO], values, variances
) -> None:
    if isinstance(dest, str):
        with open(dest, "w") as f:
            write_experiment_file(f, values, variances)
            return
    values = np.asarray(values, dtype=np.float64).ravel()
    variances = np.asarray(variances, dtype=np.float64).ravel()
    if values.shape != variances.shape:
        raise ValueError("values and variances must have the same length")
    dest.write(f"{values.size}\n")
    for v, s2 in zip(values, variances):
        dest.write(f"{v:.17g} {s2:.17g}\n")
