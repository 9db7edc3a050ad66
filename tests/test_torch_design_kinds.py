"""The port's sequential design on the sparse and the multi-fidelity
emulators against the JAX package's on the CPU at float64 (the checks of
test_torch_design.py, JAX's pool injected): the active-variance batch and
the NROY wave on a sparse emulator fitted by the port (m=8 inducing
points) and on the scalar and multivariate multi-fidelity emulators of
`tests/torch_mf_fixture.py`, each served by both packages from the same
snapshot; and the CLI's --matrix_free exit-2 routes for both kinds."""

import numpy as np
import pytest
import torch

from madaiemulator_tpu_torch.io import snapshot as tsnap
from madaiemulator_tpu_torch.models import sparse as tsp
from madaiemulator_tpu_torch.utils import config as tcfg
from test_torch_design import (
    CPU,
    D,
    N,
    NAMES,
    T,
    _read_both,
    _sim,
    check_active_variance,
    check_exit_2,
    check_nroy_wave,
)
from torch_mf_fixture import mf_emulator
import torch_shared  # noqa: F401

KINDS = ("sparse", "mf", "mf_scalar")


@pytest.fixture(scope="module")
def kinds(tmp_path_factory):
    """{"emus": {kind: (JAX emulator, port emulator)}, "paths": {kind:
    snapshot}}."""
    tmp = tmp_path_factory.mktemp("design_kinds")
    rng = np.random.default_rng(32)
    X = rng.uniform(1.0, 3.0, size=(N, D))
    Y = _sim(X) + 0.02 * rng.standard_normal((N, T))
    paths = {k: str(tmp / f"{k}.txt") for k in KINDS}
    semu = tsp.fit_multivariate_sparse(
        torch.Generator().manual_seed(0), torch.tensor(X), torch.tensor(Y),
        tcfg.GPConfig(nparams=D, regression_order=1, n_restarts=2,
                      max_opt_steps=5), inducing=8)
    tsnap.write_snapshot_auto(paths["sparse"], semu, *NAMES)
    tsnap.write_snapshot_auto(paths["mf"], mf_emulator(True), *NAMES)
    tsnap.write_snapshot_auto(paths["mf_scalar"], mf_emulator(False),
                              NAMES[0], ["o0"])
    return dict(emus={k: _read_both(p) for k, p in paths.items()},
                paths=paths)


@pytest.mark.parametrize("kind", KINDS)
def test_active_variance_design_matches_jax(kind, kinds, monkeypatch):
    check_active_variance(kind, *kinds["emus"][kind], monkeypatch)


@pytest.mark.parametrize("kind", KINDS)
def test_nroy_wave_design_matches_jax(kind, kinds, monkeypatch):
    check_nroy_wave(kind, *kinds["emus"][kind], monkeypatch)


@pytest.mark.parametrize("kind", ["sparse", "mf"])
def test_cli_design_matrix_free_exits_2(kind, kinds, monkeypatch, capsys):
    check_exit_2(f"{kind}_matrix_free",
                 ["design", kinds["paths"][kind], "--matrix_free"],
                 monkeypatch, capsys)
