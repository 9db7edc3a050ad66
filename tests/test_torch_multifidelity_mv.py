"""The multivariate multi-fidelity emulator of the port on the CPU against
the JAX package at float64: `fit_multivariate_multifidelity` from the same
starts (one shared PCA basis, a nested level and a non-nested one), the
version-2 multi-fidelity snapshot (text byte for byte, .npz key for key,
both ways), the per-level observable-space LOO, and the CLI on a
multivariate MULTIFIDELITY model file and its snapshot.

The checks are tests/test_torch_multifidelity.py's, run here on the "mv"
kind (its `name` fixture); the two modules stay under the per-file time
budget because each compiles only its own kind's JAX fits.
"""

import pytest

from test_torch_multifidelity import (  # noqa: F401  (fixtures and checks)
    cli_states,
    fits,
    test_cli_estimate_thetas_multifidelity,
    test_cli_serve_print_convert_validate_match_jax,
    test_fit_matches_jax_from_the_same_starts,
    test_loo_twins_match_jax,
    test_snapshots_both_ways,
)
import torch_shared  # noqa: F401


@pytest.fixture(scope="module")
def name():
    return "mv"
