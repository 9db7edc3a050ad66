"""Run configuration for the emulator (port of madaiemulator_tpu/utils/config.py).

Same enum, CLI names, field names and validation as the JAX package, so the
same configs and CLI lines run on both. One deliberate difference:
`gram_method` and `cholesky_method` default to "pallas" here, so the serve
path on the card goes through the hand-written Hopper kernels with no flag.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class CovarianceFamily(enum.Enum):
    """Covariance function families of the reference.

    POWER_EXPONENTIAL is the reference's "gaussian" covariance:
    amplitude * exp(-0.5 * sum_d |dx_d / ell_d|^alpha) with per-dimension
    length scales. MATERN32 / MATERN52 are isotropic Matérn (one length
    scale); the _ARD variants scale each dimension separately and feed the
    same Matérn polynomial.
    """

    POWER_EXPONENTIAL = "power_exponential"
    MATERN32 = "matern32"
    MATERN52 = "matern52"
    MATERN32_ARD = "matern32_ard"
    MATERN52_ARD = "matern52_ard"

    def num_length_scales(self, nparams: int) -> int:
        if self in (
            CovarianceFamily.POWER_EXPONENTIAL,
            CovarianceFamily.MATERN32_ARD,
            CovarianceFamily.MATERN52_ARD,
        ):
            return nparams  # ARD: one length scale per input dimension
        return 1  # isotropic Matérn, as in the reference

    def num_thetas(self, nparams: int) -> int:
        # theta[0] = amplitude, theta[1] = nugget, theta[2:] = length scales
        return 2 + self.num_length_scales(nparams)


# Reference CLI names for --covariance_fn.
COVARIANCE_CLI_NAMES = {
    "power_exponential": CovarianceFamily.POWER_EXPONENTIAL,
    "gaussian": CovarianceFamily.POWER_EXPONENTIAL,
    "matern32": CovarianceFamily.MATERN32,
    "matern_three": CovarianceFamily.MATERN32,
    "matern52": CovarianceFamily.MATERN52,
    "matern_five": CovarianceFamily.MATERN52,
    # extensions (not in the reference)
    "matern32_ard": CovarianceFamily.MATERN32_ARD,
    "matern52_ard": CovarianceFamily.MATERN52_ARD,
}


@dataclasses.dataclass(frozen=True)
class GPConfig:
    """Static configuration of one scalar-GP emulation problem.

    Trainable values (thetas) live in `ops.kernels.GPParams` instead.

    gram_method: "pallas" (default here) builds every Gram and
    cross-covariance with kernel K1 (`ops/hopper/pairwise.py`); "xla" uses
    library math (the centred matmul trick). The kernel covers float32 with
    alpha = 2 power-exponential and the Matérn families; float64 and
    alpha != 2 take the library path, as in the JAX package.

    cholesky_method: "pallas" (default here) factors N <= pallas_cholesky_max_n
    with kernel K2 (`ops/hopper/cholesky.py`) at float32 and routes larger N
    to the left-looking blocked factorization with kernel K3
    (`ops/hopper/panel.py`) on every diagonal panel (the JAX package takes
    library panels there; the factor is the same); "left" is the
    left-looking factorization with library panels, the JAX route exactly
    (`ops/linalg.left_cholesky`); "xla" is `torch.linalg.cholesky_ex`.
    "blocked" is not ported and is rejected.

    pallas_interpret is accepted so JAX configs carry over; the port ignores
    it (a kernel wrapper runs its plain version for CPU tensors).
    """

    nparams: int
    covariance: CovarianceFamily = CovarianceFamily.POWER_EXPONENTIAL
    regression_order: int = 1  # polynomial mean order 0..3
    power_exp_alpha: float = 2.0
    amp_bounds: Tuple[float, float] = (1e-4, 1e4)
    nugget_bounds: Tuple[float, float] = (1e-9, 1.0)
    length_scale_bounds: Tuple[float, float] = (1e-2, 1e1)
    # Stability floor added to the Gram diagonal on top of the nugget, as a
    # fraction of the amplitude. None = auto: 0 in float64, and at float32
    # max(1e-6, 12*sqrt(N)*eps) (ops/kernels.effective_jitter_frac).
    jitter: float | None = None
    n_restarts: int = 8
    max_opt_steps: int = 100
    # The predictive variance at new points includes the nugget.
    predict_variance_includes_nugget: bool = True
    reml: bool = False
    gram_method: str = "pallas"
    cholesky_method: str = "pallas"
    cholesky_block: int = 512
    pallas_cholesky_max_n: int = 1024
    pallas_interpret: bool = False
    cholesky_update_precision: str = "highest"
    # Batched predictions process queries in sequential chunks of this size
    # (None = auto: chunk past ~256 MB of (N, m) temporaries).
    predict_query_chunk: int | None = None
    linesearch: str = "zoom"

    def __post_init__(self):
        if self.regression_order not in (0, 1, 2, 3):
            raise ValueError(
                f"regression_order must be 0..3, got {self.regression_order}"
            )
        if self.nparams < 1:
            raise ValueError(f"nparams must be >= 1, got {self.nparams}")
        if self.gram_method not in ("xla", "pallas"):
            raise ValueError(f"unknown gram_method {self.gram_method!r}")
        if self.cholesky_method == "blocked":
            raise ValueError(
                "cholesky_method='blocked' is not ported to the PyTorch "
                "package; use 'left', 'pallas' or 'xla'"
            )
        if self.cholesky_method not in ("xla", "left", "pallas"):
            raise ValueError(
                f"unknown cholesky_method {self.cholesky_method!r}"
            )
        if self.cholesky_update_precision not in (
            "auto", "default", "high", "highest",
        ):
            raise ValueError(
                "unknown cholesky_update_precision "
                f"{self.cholesky_update_precision!r}"
            )

    @property
    def num_thetas(self) -> int:
        return self.covariance.num_thetas(self.nparams)

    @property
    def num_length_scales(self) -> int:
        return self.covariance.num_length_scales(self.nparams)

    @property
    def num_regression_fns(self) -> int:
        # per-dimension pure powers, no cross terms: 1 + order * nparams
        return 1 + self.regression_order * self.nparams
