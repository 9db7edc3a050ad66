"""Trained-emulator snapshot, dense grammar versions 1-3, as text and as
numpy .npz (port of madaiemulator_tpu/io/snapshot.py: read_snapshot /
write_snapshot, read_snapshot_npz / write_snapshot_npz and the extension
routing of read_snapshot_auto / write_snapshot_auto).

Both encodings are shared with the JAX package (the text byte for byte, the
.npz key for key), so a snapshot written by either package loads in the
other. The text grammar:

    MADAIEMULATOR_TPU_SNAPSHOT <1|2>
    covariance <name> ; power_exp_alpha <float> ; regression_order <int>
    predict_variance_includes_nugget <0|1> ; pca_standardize <0|1>
    nparams <d> ; noutputs <t> ; npoints <N> ; ncomponents <r>
    d param names, t output names, design scaling (mins; ranges),
    PCA (ymean; ystd; eigenvalues; U t x r), scaled design X (N x d),
    PC scores Z (N x r), thetas (r x ntheta) [amp nugget ls...],
    and in version 2 the PC-space noise variances (N x r). Version 3 (a
    gradient-enhanced emulator) adds the header flags has_noise,
    has_gradients and has_gradient_noise after pca_standardize, and after
    the optional noise block the PC-space gradients ((N*d) x r,
    point-major) and, when flagged, their noise variances in the same
    layout.

'#' starts a comment that runs to the end of its line; floats are written
"%.17g" so float64 round-trips exactly. The .npz holds the same payload
as arrays under the JAX writer's keys (`write_snapshot_npz`; version 3 adds
dZ_pc and dZ_noise_pc, each (N, d, r)).

The sparse (SGPR) grammar (`write_snapshot_sparse` and the readers below)
stores the O(m^2) serve state itself, not the training set. The
multi-fidelity grammar (its own magic, version 1 scalar and version 2
multivariate, text and .npz; `write_snapshot_multifidelity` and the
readers below) stores each level's training data and thetas; the readers
rebuild every level's serve state. `read_snapshot_auto` and
`write_snapshot_auto` route all three grammars.
"""

from __future__ import annotations

from typing import List, TextIO, Tuple, Union

import numpy as np
import torch

from madaiemulator_tpu_torch.models.multivariate import (
    MultivariateEmulator,
    PCAState,
    emulator_from_numpy,
)
from madaiemulator_tpu_torch.models.sparse import (
    SGPRServeState,
    SparseMultivariateEmulator,
)
from madaiemulator_tpu_torch.ops.kernels import GPParams
from madaiemulator_tpu_torch.utils.config import COVARIANCE_CLI_NAMES, GPConfig
from madaiemulator_tpu_torch.utils.designs import DesignScaling

MAGIC = "MADAIEMULATOR_TPU_SNAPSHOT"
VERSION = 1
VERSION_NOISE = 2  # version 1 + a trailing (N x r) PC-space noise block
VERSION_GRADIENTS = 3  # + header flags and the PC-space gradient blocks
MAGIC_SGPR = "MADAIEMULATOR_TPU_SNAPSHOT_SGPR"
VERSION_SGPR = 1
MAGIC_MF = "MADAIEMULATOR_TPU_SNAPSHOT_MF"
VERSION_MF = 1  # scalar AR(1) co-kriging: per-level data, thetas, rho
VERSION_MF_MV = 2  # multivariate: a shared PCA block + component batches


def _fmt_vec(v) -> str:
    return " ".join(f"{float(x):.17g}" for x in np.asarray(v).ravel())


def _fmt_mat(M) -> str:
    return "\n".join(
        " ".join(f"{float(x):.17g}" for x in row) for row in np.asarray(M)
    )


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _gradients(emu):
    """(dZ, dZ_noise) of a dense emulator; the matrix-free
    IterativeMultivariateEmulator has neither."""
    return getattr(emu, "dZ", None), getattr(emu, "dZ_noise", None)


def _version(emu: MultivariateEmulator) -> int:
    if _gradients(emu)[0] is not None:
        return VERSION_GRADIENTS
    return VERSION if emu.noise is None else VERSION_NOISE


def _check_version(version: int) -> None:
    if version not in (VERSION, VERSION_NOISE, VERSION_GRADIENTS):
        raise ValueError(f"unsupported snapshot version {version}")


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
    version = _version(emu)
    dZ, dZ_noise = _gradients(emu)
    w(f"{MAGIC} {version}\n")
    w(f"covariance {cfg.covariance.value}\n")
    w(f"power_exp_alpha {cfg.power_exp_alpha:.17g}\n")
    w(f"regression_order {cfg.regression_order}\n")
    w(f"predict_variance_includes_nugget {int(cfg.predict_variance_includes_nugget)}\n")
    w(f"pca_standardize {int(pca_standardize)}\n")
    if version == VERSION_GRADIENTS:
        w(f"has_noise {int(emu.noise is not None)}\n")
        w(f"has_gradients {int(dZ is not None)}\n")
        w(f"has_gradient_noise {int(dZ_noise is not None)}\n")
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
    if dZ is not None:
        w("# PC-space gradient observations ((n*d) x r, point-major)\n")
        w(_fmt_mat(_np(dZ).reshape(n * d, r)) + "\n")
    if dZ_noise is not None:
        w("# PC-space gradient-noise variances ((n*d) x r, point-major)\n")
        w(_fmt_mat(_np(dZ_noise).reshape(n * d, r)) + "\n")


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
    `device` (the serve-time precompute). build_states=False skips the
    dense factorizations and returns an `IterativeMultivariateEmulator`
    (matrix-free serving, re-encoding, printing); a gradient-enhanced
    (version 3) snapshot then raises ValueError. Returns (emulator,
    param_names, output_names). The config uses the port's defaults, so at
    float32 the serve path runs on the Hopper kernels."""
    if isinstance(source, str):
        if source.endswith(".npz"):
            raise ValueError("an .npz snapshot: use read_snapshot_npz or "
                             "read_snapshot_auto")
        with open(source, "r") as f:
            return read_snapshot(f, device, dtype, build_states)
    toks = _Tokens(source.read())
    first = toks.one()
    if first == MAGIC_MF:
        raise ValueError("a multi-fidelity snapshot: use "
                         "read_snapshot_multifidelity or read_snapshot_auto")
    if first == MAGIC_SGPR:
        raise ValueError("a sparse (SGPR) snapshot: use read_snapshot_sparse "
                         "or read_snapshot_auto")
    if first != MAGIC:
        raise ValueError("not a madaiemulator_tpu snapshot")
    version = int(toks.one())
    _check_version(version)
    cov = COVARIANCE_CLI_NAMES[toks.expect("covariance")]
    alpha = float(toks.expect("power_exp_alpha"))
    order = int(toks.expect("regression_order"))
    pred_nug = bool(int(toks.expect("predict_variance_includes_nugget")))
    toks.expect("pca_standardize")  # metadata: ystd is applied directly
    if version == VERSION_GRADIENTS:
        has_noise, has_grad, has_grad_noise = (
            bool(int(toks.expect(k))) for k in
            ("has_noise", "has_gradients", "has_gradient_noise"))
    else:
        has_noise, has_grad, has_grad_noise = (
            version == VERSION_NOISE, False, False)
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
    if has_noise:
        arrays["noise"] = toks.mat(n, r)
    if has_grad:
        arrays["dZ"] = toks.mat(n * d, r).reshape(n, d, r)
    if has_grad_noise:
        arrays["dZ_noise"] = toks.mat(n * d, r).reshape(n, d, r)
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


def write_snapshot_npz(
    dest: str,
    emu: MultivariateEmulator,
    param_names: List[str] | None = None,
    output_names: List[str] | None = None,
) -> None:
    """Binary snapshot (numpy .npz, compressed): the text format's payload
    as arrays, under the JAX writer's keys and dtypes, so either package
    reads what the other wrote. Faster to parse than text at large N."""
    d = emu.X.shape[1]
    t = emu.n_outputs
    cfg = emu.config
    extra = {key: _np(a) for key, a in zip(("noise_pc", "dZ_pc",
                                            "dZ_noise_pc"),
                                           (emu.noise, *_gradients(emu)))
             if a is not None}
    np.savez_compressed(
        dest,
        magic=np.array([MAGIC]),
        version=np.array([_version(emu)]),
        covariance=np.array([cfg.covariance.value]),
        power_exp_alpha=np.array([cfg.power_exp_alpha]),
        regression_order=np.array([cfg.regression_order]),
        predict_variance_includes_nugget=np.array(
            [int(cfg.predict_variance_includes_nugget)]),
        # derived from the state: standardize=False stores ystd = ones
        pca_standardize=np.array([int(np.any(_np(emu.pca.ystd) != 1.0))]),
        param_names=np.array(
            list(param_names or [f"param_{i}" for i in range(d)])),
        output_names=np.array(
            list(output_names or [f"output_{i}" for i in range(t)])),
        mins=_np(emu.scaling.mins),
        ranges=_np(emu.scaling.ranges),
        ymean=_np(emu.pca.ymean),
        ystd=_np(emu.pca.ystd),
        eigenvalues=_np(emu.pca.eigenvalues),
        U=_np(emu.pca.U),
        X=_np(emu.X),
        Z=_np(emu.Z),
        log_amp=_np(emu.params.log_amp),
        log_nugget=_np(emu.params.log_nugget),
        log_ls=_np(emu.params.log_ls),
        **extra,
    )


def read_snapshot_npz(
    source: str,
    device,
    dtype: torch.dtype = torch.float64,
    build_states: bool = True,
) -> Tuple[MultivariateEmulator, List[str], List[str]]:
    """Load an .npz snapshot as `read_snapshot` loads a text one: the serve
    states rebuilt on `device`, or with build_states=False the matrix-free
    `IterativeMultivariateEmulator`. Returns (emulator, param_names,
    output_names)."""
    with np.load(source, allow_pickle=False) as z:
        magic = str(z["magic"][0])
        if magic == MAGIC_MF:
            raise ValueError(
                "a multi-fidelity .npz snapshot: use "
                "read_snapshot_multifidelity_npz or read_snapshot_auto")
        if magic == MAGIC_SGPR:
            raise ValueError("a sparse (SGPR) .npz snapshot: use "
                             "read_snapshot_sparse_npz or read_snapshot_auto")
        if magic != MAGIC:
            raise ValueError("not a madaiemulator_tpu npz snapshot")
        _check_version(int(z["version"][0]))
        cfg = GPConfig(
            nparams=int(z["X"].shape[1]),
            covariance=COVARIANCE_CLI_NAMES[str(z["covariance"][0])],
            regression_order=int(z["regression_order"][0]),
            power_exp_alpha=float(z["power_exp_alpha"][0]),
            predict_variance_includes_nugget=bool(
                int(z["predict_variance_includes_nugget"][0])),
        )
        arrays = {k: z[k] for k in ("mins", "ranges", "ymean", "ystd",
                                    "eigenvalues", "U", "X", "Z", "log_amp",
                                    "log_nugget", "log_ls")}
        for key, name in (("noise_pc", "noise"), ("dZ_pc", "dZ"),
                          ("dZ_noise_pc", "dZ_noise")):
            if key in z:
                arrays[name] = z[key]
        names = (list(map(str, z["param_names"])),
                 list(map(str, z["output_names"])))
    # the shared tail of both readers (the JAX package's
    # _assemble_multivariate): the container and its serve states
    emu = emulator_from_numpy(arrays, cfg, device=device, dtype=dtype,
                              build_states=build_states)
    return (emu, *names)


def write_snapshot_auto(
    dest: str,
    emu,
    param_names: List[str] | None = None,
    output_names: List[str] | None = None,
) -> None:
    """Dispatch on the container (dense multivariate, sparse or
    multi-fidelity) and on the extension ('.npz' -> binary, anything else
    -> text). output_names is a list for every family: the scalar
    multi-fidelity writers take its one entry."""
    from madaiemulator_tpu_torch.models.multifidelity import (
        MultiFidelityEmulator,
        MultivariateMultiFidelityEmulator,
    )

    npz = dest.endswith(".npz")
    if isinstance(emu, MultiFidelityEmulator):
        writer = (write_snapshot_multifidelity_npz if npz
                  else write_snapshot_multifidelity)
        writer(dest, emu, param_names,
               None if output_names is None else output_names[0])
        return
    if isinstance(emu, MultivariateMultiFidelityEmulator):
        writer = (write_snapshot_multifidelity_mv_npz if npz
                  else write_snapshot_multifidelity_mv)
    elif isinstance(emu, SparseMultivariateEmulator):
        writer = write_snapshot_sparse_npz if npz else write_snapshot_sparse
    else:
        writer = write_snapshot_npz if npz else write_snapshot
    writer(dest, emu, param_names, output_names)


def read_snapshot_auto(
    source: str,
    device,
    dtype: torch.dtype = torch.float64,
    build_states: bool = True,
):
    """Dispatch on the snapshot's own magic and on the extension ('.npz'
    -> binary, anything else -> text): a sparse (SGPR) snapshot returns a
    `SparseMultivariateEmulator` (its payload is the serve state;
    build_states does not apply), a dense one what `read_snapshot` /
    `read_snapshot_npz` return, a multi-fidelity one a
    `MultiFidelityEmulator` or `MultivariateMultiFidelityEmulator` with
    every level's serve state rebuilt (the levels are small by
    construction; build_states does not apply). Returns (emulator,
    param_names, output_names)."""
    if source.endswith(".npz"):
        with np.load(source, allow_pickle=False) as z:
            magic = str(z["magic"][0])
        if magic == MAGIC_MF:
            return read_snapshot_multifidelity_npz(source, device,
                                                   dtype=dtype)
        if magic == MAGIC_SGPR:
            return read_snapshot_sparse_npz(source, device, dtype=dtype)
        return read_snapshot_npz(source, device, dtype=dtype,
                                 build_states=build_states)
    with open(source, "r") as f:
        head = f.readline().split()
    if head and head[0] == MAGIC_MF:
        return read_snapshot_multifidelity(source, device, dtype=dtype)
    if head and head[0] == MAGIC_SGPR:
        return read_snapshot_sparse(source, device, dtype=dtype)
    return read_snapshot(source, device, dtype=dtype,
                         build_states=build_states)


# --- Sparse (SGPR) snapshots -------------------------------------------------
#
# Grammar (text; '#' comments; floats %.17g), the JAX package's:
#
#     MADAIEMULATOR_TPU_SNAPSHOT_SGPR 1
#     covariance <family> ; power_exp_alpha ; regression_order ;
#     predict_variance_includes_nugget ; pca_standardize
#     nparams <d> ; noutputs <t> ; ninducing <m> ; ncomponents <r>
#     param names (d), output names (t)
#     design scaling (mins; ranges)
#     pca: ymean; ystd; eigenvalues; U (t x r)
#     Z (m x d)                          shared inducing points, scaled
#     thetas (r x ntheta)                [amp nugget ls...] natural space
#     per component c = 0..r-1:
#         Lm (m x m)  lower chol(K_mm + jitter)
#         LB (m x m)  lower chol(I + A A^T)
#         c  (m)      LB^-1 A D^-1/2 (y - H beta)
#         beta (p)    GLS trend coefficients   (p = 1 + order*d)
#         LA (p x p)  lower chol(H^T Sigma^-1 H)
#         E  (m x p)  GLS variance operator
#
# The payload IS the serve state (models.sparse.SGPRServeState): a sparse
# fit's training set can be a million points. Lm is stored rather than
# rebuilt, so a state fitted at one dtype serves consistently at another.


def _check_sparse_ok(emu: SparseMultivariateEmulator) -> None:
    """Refuse to persist failed factorizations: `_sgpr_system` substitutes
    identity placeholders where a Cholesky fails (ok False), and neither the
    readers nor native/ have an ok flag."""
    ok = _np(emu.states.ok).reshape(-1)
    if not bool(np.all(ok)):
        bad = [int(i) for i in np.nonzero(~ok)[0]]
        raise ValueError(
            f"write_snapshot_sparse: component(s) {bad} carry FAILED "
            "factorizations (state.ok=False — identity placeholder "
            "factors); refusing to persist. Refit with different "
            "hyperparameter bounds or more restarts."
        )


def _sparse_header(emu: SparseMultivariateEmulator, param_names,
                   output_names):
    m, d = emu.Z.shape
    t = emu.n_outputs
    return (list(param_names or [f"param_{i}" for i in range(d)]),
            list(output_names or [f"output_{j}" for j in range(t)]),
            # derived from the state: standardize=False stores ystd = ones
            bool(np.any(_np(emu.pca.ystd) != 1.0)))


def write_snapshot_sparse(
    dest: Union[str, TextIO],
    emu: SparseMultivariateEmulator,
    param_names: List[str] | None = None,
    output_names: List[str] | None = None,
) -> None:
    """Persist a `SparseMultivariateEmulator` (the text grammar above; the
    JAX writer's bytes)."""
    _check_sparse_ok(emu)
    if isinstance(dest, str):
        with open(dest, "w") as f:
            write_snapshot_sparse(f, emu, param_names, output_names)
        return
    cfg = emu.config
    m, d = emu.Z.shape
    t = emu.n_outputs
    r = emu.n_components
    param_names, output_names, standardize = _sparse_header(
        emu, param_names, output_names)
    thetas = np.concatenate(
        [
            np.exp(_np(emu.params.log_amp))[:, None],
            np.exp(_np(emu.params.log_nugget))[:, None],
            np.exp(_np(emu.params.log_ls)).reshape(r, -1),
        ],
        axis=1,
    )
    w = dest.write
    w(f"{MAGIC_SGPR} {VERSION_SGPR}\n")
    w(f"covariance {cfg.covariance.value}\n")
    w(f"power_exp_alpha {cfg.power_exp_alpha:.17g}\n")
    w(f"regression_order {cfg.regression_order}\n")
    w(f"predict_variance_includes_nugget "
      f"{int(cfg.predict_variance_includes_nugget)}\n")
    w(f"pca_standardize {int(standardize)}\n")
    w(f"nparams {d}\nnoutputs {t}\nninducing {m}\nncomponents {r}\n")
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
    w("# inducing points Z (m x d), scaled\n")
    w(_fmt_mat(_np(emu.Z)) + "\n")
    w("# thetas per component (r x ntheta) [amp nugget ls...]\n")
    w(_fmt_mat(thetas) + "\n")
    st = SGPRServeState(*(_np(a) for a in emu.states))
    for c in range(r):
        w(f"# component {c}: Lm; LB; c; beta; LA; E\n")
        w(_fmt_mat(st.Lm[c]) + "\n")
        w(_fmt_mat(st.LB[c]) + "\n")
        w(_fmt_vec(st.c[c]) + "\n")
        w(_fmt_vec(st.beta[c]) + "\n")
        w(_fmt_mat(st.LA[c]) + "\n")
        w(_fmt_mat(st.E[c]) + "\n")


def _sparse_emulator(arrays, cfg: GPConfig, device,
                     dtype) -> SparseMultivariateEmulator:
    """The shared tail of both sparse readers: numpy arrays (the npz keys)
    -> the container on `device`, every factorization flagged ok (only
    successful ones are ever written)."""
    def t(key):  # a copy: the caller's arrays may be read-only views
        return torch.tensor(np.asarray(arrays[key]), dtype=dtype,
                            device=device)

    Z = t("Z")
    r, m, _ = np.shape(arrays["Lm"])
    states = SGPRServeState(
        Z=Z.expand(r, *Z.shape), Lm=t("Lm"), LB=t("LB"), c=t("c"),
        beta=t("beta"), LA=t("LA"), E=t("E"),
        ok=torch.ones((r,), dtype=torch.bool, device=device))
    return SparseMultivariateEmulator(
        scaling=DesignScaling(mins=t("mins"), ranges=t("ranges")),
        pca=PCAState(ymean=t("ymean"), ystd=t("ystd"),
                     eigenvalues=t("eigenvalues"), U=t("U")),
        Z=Z,
        params=GPParams(log_amp=t("log_amp"), log_nugget=t("log_nugget"),
                        log_ls=t("log_ls")),
        states=states, config=cfg)


def read_snapshot_sparse(
    source: Union[str, TextIO],
    device,
    dtype: torch.dtype = torch.float64,
) -> Tuple[SparseMultivariateEmulator, List[str], List[str]]:
    """Load a sparse snapshot, ready to serve on `device` (nothing is
    rebuilt). Returns (SparseMultivariateEmulator, param_names,
    output_names)."""
    if isinstance(source, str):
        with open(source, "r") as f:
            return read_snapshot_sparse(f, device, dtype)
    toks = _Tokens(source.read())
    if toks.one() != MAGIC_SGPR:
        raise ValueError("not a sparse (SGPR) snapshot")
    version = int(toks.one())
    if version != VERSION_SGPR:
        raise ValueError(f"unsupported sparse snapshot version {version}")
    cov = COVARIANCE_CLI_NAMES[toks.expect("covariance")]
    alpha = float(toks.expect("power_exp_alpha"))
    order = int(toks.expect("regression_order"))
    pred_nug = bool(int(toks.expect("predict_variance_includes_nugget")))
    toks.expect("pca_standardize")  # metadata: ystd carries the effect
    d = int(toks.expect("nparams"))
    t = int(toks.expect("noutputs"))
    m = int(toks.expect("ninducing"))
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
        "Z": toks.mat(m, d),
    }
    th = toks.mat(r, 2 + cov.num_length_scales(d))
    arrays["log_amp"] = np.log(th[:, 0])
    arrays["log_nugget"] = np.log(th[:, 1])
    arrays["log_ls"] = np.log(th[:, 2:])
    p = 1 + order * d
    blocks = {"Lm": [], "LB": [], "c": [], "beta": [], "LA": [], "E": []}
    for _ in range(r):
        blocks["Lm"].append(toks.mat(m, m))
        blocks["LB"].append(toks.mat(m, m))
        blocks["c"].append(toks.mat(1, m)[0])
        blocks["beta"].append(toks.mat(1, p)[0])
        blocks["LA"].append(toks.mat(p, p))
        blocks["E"].append(toks.mat(m, p))
    arrays.update({k: np.stack(v) for k, v in blocks.items()})
    cfg = GPConfig(nparams=d, covariance=cov, regression_order=order,
                   power_exp_alpha=alpha,
                   predict_variance_includes_nugget=pred_nug)
    return (_sparse_emulator(arrays, cfg, device, dtype), param_names,
            output_names)


def write_snapshot_sparse_npz(
    dest: str,
    emu: SparseMultivariateEmulator,
    param_names: List[str] | None = None,
    output_names: List[str] | None = None,
) -> None:
    """Binary sparse snapshot: the text grammar's payload under the JAX
    writer's keys and dtypes."""
    _check_sparse_ok(emu)
    cfg = emu.config
    param_names, output_names, standardize = _sparse_header(
        emu, param_names, output_names)
    st = emu.states
    np.savez_compressed(
        dest,
        magic=np.array([MAGIC_SGPR]),
        version=np.array([VERSION_SGPR]),
        covariance=np.array([cfg.covariance.value]),
        power_exp_alpha=np.array([cfg.power_exp_alpha]),
        regression_order=np.array([cfg.regression_order]),
        predict_variance_includes_nugget=np.array(
            [int(cfg.predict_variance_includes_nugget)]),
        pca_standardize=np.array([int(standardize)]),
        param_names=np.array(param_names),
        output_names=np.array(output_names),
        mins=_np(emu.scaling.mins),
        ranges=_np(emu.scaling.ranges),
        ymean=_np(emu.pca.ymean),
        ystd=_np(emu.pca.ystd),
        eigenvalues=_np(emu.pca.eigenvalues),
        U=_np(emu.pca.U),
        Z=_np(emu.Z),
        log_amp=_np(emu.params.log_amp),
        log_nugget=_np(emu.params.log_nugget),
        log_ls=_np(emu.params.log_ls),
        Lm=_np(st.Lm),
        LB=_np(st.LB),
        c=_np(st.c),
        beta=_np(st.beta),
        LA=_np(st.LA),
        E=_np(st.E),
    )


def read_snapshot_sparse_npz(
    source: str,
    device,
    dtype: torch.dtype = torch.float64,
) -> Tuple[SparseMultivariateEmulator, List[str], List[str]]:
    """Binary twin of `read_snapshot_sparse`."""
    with np.load(source, allow_pickle=False) as z:
        if (str(z["magic"][0]) != MAGIC_SGPR
                or int(z["version"][0]) != VERSION_SGPR):
            raise ValueError("not a sparse (SGPR) .npz snapshot")
        cfg = GPConfig(
            nparams=int(z["mins"].shape[0]),
            covariance=COVARIANCE_CLI_NAMES[str(z["covariance"][0])],
            regression_order=int(z["regression_order"][0]),
            power_exp_alpha=float(z["power_exp_alpha"][0]),
            predict_variance_includes_nugget=bool(
                int(z["predict_variance_includes_nugget"][0])),
        )
        arrays = {k: z[k] for k in (
            "mins", "ranges", "ymean", "ystd", "eigenvalues", "U", "Z",
            "log_amp", "log_nugget", "log_ls", "Lm", "LB", "c", "beta", "LA",
            "E")}
        names = (list(map(str, z["param_names"])),
                 list(map(str, z["output_names"])))
        return (_sparse_emulator(arrays, cfg, device, dtype), *names)


# --- Multi-fidelity (AR(1) co-kriging) snapshots ------------------------------
#
# Their own magic and grammar, the JAX package's (text byte for byte, .npz
# key for key):
#
#     MADAIEMULATOR_TPU_SNAPSHOT_MF 1
#     covariance ; power_exp_alpha ; regression_order ;
#     predict_variance_includes_nugget
#     nparams <d> ; nlevels <L>
#     param names (d), output name (1)
#     design scaling (mins; ranges)
#     per level k: "level k N_k has_noise", thetas [amp nugget ls...],
#         "rho <float>" (k >= 1), scaled design (N_k x d), targets (N_k),
#         the lower-fidelity column (N_k, k >= 1), noise (N_k, if flagged)
#
# Version 2 (multivariate) adds pca_standardize after the four config
# lines, noutputs / ncomponents before nlevels, t output names, the shared
# PCA block (ymean; ystd; eigenvalues; U t x r) after the scaling, and per
# level thetas (r x ntheta), "rho <r floats>", X (N_k x d), Z (N_k x r),
# H (N_k x r, k >= 1) and noise (N_k x r, if flagged). The payload holds no
# factorization: the readers rebuild every level's serve state (the
# levels are small by construction).


def _theta_row(params: GPParams) -> np.ndarray:
    return np.concatenate([
        np.exp(_np(params.log_amp))[None],
        np.exp(_np(params.log_nugget))[None],
        np.exp(_np(params.log_ls)).ravel(),
    ])


def _theta_rows(params: GPParams, r: int) -> np.ndarray:
    return np.column_stack([
        np.exp(_np(params.log_amp)),
        np.exp(_np(params.log_nugget)),
        np.exp(_np(params.log_ls)).reshape(r, -1),
    ])


def _mf_config_lines(w, cfg: GPConfig, version: int) -> None:
    w(f"{MAGIC_MF} {version}\n")
    w(f"covariance {cfg.covariance.value}\n")
    w(f"power_exp_alpha {cfg.power_exp_alpha:.17g}\n")
    w(f"regression_order {cfg.regression_order}\n")
    w(f"predict_variance_includes_nugget "
      f"{int(cfg.predict_variance_includes_nugget)}\n")


def write_snapshot_multifidelity(
    dest: Union[str, TextIO],
    emu,
    param_names: List[str] | None = None,
    output_name: str | None = None,
) -> None:
    """Persist a trained `MultiFidelityEmulator` (grammar version 1)."""
    if isinstance(dest, str):
        with open(dest, "w") as f:
            write_snapshot_multifidelity(f, emu, param_names, output_name)
        return
    L = emu.n_levels
    d = emu.levels[0].data.X.shape[1]
    param_names = list(param_names or [f"param_{i}" for i in range(d)])
    w = dest.write
    _mf_config_lines(w, emu.config, VERSION_MF)
    w(f"nparams {d}\nnlevels {L}\n")
    for s in param_names:
        w(f"{s}\n")
    w(f"{output_name or 'output_0'}\n")
    w("# design scaling (mins; ranges)\n")
    w(_fmt_vec(_np(emu.scaling.mins)) + "\n")
    w(_fmt_vec(_np(emu.scaling.ranges)) + "\n")
    for k, lv in enumerate(emu.levels):
        nk = lv.data.X.shape[0]
        has_noise = int(lv.data.noise is not None)
        w(f"level {k} {nk} {has_noise}\n")
        w("# thetas [amp nugget ls...]\n")
        w(_fmt_vec(_theta_row(lv.params)) + "\n")
        if k > 0:
            w(f"rho {float(_np(lv.rho)):.17g}\n")
        w(f"# level {k}: scaled design ({nk} x {d}); targets; "
          + ("lower-fidelity column; " if k > 0 else "")
          + ("noise" if has_noise else "") + "\n")
        w(_fmt_mat(_np(lv.data.X)) + "\n")
        w(_fmt_vec(_np(lv.data.y)) + "\n")
        if k > 0:
            w(_fmt_vec(_np(lv.data.h_extra[:, 0])) + "\n")
        if has_noise:
            w(_fmt_vec(_np(lv.data.noise)) + "\n")


def _mf_config(d: int, cov, alpha, order, pred_nug) -> GPConfig:
    return GPConfig(nparams=d, covariance=cov, regression_order=order,
                    power_exp_alpha=alpha,
                    predict_variance_includes_nugget=pred_nug)


def _mf_level(arrays: dict, k: int, cfg: GPConfig, device, dtype):
    """Level k of a scalar multi-fidelity emulator from its arrays (the
    .npz keys): the serve state rebuilt on `device`."""
    from madaiemulator_tpu_torch.models.gp import (
        GPData,
        precompute_predictor,
    )
    from madaiemulator_tpu_torch.models.multifidelity import FidelityLevel

    def t(key):
        return torch.tensor(np.asarray(arrays[key]), dtype=dtype,
                            device=device)

    params = GPParams(log_amp=t(f"log_amp_{k}"),
                      log_nugget=t(f"log_nugget_{k}"),
                      log_ls=t(f"log_ls_{k}"))
    data = GPData(
        X=t(f"X_{k}"), y=t(f"y_{k}"),
        noise=t(f"noise_{k}") if f"noise_{k}" in arrays else None,
        h_extra=t(f"h_{k}")[:, None] if k > 0 else None)
    rho = (t(f"rho_{k}").reshape(()) if k > 0
           else torch.zeros((), dtype=dtype, device=device))
    return FidelityLevel(data=data, params=params,
                         state=precompute_predictor(params, data, cfg),
                         rho=rho)


def _mf_mv_level(arrays: dict, k: int, r: int, cfg: GPConfig, device, dtype):
    """Level k of a multivariate multi-fidelity emulator from its arrays:
    the component-batched serve states rebuilt on `device`."""
    from madaiemulator_tpu_torch.models.multifidelity import MVFidelityLevel
    from madaiemulator_tpu_torch.models.multivariate import _vmapped_states

    def t(key):
        return torch.tensor(np.asarray(arrays[key]), dtype=dtype,
                            device=device)

    params = GPParams(log_amp=t(f"log_amp_{k}"),
                      log_nugget=t(f"log_nugget_{k}"),
                      log_ls=t(f"log_ls_{k}"))
    X, Z = t(f"X_{k}"), t(f"Z_{k}")
    H = t(f"H_{k}") if k > 0 else None
    nz = t(f"noise_{k}") if f"noise_{k}" in arrays else None
    rho = (t(f"rho_{k}") if k > 0
           else torch.zeros((r,), dtype=dtype, device=device))
    states = _vmapped_states(params, X, Z, cfg, noise_pc=nz, H_pc=H)
    return MVFidelityLevel(X=X, Z=Z, H=H, noise=nz, params=params,
                           states=states, rho=rho)


def _mf_scaling(arrays: dict, device, dtype) -> DesignScaling:
    return DesignScaling(
        mins=torch.tensor(np.asarray(arrays["mins"]), dtype=dtype,
                          device=device),
        ranges=torch.tensor(np.asarray(arrays["ranges"]), dtype=dtype,
                            device=device))


def _mf_pca(arrays: dict, device, dtype) -> PCAState:
    return PCAState(*(torch.tensor(np.asarray(arrays[k]), dtype=dtype,
                                   device=device)
                      for k in ("ymean", "ystd", "eigenvalues", "U")))


def read_snapshot_multifidelity(
    source: Union[str, TextIO],
    device,
    dtype: torch.dtype = torch.float64,
):
    """Load a multi-fidelity text snapshot (version 1 or 2) and rebuild
    every level's serve state on `device`. Returns (MultiFidelityEmulator,
    param_names, [output_name]) or (MultivariateMultiFidelityEmulator,
    param_names, output_names)."""
    from madaiemulator_tpu_torch.models.multifidelity import (
        MultiFidelityEmulator,
    )

    if isinstance(source, str):
        with open(source, "r") as f:
            return read_snapshot_multifidelity(f, device, dtype)
    toks = _Tokens(source.read())
    if toks.one() != MAGIC_MF:
        raise ValueError("not a multi-fidelity snapshot")
    version = int(toks.one())
    if version == VERSION_MF_MV:
        return _read_mf_mv_body(toks, device, dtype)
    if version != VERSION_MF:
        raise ValueError(
            f"unsupported multi-fidelity snapshot version {version}")
    cov = COVARIANCE_CLI_NAMES[toks.expect("covariance")]
    alpha = float(toks.expect("power_exp_alpha"))
    order = int(toks.expect("regression_order"))
    pred_nug = bool(int(toks.expect("predict_variance_includes_nugget")))
    d = int(toks.expect("nparams"))
    L = int(toks.expect("nlevels"))
    param_names = toks.take(d)
    output_name = toks.one()
    arrays = {"mins": toks.mat(1, d)[0], "ranges": toks.mat(1, d)[0]}
    ntheta = 2 + cov.num_length_scales(d)
    cfg = _mf_config(d, cov, alpha, order, pred_nug)
    levels = []
    for k in range(L):
        kk = int(toks.expect("level"))
        if kk != k:
            raise ValueError(f"snapshot: expected level {k}, got {kk}")
        nk = int(toks.one())
        has_noise = bool(int(toks.one()))
        theta = toks.mat(1, ntheta)[0]
        a = {f"log_amp_{k}": np.log(theta[0]),
             f"log_nugget_{k}": np.log(theta[1]),
             f"log_ls_{k}": np.log(theta[2:])}
        if k > 0:
            a[f"rho_{k}"] = float(toks.expect("rho"))
        a[f"X_{k}"] = toks.mat(nk, d)
        a[f"y_{k}"] = toks.mat(1, nk)[0]
        if k > 0:
            a[f"h_{k}"] = toks.mat(1, nk)[0]
        if has_noise:
            a[f"noise_{k}"] = toks.mat(1, nk)[0]
        levels.append(_mf_level(a, k, cfg, device, dtype))
    emu = MultiFidelityEmulator(scaling=_mf_scaling(arrays, device, dtype),
                                levels=tuple(levels), config=cfg)
    return emu, param_names, [output_name]


def write_snapshot_multifidelity_mv(
    dest: Union[str, TextIO],
    emu,
    param_names: List[str] | None = None,
    output_names: List[str] | None = None,
) -> None:
    """Persist a `MultivariateMultiFidelityEmulator` (grammar version 2:
    the shared PCA block and the component-batched per-level payloads)."""
    if isinstance(dest, str):
        with open(dest, "w") as f:
            write_snapshot_multifidelity_mv(f, emu, param_names,
                                            output_names)
        return
    L = emu.n_levels
    t = emu.n_outputs
    r = emu.n_components
    d = emu.levels[0].X.shape[1]
    param_names = list(param_names or [f"param_{i}" for i in range(d)])
    output_names = list(output_names or [f"output_{j}" for j in range(t)])
    standardize = bool(np.any(_np(emu.pca.ystd) != 1.0))
    w = dest.write
    _mf_config_lines(w, emu.config, VERSION_MF_MV)
    w(f"pca_standardize {int(standardize)}\n")
    w(f"nparams {d}\nnoutputs {t}\nncomponents {r}\nnlevels {L}\n")
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
    for k, lv in enumerate(emu.levels):
        nk = lv.X.shape[0]
        has_noise = int(lv.noise is not None)
        w(f"level {k} {nk} {has_noise}\n")
        thetas = _theta_rows(lv.params, r)
        w(f"# thetas ({r} x {thetas.shape[1]}) [amp nugget ls...]\n")
        w(_fmt_mat(thetas) + "\n")
        if k > 0:
            w(f"rho {_fmt_vec(_np(lv.rho))}\n")
        w(f"# level {k}: scaled design ({nk} x {d}); Z ({nk} x {r}); "
          + ("H; " if k > 0 else "")
          + ("noise" if has_noise else "") + "\n")
        w(_fmt_mat(_np(lv.X)) + "\n")
        w(_fmt_mat(_np(lv.Z)) + "\n")
        if k > 0:
            w(_fmt_mat(_np(lv.H)) + "\n")
        if has_noise:
            w(_fmt_mat(_np(lv.noise)) + "\n")


def _read_mf_mv_body(toks: _Tokens, device, dtype):
    """The version-2 text body (the token stream past the version)."""
    from madaiemulator_tpu_torch.models.multifidelity import (
        MultivariateMultiFidelityEmulator,
    )

    cov = COVARIANCE_CLI_NAMES[toks.expect("covariance")]
    alpha = float(toks.expect("power_exp_alpha"))
    order = int(toks.expect("regression_order"))
    pred_nug = bool(int(toks.expect("predict_variance_includes_nugget")))
    toks.expect("pca_standardize")  # metadata: ystd is applied directly
    d = int(toks.expect("nparams"))
    t = int(toks.expect("noutputs"))
    r = int(toks.expect("ncomponents"))
    L = int(toks.expect("nlevels"))
    param_names = toks.take(d)
    output_names = toks.take(t)
    arrays = {
        "mins": toks.mat(1, d)[0],
        "ranges": toks.mat(1, d)[0],
        "ymean": toks.mat(1, t)[0],
        "ystd": toks.mat(1, t)[0],
        "eigenvalues": toks.mat(1, r)[0],
        "U": toks.mat(t, r),
    }
    cfg = _mf_config(d, cov, alpha, order, pred_nug)
    ntheta = 2 + cov.num_length_scales(d)
    levels = []
    for k in range(L):
        kk = int(toks.expect("level"))
        if kk != k:
            raise ValueError(f"snapshot: expected level {k}, got {kk}")
        nk = int(toks.one())
        has_noise = bool(int(toks.one()))
        thetas = toks.mat(r, ntheta)
        a = {f"log_amp_{k}": np.log(thetas[:, 0]),
             f"log_nugget_{k}": np.log(thetas[:, 1]),
             f"log_ls_{k}": np.log(thetas[:, 2:])}
        if k > 0:
            first = float(toks.expect("rho"))
            a[f"rho_{k}"] = np.concatenate([[first], toks.mat(1, r - 1)[0]])
        a[f"X_{k}"] = toks.mat(nk, d)
        a[f"Z_{k}"] = toks.mat(nk, r)
        if k > 0:
            a[f"H_{k}"] = toks.mat(nk, r)
        if has_noise:
            a[f"noise_{k}"] = toks.mat(nk, r)
        levels.append(_mf_mv_level(a, k, r, cfg, device, dtype))
    emu = MultivariateMultiFidelityEmulator(
        scaling=_mf_scaling(arrays, device, dtype),
        pca=_mf_pca(arrays, device, dtype), levels=tuple(levels), config=cfg)
    return emu, param_names, output_names


def _mf_npz_header(emu, version: int, param_names, d: int) -> dict:
    cfg = emu.config
    return dict(
        magic=np.array([MAGIC_MF]),
        version=np.array([version]),
        covariance=np.array([cfg.covariance.value]),
        power_exp_alpha=np.array([cfg.power_exp_alpha]),
        regression_order=np.array([cfg.regression_order]),
        predict_variance_includes_nugget=np.array(
            [int(cfg.predict_variance_includes_nugget)]),
        nlevels=np.array([emu.n_levels]),
        param_names=np.array(
            list(param_names or [f"param_{i}" for i in range(d)])),
    )


def write_snapshot_multifidelity_npz(
    dest: str,
    emu,
    param_names: List[str] | None = None,
    output_name: str | None = None,
) -> None:
    """Binary scalar multi-fidelity snapshot: the text grammar's payload,
    per-level arrays suffixed _<k>, under the JAX writer's keys."""
    d = emu.levels[0].data.X.shape[1]
    arrays = {}
    for k, lv in enumerate(emu.levels):
        arrays[f"X_{k}"] = _np(lv.data.X)
        arrays[f"y_{k}"] = _np(lv.data.y)
        arrays[f"log_amp_{k}"] = _np(lv.params.log_amp)
        arrays[f"log_nugget_{k}"] = _np(lv.params.log_nugget)
        arrays[f"log_ls_{k}"] = _np(lv.params.log_ls)
        if k > 0:
            arrays[f"h_{k}"] = _np(lv.data.h_extra[:, 0])
            arrays[f"rho_{k}"] = _np(lv.rho)
        if lv.data.noise is not None:
            arrays[f"noise_{k}"] = _np(lv.data.noise)
    np.savez_compressed(
        dest, **_mf_npz_header(emu, VERSION_MF, param_names, d),
        output_name=np.array([output_name or "output_0"]),
        mins=_np(emu.scaling.mins), ranges=_np(emu.scaling.ranges),
        **arrays)


def write_snapshot_multifidelity_mv_npz(
    dest: str,
    emu,
    param_names: List[str] | None = None,
    output_names: List[str] | None = None,
) -> None:
    """Binary multivariate multi-fidelity snapshot (version 2): the text
    grammar's payload, per-level arrays suffixed _<k>."""
    d = emu.levels[0].X.shape[1]
    t = emu.n_outputs
    arrays = {}
    for k, lv in enumerate(emu.levels):
        arrays[f"X_{k}"] = _np(lv.X)
        arrays[f"Z_{k}"] = _np(lv.Z)
        arrays[f"log_amp_{k}"] = _np(lv.params.log_amp)
        arrays[f"log_nugget_{k}"] = _np(lv.params.log_nugget)
        arrays[f"log_ls_{k}"] = _np(lv.params.log_ls)
        if k > 0:
            arrays[f"H_{k}"] = _np(lv.H)
            arrays[f"rho_{k}"] = _np(lv.rho)
        if lv.noise is not None:
            arrays[f"noise_{k}"] = _np(lv.noise)
    np.savez_compressed(
        dest, **_mf_npz_header(emu, VERSION_MF_MV, param_names, d),
        output_names=np.array(
            list(output_names or [f"output_{j}" for j in range(t)])),
        mins=_np(emu.scaling.mins), ranges=_np(emu.scaling.ranges),
        ymean=_np(emu.pca.ymean), ystd=_np(emu.pca.ystd),
        eigenvalues=_np(emu.pca.eigenvalues), U=_np(emu.pca.U),
        **arrays)


def read_snapshot_multifidelity_npz(
    source: str,
    device,
    dtype: torch.dtype = torch.float64,
):
    """Binary twin of `read_snapshot_multifidelity` (version 1 or 2)."""
    from madaiemulator_tpu_torch.models.multifidelity import (
        MultiFidelityEmulator,
        MultivariateMultiFidelityEmulator,
    )

    with np.load(source, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    version = int(arrays["version"][0])
    if (str(arrays["magic"][0]) != MAGIC_MF
            or version not in (VERSION_MF, VERSION_MF_MV)):
        raise ValueError("not a compatible multi-fidelity npz snapshot")
    cfg = _mf_config(
        int(arrays["mins"].shape[0]),
        COVARIANCE_CLI_NAMES[str(arrays["covariance"][0])],
        float(arrays["power_exp_alpha"][0]),
        int(arrays["regression_order"][0]),
        bool(int(arrays["predict_variance_includes_nugget"][0])))
    L = int(arrays["nlevels"][0])
    scaling = _mf_scaling(arrays, device, dtype)
    param_names = list(map(str, arrays["param_names"]))
    if version == VERSION_MF_MV:
        pca = _mf_pca(arrays, device, dtype)
        r = pca.U.shape[1]
        levels = tuple(_mf_mv_level(arrays, k, r, cfg, device, dtype)
                       for k in range(L))
        emu = MultivariateMultiFidelityEmulator(
            scaling=scaling, pca=pca, levels=levels, config=cfg)
        return emu, param_names, list(map(str, arrays["output_names"]))
    levels = tuple(_mf_level(arrays, k, cfg, device, dtype)
                   for k in range(L))
    emu = MultiFidelityEmulator(scaling=scaling, levels=levels, config=cfg)
    return emu, param_names, [str(arrays["output_name"][0])]
