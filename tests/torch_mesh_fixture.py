"""A well-conditioned copy of the multivariate golden snapshot, shared by
tests/test_torch_mesh.py and tests/test_torch_sharded.py."""

import pathlib

GOLDEN_MV = (pathlib.Path(__file__).resolve().parent / "golden"
             / "multivar_pca" / "state.txt")
THETAS = "# thetas per component (r x ntheta) [amp nugget ls...]"


def conditioned_golden(directory: pathlib.Path, nugget: str = "0.05") -> str:
    """The multivariate golden (N=40, d=3, t=6, r=2) with every
    component's nugget set to `nugget`, written to directory/state.txt: at
    the golden's 1e-9 two LAPACKs serve ~1e-7 apart, a float64 floor that
    would hide what the sharded paths do (tests/test_torch_serve.py holds
    the goldens at 1e-6)."""
    lines = GOLDEN_MV.read_text().splitlines()
    i = lines.index(THETAS)
    for k in (i + 1, i + 2):
        row = lines[k].split()
        row[1] = nugget
        lines[k] = " ".join(row)
    path = pathlib.Path(directory) / "state.txt"
    path.write_text("\n".join(lines) + "\n")
    return str(path)
