"""The data recipe a configuration file names: `portbench/data/<kind>.py`,
a module with `make(recipe, seed, device) -> (X, y)` that draws the inputs
on the device from the run's seed in a few large draws. A kind with no
such file is refused."""

from __future__ import annotations

from portbench.harness import cell


def make(recipe: dict, seed: int, device) -> tuple:
    path = cell.HERE / "data" / f"{recipe['kind']}.py"
    if not path.is_file():
        raise ValueError(f"unknown data recipe {recipe['kind']!r}: no {path}")
    return cell.load_module(path).make(recipe, seed, device)
