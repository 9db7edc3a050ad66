"""A device mesh and the few helpers every sharded path uses (the port's
counterpart of `jax.sharding.Mesh` and of the GSPMD placement the JAX
package's multi-device paths rely on).

JAX runs those paths as one program: arrays carry sharding annotations and
XLA inserts the collectives. PyTorch has no sharded tensor that this
package uses, so the port keeps JAX's single-controller semantics with an
explicit mesh: one Python caller

  * splits a tensor along an axis into contiguous shards (`blocks`,
    `split`), padded as the JAX function pads, where it pads;
  * moves each shard to its device (`place`);
  * runs a function on every shard (`Mesh.map`);
  * gathers the shards (`gather`), or sums their partials (`sum_partials`),
    onto one device, the mesh's first as a rule.

Concurrency. The calling thread runs the shards in turn, each under its
device's guard. CUDA launches return before the work is done, so the
shards of a call that reads nothing back (the matvec, the ELBO's sums, the
factor's panels, a walker block's log-posterior) run on their cards at
once, and the gather waits for them; a shard that reads values back (an
ensemble shard's lock-step L-BFGS) holds the caller until it is done, so
such shards on several cards do not overlap. A worker thread per card was
measured first, on four H100s: the threads contend for the GIL at every
read-back and at every Python autograd node, and a config-5 fit over 4
cards took 31.9 s against 10.3 s in turn on one card, the sharded matvec
36.7 ms against 18.1 ms unsharded. A mesh whose slots repeat one device
(a virtual mesh, the counterpart of the JAX tests'
`--xla_force_host_platform_device_count=8`) works the same way. Autograd
records every shard's work, so a backward from the caller reaches every
device.

Outputs come back gathered onto one device (the mesh's first), where JAX
returns arrays sharded over the mesh: a deliberate difference.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch


def _norm(device) -> torch.device:
    """A torch.device with its index filled in for CUDA, so that devices
    compare equal to the ones tensors report."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices(n_devices: Optional[int], devices, who: str
                    ) -> List[torch.device]:
    """The devices a mesh constructor uses: `devices` when given (a device
    may repeat: a virtual mesh), else the first n_devices visible CUDA
    devices (all of them by default). No CUDA device raises: a mesh never
    falls back to the CPU on its own."""
    if devices is not None:
        devs = [_norm(d) for d in devices]
        if not devs:
            raise ValueError(f"{who}: devices is empty")
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"{who}: n_devices={n_devices} but "
                             f"{len(devs)} devices were listed")
        return devs
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device is visible (pass devices=[...] for an "
            "explicit, e.g. virtual, mesh)")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"{who}: n_devices must be >= 1, got {n}")
    if n > count:
        raise ValueError(f"{who}: need {n} devices, found {count}")
    return [torch.device("cuda", i) for i in range(n)]


class Mesh:
    """Devices laid out on named axes.

    devices: a numpy object array of torch.device, shaped by the axes;
    axis_names: their names; shape: axis name -> size (as in JAX); size:
    the number of slots. A device may fill several slots (a virtual mesh).
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        flat = [_norm(d) for d in np.asarray(devices, dtype=object).flat]
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(np.shape(np.asarray(devices,
                                                       dtype=object)))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"Mesh: devices of shape {self.devices.shape} do not match "
                f"the axes {self.axis_names}")
        if self.devices.size == 0:
            raise ValueError("Mesh: no devices")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def first(self) -> torch.device:
        """The device sharded results are gathered onto."""
        return self.devices.flat[0]

    @property
    def distinct(self) -> List[torch.device]:
        """Each device once, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))

    def axis_devices(self, name: str) -> List[torch.device]:
        """The devices along one axis (index 0 on every other axis): where
        an array sharded on that axis alone lives, one shard each."""
        i = self.axis_names.index(name)
        idx = [0] * self.devices.ndim
        idx[i] = slice(None)
        return list(self.devices[tuple(idx)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.distinct]})"

    def map(self, devices: Sequence[torch.device], fn: Callable,
            *per_shard: Sequence) -> list:
        """[fn(*(a[i] for a in per_shard)) for shard i on devices[i]], in
        shard order, each under its device's guard, from the calling thread
        (see the module docstring)."""
        devices = [_norm(d) for d in devices]
        results = []
        for i, dev in enumerate(devices):
            with _guard(dev):
                results.append(fn(*(a[i] for a in per_shard)))
        return results


def _guard(dev: torch.device):
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def check_mesh(mesh, who: str) -> None:
    """Raise unless `mesh` is None or a `Mesh`."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"{who}: mesh must be a parallel.mesh.Mesh, got "
                        f"{type(mesh).__name__}")


def blocks(n: int, parts: int) -> List[Tuple[int, int]]:
    """[start, end) of `parts` contiguous blocks of n items, ceil(n / parts)
    each, the last ones shorter (or empty): the layout of an axis of n
    sharded over `parts` slots (the JAX package pads the short ones)."""
    size = -(-n // parts)
    return [(min(i * size, n), min((i + 1) * size, n)) for i in range(parts)]


def split(t: torch.Tensor, parts: int, dim: int = 0, wrap: bool = False
          ) -> List[torch.Tensor]:
    """`parts` contiguous shards of t along dim (`blocks`). wrap=True pads
    t first with its own leading entries, wrapping when the pad exceeds n
    (the JAX package's `jnp.arange(pad) % m`), so the shards are equal."""
    n = t.shape[dim]
    extra = (-n) % parts
    if wrap and extra:
        idx = torch.arange(extra, device=t.device) % n
        t = torch.cat([t, t.index_select(dim, idx)], dim=dim)
        n += extra
    return [t.narrow(dim, a, b - a) for a, b in blocks(n, parts)]


def place(shards: Sequence[torch.Tensor], devices: Sequence[torch.device]
          ) -> List[torch.Tensor]:
    """Each shard moved to its device (a differentiable copy; no copy where
    it already lies there)."""
    return [s.to(d) for s, d in zip(shards, devices)]


def gather(parts: Sequence[torch.Tensor], device, dim: int = 0
           ) -> torch.Tensor:
    """The shards concatenated along dim on `device`."""
    device = _norm(device)
    return torch.cat([p.to(device) for p in parts], dim=dim)


def sum_partials(parts: Sequence, device):
    """The partials summed on `device`, shard 0 first; tuples (and tuples
    of tuples) of tensors are summed entry by entry."""
    device = _norm(device)
    first = parts[0]
    if isinstance(first, (tuple, list)):
        return type(first)(sum_partials([p[i] for p in parts], device)
                           for i in range(len(first)))
    total = first.to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def replicate(obj, device):
    """A copy of obj with every tensor inside it (NamedTuples, tuples,
    lists, dicts) moved to `device`; anything else is shared. Used to put
    a trained emulator's serve states on each device of a mesh, as GSPMD
    replicates a jitted closure's constants."""
    device = _norm(device)
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(replicate(v, device) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(replicate(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: replicate(v, device) for k, v in obj.items()}
    return obj
