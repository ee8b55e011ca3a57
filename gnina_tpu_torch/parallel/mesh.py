"""Device meshes: the ligand batch over "dp", wide CNN layers over "tp".

Counterpart of the JAX package's gnina_tpu/parallel/mesh.py.  A Mesh is a
(dp, tp) array of torch devices:

  axis "dp"  ligand/pose batches, one slice per row, embarrassingly
             parallel (DockingEngine.dock_batch(mesh=) runs one shard per
             row with no collective in the inner loop);
  axis "tp"  the columns of the wide fully connected weights inside a
             row (models/train.py).

Placement is explicit: shard_ligand_batch puts each row's slice on that
row's device, replicate puts a copy on every device of the mesh.  A Mesh
may name one device more than once (Mesh.of(["cuda:0", "cuda:0"])): that
is how a sharded run is held to the unsharded one on a machine with one
card, or on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, tp) array of torch.device with axis names ("dp", "tp")."""

    devices: np.ndarray     # (dp, tp) object array of torch.device

    @classmethod
    def of(cls, devices: Sequence, dp: Optional[int] = None,
           tp: int = 1) -> "Mesh":
        """A mesh over the named devices (strings or torch.device)."""
        devs = [torch.device(d) for d in devices]
        n = len(devs)
        if dp is None:
            dp = n // tp
        if dp < 1 or dp * tp != n:
            raise ValueError(f"dp*tp = {dp}*{tp} != {n} devices")
        arr = np.empty(n, dtype=object)
        arr[:] = devs
        return cls(arr.reshape(dp, tp))

    @property
    def shape(self) -> dict:
        return {"dp": int(self.devices.shape[0]),
                "tp": int(self.devices.shape[1])}

    def row(self, i: int) -> List[torch.device]:
        """The devices of dp row i (its tp group)."""
        return list(self.devices[i])


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the first n_devices cards (torch.cuda.device_count()),
    or over `devices` when given (the CPU only when it is named there).
    dp defaults to n // tp; dp * tp must equal the device count."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("no CUDA device: name the devices (e.g. "
                               "devices=['cpu', 'cpu']) to build a mesh on "
                               "the CPU")
        devices = [f"cuda:{i}" for i in range(count)]
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked for, "
                             f"{len(devices)} present")
        devices = devices[:n_devices]
    return Mesh.of(devices, dp, tp)


def _map(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map(v, fn) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return tree


def shard_ligand_batch(mesh: Mesh, batch_tree) -> list:
    """Split every tensor of a stacked ligand/pose batch along its leading
    axis into dp equal slices: slice i on row i's first device."""
    dp = mesh.shape["dp"]

    def check(t):
        if t.shape[0] % dp:
            raise ValueError(f"leading axis {t.shape[0]} is not a multiple "
                             f"of dp = {dp}")
        return t

    _map(batch_tree, check)
    return [_map(batch_tree, lambda t, i=i: t.chunk(dp, dim=0)[i].to(
        mesh.devices[i, 0])) for i in range(dp)]


def replicate(mesh: Mesh, tree) -> list:
    """A copy of every tensor of `tree` on each device of the mesh, in
    mesh.devices.flat order."""
    return [_map(tree, lambda t, d=d: t.to(d)) for d in mesh.devices.flat]
