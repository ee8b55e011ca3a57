"""One training step of a converted CNN, over a device mesh.

Counterpart of the JAX package's gnina_tpu/models/train.py: pose
classification (cross-entropy on the log-softmax head) plus affinity
regression (pseudo-Huber, with a hinge for poor poses), differentiated
through the same runtime that serves inference (models/runtime.execute),
and SGD with momentum 0.9 (torch.optim.SGD, optax's sgd(momentum=0.9):
the first step's momentum buffer is the gradient itself in both).

Sharding over a parallel.mesh.Mesh:
- "dp": the batch splits into one equal slice per mesh row.  Every row
  holds a replica of the parameters, computes its slice's share of the
  loss (its mean weighted by its share of the batch) and its gradients;
  the gradients are summed onto the first row's parameters before the
  step, so a sharded step equals the one-device step;
- "tp": a 2-D weight whose last dimension (the input features of a linear
  layer) is at least 1024 and divisible by tp (param_shardings, the JAX
  module's rule; the 27,648-wide heads of the default2018 models) is held
  as column blocks, one on each device of a row (ColumnShards): each block
  takes its slice of the features and the partial products are summed.
  The rest is replicated.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gnina_tpu_torch.models import runtime
from gnina_tpu_torch.parallel.mesh import Mesh

MOMENTUM = 0.9


def loss_fn(spec: dict, params, grids, labels, affinities):
    """Mean cross-entropy of the pose head at `labels` (B,) plus the mean
    pseudo-Huber of the affinity error; for a label-0 pose only an
    over-prediction counts (gnina_tpu/models/train.py:26-36)."""
    out = runtime.execute(spec, params, grids)
    logp, aff = out[0], out[1]            # (B, 2) log-probabilities, (B,)
    labels = labels.long()
    ce = -torch.mean(torch.gather(logp, 1, labels[:, None]))
    diff = aff - affinities
    diff = torch.where(labels == 1, diff, torch.clamp(diff, min=0.0))
    huber = torch.mean(torch.sqrt(1.0 + diff * diff) - 1.0)
    return ce + huber


class ColumnShards:
    """A 2-D weight split by columns over devices: blocks[i] holds the
    columns of widths[i] on its device.  F.linear(x, shards, b) computes
    each block's partial product on its device and sums them on x's
    device; autograd carries each block's gradient to it.  Nothing else
    takes it."""

    def __init__(self, blocks: List[torch.Tensor]):
        self.blocks = blocks
        self.widths = [int(b.shape[1]) for b in blocks]

    def full(self) -> torch.Tensor:
        """The whole weight on the first block's device."""
        dev = self.blocks[0].device
        return torch.cat([b.to(dev) for b in self.blocks], dim=1)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is not F.linear:
            raise NotImplementedError(
                f"a column-sharded weight takes only F.linear, not {func}")
        x, w = args[0], args[1]
        b = args[2] if len(args) > 2 else kwargs.get("bias")
        y = None
        for xi, bi in zip(torch.split(x, w.widths, dim=-1), w.blocks):
            part = F.linear(xi.to(bi.device), bi).to(x.device)
            y = part if y is None else y + part
        return y if b is None else y + b


def param_shardings(mesh: Mesh, params: Dict) -> Dict[str, tuple]:
    """(None, "tp") for a 2-D weight split by columns over "tp", () for a
    replicated one (gnina_tpu/models/train.py:39-49)."""
    tp = mesh.shape["tp"]
    out = {}
    for k, v in params.items():
        shape = tuple(v.shape)
        if len(shape) == 2 and shape[-1] % tp == 0 and shape[-1] >= 1024:
            out[k] = (None, "tp")
        else:
            out[k] = ()
    return out


def _place(mesh: Mesh, row: int, params: Dict, shardings: Dict) -> Dict:
    """Fresh leaf tensors of `params` on mesh row `row`: replicated ones on
    its first device, (None, "tp") ones as ColumnShards over its devices."""
    devs = mesh.row(row)
    tp = len(devs)
    out = {}
    for k, v in params.items():
        full = v.full() if isinstance(v, ColumnShards) else torch.as_tensor(
            np.asarray(v) if not torch.is_tensor(v) else v)
        full = full.detach().to(torch.float32)
        if shardings[k]:
            out[k] = ColumnShards([
                blk.to(d).clone().requires_grad_(True)
                for blk, d in zip(torch.chunk(full, tp, dim=1), devs)])
        else:
            out[k] = full.to(devs[0]).clone().requires_grad_(True)
    return out


def _leaves(params: Dict) -> List[torch.Tensor]:
    out = []
    for k in sorted(params):
        v = params[k]
        out.extend(v.blocks if isinstance(v, ColumnShards) else [v])
    return out


def gather_params(params: Dict) -> Dict[str, torch.Tensor]:
    """A copy of every parameter, whole, on the CPU (the step updates the
    placed tensors in place)."""
    return {k: (v.full() if isinstance(v, ColumnShards) else v).detach()
            .cpu().clone() for k, v in params.items()}


def make_train_step(mesh: Mesh, spec: dict, shardings: Dict) -> Callable:
    """train_step(params, opt_state, grids, labels, affinities) ->
    (params, opt_state, loss): one SGD step of the mesh-placed params."""
    spec = runtime.normalize_spec(spec)
    dp = mesh.shape["dp"]

    def train_step(params, opt_state, grids, labels, affinities):
        b = grids.shape[0]
        if b % dp:
            raise ValueError(f"batch {b} does not split over dp = {dp}")
        opt_state.zero_grad(set_to_none=True)
        master = _leaves(params)
        loss = None
        for r, (g, lab, aff) in enumerate(zip(
                grids.chunk(dp), labels.chunk(dp), affinities.chunk(dp))):
            dev = mesh.row(r)[0]
            rep = params if r == 0 else _place(mesh, r, params, shardings)
            part = loss_fn(spec, rep, g.to(dev), lab.to(dev),
                           aff.to(dev)) * (g.shape[0] / b)
            part.backward()
            if r:
                # sum the row's gradients onto the first row's parameters
                for m_, x in zip(master, _leaves(rep)):
                    gx = x.grad.to(m_.device)
                    m_.grad = gx if m_.grad is None else m_.grad + gx
            part = part.detach().to(mesh.row(0)[0])
            loss = part if loss is None else loss + part
        opt_state.step()
        return params, opt_state, loss

    return train_step


def train_setup(mesh: Mesh, spec: dict, params: Dict,
                learning_rate: float = 1e-3
                ) -> Tuple[Dict, torch.optim.Optimizer, Callable]:
    """Place `params` (numpy arrays or tensors) on the mesh and build
    (params, opt_state, train_step), the JAX function's triple: opt_state
    is the torch.optim.SGD over the placed parameters."""
    shardings = param_shardings(mesh, params)
    placed = _place(mesh, 0, params, shardings)
    opt = torch.optim.SGD(_leaves(placed), lr=learning_rate,
                          momentum=MOMENTUM)
    return placed, opt, make_train_step(mesh, spec, shardings)
