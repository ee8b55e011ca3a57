"""Legacy adaptive steepest-descent minimizer (--simple_ascent).

Reference: gninasrc/lib/ssd.h:29-47, ssd.cpp:26-45: Vina's pre-BFGS
minimizer, kept for parity with `minimization_params::type == Simple`.
The step factor grows by `up` on improvement and shrinks by `down` on
rejection; a pose stops after `evals` trials or once its factor drops
below `min_factor`.  Batched over a leading pose dimension: each pose runs
its own loop, masked once it has stopped.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from gnina_tpu_torch.ops.fk import conf_increment
from gnina_tpu_torch.types import Conf


@dataclasses.dataclass(frozen=True)
class SSDParams:
    evals: int = 300
    initial_factor: float = 1e-4
    min_factor: float = 1e-6
    up: float = 1.6
    down: float = 0.5


class SSDResult(NamedTuple):
    x: Conf
    f0: torch.Tensor
    g: torch.Tensor


def ssd(f: Callable, x0: Conf, params: SSDParams = SSDParams(),
        dof_mask=None) -> SSDResult:
    """Minimize f over pose DOF (ssd.cpp:26-45).

    f: Conf (B, ...) -> (energy (B,), flat gradient (B, D))."""
    with torch.no_grad():
        e, g = f(x0)
        if dof_mask is not None:
            g = torch.where(dof_mask, g, 0.0)
        x = x0
        factor = torch.full_like(e, params.initial_factor)
        for _ in range(params.evals):
            live = factor >= params.min_factor
            if not bool(live.any()):
                break
            cand = conf_increment(x, g, -factor)
            e_c, g_c = f(cand)
            if dof_mask is not None:
                g_c = torch.where(dof_mask, g_c, 0.0)
            ok = e_c <= e
            better = live & ok
            x = Conf(*[torch.where(better[:, None], a, b)
                       for a, b in zip(cand, x)])
            e = torch.where(better, e_c, e)
            g = torch.where(better[:, None], g_c, g)
            factor = torch.where(
                live, factor * torch.where(ok, params.up, params.down),
                factor)
        return SSDResult(x=x, f0=e, g=g)
