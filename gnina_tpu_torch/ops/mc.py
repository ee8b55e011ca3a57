"""Monte Carlo bookkeeping: chain init and the top-N dedup pose container.

Replaces monte_carlo.cpp + parallel_mc.cpp's host bookkeeping: the
reference's `exhaustiveness` thread pool becomes a lane axis of chains, and
the saved-minima container (coords.cpp add_to_output_container) a
fixed-slot buffer per lane updated with masked selects.  Every function is
batched over a leading lane axis.

Semantics mirrored from the reference:
- random initial conformations in the box (conf.h:119-122,441-446)
- RMSD-deduplicated top-N insert (coords.cpp:43-56) and the per-ligand
  merge of the chains' containers (parallel_mc.cpp:168-181)
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from gnina_tpu_torch.constants import MAX_FL
from gnina_tpu_torch.device import resolve_device
from gnina_tpu_torch.ops.quat import random_orientation


@dataclasses.dataclass(frozen=True)
class MCParams:
    temperature: float = 1.2
    mutation_amplitude: float = 2.0
    min_rmsd: float = 1.0
    num_saved_mins: int = 50
    hunt_cap: tuple = (10.0, 10.0, 10.0)


class PoseContainer(NamedTuple):
    """Fixed-slot saved-minima buffer, leading dims (..., S)."""

    energy: torch.Tensor       # (..., S)
    position: torch.Tensor     # (..., S, 3)
    orientation: torch.Tensor  # (..., S, 4)
    torsions: torch.Tensor     # (..., S, T)
    coords: torch.Tensor       # (..., S, N, 3) heavy-atom lab coords


def empty_container(batch: tuple, s: int, t: int, n: int,
                    device=None) -> PoseContainer:
    device = resolve_device(device)
    f = dict(dtype=torch.float32, device=device)
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], **f)
    return PoseContainer(
        energy=torch.full(batch + (s,), MAX_FL, **f),
        position=torch.zeros(batch + (s, 3), **f),
        orientation=ident.expand(batch + (s, 4)).clone(),
        torsions=torch.zeros(batch + (s, t), **f),
        coords=torch.full(batch + (s, n, 3), 1e9, **f),
    )


def _take(a, idx):
    """a (B, S, ...), idx (B,) -> a[b, idx[b]] (B, ...)."""
    return a[torch.arange(a.shape[0], device=a.device), idx]


def rmsd_upper_bound_sq(coords_a, coords_b, heavy_mask):
    """Mean squared same-index heavy-atom distance (model.cpp:1064-1078)."""
    d2 = torch.sum((coords_a - coords_b) ** 2, dim=-1)           # (..., N)
    cnt = torch.clamp(torch.sum(heavy_mask, dim=-1), min=1)
    return torch.sum(torch.where(heavy_mask, d2, 0.0), dim=-1) / cnt


def add_to_container(cont: PoseContainer, position, orientation, torsions,
                     energy, coords, heavy_mask, min_rmsd: float,
                     valid=None) -> PoseContainer:
    """add_to_output_container (coords.cpp:43-56) for a batch of containers
    (B, S, ...) and one candidate each (B, ...)."""
    r2 = rmsd_upper_bound_sq(cont.coords, coords[:, None],
                             heavy_mask[:, None])                 # (B, S)
    closest = torch.argmin(r2, dim=1)
    have_close = _take(r2, closest) < min_rmsd * min_rmsd
    worst = torch.argmax(cont.energy, dim=1)
    # case 1: similar pose exists -> replace if better; case 2: nothing
    # similar -> take worst slot if better (empty slots have energy MAX_FL
    # so they are always taken first)
    replace_similar = have_close & (energy < _take(cont.energy, closest))
    replace_worst = ~have_close & (energy < _take(cont.energy, worst))
    slot = torch.where(replace_similar, closest, worst)
    do = replace_similar | replace_worst
    if valid is not None:
        do = do & valid
    onehot = (torch.arange(cont.energy.shape[1], device=slot.device)[None]
              == slot[:, None]) & do[:, None]                     # (B, S)

    def upd(arr, new):
        m = onehot.reshape(onehot.shape + (1,) * (arr.dim() - 2))
        return torch.where(m, new[:, None], arr)

    return PoseContainer(
        energy=upd(cont.energy, energy),
        position=upd(cont.position, position),
        orientation=upd(cont.orientation, orientation),
        torsions=upd(cont.torsions, torsions),
        coords=upd(cont.coords, torch.where(heavy_mask[..., None], coords,
                                            1e9)),
    )


def batch_merge_candidates(cont: PoseContainer, cand: PoseContainer,
                           heavy_mask, min_rmsd: float,
                           greedy_iters: int = 16) -> PoseContainer:
    """Fold S candidate poses into each lane's K-slot container in one pass.

    Concatenate the K existing slots with the S candidates, sort by energy,
    suppress every entry within min_rmsd of a better KEPT entry, and keep
    the best K survivors.  The kept-set recurrence (greedy dedup in energy
    order) is the fixed point of `kept[i] = !any_j(adj[i,j] & kept[j])`;
    after t iterations every entry whose suppression-chain depth is < t is
    exact.  Invalid entries (energy >= MAX_FL) never suppress and sort
    last; unkept/invalid output slots are reset to the empty-slot
    convention (energy MAX_FL, coords 1e9).  heavy_mask (B, N)."""
    k = cont.energy.shape[1]
    allc = PoseContainer(*[torch.cat([a, b], dim=1)
                           for a, b in zip(cont, cand)])
    order = torch.argsort(allc.energy, dim=1, stable=True)
    allc = PoseContainer(*[torch.gather(
        a, 1, order.reshape(order.shape + (1,) * (a.dim() - 2)).expand_as(a))
        for a in allc])
    e = allc.energy
    mtot = e.shape[1]
    x = torch.where(heavy_mask[:, None, :, None], allc.coords, 0.0)
    xf = x.reshape(x.shape[0], mtot, -1)
    sq = torch.sum(xf * xf, dim=-1)
    gram = torch.bmm(xf, xf.transpose(1, 2))
    cnt = torch.clamp(torch.sum(heavy_mask, dim=-1), min=1)[:, None, None]
    d2 = (sq[:, :, None] + sq[:, None, :] - 2.0 * gram) / cnt
    valid = e < MAX_FL
    ii = torch.arange(mtot, device=e.device)
    adj = ((ii[None, :] < ii[:, None])[None]          # j strictly better
           & (d2 < min_rmsd * min_rmsd)
           & valid[:, None, :]).to(torch.float32)     # adj[b, i, j]
    kept = torch.ones_like(e)
    for _ in range(greedy_iters):
        kept = (torch.sum(adj * kept[:, None, :], dim=-1) < 0.5).float()
    keep = (kept > 0.5) & valid
    sel = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)[:, :k]
    out = PoseContainer(*[torch.gather(
        a, 1, sel.reshape(sel.shape + (1,) * (a.dim() - 2)).expand(
            (a.shape[0], k) + a.shape[2:])) for a in allc])
    kvalid = torch.gather(keep, 1, sel)
    return out._replace(
        energy=torch.where(kvalid, out.energy, MAX_FL),
        coords=torch.where(kvalid[..., None, None], out.coords, 1e9))


def merge_containers(conts: PoseContainer, heavy_mask, min_rmsd: float,
                     out_slots: int) -> PoseContainer:
    """Merge per-chain containers (parallel_mc.cpp:168-181, min_rmsd=2).

    conts (B, C, S, ...): C chains' containers for each of B ligands;
    returns (B, out_slots, ...) deduplicated and sorted by energy.
    heavy_mask (B, N)."""
    b = conts.energy.shape[0]
    c = PoseContainer(*[a.reshape((b, -1) + a.shape[3:]) for a in conts])
    order = torch.argsort(c.energy, dim=1, stable=True)
    c = PoseContainer(*[torch.gather(
        a, 1, order.reshape(order.shape + (1,) * (a.dim() - 2)).expand_as(a))
        for a in c])
    t = c.torsions.shape[-1]
    n = c.coords.shape[-2]
    out = empty_container((b,), out_slots, t, n, device=c.energy.device)
    for i in range(c.energy.shape[1]):
        out = add_to_container(out, c.position[:, i], c.orientation[:, i],
                               c.torsions[:, i], c.energy[:, i],
                               c.coords[:, i], heavy_mask, min_rmsd,
                               valid=c.energy[:, i] < MAX_FL)
    order = torch.argsort(out.energy, dim=1, stable=True)
    return PoseContainer(*[torch.gather(
        a, 1, order.reshape(order.shape + (1,) * (a.dim() - 2)).expand_as(a))
        for a in out])


def randomize_conf(lanes: int, corner1, corner2, t: int,
                   generator: torch.Generator, device=None):
    """Random position in box, random orientation, random torsions
    (conf.h:119-122,441-446) for `lanes` chains: (pos, quat, tors), drawn
    on the generator's device and returned on `device`."""
    device = resolve_device(device)
    gdev = generator.device
    lo = torch.as_tensor(corner1, dtype=torch.float32, device=gdev)
    hi = torch.as_tensor(corner2, dtype=torch.float32, device=gdev)
    u = torch.rand((lanes, 3), generator=generator, dtype=torch.float32,
                   device=gdev)
    pos = u * (hi - lo) + lo
    quat = random_orientation((lanes,), generator, gdev)
    tors = torch.rand((lanes, t), generator=generator, dtype=torch.float32,
                      device=gdev) * (2.0 * math.pi) - math.pi
    return pos.to(device), quat.to(device), tors.to(device)


class MCCarry(NamedTuple):
    """Resumable MC chain state over the flat lane axis (L = ligands x
    chains): carrying it across windows chunks the search."""

    rigid: torch.Tensor      # (L, 8) chain head, packed conf
    tors: torch.Tensor       # (L, M)
    e: torch.Tensor          # (L,) chain-head Metropolis energy
    best_e: torch.Tensor     # (L,)
    cont: PoseContainer      # (L, S, ...)
    coords: torch.Tensor     # (L, N, 3) heavy coords of the chain head


def mc_init(lanes: int, m: int, params: MCParams, corner1, corner2,
            n_heavy: int, generator: torch.Generator, fk_fn,
            device=None) -> MCCarry:
    """Random chain heads and empty containers for every lane; fk_fn maps
    packed (rigid, tors) to heavy coords."""
    device = resolve_device(device)
    from gnina_tpu_torch.ops.fused_dock import conf_to_packed
    from gnina_tpu_torch.types import Conf

    pos, quat, tors = randomize_conf(lanes, corner1, corner2, m - 1,
                                     generator, device)
    rigid, ptors = conf_to_packed(Conf(pos, quat, tors), m)
    return MCCarry(rigid=rigid, tors=ptors,
                   e=torch.full((lanes,), MAX_FL, dtype=torch.float32,
                                device=device),
                   best_e=torch.full((lanes,), MAX_FL, dtype=torch.float32,
                                     device=device),
                   cont=empty_container((lanes,), params.num_saved_mins,
                                        m - 1, n_heavy, device),
                   coords=fk_fn(rigid, ptors))
