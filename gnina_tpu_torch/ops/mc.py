"""Monte Carlo bookkeeping: chain init, the one-DOF mutation, Metropolis,
and the top-N dedup pose container.

Replaces monte_carlo.cpp + parallel_mc.cpp's host bookkeeping: the
reference's `exhaustiveness` thread pool becomes a lane axis of chains, and
the saved-minima container (coords.cpp add_to_output_container) a
fixed-slot buffer per lane updated with masked selects.  Every function is
batched over a leading lane axis.

Semantics mirrored from the reference:
- random initial conformations in the box (conf.h:119-122,441-446)
- mutate_conf picks ONE random DOF: +-2A translation, gyration-scaled
  rotation, or torsion redraw (mutate.cpp:35-73); Metropolis at T=1.2
  (monte_carlo.cpp:99-148)
- RMSD-deduplicated top-N insert (coords.cpp:43-56) and the per-ligand
  merge of the chains' containers (parallel_mc.cpp:168-181)
- the host-driven step loop (chain_steps): truncated minimisation at the
  hunt caps, Metropolis on the inter-only energy at authentic v, the
  promising/pending bookkeeping and the full-v refine of promising poses
  (monte_carlo.cpp:44-47, 99-148); mc_chunk runs it on the general path's
  energy functions (the BFGS of ops/bfgs.py over autograd energies, on
  the search grids or analytic), mc_fused.fused_mc_chunk on the fused
  minimisation kernels
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from gnina_tpu_torch.constants import EPSILON_FL, MAX_FL
from gnina_tpu_torch.device import resolve_device
from gnina_tpu_torch.ops.bfgs import MinimizeParams, bfgs
from gnina_tpu_torch.ops.quat import quaternion_increment, random_orientation
from gnina_tpu_torch.types import Conf


@dataclasses.dataclass(frozen=True)
class MCParams:
    temperature: float = 1.2
    mutation_amplitude: float = 2.0
    min_rmsd: float = 1.0
    num_saved_mins: int = 50
    hunt_cap: tuple = (10.0, 10.0, 10.0)
    # full-v refinement cadence of the host-driven chunk: the latest
    # promising pose of each lane is refined every `refine_stride` steps
    # (0 = never, rely on the final refine stages)
    refine_stride: int = 4
    # the general path's minimiser (mc_chunk); the fused route's kernels
    # carry their own
    minparams: MinimizeParams = MinimizeParams()


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


class MutationDraws(NamedTuple):
    """The random numbers of one mutate_conf call per lane.  A caller that
    supplies them (instead of a generator) decides every draw, so two
    implementations can be fed the same numbers."""

    which: torch.Tensor      # (L,) int64: 0 position, 1 orientation, 2+ torsion
    pos_dir: torch.Tensor    # (L, 3) standard normal
    pos_r: torch.Tensor      # (L,) uniform [0, 1)
    rot_dir: torch.Tensor    # (L, 3) standard normal
    rot_r: torch.Tensor      # (L,) uniform [0, 1)
    new_tor: torch.Tensor    # (L,) uniform [-pi, pi)


def draw_mutation(generator: torch.Generator, num_real_torsions,
                  has_rigid_dof, device=None) -> MutationDraws:
    """One lane-batch of mutation draws from `generator` (drawn on its
    device, returned on `device`).  num_real_torsions (L,) int,
    has_rigid_dof (L,) bool."""
    device = resolve_device(device)
    gdev = generator.device
    f = dict(generator=generator, dtype=torch.float32, device=gdev)
    nt = torch.as_tensor(num_real_torsions).to(gdev)
    lanes = nt.shape[0]
    lo = torch.where(torch.as_tensor(has_rigid_dof).to(gdev), 0, 2)
    span = (nt + 2 - lo).to(torch.float32)
    which = lo + torch.minimum(torch.floor(torch.rand(lanes, **f) * span),
                               span - 1.0).long()
    out = MutationDraws(
        which=which, pos_dir=torch.randn((lanes, 3), **f),
        pos_r=torch.rand(lanes, **f), rot_dir=torch.randn((lanes, 3), **f),
        rot_r=torch.rand(lanes, **f),
        new_tor=torch.rand(lanes, **f) * (2.0 * math.pi) - math.pi)
    return MutationDraws(*[x.to(device) for x in out])


def random_inside_sphere(direction, u):
    """Uniform point in the unit ball: a standard-normal `direction`
    (..., 3), normalised, times cbrt of the uniform `u` (...)."""
    norm = torch.linalg.vector_norm(direction, dim=-1, keepdim=True)
    d = direction / torch.clamp(norm, min=EPSILON_FL)
    return (u ** (1.0 / 3.0))[..., None] * d


def gyration_radius(coords, root_pos, lig_heavy_mask):
    """Ligand heavy-atom gyration radius about the root origin
    (model.cpp:1002): coords (L, N, 3), root_pos (L, 3), mask (L, N)."""
    d2 = torch.sum((coords - root_pos[:, None]) ** 2, dim=-1)
    cnt = torch.clamp(torch.sum(lig_heavy_mask, dim=-1), min=1)
    return torch.sqrt(torch.sum(torch.where(lig_heavy_mask, d2, 0.0), dim=-1)
                      / cnt)


def mutate_conf(conf: Conf, gr, amplitude: float, num_real_torsions,
                has_rigid_dof=True, draws: Optional[MutationDraws] = None,
                generator: Optional[torch.Generator] = None) -> Conf:
    """One-DOF mutation (mutate.cpp:35-73) of a lane-batch of confs.

    gr (L,): each ligand's current gyration radius.  has_rigid_dof False
    (covalent complexes) restricts the draw to torsions.  The random
    numbers are `draws`, else drawn from `generator`."""
    lanes, t = conf.torsions.shape
    dev = conf.position.device
    nt = torch.as_tensor(num_real_torsions, device=dev).expand(lanes)
    rigid = torch.as_tensor(has_rigid_dof, device=dev).expand(lanes)
    if draws is None:
        if generator is None:
            raise ValueError("mutate_conf needs draws or a generator")
        draws = draw_mutation(generator, nt, rigid, device=dev)
    which = draws.which
    pos_new = conf.position + amplitude * random_inside_sphere(
        draws.pos_dir, draws.pos_r)
    # orientation mutation, scaled by the ligand's gyration radius
    rot = (amplitude / torch.clamp(gr, min=EPSILON_FL))[:, None] \
        * random_inside_sphere(draws.rot_dir, draws.rot_r)
    quat_new = torch.where((gr > EPSILON_FL)[:, None],
                           quaternion_increment(conf.orientation, rot),
                           conf.orientation)
    slot = torch.arange(t, device=dev)[None, :] == (which - 2)[:, None]
    tors_new = torch.where(slot, draws.new_tor[:, None], conf.torsions)
    return Conf(
        position=torch.where((which == 0)[:, None], pos_new, conf.position),
        orientation=torch.where((which == 1)[:, None], quat_new,
                                conf.orientation),
        torsions=torch.where((which >= 2)[:, None], tors_new, conf.torsions))


def metropolis_accept(old_f, new_f, temperature: float, u=None,
                      generator: Optional[torch.Generator] = None):
    """new_f < old_f, or a uniform below exp((old_f - new_f) / T).  The
    uniforms are `u` (L,), else drawn from `generator`."""
    if u is None:
        if generator is None:
            raise ValueError("metropolis_accept needs u or a generator")
        u = torch.rand(old_f.shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(old_f.device)
    return (new_f < old_f) | (u < torch.exp((old_f - new_f) / temperature))


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
    # the latest promising pose awaiting its full-v refinement at the next
    # stride boundary of the host-driven chunk (MCParams.refine_stride)
    pending_rigid: torch.Tensor        # (L, 8)
    pending_tors: torch.Tensor         # (L, M)
    pending_valid: torch.Tensor        # (L,) bool
    pending_is_current: torch.Tensor   # (L,) bool: pending is the chain head


def mc_init(lanes: int, m: int, params: MCParams, corner1, corner2,
            n_heavy: int, generator: torch.Generator, fk_fn,
            device=None) -> MCCarry:
    """Random chain heads and empty containers for every lane; fk_fn maps
    packed (rigid, tors) to heavy coords."""
    device = resolve_device(device)
    from gnina_tpu_torch.ops.fused_dock import conf_to_packed

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
                   coords=fk_fn(rigid, ptors), pending_rigid=rigid,
                   pending_tors=ptors,
                   pending_valid=torch.zeros(lanes, dtype=torch.bool,
                                             device=device),
                   pending_is_current=torch.zeros(lanes, dtype=torch.bool,
                                                  device=device))


def chain_steps(carry: MCCarry, generator: Optional[torch.Generator],
                num_steps: int, minimize_hunt, minimize_full, heavy_mask,
                gyr_mask, ntors, has_rigid, params: MCParams, tp: int,
                draws=None) -> MCCarry:
    """num_steps host-driven MC steps on the flat lane axis
    (monte_carlo.cpp:99-148).

    minimize_hunt / minimize_full (rigid, tors) -> (rigid', tors',
    Metropolis energy (L,), coords (L, N, 3)) minimise every lane at the
    hunt caps / at authentic v.  heavy_mask (L, N) marks the coordinate
    rows the container keeps, gyr_mask (L, N) those of the gyration
    radius.  Step i takes its random numbers from draws[i] = (mutation
    draws, Metropolis uniforms (L,)) when supplied, else from
    `generator`."""
    from gnina_tpu_torch.ops.fused_dock import conf_to_packed, packed_to_conf

    m = carry.tors.shape[1]
    lanes = carry.e.shape[0]
    dev = carry.e.device

    def add(cont, rigid, tors, e, coords, valid):
        return add_to_container(cont, rigid[:, 0:3], rigid[:, 3:7],
                                tors[:, 1:1 + tp], e, coords, heavy_mask,
                                params.min_rmsd, valid=valid)

    def sel(mask, a, b):
        return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    def step(carry: MCCarry, i: int) -> MCCarry:
        if draws is not None:
            md, u = draws[i]
        else:
            md = draw_mutation(generator, ntors, has_rigid, device=dev)
            u = torch.rand(lanes, generator=generator, dtype=torch.float32,
                           device=generator.device).to(dev)
        gr = gyration_radius(carry.coords, carry.rigid[:, 0:3], gyr_mask)
        cand = mutate_conf(packed_to_conf(carry.rigid, carry.tors, m - 1),
                           gr, params.mutation_amplitude, ntors, has_rigid,
                           draws=md)
        crig, ctor = conf_to_packed(cand, m)
        crig, ctor, cand_e, cand_coords = minimize_hunt(crig, ctor)

        accept = metropolis_accept(carry.e, cand_e, params.temperature, u=u)
        accept = accept | (carry.e >= MAX_FL)      # step 0 always accepts
        rigid = sel(accept, crig, carry.rigid)
        tors = sel(accept, ctor, carry.tors)
        e = torch.where(accept, cand_e, carry.e)
        coords = sel(accept, cand_coords, carry.coords)

        # "promising" (monte_carlo.cpp:120-135): improved best, or the
        # container not yet full; saved unrefined right away, refined at
        # the next stride boundary
        has_empty = torch.any(carry.cont.energy >= MAX_FL, dim=-1)
        promising = accept & ((cand_e < carry.best_e) | has_empty)
        cont = add(carry.cont, rigid, tors, e, coords, promising)
        best_e = torch.where(promising & (e < carry.best_e), e, carry.best_e)
        return MCCarry(
            rigid=rigid, tors=tors, e=e, best_e=best_e, cont=cont,
            coords=coords,
            pending_rigid=sel(promising, rigid, carry.pending_rigid),
            pending_tors=sel(promising, tors, carry.pending_tors),
            pending_valid=carry.pending_valid | promising,
            pending_is_current=torch.where(
                promising, True, carry.pending_is_current & ~accept))

    def refine_phase(carry: MCCarry) -> MCCarry:
        """Full-v refinement of the pending promising poses (the in-loop
        quasi_newton at authentic_v, monte_carlo.cpp:128).  When the
        pending pose is still the chain head, the chain continues from the
        refined conf."""
        rrig, rtor, re, rcoords = minimize_full(carry.pending_rigid,
                                                carry.pending_tors)
        do = carry.pending_valid
        cont = add(carry.cont, rrig, rtor, re, rcoords, do)
        best_e = torch.where(do & (re < carry.best_e), re, carry.best_e)
        move = do & carry.pending_is_current
        return carry._replace(
            rigid=sel(move, rrig, carry.rigid),
            tors=sel(move, rtor, carry.tors),
            e=torch.where(move, re, carry.e), best_e=best_e, cont=cont,
            coords=sel(move, rcoords, carry.coords),
            pending_valid=torch.zeros_like(carry.pending_valid),
            pending_is_current=torch.zeros_like(carry.pending_is_current))

    stride = params.refine_stride
    refine = bool(stride) and stride > 0 and num_steps >= stride
    for i in range(num_steps):
        carry = step(carry, i)
        if refine and i % stride == stride - 1:
            carry = refine_phase(carry)
    return carry


def mc_chunk(carry: MCCarry, generator: Optional[torch.Generator],
             num_steps: int, lig, energy_fn, params: MCParams,
             max_layers: int, dof_mask, num_real_torsions,
             has_rigid_dof=True, draws=None) -> MCCarry:
    """num_steps MC steps of every lane from a carried state, on the
    general path (monte_carlo.cpp:99-148).

    lig: a LigandData whose tensors carry the lane dimension
    (energy.lane_ligands); dof_mask (L, D); num_real_torsions (L,);
    has_rigid_dof (L,).  energy_fn contract, over a lane batch of confs:
      eval_deriv(conf, v) -> (e, g) for the BFGS;
      metro_on_coords(coords) -> Metropolis / update energy at authentic v
        (the search grid's inter-only energy, parallel_mc.cpp:161-162);
      eval_energy(conf, v) -> forward-only energy (line-search trials).
    The chain's coordinates are every atom's (L, N, 3)."""
    from gnina_tpu_torch.ops import fk
    from gnina_tpu_torch.ops.fused_dock import conf_to_packed, packed_to_conf

    eval_deriv = energy_fn["eval_deriv"]
    metro_on_coords = energy_fn["metro_on_coords"]
    eval_energy = energy_fn.get("eval_energy")
    m = carry.tors.shape[1]

    def minimizer(v):
        def run(rigid, tors):
            res = bfgs(lambda c: eval_deriv(c, v),
                       packed_to_conf(rigid, tors, m - 1), params.minparams,
                       dof_mask,
                       f_val=(lambda c: eval_energy(c, v))
                       if eval_energy else None)
            with torch.no_grad():
                coords = fk.fk_coords(lig, res.x, max_layers)
                e = metro_on_coords(coords)
            r, t = conf_to_packed(res.x, m)
            return r, t, e, coords
        return run

    return chain_steps(carry, generator, num_steps,
                       minimizer(list(params.hunt_cap)),
                       minimizer([1000.0, 1000.0, 1000.0]), lig.heavy_mask,
                       lig.lig_heavy_mask, num_real_torsions, has_rigid_dof,
                       params, m - 1, draws=draws)


def run_mc_chain(generator: torch.Generator, num_steps: int, lig,
                 energy_fn, params: MCParams, corner1, corner2,
                 max_layers: int, dof_mask, num_real_torsions,
                 has_rigid_dof=True) -> PoseContainer:
    """Whole MC chains of every lane in one call (init + all steps); the
    chunked mc_init / mc_chunk pair is the docking engine's."""
    from gnina_tpu_torch.ops import fk
    from gnina_tpu_torch.ops.fused_dock import packed_to_conf

    lanes, n = lig.types.shape
    m = lig.parent.shape[-1]
    carry = mc_init(lanes, m, params, corner1, corner2, n, generator,
                    lambda r, t: fk.fk_coords(lig, packed_to_conf(r, t, m - 1),
                                              max_layers),
                    device=lig.types.device)
    final = mc_chunk(carry, generator, num_steps, lig, energy_fn, params,
                     max_layers, dof_mask, num_real_torsions, has_rigid_dof)
    return final.cont
