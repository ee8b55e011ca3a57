"""Monte Carlo chunks driven by the fused kernels.

fused_mc_chunk_inkernel: the whole step loop (mutate + BFGS + Metropolis)
runs inside K3 (fused_dock.async_mc_window) or, with async_mc off, K5
(fused_dock.lockstep_mc_window) for S = window steps per launch; the
host-side bookkeeping per window is:
  1. pick the best accepted candidate of each of the `refine_subs`
     sub-windows and refine it at full v through K2 (the reference's
     in-loop promising-pose refinement, monte_carlo.cpp:120-135);
  2. fold ALL accepted candidates + the refined poses into each lane's
     top-N container with ONE batched sort/dedup merge
     (mc.batch_merge_candidates);
  3. continue the chain from the refined pose when the refined candidate
     is still the chain head (monte_carlo.cpp:128 semantics).

fused_mc_chunk: the host drives every step (fused_mc_in_kernel off):
mutate, one K2/K4 minimisation at the hunt caps, Metropolis, the
promising/pending bookkeeping, and a full-v refine of each lane's pending
pose every refine_stride steps (monte_carlo.cpp:99-148): mc.chain_steps,
the general path's step loop, over the kernels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from gnina_tpu_torch import trace
from gnina_tpu_torch.constants import MAX_FL
from gnina_tpu_torch.ops import fused_dock as fd
from gnina_tpu_torch.ops import mc


class LaneMeta(NamedTuple):
    """Per-lane static metadata for the flattened (ligand x chain) axis."""

    heavy_mask: torch.Tensor  # (L, NH) bool: real heavy row of the pack
    ntors: torch.Tensor       # (L,) int64 real torsion count
    has_rigid: torch.Tensor   # (L,) bool


def lane_meta(pack: fd.DockPack) -> LaneMeta:
    real = torch.as_tensor(pack.heavy_idx >= 0, device=pack.lane_lig.device)
    dofm = pack.dofmask[pack.lane_lig.long()]
    return LaneMeta(heavy_mask=real[pack.lane_lig.long()],
                    ntors=dofm[:, 6:].sum(1).long(),
                    has_rigid=dofm[:, 0] > 0)


def fused_mc_chunk(carry: mc.MCCarry, generator: Optional[torch.Generator],
                   num_steps: int, fused, pack: fd.DockPack, scal_hunt,
                   scal_full, meta: LaneMeta, params: mc.MCParams, tp: int,
                   draws: Optional[Sequence[Tuple[mc.MutationDraws,
                                                  torch.Tensor]]] = None
                   ) -> mc.MCCarry:
    """num_steps host-driven MC steps on the flat lane axis
    (monte_carlo.cpp:99-148), the step loop of mc.chain_steps.

    fused(rigid, tors, scal) -> (rigid', tors', stats, coords) is one
    minimisation of every lane (a FusedBfgs handle: K2, or K4 under
    async_ls); the hunt-cap and full-v minimisations share it, the v levels
    ride in scal.  Step i takes its random numbers from draws[i] =
    (mutation draws, Metropolis uniforms (L,)) when supplied, else from
    `generator`."""

    def minimizer(scal):
        def run(rigid, tors):
            org, otr, stats, coords = fused(rigid.contiguous(),
                                            tors.contiguous(), scal)
            return org, otr, stats[:, 1], coords
        return run

    return mc.chain_steps(carry, generator, num_steps, minimizer(scal_hunt),
                          minimizer(scal_full), meta.heavy_mask,
                          meta.heavy_mask, meta.ntors, meta.has_rigid, params,
                          tp, draws=draws)


def fused_mc_chunk_inkernel(carry: mc.MCCarry, generator: torch.Generator,
                            num_steps: int, fused_mc: fd.FusedBfgs,
                            fused_ref: fd.FusedBfgs, pack: fd.DockPack,
                            scal_hunt, scal_full, meta: LaneMeta,
                            params: mc.MCParams, tp: int,
                            refine_subs: int = 1,
                            seeds: Optional[Sequence[int]] = None
                            ) -> mc.MCCarry:
    """num_steps MC steps per lane in windows of S = fused_mc.mc_steps.

    generator draws one Philox seed per window (the kernel's stream is
    keyed on (seed, lane_offset + lane)), unless `seeds` gives the
    windows' seeds (the shards of one batch share them).  The stream of an async window (K3) is
    completion-indexed with a completed flag per row; that of a lockstep
    window (K5) is step-indexed and every row is valid."""
    lanes = carry.e.shape[0]
    s_steps = fused_mc.mc_steps
    if num_steps % s_steps:
        raise ValueError("chunk steps must be a multiple of the MC window")
    if refine_subs < 1 or s_steps % refine_subs:
        raise ValueError("refine_subs must divide the window length")
    dev = carry.e.device
    consts = (torch.tensor(3e38, dtype=torch.float32, device=dev),
              torch.arange(s_steps, device=dev),
              torch.arange(lanes, device=dev),
              pack.lane_lig.repeat_interleave(s_steps))

    for w in range(num_steps // s_steps):
        with trace.span("mc.window", device=dev):
            seed = (int(seeds[w]) if seeds is not None else
                    int(torch.randint(0, 1 << 30, (1,), generator=generator)))
            carry = _window(carry, seed, fused_mc, fused_ref, pack, scal_hunt,
                            scal_full, meta, params, tp, refine_subs, consts)
    return carry


def _window(carry, seed, fused_mc, fused_ref, pack, scal_hunt, scal_full,
            meta, params, tp, refine_subs, consts):
    """One window of fused_mc_chunk_inkernel from the window's seed: K3
    (or K5), the stream's FK and candidate selection, the refine_subs K2
    refinements, the merge."""
    big, sidx, lane_ix, stream_lig = consts
    lanes, s_steps, m = carry.e.shape[0], fused_mc.mc_steps, fused_mc.m
    sub = s_steps // refine_subs
    with trace.span("mc.k3"):
        (frigid, ftors, fstats, fcoords, srig, stor,
         sstat) = fused_mc.run_mc(carry.rigid, carry.tors, scal_hunt, seed,
                                  carry.e)
    trace.count("mc.windows")
    trace.count("mc.steps_scheduled", s_steps * lanes)
    if fused_mc.async_mc:
        # stats row 4: the steps each lane completed in the window
        trace.count_device("mc.steps_completed", fstats[:, 4])
    else:
        trace.count("mc.steps_completed", s_steps * lanes)

    with trace.span("mc.fk"):
        if fused_mc.async_mc:
            validp = sstat[..., 2] > 0.5                      # (L, S)
        else:
            validp = torch.ones_like(sstat[..., 0], dtype=torch.bool)
        # never-completed rows are zeros (quat 0): neutralize before FK
        ident = torch.tensor([0, 0, 0, 1, 0, 0, 0, 0], dtype=torch.float32,
                             device=carry.e.device)
        crig = torch.where(validp[..., None], srig, ident)
        ccrd = fd.fk_packed(crig.reshape(-1, 8), stor.reshape(-1, m), pack,
                            lane_lig=stream_lig).reshape(
                                lanes, s_steps, -1, 3)
        cand_e = torch.where(validp, sstat[..., 0], MAX_FL)
        accept = (sstat[..., 1] > 0.5) & validp                # (L, S)

        masked_e = torch.where(accept, cand_e, big)
        idx_best = torch.argmin(masked_e, dim=1)
        has_acc = torch.any(accept, dim=1)
        last_acc = torch.max(torch.where(accept, sidx, -1), dim=1).values

    # full-v refinement of the best accepted candidate of EACH sub-window
    # (refine_subs K2 launches)
    with trace.span("mc.refine"):
        refs = []
        for r in range(refine_subs):
            idx_r = torch.argmin(masked_e[:, r * sub:(r + 1) * sub], dim=1) \
                + r * sub
            valid_r = torch.any(accept[:, r * sub:(r + 1) * sub], dim=1)
            org, otr, rstats, rcoords = fused_ref(
                crig[lane_ix, idx_r].contiguous(),
                stor[lane_ix, idx_r].contiguous(), scal_full)
            refs.append((org, otr, rstats[:, 1], rcoords, valid_r))

    with trace.span("mc.merge"):
        # the chain continues from the refined conf when the best candidate
        # is still the chain head; it lives in sub-window idx_best // sub
        move = has_acc & (last_acc == idx_best)
        sb = idx_best // sub
        rrig, rtor, re, rcrd = refs[0][:4]
        for r in range(1, refine_subs):
            sel = sb == r
            rrig = torch.where(sel[:, None], refs[r][0], rrig)
            rtor = torch.where(sel[:, None], refs[r][1], rtor)
            re = torch.where(sel, refs[r][2], re)
            rcrd = torch.where(sel[:, None, None], refs[r][3], rcrd)

        rigid = torch.where(move[:, None], rrig, frigid)
        tors = torch.where(move[:, None], rtor, ftors)
        e = torch.where(move, re, fstats[:, 0])
        coords = torch.where(move[:, None, None], rcrd, fcoords)

        # ONE batched container merge: S accepted candidates + the refined
        # poses; rejected slots become empty entries (energy MAX_FL)
        re_col = torch.stack([x[2] for x in refs], dim=1)        # (L, R)
        rvalid = torch.stack([x[4] for x in refs], dim=1)
        rrig_col = torch.stack([x[0] for x in refs], dim=1)      # (L, R, 8)
        rtor_col = torch.stack([x[1] for x in refs], dim=1)
        rcrd_col = torch.stack([x[3] for x in refs], dim=1)
        hm = meta.heavy_mask[:, None, :, None]
        cand = mc.PoseContainer(
            energy=torch.cat([torch.where(accept, cand_e, MAX_FL),
                              torch.where(rvalid, re_col, MAX_FL)], dim=1),
            position=torch.cat([crig[..., 0:3], rrig_col[..., 0:3]], dim=1),
            orientation=torch.cat([crig[..., 3:7], rrig_col[..., 3:7]],
                                  dim=1),
            torsions=torch.cat([stor[..., 1:1 + tp], rtor_col[..., 1:1 + tp]],
                               dim=1),
            coords=torch.cat([
                torch.where(accept[..., None, None] & hm, ccrd, 1e9),
                torch.where(rvalid[..., None, None] & hm, rcrd_col, 1e9)],
                dim=1))
        cont = mc.batch_merge_candidates(carry.cont, cand, meta.heavy_mask,
                                         params.min_rmsd)
        best_e = torch.minimum(carry.best_e, torch.min(masked_e, dim=1).values)
        best_e = torch.minimum(best_e, torch.min(
            torch.where(rvalid, re_col, big), dim=1).values)
        return mc.MCCarry(rigid=rigid.contiguous(), tors=tors.contiguous(),
                          e=e.contiguous(), best_e=best_e, cont=cont,
                          coords=coords, pending_rigid=rigid,
                          pending_tors=tors,
                          pending_valid=torch.zeros_like(carry.pending_valid),
                          pending_is_current=torch.zeros_like(
                              carry.pending_is_current))

