#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Builds csrc/fused_dock.cu, csrc/probes.cu and csrc/voxelize.cu from this
checkout (one nvcc each, started together, sm_90a), holds each of their kernels and kernel
modes (K1 eval_fg, K2 bfgs_minimize and its async_ls mode K4, K3
async_mc_window and its warm_ls mode K6, K5 lockstep_mc_window, K7's
gradient layout over K1, K8 the done_frac group stop of K2/K4/K5, and the
rate probes K9 probe_pairs, K10 probe_gather_loop, K11 probe_mxu) against
its plain PyTorch version at the main path's shapes (K1 and one K3 window
also on a receptor above the shared-memory budget, which the kernels
stream through tiles: phase [4f]; K3's Philox stream against torch.rand
uniforms by the window's statistics: phase [4g]), and docks 16 copies
of the minout.sdf ligand x exhaustiveness 8 (128 chains) through
DockingEngine.dock_batch on the card
under each search setting that selects one of them: the default in-kernel
search at 1024 MC steps, the same with fused_async_ls and with
fused_warm_ls, lockstep windows (fused_async_mc=False, 256 steps) and the
host-driven step loop (fused_mc_in_kernel=False, 4 ligands, 256 steps),
and each of the four again with fused_done_frac=0.9.
Then it docks under the default settings with the default three-model CNN
ensemble (at 1024 steps, and once at the settings' own step heuristic),
holds the grids and ensemble outputs of one pose chunk against the same
code on the CPU and the CUDA voxeliser's 128-pose grids against the plain
voxeliser's on the card (one launch a chunk of the dock's rescore), drives the command line in process (cli.main: a screen
of the 16 ligands from files with GNINA_TPU_FUSED_DONE_FRAC=0.9 and the
default CNN rescore, whose SDF tags must equal the engine's energies, then
--score_only, --minimize and --randomize_only on one ligand), and times
every kernel.  The receptor is synthetic, made
from --seed: heavy atoms at protein density on a jittered lattice around
the ligand with a cavity carved at its centre, read through
Receptor.from_file.

Phase [7] traces one more dock_batch with torch.profiler and splits the
card's busy time by kernel.  The last phase, [8], runs the general docking
path (fused_search="off": search grids, the per-step MC, the stages on
the exact energy; ordinary PyTorch, no kernel) on the same job at
GENERAL_STEPS steps: the populate and dock times, every pose against
the engine's and K1's exact rescores and the box, a --scoring dkoes_scoring and a
--user_grid job through cli.main, and the fused route against the
general path over 3 seeds (ROADMAP item 16; the gap and
scripts/quality_gate.py's bar are printed).  Phase [9] runs flexible side
chains, covalent ligands and --outputmin, which take the general path
only: a flex dock_batch at full width on a receptor with real residues
(FLEX_STEPS steps) and six cli.main jobs at FLEX_CLI_STEPS steps
(--flexdist with --out_flex and --full_flex_output, --flexres, --flex, a
covalent job, --minimize --outputmin 4, --no_lig --score_only).  Phase
[10] runs the CNN inside the search (general path only): a
cnn_scoring='refinement' dock_batch at full width with the default
ensemble (CNN_STEPS steps), the CNN objective on the card against the
same code on the CPU, --minimize under refinement, and six cli.main jobs
at CNN_CLI_STEPS steps (metrorescore, metrorefine, all, --minimize
--cnn_scoring refinement, the empirical mix, and the CNN debug outputs).
Phase [11] runs the tools: gninagrid at full width (48^3 x 28 channels)
held to the same command on the CPU, the gninatyper/tognina/fromgnina
round trip, gninavis with the default ensemble (card against CPU on a few
masked rows), the minimisation server over HTTP on 127.0.0.1 (every
served affinity the engine's own), and --score_only --cnn_model with a
TorchScript network traced in the phase (its CNNscore the traced module's
forward on the port's grid; the job rescores through K1).  Phase [12] runs what scales the port out: the main
path's dock under a two-shard Mesh on the one card against the unsharded
dock, K3 and K5 at a lane offset, a two-process screen (--dist_nprocs 2,
gloo on 127.0.0.1) against one-process screens of each process's subset,
one training step of a default-ensemble model at full width against the
same step on the CPU (alone and on a dp = 2 mesh), and native bond
perception against the Python loop.

Phases print one line each; any failed check exits non-zero.  The line
before the last is the kernel table as JSON (`launches` counts kernel
launches, `calls` the wrapper calls that made them: a K8 call makes one
cooperative launch per set of co-resident groups, a probe call one), the
one before it the card's `nvidia-smi` name and power limit, and the last
line is
{"ok": true, "device": {...}}.  Without a card, or without the rest of the
repository beside it, the script exits non-zero and prints no result.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import types

import numpy as np

FP32_PEAK = 67e12       # H100 SXM FP32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12      # H100 SXM HBM3, bytes/s
BF16_PEAK = 989e12      # H100 SXM dense bf16 in the tensor cores, FLOP/s
# H100 SXM bf16 outside the tensor cores (packed pairs in the FP32 pipes,
# twice the FP32 rate; NVIDIA's H100 architecture paper, "Peak BF16 TFLOPS
# (non-Tensor)"), FLOP/s: the peak for K9's __nv_bfloat16 arithmetic
BF16_VECTOR_PEAK = 133.8e12
# operations per pair of the probe's pair energy (probes.pair_energies): 9
# for the distance, 8 for the two gaussians, 18 for the repulsion and the two
# ramps with their factors, 11 to weigh, cut and add (each exp or sqrt one).
# Three of them (two exp, one sqrt) run on the H100's special function
# pipe, 16 a clock an SM: at 1.98 GHz about as long as the FP32 bound
# itself (0.075 against 0.072 ms at the probe's default sizes), a co-limit
# that the bound does not count.
OPS_PROBE_PAIR = 46
# FP32 operations per (heavy ligand atom, receptor atom) pair and
# evaluation, counted from eval_pose in csrc/fused_dock.cu: the distance
# test every pair pays, and the vina terms (2 gauss, repulsion,
# hydrophobic, h-bond) of a pair inside the cutoff with and without the
# derivative (each exp counted as one operation).
OPS_PAIR_TEST = 9
OPS_PAIR_VALUE = 46
OPS_PAIR_DERIV = 72

LIGANDS, EXHAUSTIVENESS, MC_STEPS = 16, 8, 1024
# phase [8]'s depth: the general path is a per-step loop of small torch
# operations (about half a second a step at 128 lanes on an H100), so its
# docks run 32 steps (128 until [10] needed the time, 64 until [12] took
# 37.4 s and the whole script about 805 s, over the 760 s allowed before a
# cut; 48 would run as 64: the engine docks in chunks of 32 steps at 128
# lanes) and its command-line jobs 16 (32 until [11] took 86 s and the
# whole script 827.6 s), not 1024; scripts/torch_route_gap.py compares the
# two routes at depth (PERF.md section 4)
GENERAL_STEPS, GENERAL_CLI_STEPS = 32, 16
# phase [9]'s depth: flex jobs take the general path only, at 0.7-1.5 s a
# step at 128 lanes with four flex residues, so the flex dock is cut from
# 1024 to 32 steps at full width and its command-line jobs to 4 (8 until
# [12] pushed the whole script to about 805 s), to keep [9] under 150 s
# (PERF.md section 4)
FLEX_STEPS, FLEX_CLI_STEPS = 32, 4
# phase [10]'s depth: the CNN in the loop adds a CNN evaluation of every
# lane to each general-path step (Metropolis) and CNN minimisations of the
# saved poses, so its dock is cut from 1024 to 8 MC steps at full width
# (128 lanes, the three-model ensemble on 48^3 grids) and its command-line
# jobs to 2 (at 16 steps the whole script took about 830 s on a slow host,
# over the 800 s it must stay under; 4 until [12] pushed it to about 805
# s; PERF.md section 4)
CNN_STEPS, CNN_CLI_STEPS = 8, 2
# phase [11]'s ligands (the first records of minout.sdf): gninagrid's
# grids, the file tools' round trip and the served minimisations.  Cut
# from 8 to 2 after [8]'s command-line cut: at 8, [11] took 86.0 s (a
# served minimisation and its direct twin 2.9 s each, the CPU's grids
# 21.5 s) and the whole script 827.6 s (PERF.md section 4)
TOOLS_LIGANDS = 2


class Failure(Exception):
    pass


def check(ok, what):
    if not ok:
        raise Failure(what)


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def close(a, b, rtol, atol):
    """|a - b| <= atol + rtol |b| elementwise (numpy's rule)."""
    a, b = a.double(), b.double()
    return bool(((a - b).abs() <= atol + rtol * b.abs()).all())


def stream_stats(out):
    """Per lane of a K3 window: its accept rate (accepted over completed
    steps), completed steps and mean candidate energy over the completed
    rows, as float64 numpy arrays."""
    st = out[6].double()
    flags, acc = st[..., 2], st[..., 1]
    done = flags.sum(1).clamp(min=1.0)
    e = (st[..., 0] * flags).sum(1) / done
    return {"accept rate": (acc.sum(1) / done).cpu().numpy(),
            "completed steps": flags.sum(1).cpu().numpy(),
            "mean candidate energy": e.cpu().numpy()}


def mutation_shares(rigid0, tors0, out, trace):
    """Shares of position, orientation and torsion mutations over a plain
    K3 window's completed rows: each row's mutated start against the chain
    head it was drawn from (the last accepted row before it, else the
    start)."""
    import torch

    srig, stor, sstat = out[4], out[5], out[6]
    hr, ht = rigid0.clone(), tors0.clone()
    n = torch.zeros(3, dtype=torch.float64, device=srig.device)
    for j in range(srig.shape[1]):
        done = sstat[:, j, 2] > 0.5
        sr, stt = trace["start_rigid"][:, j], trace["start_tors"][:, j]
        n[0] += (done & (sr[:, :3] != hr[:, :3]).any(1)).sum()
        n[1] += (done & (sr[:, 3:7] != hr[:, 3:7]).any(1)).sum()
        n[2] += (done & (stt != ht).any(1)).sum()
        a = done & (sstat[:, j, 1] > 0.5)
        hr = torch.where(a[:, None], srig[:, j], hr)
        ht = torch.where(a[:, None], stor[:, j], ht)
    return (n / n.sum().clamp(min=1.0)).cpu().numpy()


def timed(fn, reps):
    """Median wall of `reps` calls, each bracketed by CUDA events."""
    import torch

    ts = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        ts.append(t0.elapsed_time(t1))
    return float(np.median(ts))


def smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise Failure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def in_cutoff_fraction(coords, pack, lig_idx, cutoff_sqr):
    """Share of (heavy atom, receptor atom) pairs inside the cutoff, over
    the given heavy coordinates (L, N, 3)."""
    import torch

    nh = pack.nheavy.long()[lig_idx]
    rec = pack.rec[:, :3]
    inside, total = 0, 0
    for c0 in range(0, coords.shape[0], 64):
        c = coords[c0:c0 + 64]
        d2 = ((c[:, :, None, :] - rec) ** 2).sum(-1)         # (l, N, K)
        real = (torch.arange(c.shape[1], device=c.device)[None]
                < nh[c0:c0 + 64, None])
        inside += int(((d2 < cutoff_sqr) & real[..., None]).sum())
        total += int(real.sum()) * rec.shape[0]
    return inside / max(total, 1)


def kernel_ops(evals_value, evals_deriv, pack, lig_idx, frac_in):
    """FP32 operations of the given numbers of value and value+gradient
    evaluations per lane (tensors over lanes)."""
    nh = pack.nheavy.double()[lig_idx.long()]
    k = pack.rec.shape[0]
    pairs = nh * k
    intra = pack.imask.double().sum((1, 2))[lig_idx.long()]
    per_value = pairs * (OPS_PAIR_TEST + frac_in * OPS_PAIR_VALUE) \
        + intra * (OPS_PAIR_TEST + OPS_PAIR_VALUE)
    per_deriv = pairs * (OPS_PAIR_TEST + frac_in * OPS_PAIR_DERIV) \
        + intra * (OPS_PAIR_TEST + OPS_PAIR_DERIV)
    return float((evals_value.double() * per_value
                  + evals_deriv.double() * per_deriv).sum())


def pack_bytes(pack, lanes, m):
    """Bytes a launch must move: the pack, the receptor and the lane
    index read once, the poses read and written once."""
    t = [pack.lc, pack.ap, pack.node, pack.parent, pack.layer, pack.relax,
         pack.relo, pack.imask, pack.dofmask, pack.nheavy, pack.rec]
    n = sum(x.numel() * x.element_size() for x in t)
    return n + lanes * 4 * (1 + 2 * (8 + m))


def trace_dock(run):
    """Run `run()` once under torch.profiler; returns (wall s, device ms by
    kernel, launches of kernels other than the port's own).  Kernels run
    on one stream, so their durations add up to the device's busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (("k_async_mc", "async_mc_window"),
             ("k_lockstep_mc", "lockstep_mc_window"),
             ("k_bfgs", "bfgs_minimize"), ("k_eval_fg", "eval_fg"))
    busy = {nm: 0.0 for _, nm in names}
    busy["other kernels"] = 0.0
    n_other = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        nm = next((n for key, n in names if key in ev.name), None)
        if nm is None:
            nm = "other kernels"
            n_other += 1
        busy[nm] += ev.time_range.elapsed_us() / 1e3
    return wall, busy, n_other


def compare_k2(fd, terms, r, t, sc, pk, iters, wm, rtol, atol,
               async_ls=False):
    """K2 (K4 with async_ls) against its plain version from the same
    starts.  A lane whose two versions made the same numbers of Armijo
    trials and accepted steps took the same path and is held to (rtol,
    atol).  Any other lane had an
    Armijo test decided the other way (a flip); at most 1% of lanes may,
    and at one iteration each flip must be explained by the K1 bound: the
    Armijo margin at the deciding trial, recomputed by the plain version,
    lies within the K1 error of the two energies it compares.  Returns
    (max |de| over same-path lanes, flipped lanes)."""
    import torch

    got = fd.bfgs_minimize(terms, r, t, sc, pk, iters, wm,
                           async_ls=async_ls)
    torch.cuda.synchronize()
    ref = fd.bfgs_minimize_plain(terms, r, t, sc, pk, iters, wm,
                                 async_ls=async_ls)
    gs, rs = got[2], ref[2]
    same = (gs[:, 2] == rs[:, 2]) & (gs[:, 4] == rs[:, 4])
    err = max_err(gs[same, :2], rs[same, :2])
    check(close(gs[same, :2], rs[same, :2], rtol, atol),
          f"K2 energies at {iters} iterations off by {err}")
    flip = ~same
    nflip = int(flip.sum())
    check(nflip <= 0.01 * len(flip), f"K2 Armijo flips on {nflip} lanes")
    check(bool(torch.isfinite(gs[:, 0]).all()), "K2 non-finite energies")
    if iters == 1 and nflip:
        # the first trial that one version accepted and the other rejected
        tdec = torch.minimum(gs[:, 2], rs[:, 2]) - 1
        f0, _, g, _ = fd.eval_fg_plain(terms, r, t, sc, pk)
        p = -g * pk.dofmask[pk.lane_lig.long()]
        pg = (p * g).sum(1)
        alpha = torch.exp2(-tdec)
        rt, tt = fd._increment(r, t, p, alpha)
        f1 = fd.eval_fg_plain(terms, rt, tt, sc, pk)[0]
        margin = (f1 - f0 - fd.C0 * alpha * pg).abs()
        allow = 2e-4 * (f0.abs() + f1.abs()) + 4e-3
        check(bool((margin[flip] <= allow[flip]).all()),
              f"K2 Armijo flip not explained by the K1 bound: margins "
              f"{margin[flip].tolist()}")
    return err, nflip


def phase_k8(S, k2_starts, errs):
    """K8, the group stop (done_frac < 1), on the card.

    In k_bfgs, lockstep and async_ls, at L=128 and L=800 (seven groups, the
    last with 96 counted padding lanes), done_frac 0.5 and 0.9: against the
    plain version at the K2 bounds (1 and 3 iterations: a lane whose two
    versions made the same numbers of trials and accepted steps, and whose
    group ran the same number of iterations, is held to them wherever the
    uncoupled kernel meets them too, which at least 99% of lanes must; a
    lane with other counts had an Armijo test decided the other way, at
    most 1% may, and such a lane can move its group's stop: a stop may
    differ from plain only in a group that holds a lane whose uncoupled
    kernel and plain counts differ at the same depth, which the plain
    version, whose sums on the card come out the same in every run, shows
    alike in both runs); then at the main
    path's depth that every lane of a group reports one stop, that no lane
    ran past it, that a lane which ends on its own before the stop is bit
    for bit the uncoupled kernel's, that the same launch twice gives the
    same bits, and that done_frac = 1.0 is the uncoupled launch.  At L=128
    half the lanes start from minima and half from jittered poses, so that
    the lanes end at different iterations and the count decides.  A pose
    does not wait for its group at every iteration: it runs on and takes
    its state at the stop back from K8's ring; the lanes that did (the
    wrapper's `overrun`) are counted, and some must have.  In
    k_lockstep_mc (S=16, L=128 and L=64) on supplied uniforms against the
    plain steps."""
    import torch

    fd, fx, terms, dev = S.fd, S.fx, S.terms, S.dev
    mins = k2_starts["finish"]
    jit = k2_starts["refine"]
    half = S.lanes // 2
    mixed = (torch.cat([mins[0][:half], jit[0][half:]]).contiguous(),
             torch.cat([mins[1][:half], jit[1][half:]]).contiguous())
    shapes = (("refine", S.pack, S.lanes, S.scal_r, True, mixed),
              ("finish", S.pack_out, S.out_lanes, S.scal_s, False, mins))
    lines = []
    rolled_total = 0
    for label, pk, nl, sc, wm, (r, t) in shapes:
        for async_ls in (False, True):
            tag = "[async_ls,done_frac]" if async_ls else "[done_frac]"
            base = fd.bfgs_minimize(terms, r, t, sc, pk, S.miniters, wm,
                                    async_ls=async_ls)
            one = fd.bfgs_minimize(terms, r, t, sc, pk, S.miniters, wm,
                                   async_ls=async_ls, done_frac=1.0)
            torch.cuda.synchronize()
            check(all(torch.equal(x, y) for x, y in zip(base, one)),
                  f"K8 {label}: done_frac=1.0 is not the uncoupled launch")
            worst1 = worst3 = 0.0
            stops = {}
            moved_full = {}
            moved_flip = [0, 0]      # moved stops, groups with a flip
            votes_met = votes_eq = 0
            cap_slots = (S.miniters * fd.NUM_TRIALS + 1 if async_ls
                         else S.miniters)
            # groups holding a lane whose counts (trials, iterations,
            # accepted steps) differ between the uncoupled kernel and the
            # uncoupled plain version at the main path's depth
            pbase = fd.bfgs_minimize_plain(terms, r, t, sc, pk, S.miniters,
                                           wm, async_ls=async_ls)
            stray = (base[2][:, 2:5] != pbase[2][:, 2:5]).any(1)
            strayed = set((torch.nonzero(stray)[:, 0] // fd.GROUP).tolist())
            n_groups = -(-nl // fd.GROUP)

            def pair(iters, frac):
                """Kernel and plain stats at (iters, frac), and the lanes
                within (rtol, atol) of each other."""
                rtol, atol = (5e-4, 5e-3) if iters == 1 else (1e-2, 5e-2)
                kw = dict(async_ls=async_ls, done_frac=frac)
                gs = fd.bfgs_minimize(terms, r, t, sc, pk, iters, wm,
                                      **kw)[2]
                torch.cuda.synchronize()
                rs = fd.bfgs_minimize_plain(terms, r, t, sc, pk, iters, wm,
                                            **kw)[2]
                near = ((gs[:, :2].double() - rs[:, :2].double()).abs()
                        <= atol + rtol * rs[:, :2].double().abs()).all(1)
                return gs, rs, near

            for iters in (1, 3):
                fs, fr, near_free = pair(iters, 1.0)
                check(float(near_free.float().mean()) >= 0.99,
                      f"K8 {label}: the uncoupled kernel leaves the K2 "
                      f"bound on {int((~near_free).sum())} lanes")
                # groups holding a lane whose uncoupled counts (trials or
                # ticks, iterations, accepts) differ between kernel and
                # plain version: an Armijo, descent or convergence test
                # decided the other way, which may move the group's stop
                flipped = set((torch.nonzero(
                    (fs[:, 2:5] != fr[:, 2:5]).any(1))[:, 0]
                    // fd.GROUP).tolist())
                for frac in (0.5, 0.9):
                    gs, rs, near = pair(iters, frac)
                    moved = gs[:, 5] != rs[:, 5]
                    off = set((torch.nonzero(moved)[:, 0]
                               // fd.GROUP).tolist())
                    check(len(off - flipped) == 0, f"K8 {label} {frac}: at "
                          f"{iters} iterations the stop differs from plain "
                          f"in groups {sorted(off)}, without a flipped lane "
                          f"in {sorted(off - flipped)}")
                    moved_flip[0] += len(off)
                    moved_flip[1] += len(flipped)
                    same = ((gs[:, 2] == rs[:, 2]) & (gs[:, 4] == rs[:, 4])
                            & ~moved)
                    nflip = int((~same & ~moved).sum())
                    check(nflip <= 0.01 * nl,
                          f"K8 {label} {frac}: Armijo flips on {nflip} lanes")
                    held = same & near_free
                    err = max_err(gs[held, :2], rs[held, :2])
                    check(bool(near[held].all()),
                          f"K8 {label} {frac}: energies at {iters} "
                          f"iterations off plain by {err}")
                    if iters == 1:
                        worst1 = max(worst1, err)
                    else:
                        worst3 = max(worst3, err)
            votes = {}
            rolled = {}
            for frac in (0.5, 0.9):
                kv, pv = [], []
                a = fd.bfgs_minimize(terms, r, t, sc, pk, S.miniters, wm,
                                     async_ls=async_ls, done_frac=frac,
                                     votes=kv)
                rolled[frac] = int((fd.bfgs_minimize.overrun > 0).sum())
                b = fd.bfgs_minimize(terms, r, t, sc, pk, S.miniters, wm,
                                     async_ls=async_ls, done_frac=frac)
                torch.cuda.synchronize()
                check(all(torch.equal(x, y) for x, y in zip(a, b)),
                      f"K8 {label} {frac}: two launches differ")
                gi = a[2][:, 5]
                # the stops at the main path's depth against the plain
                # version's.  Over this many iterations float32 differences
                # decide some lane's Armijo or convergence test the other
                # way, and one such lane can move its group's stop; up to
                # the stop a coupled lane is the uncoupled one, so a group
                # may differ only if it holds a lane that already takes
                # another path in the UNCOUPLED kernel and plain version
                pi = fd.bfgs_minimize_plain(
                    terms, r, t, sc, pk, S.miniters, wm, async_ls=async_ls,
                    done_frac=frac, votes=pv)[2][:, 5]
                off = set((torch.nonzero(gi != pi)[:, 0]
                           // fd.GROUP).tolist())
                check(off <= strayed, f"K8 {label} {frac}: at {S.miniters} "
                      f"iterations the stop differs from plain in groups "
                      f"{sorted(off)} ({sorted(set(gi.tolist()))} vs "
                      f"{sorted(set(pi.tolist()))}); lanes of the uncoupled "
                      f"search stray only in groups {sorted(strayed)}")
                moved_full[frac] = len(off)
                # the stop against the kernel's own barrier words, which no
                # float32 difference touches: a group met (every block
                # arrived) at exactly the iterations it ran, its count with
                # the padding lanes stayed below the target at each but the
                # last, and reached it there unless the cap ended the loop
                v = votes[frac] = kv[0]
                check(v.shape == pv[0].shape == (n_groups, cap_slots),
                      f"K8 {label} {frac}: votes of shape {tuple(v.shape)}")
                heads = torch.arange(n_groups, device=dev) * fd.GROUP
                stop = gi[heads].long()[:, None]
                col = torch.arange(cap_slots, device=dev)[None]
                ran = col < stop
                check(torch.equal(v >= 0, ran), f"K8 {label} {frac}: a group "
                      f"met at an iteration it did not run, or missed one")
                pad = torch.zeros(n_groups, 1, dtype=torch.int32, device=dev)
                pad[-1] = n_groups * fd.GROUP - nl
                reached = ran & (v + pad >= int(frac * fd.GROUP))
                at_stop = col == stop - 1
                check(not bool((reached & ~at_stop).any()),
                      f"K8 {label} {frac}: a group ran on past its target")
                check(bool(((reached & at_stop).any(1)
                            | (stop[:, 0] == cap_slots)).all()),
                      f"K8 {label} {frac}: a group stopped short of its "
                      f"target")
                both = (v >= 0) & (pv[0] >= 0)
                votes_met += int(both.sum())
                votes_eq += int((both & (v == pv[0])).sum())
                grp = torch.arange(nl, device=dev) // fd.GROUP
                first = gi[(grp * fd.GROUP).clamp(max=nl - 1)]
                check(torch.equal(gi, first),
                      f"K8 {label} {frac}: lanes of one group stopped apart")
                cap = (S.miniters * fd.NUM_TRIALS + 1 if async_ls
                       else S.miniters)
                check(bool(((gi >= 1) & (gi <= cap)).all()),
                      f"K8 {label} {frac}: group iterations out of range")
                # a lane's own count: iterations entered, or active ticks
                own = a[2][:, 2] if async_ls else a[2][:, 3]
                check(bool((own <= gi).all()),
                      f"K8 {label} {frac}: a lane ran past its group's stop")
                # a lane the uncoupled kernel ends before the stop is
                # untouched by it; a cut lane never ends below the
                # uncoupled minimum (descent, +1e-3)
                own_free = base[2][:, 2] if async_ls else base[2][:, 3]
                free = own_free < gi
                check(torch.equal(a[0][free], base[0][free])
                      and torch.equal(a[1][free], base[1][free])
                      and torch.equal(a[2][free, :2], base[2][free, :2]),
                      f"K8 {label} {frac}: a lane that ended before the "
                      f"stop differs from the uncoupled kernel")
                check(bool((a[2][:, 0] >= base[2][:, 0] - 1e-3).all()),
                      f"K8 {label} {frac}: a cut lane ended below the "
                      f"uncoupled search")
                check(bool(torch.isfinite(a[0]).all()),
                      f"K8 {label} {frac}: non-finite poses")
                stops[frac] = sorted(set(gi.tolist()))
            rolled_total += sum(rolled.values())
            check(stops[0.5][0] <= stops[0.9][0],
                  f"K8 {label}: a lower done_frac stopped later")
            # up to the earlier stop the two runs are the same search
            both = (votes[0.5] >= 0) & (votes[0.9] >= 0)
            check(torch.equal(votes[0.5][both], votes[0.9][both]),
                  f"K8 {label}: the done counts at 0.5 and 0.9 differ "
                  f"before either stop")
            errs[f"bfgs_minimize{tag}/{label}"] = worst1
            lines.append(
                f"[3c] K8 bfgs_minimize{tag}/{label} (L={nl}) vs plain at "
                f"done_frac 0.5 and 0.9: max |de| {worst1:.2e} at 1 "
                f"iteration (rtol 5e-4, atol 5e-3), {worst3:.2e} at 3 (rtol "
                f"1e-2, atol 5e-2); at 1 and 3 iterations {moved_flip[0]} "
                f"stops moved against plain, each in one of the "
                f"{moved_flip[1]} groups (summed over the four cases) that "
                f"hold a lane flipped in the uncoupled search; at "
                f"{S.miniters} iterations the groups "
                f"stopped after {stops[0.5]} (0.5) and {stops[0.9]} (0.9) "
                f"{'ticks' if async_ls else 'iterations'}, the plain "
                f"version's stops in all but {moved_full[0.5]} (0.5) and "
                f"{moved_full[0.9]} (0.9) of {n_groups} groups, each of "
                f"them among the {len(strayed)} groups where a lane of the "
                f"uncoupled search ({int(stray.sum())} of {nl}) takes "
                f"another path in kernel and plain version; every stop is "
                f"where the kernel's own barrier words reach the target "
                f"(done counts equal to the plain version's at {votes_eq} of "
                f"{votes_met} meetings); one stop per group, ended lanes "
                f"bit-equal to the uncoupled kernel, two launches "
                f"bit-equal, 1.0 bit-equal to uncoupled; {rolled[0.5]} "
                f"(0.5) and {rolled[0.9]} (0.9) lanes ran past their "
                f"group's stop and rolled back")
    for ln in lines:
        print(ln, flush=True)
    check(rolled_total > 0, "K8: no lane ran past its group's stop: the "
          "poses waited for their groups")

    # The group stop's own cost: 128 copies of one pose do the same work in
    # every block, so no block waits for a slower one, and with done_frac
    # 0.99 the group stops where each pose stops anyway.  What the coupled
    # launch takes beyond the uncoupled one, over the iterations it ran, is
    # the vote, the read of the words and the ring record of an iteration,
    # and the one wait at the run's end (with the launch's extra cost: the
    # cooperative launch and the zeroed scratch).  Timed in turns: free,
    # coupled, coupled, free.
    r1 = jit[0][:1].expand(S.lanes, -1).contiguous()
    t1 = jit[1][:1].expand(S.lanes, -1).contiguous()
    parts = []
    for async_ls in (False, True):
        run = lambda frac: fd.bfgs_minimize(
            terms, r1, t1, S.scal_r, S.pack, S.miniters, True,
            async_ls=async_ls, done_frac=frac)
        out, ref = run(0.99), run(1.0)
        torch.cuda.synchronize()
        check(all(torch.equal(x, x[:1].expand_as(x)) for x in out[:2]),
              "K8: identical poses ended apart")
        check(torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1]),
              "K8: identical poses stopped off the uncoupled search")
        its = float(out[2][0, 5])
        ms = [timed(lambda: run(f), 20) for f in (1.0, 0.99, 0.99, 1.0)]
        extra = (ms[1] + ms[2] - ms[0] - ms[3]) / 2
        parts.append(f"{'async_ls' if async_ls else 'lockstep'}: uncoupled "
                     f"{ms[0]:.3f} and {ms[3]:.3f} ms, coupled {ms[1]:.3f} "
                     f"and {ms[2]:.3f} ms over {its:.0f} "
                     f"{'ticks' if async_ls else 'iterations'}, "
                     f"{1e3 * extra / max(its, 1.0):.2f} us each")
    print("[3c] K8's vote alone (128 copies of one pose, done_frac 0.99, "
          "the launch's extra cost included): " + "; ".join(parts),
          flush=True)

    # K5 coupled: S=16 steps on supplied uniforms, rows against the plain
    # steps from the kernel's own chain head.  At the lockstep dock's 128
    # lanes (a full group) one iteration a step at 0.9 and three at 0.5; at
    # the screen's 64 lanes (8 ligands x 8 chains, 64 counted padding lanes)
    # three iterations at 0.5, where the padding alone meets the target of 64
    # and every step's BFGS must stop after one iteration, and at 0.55 (6
    # real lanes needed).  Held: the group's iteration count (stats row 5)
    # equals the sum of the plain steps' counts (a step with a flipped
    # Armijo test may move it by at most maxiters), trial counts equal on
    # 98% of rows, Metropolis decisions recomputed, two launches bit-equal.
    # Energies: one iteration a step at K5's two-tier rule; three at 99% of
    # rows within the K2 three-iteration bound.  No bound on every row at
    # three iterations: a candidate mutated into a clash amplifies float32
    # differences from iteration to iteration, and the UNCOUPLED kernel's
    # rows, compared the same way on the same inputs, stray as far (printed
    # beside).
    pack64 = S.pack.with_lanes(torch.arange(
        LIGANDS // 2, device=dev, dtype=torch.int32).repeat_interleave(
            EXHAUSTIVENESS))
    k5_err, parts = 0.0, []
    for pk, maxit, frac, control in ((S.pack, 1, 0.9, False),
                                     (S.pack, 3, 0.5, True),
                                     (pack64, 3, 0.5, False),
                                     (pack64, 3, 0.55, False)):
        nl = pk.lanes
        ecur = torch.full((nl,), 3.0e38, device=dev)
        r, t = fx.packed_poses(S.rng, nl, S.lo, S.hi, S.lig, S.m, dev,
                               "perturbed")
        uni = torch.as_tensor(S.rng.random((16, fd.N_DRAWS, nl),
                                           dtype=np.float32), device=dev)
        inner = (5e-4, 5e-3) if maxit == 1 else (1e-2, 5e-2)

        def rows(kfrac):
            """The window at kfrac against its plain steps: (outputs, rows
            beyond the inner bound, largest |de|, flipped rows)."""
            got = fd.lockstep_mc_window(terms, r, t, S.scal_h, pk, ecur, 16,
                                        maxit, uniforms=uni, done_frac=kfrac)
            torch.cuda.synchronize()
            rep = fd.replay_lockstep_window_plain(
                terms, r, t, S.scal_h, pk, ecur, got[4:], uni, maxit,
                done_frac=kfrac)
            same = rep[2] == got[6][..., 2]
            ek, er = got[6][..., 0][same].double(), rep[0][same].double()
            tight = (ek - er).abs() <= inner[1] + inner[0] * er.abs()
            return got, rep, same, ek, er, int((~tight).sum())

        got, rep, same, ek, er, n_loose = rows(frac)
        rolled = int((fd.lockstep_mc_window.overrun > 0).sum())
        again = fd.lockstep_mc_window(terms, r, t, S.scal_h, pk, ecur, 16,
                                      maxit, uniforms=uni, done_frac=frac)
        torch.cuda.synchronize()
        tag = f"K8 in K5 (L={nl}, maxiters {maxit}, done_frac {frac})"
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"{tag}: two launches differ")
        gi = got[2][:, 5]
        grp = torch.arange(nl, device=dev) // fd.GROUP
        check(torch.equal(gi, gi[(grp * fd.GROUP).clamp(max=nl - 1)]),
              f"{tag}: lanes of one group ran different iteration counts")
        check(bool(((gi >= 16) & (gi <= 16 * maxit)).all()),
              f"{tag}: group iterations out of range")
        nflip = int((~same).sum())
        check(nflip <= 0.02 * same.numel(),
              f"{tag}: trial counts differ from plain on {nflip} rows")
        flipped_steps = int((~same).any(0).sum())
        gap = float((gi - rep[5].sum(1)).abs().max())
        check(gap <= maxit * flipped_steps,
              f"{tag}: the group ran {sorted(set(gi.tolist()))} iterations, "
              f"the plain steps {sorted(set(rep[5].sum(1).tolist()))}")
        if pk is pack64 and frac == 0.5:
            check(bool((gi == 16).all()), f"{tag}: the padding lanes alone "
                  f"meet the target, yet the group ran {gi[0]} iterations")
        err = max_err(ek, er)
        check(n_loose <= 0.01 * ek.numel()
              and (maxit > 1 or close(ek, er, 1e-2, 5e-2)),
              f"{tag}: stream energies off the plain steps by {err} "
              f"({n_loose} rows beyond rtol {inner[0]}, atol {inner[1]})")
        check(torch.equal(got[6][..., 1] > 0.5, rep[3]),
              f"{tag}: Metropolis decisions")
        k5_err = max(k5_err, err)
        part = (f"L={nl} maxiters {maxit} done_frac {frac}: {gi[0]:.0f} "
                f"iterations of at most {16 * maxit} as in the plain steps, "
                f"{n_loose} of {ek.numel()} rows beyond rtol {inner[0]}, "
                f"atol {inner[1]}, max |de| {err:.2e}, trial counts differ "
                f"on {nflip} rows, {rolled} lanes rolled back in some step")
        if control:
            _, _, _, ek1, er1, n_loose1 = rows(1.0)
            part += (f" (the uncoupled kernel against its plain steps on "
                     f"the same inputs: {n_loose1} rows beyond, max |de| "
                     f"{max_err(ek1, er1):.2e})")
        parts.append(part)
    errs["lockstep_mc_window[done_frac]"] = k5_err
    print("[3c] K8 in lockstep_mc_window (S=16, supplied uniforms) vs the "
          "plain steps; one iteration a step: 99% of rows within rtol 5e-4, "
          "atol 5e-3 and all within rtol 1e-2, atol 5e-2; three: 99% within "
          "rtol 1e-2, atol 5e-2; Metropolis decisions recomputed, two "
          "launches bit-equal, one count per group. " + "; ".join(parts),
          flush=True)


def phase_streamed(S, errs):
    """K1 and one K3 window on a receptor above the shared-memory budget: a
    synthetic receptor from --seed in a 34 A box (a 60 A cube, about 2.9x
    the main path's atoms after pruning), which the kernels stream through
    shared-memory tiles.  K1 at the rescore's L=800 against its plain
    version (the bounds of phase 2); K3 at L=128 on supplied uniforms, S=4
    and one iteration, against the plain window and its plain steps (the
    rules of phase 4), then a full window (S=128, tick budget 16) on Philox,
    timed beside the main path's."""
    import torch

    from gnina_tpu_torch.chem.ingest import box_from_center_size
    from gnina_tpu_torch.scoring.builtin import get_scoring_function

    fd, fx, terms, dev, rng = S.fd, S.fx, S.terms, S.dev, S.rng
    rec, lig, center, size = fx.system(seed=S.seed, box=34.0, cube=60.0)
    sf = get_scoring_function("vina")
    pruned = rec.pruned(np.asarray(center), np.asarray(size) / 2,
                        margin=sf.cutoff)
    kr = len(pruned.types)
    lo, hi = box_from_center_size(center, size)
    pack = fd.build_pack([lig] * LIGANDS, pruned.coords, pruned.types,
                         np.ones(kr, np.float32), EXHAUSTIVENESS, sf.table,
                         m_pad=S.m, device=dev)
    n, m_, _, _, lanes = pack.dims
    plan = fd.smem_plan(n, m_, 6 + m_ - 1, kr)
    check(not plan.resident, f"K={kr}: the receptor did not stream")
    pack_out = pack.with_lanes(S.pack_out.lane_lig)
    nl_out = S.out_lanes
    scal_r = fd.scal_vector(1000.0, 1000.0, 1e3, 1000.0, lo, hi, device=dev)
    scal_h = fd.scal_vector(10.0, 10.0, 1e3, 1000.0, lo, hi, 2.0, 1.2,
                            device=dev)
    e_err = g_err = c_err = 0.0
    for kind in ("random", "perturbed"):
        r, t = fx.packed_poses(rng, nl_out, lo, hi, lig, S.m, dev, kind)
        got = fd.eval_fg(terms, r, t, scal_r, pack_out)
        torch.cuda.synchronize()
        ref = fd.eval_fg_plain(terms, r, t, scal_r, pack_out)
        for i, nm in ((0, "e"), (1, "e_metro")):
            check(close(got[i], ref[i], 2e-4, 2e-3), f"K1 streamed {nm} "
                  f"({kind}) off by {max_err(got[i], ref[i])}")
        e_err = max(e_err, max_err(got[0], ref[0]), max_err(got[1], ref[1]))
        if kind == "perturbed":
            g_err = max_err(got[2], ref[2])
            check(close(got[2], ref[2], 1e-3, 1e-2),
                  f"K1 streamed gradient off by {g_err}")
        c_err = max(c_err, max_err(got[3], ref[3]))
        check(c_err <= 1e-4, f"K1 streamed coords off by {c_err} A")
        del ref
    errs["eval_fg/streamed"] = e_err

    ecur = torch.full((lanes,), 3.0e38, device=dev)
    s_steps, maxit = 4, 1
    budget = 1 + maxit * fd.NUM_TRIALS
    r, t = fx.packed_poses(rng, lanes, lo, hi, lig, S.m, dev, "perturbed")
    uni = torch.as_tensor(rng.random((s_steps * budget, fd.N_DRAWS, lanes),
                                     dtype=np.float32), device=dev)
    got = fd.async_mc_window(terms, r, t, scal_h, pack, ecur, s_steps,
                             budget, maxit, uniforms=uni)
    torch.cuda.synchronize()
    ref = fd.async_mc_window_plain(terms, r, t, scal_h, pack, ecur, s_steps,
                                   budget, maxit, uniforms=uni)
    gs, rs = got[6], ref[6]
    check(torch.equal(gs[..., 2], rs[..., 2]), "K3 streamed completion flags")
    e_rep, p_rep, acc_rep, ticks = fd.replay_mc_window_plain(
        terms, r, t, scal_h, pack, ecur, got[4:], uni)
    same = ticks == got[2][:, 2].long()
    flips = int((~same).sum())
    check(flips <= 0.01 * lanes, f"K3 streamed Armijo flips on {flips} lanes")
    row0 = max_err(gs[same, 0, 0], rs[same, 0, 0])
    check(close(gs[same, 0, 0], rs[same, 0, 0], 5e-4, 5e-3),
          f"K3 streamed first-step energies off the plain window by {row0}")
    k3_err = max_err(gs[same][..., 0], e_rep[same])
    check(close(gs[same][..., 0], e_rep[same], 5e-4, 5e-3),
          f"K3 streamed stream energies off the plain steps by {k3_err}")
    check(max_err(got[4][same][..., :3], p_rep[same]) <= 2e-3,
          "K3 streamed stream positions off the plain steps")
    check(torch.equal(gs[same][..., 1] > 0.5, acc_rep[same]),
          "K3 streamed Metropolis decisions")
    errs["async_mc_window/streamed"] = k3_err

    r, t = fx.packed_poses(rng, lanes, lo, hi, lig, S.m, dev, "random")
    run = lambda: fd.async_mc_window(terms, r, t, scal_h, pack, ecur, 128, 16,
                                     S.miniters, seed=S.seed + 2)
    full = run()
    torch.cuda.synchronize()
    flags = full[6][..., 2]
    check(bool(((flags == 0) | (flags == 1)).all())
          and torch.equal(flags.sum(1), full[2][:, 4])
          and bool(torch.isfinite(full[6][..., 0][flags > 0]).all()),
          "K3 streamed full window")
    ms = timed(run, 3)
    frac = in_cutoff_fraction(full[3], pack, pack.lane_lig.long(),
                              terms.cutoff_sqr)
    print(f"[4f] receptor above the shared-memory budget: K = {kr} atoms "
          f"({plan.n_tiles} tiles of {plan.rec_tile}, {plan.nbytes} B of "
          f"shared memory a block): K1 vs plain at L={nl_out} max |de| "
          f"{e_err:.2e} (rtol 2e-4, atol 2e-3), |dg| {g_err:.2e} (rtol 1e-3, "
          f"atol 1e-2), |dx| {c_err:.2e} A (1e-4); K3 (S=4, maxiters 1, "
          f"supplied uniforms) completion flags equal, max |de| {row0:.2e} on "
          f"first steps, {k3_err:.2e} over the stream against the plain "
          f"steps (rtol 5e-4, atol 5e-3), Metropolis decisions recomputed, "
          f"Armijo flips on {flips} of {lanes} lanes; full window S=128 "
          f"budget 16: {ms:.3f} ms, {int(flags.sum())} steps completed, "
          f"{int(full[2][:, 2].sum())} evaluations, in-cutoff pair share "
          f"{frac:.4f}", flush=True)


def phase_probes(S, errs):
    """K9-K11 against their plain versions at the script's default sizes
    (L=128, N=32, K=1280, 20 repetitions), then timed; returns the table
    rows.  Tolerances: each checksum is a float32 sum of 1e8 (K9), 8e5
    (K10) or 8e6 (K11) terms taken in another order than the plain
    version's, held to 2e-5 of the sum of the terms' magnitudes; bfloat16
    pair arithmetic rounds at other places in the two versions (hexp and
    hsqrt against float32 functions rounded once): 2e-2 of it."""
    import torch

    from gnina_tpu_torch import probes

    dev = S.dev
    lanes, n, k, reps = 128, 32, 1280, 20
    x = probes.make_inputs(S.seed, lanes, n, k, dev)
    a = n * lanes
    mag_pairs = reps * float(probes.pair_energies(
        x["lig"], x["ligp"], x["rec"], x["recp"]).abs().sum())
    mag_gather = reps * float(
        (x["cells"][x["idx"].long(), :8] * x["w"]).abs().sum())
    mag_mxu = reps * float(x["g"].float()[x["tgt"][:, 0].long()].abs().sum())
    pair_args = (x["lig"], x["ligp"], x["rec"], x["recp"], reps)
    ii = torch.arange(probes.MXU_KDIM, device=dev, dtype=torch.int32)[None]
    onehot = (ii == x["tgt"]).to(torch.bfloat16)

    def lib_mxu():
        for _ in range(reps):
            torch.matmul(onehot, x["g"])

    in_bytes = lambda *names: sum(x[nm].numel() * x[nm].element_size()
                                  for nm in names) + 4
    cases = (
        ("probe_pairs/f32", lambda: probes.probe_pairs(*pair_args),
         lambda: probes.probe_pairs_plain(*pair_args), 2e-5, mag_pairs,
         OPS_PROBE_PAIR * a * k * reps / FP32_PEAK,
         in_bytes("lig", "ligp", "rec", "recp"), None,
         "scripts/tpu_pallas_probe.py:104"),
        ("probe_pairs/bf16",
         lambda: probes.probe_pairs(*pair_args, dtype=torch.bfloat16),
         lambda: probes.probe_pairs_plain(*pair_args, dtype=torch.bfloat16),
         2e-2, mag_pairs, OPS_PROBE_PAIR * a * k * reps / BF16_VECTOR_PEAK,
         in_bytes("lig", "ligp", "rec", "recp"), None,
         "scripts/tpu_pallas_probe.py:104"),
        ("probe_gather_loop",
         lambda: probes.probe_gather_loop(x["idx"], x["cells"], x["w"], reps),
         lambda: probes.probe_gather_loop_plain(x["idx"], x["cells"], x["w"],
                                                reps),
         2e-5, mag_gather, 16 * a * reps / FP32_PEAK,
         a * (4 + 32 + 32) + 4, None, "scripts/tpu_pallas_probe.py:126"),
        ("probe_mxu", lambda: probes.probe_mxu(x["tgt"], x["g"], reps),
         lambda: probes.probe_mxu_plain(x["tgt"], x["g"], reps), 2e-5,
         mag_mxu, 2.0 * a * probes.MXU_KDIM * 128 * reps / BF16_PEAK,
         in_bytes("tgt", "g"), lib_mxu, "scripts/tpu_pallas_probe.py:163"),
    )
    rows = []
    for name, kern, plain, tol, mag, ops_s, nbytes, lib, replaces in cases:
        got = float(kern())
        torch.cuda.synchronize()
        ref = float(plain())
        again = float(kern())
        err = abs(got - ref)
        check(np.isfinite(got) and err <= tol * mag,
              f"{name}: checksum {got} vs plain {ref} (allowed {tol * mag})")
        check(got == again, f"{name}: two launches differ")
        errs[name] = err
        bytes_s = nbytes / HBM_RATE
        rows.append(dict(
            name=name, shape=f"L={lanes} N={n} K={k} reps={reps}",
            ms=timed(kern, 5), plain_ms=timed(plain, 2),
            bound_ms=max(ops_s, bytes_s) * 1e3,
            bound_by="operations" if ops_s >= bytes_s else "bytes",
            library_ms=timed(lib, 5) if lib else None, replaces=replaces,
            max_abs_err=err, source="gnina_tpu_torch/csrc/probes.cu"))
        print(f"[4e] {name} vs plain: checksum {got:.6g} vs {ref:.6g}, |d| "
              f"{err:.3g} (allowed {tol:g} x {mag:.4g} = {tol * mag:.3g}), "
              f"two launches equal", flush=True)
    # the floor under K10: an empty kernel launched with K10's grid
    plan = probes.gather_plan(a, reps)
    floor = timed(lambda: probes.launch_empty(plan["blocks"],
                                              plan["threads"]), 5)
    gather = next(r for r in rows if r["name"] == "probe_gather_loop")
    print(f"[4e] an empty kernel on probe_gather_loop's grid ({plan['blocks']} "
          f"blocks of {plan['threads']}): {floor:.4f} ms a call, against "
          f"{gather['ms']:.4f} ms", flush=True)
    # the probes' own path: the script a user runs, counts set to 0 before
    for pr in probes.PROBES:
        pr.reset()
    probes.run(dev)
    torch.cuda.synchronize()
    counts = {pr.name: pr.launches for pr in probes.PROBES}
    calls = {pr.name: pr.calls for pr in probes.PROBES}
    check(all(counts[nm] == probes.LAUNCHES_PER_CALL * calls[nm] > 0
              for nm in counts), f"probe launches {counts} of calls {calls}")
    for row in rows:
        row["launches"] = counts[row["name"].split("/")[0]]
        row["calls"] = calls[row["name"].split("/")[0]]
    print(f"[4e] python -m gnina_tpu_torch.probes in process: calls {calls}, "
          f"kernel launches {counts} ({probes.LAUNCHES_PER_CALL} a call: "
          f"block 0 adds the blocks' sums)", flush=True)
    return rows


def phase_cli(S, scorer_names):
    """The command line at full width: a screen of 16 copies of the ligand
    through cli.main (autobox, exhaustiveness 8, 1024 steps, the default CNN
    rescore, fused_done_frac 0.9 from the environment), then --score_only,
    --minimize and --randomize_only on one ligand.  Returns the screen's
    kernel launches and its walls at done_frac 0.9 and 1.0."""
    import re
    import tempfile

    import torch

    from gnina_tpu_torch import cli

    fd, fx = S.fd, S.fx
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    path = lambda name: os.path.join(tmp, name)

    def read(name):
        with open(path(name)) as f:
            return f.read()

    with open(path("rec.pdb"), "w") as f:
        f.write(fx.receptor_pdb_text(fx.ligand_center(S.lig), S.seed))
    with open(fx.LIGAND_SDF) as f:
        first = f.read().split("$$$$\n")[0] + "$$$$\n"
    body = first[first.index("\n"):]
    names = [f"lig{i:02d}" for i in range(LIGANDS)]
    with open(path("one.sdf"), "w") as f:
        f.write(first)
    with open(path("ligs.sdf"), "w") as f:
        f.write("".join(n + body for n in names))

    captured, sizes = [], []
    real_dock = cli.DockingEngine.dock_batch

    def spy(self, *a, **kw):
        res = real_dock(self, *a, **kw)
        captured.extend(res)
        sizes.append(len(res))
        return res

    def screen(frac, tag):
        os.environ["GNINA_TPU_FUSED_DONE_FRAC"] = str(frac)
        argv = ["-r", path("rec.pdb"), "-l", path("ligs.sdf"),
                "--autobox_ligand", path("one.sdf"), "--exhaustiveness",
                str(EXHAUSTIVENESS), "--num_mc_steps", str(MC_STEPS),
                "--seed", str(S.seed + 1), "-o", path(f"out_{tag}.sdf"),
                "--log", path(f"screen_{tag}.log"), "-q"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(argv)                 # no --device: the card
        torch.cuda.synchronize()
        return rc, time.perf_counter() - t0

    try:
        cli.DockingEngine.dock_batch = spy
        for k in fd.KERNELS:
            k.reset()
        rc, cold = screen(0.9, "a")
        cnt = read_counts(fd)
        launches, coupled, calls = cnt.launches, cnt.coupled, cnt.calls
        check(rc == 0, f"the screen returned {rc}")
        # batches of max(8, K3 slots // exhaustiveness) ligands: one of 16
        # on an H100
        n_b = len(sizes)
        n_win = MC_STEPS // 128
        # the finish stages' lanes (a batch's ligands x saved poses) exceed
        # what one cooperative launch holds, so they make more launches than
        # calls
        check(calls["async_mc_window"] == n_b * n_win
              and calls["bfgs_minimize"] == n_b * (2 * n_win + 5)
              and calls["eval_fg"] == n_b
              and launches["bfgs_minimize"] >= calls["bfgs_minimize"],
              f"screen calls {calls}, launches {launches}")
        check(coupled["bfgs_minimize"] == launches["bfgs_minimize"],
              f"the screen ran K2 uncoupled: {coupled}")
        check(len(captured) == LIGANDS, "the screen docked "
              f"{len(captured)} ligands")
        blocks = [b for b in read("out_a.sdf").split("$$$$\n") if b.strip()]
        log = read("screen_a.log")
        it = iter(blocks)
        n_poses = 0
        for name, res in zip(names, captured):
            check(bool(res), f"{name}: no poses")
            check(f"## {name}\n" in log, f"{name} missing from the log")
            for p in res:
                b = next(it, "")
                check(b.splitlines()[0] == name, f"block order at {name}")
                tag = re.search(r">  <minimizedAffinity>\n(\S+)", b)
                check(tag is not None and tag.group(1) == f"{p.energy:.5f}",
                      f"{name}: minimizedAffinity tag vs the engine's "
                      f"{p.energy:.5f}")
                check(">  <CNNscore>" in b and ">  <CNNaffinity>" in b,
                      f"{name}: CNN tags missing")
                n_poses += 1
        check(next(it, None) is None, "more SDF blocks than poses")
        best = [r[0].energy for r in captured]
        # the same screen at 1.0 and 0.9 in turns, warm: 1.0, 0.9, 0.9, 1.0
        walls = {0.9: [], 1.0: []}
        means = {}
        for i, frac in enumerate((1.0, 0.9, 0.9, 1.0)):
            del captured[:]
            rc, w = screen(frac, f"t{i}")
            check(rc == 0, f"the screen at done_frac {frac} returned {rc}")
            walls[frac].append(w)
            means[frac] = float(np.mean([r[0].energy for r in captured]))
    finally:
        cli.DockingEngine.dock_batch = real_dock
        os.environ.pop("GNINA_TPU_FUSED_DONE_FRAC", None)
    print(f"[5h] cli.main screen: {LIGANDS} ligands in {n_b} batches of "
          f"{sizes[0]} x "
          f"{EXHAUSTIVENESS} chains, {MC_STEPS} steps, default CNN rescore "
          f"({', '.join(scorer_names)}), GNINA_TPU_FUSED_DONE_FRAC=0.9: rc "
          f"0, {n_poses} SDF blocks for {LIGANDS} ligands in input order, "
          f"every minimizedAffinity tag equal to the engine's energy, CNN "
          f"tags present; first call {cold:.2f} s (loads the ensemble); "
          f"calls {calls}, launches {launches}, coupled {coupled}; warm "
          f"walls at done_frac "
          f"1.0 {walls[1.0][0]:.2f} and {walls[1.0][1]:.2f} s, at 0.9 "
          f"{walls[0.9][0]:.2f} and {walls[0.9][1]:.2f} s (in turns 1.0, "
          f"0.9, 0.9, 1.0); mean best energy {means[1.0]:.3f} (1.0) vs "
          f"{means[0.9]:.3f} (0.9) kcal/mol; best of the first run "
          f"{min(best):.3f}", flush=True)

    # the other modes on one ligand
    base = ["-r", path("rec.pdb"), "-l", path("one.sdf"), "-q"]
    for k in fd.KERNELS:
        k.reset()
    t0 = time.perf_counter()
    rc = cli.main(base + ["--score_only", "--log", path("score.log"), "-o",
                          path("score.sdf")])
    t_score = time.perf_counter() - t0
    check(rc == 0 and fd.eval_fg.launches == 1,
          f"--score_only: rc {rc}, K1 launches {fd.eval_fg.launches}")
    slog = read("score.log")
    aff = re.search(r"Affinity: (-?[\d.]+) \(kcal/mol\)", slog)
    cs = re.search(r"CNNscore: ([\d.]+)", slog)
    check(aff is not None and cs is not None
          and "Term values, before weighting:" in slog
          and "Intramolecular energy:" in slog, "--score_only log lines")
    check(0.0 < float(cs.group(1)) < 1.0, "--score_only CNNscore")
    t0 = time.perf_counter()
    rc = cli.main(base + ["--minimize", "--cnn_scoring", "none", "--log",
                          path("min.log"), "-o", path("min.sdf")])
    t_min = time.perf_counter() - t0
    mlog = read("min.log")
    m_aff = re.search(r"Affinity: (-?[\d.]+)  (-?[\d.]+) \(kcal", mlog)
    m_rmsd = re.search(r"RMSD: ([\d.]+)", mlog)
    check(rc == 0 and m_aff is not None and m_rmsd is not None,
          "--minimize log lines")
    # the same on the CPU: one basin (0.05 kcal/mol, 0.1 A)
    rc = cli.main(base + ["--minimize", "--cnn_scoring", "none", "--device",
                          "cpu", "--log", path("min_cpu.log")])
    c_aff = re.search(r"Affinity: (-?[\d.]+)", read("min_cpu.log"))
    c_rmsd = re.search(r"RMSD: ([\d.]+)", read("min_cpu.log"))
    check(rc == 0 and abs(float(m_aff.group(1)) - float(c_aff.group(1)))
          <= 0.05 and abs(float(m_rmsd.group(1)) - float(c_rmsd.group(1)))
          <= 0.1, f"--minimize on the card {m_aff.group(1)} vs the CPU "
          f"{c_aff.group(1)}")
    check(float(m_aff.group(1)) < float(aff.group(1)),
          "--minimize did not lower the affinity")
    rc = cli.main(base + ["--randomize_only", "--cnn_scoring", "none",
                          "--num_modes", "3", "--log", path("rand.log"), "-o",
                          path("rand.sdf")])
    check(rc == 0 and read("rand.log").count("Clash penalty:") == 3
          and read("rand.sdf").count("$$$$") == 3,
          "--randomize_only")
    check(cli.main(base + ["--no_such_flag"]) == 1, "unknown flag accepted")
    print(f"[5h] cli.main on one ligand: --score_only rc 0 in {t_score:.2f} "
          f"s (K1 once; Affinity {aff.group(1)}, CNNscore {cs.group(1)}); "
          f"--minimize rc 0 in {t_min:.2f} s (Affinity {m_aff.group(1)}, "
          f"RMSD {m_rmsd.group(1)}; on the CPU {c_aff.group(1)}, "
          f"{c_rmsd.group(1)}: within 0.05 kcal/mol and 0.1 A); "
          f"--randomize_only rc 0, 3 poses; an unknown flag returns 1",
          flush=True)
    return launches, coupled, walls


def timed_populate(eng):
    """Wrap the engine's _populate_cache (an instance attribute over the
    method; `del eng._populate_cache` unwraps it) so that each call's wall,
    the card synchronised on both sides, and its grids are recorded:
    returns the two lists."""
    import torch

    walls, grids = [], []
    real = eng._populate_cache

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        grids.append(out)
        return out

    eng._populate_cache = timed
    return walls, grids


def phase_general(seed, steps, cli_steps, seeds=3):
    """[8] The general path (fused_search="off": search grids, the per-step
    MC of mc_chunk, the stages on the exact energy; ordinary PyTorch, no
    kernel) on the card, on the main job: 16 copies of the ligand x 8
    chains in the 20 A box of the seed's synthetic receptor, `steps` MC
    steps.  Times the populate and the dock, checks every pose (energy =
    the engine's exact rescore of its conf within 1e-3 kcal/mol, and K1's,
    an energy code of its own, within 1e-3 plus 0.005 per pair at the
    cutoff; heavy atoms in the box; finite), runs a --scoring
    dkoes_scoring and a --user_grid job through cli.main (`cli_steps`
    steps, one ligand), and docks the job under `seeds` seeds on both
    routes for the fused-against-general quality comparison
    (scripts/quality_gate.py's bar, reported)."""
    import re
    import tempfile

    import torch

    from gnina_tpu_torch import _fixtures as fx
    from gnina_tpu_torch import cli
    from gnina_tpu_torch.chem.ingest import box_from_center_size
    from gnina_tpu_torch.constants import IS_HYDROGEN
    from gnina_tpu_torch.docking import DockingEngine, DockSettings, \
        exact_split
    from gnina_tpu_torch.ops import cache_grid as cg
    from gnina_tpu_torch.ops import fused_dock as fd
    from gnina_tpu_torch.ops.energy import Box
    from gnina_tpu_torch.types import Conf, pad_ligand, pad_receptor

    rec, lig, center, size = fx.system(seed=seed, box=20.0)
    ligs = [lig] * LIGANDS
    lo, hi = box_from_center_size(center, size)
    base = dict(cnn_scoring="none", num_mc_steps=steps,
                exhaustiveness=EXHAUSTIVENESS)
    gen = DockingEngine(DockSettings(fused_search="off", **base))
    check(gen.device.type == "cuda", "the general engine is not on the card")
    pop, made = timed_populate(gen)
    results, wall, cnt = counted_dock(fd, gen, rec, ligs, center, size,
                                      seed=seed)
    check(not any(cnt.launches.values()),
          f"the general path launched kernels: {cnt.launches}")
    del gen._populate_cache
    grids = made[0] if made else None
    check(len(pop) == 1 and grids is not None
          and tuple(grids.data.shape[1:]) == cg.grid_shape_for(lo, hi)
          and grids.data.is_cuda, "the search grids were not populated once "
          "on the card")
    # every pose against the engine's exact rescore of its conf (the
    # assembly, within 1e-3 kcal/mol) and against K1's (the fused route's
    # rescore on a one-lane-a-pose pack, an energy code of its own), within
    # 1e-3 plus 0.005 per atom pair within 2e-3 A^2 of the cutoff as in
    # [5]; these K1 launches follow the counted run
    sf = gen.sf
    dev = gen.device
    ru = lambda x, k: max(-(-x // k) * k, k)
    n, m = ru(lig.num_atoms, 8), ru(lig.num_nodes, 4)
    pruned = rec.pruned(np.asarray(center), np.asarray(size) / 2,
                        margin=sf.cutoff)
    rec_d = pad_receptor(pruned.coords, pruned.types, pruned.charges,
                         ru(len(pruned.types), 128), device=dev)
    lig_d = pad_ligand(lig, n, m, ru(len(lig.pairs), 32), device=dev)
    efn = gen._make_efn(ru(int(lig.layer.max()), 4))
    box = Box(lo=torch.as_tensor(lo, device=dev),
              hi=torch.as_tensor(hi, device=dev))
    rc = np.asarray(pruned.coords, np.float64)
    heavy = ~IS_HYDROGEN[lig.types]
    worst, k1_worst, k1_band, n_band, n_poses = 0.0, 0.0, 0.0, 0, 0
    for res in results:
        check(bool(res), "a ligand without poses")
        tors = np.zeros((len(res), m - 1), np.float32)
        for i, p in enumerate(res):
            tors[i, :len(p.conf_torsions)] = p.conf_torsions
        conf = Conf(*[torch.as_tensor(np.asarray(x, np.float32), device=dev)
                      for x in ([p.conf_position for p in res],
                                [p.conf_orientation for p in res], tors)])
        with torch.no_grad():
            inter, _ = exact_split(efn, lig_d, rec_d, conf, box, 1e3,
                                   [1000.0] * 3)
        e_own = gen._conf_independent(lig, inter.cpu().numpy())
        pack = fd.build_pack([lig], pruned.coords, pruned.types,
                             np.ones(len(pruned.types), np.float32),
                             len(res), sf.table, m_pad=m, device=dev)
        rigid, ptors = fd.conf_to_packed(conf, m)
        inter, _ = gen._exact_energies(rigid, ptors, pack, lo, hi, 1e3)
        e_k1 = gen._conf_independent(lig, inter)
        for i, p in enumerate(res):
            check(bool(np.isfinite(p.energy))
                  and bool(np.isfinite(p.coords).all()), "non-finite pose")
            worst = max(worst, abs(p.energy - float(e_own[i])))
            c = np.clip(np.asarray(p.coords, np.float64)[heavy], lo, hi)
            d2 = ((c[:, None] - rc[None]) ** 2).sum(-1)
            band = int((np.abs(d2 - sf.cutoff ** 2) < 2e-3).sum())
            de = abs(p.energy - float(e_k1[i]))
            check(de <= 1e-3 + 0.005 * band, f"pose energy {p.energy} vs "
                  f"K1's rescore {e_k1[i]} ({band} pairs at the cutoff)")
            if band:
                n_band += 1
                k1_band = max(k1_band, de)
            else:
                k1_worst = max(k1_worst, de)
            c = p.coords[heavy]
            check(bool(((c >= lo - 1e-3) & (c <= hi + 1e-3)).all()),
                  "a pose outside the box")
        e = [p.energy for p in res]
        check(e == sorted(e), "poses not sorted by energy")
        n_poses += len(res)
    check(worst <= 1e-3, f"pose energy vs the engine's rescore: {worst}")
    print(f"[8] general path (fused_search='off'), {LIGANDS} ligands x "
          f"{EXHAUSTIVENESS} chains, {steps} steps, 20 A box: populate "
          f"{pop[0]:.2f} s ({len(grids.type_gridded.nonzero())} types on "
          f"{'x'.join(str(v) for v in grids.data.shape[1:])} points, "
          f"K = {len(pruned.types)}), dock {wall:.2f} s wall with the "
          f"populate ({(wall - pop[0]) / steps * 1e3:.1f} ms a step); "
          f"{n_poses} poses, every energy the engine's exact rescore "
          f"within {worst:.2e} kcal/mol and K1's within {k1_worst:.2e} "
          f"({k1_band:.2e} on the {n_band} poses with a pair within 2e-3 "
          f"A^2 of the cutoff), every pose in the box; best "
          f"{min(r[0].energy for r in results):.3f} kcal/mol; no kernel "
          f"launched", flush=True)

    # the command line: a dkoes_scoring job and a user-grid job
    tmp = tempfile.mkdtemp(prefix="chip_smoke_general_")
    path = lambda name: os.path.join(tmp, name)
    with open(path("rec.pdb"), "w") as f:
        f.write(fx.receptor_pdb_text(fx.ligand_center(lig), seed))
    with open(fx.LIGAND_SDF) as f:
        first = f.read().split("$$$$\n")[0] + "$$$$\n"
    with open(path("one.sdf"), "w") as f:
        f.write(first)
    # an AD4 map of 41^3 points 0.5 A apart around the ligand: a bowl
    # centred there, x fastest
    mc = fx.ligand_center(lig)
    ax = (np.arange(41) - 20) * 0.5
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    bowl = 0.01 * (x * x + y * y + z * z) - 0.5
    with open(path("bias.map"), "w") as f:
        f.write("GRID_PARAMETER_FILE chip.gpf\nGRID_DATA_FILE chip.fld\n"
                "MACROMOLECULE rec.pdbqt\nSPACING 0.5\nNELEMENTS 40 40 40\n"
                f"CENTER {mc[0]:.3f} {mc[1]:.3f} {mc[2]:.3f}\n")
        f.write("\n".join(f"{v:.4f}" for v in
                          bowl.transpose(2, 1, 0).ravel()) + "\n")
    calls = []
    real_general = cli.DockingEngine._dock_general

    def spy(self, *a, **kw):
        calls.append(1)
        return real_general(self, *a, **kw)

    common = ["-r", path("rec.pdb"), "-l", path("one.sdf"), "--cnn_scoring",
              "none", "--exhaustiveness", str(EXHAUSTIVENESS),
              "--num_mc_steps", str(cli_steps), "--seed", str(seed), "-q"]
    jobs = {"dkoes_scoring": ["--autobox_ligand", path("one.sdf"),
                              "--scoring", "dkoes_scoring"],
            "user_grid": ["--user_grid", path("bias.map")]}
    walls = {}
    try:
        cli.DockingEngine._dock_general = spy
        for name, flags in jobs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(common + flags + ["-o", path(f"{name}.sdf"),
                                            "--log", path(f"{name}.log")])
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            check(rc == 0, f"cli.main {name}: rc {rc}")
            with open(path(f"{name}.sdf")) as f:
                text = f.read()
            tags = [float(v) for v in re.findall(
                r">  <minimizedAffinity>\n(\S+)", text)]
            check(text.count("$$$$") == len(tags) >= 1
                  and np.isfinite(tags).all(), f"cli.main {name}: poses")
            if name == "user_grid":
                # the map's box: 41 points 0.5 A apart from centre + 0.25
                ulo, uhi = mc + 0.25 - 10.25, mc + 0.25 + 10.25
                for blk in text.split("$$$$\n")[:len(tags)]:
                    lines = blk.splitlines()
                    na = int(lines[3][:3])
                    atoms = [ln.split() for ln in lines[4:4 + na]]
                    xyz = np.array([[float(v) for v in a[:3]] for a in atoms
                                    if a[3] != "H"])
                    check(bool(((xyz >= ulo - 1e-2)
                                & (xyz <= uhi + 1e-2)).all()),
                          "a user-grid pose outside the map's box")
            walls[name] = (walls[name], len(tags), min(tags))
    finally:
        cli.DockingEngine._dock_general = real_general
    check(len(calls) == len(jobs), f"cli.main took the general path "
          f"{len(calls)} times for {len(jobs)} jobs")
    print("[8] cli.main on the general path, 1 ligand x "
          f"{EXHAUSTIVENESS} chains, {cli_steps} steps: " + "; ".join(
              f"--{k} rc 0 in {w:.2f} s, {n} poses, best {b:.3f}"
              for k, (w, n, b) in walls.items())
          + " (the user-grid job in the map's box)", flush=True)

    # item 16 on the card: the fused route against the general path
    fused = DockingEngine(DockSettings(**base))
    fused.dock_batch(rec, ligs, center, size, seed=seed)         # warm
    means = {"fused": [], "general": [float(np.mean(
        [r[0].energy for r in results]))]}
    fwall, gwall = [], [wall]
    for i in range(seeds):
        t0 = time.perf_counter()
        res = fused.dock_batch(rec, ligs, center, size, seed=seed + i)
        torch.cuda.synchronize()
        fwall.append(time.perf_counter() - t0)
        means["fused"].append(float(np.mean([r[0].energy for r in res])))
        if i:
            t0 = time.perf_counter()
            res = gen.dock_batch(rec, ligs, center, size, seed=seed + i)
            torch.cuda.synchronize()
            gwall.append(time.perf_counter() - t0)
            means["general"].append(float(np.mean(
                [r[0].energy for r in res])))
    fm, gm = np.mean(means["fused"]), np.mean(means["general"])
    spread = max(np.ptp(means["fused"]), np.ptp(means["general"]))
    bar = max(spread, 0.25)
    print(f"[8] quality (ROADMAP item 16) on that job, seeds {seed}-"
          f"{seed + seeds - 1}: mean best fused {fm:.3f} "
          f"{[round(v, 3) for v in means['fused']]} in "
          f"{np.mean(fwall):.2f} s a dock, general {gm:.3f} "
          f"{[round(v, 3) for v in means['general']]} in "
          f"{np.mean(gwall):.2f} s a dock; gap fused - general "
          f"{fm - gm:+.3f} kcal/mol against the bar max(seed spread, 0.25) "
          f"= {bar:.3f} (scripts/quality_gate.py): "
          f"{'within' if abs(fm - gm) <= bar else 'OUTSIDE'} the bar "
          "(reported, not a check)", flush=True)
    return dict(populate_s=pop[0], dock_s=wall, cli=walls, fused=means[
        "fused"], general=means["general"], bar=bar)


def phase_flex(seed, steps, cli_steps):
    """[9] Flexible side chains, covalent ligands and --outputmin on the
    card (the general path: every such job leaves the fused route).

    [9a] dock_batch at full width: 16 copies of the ligand with the
    residues that --flexdist 3.5 selects in the seed's receptor with real
    residues (_fixtures.flex_receptor), extracted, stripped and attached
    as the command line does, x 8 chains in a 20 A box, `steps` MC steps.
    Checks every pose: finite and in the box, the inflex anchors (CA, C)
    at their input coordinates within 1e-4 A, every bond inside a flex
    residue at its input length within 1e-3 A, and the energy and
    intramolecular energy the flex-aware exact_split of its conf
    recomputed on the CPU within 1e-3 kcal/mol, plus 0.005 per atom pair
    within 2e-3 A^2 of the cutoff as in [5] and [8]: the pair terms stop
    at the cutoff, so a pair there counts on one device and not the other
    (one O-C pair at 8 A is 3.16e-3 kcal/mol of gauss2).

    [9b] cli.main jobs, 1 ligand x 8 chains, `cli_steps` steps: --flexdist
    with --out_flex and --full_flex_output, --flexres on the same
    residues, --flex on a PDBQT written from the fixture, a covalent job
    onto the fixture's CYS SG, --minimize --outputmin 4 (in a scratch
    working directory: minout.sdf goes there) and --no_lig --score_only."""
    import re
    import tempfile

    import torch

    from gnina_tpu_torch import _fixtures as fx
    from gnina_tpu_torch import cli
    from gnina_tpu_torch.chem import covalent, flexinfo, ingest
    from gnina_tpu_torch.chem.ingest import box_from_center_size
    from gnina_tpu_torch.chem.tree_build import attach_flex
    from gnina_tpu_torch.constants import IS_HYDROGEN
    from gnina_tpu_torch.docking import DockingEngine, DockSettings, \
        exact_split
    from gnina_tpu_torch.ops import fused_dock as fd
    from gnina_tpu_torch.ops.energy import Box
    from gnina_tpu_torch.types import Conf, pad_ligand, pad_receptor

    tmp = tempfile.mkdtemp(prefix="chip_smoke_flex_")
    path = lambda name: os.path.join(tmp, name)
    lig = fx.ligand()
    rec_text = fx.flex_receptor_pdb_text(lig, seed)
    with open(path("rec.pdb"), "w") as f:
        f.write(rec_text)
    rec = ingest.Receptor.from_file(path("rec.pdb"))
    center, _ = ingest.autobox_ligand(fx.LIGAND_SDF)
    size = np.full(3, 20.0, np.float32)
    lo, hi = box_from_center_size(center, size)
    keys = flexinfo.select_flex_residues(rec, flexdist=3.5,
                                         flexdist_coords=lig.orig_coords)
    check(len(keys) >= 4 and tuple(keys) == fx.FLEXDIST_35,
          f"--flexdist 3.5 selected {keys}, not {fx.FLEXDIST_35}")
    flex = [flexinfo.extract_flex_residue(rec, k) for k in keys]
    rigid = flexinfo.strip_flex_from_receptor(rec, flex)
    cplx = attach_flex(lig, flex)
    names = " ".join(f"{f.resname}{f.key[1]}" for f in flex)
    nf = cplx.movable_atoms - cplx.lig_atoms

    # [9a] dock_batch at full width through the general path
    eng = DockingEngine(DockSettings(cnn_scoring="none", num_mc_steps=steps,
                                     exhaustiveness=EXHAUSTIVENESS))
    check(eng.device.type == "cuda" and not eng._fused_route([cplx]),
          "a flex job on the fused route, or off the card")
    pop, _ = timed_populate(eng)
    results, wall, cnt = counted_dock(fd, eng, rigid, [cplx] * LIGANDS,
                                      center, size, seed=seed)
    del eng._populate_cache
    check(not any(cnt.launches.values()),
          f"the flex dock launched kernels: {cnt.launches}")
    check(len(pop) == 1, "the search grids were not populated once")

    # the checks, on the CPU's copy of the energy code
    ru = lambda x, k: max(-(-x // k) * k, k)
    n, m = ru(cplx.num_atoms, 8), ru(cplx.num_nodes, 4)
    pruned = rigid.pruned(np.asarray(center), np.asarray(size) / 2,
                          margin=eng.sf.cutoff)
    rec_d = pad_receptor(pruned.coords, pruned.types, pruned.charges,
                         ru(len(pruned.types), 128), device="cpu")
    lig_d = pad_ligand(cplx, n, m, ru(len(cplx.pairs), 32), device="cpu")
    efn = eng._make_efn(int(cplx.layer.max()))
    box = Box(lo=torch.as_tensor(lo), hi=torch.as_tensor(hi))
    orig = cplx.orig_coords
    inflex = np.arange(cplx.movable_atoms, cplx.num_atoms)
    bonds, off = [], cplx.movable_atoms
    for (_key, _name, start, end, fr) in cplx.flex_meta:
        # the atom pairs bonded inside one flex residue (its movable atoms
        # and its inflex anchors, which attach_flex appends in order)
        idx = np.r_[start:end, off:off + len(fr.inflex_types)]
        off += len(fr.inflex_types)
        d = np.linalg.norm(orig[idx][:, None] - orig[idx][None], axis=-1)
        bonds += [(idx[a], idx[b])
                  for a, b in zip(*np.nonzero(np.triu(d < 2.0, 1)))]
    bonds = np.array(bonds)
    d0 = np.linalg.norm(orig[bonds[:, 0]] - orig[bonds[:, 1]], axis=-1)
    heavy = cplx.movable_atoms > np.arange(cplx.num_atoms)
    heavy &= ~IS_HYDROGEN[cplx.types]
    rc = np.asarray(pruned.coords, np.float64)
    cut2 = eng.sf.cutoff ** 2
    pairs = np.concatenate([np.asarray(cplx.pairs).reshape(-1, 2),
                            np.asarray(cplx.other_pairs).reshape(-1, 2)])
    worst = dict(anchor=0.0, bond=0.0, energy=0.0, intramol=0.0)
    n_poses, n_band, worst_band = 0, 0, 0.0
    for res in results:
        check(bool(res), "a flex ligand without poses")
        tors = np.zeros((len(res), m - 1), np.float32)
        for i, p in enumerate(res):
            tors[i, :len(p.conf_torsions)] = p.conf_torsions
        conf = Conf(*[torch.as_tensor(np.asarray(x, np.float32))
                      for x in ([p.conf_position for p in res],
                                [p.conf_orientation for p in res], tors)])
        with torch.no_grad():
            inter, intra = exact_split(efn, lig_d, rec_d, conf, box, 1e3,
                                       [1000.0] * 3)
        e_cpu = eng._conf_independent(cplx, inter.numpy())
        for i, p in enumerate(res):
            c = np.asarray(p.coords, np.float64)
            check(bool(np.isfinite(c).all()) and np.isfinite(p.energy)
                  and np.isfinite(p.intramol), "a non-finite flex pose")
            check(bool(((c[heavy] >= lo - 1e-3)
                        & (c[heavy] <= hi + 1e-3)).all()),
                  "a flex pose outside the box")
            worst["anchor"] = max(worst["anchor"],
                                  float(np.abs(c[inflex] - orig[inflex]).max()))
            d = np.linalg.norm(c[bonds[:, 0]] - c[bonds[:, 1]], axis=-1)
            worst["bond"] = max(worst["bond"], float(np.abs(d - d0).max()))
            # the pairs at the cutoff: movable heavy atoms (clamped into
            # the box, as the inter energy takes them) with the receptor,
            # and the intra and other pairs
            h = np.clip(c[heavy], lo, hi)
            d2 = np.concatenate([
                ((h[:, None] - rc[None]) ** 2).sum(-1).ravel(),
                ((c[pairs[:, 0]] - c[pairs[:, 1]]) ** 2).sum(-1)])
            band = int((np.abs(d2 - cut2) < 2e-3).sum())
            de = max(abs(p.energy - float(e_cpu[i])),
                     abs(p.intramol - float(intra[i])))
            check(de <= 1e-3 + 0.005 * band,
                  f"pose energies vs the CPU's exact_split: energy "
                  f"{p.energy} / {float(e_cpu[i])}, intramol {p.intramol} "
                  f"/ {float(intra[i])} ({band} pairs at the cutoff)")
            if band:
                n_band += 1
                worst_band = max(worst_band, de)
            else:
                worst["energy"] = max(worst["energy"],
                                      abs(p.energy - float(e_cpu[i])))
                worst["intramol"] = max(worst["intramol"],
                                        abs(p.intramol - float(intra[i])))
        n_poses += len(res)
    check(worst["anchor"] <= 1e-4, f"an inflex anchor moved {worst}")
    check(worst["bond"] <= 1e-3, f"a flex bond changed length {worst}")
    print(f"[9a] flex dock_batch (general path), {LIGANDS} ligands x "
          f"{EXHAUSTIVENESS} chains, {steps} steps, 20 A box: residues "
          f"{names} ({nf} flex atoms, {len(inflex)} inflex anchors), "
          f"{cplx.num_torsions} torsions ({lig.num_torsions} ligand + "
          f"{cplx.num_torsions - lig.num_torsions} flex), "
          f"{len(cplx.other_pairs)} other pairs; populate {pop[0]:.2f} s, "
          f"dock {wall:.2f} s wall with the populate "
          f"({(wall - pop[0]) / steps * 1e3:.1f} ms a step); {n_poses} "
          f"poses, finite and in the box, anchors within "
          f"{worst['anchor']:.1e} A, {len(bonds)} flex bonds within "
          f"{worst['bond']:.1e} A, energy and intramol the CPU's "
          f"exact_split within {worst['energy']:.1e} / "
          f"{worst['intramol']:.1e} kcal/mol ({worst_band:.1e} on the "
          f"{n_band} poses with a pair within 2e-3 A^2 of the cutoff); best "
          f"{min(r[0].energy for r in results):.3f} kcal/mol; no kernel "
          f"launched | {smi_line()}", flush=True)

    # [9b] the command line
    with open(fx.LIGAND_SDF) as f:
        first = f.read().split("$$$$\n")[0] + "$$$$\n"
    with open(path("one.sdf"), "w") as f:
        f.write(first)
    with open(path("warhead.sdf"), "w") as f:
        f.write(fx.ACRYLAMIDE_SDF)
    with open(path("flex.pdbqt"), "w") as f:
        f.write(fx.flex_pdbqt_text(rec, keys))
    flex_set = {(k[0], k[1]) for k in keys}
    with open(path("rigid.pdb"), "w") as f:   # the --flex job's receptor
        f.write("".join(
            ln + "\n" for ln in rec_text.splitlines()
            if not (ln.startswith("ATOM") and (ln[21], int(ln[22:26]))
                    in flex_set and ln[12:16].strip()
                    not in flexinfo.BACKBONE_RIGID)))
    spec = ",".join(f"{c}:{r}" for c, r in sorted(flex_set))
    cys = next(r for n_, r, _ in fx.FLEX_RESIDUES if n_ == "CYS")
    box_args = ["--center_x", f"{center[0]:.4f}", "--center_y",
                f"{center[1]:.4f}", "--center_z", f"{center[2]:.4f}",
                "--size_x", "20", "--size_y", "20", "--size_z", "20"]
    common = ["--cnn_scoring", "none", "--exhaustiveness",
              str(EXHAUSTIVENESS), "--num_mc_steps", str(cli_steps),
              "--seed", str(seed), "-q"]
    lig1 = ["-r", path("rec.pdb"), "-l", path("one.sdf")]
    jobs = {
        "flexdist": lig1 + box_args + [
            "--flexdist", "3.5", "--flexdist_ligand", path("one.sdf"),
            "--out_flex", path("flexdist.pdb"), "--full_flex_output"],
        "flexres": lig1 + box_args + ["--flexres", spec],
        "flex": ["-r", path("rigid.pdb"), "-l", path("one.sdf"),
                 "--flex", path("flex.pdbqt")] + box_args,
        "covalent": ["-r", path("rec.pdb"), "-l", path("warhead.sdf"),
                     "--covalent_rec_atom", f"A:{cys}:SG",
                     "--covalent_lig_atom_pattern", "[$(C=C)]"] + box_args,
        "outputmin": lig1 + ["--flexres", spec, "--minimize",
                             "--outputmin", "4"],
        "no_lig": ["-r", path("rec.pdb"), "--no_lig", "--flexres", spec,
                   "--score_only"],
    }
    walls, notes = {}, {}
    cwd = os.getcwd()
    try:
        os.chdir(tmp)       # --outputmin writes minout.sdf in the cwd
        for name, flags in jobs.items():
            out = [] if name == "no_lig" else ["-o", path(f"{name}.sdf")]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = cli.main(common + flags + out
                          + ["--log", path(f"{name}.log")])
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            check(rc == 0, f"cli.main {name}: rc {rc}")
    finally:
        os.chdir(cwd)

    def read(name):
        with open(path(name)) as f:
            return f.read()

    def sdf_poses(name):
        text = read(f"{name}.sdf")
        tags = [float(v) for v in re.findall(
            r">  <minimizedAffinity>\n(\S+)", text)]
        check(text.count("$$$$") == len(tags) >= 1
              and np.isfinite(tags).all(), f"cli.main {name}: poses")
        blocks = []
        for blk in text.split("$$$$\n")[:len(tags)]:
            lines = blk.splitlines()
            na = int(lines[3][:3])
            blocks.append(np.array([[float(v) for v in ln.split()[:3]]
                                    for ln in lines[4:4 + na]]))
        return tags, blocks

    def flex_line(name):
        hit = re.findall(r"Flexible residues: (.*)", read(f"{name}.log"))
        check(len(hit) == 1, f"cli.main {name}: no flexible residues")
        return set(hit[0].split())

    want = {f"{c}:{r}" for c, r in flex_set}
    for name in ("flexdist", "flexres", "flex"):
        check(flex_line(name) == want, f"cli.main {name}: residues "
              f"{flex_line(name)}, not {want}")
        tags, _ = sdf_poses(name)
        notes[name] = f"{len(tags)} poses, best {min(tags):.3f}"
    # --out_flex --full_flex_output: a MODEL a pose, each the stripped
    # receptor's heavy atoms and the flex atoms
    pdb = read("flexdist.pdb")
    models = pdb.split("ENDMDL\n")[:-1]
    n_rigid = sum(1 for a in rigid.mol.atoms if a.anum != 1)
    check(len(models) == len(sdf_poses("flexdist")[0]) and all(
        sum(ln.startswith("ATOM") for ln in blk.splitlines())
        == n_rigid + nf for blk in models),
        f"--out_flex: {len(models)} models, not one a pose of "
        f"{n_rigid} + {nf} atoms")
    notes["flexdist"] += (f", --out_flex {len(models)} MODELs of "
                          f"{n_rigid} + {nf} atoms")
    # covalent: the attachment atom where build_covalent_complex placed it
    cinfo = covalent.CovInfo(covalent.CovOptions(
        covalent_rec_atom=f"A:{cys}:SG",
        covalent_lig_atom_pattern="[$(C=C)]"), log=lambda *a: None)
    mol = next(ingest.iter_molecules(path("warhead.sdf")))
    _, placed = covalent.build_covalent_complex(rec, mol, cinfo)
    tags, blocks = sdf_poses("covalent")
    moved = max(float(np.abs(b[0] - placed[0].orig_coords[0]).max())
                for b in blocks)
    check(moved <= 1e-3, f"the covalent attachment atom moved {moved} A")
    notes["covalent"] = (f"{len(tags)} poses, best {min(tags):.3f}, "
                         f"attachment atom within {moved:.1e} A")
    # --outputmin 4: 5 frames a step, each step starting where the last
    # ended, the last frame the minimized pose
    frames = [np.array([[float(v) for v in ln.split()[:3]]
                        for ln in blk.splitlines()[4:4 + int(
                            blk.splitlines()[3][:3])]])
              for blk in read("minout.sdf").split("$$$$\n")[:-1]]
    f_ = np.array(frames)
    check(len(f_) >= 5 and len(f_) % 5 == 0 and np.isfinite(f_).all(),
          f"--outputmin 4 wrote {len(f_)} frames")
    seam = float(np.abs(f_[4:-1:5] - f_[5::5]).max()) if len(f_) > 5 else 0
    _, mblocks = sdf_poses("outputmin")
    last = float(np.abs(f_[-1] - mblocks[0]).max())
    # a step's frames rotate by quaternion_to_rotvec(q1 q0*), whose arccos
    # in float32 drops rotations under about 1e-3 rad (as in the JAX
    # package): a late, small step's last frame may sit a few 1e-3 A from
    # the next step's first
    check(seam <= 1e-2 and last <= 1e-2,
          f"--outputmin frames: seams {seam}, last frame vs the minimized "
          f"pose {last}")
    notes["outputmin"] = (f"{len(f_)} frames ({len(f_) // 5} steps x 5), "
                          f"seams within {seam:.1e} A, last frame within "
                          f"{last:.1e} A of the minimized pose")
    aff = re.findall(r"Affinity: (\S+)", read("no_lig.log"))
    check(len(aff) == 1 and np.isfinite(float(aff[0])),
          f"--no_lig --score_only: {aff}")
    notes["no_lig"] = f"affinity {float(aff[0]):.3f}"
    print("[9b] cli.main flex and covalent jobs, 1 ligand x "
          f"{EXHAUSTIVENESS} chains, {cli_steps} steps: " + "; ".join(
              f"{k} rc 0 in {walls[k]:.2f} s, {notes[k]}" for k in jobs),
          flush=True)
    return dict(dock_s=wall, populate_s=pop[0], cli=walls)


def phase_cnn(seed, steps, cli_steps):
    """[10] The CNN inside the search on the card (the general path: every
    CNN-in-the-loop job with a scorer leaves the fused route; no kernel).

    [10a] dock_batch at full width under cnn_scoring='refinement' (CNN
    Metropolis, the saved poses refined on the CNN objective, the CNNscore
    sort): 16 copies of the ligand x 8 chains in the 20 A box of the seed's
    synthetic receptor, the default ensemble (dense_1_3, dense_1_3_PT_KD_3,
    crossdock_default2018_KD_4; 28 channels on 48^3), `steps` MC steps.
    Checks: _dock_general taken and no kernel launched; every pose finite,
    its heavy atoms in the box, its energy the engine's exact rescore of its
    conf within 1e-3 kcal/mol, its CNNscore and CNNaffinity
    score_poses_multi's on its coordinates within 1e-3, the poses sorted by
    CNNscore; on 2 poses the objective's value_p and deriv_p on the card
    equal the same code on the CPU (value 1e-4 relative, gradient 1e-3 of
    its largest component); minimize under refinement (at most 100
    iterations a stage) from one ligand's input pose ends with a CNN
    objective no higher than at its start (same fixed centre, +1e-4).

    [10b] cli.main jobs, 1 ligand x 8 chains, `cli_steps` MC steps:
    --cnn_scoring metrorescore, metrorefine, all (2 steps: a CNN BFGS for
    every lane each step), --minimize --cnn_scoring refinement (at most
    100 iterations a stage), refinement
    with --cnn_mix_emp_force --cnn_mix_emp_energy --cnn_empirical_weight
    0.5, and --score_only --cnn_outputxyz --cnn_outputdx
    --cnn_gradient_check --cnn_verbose into a scratch directory (one .dx
    file a channel of the first model, n^3 values each; one finite .xyz row
    an atom; the gradient-check lines finite).  The gradient check's
    central difference at the command line's step, 1e-2 A, is printed
    beside its max relative error (not a check: the density's piecewise
    tail puts ~1e-3 of truncation error into each component, larger than
    2e-2 of the small ones); the analytic atom gradient is held instead to
    a central difference at 1e-3 A, within 2e-2 of its largest
    component."""
    import io
    import re
    import tempfile

    import torch

    from gnina_tpu_torch import _fixtures as fx
    from gnina_tpu_torch import cli
    from gnina_tpu_torch.chem.ingest import box_from_center_size
    from gnina_tpu_torch.constants import IS_HYDROGEN
    from gnina_tpu_torch.docking import DockingEngine, DockSettings, \
        exact_split
    from gnina_tpu_torch.models import debug_out
    from gnina_tpu_torch.models.scorer import CNNScorer
    from gnina_tpu_torch.ops import fused_dock as fd
    from gnina_tpu_torch.ops.energy import Box, lane_ligands
    from gnina_tpu_torch.types import Conf, initial_conf, pad_ligand, \
        pad_receptor

    t_phase = time.perf_counter()
    rec, lig, center, size = fx.system(seed=seed, box=20.0)
    ligs = [lig] * LIGANDS
    lo, hi = box_from_center_size(center, size)
    scorer = CNNScorer()
    check([m_.name for m_ in scorer.models]
          == ["dense_1_3", "dense_1_3_PT_KD_3", "crossdock_default2018_KD_4"]
          and all(m_.grid_points == 48 and m_.num_channels == 28
                  for m_ in scorer.models), "not the default ensemble")
    settings = DockSettings(cnn_scoring="refinement", num_mc_steps=steps,
                            exhaustiveness=EXHAUSTIVENESS)
    eng = DockingEngine(settings, cnn_scorer=scorer)
    check(eng.device.type == "cuda" and not eng._fused_route(ligs),
          "a CNN-in-the-loop job on the fused route, or off the card")

    # [10a] the dock, its parts timed with the card synchronised
    spent = {"build": 0.0, "stages": 0.0, "rescore": 0.0}
    calls = []

    def timed_part(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t_ = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name] += time.perf_counter() - t_
            return out
        return run

    real_general = eng._dock_general
    eng._dock_general = lambda *a, **kw: calls.append(1) or real_general(
        *a, **kw)
    eng._build_cnn_objective = timed_part("build", eng._build_cnn_objective)
    eng._stages = timed_part("stages", eng._stages)
    scorer.score_poses_multi = timed_part("rescore",
                                          scorer.score_poses_multi)
    pop, _ = timed_populate(eng)
    torch.cuda.reset_peak_memory_stats()
    results, wall, cnt = counted_dock(fd, eng, rec, ligs, center, size,
                                      seed=seed)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for name in ("_dock_general", "_build_cnn_objective", "_stages",
                 "_populate_cache"):
        delattr(eng, name)
    del scorer.score_poses_multi
    check(calls == [1], "the refinement dock did not take _dock_general")
    check(not any(cnt.launches.values()),
          f"the CNN-in-the-loop dock launched kernels: {cnt.launches}")
    check(len(pop) == 1, "the search grids were not populated once")
    mc_s = wall - pop[0] - spent["build"] - spent["stages"] - spent["rescore"]

    # every pose: finite, in the box, the engine's exact rescore, the
    # ensemble's scores on its coordinates, sorted by CNNscore
    dev = eng.device
    ru = lambda x, k: max(-(-x // k) * k, k)
    n, m = ru(lig.num_atoms, 8), ru(lig.num_nodes, 4)
    pruned = rec.pruned(np.asarray(center), np.asarray(size) / 2,
                        margin=eng.sf.cutoff)
    rec_d = pad_receptor(pruned.coords, pruned.types, pruned.charges,
                         ru(len(pruned.types), 128), device=dev)
    lig_d = pad_ligand(lig, n, m, ru(len(lig.pairs), 32), device=dev)
    layers = ru(int(lig.layer.max()), 4)
    efn = eng._make_efn(layers)
    box = Box(lo=torch.as_tensor(lo, device=dev),
              hi=torch.as_tensor(hi, device=dev))
    heavy = ~IS_HYDROGEN[lig.types]
    worst = dict(energy=0.0, score=0.0, affinity=0.0)
    n_poses = 0
    for res in results:
        check(bool(res), "a ligand without poses")
        sc_ = [p.cnnscore for p in res]
        check(sc_ == sorted(sc_, reverse=True), "poses not sorted by CNNscore")
        tors = np.zeros((len(res), m - 1), np.float32)
        for i, p in enumerate(res):
            tors[i, :len(p.conf_torsions)] = p.conf_torsions
        conf = Conf(*[torch.as_tensor(np.asarray(x, np.float32), device=dev)
                      for x in ([p.conf_position for p in res],
                                [p.conf_orientation for p in res], tors)])
        with torch.no_grad():
            inter, _ = exact_split(efn, lig_d, rec_d, conf, box, 1e3,
                                   [1000.0] * 3)
        e_own = eng._conf_independent(lig, inter.cpu().numpy())
        s_, a_, _l, _v = scorer.score_poses_multi(
            rec, [(lig, np.stack([p.coords for p in res]))])[0]
        for i, p in enumerate(res):
            c = np.asarray(p.coords, np.float64)
            check(bool(np.isfinite(c).all()) and np.isfinite(p.energy)
                  and np.isfinite(p.cnnscore), "a non-finite pose")
            check(bool(((c[heavy] >= lo - 1e-3)
                        & (c[heavy] <= hi + 1e-3)).all()),
                  "a pose outside the box")
            worst["energy"] = max(worst["energy"],
                                  abs(p.energy - float(e_own[i])))
            worst["score"] = max(worst["score"], abs(p.cnnscore - s_[i]))
            worst["affinity"] = max(worst["affinity"],
                                    abs(p.cnnaffinity - a_[i]))
        n_poses += len(res)
    check(max(worst.values()) <= 1e-3, f"poses vs their rescores: {worst}")

    # the objective on the card against the same code on the CPU, 2 poses
    cpu = DockingEngine(settings, cnn_scorer=CNNScorer(device="cpu"),
                        device="cpu")
    two = results[0][:2]
    vals = {}
    for e_, d_ in ((eng, dev), (cpu, torch.device("cpu"))):
        b_ = Box(lo=torch.as_tensor(lo, device=d_),
                 hi=torch.as_tensor(hi, device=d_))
        obj = e_._build_cnn_objective(rec, b_, layers)
        lig2 = lane_ligands([pad_ligand(lig, n, m, ru(len(lig.pairs), 32),
                                        device=d_)] * 2,
                            torch.zeros(2, dtype=torch.long, device=d_))
        t2 = np.zeros((2, m - 1), np.float32)
        for i, p in enumerate(two):
            t2[i, :len(p.conf_torsions)] = p.conf_torsions
        c2 = Conf(*[torch.as_tensor(np.asarray(x, np.float32), device=d_)
                    for x in ([p.conf_position for p in two],
                              [p.conf_orientation for p in two], t2)])
        with torch.no_grad():
            cen = obj["center_of"](lig2, c2)
            g_ = obj["prep"](cen)
            v_ = obj["value_p"](g_, lig2, c2, cen, 10.0)
        _, gr = obj["deriv_p"](g_, lig2, c2, cen, 10.0)
        vals[d_.type] = (v_.cpu().double(), gr.cpu().double())
    v_err = float(((vals["cuda"][0] - vals["cpu"][0]).abs()
                   / vals["cpu"][0].abs()).max())
    g_scale = float(vals["cpu"][1].abs().max())
    g_err = max_err(vals["cuda"][1], vals["cpu"][1]) / g_scale
    check(v_err <= 1e-4 and g_err <= 1e-3,
          f"the CNN objective on the card vs the CPU: value {v_err:.2e} "
          f"relative, gradient {g_err:.2e} of its largest component")

    # minimize under refinement from the input pose, its objective at the
    # fixed centre before and after
    meng = DockingEngine(dataclasses.replace(settings, minimize_iters=100),
                         cnn_scorer=scorer)
    torch.cuda.synchronize()
    t_ = time.perf_counter()
    mres = meng.minimize(rec, lig)
    torch.cuda.synchronize()
    min_s = time.perf_counter() - t_
    mc_, msz = meng._movable_box(lig, None, None)
    ml_d, _mr, mbox, mlayers = meng._prepare(rec, lig, mc_, msz)
    mobj = meng._build_cnn_objective(rec, mbox, mlayers)
    ml1 = lane_ligands([ml_d], torch.zeros(1, dtype=torch.long, device=dev))
    c0 = Conf(*[x[None] for x in initial_conf(lig, ml_d.num_torsion_slots,
                                              device=dev)])
    t1 = np.zeros((1, ml_d.num_torsion_slots), np.float32)
    t1[0, :len(mres.conf_torsions)] = mres.conf_torsions
    c1 = Conf(*[torch.as_tensor(np.asarray(x, np.float32), device=dev)
                for x in ([mres.conf_position], [mres.conf_orientation], t1)])
    with torch.no_grad():
        mcen = mobj["center_of"](ml1, c0)
        mg = mobj["prep"](mcen)
        v0, v1 = (float(mobj["value_p"](mg, ml1, c_, mcen, 10.0)[0])
                  for c_ in (c0, c1))
    check(np.isfinite(mres.energy) and v1 <= v0 + 1e-4,
          f"minimize under refinement: objective {v0} -> {v1}")
    print(f"[10a] cnn_scoring='refinement' dock_batch (general path), "
          f"{LIGANDS} ligands x {EXHAUSTIVENESS} chains, {steps} steps, 20 A "
          f"box, default ensemble (3 models, 28 channels x 48^3): "
          f"{wall:.2f} s wall: populate {pop[0]:.2f} s, MC "
          f"{mc_s:.2f} s ({mc_s / steps * 1e3:.1f} ms a step, CNN "
          f"Metropolis included), CNN refinement of the saved poses "
          f"{spent['stages']:.2f} s, objective set-up {spent['build']:.2f} "
          f"s, CNN rescore {spent['rescore']:.2f} s; peak memory "
          f"{peak_gb:.2f} GiB; {n_poses} poses, finite, in the box, sorted "
          f"by CNNscore, energies the engine's exact rescore within "
          f"{worst['energy']:.1e} kcal/mol, CNNscore / CNNaffinity the "
          f"ensemble's within {worst['score']:.1e} / "
          f"{worst['affinity']:.1e}; best energy "
          f"{min(p.energy for r_ in results for p in r_):.3f} kcal/mol, best "
          f"CNNscore {max(r_[0].cnnscore for r_ in results):.4f}; objective "
          f"card vs CPU on 2 poses: value {v_err:.1e} relative, gradient "
          f"{g_err:.1e} of its largest; minimize under refinement "
          f"{min_s:.2f} s, objective {v0:.4f} -> {v1:.4f}, energy "
          f"{mres.energy:.3f}; no kernel launched | {smi_line()}",
          flush=True)
    t_10a = time.perf_counter() - t_phase

    # [10b] the command line
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cnn_")
    path = lambda name: os.path.join(tmp, name)
    with open(path("rec.pdb"), "w") as f:
        f.write(fx.receptor_pdb_text(fx.ligand_center(lig), seed))
    with open(fx.LIGAND_SDF) as f:
        first = f.read().split("$$$$\n")[0] + "$$$$\n"
    with open(path("one.sdf"), "w") as f:
        f.write(first)
    common = ["-r", path("rec.pdb"), "-l", path("one.sdf"), "--seed",
              str(seed), "-q"]
    dock = ["--autobox_ligand", path("one.sdf"), "--exhaustiveness",
            str(EXHAUSTIVENESS), "--num_mc_steps", str(cli_steps)]
    jobs = {
        "metrorescore": dock + ["--cnn_scoring", "metrorescore"],
        "metrorefine": dock + ["--cnn_scoring", "metrorefine"],
        "all": dock[:-1] + ["2", "--cnn_scoring", "all"],
        "minimize": ["--minimize", "--cnn_scoring", "refinement",
                     "--minimize_iters", "100"],
        "mix": dock + ["--cnn_scoring", "refinement", "--cnn_mix_emp_force",
                       "--cnn_mix_emp_energy", "--cnn_empirical_weight",
                       "0.5"],
        "debug": ["--score_only", "--cnn_outputxyz", "--cnn_outputdx",
                  "--cnn_gradient_check", "--cnn_verbose", "--cnn_xyzprefix",
                  path("dbg")],
    }
    walls, notes = {}, {}
    for name, flags in jobs.items():
        torch.cuda.synchronize()
        t_ = time.perf_counter()
        rc = cli.main(common + flags + ["-o", path(f"{name}.sdf"), "--log",
                                        path(f"{name}.log")])
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t_
        check(rc == 0, f"cli.main {name}: rc {rc}")
        with open(path(f"{name}.sdf")) as f:
            text = f.read()
        aff = [float(v) for v in re.findall(
            r">  <minimizedAffinity>\n(\S+)", text)]
        cnn = [float(v) for v in re.findall(r">  <CNNscore>\n(\S+)", text)]
        check(text.count("$$$$") == len(aff) == len(cnn) >= 1
              and np.isfinite(aff).all() and np.isfinite(cnn).all(),
              f"cli.main {name}: poses without finite minimizedAffinity and "
              "CNNscore tags")
        notes[name] = (f"{len(aff)} poses, best affinity {min(aff):.3f}, "
                       f"top CNNscore {cnn[0]:.4f}")
    # the debug outputs
    m0 = scorer.models[0]
    nch, npts = m0.num_channels, m0.grid_points
    dx = sorted(f for f in os.listdir(tmp) if f.startswith("dbg_grad_")
                and f.endswith(".dx"))
    check(len(dx) == nch, f"{len(dx)} .dx files, not {nch}")
    for f in dx:
        with open(path(f)) as fh:
            body = fh.read().split("data follows\n", 1)[1]
        check(len(body.split()) == npts ** 3, f"{f}: not {npts}^3 values")
    rows = []
    for f in ("dbg_lig.xyz", "dbg_rec.xyz"):
        with open(path(f)) as fh:
            lines = fh.read().splitlines()
        v = np.array([[float(x) for x in ln.split()[1:]] for ln in lines[2:]])
        check(int(lines[0]) == len(v) and v.shape[1:] == (6,)
              and np.isfinite(v).all(), f"{f}: not one finite row an atom")
        rows.append(len(v))
    check(rows[0] == lig.num_atoms, "the ligand's .xyz: not one row an atom")
    with open(path("debug.log")) as fh:
        log_text = fh.read()
    pairs = np.array(re.findall(
        r"analytic (\S+) numeric (\S+) rel", log_text), float)
    rel = re.findall(r"gradient_check max relative error: (\S+)", log_text)
    check(pairs.shape == (9, 2) and np.isfinite(pairs).all() and rel,
          "the gradient check's log lines")
    # the analytic atom gradient against a central difference at 1e-3 A
    coords = np.asarray(lig.orig_coords, np.float32)
    cen = coords.mean(axis=0)
    rc_, rt_, rm_ = scorer._receptor_arrays(
        cli.ingest.Receptor.from_file(path("rec.pdb")), cen[None])
    fd_errs = {}
    for eps in (1e-3, 3e-3):
        fine = io.StringIO()
        debug_out.gradient_check(scorer, rc_, rt_, rm_, lig, coords, cen,
                                 fine, eps=eps)
        fp = np.array(re.findall(r"analytic (\S+) numeric (\S+) rel",
                                 fine.getvalue()), float)
        fd_errs[eps] = float(np.abs(fp[:, 0] - fp[:, 1]).max()
                             / np.abs(fp[:, 0]).max())
    fd_err = fd_errs[1e-3]
    check(fd_err <= 2e-2, f"the CNN atom gradient vs a central difference "
          f"at 1e-3 A: {fd_err:.2e} of its largest component")
    notes["debug"] += (f", {len(dx)} .dx files of {npts}^3, .xyz rows "
                       f"{rows[0]} / {rows[1]}, gradient check at 1e-2 A: "
                       f"max relative error {float(rel[0]):.2e} (max |d| "
                       f"{np.abs(pairs[:, 0] - pairs[:, 1]).max():.2e} of "
                       f"{np.abs(pairs[:, 0]).max():.2e}); at 1e-3 A: "
                       f"{fd_err:.2e} of the largest component (at 3e-3 "
                       f"A: {fd_errs[3e-3]:.2e})")
    print("[10b] cli.main CNN-in-the-loop jobs, 1 ligand x "
          f"{EXHAUSTIVENESS} chains, {cli_steps} steps (all: 2): "
          + "; ".join(f"{k} rc 0 in {walls[k]:.2f} s, {notes[k]}"
                      for k in jobs), flush=True)
    print(f"[10] {t_10a:.1f} s for [10a], "
          f"{time.perf_counter() - t_phase - t_10a:.1f} s for [10b]",
          flush=True)
    return dict(dock_s=wall, cli=walls)


def phase_tools(seed):
    """[11] The tools on the card (gnina_tpu_torch/tools/), on the seed's
    synthetic receptor of [8] (the whole file: the tools take no box) and
    the first TOOLS_LIGANDS records of minout.sdf, every file under a
    temporary directory.

    [11a] gninagrid at full width (the default 23.5 A / 0.5 A grid, 48^3
    points, the default typers' 28 channels) through tools.gninagrid.main:
    the combined .binmap of every ligand, --dx for one ligand, --separate
    --example_grid, -g with --separate (the user grid followed by the 14
    receptor channels), --random_translate 2.  Every file is held to the
    same command on the CPU (--device cpu): the same names, every value
    within 1e-4 (the voxelizer's card-against-CPU bar of [5f]; .dx files
    plus their print's rounding).  Grids per second on the card: main()'s
    wall (files written) and gninagrid.make_grid's alone.

    [11b] gninatyper, tognina and fromgnina: a round trip of the ligands.
    The .gninatypes records are the ligands' heavy atoms (types and float32
    coordinates equal); the .molcache loads back with equal types,
    coordinates and atom counts; fromgnina's SDF has each ligand's atom
    count, its coordinates within 1e-4 A and the element of each type.

    [11c] gninavis with the default three-model ensemble on one ligand,
    atoms and fragments (--frag_bonds 6), on the card.  Two PDBs with a
    finite B-factor per atom; the per-atom scores of atom masking on the
    card held to the same masked rows scored on the CPU for three rows (the
    base pose and two masked atoms; a CPU ensemble pass over every row at
    48^3 is too slow for the script), within twice [5f]'s bar for ensemble
    outputs (a score is a difference of two).  Prints the fragments and
    the ensemble forwards (one per pose chunk of at most 128).

    [11d] the minimisation server in a daemon thread on 127.0.0.1 (a free
    port), on the card, with DockSettings(cnn_scoring="none"), through
    tools.server_client: /status, the receptor upload, one /minimize of
    the ligands, /status again (the count), a /minimize before a receptor
    on a second state (400) and an unknown path (404).  Every returned
    minimizedAffinity equals DockingEngine.minimize on the card for that
    ligand within 1e-4 kcal/mol.  Prints ms per served ligand.

    [11e] --cnn_model: a small TorchScript network made in the phase with
    torch.jit.trace (a 3D convolution, relu, a max pool, a log-softmax pose
    head and an affinity head; metadata resolution 1 A, dimension 12 A),
    scored by cli.main --score_only --cnn_model on one ligand.  The SDF's
    CNNscore and CNNaffinity equal the traced module's own forward on the
    port's grid of the pose the scorer was given, within 1e-5; the job
    rescores through K1 (its counts set to 0 just before, read just
    after)."""
    import re
    import shutil
    import tempfile
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    import torch

    from gnina_tpu_torch import _fixtures as fx
    from gnina_tpu_torch import cli
    from gnina_tpu_torch.chem import ingest, molcache
    from gnina_tpu_torch.chem.sdf import iter_sdf
    from gnina_tpu_torch.constants import IS_HYDROGEN, SminaType, \
        smina_type_to_element_name
    from gnina_tpu_torch.docking import DockingEngine, DockSettings
    from gnina_tpu_torch.models.scorer import CNNScorer
    from gnina_tpu_torch.models.typer import default_lig_typer, \
        default_rec_typer
    from gnina_tpu_torch.ops import fused_dock as fd
    from gnina_tpu_torch.tools import fromgnina, gninagrid, gninatyper, \
        gninavis, server, server_client, tognina

    smi = smi_line()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools_")
    path = lambda *p: os.path.join(tmp, *p)
    n_lig = TOOLS_LIGANDS
    lig0 = fx.ligand()
    with open(path("rec.pdb"), "w") as f:
        f.write(fx.receptor_pdb_text(fx.ligand_center(lig0), seed))
    with open(fx.LIGAND_SDF) as f:
        blocks = f.read().split("$$$$\n")
    with open(path("ligs.sdf"), "w") as f:
        f.write("".join(b + "$$$$\n" for b in blocks[:n_lig]))
    with open(path("one.sdf"), "w") as f:
        f.write(blocks[0] + "$$$$\n")
    rec = ingest.Receptor.from_file(path("rec.pdb"))
    ligs = list(ingest.iter_ligands(path("ligs.sdf")))
    check(len(ligs) == n_lig, "the tools' ligands")
    walls = {}

    def sync_wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # ---- [11a] gninagrid ---------------------------------------------------
    t_a = time.perf_counter()
    npts = 48
    center = np.mean([lg.orig_coords.mean(axis=0) for lg in ligs], axis=0)
    ax = (np.arange(npts) - (npts - 1) / 2) * 0.5
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    gninagrid.write_dx(path("user.dx"),
                       (0.01 * (x * x + y * y + z * z)).astype(np.float32),
                       center, 0.5)
    runs = {"comb": ("ligs.sdf", []), "dx": ("one.sdf", ["--dx"]),
            "sep": ("ligs.sdf", ["--separate", "--example_grid",
                                 path("user.dx")]),
            "gsep": ("ligs.sdf", ["-g", path("user.dx"), "--separate"]),
            "trans": ("ligs.sdf", ["--random_translate", "2", "--seed",
                                   str(seed)])}
    grid_walls = {}
    for where in ("card", "cpu"):
        os.makedirs(path(where))
        for name, (src, flags) in runs.items():
            argv = (["-r", path("rec.pdb"), "-l", path(src), "-o",
                     path(where, name)] + flags
                    + (["--device", "cpu"] if where == "cpu" else []))
            rc, w = sync_wall(lambda: gninagrid.main(argv))
            check(rc == 0, f"gninagrid {name} on the {where}: rc {rc}")
            grid_walls[(where, name)] = w
    card_files = sorted(os.listdir(path("card")))
    check(card_files == sorted(os.listdir(path("cpu"))),
          "gninagrid wrote other files on the card than on the CPU")
    n3 = npts ** 3
    want = ([f"comb_{i}.{npts}.28.binmap" for i in range(n_lig)]
            + [f"sep.{npts}.14.binmap"]
            + [f"sep_{i}.{npts}.14.binmap" for i in range(n_lig)]
            + [f"gsep.{npts}.15.binmap"]
            + [f"gsep_{i}.{npts}.14.binmap" for i in range(n_lig)]
            + [f"trans_{i}.{npts}.28.binmap" for i in range(n_lig)])
    dx_files = [n for n in card_files if n.endswith(".dx")]
    check(sorted(want) == sorted(n for n in card_files
                                 if n.endswith(".binmap")),
          f"gninagrid's binmap names: {card_files}")
    check(len(dx_files) >= 4 and all(n.startswith("dx_0_") for n in dx_files),
          f"gninagrid --dx files: {dx_files}")
    grid_err = dx_err = 0.0
    for n in card_files:
        if n.endswith(".binmap"):
            a = np.fromfile(path("card", n), np.float32)
            b = np.fromfile(path("cpu", n), np.float32)
            check(a.shape == b.shape and a.size % n3 == 0
                  and np.isfinite(a).all(), f"{n}: shape or values")
            grid_err = max(grid_err, float(np.abs(a - b).max()))
        else:
            a, ca, ra = gninagrid.read_dx(path("card", n))
            b, cb, rb = gninagrid.read_dx(path("cpu", n))
            check(a.shape == (npts,) * 3 and np.array_equal(ca, cb)
                  and ra == rb == 0.5, f"{n}: header")
            dx_err = max(dx_err, float(np.abs(a - b).max()))
    # .dx values are printed to 5 decimals: 1e-5 more for their rounding
    check(grid_err <= 1e-4 and dx_err <= 1e-4 + 1e-5,
          f"gninagrid card vs CPU: {grid_err:.2e}, .dx {dx_err:.2e}")
    comb = np.fromfile(path("card", f"comb_0.{npts}.28.binmap"), np.float32)
    trans = np.fromfile(path("card", f"trans_0.{npts}.28.binmap"), np.float32)
    gsep = np.fromfile(path("card", f"gsep.{npts}.15.binmap"), np.float32)
    user = gninagrid.read_dx(path("user.dx"))[0]
    check(comb.reshape(28, -1)[:14].max() > 0.5
          and comb.reshape(28, -1)[14:].max() > 0.5,
          "the combined grid lacks receptor or ligand density")
    check(np.abs(comb - trans).max() > 0.1, "--random_translate moved nothing")
    check(gsep.size == 15 * n3 and np.array_equal(gsep[:n3], user.ravel())
          and gsep[n3:].max() > 0.5,
          "-g --separate: not the user grid followed by the receptor")
    # the voxelizer alone on the card: 8 combined grids, the ligands in turn
    rt, lt = default_rec_typer(), default_lig_typer()
    gninagrid.make_grid(rec.coords, rec.types, ligs[0].orig_coords,
                        ligs[0].types, center, rt, lt, 0.5, 23.5)
    mk_ligs = [ligs[i % n_lig] for i in range(8)]
    _g, mk_wall = sync_wall(lambda: [gninagrid.make_grid(
        rec.coords, rec.types, lg.orig_coords, lg.types,
        lg.orig_coords.mean(axis=0), rt, lt, 0.5, 23.5) for lg in mk_ligs])
    walls["11a"] = time.perf_counter() - t_a
    card_s = sum(v for (w, _n), v in grid_walls.items() if w == "card")
    cpu_s = sum(v for (w, _n), v in grid_walls.items() if w == "cpu")
    print(f"[11a] gninagrid, {npts}^3 x 28 channels at 0.5 A, {n_lig} "
          f"ligands, receptor {len(rec.types)} atoms: runs "
          + ", ".join(f"{k} {grid_walls[('card', k)]:.2f} s"
                      for k in runs)
          + f" on the card ({card_s:.2f} s; the CPU {cpu_s:.2f} s); "
          f"{len(card_files)} files equal to the CPU's within "
          f"{grid_err:.2e} (.dx {dx_err:.2e}; atol 1e-4); combined .binmap "
          f"{n_lig / grid_walls[('card', 'comb')]:.2f} grids/s through "
          f"main() with its files, make_grid alone "
          f"{len(mk_ligs) / mk_wall:.2f} grids/s; -g --separate holds the "
          f"user grid + 14 receptor channels; {walls['11a']:.1f} s | {smi}",
          flush=True)

    # ---- [11b] gninatyper, tognina, fromgnina -----------------------------
    t_b = time.perf_counter()
    os.makedirs(path("files"))
    check(gninatyper.main([path("ligs.sdf"), path("files", "t")]) == 0,
          "gninatyper")
    for i, lg in enumerate(ligs):
        c, t = gninatyper.read_gninatypes(path("files", f"t_{i}.gninatypes"))
        heavy = ~IS_HYDROGEN[lg.types]
        check(np.array_equal(t, lg.types[heavy])
              and np.array_equal(c, lg.orig_coords[heavy].astype(np.float32)),
              f"gninatypes of ligand {i}")
    mc = path("files", "ligs.molcache")
    check(tognina.main([path("ligs.sdf"), mc]) == 0, "tognina")
    back = list(molcache.load_ligands(mc))
    check(len(back) == n_lig and all(
        b.num_atoms == lg.num_atoms and np.array_equal(b.types, lg.types)
        and np.array_equal(b.orig_coords, lg.orig_coords)
        and np.array_equal(b.pairs, lg.pairs)
        for b, lg in zip(back, ligs)), "the .molcache round trip")
    check(fromgnina.main([mc, path("files", "back.sdf")]) == 0, "fromgnina")
    mols = list(iter_sdf(path("files", "back.sdf")))
    xyz_err = max(float(np.abs(m.coords() - lg.orig_coords).max())
                  for m, lg in zip(mols, ligs))
    check(len(mols) == n_lig and all(
        m.num_atoms() == lg.num_atoms
        and [a.element_name for a in m.atoms]
        == [smina_type_to_element_name(SminaType(int(t))) for t in lg.types]
        for m, lg in zip(mols, ligs)) and xyz_err <= 1e-4,
        "fromgnina's SDF: atom counts, elements or coordinates")
    walls["11b"] = time.perf_counter() - t_b
    print(f"[11b] gninatyper, tognina, fromgnina round trip of {n_lig} "
          f"ligands ({ligs[0].num_atoms} atoms each): types, coordinates "
          f"and atom counts equal, fromgnina's coordinates within "
          f"{xyz_err:.1e} A; {walls['11b']:.2f} s | {smi}", flush=True)

    # ---- [11c] gninavis ---------------------------------------------------
    t_c = time.perf_counter()
    forwards = []
    real_forward = CNNScorer.ensemble_forward

    def counting(self, *a, **kw):
        forwards.append(int(a[3].shape[0]))
        return real_forward(self, *a, **kw)

    os.makedirs(path("vis"))
    CNNScorer.ensemble_forward = counting
    try:
        rc, vis_wall = sync_wall(lambda: gninavis.main(
            ["-r", path("rec.pdb"), "-l", path("one.sdf"), "-o",
             path("vis", "v"), "--frag_bonds", "6"]))
    finally:
        CNNScorer.ensemble_forward = real_forward
    check(rc == 0, f"gninavis rc {rc}")
    lig = ligs[0]
    frags = gninavis.bond_subgraph_fragments(lig, 6)
    bfac = {}
    for kind in ("atoms", "frags"):
        with open(path("vis", f"v_0_{kind}.pdb")) as f:
            lines = f.read().splitlines()
        check(len(lines) == lig.num_atoms + 1 and lines[-1] == "END",
              f"gninavis {kind} PDB")
        bfac[kind] = np.array([float(ln[60:66]) for ln in lines[:-1]])
        check(np.isfinite(bfac[kind]).all(), f"gninavis {kind} B-factors")
    card_sc = CNNScorer()
    check(len(card_sc.models) == 3 and card_sc.device.type == "cuda",
          "gninavis: not the default ensemble on the card")
    atoms_card = gninavis.atom_masking_scores(card_sc, rec, lig)
    check(np.abs(atoms_card - bfac["atoms"]).max() <= 0.0051,
          "gninavis' atom PDB is not the card's atom masking")
    heavy_ids = [i for i in range(lig.num_atoms)
                 if not IS_HYDROGEN[lig.types[i]]]
    rows = [heavy_ids[0], heavy_ids[len(heavy_ids) // 2]]
    coords = lig.orig_coords
    batch = np.tile(coords[None], (len(rows), 1, 1))
    for r, i in enumerate(rows):
        batch[r, i] = coords[i] + 1e4
    cpu_sc = CNNScorer(device="cpu")
    cbase = cpu_sc.score_pose(rec, lig, coords)[0]
    cscores = cpu_sc.score_poses(rec, lig, batch)[0]
    gbase = card_sc.score_pose(rec, lig, coords)[0]
    gscores = card_sc.score_poses(rec, lig, batch)[0]
    vis_err = max([abs(cbase - gbase)]
                  + [abs(float(a) - float(b))
                     for a, b in zip(cscores, gscores)]
                  + [abs((cbase - float(s)) - float(atoms_card[i]))
                     for s, i in zip(cscores, rows)])
    bar = 2 * (1e-4 + 1e-3 * max(abs(cbase), 1.0))
    check(vis_err <= bar, f"gninavis card vs CPU: {vis_err:.2e} > {bar:.2e}")
    walls["11c"] = time.perf_counter() - t_c
    print(f"[11c] gninavis, default ensemble (3 models, 28 x 48^3), one "
          f"ligand: {len(heavy_ids)} heavy atoms masked, {len(frags)} "
          f"fragments of 1-6 bonds; main() {vis_wall:.2f} s in "
          f"{len(forwards)} ensemble forwards ({sum(forwards)} pose rows, "
          f"{3 * len(forwards)} model forwards); base CNNscore "
          f"{gbase:.4f}, atom scores {atoms_card.min():.4f}.."
          f"{atoms_card.max():.4f}; card vs CPU on the base and {len(rows)} "
          f"masked rows {vis_err:.2e} (atol {bar:.1e}); {walls['11c']:.1f} s"
          f" | {smi}", flush=True)

    # ---- [11d] the minimisation server ------------------------------------
    t_d = time.perf_counter()
    state = server._State(DockSettings(cnn_scoring="none"))
    check(state.engine.device.type == "cuda", "the server is not on the card")
    bare = server._State(DockSettings(cnn_scoring="none"))
    servers = []
    for st in (state, bare):
        httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                    server._make_handler(st))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        servers.append(httpd)
    port, port2 = (h.server_address[1] for h in servers)

    def http_code(fn):
        try:
            fn()
        except urllib.error.HTTPError as e:
            return e.code
        return 200

    try:
        st0 = server_client.status("127.0.0.1", port)
        results, srv_wall = sync_wall(lambda: server_client.submit(
            "127.0.0.1", port, path("rec.pdb"), path("ligs.sdf")))
        st1 = server_client.status("127.0.0.1", port)
        with open(path("ligs.sdf")) as f:
            text = f.read()
        c400 = http_code(lambda: server_client._post(
            f"http://127.0.0.1:{port2}", "/minimize", text, "sdf"))
        c404 = http_code(lambda: urllib.request.urlopen(
            f"http://127.0.0.1:{port}/nope"))
    finally:
        for h in servers:
            h.shutdown()
            h.server_close()
    check(st0["receptor_loaded"] is False and st0["ligands_minimized"] == 0
          and st1["receptor_loaded"] is True
          and st1["ligands_minimized"] == n_lig, f"server status {st0} {st1}")
    check((c400, c404) == (400, 404), f"server codes {c400} {c404}")
    check(len(results) == n_lig and all(
        list(r) == ["name", "minimizedAffinity", "intramol", "rmsd",
                    "cnnscore", "cnnaffinity"] for r in results),
        "server result keys")
    eng = DockingEngine(DockSettings(cnn_scoring="none"))
    direct, direct_wall = sync_wall(
        lambda: [eng.minimize(rec, lg).energy for lg in ligs])
    srv_err = max(abs(r["minimizedAffinity"] - e)
                  for r, e in zip(results, direct))
    check(np.isfinite(direct).all() and srv_err <= 1e-4,
          f"served minimizedAffinity vs engine.minimize: {srv_err:.2e}")
    walls["11d"] = time.perf_counter() - t_d
    print(f"[11d] server on 127.0.0.1 (cnn_scoring none): {n_lig} ligands "
          f"in one /minimize, {1e3 * srv_wall / n_lig:.1f} ms a served "
          f"ligand ({1e3 * direct_wall / n_lig:.1f} ms a direct "
          f"engine.minimize); minimizedAffinity {min(direct):.4f}.."
          f"{max(direct):.4f}, the engine's within {srv_err:.1e} kcal/mol; "
          f"status counts 0 -> {st1['ligands_minimized']}, 400 before a "
          f"receptor, 404 on an unknown path; {walls['11d']:.1f} s | {smi}",
          flush=True)

    # ---- [11e] --cnn_model ------------------------------------------------
    t_e = time.perf_counter()

    class ToyNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = torch.nn.Conv3d(28, 16, 3, padding=1)
            self.pool = torch.nn.MaxPool3d(2)
            self.pose = torch.nn.Linear(16 * 6 ** 3, 2)
            self.affinity = torch.nn.Linear(16 * 6 ** 3, 1)

        def forward(self, x):
            f = torch.flatten(self.pool(torch.relu(self.conv(x))), 1)
            return (torch.log_softmax(self.pose(f), dim=1),
                    self.affinity(f).squeeze(-1))

    torch.manual_seed(seed)
    traced = torch.jit.trace(ToyNet().eval(),
                             torch.randn(2, 28, 13, 13, 13))
    pt = path("toy.pt")
    traced.save(pt, _extra_files={"metadata": json.dumps(
        {"resolution": 1.0, "dimension": 12.0})})
    seen = []
    real_multi = CNNScorer.score_poses_multi

    def spy(self, rec_, items):
        seen.append((self, [(lg, np.array(c, np.float32)) for lg, c in items]))
        return real_multi(self, rec_, items)

    torch.cuda.synchronize()
    for k in fd.KERNELS:
        k.reset()
    CNNScorer.score_poses_multi = spy
    try:
        rc, cli_wall = sync_wall(lambda: cli.main(
            ["-r", path("rec.pdb"), "-l", path("one.sdf"), "--score_only",
             "--cnn_model", pt, "-o", path("cnn_model.sdf"), "-q"]))
    finally:
        CNNScorer.score_poses_multi = real_multi
    counts = read_counts(fd)
    check(rc == 0, f"cli.main --cnn_model: rc {rc}")
    check(counts.launches["eval_fg"] >= 1,
          f"--score_only --cnn_model did not reach K1: {counts.launches}")
    with open(path("cnn_model.sdf")) as f:
        sdf_text = f.read()
    tags = {k: float(v) for k, v in re.findall(
        r">  <(CNNscore|CNNaffinity)>\n(\S+)", sdf_text)}
    check(len(seen) == 1 and len(seen[0][1]) == 1 and len(tags) == 2,
          "--cnn_model: one scorer call, one pose, both tags")
    sc_obj, items = seen[0]
    check(len(sc_obj.models) == 1 and sc_obj.models[0].grid_points == 13,
          "--cnn_model: not the traced model")
    prep = sc_obj.prepare_multi(rec, items)
    dev = sc_obj.device
    a_ = [torch.as_tensor(x, device=dev) for x in prep["rec"]] + [
        torch.as_tensor(prep[k], device=dev)
        for k in ("coords", "types", "mask", "centers")]
    with torch.no_grad():
        grid = sc_obj.voxelize_group(sc_obj.models[0], *a_, prep["win"])
        out = torch.jit.load(pt, map_location=dev)(grid[:1])
    want_score = float(torch.softmax(out[0], dim=1)[0, 1])
    want_aff = float(out[1][0])
    cnn_err = max(abs(tags["CNNscore"] - want_score),
                  abs(tags["CNNaffinity"] - want_aff))
    check(np.isfinite([want_score, want_aff]).all() and cnn_err <= 1e-5,
          f"--cnn_model CNNscore/CNNaffinity vs the traced forward: "
          f"{cnn_err:.2e}")
    walls["11e"] = time.perf_counter() - t_e
    print(f"[11e] cli.main --score_only --cnn_model (a traced conv3d/relu/"
          f"max-pool net, 13^3 at 1 A): rc 0 in {cli_wall:.2f} s, CNNscore "
          f"{tags['CNNscore']:.6f}, CNNaffinity {tags['CNNaffinity']:.6f}, "
          f"the traced module's forward on the port's grid within "
          f"{cnn_err:.1e} (1e-5); K1 launches {counts.launches['eval_fg']}; "
          f"{walls['11e']:.1f} s | {smi}", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    print(f"[11] {time.perf_counter() - t_phase:.1f} s: "
          + ", ".join(f"[{k}] {v:.1f} s" for k, v in walls.items()),
          flush=True)
    return walls


def _sdf_close(a: str, b: str, tol: float) -> bool:
    """Two SDF texts with the same tokens, numbers within `tol`."""
    ta, tb = a.split(), b.split()
    if len(ta) != len(tb):
        return False
    for x, y in zip(ta, tb):
        if x == y:
            continue
        try:
            if abs(float(x) - float(y)) > tol:
                return False
        except ValueError:
            return False
    return True


def _records_by_name(text: str) -> dict:
    """{ligand name: the text of its SDF records}, in order of appearance."""
    out = {}
    for rec in text.split("$$$$\n"):
        if rec.strip():
            name = rec.split("\n", 1)[0]
            out[name] = out.get(name, "") + rec + "$$$$\n"
    return out


def phase_multi(seed):
    """[12] Multi-GPU and training at full width, on the one card.

    [12a] The 16 x 8 job at MC_STEPS on the default fused route
    (cnn_scoring="none") through dock_batch, unsharded and under a Mesh
    that names cuda:0 twice (two shards of 8 ligands, each from its own
    thread): the same poses (coordinates within 1e-5 A) and energies
    within 1e-5 kcal/mol, each kernel launched by both runs.
    [12b] K3 and K5 with lane_offset 64: a launch of lanes 64-127 alone on
    the kernels' own Philox draws equals the whole 128-lane launch's lanes
    64-127 bit for bit (and a launch of them without the offset does not);
    on supplied uniforms the offset launch is held to its plain version
    row by row, as [4] and [4c] hold the unsharded ones.
    [12c] `python -m gnina_tpu_torch --dist_nprocs 2` as two processes on
    the card that meet over gloo at a free port of 127.0.0.1: a screen of
    the 16 ligands at MC_STEPS with the default CNN rescore.  The merged
    SDF holds every ligand once in input order, and each process's
    ligands equal a screen of its round-robin subset in this process (the
    same text, numbers within 1e-4).
    [12d] One SGD step of crossdock_default2018_KD_4 (the default
    ensemble's model with the 27,648-wide heads) at its own 48^3 x 28
    grids, on a batch of 8 of the job's poses (the receptor of [8], the
    top pose of 8 ligands of [12a]): the loss and the updated weights
    held to the port's CPU step within 1e-4 relative, and again on a
    dp = 2 mesh of cuda:0 twice.  Prints ms per step.
    [12e] Native bond perception: the library loaded; the parse of the
    3,304-atom receptor of [8] with it and with the pure-Python loop, and
    gninagrid's main() (the [11a] combined run) in grids/s, Python loop
    first, then native."""
    import subprocess
    import tempfile

    import torch

    from gnina_tpu_torch import _fixtures as fx
    from gnina_tpu_torch import cli, native
    from gnina_tpu_torch.chem import ingest
    from gnina_tpu_torch.docking import DockingEngine, DockSettings
    from gnina_tpu_torch.models import registry, train
    from gnina_tpu_torch.models.typer import default_lig_typer, \
        default_rec_typer
    from gnina_tpu_torch.ops import fused_dock as fd
    from gnina_tpu_torch.parallel.mesh import Mesh
    from gnina_tpu_torch.tools import gninagrid

    smi = smi_line()
    here = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_multi_")
    path = lambda *p: os.path.join(tmp, *p)
    dev = torch.device("cuda")
    rec, lig, center, size = fx.system(seed=seed, box=20.0)
    ligs = [lig] * LIGANDS

    # ---- [12a] the sharded dock -------------------------------------------
    t_a = time.perf_counter()
    eng = DockingEngine(DockSettings(cnn_scoring="none",
                                     num_mc_steps=MC_STEPS,
                                     exhaustiveness=EXHAUSTIVENESS))
    mesh = Mesh.of(["cuda:0", "cuda:0"])
    eng.dock_batch(rec, ligs, center, size, seed=seed, mesh=mesh)   # warm
    whole, w_whole, c_whole = counted_dock(fd, eng, rec, ligs, center, size,
                                           seed=seed + 2)
    shard, w_shard, c_shard = counted_dock(fd, eng, rec, ligs, center, size,
                                           seed=seed + 2, mesh=mesh)
    de = dx = 0.0
    for a, b in zip(whole, shard):
        check(len(a) == len(b) > 0, "the sharded dock's pose counts")
        for ra, rb in zip(a, b):
            de = max(de, abs(ra.energy - rb.energy),
                     abs(ra.intramol - rb.intramol))
            dx = max(dx, float(np.abs(ra.coords - rb.coords).max()))
    check(len(whole) == len(shard) == LIGANDS, "the sharded dock's ligands")
    check(de <= 1e-5 and dx <= 1e-5, f"the sharded dock is off the "
          f"unsharded one by {de:.2e} kcal/mol, {dx:.2e} A")
    for k in ("async_mc_window", "bfgs_minimize", "eval_fg"):
        check(c_shard.launches[k] > 0, f"the sharded dock launched no {k}")
    check(c_shard.calls["async_mc_window"]
          == 2 * c_whole.calls["async_mc_window"],
          f"K3 calls {c_shard.calls} against {c_whole.calls}")
    print(f"[12a] dock_batch {LIGANDS} x {EXHAUSTIVENESS} at {MC_STEPS} "
          f"steps under a Mesh of cuda:0 twice (2 shards of "
          f"{LIGANDS // 2} ligands, a thread each) vs unsharded: max "
          f"|de| {de:.2e} kcal/mol (1e-5), |dx| {dx:.2e} A (1e-5); walls "
          f"{w_whole:.2f} s unsharded, {w_shard:.2f} s sharded; launches "
          f"{c_whole.launches} / {c_shard.launches}; "
          f"{time.perf_counter() - t_a:.1f} s", flush=True)

    # ---- [12b] K3 and K5 with a lane offset ------------------------------
    sf = eng.sf
    terms = fd.extract_vina_terms(sf)
    pruned = rec.pruned(np.asarray(center), np.asarray(size) / 2,
                        margin=sf.cutoff)
    lo, hi = np.asarray(center) - size / 2, np.asarray(center) + size / 2
    pack = fd.build_pack(ligs, pruned.coords, pruned.types,
                         np.ones(len(pruned.types), np.float32),
                         EXHAUSTIVENESS, sf.table, m_pad=4, device=dev)
    lanes, half = pack.lanes, pack.lanes // 2
    upper = pack.with_lanes(pack.lane_lig[half:])
    scal_h = fd.scal_vector(10.0, 10.0, 1e3, 1000.0, lo, hi, 2.0, 1.2,
                            device=dev)
    rng = np.random.default_rng(seed + 12)
    r, t = fx.packed_poses(rng, lanes, lo, hi, lig, 4, dev, "random")
    ecur = torch.full((lanes,), 3.0e38, device=dev)
    up = (terms, r[half:].contiguous(), t[half:].contiguous(), scal_h, upper,
          ecur[half:].contiguous())
    allv = (terms, r, t, scal_h, pack, ecur)
    rows = {}
    for name, call, extra in (
            ("async_mc_window", fd.async_mc_window, (128, 16, 14)),
            ("lockstep_mc_window", fd.lockstep_mc_window, (16, 14))):
        w = call(*allv, *extra, seed=seed + 3)
        o = call(*up, *extra, seed=seed + 3, lane_offset=half)
        z = call(*up, *extra, seed=seed + 3)
        torch.cuda.synchronize()
        same = all(torch.equal(a[half:], b) for a, b in zip(w, o))
        check(same, f"{name} at lane_offset {half} is not the whole "
              f"launch's lanes {half}-{lanes - 1}")
        check(not torch.equal(w[6][half:], z[6]),
              f"{name} without the offset drew the same numbers")
        rows[name] = int(w[2][half:, 4 if name == "async_mc_window"
                              else 3].sum())
    # on supplied uniforms, against the plain versions (the [4]/[4c] bounds)
    s_steps, maxit = 4, 1
    budget = 1 + maxit * fd.NUM_TRIALS
    r, t = fx.packed_poses(rng, half, lo, hi, lig, 4, dev, "perturbed")
    uni = torch.as_tensor(rng.random((s_steps * budget, fd.N_DRAWS, half),
                                     dtype=np.float32), device=dev)
    ec = ecur[half:].contiguous()
    got = fd.async_mc_window(terms, r, t, scal_h, upper, ec, s_steps, budget,
                             maxit, uniforms=uni, lane_offset=half)
    torch.cuda.synchronize()
    e_rep, _p, acc_rep, ticks = fd.replay_mc_window_plain(
        terms, r, t, scal_h, upper, ec, got[4:], uni)
    same = ticks == got[2][:, 2].long()
    check(int((~same).sum()) <= max(1, 0.01 * half),
          "K3 at the offset: Armijo flips")
    k3_err = max_err(got[6][same][..., 0], e_rep[same])
    check(close(got[6][same][..., 0], e_rep[same], 5e-4, 5e-3),
          f"K3 at the offset off its plain steps by {k3_err}")
    check(torch.equal(got[6][same][..., 1] > 0.5, acc_rep[same]),
          "K3 at the offset: Metropolis decisions")
    uni5 = uni[:s_steps].contiguous()
    got = fd.lockstep_mc_window(terms, r, t, scal_h, upper, ec, s_steps, 1,
                                uniforms=uni5, lane_offset=half)
    torch.cuda.synchronize()
    e_rep, _p, tr_rep, acc_rep, _c, _ = fd.replay_lockstep_window_plain(
        terms, r, t, scal_h, upper, ec, got[4:], uni5, 1)
    same = tr_rep == got[6][..., 2]
    check(int((~same).sum()) <= max(1, 0.01 * same.numel()),
          "K5 at the offset: Armijo flips")
    k5_err = max_err(got[6][..., 0][same], e_rep[same])
    check(close(got[6][..., 0][same].double(), e_rep[same].double(), 1e-2,
                5e-2), f"K5 at the offset off its plain steps by {k5_err}")
    check(torch.equal(got[6][..., 1] > 0.5, acc_rep),
          "K5 at the offset: Metropolis decisions")
    print(f"[12b] lane_offset {half}: K3 (S=128, budget 16) and K5 (S=16) "
          f"on lanes {half}-{lanes - 1} alone equal the {lanes}-lane "
          f"launches' lanes bit for bit on Philox ({rows['async_mc_window']}"
          f" and {rows['lockstep_mc_window']} steps), without the offset "
          f"other draws; on supplied uniforms vs the plain steps: K3 max "
          f"|de| {k3_err:.2e} (rtol 5e-4, atol 5e-3), K5 {k5_err:.2e} "
          f"(rtol 1e-2, atol 5e-2)", flush=True)

    # ---- [12c] two processes on one card -----------------------------------
    t_c = time.perf_counter()
    with open(path("rec.pdb"), "w") as f:
        f.write(fx.receptor_pdb_text(fx.ligand_center(lig), seed))
    with open(fx.LIGAND_SDF) as f:
        first = f.read().split("$$$$\n")[0] + "$$$$\n"
    body = first[first.index("\n"):]
    names = [f"lig{i:02d}" for i in range(LIGANDS)]
    with open(path("one.sdf"), "w") as f:
        f.write(first)
    with open(path("ligs.sdf"), "w") as f:
        f.write("".join(n + body for n in names))
    for pid in range(2):
        with open(path(f"subset{pid}.sdf"), "w") as f:
            f.write("".join(n + body for n in names[pid::2]))

    def screen_args(src, out):
        return ["-r", path("rec.pdb"), "-l", src, "--autobox_ligand",
                path("one.sdf"), "--exhaustiveness", str(EXHAUSTIVENESS),
                "--num_mc_steps", str(MC_STEPS), "--seed", str(seed + 4),
                "-o", out]

    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gnina_tpu_torch"]
        + screen_args(path("ligs.sdf"), path("merged.sdf"))
        + ["--dist_nprocs", "2", "--dist_procid", str(pid),
           "--dist_coordinator", f"127.0.0.1:{port}"], cwd=tmp, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    w_two = time.perf_counter() - t0
    for pid, (p, (o, e)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"screen process {pid}: rc {p.returncode}"
              f"\n{o[-2000:]}\n{e[-2000:]}")
    check(f"Merged {LIGANDS} ligand(s) from 2 process part files"
          in outs[0][0], "process 0 did not merge the part files")
    with open(path("merged.sdf")) as f:
        merged = _records_by_name(f.read())
    check(list(merged) == names, f"merged ligands {list(merged)}")
    w_sub = []
    for pid in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = cli.main(screen_args(path(f"subset{pid}.sdf"),
                                  path(f"sub{pid}.sdf")) + ["-q"])
        torch.cuda.synchronize()
        w_sub.append(time.perf_counter() - t0)
        check(rc == 0, f"the subset screen {pid}: rc {rc}")
        with open(path(f"sub{pid}.sdf")) as f:
            alone = _records_by_name(f.read())
        check(list(alone) == names[pid::2], "subset screen ligands")
        for name, text in alone.items():
            check(_sdf_close(merged[name], text, 1e-4),
                  f"{name}: the two-process screen's poses differ from the "
                  f"subset screen's")
    print(f"[12c] --dist_nprocs 2 on one card over gloo (127.0.0.1:{port}):"
          f" {LIGANDS} ligands x {EXHAUSTIVENESS} at {MC_STEPS} steps, "
          f"default CNN rescore; merged SDF holds every ligand in input "
          f"order, each process's poses equal its subset screen's (within "
          f"1e-4); two-process wall {w_two:.2f} s (two interpreters, each "
          f"loading the ensemble), one-process subset screens "
          f"{w_sub[0]:.2f} + {w_sub[1]:.2f} s; "
          f"{time.perf_counter() - t_c:.1f} s", flush=True)

    # ---- [12d] one training step at full width ---------------------------
    t_d = time.perf_counter()
    model = registry.load_model("crossdock_default2018_KD_4", device="cpu")
    params = {k: v.numpy() for k, v in model.module.params().items()}
    rt, lt = default_rec_typer(), default_lig_typer()
    poses = [res[0] for res in shard[:8]]
    grids = np.stack([gninagrid.make_grid(
        rec.coords, rec.types, p.coords, lig.types, p.coords.mean(axis=0),
        rt, lt, 0.5, 23.5, device=dev) for p in poses])
    check(grids.shape == (8, 28, 48, 48, 48), f"grids {grids.shape}")
    labels = np.array([1, 0] * 4, np.int32)
    affs = np.array([-p.energy for p in poses], np.float32)

    def step_on(mesh_, reps=1):
        p, opt, step = train.train_setup(mesh_, model.spec, params, 1e-3)
        dev_ = mesh_.row(0)[0]
        args = [torch.as_tensor(x, device=dev_)
                for x in (grids, labels, affs)]
        times = []
        for _ in range(reps):
            if dev_.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            p, opt, loss = step(p, opt, *args)
            if dev_.type == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return float(loss), train.gather_params(p), times

    loss_c, p_c, t_cpu = step_on(Mesh.of(["cpu"]))
    out = {}
    for tag, m_ in (("one", Mesh.of(["cuda:0"])),
                    ("dp2", Mesh.of(["cuda:0", "cuda:0"]))):
        loss_g, p_g, times = step_on(m_, reps=3)
        # the first of 3 steps from the same start is compared; the last
        # two time the step warm
        loss_1, p_1, _ = step_on(m_, reps=1)
        check(abs(loss_1 - loss_c) <= 1e-4 * abs(loss_c),
              f"[12d] {tag}: loss {loss_1} against the CPU's {loss_c}")
        werr = max(float((p_1[k] - p_c[k]).abs().max()
                         / max(float(p_c[k].abs().max()), 1e-30))
                   for k in p_c)
        derr = max(float(((p_1[k] - params[k]) - (p_c[k] - params[k]))
                         .abs().max()) for k in p_c)
        check(werr <= 1e-4, f"[12d] {tag}: weights off the CPU step by "
              f"{werr:.2e} relative")
        out[tag] = (loss_1, werr, derr, 1e3 * float(np.mean(times[1:])))
    print(f"[12d] one SGD step (lr 1e-3, momentum 0.9) of "
          f"crossdock_default2018_KD_4 on 8 poses at 48^3 x 28: loss "
          f"{loss_c:.6f} on the CPU, "
          + "; ".join(f"{k} loss {v[0]:.6f}, weights within {v[1]:.2e} "
                      f"relative (1e-4), update within {v[2]:.2e}, "
                      f"{v[3]:.1f} ms a step" for k, v in out.items())
          + f"; the CPU step {1e3 * t_cpu[0]:.1f} ms; "
          f"{time.perf_counter() - t_d:.1f} s", flush=True)

    # ---- [12e] native bond perception --------------------------------------
    check(native.loaded(), "native bond perception did not load")
    real = native.perceive_bonds_native

    def parse():
        t0 = time.perf_counter()
        r_ = ingest.Receptor.from_file(path("rec.pdb"))
        return r_, time.perf_counter() - t0

    def grids_per_s():
        with open(fx.LIGAND_SDF) as f:
            blocks = f.read().split("$$$$\n")[:TOOLS_LIGANDS]
        with open(path("gl.sdf"), "w") as f:
            f.write("".join(b + "$$$$\n" for b in blocks))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rc = gninagrid.main(["-r", path("rec.pdb"), "-l", path("gl.sdf"),
                             "-o", path("grid")])
        torch.cuda.synchronize()
        check(rc == 0, f"gninagrid rc {rc}")
        return TOOLS_LIGANDS / (time.perf_counter() - t0)

    try:
        native.perceive_bonds_native = lambda *a, **k: None
        r_py, t_py = parse()
        g_py = grids_per_s()
    finally:
        native.perceive_bonds_native = real
    r_nat, t_nat = parse()
    g_nat = grids_per_s()
    check(np.array_equal(r_py.types, r_nat.types) and len(r_nat.types) == 3304,
          "the receptor's typing differs between the two perceptions")
    print(f"[12e] native bond perception loaded "
          f"({os.path.basename(native.library_path())}); the 3,304-atom "
          f"receptor parses in {1e3 * t_nat:.1f} ms native against "
          f"{1e3 * t_py:.1f} ms in the Python loop; gninagrid main() "
          f"{g_py:.2f} grids/s with the Python loop, {g_nat:.2f} native "
          f"({TOOLS_LIGANDS} ligands, 48^3 x 28)", flush=True)
    print(f"[12] multi-GPU, training, native perception: "
          f"{time.perf_counter() - t_phase:.1f} s | {smi}", flush=True)


def read_counts(fd):
    """Every wrapper's counts as dicts by kernel name: kernel launches (in
    all, by the call's lane count, by mode, with done_frac < 1) and wrapper
    calls (in all, by lane count).  The two differ under K8 only, where a
    call makes one cooperative launch per set of co-resident groups."""
    ks = fd.KERNELS
    return types.SimpleNamespace(
        launches={k.name: k.launches for k in ks},
        calls={k.name: k.calls for k in ks},
        by_lanes={k.name: dict(k.launches_by_lanes) for k in ks},
        calls_by_lanes={k.name: dict(k.calls_by_lanes) for k in ks},
        by_mode={k.name: dict(k.launches_by_mode) for k in ks},
        coupled={k.name: k.launches_coupled for k in ks})


def counted_dock(fd, eng, *args, **kw):
    """One dock_batch with every kernel count set to 0 just before and read
    just after: (results, wall s, counts as read_counts gives them)."""
    import torch

    torch.cuda.synchronize()
    for k in fd.KERNELS:
        k.reset()
    t0 = time.perf_counter()
    results = eng.dock_batch(*args, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return results, wall, read_counts(fd)


def bound_ms(ops, nbytes):
    return max(ops / FP32_PEAK, nbytes / HBM_RATE) * 1e3, \
        "operations" if ops / FP32_PEAK >= nbytes / HBM_RATE else "bytes"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_main = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a card",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from gnina_tpu_torch import _fixtures as fx
    from gnina_tpu_torch.chem.ingest import box_from_center_size
    from gnina_tpu_torch.constants import IS_HYDROGEN
    from gnina_tpu_torch.docking import DockingEngine, DockSettings, \
        exact_split
    from gnina_tpu_torch.ops import _cuda
    from gnina_tpu_torch.ops import fused_dock as fd
    from gnina_tpu_torch.ops.energy import Box, make_energy_fn
    from gnina_tpu_torch.scoring.builtin import get_scoring_function
    from gnina_tpu_torch.types import Conf, pad_ligand, pad_receptor

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 must be off")

    # ---- 1. device and build ------------------------------------------
    t0 = time.perf_counter()
    sos = _cuda.build_all(verbose=True)     # one nvcc per source, together
    _cuda.lib()
    _cuda.probes_lib()
    _cuda.voxelize_lib()
    build_s = time.perf_counter() - t0
    print(f"[1] device {kind} | {smi} | kernels built in {build_s:.1f} s ("
          + ", ".join(os.path.basename(v) for v in sos.values()) + ")",
          flush=True)

    # ---- the main path's system -----------------------------------------
    rec, lig, center, size = fx.system(seed=args.seed, box=20.0)
    sf = get_scoring_function("vina")
    terms = fd.extract_vina_terms(sf)
    pruned = rec.pruned(np.asarray(center), np.asarray(size) / 2,
                        margin=sf.cutoff)
    kr = len(pruned.types)
    lo, hi = box_from_center_size(center, size)
    m = 4
    ligs = [lig] * LIGANDS
    pack = fd.build_pack(ligs, pruned.coords, pruned.types,
                         np.ones(kr, np.float32), EXHAUSTIVENESS, sf.table,
                         m_pad=m, device=dev)
    lanes = pack.lanes
    scal_h = fd.scal_vector(10.0, 10.0, 1e3, 1000.0, lo, hi, 2.0, 1.2,
                            device=dev)
    print(f"    receptor {len(rec.types)} atoms, K = {kr} after pruning to "
          f"the {size[0]:.0f} A box + {sf.cutoff:.0f} A; ligand "
          f"{lig.num_atoms} atoms ({pack.max_heavy} heavy), "
          f"{lig.num_torsions} torsions; {lanes} lanes", flush=True)
    errs = {}
    # the second lane layout of the main path: one lane per saved pose, for
    # the finish stages (K2) and the exact rescore (K1)
    num_out = max(DockSettings().num_modes, DockSettings().num_mc_saved)
    out_lanes = LIGANDS * num_out
    pack_out = pack.with_lanes(torch.arange(
        LIGANDS, device=dev, dtype=torch.int32).repeat_interleave(num_out))
    miniters = max(int((25 + lig.num_atoms) / 3), 1)
    # caps and box slope as dock_batch sets them: the rescore (K1) and the
    # in-loop refine (K2) at caps 1000 and slope 1e3, the last finish stage
    # (K2) at slope 1e5
    scal_r = fd.scal_vector(1000.0, 1000.0, 1e3, 1000.0, lo, hi, device=dev)
    scal_s = fd.scal_vector(1000.0, 1000.0, 1e5, 1000.0, lo, hi, device=dev)
    S = types.SimpleNamespace(
        fd=fd, fx=fx, terms=terms, dev=dev, rng=rng, seed=args.seed, lig=lig,
        rec=rec, m=m, lo=lo, hi=hi, pack=pack, pack_out=pack_out, lanes=lanes,
        out_lanes=out_lanes, miniters=miniters, scal_h=scal_h, scal_r=scal_r,
        scal_s=scal_s)

    # ---- 2. K1 vs its plain version at the rescore's shape ---------------
    e_err = g_err = c_err = 0.0
    k1_poses = {}
    for kind_ in ("random", "perturbed"):
        r, t = fx.packed_poses(rng, out_lanes, lo, hi, lig, m, dev, kind_)
        k1_poses[kind_] = (r, t)
        got = fd.eval_fg(terms, r, t, scal_r, pack_out)
        torch.cuda.synchronize()
        ref = fd.eval_fg_plain(terms, r, t, scal_r, pack_out)
        for i, nm in ((0, "e"), (1, "e_metro")):
            check(close(got[i], ref[i], 2e-4, 2e-3),
                  f"K1 {nm} ({kind_}) off by {max_err(got[i], ref[i])}")
        e_err = max(e_err, max_err(got[0], ref[0]), max_err(got[1], ref[1]))
        if kind_ == "perturbed":
            check(close(got[2], ref[2], 1e-3, 1e-2),
                  f"K1 gradient off by {max_err(got[2], ref[2])}")
            g_err = max_err(got[2], ref[2])
        c_err = max(c_err, max_err(got[3], ref[3]))
        check(c_err <= 1e-4, f"K1 coords off by {c_err} A")
    errs["eval_fg"] = e_err
    print(f"[2] K1 eval_fg vs plain on {out_lanes} random + {out_lanes} "
          f"perturbed poses (the rescore's L={out_lanes}, caps 1000, slope "
          f"1e3): max |de| {e_err:.2e} (rtol 2e-4, atol 2e-3), |dg| "
          f"{g_err:.2e} (rtol 1e-3, atol 1e-2), |dx| {c_err:.2e} A "
          f"(1e-4)", flush=True)

    # ---- 3. K2 vs its plain version in both main-path modes --------------
    # refine: L=128, caps 1000, slope 1e3, Metropolis energy kept, from
    # perturbed poses; finish: L=800, slope 1e5, no Metropolis energy, from
    # minima like the container's (random poses through K2 at the hunt caps,
    # then at caps 1000).  Clashing starts at caps 1000 are not what the
    # finish stages see: there BFGS amplifies float32 differences from
    # iteration to iteration, past the 3-iteration bound.
    k2_starts = {}
    for label, pk, nl, sc, wm in (
            ("refine", pack, lanes, scal_r, True),
            ("finish", pack_out, out_lanes, scal_s, False)):
        if label == "refine":
            r, t = fx.packed_poses(rng, nl, lo, hi, lig, m, dev, "perturbed")
        else:
            r, t = fx.packed_poses(rng, nl, lo, hi, lig, m, dev, "random")
            r, t = fd.bfgs_minimize(terms, r, t, scal_h, pk, miniters)[:2]
            r, t = fd.bfgs_minimize(terms, r, t, scal_r, pk, miniters)[:2]
        k2_starts[label] = (r, t)
        # descent is held against the kernel's own start energy
        e0 = fd.eval_fg(terms, r, t, sc, pk)[0]
        k2, flips = {}, {}
        for iters, rtol, atol in ((1, 5e-4, 5e-3), (3, 1e-2, 5e-2)):
            k2[iters], flips[iters] = compare_k2(fd, terms, r, t, sc, pk,
                                                 iters, wm, rtol, atol)
        got8 = fd.bfgs_minimize(terms, r, t, sc, pk, 8, wm)
        torch.cuda.synchronize()
        check(bool((got8[2][:, 0] <= e0 + 1e-3).all()),
              f"K2 {label} ascended at 8 iterations")
        check(bool(torch.isfinite(got8[0]).all()), f"K2 {label} non-finite")
        errs[f"bfgs_minimize/{label}"] = k2[1]
        print(f"[3] K2 bfgs_minimize/{label} (L={nl}, slope "
              f"{float(sc[2]):.0e}, metro {wm}) vs plain: max |de| "
              f"{k2[1]:.2e} at 1 iteration (rtol 5e-4, atol 5e-3), "
              f"{k2[3]:.2e} at 3 (rtol 1e-2, atol 5e-2) on same-path lanes; "
              f"Armijo flips on {flips[1]} and {flips[3]} of {nl} lanes; 8 "
              f"iterations never above the start (+1e-3)", flush=True)

    # ---- 3b. K4 (K2 with async_ls) at both K2 shapes ----------------------
    # Against its plain version with the K2 bounds and flip rule, then its
    # final state against K2's own on the same starts: one block per pose
    # walks the same trial points in both modes, so lanes that made the
    # same number of trials must agree to 1e-4 kcal/mol and 1e-5 in the
    # pose, and K4's accepts (stats row 3) are K2's accepted iterations.
    for label, pk, nl, sc, wm in (
            ("refine", pack, lanes, scal_r, True),
            ("finish", pack_out, out_lanes, scal_s, False)):
        r, t = k2_starts[label]
        k4, flips = {}, {}
        for iters, rtol, atol in ((1, 5e-4, 5e-3), (3, 1e-2, 5e-2)):
            k4[iters], flips[iters] = compare_k2(
                fd, terms, r, t, sc, pk, iters, wm, rtol, atol,
                async_ls=True)
        a = fd.bfgs_minimize(terms, r, t, sc, pk, miniters, wm,
                             async_ls=True)
        b = fd.bfgs_minimize(terms, r, t, sc, pk, miniters, wm)
        torch.cuda.synchronize()
        same = a[2][:, 2] == b[2][:, 2]
        check(float(same.float().mean()) >= 0.99,
              f"K4 {label}: trial counts differ from K2's on "
              f"{int((~same).sum())} lanes")
        d_e = max_err(a[2][same, :2], b[2][same, :2])
        d_x = max(max_err(a[0][same], b[0][same]),
                  max_err(a[1][same], b[1][same]))
        check(d_e <= 1e-4 and d_x <= 1e-5,
              f"K4 {label} final state off K2's by {d_e} kcal/mol, {d_x}")
        check(torch.equal(a[2][same, 3], b[2][same, 4]),
              f"K4 {label} accepts differ from K2's accepted iterations")
        check(bool((a[2][:, 2] <= miniters * fd.NUM_TRIALS + 1).all()),
              "K4 ticks above the cap")
        errs[f"bfgs_minimize[async_ls]/{label}"] = k4[1]
        print(f"[3b] K4 bfgs_minimize[async_ls]/{label} (L={nl}) vs plain: "
              f"max |de| {k4[1]:.2e} at 1 iteration (rtol 5e-4, atol 5e-3), "
              f"{k4[3]:.2e} at 3 (rtol 1e-2, atol 5e-2) on same-path lanes; "
              f"Armijo flips on {flips[1]} and {flips[3]} of {nl} lanes; at "
              f"{miniters} iterations the final state equals K2's on "
              f"{int(same.sum())} of {nl} lanes with the same trial count: "
              f"max |de| {d_e:.2e} (1e-4), |dx| {d_x:.2e} (1e-5)",
              flush=True)

    # ---- 3c. K8: the group stop in k_bfgs and k_lockstep_mc --------------
    phase_k8(S, k2_starts, errs)

    # ---- 4. K3 vs its plain version --------------------------------------
    # S=4 steps of one BFGS iteration each on the same supplied uniforms.
    # Each stream row is held to the K2 one-iteration bound against the
    # plain step from the kernel's own chain head (fd.replay_mc_window_plain):
    # a chain head carries the earlier rows' float32 differences, and the
    # search amplifies them from row to row, so whole plain and kernel
    # windows drift apart.
    # A lane whose kernel ticks differ from the replay's took an Armijo test
    # the other way (a flip); at most 1% of lanes may.
    ecur = torch.full((lanes,), 3.0e38, device=dev)
    s_steps, maxit = 4, 1
    budget = 1 + maxit * fd.NUM_TRIALS
    r, t = fx.packed_poses(rng, lanes, lo, hi, lig, m, dev, "perturbed")
    uni = torch.as_tensor(rng.random((s_steps * budget, fd.N_DRAWS, lanes),
                                     dtype=np.float32), device=dev)
    got = fd.async_mc_window(terms, r, t, scal_h, pack, ecur, s_steps,
                             budget, maxit, uniforms=uni)
    torch.cuda.synchronize()
    ref = fd.async_mc_window_plain(terms, r, t, scal_h, pack, ecur, s_steps,
                                   budget, maxit, uniforms=uni)
    gs, rs = got[6], ref[6]
    check(torch.equal(gs[..., 2], rs[..., 2]), "K3 completion flags")
    check(bool((gs[..., 2] == 1).all()), "K3 left steps incomplete")
    e_rep, p_rep, acc_rep, ticks = fd.replay_mc_window_plain(
        terms, r, t, scal_h, pack, ecur, got[4:], uni)
    same = ticks == got[2][:, 2].long()
    k3_flips = int((~same).sum())
    check(k3_flips <= 0.01 * lanes, f"K3 Armijo flips on {k3_flips} lanes")
    k3_row0 = max_err(gs[same, 0, 0], rs[same, 0, 0])
    check(close(gs[same, 0, 0], rs[same, 0, 0], 5e-4, 5e-3),
          f"K3 first-step energies off the plain window by {k3_row0}")
    k3_err = max_err(gs[same][..., 0], e_rep[same])
    check(close(gs[same][..., 0], e_rep[same], 5e-4, 5e-3),
          f"K3 stream energies off the plain steps by {k3_err}")
    check(max_err(got[4][same][..., :3], p_rep[same]) <= 2e-3,
          "K3 stream positions off the plain steps")
    check(torch.equal(gs[same][..., 1] > 0.5, acc_rep[same]),
          "K3 Metropolis decisions")
    errs["async_mc_window"] = k3_err
    # one full window on the kernel's own Philox draws
    r, t = fx.packed_poses(rng, lanes, lo, hi, lig, m, dev, "random")
    full = fd.async_mc_window(terms, r, t, scal_h, pack, ecur, 128, 16, 14,
                              seed=args.seed + 1)
    torch.cuda.synchronize()
    st = full[6]
    flags, acc = st[..., 2], st[..., 1]
    check(bool(((flags == 0) | (flags == 1)).all()), "K3 flags not 0/1")
    check(not bool(((acc > 0) & (flags == 0)).any()), "K3 accept w/o step")
    check(bool(torch.isfinite(st[..., 0][flags > 0]).all()),
          "K3 non-finite energies")
    done = flags.sum(1)
    check(torch.equal(done, full[2][:, 4]), "K3 step count")
    check(bool((torch.cumprod(flags, 1).sum(1) == done).all()),
          "K3 stream rows not completion-ordered")
    print(f"[4] K3 async_mc_window vs plain on supplied uniforms (S=4, "
          f"maxiters 1): completion flags equal, max |de| {k3_row0:.2e} on "
          f"first steps against the plain window, {k3_err:.2e} over the "
          f"stream against the plain steps (rtol 5e-4, atol 5e-3), "
          f"Metropolis decisions recomputed, Armijo flips on {k3_flips} of "
          f"{lanes} lanes; full "
          f"window S=128 budget 16 on Philox: {int(done.sum())} steps "
          f"completed of {128 * lanes}, {int(acc.sum())} accepted, "
          f"{int(full[2][:, 2].sum())} evaluations", flush=True)

    # ---- 4g. K3's Philox stream against torch.rand ------------------------
    # The same window from the same starts on torch.rand uniforms (the
    # plain versions' generator): the per-lane accept rate, completed steps
    # and mean candidate energy must agree with the Philox window's within
    # 4 standard errors of the difference of the two lane means (lanes are
    # independent chains).  The plain version on the torch.rand uniforms
    # gives the shares of mutation kinds, which follow from the `which`
    # draw alone (1/(T+2) position, 1/(T+2) orientation, T/(T+2) torsion
    # for T torsions).
    g = torch.Generator(device=dev)
    g.manual_seed(args.seed + 2)
    uni = torch.rand((128 * 16, fd.N_DRAWS, lanes), generator=g, device=dev)
    t0 = time.perf_counter()
    rand = fd.async_mc_window(terms, r, t, scal_h, pack, ecur, 128, 16, 14,
                              uniforms=uni)
    plain = fd.async_mc_window_plain(terms, r, t, scal_h, pack, ecur, 128,
                                     16, 14, uniforms=uni, trace=True)
    torch.cuda.synchronize()
    shares = mutation_shares(r, t, plain, plain[-1])
    sides = [stream_stats(full), stream_stats(rand), stream_stats(plain)]
    parts = []
    for key in sides[0]:
        (a, b, c) = (x[key] for x in sides)
        se = lambda v: v.std(ddof=1) / np.sqrt(len(v))
        z = (a.mean() - b.mean()) / max(np.hypot(se(a), se(b)), 1e-12)
        parts.append(f"{key} {a.mean():.4f} +- {se(a):.4f} (Philox) vs "
                     f"{b.mean():.4f} +- {se(b):.4f} (torch.rand; plain "
                     f"{c.mean():.4f}), z {z:+.2f}")
        check(abs(z) <= 4.0, f"K3 Philox stream against torch.rand: {key} "
              f"{a.mean()} vs {b.mean()}, {z:+.2f} standard errors")
    tt = lig.num_torsions
    print(f"[4g] K3 stream, S=128 budget 16 maxiters 14, {lanes} lanes from "
          f"the same starts: " + "; ".join(parts) + f"; mutation shares on "
          f"torch.rand (plain trace) position {shares[0]:.3f}, orientation "
          f"{shares[1]:.3f}, torsion {shares[2]:.3f} (expected "
          f"{1 / (tt + 2):.3f}, {1 / (tt + 2):.3f}, {tt / (tt + 2):.3f}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 4b. K6 (K3 with warm_ls) -----------------------------------------
    # The flag off is the call above, bit for bit.  The flag on, at 2
    # iterations per candidate (the second starts at the warm exponent),
    # is held row by row to the plain step under the same flag from the
    # kernel's own chain head, at the K2 3-iteration bound; lanes whose
    # ticks differ took an Armijo test the other way (at most 2 of 128).
    s_steps, maxit = 4, 2
    budget = 1 + maxit * fd.NUM_TRIALS
    r, t = fx.packed_poses(rng, lanes, lo, hi, lig, m, dev, "perturbed")
    uni = torch.as_tensor(rng.random((s_steps * budget, fd.N_DRAWS, lanes),
                                     dtype=np.float32), device=dev)
    margs = (terms, r, t, scal_h, pack, ecur, s_steps, budget, maxit)
    cold = fd.async_mc_window(*margs, uniforms=uni)
    off = fd.async_mc_window(*margs, uniforms=uni, warm_ls=False)
    warm = fd.async_mc_window(*margs, uniforms=uni, warm_ls=True)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(cold, off)),
          "K6 with the flag off is not the K3 window")
    check(bool((warm[6][..., 2] == 1).all()), "K6 left steps incomplete")
    e_rep, p_rep, acc_rep, ticks = fd.replay_mc_window_plain(
        terms, r, t, scal_h, pack, ecur, warm[4:], uni, maxiters=maxit,
        warm_ls=True)
    same = ticks == warm[2][:, 2].long()
    k6_flips = int((~same).sum())
    check(k6_flips <= 2, f"K6 Armijo flips on {k6_flips} lanes")
    k6_err = max_err(warm[6][same][..., 0], e_rep[same])
    check(close(warm[6][same][..., 0], e_rep[same], 1e-2, 5e-2),
          f"K6 stream energies off the plain steps by {k6_err}")
    check(torch.equal(warm[6][same][..., 1] > 0.5, acc_rep[same]),
          "K6 Metropolis decisions")
    check(not torch.equal(warm[2][:, 2], cold[2][:, 2]),
          "K6 took the cold window's ticks on every lane")
    errs["async_mc_window[warm_ls]"] = k6_err
    print(f"[4b] K6 async_mc_window[warm_ls] (S=4, maxiters 2): flag off "
          f"bit-identical to K3; flag on vs the plain steps under warm_ls: "
          f"max |de| {k6_err:.2e} (rtol 1e-2, atol 5e-2), Metropolis "
          f"decisions recomputed, Armijo flips on {k6_flips} of {lanes} "
          f"lanes (at most 2); evaluations {int(warm[2][:, 2].sum())} warm "
          f"vs {int(cold[2][:, 2].sum())} cold", flush=True)

    # ---- 4c. K5 vs its plain version -------------------------------------
    # S=4 and S=16 steps of one BFGS iteration each on supplied uniforms,
    # in both line-search modes.  Each stream row is held against the plain
    # step from the kernel's own chain head
    # (fd.replay_lockstep_window_plain): at least 99% of the rows within the
    # K2 one-iteration bound (rtol 5e-4, atol 5e-3) and every row within
    # the three-iteration bound (rtol 1e-2, atol 5e-2): over some 3,000
    # rows a few candidates step down a clash, where the step amplifies
    # the float32 differences of K1's gradient.  A row whose trial count
    # differs from the replay's took an Armijo test the other way (at most
    # 1% of rows).
    k5_err, k5_flips, k5_rows, k5_loose = 0.0, 0, 0, 0
    for s_steps, async_ls in ((4, False), (16, False), (4, True)):
        r, t = fx.packed_poses(rng, lanes, lo, hi, lig, m, dev, "perturbed")
        uni = torch.as_tensor(rng.random((s_steps, fd.N_DRAWS, lanes),
                                         dtype=np.float32), device=dev)
        got = fd.lockstep_mc_window(terms, r, t, scal_h, pack, ecur, s_steps,
                                    1, async_ls=async_ls, uniforms=uni)
        torch.cuda.synchronize()
        e_rep, p_rep, tr_rep, acc_rep, c_rep, _ = \
            fd.replay_lockstep_window_plain(
                terms, r, t, scal_h, pack, ecur, got[4:], uni, 1,
                async_ls=async_ls)
        same = tr_rep == got[6][..., 2]
        nflip = int((~same).sum())
        check(nflip <= 0.01 * same.numel(),
              f"K5 S={s_steps}: Armijo flips on {nflip} rows")
        ek, er = got[6][..., 0][same].double(), e_rep[same].double()
        err = max_err(ek, er)
        tight = (ek - er).abs() <= 5e-3 + 5e-4 * er.abs()
        n_loose = int((~tight).sum())
        check(n_loose <= 0.01 * tight.numel() and close(ek, er, 1e-2, 5e-2),
              f"K5 S={s_steps} stream energies off the plain steps by {err} "
              f"({n_loose} rows beyond the one-iteration bound)")
        check(max_err(got[4][..., :3][same], p_rep[same]) <= 2e-3,
              f"K5 S={s_steps} stream positions off the plain steps")
        check(torch.equal(got[6][..., 1] > 0.5, acc_rep),
              f"K5 S={s_steps} Metropolis decisions")
        check(torch.equal(got[6][..., 2].sum(1), got[2][:, 2]),
              f"K5 S={s_steps} trial counts")
        # the final chain state is the last accepted row; the coordinates
        # are those of the last step's last evaluation as the JAX kernel
        # leaves them: the last iterate before the restore, or under
        # async_ls the last tick's trial point (within 1e-2 A: a rejected
        # trial lies a whole step down K1's gradient, which carries its
        # float32 differences)
        acc = got[6][..., 1] > 0.5
        last = (acc * torch.arange(1, s_steps + 1, device=dev)).argmax(1)
        ix = torch.arange(lanes, device=dev)
        check(torch.equal(got[0], got[4][ix, last])
              and torch.equal(got[2][:, 0], got[6][ix, last, 0]),
              f"K5 S={s_steps} final chain state")
        check(max_err(got[3][same[:, -1]], c_rep[same[:, -1]]) <= 1e-2,
              f"K5 S={s_steps} coordinates off the plain last step's")
        if not async_ls:
            c_last = fd.fk_packed(got[4][:, -1], got[5][:, -1], pack)
            check(max_err(got[3], c_last) <= 1e-4,
                  f"K5 S={s_steps} coordinates are not the last iterate's")
        k5_err, k5_flips = max(k5_err, err), k5_flips + nflip
        k5_rows += same.numel()
        k5_loose += n_loose
    errs["lockstep_mc_window"] = k5_err
    r, t = fx.packed_poses(rng, lanes, lo, hi, lig, m, dev, "random")
    full5 = fd.lockstep_mc_window(terms, r, t, scal_h, pack, ecur, 16,
                                  miniters, seed=args.seed + 3)
    again = fd.lockstep_mc_window(terms, r, t, scal_h, pack, ecur, 16,
                                  miniters, seed=args.seed + 3)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(full5, again)),
          "K5 on Philox is not deterministic")
    check(bool(torch.isfinite(full5[6][..., 0]).all()),
          "K5 non-finite energies")
    check(bool((full5[6][:, 0, 1] == 1).all()), "K5 first step not accepted")
    print(f"[4c] K5 lockstep_mc_window vs the plain steps on supplied "
          f"uniforms (S=4 and S=16, and S=4 with async_ls; L={lanes}, "
          f"maxiters 1): max |de| {k5_err:.2e} (rtol 1e-2, atol 5e-2; "
          f"{k5_loose} rows beyond rtol 5e-4, atol 5e-3, at most 1%), "
          f"positions within 2e-3 A, Metropolis decisions recomputed, "
          f"Armijo flips on {k5_flips} of {k5_rows} rows; full window S=16 "
          f"maxiters {miniters} on Philox: {int(full5[6][..., 1].sum())} of "
          f"{16 * lanes} steps accepted, {int(full5[2][:, 2].sum())} trial "
          f"evaluations, the same window for the same seed", flush=True)

    # ---- 4d. K7: the debug_grad layout over K1's gradient ----------------
    r, t = k1_poses["perturbed"]
    got7 = fd.debug_grad(terms, r, t, scal_r, pack_out)
    torch.cuda.synchronize()
    ref7 = fd.eval_fg_plain(terms, r, t, scal_r, pack_out)
    n_rows = pack_out.dims[0]
    dof = 6 + m - 1
    rows7 = got7[3].permute(0, 2, 1).reshape(out_lanes, 3 * n_rows)
    check(close(rows7[:, :dof], ref7[2], 1e-3, 1e-2),
          f"K7 gradient rows off by {max_err(rows7[:, :dof], ref7[2])}")
    check(bool((rows7[:, dof:] == 0).all()), "K7 rows past D not zero")
    check(close(got7[2][:, 0], ref7[0], 2e-4, 2e-3), "K7 energy row")
    errs["debug_grad"] = max_err(rows7[:, :dof], ref7[2])
    print(f"[4d] K7 debug_grad (K1's gradient in the rows of the coordinate "
          f"output, L={out_lanes}): max |dg| {errs['debug_grad']:.2e} vs "
          f"plain (rtol 1e-3, atol 1e-2), rows past D zero", flush=True)

    # ---- 4e. K9-K11: the rate probes ---------------------------------------
    probe_rows = phase_probes(S, errs)

    # ---- 4f. K1 and K3 with the receptor streamed through tiles ------------
    phase_streamed(S, errs)

    # ---- 5. the main path end to end ---------------------------------------
    settings = DockSettings(cnn_scoring="none", num_mc_steps=MC_STEPS,
                            exhaustiveness=EXHAUSTIVENESS)
    eng = DockingEngine(settings)           # device=None: the card
    check(eng.device.type == "cuda", "default device is not the card")
    eng.dock_batch(rec, ligs, center, size, seed=args.seed)     # warm
    results, wall, cnt = counted_dock(
        fd, eng, rec, ligs, center, size, seed=args.seed + 1)
    cnt_main = cnt
    launches, by_lanes, by_mode = cnt.launches, cnt.by_lanes, cnt.by_mode
    check(cnt.calls == launches, f"uncoupled calls {cnt.calls} made "
          f"{launches} launches")
    check(launches["async_mc_window"] == MC_STEPS // 128,
          f"K3 launches {launches['async_mc_window']}")
    check(launches["bfgs_minimize"] == 2 * (MC_STEPS // 128) + 5,
          f"K2 launches {launches['bfgs_minimize']}")
    check(launches["eval_fg"] == 1, f"K1 launches {launches['eval_fg']}")
    check(launches["lockstep_mc_window"] == 0
          and not by_mode["bfgs_minimize"].get(True)
          and not by_mode["async_mc_window"].get(True),
          "the default search launched a fallback mode")
    # each pose against the plain exact rescore of its conf, within 1e-3
    # kcal/mol plus 0.005 per atom pair within 2e-3 A^2 of the cutoff (the
    # energy steps there; two float32 paths may round to either side)
    rec_d = pad_receptor(pruned.coords, pruned.types, pruned.charges, kr,
                         device=dev)
    lig_d = pad_ligand(lig, 24, m, 96, device=dev)
    efn = make_energy_fn(sf, 4)
    box = Box(lo=torch.as_tensor(lo, device=dev),
              hi=torch.as_tensor(hi, device=dev))
    cap = [1000.0] * 3
    heavy = ~IS_HYDROGEN[lig.types]
    rc = np.asarray(pruned.coords, np.float64)

    def verify(results, n_ligs, min_rmsd, by_energy=True):
        """The repo's own checks of a dock's poses; returns the largest
        |energy - plain rescore|."""
        check(len(results) == n_ligs and all(results), "missing poses")
        worst = 0.0
        for res in results:
            conf = Conf(*[torch.as_tensor(
                np.stack([getattr(p, f) for p in res]), device=dev)
                for f in ("conf_position", "conf_orientation",
                          "conf_torsions")])
            with torch.no_grad():
                inter, _ = exact_split(efn, lig_d, rec_d, conf, box, 1e3, cap)
            e_ref = eng._conf_independent(lig, inter.cpu().numpy())
            for i, p in enumerate(res):
                c = np.clip(np.asarray(p.coords, np.float64)[heavy], lo, hi)
                d2 = ((c[:, None] - rc[None]) ** 2).sum(-1)
                tol = 1e-3 + 0.005 * int((np.abs(d2 - sf.cutoff ** 2)
                                          < 2e-3).sum())
                worst = max(worst, abs(p.energy - float(e_ref[i])))
                check(abs(p.energy - float(e_ref[i])) <= tol,
                      f"pose energy {p.energy} vs plain rescore {e_ref[i]}")
                check(bool(np.isfinite(p.coords).all()), "non-finite pose")
            if by_energy:
                e = [p.energy for p in res]
                check(e == sorted(e), "poses not sorted by energy")
            for i in range(len(res)):
                for j in range(i):
                    d = np.sqrt(((res[i].coords[heavy]
                                  - res[j].coords[heavy]) ** 2).sum(1).mean())
                    check(d > min_rmsd, "poses closer than out_min_rmsd")
        return worst

    worst = verify(results, LIGANDS, settings.out_min_rmsd)
    best = min(r_[0].energy for r_ in results)
    counts = [len(r_) for r_ in results]
    print(f"[5] dock_batch {LIGANDS} ligands x {EXHAUSTIVENESS} chains, "
          f"{MC_STEPS} steps: {wall:.2f} s, {LIGANDS / wall:.3f} lig/s, "
          f"best {best:.3f} kcal/mol, poses per ligand {counts}, launches "
          f"{launches} {by_lanes}; energies vs plain rescore max |de| "
          f"{worst:.2e}", flush=True)

    # ---- 5b-5e. the fallback search settings, each through dock_batch -----
    def settings_dock(label, n_ligs, steps, expect, **kw):
        """One counted dock under DockSettings(cnn_scoring='none', **kw);
        `expect` maps kernel name -> launches."""
        st = DockSettings(cnn_scoring="none", num_mc_steps=steps,
                          exhaustiveness=EXHAUSTIVENESS, **kw)
        res, w, cnt = counted_dock(
            fd, DockingEngine(st), rec, ligs[:n_ligs], center, size,
            seed=args.seed + 1)
        ln, bl, bm = cnt.launches, cnt.by_lanes, cnt.by_mode
        check(cnt.calls == ln, f"{label}: uncoupled calls {cnt.calls} made "
              f"{ln} launches")
        for name, n in expect.items():
            check(ln[name] == n, f"{label}: {name} launches {ln[name]}, "
                  f"expected {n}")
        worst_ = verify(res, n_ligs, st.out_min_rmsd)
        print(f"[5{label[0]}] dock_batch {label[3:]}: {n_ligs} ligands x "
              f"{EXHAUSTIVENESS} chains, {steps} steps: {w:.2f} s, "
              f"{n_ligs / w:.3f} lig/s, best "
              f"{min(r_[0].energy for r_ in res):.3f} kcal/mol, launches "
              f"{ln} by lanes {bl} by mode {bm}; energies vs plain rescore "
              f"max |de| {worst_:.2e}", flush=True)
        return cnt

    n_win = MC_STEPS // 128
    # K4 in every BFGS of the default in-kernel search
    cnt_k4 = settings_dock(
        "b: fused_async_ls=True", LIGANDS, MC_STEPS,
        {"async_mc_window": n_win, "bfgs_minimize": 2 * n_win + 5,
         "eval_fg": 1, "lockstep_mc_window": 0}, fused_async_ls=True)
    check(cnt_k4.by_mode["bfgs_minimize"] == {True: 2 * n_win + 5},
          f"async_ls dock ran K2 without the flag: "
          f"{cnt_k4.by_mode['bfgs_minimize']}")
    # K6 windows
    cnt_k6 = settings_dock(
        "c: fused_warm_ls=True", LIGANDS, MC_STEPS,
        {"async_mc_window": n_win, "bfgs_minimize": 2 * n_win + 5,
         "eval_fg": 1, "lockstep_mc_window": 0}, fused_warm_ls=True)
    check(cnt_k6.by_mode["async_mc_window"] == {True: n_win},
          f"warm_ls dock ran K3 without the flag: "
          f"{cnt_k6.by_mode['async_mc_window']}")
    # K5 windows of 16 steps
    lock_steps = 256
    cnt_k5 = settings_dock(
        "d: fused_async_mc=False (lockstep windows)", LIGANDS, lock_steps,
        {"lockstep_mc_window": lock_steps // 16, "async_mc_window": 0,
         "bfgs_minimize": lock_steps // 16 + 5, "eval_fg": 1},
        fused_async_mc=False)
    # the host-driven step loop over K4: one minimisation per step, one
    # refine every refine_stride steps, five finish stages
    host_steps, stride = 256, DockSettings().refine_stride
    settings_dock(
        "e: fused_mc_in_kernel=False, fused_async_ls=True (host-driven)", 4,
        host_steps,
        {"bfgs_minimize": host_steps + host_steps // stride + 5,
         "async_mc_window": 0, "lockstep_mc_window": 0, "eval_fg": 1},
        fused_mc_in_kernel=False, fused_async_ls=True)

    # ---- 5e'. K8 through dock_batch: fused_done_frac=0.9 in every mode -----
    k8_launch = {}
    for label, n_ligs, steps, kern, kw in (
            ("default", LIGANDS, MC_STEPS, "bfgs_minimize", {}),
            ("fused_async_ls", LIGANDS, MC_STEPS, "bfgs_minimize",
             dict(fused_async_ls=True)),
            ("fused_async_mc=False", LIGANDS, lock_steps,
             "lockstep_mc_window", dict(fused_async_mc=False)),
            ("fused_mc_in_kernel=False", 4, 64, "bfgs_minimize",
             dict(fused_mc_in_kernel=False))):
        st = DockSettings(cnn_scoring="none", num_mc_steps=steps,
                          exhaustiveness=EXHAUSTIVENESS, fused_done_frac=0.9,
                          **kw)
        res, w, cnt = counted_dock(
            fd, DockingEngine(st), rec, ligs[:n_ligs], center, size,
            seed=args.seed + 1)
        ln, bl, coupled = cnt.launches, cnt.by_lanes, cnt.coupled
        check(coupled["bfgs_minimize"] == ln["bfgs_minimize"] > 0
              and coupled["lockstep_mc_window"] == ln["lockstep_mc_window"],
              f"done_frac dock ({label}) ran uncoupled launches: {coupled} "
              f"of {ln}")
        # a coupled call makes one launch per set of co-resident groups:
        # one for a single group, at most one per group beyond
        for name in ("bfgs_minimize", "lockstep_mc_window"):
            for nl_, n_ in bl[name].items():
                c_ = cnt.calls_by_lanes[name][nl_]
                check(0 < c_ <= n_ <= c_ * -(-nl_ // fd.GROUP),
                      f"done_frac dock ({label}): {n_} launches of {name} "
                      f"in {c_} calls at {nl_} lanes")
        worst_ = verify(res, n_ligs, st.out_min_rmsd)
        k8_launch[label] = cnt
        print(f"[5e'] dock_batch fused_done_frac=0.9, {label}: {n_ligs} "
              f"ligands x {EXHAUSTIVENESS} chains, {steps} steps: {w:.2f} s, "
              f"{n_ligs / w:.3f} lig/s, best "
              f"{min(r_[0].energy for r_ in res):.3f} kcal/mol, coupled "
              f"launches {coupled} by lanes {bl[kern]} in calls "
              f"{cnt.calls_by_lanes[kern]}; energies vs plain rescore max "
              f"|de| {worst_:.2e}", flush=True)

    # ---- 5f. the default settings with the default CNN ensemble -----------
    from gnina_tpu_torch.models.scorer import MAX_POSE_BATCH, CNNScorer

    t0 = time.perf_counter()
    scorer = CNNScorer()                    # device=None: the card
    check(scorer.device.type == "cuda", "the scorer is not on the card")
    check([m_.name for m_ in scorer.models]
          == ["dense_1_3", "dense_1_3_PT_KD_3", "crossdock_default2018_KD_4"],
          "not the default ensemble")
    check(all(m_.grid_points == 48 and m_.num_channels == 28
              for m_ in scorer.models), "not 28 channels on 48^3")
    load_s = time.perf_counter() - t0
    rescore = {"s": 0.0, "poses": 0, "calls": 0}
    inner = scorer.score_poses_multi

    def timed_rescore(rec_, items):
        torch.cuda.synchronize()
        t_ = time.perf_counter()
        out = inner(rec_, items)
        torch.cuda.synchronize()
        rescore["s"] += time.perf_counter() - t_
        rescore["poses"] += sum(len(c) for _, c in items)
        rescore["calls"] += 1
        return out

    scorer.score_poses_multi = timed_rescore
    # warm: one full chunk through voxelizer and ensemble
    warm_c = (lig.orig_coords[None] + 0.3 * rng.normal(
        size=(MAX_POSE_BATCH, 1, 3))).astype(np.float32)
    inner(rec, [(lig, warm_c)])
    st_cnn = DockSettings(num_mc_steps=MC_STEPS)     # every other default
    check(st_cnn.cnn_scoring == "rescore" and st_cnn.sort_order == "auto",
          "not the default CNN settings")
    eng_cnn = DockingEngine(st_cnn, cnn_scorer=scorer)
    from gnina_tpu_torch.ops import voxelize as vox_mod
    vox_mod.voxelize_cuda.launches = 0
    res_cnn, wall_cnn, cnt = counted_dock(
        fd, eng_cnn, rec, ligs, center, size, seed=args.seed + 1)
    vox_launches = vox_mod.voxelize_cuda.launches
    ln = cnt.launches
    check(ln["async_mc_window"] == n_win and ln["eval_fg"] == 1
          and ln["bfgs_minimize"] == 2 * n_win + 5,
          f"default-settings dock launches {ln}")
    verify(res_cnn, LIGANDS, st_cnn.out_min_rmsd, by_energy=False)
    for res in res_cnn:
        sc_ = [p.cnnscore for p in res]
        check(sc_ == sorted(sc_, reverse=True), "poses not sorted by cnnscore")
        check(all(0.0 < x < 1.0 for x in sc_),
              f"cnnscore out of (0, 1): {sc_}")
        check(all(np.isfinite([p.cnnaffinity, p.cnnvariance]).all()
                  and p.cnnvariance >= 0.0 for p in res),
              "non-finite CNN affinity or variance")
    check(rescore["calls"] == 1, "the rescore was not one batched call")
    resc_s, resc_n = rescore["s"], rescore["poses"]
    # one voxeliser launch a pose chunk of the rescore (one voxelisation
    # group: the three models share their grids)
    resc_chunks = -(-resc_n // min(1 << (resc_n - 1).bit_length(),
                                   MAX_POSE_BATCH))
    check(vox_launches == resc_chunks,
          f"the dock's rescore launched the CUDA voxeliser {vox_launches} "
          f"times for {resc_chunks} chunks of {resc_n} poses")

    # one pose chunk on the card against the same code on the CPU: the
    # first 8 poses (a chunk of a smaller call; a 128-pose chunk through
    # three dense nets takes minutes on the host)
    cpu_scorer = CNNScorer(device="cpu")
    c8 = np.stack([p.coords for res in res_cnn for p in res][:8])
    prep = scorer.prepare_multi(rec, [(lig, c8)])
    check(prep["bp"] == 8, "chunk size")

    def chunk_on(sc_obj):
        d_ = sc_obj.device
        a_ = [torch.as_tensor(x, device=d_) for x in prep["rec"]] + [
            torch.as_tensor(prep[k], device=d_)
            for k in ("coords", "types", "mask", "centers")]
        with torch.no_grad():
            g_ = sc_obj.voxelize_group(sc_obj.models[0], *a_, prep["win"])
            o_ = sc_obj.ensemble_forward(
                *a_, prep["win"], torch.Generator(device=d_).manual_seed(0))
        return g_, o_

    g_gpu, o_gpu = chunk_on(scorer)
    torch.cuda.synchronize()
    g_cpu, o_cpu = chunk_on(cpu_scorer)
    grid_err = max_err(g_gpu.cpu(), g_cpu)
    check(tuple(g_gpu.shape) == (8, 28, 48, 48, 48), "grid shape")
    check(float(g_cpu.max()) > 0.5, "empty grids")
    check(grid_err <= 1e-4, f"grids off the CPU voxelizer by {grid_err}")
    out_err = max(max_err(a.cpu(), b) for a, b in zip(o_gpu, o_cpu))
    check(all(close(a.cpu(), b, 1e-3, 1e-4) for a, b in zip(o_gpu, o_cpu)),
          f"ensemble outputs off the CPU's by {out_err}")

    # per-chunk times at the full chunk of 128 poses
    prep128 = scorer.prepare_multi(rec, [(lig, warm_c)])
    a128 = [torch.as_tensor(x, device=dev) for x in prep128["rec"]] + [
        torch.as_tensor(prep128[k], device=dev)
        for k in ("coords", "types", "mask", "centers")]
    with torch.no_grad():
        vox_ms = timed(lambda: scorer.voxelize_group(
            scorer.models[0], *a128, prep128["win"]), 3)
        g128 = scorer.voxelize_group(scorer.models[0], *a128, prep128["win"])
    with torch.enable_grad():      # the kernel runs outside autograd only
        plain_vox_ms = timed(lambda: scorer.voxelize_group(
            scorer.models[0], *a128, prep128["win"]), 1)
        plain128 = scorer.voxelize_group(scorer.models[0], *a128,
                                         prep128["win"])
    vox_err = float((g128 - plain128).abs().max())   # no float64 copies
    del plain128
    check(g128.is_contiguous() and tuple(g128.shape)
          == (MAX_POSE_BATCH, 28, 48, 48, 48), "the kernel's grid layout")
    check(vox_err <= 1e-5,
          f"the kernel's 128-pose grids off the plain voxeliser's by "
          f"{vox_err}")
    # the kernel's least bytes: the grids written once, its operands read
    # once (coordinates, channel, radius and mask: 21 B an atom row)
    vox_bytes = g128.numel() * 4 + 21 * (a128[0].shape[0]
                                         + a128[3][..., 0].numel())
    vox_bound, vox_by = bound_ms(0.0, vox_bytes)
    vox_row = dict(
        name="voxelize_cuda",
        shape=f"B={MAX_POSE_BATCH} N={a128[3].shape[1]} "
              f"K={a128[0].shape[0]}",
        ms=vox_ms, plain_ms=plain_vox_ms, bound_ms=vox_bound,
        bound_by=vox_by, launches=vox_launches, calls=vox_launches,
        replaces="none", max_abs_err=vox_err,
        source="gnina_tpu_torch/csrc/voxelize.cu")
    with torch.no_grad():
        fwd_ms = {m_.name: timed(lambda: m_.module(g128), 3)
                  for m_ in scorer.models}
        torch.cuda.reset_peak_memory_stats()
        scorer.ensemble_forward(*a128, prep128["win"],
                                torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    del g128
    print(f"[5f] default settings + default CNN ensemble (3 models, 28 "
          f"channels x 48^3; loaded in {load_s:.1f} s): dock_batch "
          f"{LIGANDS} ligands x {EXHAUSTIVENESS} chains, {MC_STEPS} steps: "
          f"{wall_cnn:.2f} s, {LIGANDS / wall_cnn:.3f} lig/s, of which the "
          f"CNN rescore of {resc_n} poses {resc_s:.2f} s "
          f"({100 * resc_s / wall_cnn:.1f}%); poses sorted by cnnscore, "
          f"best cnnscore {max(r_[0].cnnscore for r_ in res_cnn):.3f}; "
          f"receptor window {prep128['win']} of {len(prep128['rec'][0])} "
          f"atoms; per 128-pose chunk: voxelise {vox_ms:.3f} ms (the "
          f"plain voxeliser {plain_vox_ms:.1f} ms, max |d| {vox_err:.2e}; "
          f"{vox_launches} launches for the dock's {resc_chunks} chunks), "
          f"forward "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in fwd_ms.items())
          + f", peak memory {peak_gb:.2f} GiB; card vs CPU on an 8-pose "
          f"chunk: grids max |d| {grid_err:.2e} (atol 1e-4), ensemble "
          f"outputs max |d| {out_err:.2e} (rtol 1e-3, atol 1e-4)",
          flush=True)

    # ---- 5g. DockSettings() as it stands: the heuristic's step count -------
    rescore.update(s=0.0, poses=0, calls=0)
    eng_def = DockingEngine(DockSettings(), cnn_scorer=scorer)
    res_def, wall_def, cnt = counted_dock(
        fd, eng_def, rec, ligs, center, size, seed=args.seed + 1)
    ln = cnt.launches
    verify(res_def, LIGANDS, 1.0, by_energy=False)
    for res in res_def:
        sc_ = [p.cnnscore for p in res]
        check(sc_ == sorted(sc_, reverse=True), "poses not sorted by cnnscore")
    def_steps = int(70 * 3 * (50 + lig.num_atoms
                              + 10 * (6 + lig.num_torsions)) / 2)
    print(f"[5g] DockSettings() + default CNN ensemble, {def_steps} MC steps "
          f"by the heuristic: dock_batch {LIGANDS} ligands x 8 chains: "
          f"{wall_def:.2f} s, {LIGANDS / wall_def:.3f} lig/s, CNN rescore "
          f"{rescore['s']:.2f} s of it; best energy "
          f"{min(p.energy for r_ in res_def for p in r_):.3f} kcal/mol, "
          f"launches {ln}", flush=True)
    scorer.score_poses_multi = inner

    # ---- 5h. the command line, at full width ------------------------------
    cli_launches, cli_coupled, cli_walls = phase_cli(
        S, [m_.name for m_ in scorer.models])
    for name in ("async_mc_window", "bfgs_minimize", "eval_fg"):
        check(cli_launches[name] > 0, f"the screen never launched {name}")

    # ---- 6. kernel timings at the main path's shapes ------------------------
    reps = 5
    rows = []
    cut2 = terms.cutoff_sqr

    # K1 at the rescore shape (one lane per saved pose)
    r, t = k1_poses["perturbed"]
    ms = timed(lambda: fd.eval_fg(terms, r, t, scal_r, pack_out), reps)
    pms = timed(lambda: fd.eval_fg_plain(terms, r, t, scal_r, pack_out),
                reps)
    crd = fd.eval_fg(terms, r, t, scal_r, pack_out)[3]
    lig_idx = pack_out.lane_lig.long()
    frac = in_cutoff_fraction(crd, pack_out, lig_idx, cut2)
    ones = torch.ones(out_lanes, device=dev)
    ops = kernel_ops(0 * ones, ones, pack_out, lig_idx, frac)
    nbytes = pack_bytes(pack_out, out_lanes, m) \
        + out_lanes * 4 * (2 + (5 + m) + 3 * pack.dims[0])
    bms, bby = bound_ms(ops, nbytes)
    rows.append(dict(name="eval_fg", shape=f"L={out_lanes}", ms=ms,
                     plain_ms=pms, bound_ms=bms, bound_by=bby,
                     launches=launches["eval_fg"],
                     calls=cnt_main.calls["eval_fg"],
                     replaces="gnina_tpu/ops/pallas_dock.py:677",
                     max_abs_err=errs["eval_fg"]))

    # K2 and K4 at both main-path shapes, from the starts phase 3 compared
    # on; K4's launches are those of the fused_async_ls dock
    # K8's rows: the same launches with done_frac = 0.9, counted in the
    # fused_done_frac docks of phase 5e'
    for async_ls, frac, tag, counts_ in (
            (False, 1.0, "", cnt_main),
            (True, 1.0, "[async_ls]", cnt_k4),
            (False, 0.9, "[done_frac]", k8_launch["default"]),
            (True, 0.9, "[async_ls,done_frac]",
             k8_launch["fused_async_ls"])):
        for label, pk, nl, sc, wm in (
                ("refine", pack, lanes, scal_r, True),
                ("finish", pack_out, out_lanes, scal_s, False)):
            r, t = k2_starts[label]
            kw = dict(async_ls=async_ls, done_frac=frac)
            ms = timed(lambda: fd.bfgs_minimize(
                terms, r, t, sc, pk, miniters, wm, **kw), reps)
            pms = timed(lambda: fd.bfgs_minimize_plain(
                terms, r, t, sc, pk, miniters, wm, **kw), 2)
            out = fd.bfgs_minimize(terms, r, t, sc, pk, miniters, wm, **kw)
            li = pk.lane_lig.long()
            frac_in = in_cutoff_fraction(out[3], pk, li, cut2)
            stats = out[2]
            # the least work of the function: a value for each rejected
            # Armijo trial, a value and gradient for the start and each
            # accepted one (stats row 2: trials, row 4: accepted)
            ops = kernel_ops(stats[:, 2] - stats[:, 4], 1 + stats[:, 4], pk,
                             li, frac_in)
            nbytes = pack_bytes(pk, nl, m) + nl * 4 * (8 + 3 * pack.dims[0])
            bms, bby = bound_ms(ops, nbytes)
            name = f"bfgs_minimize{tag}/{label}"
            line = ("715" if frac < 1.0 else "860" if async_ls else "722")
            rows.append(dict(
                name=name, shape=f"L={nl}", ms=ms, plain_ms=pms,
                bound_ms=bms, bound_by=bby,
                launches=counts_.by_lanes["bfgs_minimize"].get(nl, 0),
                calls=counts_.calls_by_lanes["bfgs_minimize"].get(nl, 0),
                replaces="gnina_tpu/ops/pallas_dock.py:" + line,
                max_abs_err=errs[name]))

    # K3 and K6: one window of the main path (S=128, tick budget 16); K6's
    # launches are those of the fused_warm_ls dock
    r, t = fx.packed_poses(rng, lanes, lo, hi, lig, m, dev, "random")
    ecur = torch.full((lanes,), 3.0e38, device=dev)
    gen = torch.Generator(device=dev)
    window_steps = {}
    for warm_ls, name, n_launch, line in (
            (False, "async_mc_window", launches["async_mc_window"], "1124"),
            (True, "async_mc_window[warm_ls]",
             cnt_k6.launches["async_mc_window"], "1150")):
        run3 = lambda: fd.async_mc_window(
            terms, r, t, scal_h, pack, ecur, 128, 16, miniters,
            seed=args.seed + 2, warm_ls=warm_ls)
        ms = timed(run3, reps)
        pms = timed(lambda: fd.async_mc_window_plain(
            terms, r, t, scal_h, pack, ecur, 128, 16, miniters,
            generator=gen.manual_seed(args.seed + 2), warm_ls=warm_ls), 1)
        out = run3()
        frac = in_cutoff_fraction(out[3], pack, pack.lane_lig.long(), cut2)
        # the least work of the function: a value and gradient for each
        # candidate's mutated start (stats row 4, completed steps) and each
        # accepted Armijo trial (row 3); a value for every other tick (row 2)
        grads = out[2][:, 4] + out[2][:, 3]
        ops = kernel_ops(torch.clamp(out[2][:, 2] - grads, min=0), grads,
                         pack, pack.lane_lig.long(), frac)
        nbytes = pack_bytes(pack, lanes, m) + lanes * 4 * (
            8 + 3 * pack.dims[0] + 128 * (8 + m + 3))
        bms, bby = bound_ms(ops, nbytes)
        window_steps[name] = (int(out[2][:, 4].sum()),
                              int(out[2][:, 3].sum()))
        rows.append(dict(name=name, shape=f"L={lanes} S=128 b=16", ms=ms,
                         plain_ms=pms, bound_ms=bms, bound_by=bby,
                         in_cutoff=frac, launches=n_launch, calls=n_launch,
                         replaces=f"gnina_tpu/ops/pallas_dock.py:{line}",
                         max_abs_err=errs[name]))

    # K5: one window of the lockstep dock (S=16, whole BFGS per step)
    run5 = lambda: fd.lockstep_mc_window(terms, r, t, scal_h, pack, ecur, 16,
                                         miniters, seed=args.seed + 2)
    ms = timed(run5, reps)
    pms = timed(lambda: fd.lockstep_mc_window_plain(
        terms, r, t, scal_h, pack, ecur, 16, miniters,
        generator=gen.manual_seed(args.seed + 2)), 1)
    out = run5()
    frac = in_cutoff_fraction(out[3], pack, pack.lane_lig.long(), cut2)
    # the least work: a value and gradient for each step's mutated start
    # and each accepted line-search step (stats row 4), a value for every
    # other trial (row 2)
    ops = kernel_ops(out[2][:, 2] - out[2][:, 4], 16 + out[2][:, 4], pack,
                     pack.lane_lig.long(), frac)
    nbytes = pack_bytes(pack, lanes, m) + lanes * 4 * (
        8 + 3 * pack.dims[0] + 16 * (8 + m + 3))
    bms, bby = bound_ms(ops, nbytes)
    rows.append(dict(name="lockstep_mc_window", shape=f"L={lanes} S=16",
                     ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                     launches=cnt_k5.launches["lockstep_mc_window"],
                     calls=cnt_k5.calls["lockstep_mc_window"],
                     replaces="gnina_tpu/ops/pallas_dock.py:1290",
                     max_abs_err=errs["lockstep_mc_window"]))

    # K8 in K5: the same window with done_frac = 0.9
    run5c = lambda: fd.lockstep_mc_window(terms, r, t, scal_h, pack, ecur, 16,
                                          miniters, seed=args.seed + 2,
                                          done_frac=0.9)
    ms = timed(run5c, reps)
    pms = timed(lambda: fd.lockstep_mc_window_plain(
        terms, r, t, scal_h, pack, ecur, 16, miniters,
        generator=gen.manual_seed(args.seed + 2), done_frac=0.9), 1)
    out = run5c()
    frac = in_cutoff_fraction(out[3], pack, pack.lane_lig.long(), cut2)
    ops = kernel_ops(out[2][:, 2] - out[2][:, 4], 16 + out[2][:, 4], pack,
                     pack.lane_lig.long(), frac)
    bms, bby = bound_ms(ops, nbytes)
    rows.append(dict(
        name="lockstep_mc_window[done_frac]", shape=f"L={lanes} S=16", ms=ms,
        plain_ms=pms, bound_ms=bms, bound_by=bby,
        launches=k8_launch["fused_async_mc=False"].launches[
            "lockstep_mc_window"],
        calls=k8_launch["fused_async_mc=False"].calls["lockstep_mc_window"],
        replaces="gnina_tpu/ops/pallas_dock.py:715",
        max_abs_err=errs["lockstep_mc_window[done_frac]"]))

    # K7: K1's launch with the gradient laid into the coordinate rows; its
    # launches on the main path are K1's (the rescore returns the gradient
    # debug_grad exposes)
    r, t = k1_poses["perturbed"]
    k1 = rows[0]
    rows.append(dict(
        name="debug_grad", shape=f"L={out_lanes}",
        ms=timed(lambda: fd.debug_grad(terms, r, t, scal_r, pack_out), reps),
        plain_ms=timed(lambda: fd.eval_fg_plain(terms, r, t, scal_r,
                                                pack_out), reps),
        bound_ms=k1["bound_ms"], bound_by=k1["bound_by"],
        launches=k1["launches"], calls=k1["calls"],
        replaces="gnina_tpu/ops/pallas_dock.py:960",
        max_abs_err=errs["debug_grad"]))
    rows.extend(probe_rows)
    rows.append(vox_row)
    for row in rows:
        check(row["launches"] > 0, f"{row['name']} not on the main path")
        lib = ("no single PyTorch call computes it"
               if row.get("library_ms") is None else
               f"torch.matmul on the same operands {row['library_ms']:.3f} "
               f"ms")
        share = (f", in-cutoff pair share {row['in_cutoff']:.4f}"
                 if "in_cutoff" in row else "")
        print(f"[6] {row['name']} {row['shape']}: {row['ms']:.3f} ms "
              f"(plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.4f}"
              f" ms by {row['bound_by']}{share}), {row['launches']} launches "
              f"in {row['calls']} calls on its path; {lib}", flush=True)

    print("[6] one window of 128 steps x 16 ticks from the same starts and "
          "seed: " + "; ".join(
              f"{k} completed {v[0]} of {128 * lanes} steps with {v[1]} "
              f"accepted line-search steps" for k, v in window_steps.items()),
          flush=True)

    # ---- 7. where one dock_batch spends the card's time -------------------
    pwall, busy, n_other = trace_dock(
        lambda: eng.dock_batch(rec, ligs, center, size, seed=args.seed + 1))
    total = sum(busy.values())
    if total > 0:
        parts = ", ".join(f"{k} {v:.1f} ms" for k, v in busy.items())
        share = 100 * total / (1e3 * pwall)
        print(f"[7] one dock_batch under torch.profiler: {pwall:.2f} s wall "
              f"(profiled), device busy {total:.1f} ms ({share:.1f}%): "
              f"{parts} ({n_other} launches of other kernels)", flush=True)
    else:
        print("[7] torch.profiler recorded no device activity: device busy "
              "share not measured", flush=True)

    # ---- 8. the general path (no kernel) ----------------------------------
    phase_general(args.seed, GENERAL_STEPS, GENERAL_CLI_STEPS)

    # ---- 9. flex residues, covalent ligands, --outputmin (no kernel) -------
    phase_flex(args.seed, FLEX_STEPS, FLEX_CLI_STEPS)

    # ---- 10. the CNN inside the search (no kernel) -------------------------
    phase_cnn(args.seed, CNN_STEPS, CNN_CLI_STEPS)

    # ---- 11. the tools (K1 under --score_only --cnn_model) -----------------
    phase_tools(args.seed)

    # ---- 12. multi-GPU, training, native perception (K1-K5) ----------------
    phase_multi(args.seed)

    table = {"kernels": [dict(
        name=row["name"], route="cuda",
        source=row.get("source", "gnina_tpu_torch/csrc/fused_dock.cu"),
        replaces=row["replaces"], launches=row["launches"],
        calls=row["calls"],
        max_abs_err=row["max_abs_err"], ms=row["ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=row.get("library_ms"))
        for row in rows]}
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_main:.1f} s", flush=True)
    print(smi)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
