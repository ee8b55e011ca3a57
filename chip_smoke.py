#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Builds csrc/fused_dock.cu from this checkout (nvcc, sm_90a), holds each of
its three kernels against its plain PyTorch version at the main path's
shapes, docks 16 copies of the minout.sdf ligand x exhaustiveness 8 (128
chains, 1024 MC steps) through DockingEngine.dock_batch on the card, and
times every kernel.  The receptor is synthetic, made from --seed: heavy
atoms at protein density on a jittered lattice around the ligand with a
cavity carved at its centre, read through Receptor.from_file.

A last phase traces one more dock_batch with torch.profiler and splits
the card's busy time by kernel.

Phases print one line each; any failed check exits non-zero.  The line
before the last is the kernel table as JSON, the one before it the card's
`nvidia-smi` name and power limit, and the last line is
{"ok": true, "device": {...}}.  Without a card, or without the rest of the
repository beside it, the script exits non-zero and prints no result.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

FP32_PEAK = 67e12       # H100 SXM FP32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12      # H100 SXM HBM3, bytes/s
# FP32 operations per (heavy ligand atom, receptor atom) pair and
# evaluation, counted from eval_pose in csrc/fused_dock.cu: the distance
# test every pair pays, and the vina terms (2 gauss, repulsion,
# hydrophobic, h-bond) of a pair inside the cutoff with and without the
# derivative (each exp counted as one operation).
OPS_PAIR_TEST = 9
OPS_PAIR_VALUE = 46
OPS_PAIR_DERIV = 72

LIGANDS, EXHAUSTIVENESS, MC_STEPS = 16, 8, 1024


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
    kernel, launches of kernels other than the port's three).  Kernels run
    on one stream, so their durations add up to the device's busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (("k_async_mc", "async_mc_window"), ("k_bfgs", "bfgs_minimize"),
             ("k_eval_fg", "eval_fg"))
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


def compare_k2(fd, terms, r, t, sc, pk, iters, wm, rtol, atol):
    """K2 against its plain version from the same starts.  A lane whose two
    versions made the same numbers of Armijo trials and accepted steps
    took the same path and is held to (rtol, atol).  Any other lane had an
    Armijo test decided the other way (a flip); at most 1% of lanes may,
    and at one iteration each flip must be explained by the K1 bound: the
    Armijo margin at the deciding trial, recomputed by the plain version,
    lies within the K1 error of the two energies it compares.  Returns
    (max |de| over same-path lanes, flipped lanes)."""
    import torch

    got = fd.bfgs_minimize(terms, r, t, sc, pk, iters, wm)
    torch.cuda.synchronize()
    ref = fd.bfgs_minimize_plain(terms, r, t, sc, pk, iters, wm)
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


def bound_ms(ops, nbytes):
    return max(ops / FP32_PEAK, nbytes / HBM_RATE) * 1e3, \
        "operations" if ops / FP32_PEAK >= nbytes / HBM_RATE else "bytes"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

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
    so = _cuda.build(verbose=True)
    _cuda.lib()
    build_s = time.perf_counter() - t0
    print(f"[1] device {kind} | {smi} | kernels built in {build_s:.1f} s "
          f"({os.path.basename(so)})", flush=True)

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

    # ---- 5. the main path end to end ---------------------------------------
    settings = DockSettings(cnn_scoring="none", num_mc_steps=MC_STEPS,
                            exhaustiveness=EXHAUSTIVENESS)
    eng = DockingEngine(settings)           # device=None: the card
    check(eng.device.type == "cuda", "default device is not the card")
    eng.dock_batch(rec, ligs, center, size, seed=args.seed)     # warm
    torch.cuda.synchronize()
    for k in fd.KERNELS:
        k.reset()
    t0 = time.perf_counter()
    results = eng.dock_batch(rec, ligs, center, size, seed=args.seed + 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in fd.KERNELS}
    by_lanes = {k.name: dict(k.launches_by_lanes) for k in fd.KERNELS}
    check(launches["async_mc_window"] == MC_STEPS // 128,
          f"K3 launches {launches['async_mc_window']}")
    check(launches["bfgs_minimize"] == 2 * (MC_STEPS // 128) + 5,
          f"K2 launches {launches['bfgs_minimize']}")
    check(launches["eval_fg"] == 1, f"K1 launches {launches['eval_fg']}")
    check(len(results) == LIGANDS and all(results), "missing poses")
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
    worst = 0.0
    for res in results:
        conf = Conf(*[torch.as_tensor(np.stack([getattr(p, f) for p in res]),
                                      device=dev)
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
        e = [p.energy for p in res]
        check(e == sorted(e), "poses not sorted by energy")
        for i in range(len(res)):
            for j in range(i):
                d = np.sqrt(((res[i].coords[heavy] - res[j].coords[heavy])
                             ** 2).sum(1).mean())
                check(d > settings.out_min_rmsd, "poses closer than "
                      "out_min_rmsd")
    best = min(r_[0].energy for r_ in results)
    counts = [len(r_) for r_ in results]
    print(f"[5] dock_batch {LIGANDS} ligands x {EXHAUSTIVENESS} chains, "
          f"{MC_STEPS} steps: {wall:.2f} s, {LIGANDS / wall:.3f} lig/s, "
          f"best {best:.3f} kcal/mol, poses per ligand {counts}, launches "
          f"{launches} {by_lanes}; energies vs plain rescore max |de| "
          f"{worst:.2e}", flush=True)

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
                     replaces="gnina_tpu/ops/pallas_dock.py:677",
                     max_abs_err=errs["eval_fg"]))

    # K2 at both main-path shapes, from the starts phase 3 compared on
    for label, pk, nl, sc, wm in (
            ("refine", pack, lanes, scal_r, True),
            ("finish", pack_out, out_lanes, scal_s, False)):
        r, t = k2_starts[label]
        ms = timed(lambda: fd.bfgs_minimize(terms, r, t, sc, pk, miniters,
                                            wm), reps)
        pms = timed(lambda: fd.bfgs_minimize_plain(terms, r, t, sc, pk,
                                                   miniters, wm), reps)
        out = fd.bfgs_minimize(terms, r, t, sc, pk, miniters, wm)
        li = pk.lane_lig.long()
        frac = in_cutoff_fraction(out[3], pk, li, cut2)
        stats = out[2]
        # the least work of the function: a value for each rejected Armijo
        # trial, a value and gradient for the start and each accepted one
        ops = kernel_ops(stats[:, 2] - stats[:, 4], 1 + stats[:, 4], pk, li,
                         frac)
        nbytes = pack_bytes(pk, nl, m) + nl * 4 * (8 + 3 * pack.dims[0])
        bms, bby = bound_ms(ops, nbytes)
        rows.append(dict(name=f"bfgs_minimize/{label}", shape=f"L={nl}",
                         ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                         launches=by_lanes["bfgs_minimize"].get(nl, 0),
                         replaces="gnina_tpu/ops/pallas_dock.py:722",
                         max_abs_err=errs[f"bfgs_minimize/{label}"]))

    # K3: one window of the main path (S=128, tick budget 16)
    r, t = fx.packed_poses(rng, lanes, lo, hi, lig, m, dev, "random")
    ecur = torch.full((lanes,), 3.0e38, device=dev)
    run3 = lambda: fd.async_mc_window(terms, r, t, scal_h, pack, ecur, 128,
                                      16, miniters, seed=args.seed + 2)
    ms = timed(run3, reps)
    gen = torch.Generator(device=dev)
    pms = timed(lambda: fd.async_mc_window_plain(
        terms, r, t, scal_h, pack, ecur, 128, 16, miniters,
        generator=gen.manual_seed(args.seed + 2)), reps)
    out = run3()
    frac = in_cutoff_fraction(out[3], pack, pack.lane_lig.long(), cut2)
    # the least work of the function: a value and gradient for each
    # candidate's mutated start (stats row 4, completed steps) and each
    # accepted Armijo trial (row 3); a value for every other tick (row 2)
    grads = out[2][:, 4] + out[2][:, 3]
    ops = kernel_ops(torch.clamp(out[2][:, 2] - grads, min=0), grads, pack,
                     pack.lane_lig.long(), frac)
    nbytes = pack_bytes(pack, lanes, m) + lanes * 4 * (
        8 + 3 * pack.dims[0] + 128 * (8 + m + 3))
    bms, bby = bound_ms(ops, nbytes)
    rows.append(dict(name="async_mc_window", shape=f"L={lanes} S=128 b=16",
                     ms=ms, plain_ms=pms, bound_ms=bms, bound_by=bby,
                     launches=launches["async_mc_window"],
                     replaces="gnina_tpu/ops/pallas_dock.py:1124",
                     max_abs_err=errs["async_mc_window"]))
    for row in rows:
        check(row["launches"] > 0, f"{row['name']} not on the main path")
        print(f"[6] {row['name']} {row['shape']}: {row['ms']:.3f} ms "
              f"(plain {row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f}"
              f" ms by {row['bound_by']}), {row['launches']} launches per "
              f"dock_batch; no single PyTorch call computes it", flush=True)

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

    table = {"kernels": [dict(
        name=row["name"], route="cuda",
        source="gnina_tpu_torch/csrc/fused_dock.cu",
        replaces=row["replaces"], launches=row["launches"],
        max_abs_err=row["max_abs_err"], ms=row["ms"],
        plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
        bound_by=row["bound_by"], library_ms=None) for row in rows]}
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
