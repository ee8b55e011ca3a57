"""Split one K3 window and one k_bfgs launch of csrc/fused_dock.cu into
their phases on the card.

    python scripts/torch_tick_split.py SOURCE.cu

Writes an instrumented copy of SOURCE to gnina_tpu_torch/_build/split/:
thread 0 of every block stamps clock64() at the phase boundaries of a tick
(uniforms, mutation or search direction, FK, the pair loops, the force
reduction, gyration, the BFGS accept work, Metropolis and the stream) into
shared-memory sums and writes them out at the launch's end.  Two layouts
are known, and the stamps are chosen from the source: the block-wide
evaluation of the first ports (one __syncthreads() phase after another)
and the warp-0 control whose pair loops run on every warp between two
block barriers (there the pair phase is thread 0's own share).  Then it
runs one window at the main path's shape (L=128, S=128, tick budget 16,
K=2,157, Philox) and prints the window's time, the SM clock and each
phase's share and cycles a tick, averaged over the blocks.

For the warp-0 layout it also stamps k_bfgs (K2) at the main path's two
shapes, the refine (L=128, caps 1000, from perturbed poses) and the finish
(L=800, slope 1e5, from minima): the chain behind the launch's time (the
distribution of evaluations, iterations and accepts a pose from the
kernel's stats rows 2-4, the slowest pose's cycles against the launch,
the trial at which iterations accept, block start and end times on the
global timer) and each phase's us per value and per value+gradient
evaluation.  The card's name and power limit close the output.  Imports no
JAX.
"""

import ctypes
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

from gnina_tpu_torch import _fixtures as fx  # noqa: E402
from gnina_tpu_torch.chem.ingest import box_from_center_size  # noqa: E402
from gnina_tpu_torch.ops import _cuda  # noqa: E402
from gnina_tpu_torch.ops import fused_dock as fd  # noqa: E402
from gnina_tpu_torch.scoring.builtin import get_scoring_function  # noqa: E402

HDR = r'''
__device__ unsigned long long g_split[1024 * 48];
__device__ __forceinline__ void sp_stamp(unsigned long long* acc,
                                         unsigned long long& last, int i) {
  if (threadIdx.x == 0) {
    unsigned long long now = clock64();
    acc[i] += now - last;
    last = now;
  }
}
#define SP(i) sp_stamp(sp_acc, sp_last, i)
#define SPD(i) SP(DERIV ? (i) : (i) + 16)
#define SPN(i) if (threadIdx.x == 0) sp_acc[i] += 1
__device__ __forceinline__ unsigned long long sp_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}
'''


def rep(s, old, new):
    if old not in s:
        raise ValueError(f"the source has no {old!r}: another layout")
    return s.replace(old, new, 1)


def rep_re(s, pattern, fn):
    """The first match of pattern replaced by fn(match)."""
    m = re.search(pattern, s)
    if m is None:
        raise ValueError(f"the source has no {pattern!r}: another layout")
    return s[:m.start()] + fn(m) + s[m.end():]


def rep_first(s, pairs):
    """The first (old, new) whose old is in s, replaced."""
    for old, new in pairs:
        if old in s:
            return s.replace(old, new, 1)
    raise ValueError(f"the source has none of {[p[0] for p in pairs]!r}")


def instrument_block_wide(s):
    """Stamps for the block-wide evaluation."""
    s = rep(s, "#define NT 256", HDR + "\n#define NT 256")
    # eval_pose gets the accumulators through static shared variables
    s = rep(s, "template <bool DERIV>\n__device__ void eval_pose(",
            "__shared__ unsigned long long sp_acc[48];\n__shared__ unsigned long long sp_last;\n"
            "template <bool DERIV>\n__device__ void eval_pose(")
    s = rep(s, "  fk(s, rig, tor, N, M, pk.LY);\n  // rows >= nh",
            "  SP(9);\n  fk(s, rig, tor, N, M, pk.LY);\n  SP(2);\n  // rows >= nh")
    s = rep(s, "  // receptor interactions: warps over atoms", "  SP(3);\n  // receptor interactions: warps over atoms")
    s = rep(s, "  // intra pairs: dense masked", "  SP(4);\n  // intra pairs: dense masked")
    s = rep(s, "  __syncthreads();\n  if (t == 0) {\n    float e = 0.0f, em = 0.0f;",
            "  __syncthreads();\n  SP(5);\n  if (t == 0) {\n    float e = 0.0f, em = 0.0f;")
    s = rep(s, "  if (!DERIV) { __syncthreads(); return; }",
            "  if (!DERIV) { __syncthreads(); SP(6); return; }\n  __syncthreads();\n  SP(6);")
    s = rep(s, "    gout[t] = v * s.dofm[t];\n  }\n  __syncthreads();\n}",
            "    gout[t] = v * s.dofm[t];\n  }\n  __syncthreads();\n  SP(7);\n}")
    # k_async_mc body
    s = rep(s, "  const uint2 key = make_uint2(seed, (uint32_t)lane);\n  for (int tick = 0; tick < t_total",
            "  const uint2 key = make_uint2(seed, (uint32_t)lane);\n"
            "  if (t == 0) { for (int i = 0; i < 48; ++i) sp_acc[i] = 0; sp_last = clock64(); }\n"
            "  for (int tick = 0; tick < t_total")
    s = rep(s, "    draw_uniforms(s, uniforms, tick, L, lane, key);\n    const float* u = s.sc + S_U;\n    float pg",
            "    SP(10);\n    draw_uniforms(s, uniforms, tick, L, lane, key);\n    SP(0);\n    const float* u = s.sc + S_U;\n    float pg")
    s = rep(s, "    eval_pose<true>(s, pk, tm, sv, nh, s.t_rig, s.t_tor, s.gn);\n    const float f1 = s.sc[S_E], fm1 = s.sc[S_MET];\n    const float gy1",
            "    SP(1);\n    eval_pose<true>(s, pk, tm, sv, nh, s.t_rig, s.t_tor, s.gn);\n    const float f1 = s.sc[S_E], fm1 = s.sc[S_MET];\n    SP(7);\n    const float gy1")
    s = rep(s, "    n_eval += 1.0f;\n    bool cdone = false;", "    SP(8);\n    n_eval += 1.0f;\n    bool cdone = false;")
    s = rep(s, "    if (cdone) {\n      // step completion", "    SP(9);\n    if (cdone) {\n      // step completion")
    s = rep(s, "  fk(s, s.c_rig, s.c_tor, pk.N, M, pk.LY);\n  write_pose_out(s, s.c_rig, s.c_tor, lane, pk.N, M, orig, otor, ocoords);\n  if (t == 0) {\n    float* st = stats + (size_t)lane * 8;\n    st[0] = e_cur; st[1] = e_cur; st[2] = n_eval;",
            "  SP(10);\n  if (t == 0) for (int i = 0; i < 48; ++i) g_split[blockIdx.x * 48 + i] = sp_acc[i];\n"
            "  fk(s, s.c_rig, s.c_tor, pk.N, M, pk.LY);\n  write_pose_out(s, s.c_rig, s.c_tor, lane, pk.N, M, orig, otor, ocoords);\n  if (t == 0) {\n    float* st = stats + (size_t)lane * 8;\n    st[0] = e_cur; st[1] = e_cur; st[2] = n_eval;")
    s = rep(s, 'extern "C" {', 'extern "C" {\nint gt_split_read(unsigned long long* h) { return (int)cudaMemcpyFromSymbol(h, g_split, sizeof(g_split)); }')
    return s, ["draw", "mutate|ndir+incr", "fk", "zero", "receptor", "intra",
             "esum", "fk_backward", "gyration", "accept_bfgs", "metro+stream"]


def instrument_warp0(s):
    """Stamps for the warp-0 control with pair loops on every warp."""
    s = rep(s, "#define NT 512", HDR + "\n#define NT 512")
    s = rep(s, "// ------------------------------------------------- barriers and copies ----",
            "__shared__ unsigned long long sp_acc[48];\n__shared__ unsigned long long sp_last;\n// ------------------------------------------------- barriers and copies ----")
    # eval_pose
    s = rep(s, "  const Smem& s = c.s;\n  fk(s, rig, tor, c.pk.N, c.pk.M, c.pk.LY);\n",
            "  const Smem& s = c.s;\n  SPN(DERIV ? 37 : 38);\n  SPD(9);\n"
            "  fk(s, rig, tor, c.pk.N, c.pk.M, c.pk.LY);\n")
    s = rep(s, "  if (lane_id() == 0) {\n    s.sc[S_CMD]", "  SPD(2);\n  if (lane_id() == 0) {\n    s.sc[S_CMD]")
    s = rep_first(s, [
        ("  __syncwarp();\n  block_bar();\n  pair_phase<DERIV>(s, c.pk, *c.tm, c.sv, c.nh, c.rr);\n  block_bar();\n  finish_eval<DERIV>(s, c.pk, c.sv, c.nh, gout);\n}",
         "  __syncwarp();\n  block_bar();\n  SPD(3);\n  pair_phase<DERIV>(s, c.pk, *c.tm, c.sv, c.nh, c.rr);\n  SPD(4);\n  block_bar();\n  SPD(5);\n  finish_eval<DERIV>(s, c.pk, c.sv, c.nh, gout);\n  SPD(6);\n}"),
        # the force reduction spread over the block: a third barrier
        ("  __syncwarp();\n  block_bar();\n  pair_phase<DERIV>(s, c.pk, *c.tm, c.sv, c.nh, c.rr);\n  block_bar();\n  reduce_rows<DERIV>(s, c.pk, c.nh);\n  reduce_bar_sync();\n  finish_eval<DERIV>(s, c.pk, c.sv, c.nh, gout);\n}",
         "  __syncwarp();\n  block_bar();\n  SPD(3);\n  pair_phase<DERIV>(s, c.pk, *c.tm, c.sv, c.nh, c.rr);\n  SPD(4);\n  block_bar();\n  SPD(5);\n  reduce_rows<DERIV>(s, c.pk, c.nh);\n  reduce_bar_sync();\n  SPD(11);\n  finish_eval<DERIV>(s, c.pk, c.sv, c.nh, gout);\n  SPD(6);\n}"),
        # ... for value+gradient evaluations only, node sums per kernel
        ("  __syncwarp();\n  block_bar();\n  pair_phase<DERIV>(s, c.pk, *c.tm, c.sv, c.nh, c.rr);\n  block_bar();\n  if (DERIV) {\n    reduce_rows(s, c.pk, c.nh);\n    reduce_bar_sync();\n  }\n  finish_eval<DERIV, NL>(s, c.pk, c.sv, c.nh, gout);\n}",
         "  __syncwarp();\n  block_bar();\n  SPD(3);\n  pair_phase<DERIV>(s, c.pk, *c.tm, c.sv, c.nh, c.rr);\n  SPD(4);\n  block_bar();\n  SPD(5);\n  if (DERIV) {\n    reduce_rows(s, c.pk, c.nh);\n    reduce_bar_sync();\n  }\n  SPD(11);\n  finish_eval<DERIV, NL>(s, c.pk, c.sv, c.nh, gout);\n  SPD(6);\n}")])
    s = rep_first(s, [(f"  intra_pairs<{t}>(s, tm, sv[0], N, nh);\n", f"  intra_pairs<{t}>(s, tm, sv[0], N, nh);\n  SPD(12);\n")
                      for t in ("DERIV",)])
    s = rep(s, "  if (!DERIV) return;\n", "  SPD(13);\n  if (!DERIV) return;\n")
    # k_async_mc
    s = rep(s, "  const uint2 key = make_uint2(seed, (uint32_t)lane);\n  for (int tick = 0; tick < t_total",
            "  const uint2 key = make_uint2(seed, (uint32_t)lane);\n"
            "  if (threadIdx.x == 0) { for (int i = 0; i < 48; ++i) sp_acc[i] = 0; sp_last = clock64(); }\n"
            "  for (int tick = 0; tick < t_total")
    s = rep(s, "    draw_uniforms(s, uniforms, tick, L, lane, key);\n    const float* u = s.sc + S_U;\n    float pg",
            "    SP(10);\n    draw_uniforms(s, uniforms, tick, L, lane, key);\n    SP(0);\n    const float* u = s.sc + S_U;\n    float pg")
    s = rep_first(s, [(f"    eval_pose<{t}>(c, s.t_rig, s.t_tor, s.gn);\n    const float f1 = s.sc[S_E], fm1 = s.sc[S_MET];\n    const float gy1",
                       f"    SP(1);\n    eval_pose<{t}>(c, s.t_rig, s.t_tor, s.gn);\n    const float f1 = s.sc[S_E], fm1 = s.sc[S_MET];\n    SP(7);\n    const float gy1")
                      for t in ("true", "true, 8")])
    s = rep(s, "    n_eval += 1.0f;\n    bool cdone = false;", "    SP(8);\n    n_eval += 1.0f;\n    bool cdone = false;")
    s = rep(s, "    if (cdone) {\n      // step completion", "    SP(9);\n    if (cdone) {\n      // step completion")
    s = rep(s, "  release_workers(s);\n  fk(s, s.c_rig, s.c_tor, pk.N, M, pk.LY);\n  write_pose_out(s, s.c_rig, s.c_tor, lane, pk.N, M, orig, otor, ocoords);\n  if (ln == 0) {\n    float* st = stats + (size_t)lane * 8;\n    st[0] = e_cur; st[1] = e_cur; st[2] = n_eval;",
            "  SP(10);\n  if (threadIdx.x == 0) for (int i = 0; i < 48; ++i) g_split[blockIdx.x * 48 + i] = sp_acc[i];\n"
            "  release_workers(s);\n  fk(s, s.c_rig, s.c_tor, pk.N, M, pk.LY);\n  write_pose_out(s, s.c_rig, s.c_tor, lane, pk.N, M, orig, otor, ocoords);\n  if (ln == 0) {\n    float* st = stats + (size_t)lane * 8;\n    st[0] = e_cur; st[1] = e_cur; st[2] = n_eval;")
    s = rep(s, 'extern "C" {', 'extern "C" {\nint gt_split_read(unsigned long long* h) { return (int)cudaMemcpyFromSymbol(h, g_split, sizeof(g_split)); }')
    return s, ["draw", "mutate|ndir+incr", "fk", "barrier A",
             "pairs: receptor (w0)", "barrier B", "fk_backward",
             "eval tail", "gyration", "accept_bfgs", "metro+stream",
             "row sums over the block", "pairs: intra (w0)", "row sums+curl"]


def instrument_bfgs(s):
    """Stamps for k_bfgs on top of instrument_warp0's: the search
    direction, the accept work, the launch's start and end on the global
    timer, and counters of the trial at which each iteration accepted."""
    s = rep(s, "  read_pose(rigid0, tors0, lane, M, s.s_rig, s.s_tor);\n"
            "  const GroupSync gs",
            "  if (threadIdx.x == 0) { for (int i = 0; i < 48; ++i) "
            "sp_acc[i] = 0; sp_acc[40] = sp_gtime(); sp_acc[42] = sp_entry; "
            "sp_last = clock64(); }\n"
            "  read_pose(rigid0, tors0, lane, M, s.s_rig, s.s_tor);\n"
            "  const GroupSync gs")
    # the block's entry (before the pack and the receptor are staged) and
    # its very end, on the global timer
    s = rep_re(s, r"k_bfgs\((?:.|\n)*?\) \{\n", lambda m: m.group(0)
               + "  const unsigned long long sp_entry = sp_gtime();\n")
    s = rep(s, "    st[5] = res.g_iters;\n  }\n}",
            "    st[5] = res.g_iters;\n  }\n  if (threadIdx.x == 0) "
            "g_split[blockIdx.x * 48 + 43] = sp_gtime();\n}")
    end = ("  release_workers(s);\n  fk(s, s.x_rig, s.x_tor, pk.N, M, pk.LY);\n"
           "  write_pose_out(s, s.x_rig, s.x_tor, lane, pk.N, M, orig, otor, "
           "ocoords);")
    s = rep(s, end, "  SP(10);\n  if (threadIdx.x == 0) { sp_acc[41] = sp_gtime(); "
            "for (int i = 0; i < 48; ++i) g_split[blockIdx.x * 48 + i] = "
            "sp_acc[i]; }\n" + end)
    # the BFGS loops' own lines, at whatever indentation the source has
    for tail in (r"if \(pg >= 0\.0f\) \{", r"const float alpha"):
        s = rep_re(s, r"\n( +)neg_hdot\(s\.h, s\.g, s\.dofm, s\.p, D\);\n"
                   r"\1const float pg = warp_dot\(s\.p, s\.g, D\);\n\1"
                   + tail, lambda m: m.group(0).replace(
                       "\n" + m.group(1) + m.group(0).split("\n")[-1].strip(),
                       "\n" + m.group(1) + "SP(14);\n" + m.group(1)
                       + m.group(0).split("\n")[-1].strip()))
    for tail in (r"if \(conv\) fin = 1;", r"tl = 0\.0f;"):
        s = rep_re(s, r"\n( +)f0 = f1;\n\1met = fm1;\n\1" + tail,
                   lambda m: m.group(0) + "\n" + m.group(1) + "SP(15);")
    s = rep_first(s, [
        ("{ accepted = true; break; }",
         "{ accepted = true; SPN(32 + min(tr, 2)); break; }"),
        ("            accepted = true;\n            if (grad) break;",
         "            accepted = true; SPN(32 + min(tr, 2));\n"
         "            if (grad) break;")])
    s = rep(s, "fin = 2;                           // stuck: no step can follow",
            "fin = 2; SPN(35);")
    s = rep(s, "fin = 1;                             // no descent direction",
            "fin = 1; SPN(36);")
    return s


BFGS_PHASES = ((14, "search direction"), (9, "before an evaluation"),
               (2, "fk"), (3, "barrier A"), (12, "pairs: intra (w0)"),
               (4, "pairs: receptor (w0)"), (5, "barrier B"),
               (11, "row sums over the block"), (13, "row sums+curl"),
               (6, "fk_backward"), (15, "accept work"), (10, "tail"))


def split_bfgs(lib, terms, dev, clk):
    """Stamp k_bfgs at the refine (L=128) and finish (L=800) shapes of the
    main path and print the chain behind its time."""
    import torch_kernel_ab as ab

    lig, pack, lo, hi, _ = ab.system(20.0, 40.0, dev)
    num_out = max(ab.DockSettings().num_modes,
                  ab.DockSettings().num_mc_saved)
    pack_out = pack.with_lanes(torch.arange(
        16, device=dev, dtype=torch.int32).repeat_interleave(num_out))
    scal_h = fd.scal_vector(10.0, 10.0, 1e3, 1000.0, lo, hi, 2.0, 1.2,
                            device=dev)
    scal_r = fd.scal_vector(1000.0, 1000.0, 1e3, 1000.0, lo, hi, device=dev)
    scal_s = fd.scal_vector(1000.0, 1000.0, 1e5, 1000.0, lo, hi, device=dev)
    miniters = max(int((25 + lig.num_atoms) / 3), 1)
    rng = np.random.default_rng(0)
    rp, tp = fx.packed_poses(rng, pack.lanes, lo, hi, lig, 4, dev,
                             "perturbed")
    rf, tf = fx.packed_poses(rng, pack_out.lanes, lo, hi, lig, 4, dev,
                             "random")
    rf, tf = fd.bfgs_minimize(terms, rf, tf, scal_h, pack_out, miniters)[:2]
    rf, tf = fd.bfgs_minimize(terms, rf, tf, scal_r, pack_out, miniters)[:2]
    for label, pk, r, t, sc, wm in (("refine", pack, rp, tp, scal_r, True),
                                    ("finish", pack_out, rf, tf, scal_s,
                                     False)):
        run = lambda: fd.bfgs_minimize(terms, r, t, sc, pk, miniters, wm)
        run()
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = run()
        ev1.record()
        torch.cuda.synchronize()
        ms = ev0.elapsed_time(ev1)
        h = np.zeros(1024 * 48, np.uint64)
        if lib.gt_split_read(h.ctypes.data) != 0:
            raise RuntimeError("could not read the stamps")
        h = h.reshape(1024, 48)[:pk.lanes].astype(np.float64)
        st = out[2].double().cpu().numpy()
        n_acc, n_it = st[:, 4], st[:, 3]
        # the kernel's own evaluations (value+gradient, value-only)
        n_grad, n_val = h[:, 37], h[:, 38]
        evals = n_grad + n_val
        cyc = h[:, :32].sum(1)
        slow = int(np.argmax(cyc))
        t0, t1 = h[:, 40], h[:, 41]
        starts = np.sort(t0 - t0.min()) / 1e3
        q = lambda x: "/".join(f"{v:.0f}" for v in np.percentile(
            x, [0, 50, 90, 100]))
        print(f"k_bfgs {label} L={pk.lanes} maxiters {miniters}: launch "
              f"{ms:.3f} ms; per pose (min/median/p90/max) evaluations "
              f"{q(evals)}, iterations {q(n_it)}, accepts {q(n_acc)}; "
              f"the slowest pose (by cycles) {cyc[slow] / clk / 1e3:.3f} ms "
              f"at {clk:.0f} MHz with {evals[slow]:.0f} evaluations, "
              f"{n_it[slow]:.0f} iterations, {n_acc[slow]:.0f} accepts; the "
              f"pose with most evaluations {evals.max():.0f}; corr(cycles, "
              f"evaluations) {np.corrcoef(cyc, evals)[0, 1]:.3f}")
        acc = h[:, 32:37].sum(0)
        nd, nv = n_grad.sum(), n_val.sum()
        print(f"  evaluations {nd:.0f} with the gradient, {nv:.0f} "
              f"value-only; iterations {n_it.sum():.0f}: accepted at trial 0 "
              f"{acc[0]:.0f} ({100 * acc[0] / max(n_it.sum(), 1):.1f}%), at "
              f"trial 1 {acc[1]:.0f}, later {acc[2]:.0f}, out of trials "
              f"{acc[3]:.0f}; poses without a descent direction {acc[4]:.0f}")
        t_in, t_out = h[:, 42], h[:, 43]
        print(f"  block entry to its first iteration (pack and receptor "
              f"staged, the first evaluation's set-up) median "
              f"{np.median(t0 - t_in) / 1e3:.1f} us; the end stamp to the "
              f"block's exit median {np.median(t_out - t1) / 1e3:.1f} us; "
              f"first entry to last exit {(t_out.max() - t_in.min()) / 1e3:.1f}"
              f" us of the launch's {1e3 * ms:.1f} us")
        print(f"  blocks start over {starts[-1]:.1f} us (global timer; "
              f"{int((starts > 5).sum())} start more than 5 us after the "
              f"first), the longest block {(t1 - t0).max() / 1e3:.1f} us, the "
              f"median {np.median(t1 - t0) / 1e3:.1f} us, first start to "
              f"last end {(t1.max() - t0.min()) / 1e3:.1f} us")
        tot = cyc.sum()
        for i, nm in BFGS_PHASES:
            c_d, c_v = h[:, i].sum(), h[:, i + 16].sum() if i < 16 else 0.0
            print(f"  {nm:24s} {100 * (c_d + c_v) / tot:5.1f}%  value+grad "
                  f"{c_d / nd / clk:7.2f} us  value {c_v / max(nv, 1) / clk:7.2f}"
                  f" us an evaluation")


def main(src_path):
    with open(src_path) as f:
        src = f.read()
    warp0 = "worker_loop" in src
    s, names = (instrument_warp0 if warp0 else instrument_block_wide)(src)
    if warp0:
        s = instrument_bfgs(s)
    out_dir = os.path.join(_cuda.BUILD_DIR, "split")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "split.cu")
    with open(cu, "w") as f:
        f.write(s)
    so = os.path.join(out_dir, "libsplit.so")
    t0 = time.time()
    r = subprocess.run([_cuda._nvcc()] + _cuda.NVCC_FLAGS + ["-o", so, cu],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(r.stderr)
    print(f"built {src_path} with stamps in {time.time() - t0:.1f} s")
    lib = ctypes.CDLL(os.path.abspath(so))
    _cuda._bind_fused(lib)
    lib.gt_split_read.argtypes = [ctypes.c_void_p]
    _cuda._LIBS["fused_dock"] = lib
    if "rec_tile" not in src:          # the argument block before the plan
        class Old(ctypes.Structure):
            _fields_ = [f for f in fd._PackArgs._fields_
                        if f[0] != "rec_tile"]
        new_args = fd._pack_args

        def old_args(pack, device):
            a, b = Old(), new_args(pack, device)
            for f, _ in Old._fields_:
                setattr(a, f, getattr(b, f))
            return a
        fd._pack_args = old_args

    dev = torch.device("cuda")
    rec, lig, center, size = fx.system(seed=0, box=20.0)
    sf = get_scoring_function("vina")
    terms = fd.extract_vina_terms(sf)
    pruned = rec.pruned(np.asarray(center), np.asarray(size) / 2,
                        margin=sf.cutoff)
    lo, hi = box_from_center_size(center, size)
    pack = fd.build_pack([lig] * 16, pruned.coords, pruned.types,
                         np.ones(len(pruned.types), np.float32), 8, sf.table,
                         m_pad=4, device=dev)
    scal_h = fd.scal_vector(10.0, 10.0, 1e3, 1000.0, lo, hi, 2.0, 1.2,
                            device=dev)
    miniters = max(int((25 + lig.num_atoms) / 3), 1)
    r, t = fx.packed_poses(np.random.default_rng(0), pack.lanes, lo, hi, lig,
                           4, dev, "random")
    ecur = torch.full((pack.lanes,), 3.0e38, device=dev)
    run = lambda: fd.async_mc_window(terms, r, t, scal_h, pack, ecur, 128,
                                     16, miniters, seed=2)
    run()
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    out = run()
    ev1.record()
    torch.cuda.synchronize()
    ms = ev0.elapsed_time(ev1)
    h = np.zeros(1024 * 48, np.uint64)
    if lib.gt_split_read(h.ctypes.data) != 0:
        raise RuntimeError("could not read the stamps")
    h = h.reshape(1024, 48)[:pack.lanes].astype(np.float64)
    ticks = float(out[2][:, 2].sum()) / pack.lanes
    clk = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0])
    tot = h[:, :32].sum(1).mean()
    print(f"K={pack.rec.shape[0]} window {ms:.3f} ms, evaluations a lane "
          f"{ticks:.0f}, SM clock {clk} MHz, cycles a lane {tot:.4g} "
          f"({tot / clk / 1e3:.2f} ms at that clock)")
    for i, nm in enumerate(names):
        if nm == "-":
            continue
        c = h[:, i].mean()
        print(f"  {nm:22s} {100 * c / tot:5.1f}%  {c / ticks:9.0f} cycles a "
              f"tick  {c / ticks / clk:7.2f} us a tick")
    if warp0:
        split_bfgs(lib, terms, dev, clk)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        sys.exit(__doc__)
    main(sys.argv[1])
