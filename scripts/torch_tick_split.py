"""Split one K3 window of csrc/fused_dock.cu into its phases on the card.

    python scripts/torch_tick_split.py SOURCE.cu

Writes an instrumented copy of SOURCE to gnina_tpu_torch/_build/split/:
thread 0 of every block stamps clock64() at the phase boundaries of a tick
(uniforms, mutation or search direction, FK, the pair loops, the force
reduction, gyration, the BFGS accept work, Metropolis and the stream) into
shared-memory sums and writes them out at the window's end.  Two layouts
are known, and the stamps are chosen from the source: the block-wide
evaluation of the first ports (one __syncthreads() phase after another)
and the warp-0 control whose pair loops run on every warp between two
block barriers (there the pair phase is thread 0's own share).  Then it
runs one window at the main path's shape (L=128, S=128, tick budget 16,
K=2,157, Philox) and prints the window's time, the SM clock and each
phase's share and cycles a tick, averaged over the blocks, with the card's
name and power limit.  Imports no JAX.
"""

import ctypes
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gnina_tpu_torch import _fixtures as fx  # noqa: E402
from gnina_tpu_torch.chem.ingest import box_from_center_size  # noqa: E402
from gnina_tpu_torch.ops import _cuda  # noqa: E402
from gnina_tpu_torch.ops import fused_dock as fd  # noqa: E402
from gnina_tpu_torch.scoring.builtin import get_scoring_function  # noqa: E402

HDR = r'''
__device__ unsigned long long g_split[1024 * 16];
__device__ __forceinline__ void sp_stamp(unsigned long long* acc,
                                         unsigned long long& last, int i) {
  if (threadIdx.x == 0) {
    unsigned long long now = clock64();
    acc[i] += now - last;
    last = now;
  }
}
#define SP(i) sp_stamp(sp_acc, sp_last, i)
'''


def rep(s, old, new):
    if old not in s:
        raise ValueError(f"the source has no {old!r}: another layout")
    return s.replace(old, new, 1)


def instrument_block_wide(s):
    """Stamps for the block-wide evaluation."""
    s = rep(s, "#define NT 256", HDR + "\n#define NT 256")
    # eval_pose gets the accumulators through static shared variables
    s = rep(s, "template <bool DERIV>\n__device__ void eval_pose(",
            "__shared__ unsigned long long sp_acc[16];\n__shared__ unsigned long long sp_last;\n"
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
            "  if (t == 0) { for (int i = 0; i < 16; ++i) sp_acc[i] = 0; sp_last = clock64(); }\n"
            "  for (int tick = 0; tick < t_total")
    s = rep(s, "    draw_uniforms(s, uniforms, tick, L, lane, key);\n    const float* u = s.sc + S_U;\n    float pg",
            "    SP(10);\n    draw_uniforms(s, uniforms, tick, L, lane, key);\n    SP(0);\n    const float* u = s.sc + S_U;\n    float pg")
    s = rep(s, "    eval_pose<true>(s, pk, tm, sv, nh, s.t_rig, s.t_tor, s.gn);\n    const float f1 = s.sc[S_E], fm1 = s.sc[S_MET];\n    const float gy1",
            "    SP(1);\n    eval_pose<true>(s, pk, tm, sv, nh, s.t_rig, s.t_tor, s.gn);\n    const float f1 = s.sc[S_E], fm1 = s.sc[S_MET];\n    SP(7);\n    const float gy1")
    s = rep(s, "    n_eval += 1.0f;\n    bool cdone = false;", "    SP(8);\n    n_eval += 1.0f;\n    bool cdone = false;")
    s = rep(s, "    if (cdone) {\n      // step completion", "    SP(9);\n    if (cdone) {\n      // step completion")
    s = rep(s, "  fk(s, s.c_rig, s.c_tor, pk.N, M, pk.LY);\n  write_pose_out(s, s.c_rig, s.c_tor, lane, pk.N, M, orig, otor, ocoords);\n  if (t == 0) {\n    float* st = stats + (size_t)lane * 8;\n    st[0] = e_cur; st[1] = e_cur; st[2] = n_eval;",
            "  SP(10);\n  if (t == 0) for (int i = 0; i < 16; ++i) g_split[blockIdx.x * 16 + i] = sp_acc[i];\n"
            "  fk(s, s.c_rig, s.c_tor, pk.N, M, pk.LY);\n  write_pose_out(s, s.c_rig, s.c_tor, lane, pk.N, M, orig, otor, ocoords);\n  if (t == 0) {\n    float* st = stats + (size_t)lane * 8;\n    st[0] = e_cur; st[1] = e_cur; st[2] = n_eval;")
    s = rep(s, 'extern "C" {', 'extern "C" {\nint gt_split_read(unsigned long long* h) { return (int)cudaMemcpyFromSymbol(h, g_split, sizeof(g_split)); }')
    return s, ["draw", "mutate|ndir+incr", "fk", "zero", "receptor", "intra",
             "esum", "fk_backward", "gyration", "accept_bfgs", "metro+stream"]


def instrument_warp0(s):
    """Stamps for the warp-0 control with pair loops on every warp."""
    s = rep(s, "#define NT 512", HDR + "\n#define NT 512")
    s = rep(s, "// ------------------------------------------------- barriers and copies ----",
            "__shared__ unsigned long long sp_acc[16];\n__shared__ unsigned long long sp_last;\n// ------------------------------------------------- barriers and copies ----")
    # eval_pose
    s = rep(s, "  const Smem& s = c.s;\n  fk(s, rig, tor, c.pk.N, c.pk.M, c.pk.LY);\n",
            "  const Smem& s = c.s;\n  SP(9);\n  fk(s, rig, tor, c.pk.N, c.pk.M, c.pk.LY);\n")
    s = rep(s, "  if (lane_id() == 0) {\n    s.sc[S_CMD]", "  SP(2);\n  if (lane_id() == 0) {\n    s.sc[S_CMD]")
    s = rep(s, "  __syncwarp();\n  block_bar();\n  pair_phase<DERIV>(s, c.pk, *c.tm, c.sv, c.nh, c.rr);\n  block_bar();\n  finish_eval<DERIV>(s, c.pk, c.sv, c.nh, gout);\n}",
            "  __syncwarp();\n  block_bar();\n  SP(3);\n  pair_phase<DERIV>(s, c.pk, *c.tm, c.sv, c.nh, c.rr);\n  SP(4);\n  block_bar();\n  SP(5);\n  finish_eval<DERIV>(s, c.pk, c.sv, c.nh, gout);\n  SP(6);\n}")
    s = rep(s, "  intra_pairs<DERIV>(s, tm, sv[0], N, nh);\n  for (int j = 0; j < rr.ntiles; ++j) {",
            "  intra_pairs<DERIV>(s, tm, sv[0], N, nh);\n  SP(12);\n  for (int j = 0; j < rr.ntiles; ++j) {")
    # k_async_mc
    s = rep(s, "  const uint2 key = make_uint2(seed, (uint32_t)lane);\n  for (int tick = 0; tick < t_total",
            "  const uint2 key = make_uint2(seed, (uint32_t)lane);\n"
            "  if (threadIdx.x == 0) { for (int i = 0; i < 16; ++i) sp_acc[i] = 0; sp_last = clock64(); }\n"
            "  for (int tick = 0; tick < t_total")
    s = rep(s, "    draw_uniforms(s, uniforms, tick, L, lane, key);\n    const float* u = s.sc + S_U;\n    float pg",
            "    SP(10);\n    draw_uniforms(s, uniforms, tick, L, lane, key);\n    SP(0);\n    const float* u = s.sc + S_U;\n    float pg")
    s = rep(s, "    eval_pose<true>(c, s.t_rig, s.t_tor, s.gn);\n    const float f1 = s.sc[S_E], fm1 = s.sc[S_MET];\n    const float gy1",
            "    SP(1);\n    eval_pose<true>(c, s.t_rig, s.t_tor, s.gn);\n    const float f1 = s.sc[S_E], fm1 = s.sc[S_MET];\n    SP(7);\n    const float gy1")
    s = rep(s, "    n_eval += 1.0f;\n    bool cdone = false;", "    SP(8);\n    n_eval += 1.0f;\n    bool cdone = false;")
    s = rep(s, "    if (cdone) {\n      // step completion", "    SP(9);\n    if (cdone) {\n      // step completion")
    s = rep(s, "  release_workers(s);\n  fk(s, s.c_rig, s.c_tor, pk.N, M, pk.LY);\n  write_pose_out(s, s.c_rig, s.c_tor, lane, pk.N, M, orig, otor, ocoords);\n  if (ln == 0) {\n    float* st = stats + (size_t)lane * 8;\n    st[0] = e_cur; st[1] = e_cur; st[2] = n_eval;",
            "  SP(10);\n  if (threadIdx.x == 0) for (int i = 0; i < 16; ++i) g_split[blockIdx.x * 16 + i] = sp_acc[i];\n"
            "  release_workers(s);\n  fk(s, s.c_rig, s.c_tor, pk.N, M, pk.LY);\n  write_pose_out(s, s.c_rig, s.c_tor, lane, pk.N, M, orig, otor, ocoords);\n  if (ln == 0) {\n    float* st = stats + (size_t)lane * 8;\n    st[0] = e_cur; st[1] = e_cur; st[2] = n_eval;")
    s = rep(s, 'extern "C" {', 'extern "C" {\nint gt_split_read(unsigned long long* h) { return (int)cudaMemcpyFromSymbol(h, g_split, sizeof(g_split)); }')
    return s, ["draw", "mutate|ndir+incr", "fk", "barrier A",
             "pairs: receptor (w0)", "barrier B", "finish+fk_backward",
             "eval tail", "gyration", "accept_bfgs", "metro+stream", "-",
             "pairs: intra (w0)"]


def main(src_path):
    with open(src_path) as f:
        src = f.read()
    instrument = (instrument_warp0 if "worker_loop" in src
                  else instrument_block_wide)
    s, names = instrument(src)
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
            _fields_ = fd._PackArgs._fields_[:-1]
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
    h = np.zeros(1024 * 16, np.uint64)
    if lib.gt_split_read(h.ctypes.data) != 0:
        raise RuntimeError("could not read the stamps")
    h = h.reshape(1024, 16)[:pack.lanes].astype(np.float64)
    ticks = float(out[2][:, 2].sum()) / pack.lanes
    clk = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()[0])
    tot = h.sum(1).mean()
    print(f"K={pack.rec.shape[0]} window {ms:.3f} ms, evaluations a lane "
          f"{ticks:.0f}, SM clock {clk} MHz, cycles a lane {tot:.4g} "
          f"({tot / clk / 1e3:.2f} ms at that clock)")
    for i, nm in enumerate(names):
        if nm == "-":
            continue
        c = h[:, i].mean()
        print(f"  {nm:22s} {100 * c / tot:5.1f}%  {c / ticks:9.0f} cycles a "
              f"tick  {c / ticks / clk:7.2f} us a tick")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        sys.exit(__doc__)
    main(sys.argv[1])
