// Fused docking kernels for Hopper (sm_90a): one thread block per pose.
//
// Replaces the JAX package's Pallas kernel gnina_tpu/ops/pallas_dock.py
// make_bfgs_kernel (:288, pallas_call :1379) in every mode of the fused
// docking route:
//   gt_eval_fg          K1: fused value + DOF gradient (eval_fg :677 =
//                       fk :362 + energy :474 + fk_backward :613); its
//                       gradient output is what the debug_grad mode (K7,
//                       :960) dumps
//   gt_bfgs_minimize    K2: truncated BFGS per pose (bfgs_run_lockstep :722)
//                       K4: the same with async_ls (bfgs_run_async :860): one
//                       value+gradient per Armijo trial, no second gradient
//                       evaluation after an accept
//   gt_async_mc_window  K3: per-pose in-kernel Monte Carlo (amc_body :1124,
//                       mutate :1038, rand_sphere :1009, gyration :1026)
//                       K6: the same with warm_ls (:1150): the Armijo
//                       exponent starts one notch above the last accepted
//   gt_lockstep_mc_window  K5: step-indexed in-kernel Monte Carlo (mc_body
//                       :1290): every step runs one whole BFGS, no tick
//                       budget
//   done_frac < 1       K8: the group stop of both BFGS loops (:715-720, read
//                       at :733 and :869): 128 consecutive poses form a
//                       group, and the loop of every pose in it ends at the
//                       iteration (or tick) at which done_frac of the group
//                       reads done.  A mode of gt_bfgs_minimize and
//                       gt_lockstep_mc_window (see GroupSync below)
// The plain PyTorch versions in gnina_tpu_torch/ops/fused_dock.py compute
// the same functions step for step.
//
// What bounds it: every energy evaluation is a pair loop of (heavy ligand
// atoms x receptor atoms) with two exp() per pair inside the 8 A cutoff,
// i.e. FP32 arithmetic and transcendental throughput, and a distance test
// for every pair.  One block per pose keeps the whole control loop (BFGS,
// line search, MC state machine) inside the block, so poses never wait for
// each other (the TPU's lockstep lanes are gone).  The design for Hopper:
//  - The receptor (32 B per atom) is staged into shared memory by TMA bulk
//    copies completed on an mbarrier: once per launch when it fits (K up to
//    6,144 atoms, 192 KB), else streamed through a ring of two tiles per
//    evaluation (the plan is the wrapper's, fused_dock.smem_plan).
//  - The pair loop spreads (heavy atom x receptor atom) pairs over all
//    warps: a lane holds one receptor atom in registers and runs the
//    distance test against every heavy atom, a warp compacts the pairs
//    inside the cutoff into a queue in shared memory (ballot and popc, in
//    atom order), and the pair terms run on full warps.  A segmented sum
//    over each atom's run of lanes (shuffles) adds the batch into the
//    warp's per-atom sums, and the warps' sums are added in a fixed
//    order, so two launches give the same bits.  Every pair is still
//    tested (no cell list).  The intra-ligand pairs are spread over all
//    threads the same way.
//  - The per-atom sums over the warps' rows of a value+gradient evaluation
//    run on every thread after the pair loop.  Everything else (FK, the
//    force reduction up the tree, the BFGS vectors, Philox, mutation,
//    gyration, Metropolis, the energy sums) runs on warp 0 with
//    __syncwarp() and warp reductions; the other warps wait at a named
//    barrier and join only the pair loop and the sums.  A block has 16
//    warps.  Each kernel is built for the pose blocks an SM of MINB_*
//    below, timed per kernel (PERF.md); k_bfgs is built for one (128
//    registers) and for two (64), each faster at its own shape
//    (bfgs_kernel).  The K8 modes are instances of their own, so the
//    uncoupled kernels carry no K8 code.  An evaluation costs two block
//    barriers, and a value+gradient one a third that only warp 0 waits at
//    (one more per receptor tile beyond the second when the receptor
//    streams).
// What bounds it then: the pair loop's distance tests and pair terms
// (latency with one block per SM), and warp 0's serial control
// between evaluations.
//
// Built without --use_fast_math: __expf/__sinf would move the gauss terms
// and torsion rotations beyond the plain version's tolerances.

#include <cuda_runtime.h>
#include <stdint.h>

#define NT 512              // threads a pose block: 16 warps
#define MAXWARPS (NT / 32)  // virtual warps of the pair loops
#define QCAP 64             // queue entries per warp (pairs inside the cutoff)
#define EPS_FL 1.1920929e-07f
#define C0 1e-4f
#define N_DRAWS 13
#define PI_F 3.14159265358979f
#define GROUP 128           // poses per done_frac group (the TPU block's lanes)
#define REC_OFFSET 128      // bytes before the receptor: the two mbarriers
#define FULL 0xffffffffu

// Pose blocks an SM each kernel is built for (__launch_bounds__' minimum):
// 1 lets a thread hold 128 registers, 2 holds it to 64 so that two blocks
// share an SM where the lanes outnumber the SMs and the shared memory
// allows.  Chosen per kernel with scripts/torch_kernel_ab.py, whose source
// arguments may set them (PATH.cu:MINB_EVAL=1,...) to time the other one;
// k_bfgs is built for both (bfgs_kernel).
#ifndef MINB_EVAL
#define MINB_EVAL 2
#endif
#ifndef MINB_ASYNC_MC
#define MINB_ASYNC_MC 1
#endif
#ifndef MINB_LOCKSTEP_MC
#define MINB_LOCKSTEP_MC 1
#endif

struct PackArgs {
  const float* lc;       // (G, N, 3)
  const float* ap;       // (G, N, 6) radius, phi, don, acc, heavy, 0
  const int* node;       // (G, N)
  const int* parent;     // (G, M)
  const int* layer;      // (G, M)
  const float* relax;    // (G, M, 3)
  const float* relo;     // (G, M, 3)
  const float* imask;    // (G, N, N)
  const float* dofmask;  // (G, D)
  const int* nheavy;     // (G,)
  const float* rec;      // (K, 8) x y z radius | phi don acc mask
  const int* lane_lig;   // (L,)
  int L, N, M, LY, K, D;
  int rec_tile;          // receptor atoms a tile; >= K: resident
};

struct TermArgs {
  int ng, nr, nh, nb;
  float g_off[4], g_width[4], g_w[4];
  float r_off[2], r_w[2];
  float h_good[2], h_bad[2], h_w[2];
  float b_good[2], b_bad[2], b_w[2];
  float cutoff_sqr;
};

// The term parameters with the reciprocals each pair would compute (the
// same float32 divisions, made once a launch); the hydrophobic and
// h-bond ramps in one list (hydrophobic first)
struct Terms {
  TermArgs a;
  float g_inv[4];
  float hb_bad[4], hb_w[4], hb_inv[4];
};

__device__ inline Terms make_terms(const TermArgs& a) {
  Terms t;
  t.a = a;
  for (int i = 0; i < 4; ++i) t.g_inv[i] = 1.0f / a.g_width[i];
  for (int i = 0; i < 4; ++i) {
    const bool hyd = i < a.nh;
    const int j = hyd ? i : i - a.nh;
    if (i >= a.nh + a.nb) {
      t.hb_bad[i] = t.hb_w[i] = t.hb_inv[i] = 0.0f;
      continue;
    }
    const float good = hyd ? a.h_good[j] : a.b_good[j];
    t.hb_bad[i] = hyd ? a.h_bad[j] : a.b_bad[j];
    t.hb_w[i] = hyd ? a.h_w[j] : a.b_w[j];
    t.hb_inv[i] = 1.0f / (good - t.hb_bad[i]);
  }
  return t;
}

// scalar slots in shared memory
enum {
  S_E = 0, S_MET, S_YY, S_YP, S_GSQ, S_CMD,
  S_U = 16,               // 13 uniforms
  S_COUNT = 32
};
// what warp 0 asks of the other warps at the barrier (S_CMD)
enum { CMD_VALUE = 0, CMD_DERIV = 1, CMD_EXIT = 2 };

struct Smem {
  float *lc, *ap, *relax, *relo, *imask, *dofm;
  int *node, *parent, *layer;
  float *chh, *shh, *fq, *fo, *axl;
  float4* cl4;              // (N) heavy atoms clamped to the box
  float* red;               // (N, 8) per-atom sums over the warps' rows:
                            // e, g (3), intra e, intra g (3)
  float *coords, *gatom, *part, *pin;
  float *F, *Tq;
  float *h, *g, *gn, *p, *y, *mhy;
  float *x_rig, *x_tor, *t_rig, *t_tor, *c_rig, *c_tor, *s_rig, *s_tor;
  float *sc;
  int* queue;               // (MAXWARPS, QCAP)
  const float4* rec;        // receptor rows (2 float4 an atom): all K, or
                            // two tiles of rec_tile atoms
  uint32_t bar;             // shared address of the two mbarriers
};

__host__ __device__ inline int smem_floats(int N, int M, int D) {
  return N * 4                                       // clamped atoms
         + N * 8                                     // per-atom sums
         + N * 3 + N * 6 + M * 3 + M * 3 + N * N + D  // pack
         + N + M + M                                 // ints
         + M + M + M * 4 + M * 3 + M * 3             // frames
         + N * 3 + N * 3                             // atoms
         + 2 * MAXWARPS * N * 4                      // per-warp pair sums
         + M * 3 + M * 3                             // node F, T
         + D * D + 5 * D                             // BFGS
         + 4 * (8 + M)                               // pose states
         + S_COUNT;
}

__host__ __device__ inline bool rec_resident(int K, int rec_tile) {
  return rec_tile >= K;
}

__host__ __device__ inline size_t rec_bytes(int K, int rec_tile) {
  return rec_resident(K, rec_tile) ? (size_t)K * 32 : (size_t)rec_tile * 64;
}

// dynamic shared memory of a block: mbarriers, receptor, pose state, queues
__host__ __device__ inline size_t smem_bytes(int N, int M, int D, int K,
                                             int rec_tile) {
  return REC_OFFSET + rec_bytes(K, rec_tile) + 4 * (size_t)smem_floats(N, M, D)
         + 4 * (size_t)(MAXWARPS * QCAP);
}

__device__ inline Smem carve(unsigned char* base, const PackArgs& pk) {
  const int N = pk.N, M = pk.M, D = pk.D;
  Smem s;
  s.bar = (uint32_t)__cvta_generic_to_shared(base);
  s.rec = reinterpret_cast<const float4*>(base + REC_OFFSET);
  float* q = reinterpret_cast<float*>(base + REC_OFFSET
                                      + rec_bytes(pk.K, pk.rec_tile));
  auto take = [&](int n) { float* r = q; q += n; return r; };
  s.cl4 = reinterpret_cast<float4*>(take(N * 4));   // 16-byte aligned
  s.red = take(N * 8);                               // 16-byte aligned
  s.lc = take(N * 3); s.ap = take(N * 6); s.relax = take(M * 3);
  s.relo = take(M * 3); s.imask = take(N * N); s.dofm = take(D);
  s.node = reinterpret_cast<int*>(take(N));
  s.parent = reinterpret_cast<int*>(take(M));
  s.layer = reinterpret_cast<int*>(take(M));
  s.chh = take(M); s.shh = take(M); s.fq = take(M * 4); s.fo = take(M * 3);
  s.axl = take(M * 3);
  s.coords = take(N * 3); s.gatom = take(N * 3);
  s.part = take(MAXWARPS * N * 4);
  s.pin = take(MAXWARPS * N * 4);
  s.F = take(M * 3); s.Tq = take(M * 3);
  s.h = take(D * D); s.g = take(D); s.gn = take(D); s.p = take(D);
  s.y = take(D); s.mhy = take(D);
  s.x_rig = take(8); s.x_tor = take(M); s.t_rig = take(8); s.t_tor = take(M);
  s.c_rig = take(8); s.c_tor = take(M);
  s.s_rig = take(8); s.s_tor = take(M);
  s.sc = take(S_COUNT);
  s.queue = reinterpret_cast<int*>(q);
  return s;
}

// every thread of the block
__device__ inline void load_pack(const Smem& s, const PackArgs& pk, int lig) {
  const int N = pk.N, M = pk.M, D = pk.D, t = threadIdx.x, NB = blockDim.x;
  for (int i = t; i < N * 3; i += NB) s.lc[i] = pk.lc[(size_t)lig * N * 3 + i];
  for (int i = t; i < N * 6; i += NB) s.ap[i] = pk.ap[(size_t)lig * N * 6 + i];
  for (int i = t; i < N * N; i += NB)
    s.imask[i] = pk.imask[(size_t)lig * N * N + i];
  for (int i = t; i < N; i += NB) s.node[i] = pk.node[(size_t)lig * N + i];
  for (int i = t; i < M; i += NB) {
    s.parent[i] = pk.parent[(size_t)lig * M + i];
    s.layer[i] = pk.layer[(size_t)lig * M + i];
  }
  for (int i = t; i < M * 3; i += NB) {
    s.relax[i] = pk.relax[(size_t)lig * M * 3 + i];
    s.relo[i] = pk.relo[(size_t)lig * M * 3 + i];
  }
  for (int i = t; i < D; i += NB) s.dofm[i] = pk.dofmask[(size_t)lig * D + i];
}

// ------------------------------------------------- barriers and copies ----

// the block barrier between warp 0 and the other warps, which reach it from
// different places in the code
__device__ __forceinline__ void block_bar() {
  asm volatile("barrier.sync 1, %0;\n" ::"r"(blockDim.x) : "memory");
}

// the per-atom sums of an evaluation (named barrier 2): the other warps
// arrive once their share is written and go on to the next evaluation's
// barrier; warp 0 waits for them
__device__ __forceinline__ void reduce_bar_arrive() {
  asm volatile("barrier.arrive 2, %0;\n" ::"r"(blockDim.x) : "memory");
}

__device__ __forceinline__ void reduce_bar_sync() {
  asm volatile("barrier.sync 2, %0;\n" ::"r"(blockDim.x) : "memory");
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// (a copy that never lands ends the launch with an error, not a hang)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok = 0;
  for (long spins = 0; !ok; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    if (spins > (1L << 26)) __trap();
  }
}

// one thread: copy `bytes` (a multiple of 16) from global src to shared dst
// by TMA, completing on the mbarrier
__device__ __forceinline__ void tma_load(uint32_t bar, const void* dst,
                                         const void* src, uint32_t bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(d), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The receptor in shared memory.  Resident: one copy at the launch's start.
// Streamed: tiles of rec_tile atoms through two buffers; warp 0 starts
// tiles 0 and 1 before each evaluation's pair loop, which waits for each
// tile, and starts tile j + 2 into the buffer of tile j once every warp is
// done with it.  `phase` holds each buffer's mbarrier parity (each thread
// keeps its own copy: every thread waits on every tile).
struct RecRing {
  int K, tile, ntiles;
  uint32_t phase;
};

// every thread of the block: the mbarriers, and the resident copy
__device__ inline RecRing stage_receptor(const Smem& s, const PackArgs& pk) {
  RecRing rr;
  rr.K = pk.K;
  rr.tile = rec_resident(pk.K, pk.rec_tile) ? pk.K : pk.rec_tile;
  rr.ntiles = rr.tile > 0 ? (pk.K + rr.tile - 1) / rr.tile : 0;
  rr.phase = 0;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(s.bar)
                 : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(s.bar + 8)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (rr.ntiles == 1) {
    if (threadIdx.x == 0)
      tma_load(s.bar, s.rec, pk.rec, (uint32_t)pk.K * 32u);
    mbar_wait(s.bar, 0);
    rr.phase ^= 1u;
  }
  return rr;
}

// warp 0, lane 0: start tile j into buffer j & 1 (streamed receptor)
__device__ inline void start_tile(const Smem& s, const PackArgs& pk,
                                  const RecRing& rr, int j) {
  const int k0 = j * rr.tile;
  const int n = min(rr.tile, rr.K - k0);
  tma_load(s.bar + 8u * (uint32_t)(j & 1), s.rec + (size_t)(j & 1) * rr.tile * 2,
           pk.rec + (size_t)k0 * 8, (uint32_t)n * 32u);
}

// ---------------------------------------------------------------- math ----

__device__ __forceinline__ float norm_angle(float x) {
  return x - (2.0f * PI_F) * rintf(x * (0.5f / PI_F));
}

__device__ __forceinline__ void qmul(const float* a, const float* b, float* o) {
  float w = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  float x = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  float y = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  float z = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
  o[0] = w; o[1] = x; o[2] = y; o[3] = z;
}

// v' = v + 2 q_v x (q_v x v + q_w v)
__device__ __forceinline__ void qrotate(const float* q, const float* v, float* o) {
  float tx = q[2] * v[2] - q[3] * v[1] + q[0] * v[0];
  float ty = q[3] * v[0] - q[1] * v[2] + q[0] * v[1];
  float tz = q[1] * v[1] - q[2] * v[0] + q[0] * v[2];
  o[0] = v[0] + 2.0f * (q[2] * tz - q[3] * ty);
  o[1] = v[1] + 2.0f * (q[3] * tx - q[1] * tz);
  o[2] = v[2] + 2.0f * (q[1] * ty - q[2] * tx);
}

// quaternion.h:242-257: normalize only when off unit by >= 1e-6
__device__ __forceinline__ void qnormalize_approx(float* q) {
  float s = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  if (fabsf(s - 1.0f) >= 1e-6f) {
    float sc = rsqrtf(fmaxf(s, EPS_FL));
    q[0] *= sc; q[1] *= sc; q[2] *= sc; q[3] *= sc;
  }
}

// Taylor-safe rotation vector -> quaternion (quaternion.cu:32-43)
__device__ __forceinline__ void rotvec_quat(float rx, float ry, float rz, float* q) {
  float a2 = rx * rx + ry * ry + rz * rz;
  float a = sqrtf(fmaxf(a2, 1e-30f));
  float half = 0.5f * a;
  float sinc = (a < 1e-6f) ? 0.5f - a2 * (1.0f / 48.0f) : sinf(half) / a;
  q[0] = cosf(half); q[1] = sinc * rx; q[2] = sinc * ry; q[3] = sinc * rz;
}

__device__ __forceinline__ float sgnf(float x) {
  return (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : 0.0f);
}

// sum over the warp; every lane gets the same bits (each butterfly step adds
// the same two values in either order)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// warp 0: a . b over D, as a warp reduction
__device__ __forceinline__ float warp_dot(const float* a, const float* b,
                                          int D) {
  float acc = 0.0f;
  for (int i = lane_id(); i < D; i += 32) acc += a[i] * b[i];
  return warp_sum(acc);
}

// |(dx, dy, dz)|^2: the one expression a pair's test and its terms use
__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return dx * dx + dy * dy + dz * dz;
}

// Vina-family energy (and d/dd) at surface distance d.  The energy's
// products and sums are written out as rounded intrinsics: the gaussian's
// product also feeds the derivative, and left to nvcc it is fused into the
// sum in one instance and not in the other.  So a value-only evaluation and
// a value+gradient one give the same energy bits (a lockstep Armijo trial
// evaluated with its gradient needs no second pass when accepted), and
// every kernel's energies are K1's (chip_smoke.py holds K2's descent
// against K1's start energy).  Pinning the pair test too cost K2 10%.
template <bool DERIV>
__device__ __forceinline__ void pair_terms(const Terms& tm, float d,
                                           float fac_hyd, float fac_hb,
                                           float& e, float& de) {
  e = 0.0f; de = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= tm.a.ng) break;
    float dd = (d - tm.a.g_off[i]) * tm.g_inv[i];
    float gv = expf(-__fmul_rn(dd, dd));
    e = __fmaf_rn(tm.a.g_w[i], gv, e);
    if (DERIV) de += tm.a.g_w[i] * gv * (-2.0f * tm.g_inv[i]) * dd;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (i >= tm.a.nr) break;
    float dd = d - tm.a.r_off[i];
    if (dd < 0.0f) {
      e = __fmaf_rn(tm.a.r_w[i], __fmul_rn(dd, dd), e);
      if (DERIV) de += tm.a.r_w[i] * (2.0f * dd);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= tm.a.nh + tm.a.nb) break;
    float fac = i < tm.a.nh ? fac_hyd : fac_hb;
    float frac = (d - tm.hb_bad[i]) * tm.hb_inv[i];
    e = __fmaf_rn(__fmul_rn(tm.hb_w[i], fac), fminf(fmaxf(frac, 0.0f), 1.0f),
                  e);
    if (DERIV && frac > 0.0f && frac < 1.0f) de += tm.hb_w[i] * fac * tm.hb_inv[i];
  }
}

// ------------------------------------------------------------ K1 core ----

// Warp 0: layered forward kinematics over the tree: node frames, then all N
// atom rows (padding rows sit at node 0's origin).
__device__ void fk(const Smem& s, const float* rig, const float* tor, int N,
                   int M, int LY) {
  const int ln = lane_id();
  for (int t = ln; t < M; t += 32) {
    for (int c = 0; c < 4; ++c) s.fq[t * 4 + c] = (t == 0) ? rig[3 + c] : (c == 0 ? 1.0f : 0.0f);
    for (int c = 0; c < 3; ++c) {
      s.fo[t * 3 + c] = (t == 0) ? rig[c] : 0.0f;
      s.axl[t * 3 + c] = 0.0f;
    }
    float half = 0.5f * norm_angle(tor[t]);
    s.chh[t] = cosf(half);
    s.shh[t] = sinf(half);
  }
  __syncwarp();
  for (int l = 1; l <= LY; ++l) {
    for (int t = ln; t < M; t += 32) {
      if (s.layer[t] != l) continue;
      int p = s.parent[t];
      const float* pq = s.fq + p * 4;
      float o[3], ax[3];
      qrotate(pq, s.relo + t * 3, o);
      qrotate(pq, s.relax + t * 3, ax);
      float tq[4] = {s.chh[t], s.shh[t] * ax[0], s.shh[t] * ax[1], s.shh[t] * ax[2]};
      float nq[4];
      qmul(tq, pq, nq);
      qnormalize_approx(nq);
      for (int c = 0; c < 3; ++c) {
        s.fo[t * 3 + c] = s.fo[p * 3 + c] + o[c];
        s.axl[t * 3 + c] = ax[c];
      }
      for (int c = 0; c < 4; ++c) s.fq[t * 4 + c] = nq[c];
    }
    __syncwarp();
  }
  for (int a = ln; a < N; a += 32) {
    int m = s.node[a];
    float r[3];
    qrotate(s.fq + m * 4, s.lc + a * 3, r);
    for (int c = 0; c < 3; ++c) s.coords[a * 3 + c] = s.fo[m * 3 + c] + r[c];
  }
  __syncwarp();
}

// Every lane of a warp: lanes with the same key a (sorted, so a key's
// lanes form one run; -1 for none) add their (e, gx, gy, gz) in lane order
// by shuffles, and the run's last lane adds the sums into dst[a * 4 ..].
// `last` is the last lane holding a key.
template <bool DERIV>
__device__ __forceinline__ void run_sums(int a, float e, float gx, float gy,
                                         float gz, int last, float* dst) {
  const int ln = lane_id();
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int ua = __shfl_up_sync(FULL, a, d);
    const float ue = __shfl_up_sync(FULL, e, d);
    float ux = 0.0f, uy = 0.0f, uz = 0.0f;
    if (DERIV) {
      ux = __shfl_up_sync(FULL, gx, d);
      uy = __shfl_up_sync(FULL, gy, d);
      uz = __shfl_up_sync(FULL, gz, d);
    }
    if (ln >= d && ua == a) {
      e += ue;
      if (DERIV) { gx += ux; gy += uy; gz += uz; }
    }
  }
  const int next = __shfl_down_sync(FULL, a, 1);
  if (a >= 0 && (ln == last || next != a)) {
    float* p = dst + a * 4;
    p[0] += e;
    if (DERIV) { p[1] += gx; p[2] += gy; p[3] += gz; }
  }
  __syncwarp();
}

// Every warp: the queued pairs q[0..n) (atom << 16 | receptor row of rb,
// sorted by atom) through the pair terms, one a lane, then run_sums into
// the virtual warp's row of per-atom sums (e, gx, gy, gz).  A run's atom
// appears once in a batch, so no two lanes add to one atom at once.
template <bool DERIV>
__device__ __forceinline__ void flush_pairs(
    const Terms& tm, const float4* __restrict__ cl4,
    const float* __restrict__ ap, const float4* __restrict__ rb,
    float* __restrict__ part, const int* __restrict__ q, int n) {
  const int ln = lane_id();
  int a = -1;
  float e = 0.0f, gx = 0.0f, gy = 0.0f, gz = 0.0f;
  if (ln < n) {
    const int ent = q[ln];
    a = ent >> 16;
    const int k = ent & 0xffff;
    const float4 c = cl4[a];
    const float4 r0 = rb[2 * k], r1 = rb[2 * k + 1];
    const float dx = c.x - r0.x, dy = c.y - r0.y, dz = c.z - r0.z;
    const float r2 = dist2(dx, dy, dz);
    if (r1.w > 0.0f) {
      const float* p = ap + a * 6;
      float r2c = fmaxf(r2, 1e-12f);
      float rinv = rsqrtf(r2c);
      float d = r2c * rinv - (p[0] + r0.w);
      float fac_hb = fminf(p[2] * r1.z + p[3] * r1.y, 1.0f);
      float pde;
      pair_terms<DERIV>(tm, d, p[1] * r1.x, fac_hb, e, pde);
      if (DERIV) {
        float gr = pde * rinv;
        gx = gr * dx; gy = gr * dy; gz = gr * dz;
      }
    }
  }
  run_sums<DERIV>(a, e, gx, gy, gz, n - 1, part);
}

// Every warp, for one of its virtual warps vw: vw's share of the receptor
// pairs of one tile (kt atoms in rb) for every heavy atom, added into vw's
// row of per-atom sums (part).  Lane l holds receptor atom vw * 32 + l +
// 512 i in registers and
// tests it against the clamped positions of 32 heavy atoms at a time (cl4,
// broadcast from shared memory) into a bit mask; then, atom by atom over
// the atoms some lane hit, the warp compacts its pairs into the queue q in
// atom order (ballot and popc), which runs 32 at a time, and the rest at the
// end of the receptor step, through flush_pairs.
template <bool DERIV>
__device__ void rec_tile_pairs(const Terms& tm, const float4* __restrict__ cl4,
                               const float* __restrict__ ap,
                               int* __restrict__ q, float* __restrict__ part,
                               int nh, const float4* __restrict__ rb, int kt,
                               int vw) {
  const int ln = lane_id();
  const unsigned lt = (1u << ln) - 1u;
  const float cut = tm.a.cutoff_sqr;
  for (int k0 = vw * 32; k0 < kt; k0 += NT) {
    const int k = k0 + ln;
    const bool real = k < kt;
    const float4 r0 = real ? rb[2 * k] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int cnt = 0;
    for (int a0 = 0; a0 < nh; a0 += 32) {
      const int na = min(32, nh - a0);
      unsigned hits = 0u;
#pragma unroll 8
      for (int j = 0; j < na; ++j) {
        const float4 c = cl4[a0 + j];
        const float dx = c.x - r0.x, dy = c.y - r0.y, dz = c.z - r0.z;
        hits |= (dist2(dx, dy, dz) < cut ? 1u : 0u) << j;
      }
      if (!real) hits = 0u;
      unsigned any = __reduce_or_sync(FULL, hits);
      while (any) {
        const int j = __ffs(any) - 1;
        any &= any - 1u;
        const bool hit = (hits >> j) & 1u;
        const unsigned m = __ballot_sync(FULL, hit);
        if (hit) q[cnt + __popc(m & lt)] = ((a0 + j) << 16) | k;
        cnt += __popc(m);
        if (cnt >= 32) {
          __syncwarp();
          flush_pairs<DERIV>(tm, cl4, ap, rb, part, q, 32);
          const int rest = cnt - 32;
          const int moved = ln < rest ? q[32 + ln] : 0;
          __syncwarp();
          if (ln < rest) q[ln] = moved;
          __syncwarp();
          cnt = rest;
        }
      }
    }
    if (cnt > 0) {
      __syncwarp();
      flush_pairs<DERIV>(tm, cl4, ap, rb, part, q, cnt);
    }
  }
}

// Every warp: the intra-ligand pairs (a, b), a dense masked nh x nh block
// with per-pair curl at v_intra, one pair a lane (pair p = a * nh + b, lane
// p mod 32 of virtual warp (p / 32) mod 16), then run_sums over each row's
// lanes into the virtual warp's row of per-atom intra sums (pin: energy,
// gradient)
template <bool DERIV>
__device__ void intra_pairs(const Smem& s, const Terms& tm, float v_intra,
                            int N, int nh) {
  const int ln = lane_id();
  for (int vw = threadIdx.x >> 5; vw < MAXWARPS; vw += blockDim.x >> 5) {
    float* pin = s.pin + (size_t)vw * N * 4;
    for (int p0 = vw * 32; p0 < nh * nh; p0 += NT) {
      const int p = p0 + ln;
      int a = -1;
      float er = 0.0f, g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
      if (p < nh * nh) {
        a = p / nh;
        const int b = p - a * nh;
        if (s.imask[a * N + b] > 0.0f) {
          const float dx = s.coords[a * 3] - s.coords[b * 3],
                      dy = s.coords[a * 3 + 1] - s.coords[b * 3 + 1],
                      dz = s.coords[a * 3 + 2] - s.coords[b * 3 + 2];
          const float r2 = dist2(dx, dy, dz);
          if (r2 < tm.a.cutoff_sqr) {
            const float* pa = s.ap + a * 6;
            const float* pb = s.ap + b * 6;
            const float r2c = fmaxf(r2, 1e-12f);
            const float rinv = rsqrtf(r2c);
            const float d = r2c * rinv - (pa[0] + pb[0]);
            const float fac_hb = fminf(pa[2] * pb[3] + pa[3] * pb[2], 1.0f);
            float pe, pde;
            pair_terms<DERIV>(tm, d, pa[1] * pb[1], fac_hb, pe, pde);
            const float tmp = v_intra / fmaxf(v_intra + fmaxf(pe, 0.0f), EPS_FL);
            if (pe > 0.0f) { pe = __fmul_rn(pe, tmp); pde *= tmp * tmp; }
            er = pe;
            if (DERIV) {
              const float gr = pde * rinv;
              g0 = gr * dx; g1 = gr * dy; g2 = gr * dz;
            }
          }
        }
      }
      run_sums<DERIV>(a, er, g0, g1, g2, 31, pin);
    }
  }
}

// Every thread, between the first two block barriers of an evaluation: the
// intra pairs, then the receptor pairs tile by tile.  The work is cut into 16
// virtual warps, each with its own rows of sums, so that the order of every
// sum is fixed by the work and not by the block (a block of 8 warps would
// run two virtual warps a warp and give the same bits).
template <bool DERIV>
__device__ void pair_phase(const Smem& s, const PackArgs& pk, const Terms& tm,
                           const float* sv, int nh, RecRing& rr) {
  const int warp = threadIdx.x >> 5, ln = lane_id(), N = pk.N;
  const int nw = blockDim.x >> 5;
  for (int vw = warp; vw < MAXWARPS; vw += nw) {
    float* part = s.part + (size_t)vw * N * 4;
    float* pin = s.pin + (size_t)vw * N * 4;
    for (int i = ln; i < nh * 4; i += 32) { part[i] = 0.0f; pin[i] = 0.0f; }
  }
  __syncwarp();
  intra_pairs<DERIV>(s, tm, sv[0], N, nh);
  for (int j = 0; j < rr.ntiles; ++j) {
    const int b = j & 1;
    if (rr.ntiles > 1) {
      mbar_wait(s.bar + 8u * (uint32_t)b, (rr.phase >> b) & 1u);
      rr.phase ^= 1u << b;
    }
    for (int vw = warp; vw < MAXWARPS; vw += nw)
      rec_tile_pairs<DERIV>(tm, s.cl4, s.ap, s.queue + warp * QCAP,
                            s.part + (size_t)vw * N * 4, nh,
                            s.rec + (size_t)b * rr.tile * 2,
                            min(rr.tile, rr.K - j * rr.tile), vw);
    if (j + 2 < rr.ntiles) {
      block_bar();                       // every warp is done with buffer b
      if (threadIdx.x == 0) start_tile(s, pk, rr, j + 2);
    }
  }
}

// Every thread, after the pair phase of a value+gradient evaluation: the
// per-atom sums over the 16 virtual warps' rows, in row order (one (atom,
// component) a thread), into s.red: e, g, intra e, intra g.  A value-only
// evaluation's two sums a row stay on warp 0 (finish_eval), in the same
// order: spread over the block they cost K2 3% (PERF.md).
__device__ void reduce_rows(const Smem& s, const PackArgs& pk, int nh) {
  const int N = pk.N;
  for (int i = threadIdx.x; i < nh * 8; i += blockDim.x) {
    const int a = i / 8, comp = i % 8;
    const float* src = (comp < 4 ? s.part : s.pin) + a * 4 + (comp & 3);
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < MAXWARPS; ++w) v += src[(size_t)w * N * 4];
    s.red[a * 8 + comp] = v;
  }
}

// Warp 0, after reduce_rows (DERIV) or the pair phase: the per-atom curl
// at v_inter (curl.h:37-42) and its Metropolis twin at v_metro, the slope
// penalty, sc[S_E] and sc[S_MET]; with DERIV the atom gradients and
// fk_backward (tree.h:374-393): per-node force and torque about the node's
// own origin, passed to parents deepest layer first, into gout (D).  The
// node sums run on NL lanes a node: 8 (each over every 8th atom, then
// summed across the 8) in the MC kernels and K1, 1 in k_bfgs, each the
// faster there (PERF.md); the two orders give different gradient bits.
template <bool DERIV, int NL>
__device__ void finish_eval(const Smem& s, const PackArgs& pk, const float* sv,
                            int nh, float* gout) {
  const int ln = lane_id(), M = pk.M;
  const float v_inter = sv[1], slope = sv[2], v_metro = sv[3];
  float esum = 0.0f, emsum = 0.0f;
  for (int a = ln; a < nh; a += 32) {
    float4 r0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), r1 = r0;
    if (DERIV) {
      r0 = *reinterpret_cast<const float4*>(s.red + a * 8);
      r1 = *reinterpret_cast<const float4*>(s.red + a * 8 + 4);
    } else {
#pragma unroll
      for (int w = 0; w < MAXWARPS; ++w) {
        r0.x += s.part[(size_t)w * pk.N * 4 + a * 4];
        r1.x += s.pin[(size_t)w * pk.N * 4 + a * 4];
      }
    }
    const float e = r0.x, ei = r1.x;
    const float cx = s.coords[a * 3], cy = s.coords[a * 3 + 1],
                cz = s.coords[a * 3 + 2];
    const float ax_ = fminf(fmaxf(cx, sv[4]), sv[7]);
    const float ay_ = fminf(fmaxf(cy, sv[5]), sv[8]);
    const float az_ = fminf(fmaxf(cz, sv[6]), sv[9]);
    const float oob = fabsf(cx - ax_) + fabsf(cy - ay_) + fabsf(cz - az_);
    const bool cap = e > 0.0f;
    const float tmp = v_inter / fmaxf(v_inter + fmaxf(e, 0.0f), EPS_FL);
    const float tmpm = v_metro / fmaxf(v_metro + fmaxf(e, 0.0f), EPS_FL);
    const float soob = __fmul_rn(slope, oob);
    esum = __fadd_rn(esum, __fadd_rn(__fadd_rn(cap ? __fmul_rn(e, tmp) : e,
                                               soob),
                                     __fmul_rn(0.5f, ei)));
    emsum = __fadd_rn(emsum, __fadd_rn(cap ? __fmul_rn(e, tmpm) : e, soob));
    if (DERIV) {
      const float gsc = cap ? tmp * tmp : 1.0f;
      s.gatom[a * 3] = r0.y * gsc * (cx == ax_ ? 1.0f : 0.0f)
                       + slope * sgnf(cx - ax_) + r1.y;
      s.gatom[a * 3 + 1] = r0.z * gsc * (cy == ay_ ? 1.0f : 0.0f)
                           + slope * sgnf(cy - ay_) + r1.z;
      s.gatom[a * 3 + 2] = r0.w * gsc * (cz == az_ ? 1.0f : 0.0f)
                           + slope * sgnf(cz - az_) + r1.w;
    }
  }
  esum = warp_sum(esum);
  emsum = warp_sum(emsum);
  if (ln == 0) { s.sc[S_E] = esum; s.sc[S_MET] = emsum; }
  __syncwarp();
  if (!DERIV) return;
  if (NL == 8) {
    for (int t0 = 0; t0 < M; t0 += 4) {
      const int t = t0 + (ln >> 3), sub = ln & 7;
      float F[3] = {0, 0, 0}, T[3] = {0, 0, 0};
      if (t < M) {
        const float* o = s.fo + t * 3;
        for (int a = sub; a < nh; a += 8) {
          if (s.node[a] != t) continue;
          const float* g = s.gatom + a * 3;
          float rx = s.coords[a * 3] - o[0], ry = s.coords[a * 3 + 1] - o[1],
                rz = s.coords[a * 3 + 2] - o[2];
          F[0] += g[0]; F[1] += g[1]; F[2] += g[2];
          T[0] += ry * g[2] - rz * g[1];
          T[1] += rz * g[0] - rx * g[2];
          T[2] += rx * g[1] - ry * g[0];
        }
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          F[c] += __shfl_xor_sync(FULL, F[c], o);
          T[c] += __shfl_xor_sync(FULL, T[c], o);
        }
      if (t < M && sub == 0)
        for (int c = 0; c < 3; ++c) { s.F[t * 3 + c] = F[c]; s.Tq[t * 3 + c] = T[c]; }
    }
  } else {
    for (int t = ln; t < M; t += 32) {
      float F[3] = {0, 0, 0}, T[3] = {0, 0, 0};
      const float* o = s.fo + t * 3;
      for (int a = 0; a < nh; ++a) {
        if (s.node[a] != t) continue;
        const float* g = s.gatom + a * 3;
        float rx = s.coords[a * 3] - o[0], ry = s.coords[a * 3 + 1] - o[1],
              rz = s.coords[a * 3 + 2] - o[2];
        F[0] += g[0]; F[1] += g[1]; F[2] += g[2];
        T[0] += ry * g[2] - rz * g[1];
        T[1] += rz * g[0] - rx * g[2];
        T[2] += rx * g[1] - ry * g[0];
      }
      for (int c = 0; c < 3; ++c) { s.F[t * 3 + c] = F[c]; s.Tq[t * 3 + c] = T[c]; }
    }
  }
  __syncwarp();
  for (int l = pk.LY; l >= 1; --l) {
    for (int t = ln; t < M; t += 32) {
      float F[3] = {0, 0, 0}, T[3] = {0, 0, 0};
      const float* op = s.fo + t * 3;
      bool any = false;
      for (int c = 0; c < M; ++c) {
        if (s.layer[c] != l || s.parent[c] != t) continue;
        any = true;
        const float* fc = s.F + c * 3;
        const float* tc = s.Tq + c * 3;
        float dx = s.fo[c * 3] - op[0], dy = s.fo[c * 3 + 1] - op[1],
              dz = s.fo[c * 3 + 2] - op[2];
        F[0] += fc[0]; F[1] += fc[1]; F[2] += fc[2];
        T[0] += tc[0] + (dy * fc[2] - dz * fc[1]);
        T[1] += tc[1] + (dz * fc[0] - dx * fc[2]);
        T[2] += tc[2] + (dx * fc[1] - dy * fc[0]);
      }
      if (any)
        for (int c = 0; c < 3; ++c) { s.F[t * 3 + c] += F[c]; s.Tq[t * 3 + c] += T[c]; }
    }
    __syncwarp();
  }
  for (int t = ln; t < pk.D; t += 32) {
    float v;
    if (t < 3) v = s.F[t];
    else if (t < 6) v = s.Tq[t - 3];
    else {
      int m = t - 5;
      v = s.axl[m * 3] * s.Tq[m * 3] + s.axl[m * 3 + 1] * s.Tq[m * 3 + 1]
          + s.axl[m * 3 + 2] * s.Tq[m * 3 + 2];
    }
    gout[t] = v * s.dofm[t];
  }
  __syncwarp();
}

// The per-launch context every device function below takes
struct Ctx {
  Smem s;
  PackArgs pk;
  const Terms* tm;       // in shared memory
  const float* sv;       // scal (12), in shared memory
  int nh;
  RecRing rr;
};

__shared__ Terms sh_terms;
__shared__ float sh_sv[12];

// Warp 0: fused value (+ DOF gradient into gout) of the pose (rig, tor).
// Writes sc[S_E] (energy), sc[S_MET] (Metropolis twin: the same raw
// per-atom receptor sums capped at v_metro); leaves the pose's coords in
// s.coords.  The other warps join at the block barriers (worker_loop).
template <bool DERIV, int NL>
__device__ __forceinline__ void eval_pose(Ctx& c, const float* rig,
                                          const float* tor,
                          float* gout) {
  const Smem& s = c.s;
  fk(s, rig, tor, c.pk.N, c.pk.M, c.pk.LY);
  for (int a = lane_id(); a < c.nh; a += 32)
    s.cl4[a] = make_float4(fminf(fmaxf(s.coords[a * 3], c.sv[4]), c.sv[7]),
                           fminf(fmaxf(s.coords[a * 3 + 1], c.sv[5]), c.sv[8]),
                           fminf(fmaxf(s.coords[a * 3 + 2], c.sv[6]), c.sv[9]),
                           0.0f);
  if (lane_id() == 0) {
    s.sc[S_CMD] = DERIV ? (float)CMD_DERIV : (float)CMD_VALUE;
    if (c.rr.ntiles > 1) {
      start_tile(s, c.pk, c.rr, 0);
      start_tile(s, c.pk, c.rr, 1);
    }
  }
  __syncwarp();
  block_bar();
  pair_phase<DERIV>(s, c.pk, *c.tm, c.sv, c.nh, c.rr);
  block_bar();
  if (DERIV) {
    reduce_rows(s, c.pk, c.nh);
    reduce_bar_sync();
  }
  finish_eval<DERIV, NL>(s, c.pk, c.sv, c.nh, gout);
}

// Warps 1 on: the pair phase and the per-atom sums of every evaluation warp
// 0 asks for, until it says exit
template <bool DERIV>
__device__ void worker_eval(Ctx& c) {
  pair_phase<DERIV>(c.s, c.pk, *c.tm, c.sv, c.nh, c.rr);
  block_bar();
  if (DERIV) {
    reduce_rows(c.s, c.pk, c.nh);
    reduce_bar_arrive();
  }
}

__device__ void worker_loop(Ctx& c) {
  for (;;) {
    block_bar();
    const float cmd = c.s.sc[S_CMD];
    if (cmd == (float)CMD_EXIT) return;
    if (cmd == (float)CMD_DERIV)
      worker_eval<true>(c);
    else
      worker_eval<false>(c);
  }
}

// Warp 0: let the other warps go
__device__ void release_workers(const Smem& s) {
  if (lane_id() == 0) s.sc[S_CMD] = (float)CMD_EXIT;
  __syncwarp();
  block_bar();
}

// Every thread: the launch's context for the pose of `lig` (pack, terms,
// scalars, the receptor staged; the __syncthreads in stage_receptor
// publishes the terms and scalars)
__device__ inline void setup(Ctx& c, unsigned char* smem, const PackArgs& pk,
                             const TermArgs& ta, const float* scal, int lig) {
  c.pk = pk;
  c.s = carve(smem, pk);
  if (threadIdx.x == 0) sh_terms = make_terms(ta);
  if (threadIdx.x < 12) sh_sv[threadIdx.x] = scal[threadIdx.x];
  c.tm = &sh_terms;
  c.sv = sh_sv;
  c.nh = pk.nheavy[lig];
  load_pack(c.s, pk, lig);
  c.rr = stage_receptor(c.s, pk);
}

// --------------------------------------------------------- BFGS pieces ----
// All on warp 0.

// conf.h:113-118: pos += a p[:3]; quat = rotvec(a p[3:6]) * quat;
// tors = normalize(tors + normalize(a p[6:]))
__device__ void increment(const float* rig, const float* tor, const float* p,
                          float alpha, float* orig, float* otor, int M) {
  const int ln = lane_id();
  if (ln == 0) {
    float dq[4], q[4];
    rotvec_quat(alpha * p[3], alpha * p[4], alpha * p[5], dq);
    qmul(dq, rig + 3, q);
    qnormalize_approx(q);
    for (int c = 0; c < 3; ++c) orig[c] = rig[c] + alpha * p[c];
    for (int c = 0; c < 4; ++c) orig[3 + c] = q[c];
    orig[7] = 0.0f;
  }
  for (int t = ln; t < M; t += 32) {
    float dt = (t == 0) ? 0.0f : alpha * p[5 + t];
    otor[t] = norm_angle(tor[t] + norm_angle(dt));
  }
  __syncwarp();
}

// out[i] = -(H v)[i] * mask[i] (mask may be null)
__device__ void neg_hdot(const float* h, const float* v, const float* mask,
                         float* out, int D) {
  for (int t = lane_id(); t < D; t += 32) {
    float acc = 0.0f;
    for (int e = 0; e < D; ++e) acc += h[t * D + e] * v[e];
    out[t] = mask ? -acc * mask[t] : -acc;
  }
  __syncwarp();
}

__device__ void set_eye(float* h, float scale, int D) {
  for (int i = lane_id(); i < D * D; i += 32)
    h[i] = (i / D == i % D) ? scale : 0.0f;
  __syncwarp();
}

// y = gn - g; sc[S_YY] = y.y, sc[S_YP] = y.p, sc[S_GSQ] = gn.gn
__device__ void diff_stats(const Smem& s, int D) {
  for (int i = lane_id(); i < D; i += 32) s.y[i] = s.gn[i] - s.g[i];
  __syncwarp();
  const float yy = warp_dot(s.y, s.y, D), yp = warp_dot(s.y, s.p, D),
              gsq = warp_dot(s.gn, s.gn, D);
  if (lane_id() == 0) { s.sc[S_YY] = yy; s.sc[S_YP] = yp; s.sc[S_GSQ] = gsq; }
  __syncwarp();
}

// first-step Hessian scaling (bfgs.h:481-486), NaN-proofed
__device__ void first_scale(const Smem& s, float alpha, int D) {
  float yy = s.sc[S_YY], yp = s.sc[S_YP];
  float scale = (fabsf(yy) > EPS_FL) ? alpha * yp / fmaxf(yy, EPS_FL) : 1.0f;
  if (!(scale == scale)) scale = 1.0f;
  set_eye(s.h, scale, D);
}

// bfgs_update (bfgs.h:52-66) with the current H, p, y
__device__ void bfgs_update(const Smem& s, float alpha, int D) {
  neg_hdot(s.h, s.y, nullptr, s.mhy, D);
  const float yhy = -warp_dot(s.y, s.mhy, D);
  const float yp = s.sc[S_YP];
  float r = 1.0f / fmaxf(alpha * yp, EPS_FL);
  float coef1 = alpha * r;
  float coef2 = alpha * alpha * (r * r * yhy + r);
  for (int i = lane_id(); i < D * D; i += 32) {
    int a = i / D, b = i % D;
    s.h[i] += coef1 * (s.mhy[a] * s.p[b] + s.p[a] * s.mhy[b])
              + coef2 * (s.p[a] * s.p[b]);
  }
  __syncwarp();
}

__device__ void copy_pose(const float* rig, const float* tor, float* orig,
                          float* otor, int M) {
  const int ln = lane_id();
  if (ln < 8) orig[ln] = rig[ln];
  for (int t = ln; t < M; t += 32) otor[t] = tor[t];
  __syncwarp();
}

__device__ void copy_vec(const float* a, float* b, int D) {
  for (int i = lane_id(); i < D; i += 32) b[i] = a[i];
  __syncwarp();
}

__device__ void write_pose_out(const Smem& s, const float* rig, const float* tor,
                               int lane, int N, int M, float* orig, float* otor,
                               float* ocoords) {
  const int ln = lane_id();
  if (ln < 8) orig[(size_t)lane * 8 + ln] = rig[ln];
  for (int t = ln; t < M; t += 32) otor[(size_t)lane * M + t] = tor[t];
  for (int i = ln; i < N * 3; i += 32) ocoords[(size_t)lane * N * 3 + i] = s.coords[i];
}

// warp 0: the pose (rig (8), tor (M)) of `lane` from global memory
__device__ void read_pose(const float* rigid, const float* tors, int lane,
                          int M, float* orig, float* otor) {
  const int ln = lane_id();
  if (ln < 8) orig[ln] = rigid[(size_t)lane * 8 + ln];
  for (int t = ln; t < M; t += 32) otor[t] = tors[(size_t)lane * M + t];
  __syncwarp();
}

// ------------------------------------------------------------- kernels ----

extern __shared__ __align__(128) unsigned char dyn_smem[];

// K1; with out_g null a value-only evaluation (what a lockstep Armijo
// trial runs), whose energies equal the value+gradient ones bit for bit
__global__ void __launch_bounds__(NT, MINB_EVAL) k_eval_fg(
    PackArgs pk, TermArgs ta, const float* rigid, const float* tors,
    const float* scal, float* out_e, float* out_met, float* out_g,
    float* out_coords) {
  const int lane = blockIdx.x;
  Ctx c;
  setup(c, dyn_smem, pk, ta, scal, pk.lane_lig[lane]);
  if (threadIdx.x >= 32) { worker_loop(c); return; }
  const Smem& s = c.s;
  const int ln = lane_id();
  read_pose(rigid, tors, lane, pk.M, s.x_rig, s.x_tor);
  if (out_g)
    eval_pose<true, 8>(c, s.x_rig, s.x_tor, s.g);
  else
    eval_pose<false, 8>(c, s.x_rig, s.x_tor, nullptr);
  release_workers(s);
  if (ln == 0) { out_e[lane] = s.sc[S_E]; out_met[lane] = s.sc[S_MET]; }
  if (out_g)
    for (int t = ln; t < pk.D; t += 32) out_g[(size_t)lane * pk.D + t] = s.g[t];
  for (int i = ln; i < pk.N * 3; i += 32)
    out_coords[(size_t)lane * pk.N * 3 + i] = s.coords[i];
}

struct BfgsResult {
  float f, met;          // energy and Metropolis energy at the returned pose
  float n_evals;         // Armijo trial evaluations
  float n_iters;         // iterations entered (async_ls: accepted steps)
  float n_acc;           // accepted steps
  float g_iters;         // coupled: iterations (ticks) the pose's group ran
  int overrun;           // coupled: iterations (ticks) run past that stop
};

// K8, the group stop (done_frac < 1).  The TPU kernel sums its done flags
// over the 128 lanes of a block, all at the same iteration, and every lane
// of the block ends at the first iteration whose sum reaches the target.
// Here a pose is a thread block, and the blocks of a group share one word
// per (group, run, iteration) in global memory: arrivals in the high half,
// done flags in the low half, added in one atomic.  A pose does not wait
// there.  It adds its vote and goes on, keeping a record of its state after
// every iteration (the pose, its energies and counters, not H or g) in a
// ring in global memory; it reads the words of the slots it has voted on
// without waiting, and the first slot whose count is final and below the
// target no longer holds it, while the first whose count reaches the
// target (counts only grow) is the group's stop.  A pose that stops on its
// own knows its votes for every later slot (the lockstep flag is |g|^2 <
// 1e-4 at a point that no longer moves, or done every second iteration for
// one out of trials; the async flag is sticky), adds them all at once, and
// then waits for the stop: only there, once a run, is there a wait.  A pose
// that ran past the stop takes its state at the stop from the ring.  The
// stop, the result of every pose and the words (the last pose of a group to
// learn the stop zeroes the words past it, which poses ahead voted on) are
// those of a meeting at every iteration.  The launch is cooperative (all
// blocks co-resident, or it fails), since a pose does wait for its group at
// the end of a run.  What bounds it: one L2 atomic and a read of a word or
// two an iteration, a record of 2 (8 + M) + 5 floats, and the wait for the
// group's slowest pose once a run.
//
// The scratch (the wrapper's, zeroed; fused_dock.k8_scratch_words): the
// words, groups x runs x run_slots; a leave count per (group, run); an int
// per lane, the iterations it ran past its group's stops; then a ring of
// run_slots records per lane.
__host__ __device__ inline int ring_floats(int M) { return 2 * (8 + M) + 5; }

struct GroupSync {
  unsigned int* slots;   // this group's words (runs x run_slots); null =
                         // uncoupled
  unsigned int* leave;   // this group's leave counts, one a run
  int* overrun;          // this lane's iterations past the stops
  float* ring;           // this lane's records, one a slot of a run
  int nblocks;           // real poses of the group
  int pad;               // inert lanes the TPU block is padded with: they
                         // read done from the first iteration on
  int target;            // int(done_frac * 128)
  int run_slots;         // iterations (ticks) one run can take
};

__device__ inline GroupSync group_sync(unsigned int* gsync, int runs,
                                       int run_slots, int done_target,
                                       int lane, int L, int M) {
  GroupSync gs = {nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0};
  if (gsync) {
    const int groups = (L + GROUP - 1) / GROUP, g = lane / GROUP;
    const size_t per_group = (size_t)runs * run_slots;
    unsigned int* leave = gsync + groups * per_group;
    int* over = reinterpret_cast<int*>(leave + (size_t)groups * runs);
    float* ring = reinterpret_cast<float*>(over + L);
    gs.slots = gsync + g * per_group;
    gs.leave = leave + (size_t)g * runs;
    gs.overrun = over + lane;
    gs.ring = ring + (size_t)lane * run_slots * ring_floats(M);
    gs.nblocks = min(GROUP, L - g * GROUP);
    gs.pad = GROUP - gs.nblocks;
    gs.target = done_target;
    gs.run_slots = run_slots;
  }
  return gs;
}

// Warp 0: the pose's votes for slots k0 .. k1-1 of the run at slot0, done
// where done_at(k) says so, one slot a lane
template <typename F>
__device__ void add_votes(const GroupSync& gs, int slot0, int k0, int k1,
                          F done_at) {
  for (int k = k0 + lane_id(); k < k1; k += 32)
    atomicAdd(gs.slots + slot0 + k, 0x10000u + (done_at(k) ? 1u : 0u));
  __syncwarp();
}

// Warp 0, K8: where a pose stands on its group's stop in one run.  res: the
// first slot not known to be below the target; stop: the iterations the
// group runs, once known, else 0.
struct Stop { int res, stop; };

// Warp 0: read the words of slots st.res .. upto (the slots the pose has
// voted on), 32 at a time, and move res past every slot whose count is
// final (every block arrived) and below the target; the first slot whose
// count reaches it (counts only grow) gives the stop.  With wait, spins on
// the first open slot until the stop is known or every slot up to upto is
// below the target.
__device__ __forceinline__ Stop resolve_stop(const GroupSync& gs, int slot0,
                                             int upto, Stop st, bool wait) {
  const int ln = lane_id();
  for (long spins = 0; st.res <= upto;) {
    const int k = st.res + ln;
    bool below = false, hit = false;
    if (k <= upto) {
      const unsigned v = *(volatile const unsigned int*)(gs.slots + slot0 + k);
      hit = (int)(v & 0xffffu) + gs.pad >= gs.target;
      below = !hit && (int)(v >> 16) == gs.nblocks;
    }
    const unsigned open = __ballot_sync(FULL, !below);
    if (!open) { st.res += 32; continue; }
    const int first = __ffs(open) - 1;
    st.res += first;
    if (__shfl_sync(FULL, hit, first)) { st.stop = st.res + 1; break; }
    if (st.res > upto || !wait) break;
    __nanosleep(128);
    if (++spins > (1L << 26)) __trap();   // a group that never meets
  }
  return st;
}

// Warp 0: the state after slot k of the current run into the ring (lane i
// writes element i, and ring_get reads it back on the same lane)
__device__ __forceinline__ void ring_put(const GroupSync& gs, const Smem& s,
                                         int k, int M, float f0, float met,
                                         BfgsResult o) {
  float* r = gs.ring + (size_t)k * ring_floats(M);
  const int ln = lane_id();
  for (int i = ln; i < 8 + M; i += 32) {
    r[i] = i < 8 ? s.x_rig[i] : s.x_tor[i - 8];
    r[8 + M + i] = i < 8 ? s.t_rig[i] : s.t_tor[i - 8];
  }
  if (ln == 0) {
    float* q = r + 2 * (8 + M);
    q[0] = f0; q[1] = met; q[2] = o.n_evals; q[3] = o.n_iters; q[4] = o.n_acc;
  }
  __syncwarp();
}

// ... and back: the poses into shared memory, the scalars returned (every
// lane gets them)
struct RingScalars { float f0, met, n_evals, n_iters, n_acc; };

__device__ __forceinline__ RingScalars ring_get(const GroupSync& gs,
                                                const Smem& s, int k, int M) {
  const float* r = gs.ring + (size_t)k * ring_floats(M);
  const int ln = lane_id();
  for (int i = ln; i < 8 + M; i += 32) {
    (i < 8 ? s.x_rig[i] : s.x_tor[i - 8]) = r[i];
    (i < 8 ? s.t_rig[i] : s.t_tor[i - 8]) = r[8 + M + i];
  }
  const float* q = r + 2 * (8 + M);
  RingScalars v;
  v.f0 = __shfl_sync(FULL, ln == 0 ? q[0] : 0.0f, 0);
  v.met = __shfl_sync(FULL, ln == 0 ? q[1] : 0.0f, 0);
  v.n_evals = __shfl_sync(FULL, ln == 0 ? q[2] : 0.0f, 0);
  v.n_iters = __shfl_sync(FULL, ln == 0 ? q[3] : 0.0f, 0);
  v.n_acc = __shfl_sync(FULL, ln == 0 ? q[4] : 0.0f, 0);
  __syncwarp();
  return v;
}

// Warp 0, once the pose knows its group's stop for the run: count itself out;
// the group's last pose out zeroes the words past the stop
__device__ __noinline__ void leave_run(const GroupSync& gs, int run,
                                       int slot0, int stop) {
  unsigned last = 0;
  if (lane_id() == 0) {
    __threadfence();
    last = atomicAdd(gs.leave + run, 1u) + 1u == (unsigned)gs.nblocks;
  }
  if (__shfl_sync(FULL, last, 0)) {
    __threadfence();
    for (int k = stop + lane_id(); k < gs.run_slots; k += 32)
      atomicExch(gs.slots + slot0 + k, 0u);
  }
  __syncwarp();
}

// Warp 0: one truncated BFGS from the pose in (s.s_rig, s.s_tor) to
// (s.x_rig, s.x_tor): Armijo backtracking (alpha = factor^-t, t <
// num_trials, first accept), first-step Hessian scaling, the update guard,
// the NaN-safe restore-if-not-improved.  A pose stops once it has
// converged, has no descent direction, or exhausts its trials.  Trials are
// value-only evaluations, and an accepted one is evaluated again with its
// gradient; with GRAD_FIRST (K5) trial 0 carries its gradient, so that an
// accept there needs no second evaluation (the two give the same energy
// bits).  It paid in K5 (-9%) and not in K2 (+5% at L=800, where half the
// first trials are rejected: PERF.md).  K5 sums a node's forces on 8 lanes,
// k_bfgs on one (finish_eval).
//
// async_ls (bfgs_run_async): every trial is a fused value+gradient
// evaluation, so an accepted trial's gradient is already there; the loop
// counts ticks (at most maxiters * num_trials + 1) and the pose's own
// (iteration, trial) pair.  With one block per pose the two modes walk the
// same trial points and take the same steps.
//
// last_fk: leave in s.coords the pose of the JAX loop's last evaluation,
// which its in-kernel MC returns as its coordinates.  The lockstep loop ends
// every iteration on a value+gradient at the iterate it keeps (a stuck
// iteration keeps the old one), so that is the FK of the last iterate BEFORE
// the restore.  The async loop's last evaluation is its last tick's trial
// point, rejected or not, and a tick that finds no descent direction still
// evaluates its trial point.  Otherwise s.coords is whatever the last
// evaluation left.
//
// COUPLED (K8): the loop is coupled to the pose's group through gs (see
// GroupSync): after every iteration (tick) the pose votes its done flag as
// the TPU loop holds it at that point, and the loop ends for the whole group
// at the first iteration whose count reaches gs.target.  The lockstep flag
// is not sticky (:818-819): a converged pose, or one without a descent
// direction, reads |g|^2 < 1e-4 from then on; a pose that ran out of trials
// reads done at that iteration and at every second one after it, and in
// between |g|^2 < 1e-4.  The async flag is the pose's own stop and is sticky
// (:923-928).  A target of 0 (done_frac < 1/128) is reached before the
// first iteration, as in the TPU loop's test, so the loop runs none.  run
// numbers the group's runs in this launch (K5's steps).
template <bool COUPLED, bool GRAD_FIRST>
__device__ __forceinline__ BfgsResult bfgs_run(Ctx& c, int maxiters,
                                               int num_trials,
                                               float log2_factor,
                                               bool async_ls, bool last_fk,
                                               const GroupSync& gs, int run) {
  const Smem& s = c.s;
  const int M = c.pk.M, D = c.pk.D;
  const bool coupled = COUPLED;
  constexpr int NL = GRAD_FIRST ? 8 : 1;     // K5's node sums, or k_bfgs'
  const bool no_iters = coupled && gs.target <= 0;
  const int slot0 = run * gs.run_slots;
  copy_pose(s.s_rig, s.s_tor, s.x_rig, s.x_tor, M);
  eval_pose<true, NL>(c, s.x_rig, s.x_tor, s.g);
  const float f_init = s.sc[S_E], met_init = s.sc[S_MET];
  float f0 = f_init, met = met_init;
  set_eye(s.h, 1.0f, D);
  BfgsResult out = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0};
  int last = -1;       // the last iteration (tick) the pose ran
  Stop st = {0, 0};    // K8
  if (!async_ls) {
    // fin: 0 running, 1 converged or no descent direction, 2 out of trials
    int fin = 0, fin_it = 0;
    const int iters = no_iters ? 0 : maxiters;
    for (int it = 0; it < iters; ++it) {
      last = it;
      neg_hdot(s.h, s.g, s.dofm, s.p, D);
      const float pg = warp_dot(s.p, s.g, D);
      if (pg >= 0.0f) {
        fin = 1;                             // no descent direction
      } else {
        out.n_iters += 1.0f;
        // value-only trials (trial 0 with its gradient under GRAD_FIRST),
        // and once accepted the gradient on the same point
        int tr = 0;
        bool accepted = false, grad = GRAD_FIRST;
        float alpha = exp2f(-(float)tr * log2_factor), f1 = 0.0f, fm1 = 0.0f;
        increment(s.x_rig, s.x_tor, s.p, alpha, s.t_rig, s.t_tor, M);
        for (;;) {
          if (grad)
            eval_pose<true, NL>(c, s.t_rig, s.t_tor, s.gn);
          else
            eval_pose<false, NL>(c, s.t_rig, s.t_tor, nullptr);
          if (accepted) break;
          out.n_evals += 1.0f;
          f1 = s.sc[S_E];
          fm1 = s.sc[S_MET];
          if ((f1 - f0) < C0 * alpha * pg) {
            accepted = true;
            if (grad) break;
            grad = true;
            continue;
          }
          if (++tr >= num_trials) break;
          alpha = exp2f(-(float)tr * log2_factor);
          increment(s.x_rig, s.x_tor, s.p, alpha, s.t_rig, s.t_tor, M);
          grad = false;
        }
        if (!accepted) {
          fin = 2;                           // stuck: no step can follow
          fin_it = it;
        } else {
          out.n_acc += 1.0f;
          diff_stats(s, D);
          if (it == 0) first_scale(s, alpha, D);
          const bool conv = s.sc[S_GSQ] < 1e-4f;
          const bool ok_h = alpha * s.sc[S_YP] >= EPS_FL;
          if (ok_h && !conv) bfgs_update(s, alpha, D);
          copy_pose(s.t_rig, s.t_tor, s.x_rig, s.x_tor, M);
          copy_vec(s.gn, s.g, D);
          f0 = f1;
          met = fm1;
          if (conv) fin = 1;
        }
      }
      if (!coupled) {
        if (fin) break;
        continue;
      }
      if (fin) {                             // this slot's and every later
        const bool small = warp_dot(s.g, s.g, D) < 1e-4f;
        add_votes(gs, slot0, it, iters, [&](int k) {
          return small || (fin == 2 && ((k - fin_it) & 1) == 0);
        });
        break;
      }
      ring_put(gs, s, it, M, f0, met, out);
      add_votes(gs, slot0, it, it + 1, [](int) { return false; });
      if ((st = resolve_stop(gs, slot0, it, st, false)).stop) break;
    }
  } else {
    const int max_ticks = no_iters ? 0 : maxiters * num_trials + 1;
    float tl = 0.0f;
    int itl = 0;
    bool done = false;
    for (int tick = 0; tick < max_ticks; ++tick) {
      last = tick;
      neg_hdot(s.h, s.g, s.dofm, s.p, D);
      const float pg = warp_dot(s.p, s.g, D);
      const float alpha = exp2f(-tl * log2_factor);
      increment(s.x_rig, s.x_tor, s.p, alpha, s.t_rig, s.t_tor, M);
      if (pg >= 0.0f) {                      // done at once (:879)
        if (last_fk) fk(s, s.t_rig, s.t_tor, c.pk.N, M, c.pk.LY);
        done = true;
      } else {
        eval_pose<true, NL>(c, s.t_rig, s.t_tor, s.gn);
        out.n_evals += 1.0f;                 // active ticks (:888)
        const float f1 = s.sc[S_E], fm1 = s.sc[S_MET];
        if ((f1 - f0) < C0 * alpha * pg) {
          out.n_acc += 1.0f;                 // accepts (:889)
          diff_stats(s, D);
          if (itl == 0) first_scale(s, alpha, D);
          itl += 1;
          done = s.sc[S_GSQ] < 1e-4f || itl >= maxiters;
          const bool ok_h = alpha * s.sc[S_YP] >= EPS_FL;
          if (ok_h && !done) bfgs_update(s, alpha, D);
          copy_pose(s.t_rig, s.t_tor, s.x_rig, s.x_tor, M);
          copy_vec(s.gn, s.g, D);
          f0 = f1;
          met = fm1;
          tl = 0.0f;
        } else {
          tl += 1.0f;
          done = tl >= (float)num_trials;    // stuck
        }
      }
      if (!coupled) {
        if (done) break;
        continue;
      }
      if (done) {                            // sticky from here on
        add_votes(gs, slot0, tick, max_ticks, [](int) { return true; });
        break;
      }
      ring_put(gs, s, tick, M, f0, met, out);
      add_votes(gs, slot0, tick, tick + 1, [](int) { return false; });
      if ((st = resolve_stop(gs, slot0, tick, st, false)).stop) break;
    }
  }
  if (coupled && !no_iters) {
    if (!st.stop) st = resolve_stop(gs, slot0, gs.run_slots - 1, st, true);
    const int stop = st.stop ? st.stop : gs.run_slots;   // 0: none met it
    if (stop - 1 < last) {                   // ran past the stop: roll back
      const RingScalars r = ring_get(gs, s, stop - 1, M);
      f0 = r.f0; met = r.met;
      out.n_evals = r.n_evals; out.n_iters = r.n_iters; out.n_acc = r.n_acc;
      if (last_fk && async_ls) fk(s, s.t_rig, s.t_tor, c.pk.N, M, c.pk.LY);
      out.overrun = last - (stop - 1);
    }
    leave_run(gs, run, slot0, stop);
    out.g_iters = (float)stop;
  }
  if (async_ls) out.n_iters = out.n_acc;
  if (last_fk && !async_ls) fk(s, s.x_rig, s.x_tor, c.pk.N, M, c.pk.LY);
  // restore original if not improved (bfgs.h:491, NaN-safe)
  if (!(f0 <= f_init)) {
    copy_pose(s.s_rig, s.s_tor, s.x_rig, s.x_tor, M);
    f0 = f_init;
    met = met_init;
  }
  out.f = f0;
  out.met = met;
  return out;
}

// K2 / K4: one truncated BFGS per pose.  stats (L, 8) = [f, metro, trial
// evaluations, iterations, accepted iterations, 0...]; under async_ls rows
// 2 and 3 are the pose's active ticks and accepts (cnt_s of the JAX kernel).
// With gsync set (K8) the launch holds whole groups from lane0 on, stats
// row 5 is the number of iterations (ticks) the pose's group ran, and gsync
// is the K8 scratch (GroupSync) for one run of slots_per_group slots.
template <bool COUPLED, int MINB>
__global__ void __launch_bounds__(NT, MINB) k_bfgs(
    PackArgs pk, TermArgs ta, const float* rigid0, const float* tors0,
    const float* scal, int maxiters, int want_metro, int num_trials,
    float log2_factor, int async_ls, float* orig, float* otor, float* stats,
    float* ocoords, unsigned int* gsync, int slots_per_group, int done_target,
    int lane0) {
  const int lane = lane0 + blockIdx.x;
  Ctx c;
  setup(c, dyn_smem, pk, ta, scal, pk.lane_lig[lane]);
  if (threadIdx.x >= 32) { worker_loop(c); return; }
  const Smem& s = c.s;
  const int M = pk.M;
  read_pose(rigid0, tors0, lane, M, s.s_rig, s.s_tor);
  const GroupSync gs = group_sync(gsync, 1, slots_per_group, done_target,
                                  lane, pk.L, M);
  const BfgsResult res = bfgs_run<COUPLED, false>(c, maxiters, num_trials,
                                                  log2_factor, async_ls != 0,
                                                  false, gs, 0);
  if (COUPLED && lane_id() == 0) *gs.overrun = res.overrun;
  release_workers(s);
  fk(s, s.x_rig, s.x_tor, pk.N, M, pk.LY);
  write_pose_out(s, s.x_rig, s.x_tor, lane, pk.N, M, orig, otor, ocoords);
  if (lane_id() == 0) {
    float* st = stats + (size_t)lane * 8;
    st[0] = res.f;
    st[1] = want_metro ? res.met : 0.0f;
    st[2] = res.n_evals;
    st[3] = res.n_iters;
    st[4] = res.n_acc;
    st[5] = res.g_iters;
  }
}

// Philox4x32-10 (Salmon et al., SC'11)
__device__ __forceinline__ uint4 philox(uint4 c, uint2 k) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

__device__ __forceinline__ float u01(uint32_t x) {
  return (float)(x >> 8) * (1.0f / 16777216.0f);
}

// uniform point in the unit ball from u[0..4] (random_inside_sphere)
__device__ void rand_sphere(const float* u, float* o) {
  float u1 = fmaxf(u[0], 1e-7f), u3 = fmaxf(u[2], 1e-7f);
  float r1 = sqrtf(-2.0f * logf(u1)), r2 = sqrtf(-2.0f * logf(u3));
  float n1 = r1 * cosf(2.0f * PI_F * u[1]);
  float n2 = r1 * sinf(2.0f * PI_F * u[1]);
  float n3 = r2 * cosf(2.0f * PI_F * u[3]);
  float inv = rsqrtf(n1 * n1 + n2 * n2 + n3 * n3 + 1e-12f);
  float rad = expf(logf(fmaxf(u[4], 1e-7f)) / 3.0f);
  float sc = inv * rad;
  o[0] = n1 * sc; o[1] = n2 * sc; o[2] = n3 * sc;
}

// warp 0: heavy-atom RMS distance from the root origin on s.coords
// (model.cpp:1002)
__device__ float gyration(const Smem& s, const float* rig, int nh) {
  float d2 = 0.0f;
  for (int a = lane_id(); a < nh; a += 32) {
    float dx = s.coords[a * 3] - rig[0], dy = s.coords[a * 3 + 1] - rig[1],
          dz = s.coords[a * 3 + 2] - rig[2];
    d2 += dx * dx + dy * dy + dz * dz;
  }
  return sqrtf(warp_sum(d2) / fmaxf((float)nh, 1.0f));
}

// warp 0: one-DOF mutation (mutate.cpp:35-73) of (rig, tor) from u[0..11]
__device__ void mutate(const Smem& s, const float* rig, const float* tor,
                       float gr, const float* u, float amp, float* orig,
                       float* otor, int M, int D) {
  const int ln = lane_id();
  float hasrig = s.dofm[0];
  float ntors = 0.0f;
  for (int i = 6; i < D; ++i) ntors += s.dofm[i];
  float lo_row = 2.0f * (1.0f - hasrig);
  float span = ntors + 2.0f - lo_row;
  float which = fminf(floorf(lo_row + u[0] * span), ntors + 1.0f);
  if (ln == 0) {
    float sp[3], so[3], dq[4], q[4];
    rand_sphere(u + 1, sp);
    rand_sphere(u + 6, so);
    bool pos_sel = which < 0.5f;
    for (int c = 0; c < 3; ++c) orig[c] = pos_sel ? rig[c] + amp * sp[c] : rig[c];
    float rs = amp / fmaxf(gr, EPS_FL);
    rotvec_quat(rs * so[0], rs * so[1], rs * so[2], dq);
    qmul(dq, rig + 3, q);
    qnormalize_approx(q);
    bool ori_sel = which >= 0.5f && which < 1.5f && gr > EPS_FL;
    for (int c = 0; c < 4; ++c) orig[3 + c] = ori_sel ? q[c] : rig[3 + c];
    orig[7] = 0.0f;
  }
  for (int t = ln; t < M; t += 32) {
    bool row_sel = which >= 1.5f && (float)t == which - 1.0f;
    otor[t] = row_sel ? u[11] * (2.0f * PI_F) - PI_F : tor[t];
  }
  __syncwarp();
}

// warp 0: N_DRAWS uniforms of draw index `idx` (a tick or a step) into
// sc[S_U..]: from the supplied uniforms (idx, 13, L), else Philox keyed on
// (seed, lane) with counter (idx, 0..3), one counter a thread
__device__ void draw_uniforms(const Smem& s, const float* uniforms, int idx,
                              int L, int lane, uint2 key) {
  const int ln = lane_id();
  if (uniforms) {
    if (ln < N_DRAWS)
      s.sc[S_U + ln] = uniforms[((size_t)idx * N_DRAWS + ln) * L + lane];
  } else if (ln < 4) {
    uint4 r = philox(make_uint4((uint32_t)idx, (uint32_t)ln, 0u, 0u), key);
    uint32_t w[4] = {r.x, r.y, r.z, r.w};
    for (int c = 0; c < 4 && 4 * ln + c < N_DRAWS; ++c)
      s.sc[S_U + 4 * ln + c] = u01(w[c]);
  }
  __syncwarp();
}

// Per-pose MC window: a state machine over (step, BFGS iteration, Armijo
// trial), one fused value+gradient eval per tick, at most
// mc_steps * tick_budget ticks.  Tick k draws 13 uniforms: from Philox
// keyed on (seed, lane_offset + lane) with counter (k, 0..3), or from the
// supplied uniforms (ticks, 13, L).  lane_offset is the global index of the
// call's lane 0 when the lanes are one shard of a larger batch, so a shard
// draws what the whole batch's launch draws for the same lanes.  Candidates stream out completion-indexed.
// warm_ls (K6): a pose's Armijo exponent starts at max(wa - 1, 0), where wa
// is the exponent of its last accepted step, reset to 0 at each new
// candidate; with the flag off the exponent is the trial count as before.
__global__ void __launch_bounds__(NT, MINB_ASYNC_MC) k_async_mc(
    PackArgs pk, TermArgs ta, const float* rigid0, const float* tors0,
    const float* scal, const float* ecur0, const float* uniforms,
    uint32_t seed, int lane_offset, int mc_steps, int tick_budget,
    int maxiters, int num_trials, float log2_factor, int warm_ls, float* orig,
    float* otor,
    float* stats, float* ocoords, float* srig, float* stor, float* sstat) {
  const int lane = blockIdx.x;
  Ctx c;
  setup(c, dyn_smem, pk, ta, scal, pk.lane_lig[lane]);
  if (threadIdx.x >= 32) { worker_loop(c); return; }
  const Smem& s = c.s;
  const int ln = lane_id();
  const int M = pk.M, D = pk.D, L = pk.L, nh = c.nh;
  const float amp = c.sv[10], temp = c.sv[11];
  read_pose(rigid0, tors0, lane, M, s.c_rig, s.c_tor);
  copy_pose(s.c_rig, s.c_tor, s.x_rig, s.x_tor, M);
  for (int i = ln; i < D; i += 32) s.g[i] = 0.0f;
  __syncwarp();
  fk(s, s.c_rig, s.c_tor, pk.N, M, pk.LY);
  float gr_cur = gyration(s, s.c_rig, nh);
  float gr_cand = gr_cur;
  float e_cur = ecur0[lane];
  float f0 = 0.0f, met = 0.0f, tl = 0.0f, itl = 0.0f, wa = 0.0f;
  int stepc = 0;
  bool start = true;
  float n_eval = 0.0f, n_ok = 0.0f;
  set_eye(s.h, 1.0f, D);
  const int t_total = mc_steps * tick_budget;
  const uint2 key = make_uint2(seed, (uint32_t)(lane_offset + lane));
  for (int tick = 0; tick < t_total && stepc < mc_steps; ++tick) {
    draw_uniforms(s, uniforms, tick, L, lane, key);
    const float* u = s.sc + S_U;
    float pg = 0.0f, alpha = 0.0f, expnt = 0.0f;
    if (start) {
      mutate(s, s.c_rig, s.c_tor, gr_cur, u, amp, s.t_rig, s.t_tor, M, D);
    } else {
      neg_hdot(s.h, s.g, s.dofm, s.p, D);
      pg = warp_dot(s.p, s.g, D);
      expnt = warm_ls ? fmaxf(wa - 1.0f, 0.0f) + tl : tl;
      alpha = exp2f(-expnt * log2_factor);
      increment(s.x_rig, s.x_tor, s.p, alpha, s.t_rig, s.t_tor, M);
    }
    eval_pose<true, 8>(c, s.t_rig, s.t_tor, s.gn);
    const float f1 = s.sc[S_E], fm1 = s.sc[S_MET];
    const float gy1 = gyration(s, s.t_rig, nh);
    n_eval += 1.0f;
    bool cdone = false;
    if (start) {
      copy_pose(s.t_rig, s.t_tor, s.x_rig, s.x_tor, M);
      copy_vec(s.gn, s.g, D);
      set_eye(s.h, 1.0f, D);
      f0 = f1; met = fm1; gr_cand = gy1;
      itl = 0.0f; tl = 0.0f; wa = 0.0f;
      start = false;
    } else {
      const bool nodesc = pg >= 0.0f;
      const bool okb = !nodesc && ((f1 - f0) < C0 * alpha * pg);
      bool conv_ok = false, budget_ok = false, stuck = false;
      if (okb) {
        n_ok += 1.0f;
        diff_stats(s, D);
        if (itl == 0.0f) first_scale(s, alpha, D);
        if (alpha * s.sc[S_YP] >= EPS_FL) bfgs_update(s, alpha, D);
        conv_ok = s.sc[S_GSQ] < 1e-4f;
        copy_pose(s.t_rig, s.t_tor, s.x_rig, s.x_tor, M);
        copy_vec(s.gn, s.g, D);
        f0 = f1; met = fm1; gr_cand = gy1;
        itl += 1.0f;
        tl = 0.0f;
        wa = expnt;
        budget_ok = itl >= (float)maxiters;
      } else if (!nodesc) {
        tl += 1.0f;
        stuck = tl >= (float)num_trials;
      }
      cdone = nodesc || stuck || conv_ok || budget_ok;
    }
    if (cdone) {
      // step completion: Metropolis at the candidate's metro energy
      const float e_new = met;
      const bool macc = (e_new < e_cur) || (u[12] < expf((e_cur - e_new) / temp));
      if (macc) {
        copy_pose(s.x_rig, s.x_tor, s.c_rig, s.c_tor, M);
        e_cur = e_new;
        gr_cur = gr_cand;
      }
      const size_t row = (size_t)lane * mc_steps + stepc;
      if (ln < 8) srig[row * 8 + ln] = s.x_rig[ln];
      for (int t = ln; t < M; t += 32) stor[row * M + t] = s.x_tor[t];
      if (ln == 0) {
        sstat[row * 3] = e_new;
        sstat[row * 3 + 1] = macc ? 1.0f : 0.0f;
        sstat[row * 3 + 2] = 1.0f;
      }
      stepc += 1;
      start = true;
    }
    __syncwarp();
  }
  release_workers(s);
  fk(s, s.c_rig, s.c_tor, pk.N, M, pk.LY);
  write_pose_out(s, s.c_rig, s.c_tor, lane, pk.N, M, orig, otor, ocoords);
  if (ln == 0) {
    float* st = stats + (size_t)lane * 8;
    st[0] = e_cur; st[1] = e_cur; st[2] = n_eval; st[3] = n_ok;
    st[4] = (float)stepc;
  }
}

// K5: step-indexed in-kernel MC (mc_body).  Each of mc_steps steps: FK of
// the chain state, gyration, one-DOF mutation, one whole BFGS (bfgs_run, in
// either line-search mode), Metropolis with one uniform.  Step k draws 13
// uniforms: Philox keyed on (seed, lane_offset + lane) with counter (k,
// 0..3), as in K3, or the supplied uniforms (steps, 13, L).  Every stream row is written: srig
// (L, S, 8), stor (L, S, M), sstat (L, S, 3) = (Metropolis energy,
// accepted, Armijo trial evaluations of the step); stats (L, 8) = [e, e,
// trial evaluations, iterations, accepted iterations, 0...].  The
// coordinates returned are those of the last step's last BFGS evaluation
// (bfgs_run's last_fk), not a fresh FK of the final chain state (the JAX
// kernel returns its last FK).  With gsync set (K8) every step's BFGS is
// coupled to the pose's group, on its own run of words in the K8 scratch
// (GroupSync: mc_steps runs of slots_per_group / mc_steps slots), and stats
// row 5 sums the iterations (ticks) the group ran over the steps.
template <bool COUPLED>
__global__ void __launch_bounds__(NT, MINB_LOCKSTEP_MC) k_lockstep_mc(
    PackArgs pk, TermArgs ta, const float* rigid0, const float* tors0,
    const float* scal, const float* ecur0, const float* uniforms,
    uint32_t seed, int lane_offset, int mc_steps, int maxiters,
    int num_trials, float log2_factor, int async_ls, float* orig, float* otor,
    float* stats, float* ocoords, float* srig, float* stor, float* sstat,
    unsigned int* gsync, int slots_per_group, int done_target, int lane0) {
  const int lane = lane0 + blockIdx.x;
  Ctx c;
  setup(c, dyn_smem, pk, ta, scal, pk.lane_lig[lane]);
  if (threadIdx.x >= 32) { worker_loop(c); return; }
  const Smem& s = c.s;
  const int ln = lane_id();
  const int M = pk.M, D = pk.D, L = pk.L, nh = c.nh;
  const float amp = c.sv[10], temp = c.sv[11];
  read_pose(rigid0, tors0, lane, M, s.c_rig, s.c_tor);
  float e_cur = ecur0[lane];
  float n_evals = 0.0f, n_iters = 0.0f, n_acc = 0.0f, g_iters = 0.0f;
  const uint2 key = make_uint2(seed, (uint32_t)(lane_offset + lane));
  const int run_slots = async_ls ? maxiters * num_trials + 1 : maxiters;
  const GroupSync gs = group_sync(gsync, mc_steps, run_slots, done_target,
                                  lane, L, M);
  int overrun = 0;
  if (mc_steps == 0) fk(s, s.c_rig, s.c_tor, pk.N, M, pk.LY);
  for (int step = 0; step < mc_steps; ++step) {
    draw_uniforms(s, uniforms, step, L, lane, key);
    const float* u = s.sc + S_U;
    fk(s, s.c_rig, s.c_tor, pk.N, M, pk.LY);
    const float gr = gyration(s, s.c_rig, nh);
    mutate(s, s.c_rig, s.c_tor, gr, u, amp, s.s_rig, s.s_tor, M, D);
    const BfgsResult res = bfgs_run<COUPLED, true>(c, maxiters, num_trials,
                                                   log2_factor, async_ls != 0,
                                                   true, gs, step);
    overrun += res.overrun;
    g_iters += res.g_iters;
    n_evals += res.n_evals;
    n_iters += res.n_iters;
    n_acc += res.n_acc;
    const float e_new = res.met;
    const bool macc = (e_new < e_cur) || (u[12] < expf((e_cur - e_new) / temp));
    const size_t row = (size_t)lane * mc_steps + step;
    if (ln < 8) srig[row * 8 + ln] = s.x_rig[ln];
    for (int t = ln; t < M; t += 32) stor[row * M + t] = s.x_tor[t];
    if (ln == 0) {
      sstat[row * 3] = e_new;
      sstat[row * 3 + 1] = macc ? 1.0f : 0.0f;
      sstat[row * 3 + 2] = res.n_evals;
    }
    if (macc) {
      copy_pose(s.x_rig, s.x_tor, s.c_rig, s.c_tor, M);
      e_cur = e_new;
    }
    __syncwarp();
  }
  release_workers(s);
  write_pose_out(s, s.c_rig, s.c_tor, lane, pk.N, M, orig, otor, ocoords);
  if (ln == 0) {
    float* st = stats + (size_t)lane * 8;
    st[0] = e_cur; st[1] = e_cur; st[2] = n_evals; st[3] = n_iters;
    st[4] = n_acc; st[5] = g_iters;
    if (COUPLED) *gs.overrun = overrun;
  }
}

// -------------------------------------------------------- C interface ----

static int launch_setup(const void* kernel, const PackArgs* pk, size_t* smem) {
  if (pk->rec_tile <= 0 && pk->K > 0) return (int)cudaErrorInvalidValue;
  *smem = smem_bytes(pk->N, pk->M, pk->D, pk->K, pk->rec_tile);
  if (*smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// k_bfgs for two pose blocks an SM (64 registers) where the lanes outnumber
// the SMs and two blocks fit an SM, else for one (128 registers): each is
// the faster at its own shape, the refine's 128 lanes and the finish's 800
// (PERF.md), and both give the same bits.  Sets *smem as launch_setup.
static int bfgs_kernel(const PackArgs* pk, bool coupled, const void** kernel,
                       size_t* smem) {
  const void* one = coupled ? (const void*)k_bfgs<true, 1>
                            : (const void*)k_bfgs<false, 1>;
  const void* two = coupled ? (const void*)k_bfgs<true, 2>
                            : (const void*)k_bfgs<false, 2>;
  int dev = 0, sms = 0, fit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  *kernel = one;
  if (pk->L > sms) {
    int rc = launch_setup(two, pk, smem);
    if (rc) return rc;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, two, NT, *smem);
    if (err != cudaSuccess) return (int)err;
    if (fit >= 2) {
      *kernel = two;
      return 0;
    }
  }
  return launch_setup(one, pk, smem);
}

// one launch of L pose blocks
static int launch_all(const void* kernel, int lanes, size_t smem,
                      cudaStream_t stream, void** args, int* launched) {
  cudaError_t err = cudaLaunchKernel(kernel, dim3(lanes), dim3(NT), args,
                                     smem, stream);
  if (err != cudaSuccess) return (int)err;
  *launched = 1;
  return (int)cudaGetLastError();
}

// K8: launch whole groups cooperatively, as many at a time as are
// co-resident; groups are independent, so the rest follow in turn on the same
// stream.  lane0 is the kernel argument (one of args) naming the launch's
// first lane; *launched counts the launches made.
static int launch_groups(const void* kernel, int lanes, size_t smem,
                         cudaStream_t stream, void** args, int* lane0,
                         int* launched) {
  int dev = 0, coop = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, NT,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  const int fit = (resident * sms) / GROUP * GROUP;
  if (fit < GROUP) return (int)cudaErrorCooperativeLaunchTooLarge;
  for (int l0 = 0; l0 < lanes; l0 += fit) {
    *lane0 = l0;
    const int nb = lanes - l0 < fit ? lanes - l0 : fit;
    err = cudaLaunchCooperativeKernel(kernel, dim3(nb), dim3(NT), args, smem,
                                      stream);
    if (err != cudaSuccess) return (int)err;
    ++*launched;
  }
  return (int)cudaGetLastError();
}

// Every gt_* entry point below writes the number of kernel launches it made
// to *launched (a host int): 1, or under K8 one per set of co-resident groups.
extern "C" {

const char* gt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int gt_eval_fg(const PackArgs* pk, const TermArgs* tm, const float* rigid,
               const float* tors, const float* scal, float* out_e,
               float* out_met, float* out_g, float* out_coords, void* stream,
               int* launched) {
  *launched = 0;
  size_t smem;
  const void* kernel = (const void*)k_eval_fg;
  int rc = launch_setup(kernel, pk, &smem);
  if (rc) return rc;
  if (pk->L == 0) return 0;
  PackArgs pkv = *pk;
  TermArgs tmv = *tm;
  void* args[] = {&pkv, &tmv, &rigid, &tors, &scal, &out_e, &out_met, &out_g,
                  &out_coords};
  return launch_all(kernel, pk->L, smem, (cudaStream_t)stream, args,
                    launched);
}

int gt_bfgs_minimize(const PackArgs* pk, const TermArgs* tm, const float* rigid,
                     const float* tors, const float* scal, int maxiters,
                     int want_metro, int num_trials, float log2_factor,
                     int async_ls, float* orig, float* otor, float* stats,
                     float* ocoords, unsigned int* gsync, int slots_per_group,
                     int done_target, void* stream, int* launched) {
  *launched = 0;
  size_t smem;
  const void* kernel;
  int rc = bfgs_kernel(pk, gsync != nullptr, &kernel, &smem);
  if (rc) return rc;
  if (pk->L == 0) return 0;
  int lane0 = 0;
  PackArgs pkv = *pk;
  TermArgs tmv = *tm;
  void* args[] = {&pkv, &tmv, &rigid, &tors, &scal, &maxiters, &want_metro,
                  &num_trials, &log2_factor, &async_ls, &orig, &otor, &stats,
                  &ocoords, &gsync, &slots_per_group, &done_target, &lane0};
  if (gsync)
    return launch_groups(kernel, pk->L, smem, (cudaStream_t)stream, args,
                         &lane0, launched);
  return launch_all(kernel, pk->L, smem, (cudaStream_t)stream, args,
                    launched);
}

int gt_async_mc_window(const PackArgs* pk, const TermArgs* tm,
                       const float* rigid, const float* tors, const float* scal,
                       const float* ecur, const float* uniforms, uint32_t seed,
                       int lane_offset, int mc_steps, int tick_budget,
                       int maxiters,
                       int num_trials, float log2_factor, int warm_ls,
                       float* orig, float* otor, float* stats, float* ocoords,
                       float* srig, float* stor, float* sstat, void* stream,
                       int* launched) {
  *launched = 0;
  size_t smem;
  const void* kernel = (const void*)k_async_mc;
  int rc = launch_setup(kernel, pk, &smem);
  if (rc) return rc;
  if (pk->L == 0) return 0;
  PackArgs pkv = *pk;
  TermArgs tmv = *tm;
  void* args[] = {&pkv, &tmv, &rigid, &tors, &scal, &ecur, &uniforms, &seed,
                  &lane_offset, &mc_steps, &tick_budget, &maxiters,
                  &num_trials,
                  &log2_factor, &warm_ls, &orig, &otor, &stats, &ocoords,
                  &srig, &stor, &sstat};
  return launch_all(kernel, pk->L, smem, (cudaStream_t)stream, args,
                    launched);
}

int gt_lockstep_mc_window(const PackArgs* pk, const TermArgs* tm,
                          const float* rigid, const float* tors,
                          const float* scal, const float* ecur,
                          const float* uniforms, uint32_t seed,
                          int lane_offset, int mc_steps, int maxiters,
                          int num_trials, float log2_factor,
                          int async_ls, float* orig, float* otor, float* stats,
                          float* ocoords, float* srig, float* stor,
                          float* sstat, unsigned int* gsync,
                          int slots_per_group, int done_target, void* stream,
                          int* launched) {
  *launched = 0;
  size_t smem;
  const void* kernel = gsync ? (const void*)k_lockstep_mc<true>
                             : (const void*)k_lockstep_mc<false>;
  int rc = launch_setup(kernel, pk, &smem);
  if (rc) return rc;
  if (pk->L == 0) return 0;
  int lane0 = 0;
  PackArgs pkv = *pk;
  TermArgs tmv = *tm;
  void* args[] = {&pkv, &tmv, &rigid, &tors, &scal, &ecur, &uniforms, &seed,
                  &lane_offset, &mc_steps, &maxiters, &num_trials,
                  &log2_factor, &async_ls,
                  &orig, &otor, &stats, &ocoords, &srig, &stor, &sstat,
                  &gsync, &slots_per_group, &done_target, &lane0};
  if (gsync)
    return launch_groups(kernel, pk->L, smem, (cudaStream_t)stream, args,
                         &lane0, launched);
  return launch_all(kernel, pk->L, smem, (cudaStream_t)stream, args,
                    launched);
}

}  // extern "C"
