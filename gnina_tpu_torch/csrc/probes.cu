// Primitive-rate probes for Hopper (sm_90a): what the card does per pair
// term, per row gather and per one-hot contraction.
//
// Replaces the three Pallas probes of scripts/tpu_pallas_probe.py:
//   gt_probe_pairs   K9:  probe_pairs (:104, pallas_call :112; body
//                         make_pairs_kernel :48-101), in float32 and bfloat16
//   gt_probe_gather  K10: probe_gather_loop (:126, pallas_call :150)
//   gt_probe_mxu     K11: probe_mxu (:163, pallas_call :182)
// Each runs `reps` repetitions inside one launch and returns the scalar
// checksum the TPU kernel writes to out_ref[0, 0]; block 0 adds the blocks'
// partial sums.  The plain PyTorch versions in gnina_tpu_torch/probes.py
// compute the same scalars.
//
// What bounds them on an H100 SXM (132 SMs, 1.98 GHz):
//
// K9 is arithmetic.  Its bound counts 46 operations a pair (each exp and
// sqrt one) at the FP32 peak of 67 TFLOP/s, 0.072 ms for L=128, N=32,
// K=1280, 20 repetitions.  Three of those operations go to the MUFU pipe
// (two ex2 and one sqrt), which does 16 a clock an SM: 4.18e12 a second,
// 0.075 ms for the same pairs, about the FP32 bound itself.  So the special
// function pipe is a co-limit, and every instruction beside the counted
// arithmetic (loads, conversions, selects) takes an issue slot that the
// bound does not count.  The design:
// every thread keeps its receptor atoms in registers for the whole launch,
// works a 2-lane x 2-atom tile of the (lane, receptor) plane so that each
// receptor value serves two lanes and each ligand value, read from shared
// memory as a broadcast, serves two receptor atoms; 1,280 blocks of 4
// warps at the default sizes, all resident at once (about 39 warps an SM);
// ex2.approx with log2(e) folded into the gaussians' scales and
// sqrt.approx; packed __nv_bfloat162 arithmetic in bfloat16 (two lanes an
// instruction, ex2.approx.bf16x2; the square root goes through float).
// Every pair runs the whole arithmetic: the cutoff is a select after it.
//
// K10 is one L2 round trip: 4,096 lookups x 20 repetitions of a 32-byte
// row segment out of an 8 MB table that stays in L2, 0.0001 ms by bytes, so
// the launch sets its time.  The design: the (lookup, repetition) units
// spread over every SM, 5 a thread, each row as two 16-byte L2 loads of its
// own unit, all of a thread's loads in flight at once.
//
// K11 is the tensor cores (bf16 in, f32 out), built for Hopper: one
// warpgroup per 64 rows and 64-column half of g, 128 blocks for 132 SMs at
// A = 4,096; the block's half of g (114.7 KB at kdim 896) comes into shared
// memory once, by TMA in the 128-byte swizzled layout that the wgmma
// descriptor names, and every repetition is kdim / 16 wgmma.m64n64k16 with
// the one-hot A built in registers, eight issued between waits, with no
// block barrier.  What bounds it then is the one-time load and wgmma's
// issue and wait latency: 20 repetitions of 56 steps are 2 x 4,096 x 896 x
// 128 x 20 operations, 0.019 ms at 989 TFLOP/s.
//
// A repetition starts its sum from carry * 1e-30, as the TPU kernel does
// (:92), so that the compiler cannot fold the repetitions into one; the
// carry is the thread's, warp's or block's own, not the whole grid's, which
// moves the checksum by less than 1e-25 of itself.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#define GT 128   // threads per block, K11

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// --------------------------------------------------------- the checksum ----
//
// Each probe is one launch.  Every block adds its threads' sums in a fixed
// order and writes the result with one 8-byte store into its slot, beside
// the launch's number (`epoch`, a new one each call); block 0 reads every
// slot, all its threads at once, until all carry this launch's number, and
// adds them in block order.  No atomic touches a value: two launches give
// the same bits.  A slot whose store has not landed yet is read again, so
// no fence orders the stores, and block 0 waits only for the slowest
// block.  The wait always ends: block 0 waits for blocks that wait for
// nothing, and every block of a launch runs in the end.  The slots outlive
// the call (probes._slots keeps them zeroed once, then only larger
// numbers), so two calls of one probe must not run at once on one card.

__device__ __forceinline__ void st_slot(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_slot(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// the block's sum of v (every thread's) into slots[block]; block 0 writes
// the sum of all blocks' into out[0]
__device__ void block_finish(float v, unsigned long long* slots,
                             unsigned epoch, float* out) {
  __shared__ float red[32];
  const unsigned nb = gridDim.x * gridDim.y * gridDim.z;
  const unsigned b = blockIdx.x + gridDim.x * (blockIdx.y
                                               + gridDim.y * blockIdx.z);
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.0f;
    for (int i = 0; i < nw; ++i) s += red[i];
    st_slot(slots + b, ((unsigned long long)epoch << 32) | __float_as_uint(s));
  }
  if (b != 0) return;
  float s;
  // back off (32 ns doubling to 1 us) between reads, so that block 0
  // leaves its SM's issue slots to the blocks still at work there
  for (unsigned nap = 32;; nap = min(2 * nap, 1024u)) {
    s = 0.0f;
    bool ready = true;
#pragma unroll 4
    for (unsigned i = threadIdx.x; i < nb; i += blockDim.x) {
      const unsigned long long x = ld_slot(slots + i);
      ready = ready && (unsigned)(x >> 32) == epoch;
      s += __uint_as_float((unsigned)x);
    }
    if (__syncthreads_and(ready)) break;
    __nanosleep(nap);
  }
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.0f;
    for (int i = 0; i < nw; ++i) t += red[i];
    out[0] = t;
  }
}

// ------------------------------------------------------------------ K9 ----
//
// The tile (probes.pairs_plan makes the grid from the same numbers): a
// block of K9_THREADS threads; each thread holds K9_KT receptor atoms in
// registers for the whole launch and computes them against K9_LT lanes
// (one __nv_bfloat162 in bfloat16) of each ligand atom of its block's
// range.  grid.x walks the receptor (K9_THREADS * K9_KT atoms a block, a
// warp's loads contiguous), grid.y the lanes, grid.z the ligand atoms.  The
// block's atoms (the lanes' coordinates and the 4 parameters) are staged in
// shared memory once and read by every thread at the same address, a
// broadcast.  The ragged edges are padding, not skipped work: receptor
// atoms past K sit at +K9_FAR and lanes past L at -K9_FAR, so r2 >= 64 and
// the cutoff's select makes their energy exactly 0.
#define K9_THREADS 128
#define K9_LT 2
#define K9_KT 2
#define K9_FAR 1.0e4f
// exp(x) = 2^(x log2 e); sqrt(log2 e) goes into the gaussians' scales:
// exp(-4 d^2) = 2^-(2 SL d)^2, exp(-((d - 3) / 2)^2) = 2^-(SL d / 2 - 1.5 SL)^2
#define K9_SL 1.2011224087864498f

typedef __nv_bfloat162 B2;

__device__ __forceinline__ uint32_t b2u(B2 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}
__device__ __forceinline__ B2 u2b(uint32_t x) {
  return *reinterpret_cast<B2*>(&x);
}
__device__ __forceinline__ float ex2_f(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float sqrt_f(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ B2 ex2_b2(B2 x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;" : "=r"(y) : "r"(b2u(x)));
  return u2b(y);
}
// bfloat16 has no packed square root: two float ones, rounded once
__device__ __forceinline__ B2 sqrt_b2(B2 x) {
  return __floats2bfloat162_rn(sqrt_f(__low2float(x)),
                               sqrt_f(__high2float(x)));
}

// One pair in float32: receptor atom (rx, ry, rz), s = its radius + the
// ligand atom's, wh and wb the hydrophobic and h-bond weights of the pair
// (the term weights folded in), lane coordinates (ax, ay, az).  Every
// operation runs for every pair; the cutoff is a select at the end.
__device__ __forceinline__ float pair_f32(float rx, float ry, float rz,
                                          float s, float wh, float wb,
                                          float ax, float ay, float az) {
  const float dx = rx - ax, dy = ry - ay, dz = rz - az;
  const float r2 = fmaf(dz, dz, fmaf(dy, dy, dx * dx));
  const float d = sqrt_f(r2) - s;
  const float v = d * (2.0f * K9_SL);
  const float u = fmaf(d, 0.5f * K9_SL, -1.5f * K9_SL);
  const float g1 = ex2_f(-v * v), g2 = ex2_f(-u * u);
  const float m = fminf(d, 0.0f);
  const float hyd = __saturatef(fmaf(d, -1.4285715f, -0.5f));
  const float hb = __saturatef(fmaf(d, -1.4285715f, -0.42857143f));
  const float e = fmaf(-0.0356f, g1, fmaf(-0.00516f, g2,
                  fmaf(0.84f * m, m, fmaf(wh, hyd, wb * hb))));
  return r2 < 64.0f ? e : 0.0f;
}

// Two pairs in packed bfloat16 (two lanes against one receptor atom, whose
// values are broadcast to both halves); the two energies go to float32.
struct K9B2 {
  B2 cv, cu, cu0, cs, ch, chb, wg1, wg2, wrep, zero, one, cut;
  __device__ K9B2()
      : cv(__float2bfloat162_rn(2.0f * K9_SL)),
        cu(__float2bfloat162_rn(0.5f * K9_SL)),
        cu0(__float2bfloat162_rn(-1.5f * K9_SL)),
        cs(__float2bfloat162_rn(-1.4285715f)),
        ch(__float2bfloat162_rn(-0.5f)),
        chb(__float2bfloat162_rn(-0.42857143f)),
        wg1(__float2bfloat162_rn(-0.0356f)),
        wg2(__float2bfloat162_rn(-0.00516f)),
        wrep(__float2bfloat162_rn(0.84f)),
        zero(__float2bfloat162_rn(0.0f)),
        one(__float2bfloat162_rn(1.0f)),
        cut(__float2bfloat162_rn(64.0f)) {}
};

__device__ __forceinline__ B2 pair_b2(const K9B2& c, B2 rx, B2 ry, B2 rz,
                                      B2 s, B2 wh, B2 wb, B2 ax, B2 ay,
                                      B2 az) {
  const B2 dx = __hsub2(rx, ax), dy = __hsub2(ry, ay), dz = __hsub2(rz, az);
  const B2 r2 = __hfma2(dz, dz, __hfma2(dy, dy, __hmul2(dx, dx)));
  const B2 d = __hsub2(sqrt_b2(r2), s);
  const B2 v = __hmul2(d, c.cv);
  const B2 u = __hfma2(d, c.cu, c.cu0);
  const B2 g1 = ex2_b2(__hmul2(__hneg2(v), v));
  const B2 g2 = ex2_b2(__hmul2(__hneg2(u), u));
  const B2 m = __hmin2(d, c.zero);
  const B2 hyd = __hmin2(__hmax2(__hfma2(d, c.cs, c.ch), c.zero), c.one);
  const B2 hb = __hmin2(__hmax2(__hfma2(d, c.cs, c.chb), c.zero), c.one);
  const B2 e = __hfma2(c.wg1, g1, __hfma2(c.wg2, g2,
               __hfma2(__hmul2(c.wrep, m), m,
                       __hfma2(wh, hyd, __hmul2(wb, hb)))));
  return __hmul2(e, __hlt2(r2, c.cut));    // 1 or 0: the cutoff's select
}

// lig (3N, L), ligp (8, N), rec (K, 4) x y z radius, recp (K, 4) phi don
// acc _; `atoms` ligand atoms a block (blockIdx.z); shared memory: 48 B an
// atom in float32 (x0 x1 y0 y1 | z0 z1 p0 p1 | p2 p3 - -), 32 B in
// bfloat16 (x y z p0 | p1 p2 p3 -, each a __nv_bfloat162).
template <bool BF16>
__global__ void __launch_bounds__(K9_THREADS) k_probe_pairs(
    const float* lig, const float* ligp, const float* rec, const float* recp,
    int L, int N, int K, int reps, int atoms, unsigned long long* slots,
    unsigned epoch, float* out) {
  extern __shared__ uint4 k9_smem[];
  const int t = threadIdx.x;
  const int l0 = blockIdx.y * K9_LT;
  const int a0 = blockIdx.z * atoms;
  const int na = min(atoms, N - a0);
  for (int i = t; i < na; i += K9_THREADS) {
    const int a = a0 + i;
    float c[3][K9_LT];
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int h = 0; h < K9_LT; ++h)
        c[q][h] = l0 + h < L ? lig[(size_t)(q * N + a) * L + l0 + h]
                             : -K9_FAR;
    const float p0 = ligp[a], p1 = ligp[N + a], p2 = ligp[2 * N + a],
                p3 = ligp[3 * N + a];
    if (BF16) {
      k9_smem[2 * i] = make_uint4(
          b2u(__floats2bfloat162_rn(c[0][0], c[0][1])),
          b2u(__floats2bfloat162_rn(c[1][0], c[1][1])),
          b2u(__floats2bfloat162_rn(c[2][0], c[2][1])),
          b2u(__float2bfloat162_rn(p0)));
      k9_smem[2 * i + 1] = make_uint4(b2u(__float2bfloat162_rn(p1)),
                                      b2u(__float2bfloat162_rn(p2)),
                                      b2u(__float2bfloat162_rn(p3)), 0u);
    } else {
      float4* f = reinterpret_cast<float4*>(k9_smem) + 3 * i;
      f[0] = make_float4(c[0][0], c[0][1], c[1][0], c[1][1]);
      f[1] = make_float4(c[2][0], c[2][1], p0, p1);
      f[2] = make_float4(p2, p3, 0.0f, 0.0f);
    }
  }
  // the thread's receptor atoms, loaded once; phi, don and acc carry the
  // terms' weights
  float rx[K9_KT], ry[K9_KT], rz[K9_KT], rr[K9_KT], phw[K9_KT], dnw[K9_KT],
      acw[K9_KT];
#pragma unroll
  for (int j = 0; j < K9_KT; ++j) {
    const int k = (blockIdx.x * K9_KT + j) * K9_THREADS + t;
    float4 r0 = make_float4(K9_FAR, K9_FAR, K9_FAR, 0.0f);
    float4 r1 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (k < K) {
      r0 = __ldg(reinterpret_cast<const float4*>(rec) + k);
      r1 = __ldg(reinterpret_cast<const float4*>(recp) + k);
    }
    rx[j] = r0.x, ry[j] = r0.y, rz[j] = r0.z, rr[j] = r0.w;
    phw[j] = -0.0351f * r1.x, dnw[j] = -0.587f * r1.y,
    acw[j] = -0.587f * r1.z;
  }
  __syncthreads();
  float carry = 0.0f;
  if (BF16) {
    const K9B2 c;
    B2 bx[K9_KT], by[K9_KT], bz[K9_KT], br[K9_KT], bph[K9_KT], bdn[K9_KT],
        bac[K9_KT];
#pragma unroll
    for (int j = 0; j < K9_KT; ++j) {
      bx[j] = __float2bfloat162_rn(rx[j]), by[j] = __float2bfloat162_rn(ry[j]);
      bz[j] = __float2bfloat162_rn(rz[j]), br[j] = __float2bfloat162_rn(rr[j]);
      bph[j] = __float2bfloat162_rn(phw[j]);
      bdn[j] = __float2bfloat162_rn(dnw[j]);
      bac[j] = __float2bfloat162_rn(acw[j]);
    }
    for (int rep = 0; rep < reps; ++rep) {
      // the atoms come from shared memory again: no repetition is folded
      // into another
      asm volatile("" ::: "memory");
      float acc[K9_KT];
#pragma unroll
      for (int j = 0; j < K9_KT; ++j) acc[j] = j ? 0.0f : carry * 1e-30f;
#pragma unroll 2
      for (int i = 0; i < na; ++i) {
        const uint4 q0 = k9_smem[2 * i], q1 = k9_smem[2 * i + 1];
#pragma unroll
        for (int j = 0; j < K9_KT; ++j) {
          const B2 s = __hadd2(br[j], u2b(q0.w));
          const B2 wh = __hmul2(u2b(q1.x), bph[j]);
          const B2 wb = __hfma2(u2b(q1.y), bac[j],
                                __hmul2(u2b(q1.z), bdn[j]));
          const B2 e = pair_b2(c, bx[j], by[j], bz[j], s, wh, wb,
                               u2b(q0.x), u2b(q0.y), u2b(q0.z));
          acc[j] += __low2float(e);
          acc[j] += __high2float(e);
        }
      }
      float sum = acc[0];
#pragma unroll
      for (int j = 1; j < K9_KT; ++j) sum += acc[j];
      carry += sum;
    }
  } else {
    const float4* sm = reinterpret_cast<const float4*>(k9_smem);
    for (int rep = 0; rep < reps; ++rep) {
      asm volatile("" ::: "memory");
      float acc[K9_KT];
#pragma unroll
      for (int j = 0; j < K9_KT; ++j) acc[j] = j ? 0.0f : carry * 1e-30f;
#pragma unroll 2
      for (int i = 0; i < na; ++i) {
        const float4 q0 = sm[3 * i], q1 = sm[3 * i + 1], q2 = sm[3 * i + 2];
#pragma unroll
        for (int j = 0; j < K9_KT; ++j) {
          const float s = rr[j] + q1.z;
          const float wh = q1.w * phw[j];
          const float wb = fmaf(q2.x, acw[j], q2.y * dnw[j]);
          acc[j] += pair_f32(rx[j], ry[j], rz[j], s, wh, wb, q0.x, q0.z,
                             q1.x);
          acc[j] += pair_f32(rx[j], ry[j], rz[j], s, wh, wb, q0.y, q0.w,
                             q1.y);
        }
      }
      float sum = acc[0];
#pragma unroll
      for (int j = 1; j < K9_KT; ++j) sum += acc[j];
      carry += sum;
    }
  }
  block_finish(carry, slots, epoch, out);
}

// ----------------------------------------------------------------- K10 ----
//
// The (lookup, repetition) units u = rep * A + a are dealt to the threads
// of the grid in K10_UNITS turns: thread g takes u = g + k * (threads of
// the grid), k < K10_UNITS (probes.gather_plan sizes the grid so that the
// turns cover every unit).  At the default sizes that is 128 blocks, about
// one an SM, and each thread's units are one lookup at five repetitions.
// Each unit issues its own loads of the row's 8 values, two 16-byte loads
// that bypass L1 (ld.global.cg, so every row load is an L2 access), as
// volatile asm that the compiler may neither merge nor drop; all of a
// thread's loads are issued before the first is used, so every
// repetition's loads are in flight at once.  w[a] comes by the read-only
// path.
#define K10_THREADS 128
#define K10_UNITS 5

__device__ __forceinline__ float4 ld_cg_v4(const float4* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

__global__ void __launch_bounds__(K10_THREADS) k_probe_gather(
    const int* idx, const float* cells, const float* w, int A, int units,
    unsigned long long* slots, unsigned epoch, float* out) {
  const int g = blockIdx.x * K10_THREADS + threadIdx.x;
  const int stride = gridDim.x * K10_THREADS;
  float4 c[K10_UNITS][2], wv[K10_UNITS][2];
#pragma unroll
  for (int k = 0; k < K10_UNITS; ++k) {
    const int u = g + k * stride;
    c[k][0] = c[k][1] = wv[k][0] = wv[k][1] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u < units) {
      const int a = u % A;
      const float4* row = reinterpret_cast<const float4*>(
          cells + (size_t)__ldg(idx + a) * 128);
      const float4* wa = reinterpret_cast<const float4*>(w + (size_t)a * 8);
      c[k][0] = ld_cg_v4(row);
      c[k][1] = ld_cg_v4(row + 1);
      wv[k][0] = __ldg(wa);
      wv[k][1] = __ldg(wa + 1);
    }
  }
  float v = 0.0f;
#pragma unroll
  for (int k = 0; k < K10_UNITS; ++k) {
    float d = c[k][0].x * wv[k][0].x;
    d = fmaf(c[k][0].y, wv[k][0].y, d), d = fmaf(c[k][0].z, wv[k][0].z, d);
    d = fmaf(c[k][0].w, wv[k][0].w, d), d = fmaf(c[k][1].x, wv[k][1].x, d);
    d = fmaf(c[k][1].y, wv[k][1].y, d), d = fmaf(c[k][1].z, wv[k][1].z, d);
    v += fmaf(c[k][1].w, wv[k][1].w, d);
  }
  block_finish(v, slots, epoch, out);
}

// the floor: an empty kernel launched as K10 is
__global__ void k_empty() {}

// ----------------------------------------------------------------- K11 ----

__device__ __forceinline__ uint32_t onehot2(int k, int tgt) {
  // two bf16 values (columns k, k + 1) of the one-hot row; 0x3F80 = 1.0
  return (k == tgt ? 0x3F80u : 0u) | (k + 1 == tgt ? 0x3F800000u : 0u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma's shared-memory matrix descriptor for a B operand stored
// MN-major with the 128-byte swizzle: rows of 64 bf16 (128 B) along N, one
// row per k, 8 rows (1,024 B) per swizzle atom; the next 8 k rows lie
// 1,024 B on (the stride byte offset).  N = 64 is one 128-byte row, so the
// leading byte offset (the step to the next 64 columns) is never taken; it
// is set to the same 1,024 B.
__device__ __forceinline__ uint64_t desc_b128(uint32_t saddr) {
  return (uint64_t)((saddr >> 4) & 0x3FFFu)
         | ((uint64_t)(1024 >> 4) << 16)
         | ((uint64_t)(1024 >> 4) << 32)
         | ((uint64_t)1 << 62);
}

// d (64 x 64, float32, 32 registers a thread) += A (64 x 16, bf16, the
// register fragment a[4]) * B (16 x 64, bf16, shared memory, MN-major)
__device__ __forceinline__ void wgmma_m64n64k16(float* d, const uint32_t* a,
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads above the wait
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// G k steps of 16 from step ks: the one-hot fragments built in registers
// (rows t0, t1 of this thread; columns as mma.m16n8k16's A fragment, which
// is wgmma's register-A layout for the warp's 16 rows), G wgmma issued
// back to back, then one wait
template <int G>
__device__ __forceinline__ void onehot_steps(float* d, int ks, int t0, int t1,
                                             int tig, uint32_t gsm) {
  uint32_t a[G][4];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int ka = (ks + j) * 16 + tig * 2;
    a[j][0] = onehot2(ka, t0);
    a[j][1] = onehot2(ka, t1);
    a[j][2] = onehot2(ka + 8, t0);
    a[j][3] = onehot2(ka + 8, t1);
  }
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < G; ++j)
    wgmma_m64n64k16(d, a[j], desc_b128(gsm + (uint32_t)(ks + j) * 2048u));
  wgmma_commit_wait();
  fence_acc(d);
}

// One warpgroup (128 threads) per 64 rows of the one-hot (A, kdim) and one
// 64-column half of g (kdim, 128): grid (A / 64, 2).  Thread 0 loads the
// block's half of g into shared memory once, by TMA (a 2-D tensor map,
// 64 x 16 boxes, 128-byte swizzle, completed on one mbarrier), in the
// layout the wgmma descriptor names; every repetition then runs from shared
// memory with no barrier: kdim / 16 wgmma.m64n64k16, 8 at a time.
// The warps' sums over all repetitions go to the checksum by block_finish,
// slot blockIdx.x + gridDim.x * blockIdx.y the block's.  A % 64 == 0,
// kdim % 16 == 0, kdim <= MXU_KMAX (the block's half of g in shared
// memory), g is (kdim, 128).
#define MXU_KMAX 1792

__global__ void __launch_bounds__(GT) k_probe_mxu(
    const __grid_constant__ CUtensorMap gmap, const int* tgt, int A, int kdim,
    int reps, unsigned long long* slots, unsigned epoch, float* out) {
  extern __shared__ __align__(1024) unsigned char mxu_smem[];
  // the swizzle pattern is keyed on address bits 7-9: align g to 1,024 B
  const uint32_t base = smem_u32(mxu_smem);
  const uint32_t gsm = (base + 1023u) & ~1023u;
  const uint32_t bar = gsm + (uint32_t)kdim * 128u;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * 64 + warp * 16 + gid;
  const int t0 = tgt[row0], t1 = tgt[row0 + 8];
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar), "r"(kdim * 128) : "memory");
    const uint64_t map = reinterpret_cast<uint64_t>(&gmap);
    const int col = blockIdx.y * 64;
    for (int k0 = 0; k0 < kdim; k0 += 16)
      asm volatile(
          "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
          "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
          ::"r"(gsm + (uint32_t)k0 * 128u), "l"(map), "r"(col), "r"(k0),
          "r"(bar) : "memory");
  }
  // a copy that never lands ends the launch with an error, not a hang
  uint32_t ok = 0;
  for (long spins = 0; !ok; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], "
        "0;\nselp.u32 %0, 1, 0, p;\n}\n" : "=r"(ok) : "r"(bar) : "memory");
    if (spins > (1L << 26)) __trap();
  }
  const int steps = kdim / 16;
  float carry = 0.0f;
  for (int rep = 0; rep < reps; ++rep) {
    float d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] = 0.0f;
    if (lane == 0) d[0] = carry * 1e-30f;
    int ks = 0;
    for (; ks + 8 <= steps; ks += 8) onehot_steps<8>(d, ks, t0, t1, tig, gsm);
    for (; ks + 4 <= steps; ks += 4) onehot_steps<4>(d, ks, t0, t1, tig, gsm);
    for (; ks < steps; ++ks) onehot_steps<1>(d, ks, t0, t1, tig, gsm);
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; i += 4) s += (d[i] + d[i + 1]) + (d[i + 2] + d[i + 3]);
    carry += warp_sum(s);
  }
  // every lane holds its warp's carry
  block_finish(lane == 0 ? carry : 0.0f, slots, epoch, out);
}

// The tensor map of g (kdim, 128) bf16 for k_probe_mxu: 64 x 16 boxes with
// the 128-byte swizzle.  cuTensorMapEncodeTiled is the driver's; it is
// looked up in the already loaded libcuda so that the library links
// against the runtime alone.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static int g_tensor_map(CUtensorMap* map, const void* g, int kdim) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (!h) return (int)cudaErrorSharedObjectInitFailed;
    encode = (EncodeTiled)dlsym(h, "cuTensorMapEncodeTiled");
    if (!encode) return (int)cudaErrorSymbolNotFound;
  }
  const cuuint64_t dims[2] = {128, (cuuint64_t)kdim};
  const cuuint64_t strides[1] = {128 * 2};
  const cuuint32_t box[2] = {64, 16};
  const cuuint32_t estride[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(g), dims,
      strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// -------------------------------------------------------- C interface ----

extern "C" {

const char* gt_probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int gt_probe_pairs(const float* lig, const float* ligp, const float* rec,
                   const float* recp, int L, int N, int K, int reps, int bf16,
                   int gx, int gy, int gz, int atoms,
                   unsigned long long* slots, unsigned epoch, float* out,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  // the grid must be probes.pairs_plan's for this build's tile
  const int kb = K9_THREADS * K9_KT;
  const int smem = atoms * (bf16 ? 32 : 48);
  if (L < 1 || N < 1 || K < 1 || atoms < 1 || gx != (K + kb - 1) / kb
      || gy != (L + K9_LT - 1) / K9_LT || gz != (N + atoms - 1) / atoms
      || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(gx, gy, gz);
  if (bf16)
    k_probe_pairs<true><<<grid, K9_THREADS, smem, st>>>(
        lig, ligp, rec, recp, L, N, K, reps, atoms, slots, epoch, out);
  else
    k_probe_pairs<false><<<grid, K9_THREADS, smem, st>>>(
        lig, ligp, rec, recp, L, N, K, reps, atoms, slots, epoch, out);
  return (int)cudaGetLastError();
}

int gt_probe_gather(const int* idx, const float* cells, const float* w, int A,
                    int reps, int blocks, unsigned long long* slots,
                    unsigned epoch, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long units = (long long)A * reps;
  const long long per = (long long)K10_THREADS * K10_UNITS;
  if (A < 1 || reps < 1 || units > 0x7fffffffLL
      || blocks != (int)((units + per - 1) / per))
    return (int)cudaErrorInvalidValue;
  k_probe_gather<<<blocks, K10_THREADS, 0, st>>>(idx, cells, w, A, (int)units,
                                                 slots, epoch, out);
  return (int)cudaGetLastError();
}

int gt_probe_empty(int blocks, int threads, void* stream) {
  k_empty<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

int gt_probe_mxu(const int* tgt, const void* g, int A, int kdim, int reps,
                 unsigned long long* slots, unsigned epoch, float* out,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (A % 64 || kdim % 16 || kdim > MXU_KMAX || A == 0 || kdim == 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  int rc = g_tensor_map(&map, g, kdim);
  if (rc) return rc;
  const int smem = kdim * 128 + 1024 + 16;
  cudaError_t err = cudaFuncSetAttribute(
      k_probe_mxu, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k_probe_mxu<<<dim3(A / 64, 2), GT, smem, st>>>(map, tgt, A, kdim, reps,
                                                 slots, epoch, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
