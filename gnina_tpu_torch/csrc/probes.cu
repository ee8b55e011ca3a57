// Primitive-rate probes for Hopper (sm_90a): what the card does per pair
// term, per row gather and per one-hot contraction.
//
// Replaces the three Pallas probes of scripts/tpu_pallas_probe.py:
//   gt_probe_pairs   K9:  probe_pairs (:104, pallas_call :112; body
//                         make_pairs_kernel :48-101), in float32 and bfloat16
//   gt_probe_gather  K10: probe_gather_loop (:126, pallas_call :150)
//   gt_probe_mxu     K11: probe_mxu (:163, pallas_call :182)
// Each runs `reps` repetitions inside one launch and returns the scalar
// checksum the TPU kernel writes to out_ref[0, 0].  The plain PyTorch
// versions in gnina_tpu_torch/probes.py compute the same scalars.
//
// What bounds them: K9 is arithmetic (two exp per pair, FP32 or bf16
// pipes); K10 is load latency (one 32-byte row segment per lookup, rows
// scattered over an 8 MB table that stays in L2); K11 is the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 out).  The designs are the simple ones:
// K9 one block per lane with threads striding over the receptor, K10 one
// thread per lookup, K11 one warp per 16 rows with the 16 x 128 slab of g
// staged in shared memory for each k step (wgmma and TMA are left for later
// work).  A repetition starts its sum from carry * 1e-30, as the TPU kernel
// does (:92), so that the compiler cannot fold the repetitions into one; the
// carry is the thread's, warp's or block's own, not the whole grid's, which
// moves the checksum by less than 1e-25 of itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PT 256   // threads per block, pairs and final sum
#define GT 128   // threads per block, gather and mxu

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// sum over the block, returned to every thread (blockDim.x = PT)
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int i = 0; i < PT / 32; ++i) s += red[i];
  __syncthreads();
  return s;
}

// out[0] = sum of x[0..n), one block, fixed order
__global__ void __launch_bounds__(PT) k_sum(const float* x, int n, float* out) {
  __shared__ float red[PT / 32];
  float v = 0.0f;
  for (int i = threadIdx.x; i < n; i += PT) v += x[i];
  const float s = block_sum(v, red);
  if (threadIdx.x == 0) out[0] = s;
}

// ------------------------------------------------------------------ K9 ----

template <typename T> struct Num;

template <> struct Num<float> {
  static __device__ __forceinline__ float from(float x) { return x; }
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
  static __device__ __forceinline__ float exp_(float x) { return expf(x); }
  static __device__ __forceinline__ float clip01(float x) {
    return fminf(fmaxf(x, 0.0f), 1.0f);
  }
};

template <> struct Num<__nv_bfloat16> {
  typedef __nv_bfloat16 B;
  static __device__ __forceinline__ B from(float x) { return __float2bfloat16(x); }
  static __device__ __forceinline__ float to_f(B x) { return __bfloat162float(x); }
  static __device__ __forceinline__ B sqrt_(B x) { return hsqrt(x); }
  static __device__ __forceinline__ B exp_(B x) { return hexp(x); }
  static __device__ __forceinline__ B clip01(B x) {
    return __hmin(__hmax(x, __float2bfloat16(0.0f)), __float2bfloat16(1.0f));
  }
};

// One block per lane.  lig (3N, L), ligp (8, N), rec (K, 4) x y z radius,
// recp (K, 4) phi don acc _.  Pair arithmetic in T; the pair energies are
// summed in float32.  partial[l] = the lane's sum over all repetitions.
template <typename T>
__global__ void __launch_bounds__(PT) k_probe_pairs(
    const float* lig, const float* ligp, const float* rec, const float* recp,
    int L, int N, int K, int reps, float* partial) {
  typedef Num<T> X;
  __shared__ float red[PT / 32];
  const int l = blockIdx.x, t = threadIdx.x;
  const float4* rec4 = reinterpret_cast<const float4*>(rec);
  const float4* recp4 = reinterpret_cast<const float4*>(recp);
  const T zero = X::from(0.0f);
  const T c_m4 = X::from(-4.0f), c_3 = X::from(3.0f), c_h = X::from(0.5f);
  const T c_s = X::from(1.4285715f), c_hb = X::from(0.42857143f);
  const T w_g1 = X::from(-0.0356f), w_g2 = X::from(0.00516f);
  const T w_rep = X::from(0.84f), w_hyd = X::from(0.0351f);
  const T w_hb = X::from(0.587f), c_cut = X::from(64.0f);
  float carry = 0.0f;
  for (int rep = 0; rep < reps; ++rep) {
    float acc = (t == 0) ? carry * 1e-30f : 0.0f;
    for (int a = 0; a < N; ++a) {
      const T ax = X::from(lig[(size_t)a * L + l]);
      const T ay = X::from(lig[(size_t)(N + a) * L + l]);
      const T az = X::from(lig[(size_t)(2 * N + a) * L + l]);
      const T lp0 = X::from(ligp[a]), lp1 = X::from(ligp[N + a]);
      const T lp2 = X::from(ligp[2 * N + a]), lp3 = X::from(ligp[3 * N + a]);
      for (int k = t; k < K; k += PT) {
        const float4 r0 = __ldg(rec4 + k), r1 = __ldg(recp4 + k);
        const T dx = X::from(r0.x) - ax, dy = X::from(r0.y) - ay,
                dz = X::from(r0.z) - az;
        const T r2 = dx * dx + dy * dy + dz * dz;
        const T r = X::sqrt_(r2);
        const T d = r - (X::from(r0.w) + lp0);
        const T g1 = X::exp_(c_m4 * d * d);
        const T dd = (d - c_3) * c_h;
        const T g2 = X::exp_(-dd * dd);
        const T rp = (d < zero) ? d * d : zero;
        const T hyd = X::clip01(-d * c_s - c_h) * (lp1 * X::from(r1.x));
        const T hb = X::clip01(-d * c_s - c_hb)
                     * (lp2 * X::from(r1.z) + lp3 * X::from(r1.y));
        T e = w_g1 * g1 - w_g2 * g2 + w_rep * rp - w_hyd * hyd - w_hb * hb;
        if (!(r2 < c_cut)) e = zero;
        acc += X::to_f(e);
      }
    }
    carry += block_sum(acc, red);
  }
  if (t == 0) partial[l] = carry;
}

// ----------------------------------------------------------------- K10 ----

// One thread per lookup a: dot of the first 8 values of row idx[a] of cells
// (R, 128) with w[a, :8].  The memory clobber makes every repetition load
// again.  partial[a] = the lookup's sum over all repetitions.
__global__ void __launch_bounds__(GT) k_probe_gather(
    const int* idx, const float* cells, const float* w, int A, int reps,
    float* partial) {
  const int a = blockIdx.x * GT + threadIdx.x;
  if (a >= A) return;
  float carry = 0.0f;
  for (int rep = 0; rep < reps; ++rep) {
    asm volatile("" ::: "memory");
    const float* row = cells + (size_t)idx[a] * 128;
    const float* wa = w + (size_t)a * 8;
    float acc = carry * 1e-30f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc += row[c] * wa[c];
    carry += acc;
  }
  partial[a] = carry;
}

// ----------------------------------------------------------------- K11 ----

__device__ __forceinline__ uint32_t onehot2(int k, int tgt) {
  // two bf16 values (columns k, k + 1) of the one-hot row; 0x3F80 = 1.0
  return (k == tgt ? 0x3F80u : 0u) | (k + 1 == tgt ? 0x3F800000u : 0u);
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One warp per 16 rows of the one-hot (A, kdim), four warps a block.  For
// each k step the block stages g[k0:k0+16, 0:128] in shared memory; a warp
// builds its A fragment from tgt in registers and runs 16 mma.sync, one per
// 8 columns, into 64 float32 accumulators.  partial[warp] = the warp's sum
// over all repetitions.  A % 64 == 0, kdim % 16 == 0, g is (kdim, 128).
__global__ void __launch_bounds__(GT) k_probe_mxu(
    const int* tgt, const __nv_bfloat16* g, int A, int kdim, int reps,
    float* partial) {
  __shared__ __align__(16) unsigned short slab[16 * 128];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * 64 + warp * 16 + gid;
  const int t0 = tgt[row0], t1 = tgt[row0 + 8];
  float carry = 0.0f;
  for (int rep = 0; rep < reps; ++rep) {
    float c[16][4];
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.0f;
    if (lane == 0) c[0][0] = carry * 1e-30f;
    for (int k0 = 0; k0 < kdim; k0 += 16) {
      __syncthreads();
      const uint4* src = reinterpret_cast<const uint4*>(g + (size_t)k0 * 128);
      uint4* dst = reinterpret_cast<uint4*>(slab);
      dst[t] = src[t];
      dst[t + GT] = src[t + GT];
      __syncthreads();
      const int ka = k0 + tig * 2;
      const uint32_t a0 = onehot2(ka, t0), a1 = onehot2(ka, t1);
      const uint32_t a2 = onehot2(ka + 8, t0), a3 = onehot2(ka + 8, t1);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
        const int n = nt * 8 + gid;
        const uint32_t b0 = (uint32_t)slab[(tig * 2) * 128 + n]
                            | ((uint32_t)slab[(tig * 2 + 1) * 128 + n] << 16);
        const uint32_t b1 = (uint32_t)slab[(tig * 2 + 8) * 128 + n]
                            | ((uint32_t)slab[(tig * 2 + 9) * 128 + n] << 16);
        mma_bf16(c[nt], a0, a1, a2, a3, b0, b1);
      }
    }
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < 16; ++i) s += (c[i][0] + c[i][1]) + (c[i][2] + c[i][3]);
    carry += warp_sum(s);
  }
  if (lane == 0) partial[blockIdx.x * (GT / 32) + warp] = carry;
}

// -------------------------------------------------------- C interface ----

extern "C" {

const char* gt_probe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int gt_probe_pairs(const float* lig, const float* ligp, const float* rec,
                   const float* recp, int L, int N, int K, int reps, int bf16,
                   float* partial, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    k_probe_pairs<__nv_bfloat16><<<L, PT, 0, st>>>(lig, ligp, rec, recp, L, N,
                                                   K, reps, partial);
  else
    k_probe_pairs<float><<<L, PT, 0, st>>>(lig, ligp, rec, recp, L, N, K, reps,
                                           partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k_sum<<<1, PT, 0, st>>>(partial, L, out);
  return (int)cudaGetLastError();
}

int gt_probe_gather(const int* idx, const float* cells, const float* w, int A,
                    int reps, float* partial, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  k_probe_gather<<<(A + GT - 1) / GT, GT, 0, st>>>(idx, cells, w, A, reps,
                                                   partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k_sum<<<1, PT, 0, st>>>(partial, A, out);
  return (int)cudaGetLastError();
}

int gt_probe_mxu(const int* tgt, const void* g, int A, int kdim, int reps,
                 float* partial, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (A % 64 || kdim % 16) return (int)cudaErrorInvalidValue;
  k_probe_mxu<<<A / 64, GT, 0, st>>>(
      tgt, reinterpret_cast<const __nv_bfloat16*>(g), A, kdim, reps, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k_sum<<<1, PT, 0, st>>>(partial, A / 16, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
