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
// (bf16 in, f32 out).  K9 and K10 are the simple designs: one block per
// lane with threads striding over the receptor, one thread per lookup.
// K11 is built for Hopper: one warpgroup per 64 rows and 64-column half of
// g, 128 blocks for 132 SMs at A = 4,096; the block's half of g (114.7 KB
// at kdim 896) comes into shared memory once, by TMA in the 128-byte
// swizzled layout that the wgmma descriptor names, and every repetition is
// kdim / 16 wgmma.m64n64k16 with the one-hot A built in registers, eight
// issued between waits, with no block barrier.  What bounds it then is the
// one-time load and wgmma's issue and wait latency: 20 repetitions of 56
// steps are 2 x 4,096 x 896 x 128 x 20 operations, 0.019 ms at 989
// TFLOP/s.  A repetition starts its sum from carry * 1e-30, as the TPU kernel
// does (:92), so that the compiler cannot fold the repetitions into one; the
// carry is the thread's, warp's or block's own, not the whole grid's, which
// moves the checksum by less than 1e-25 of itself.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
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
// partial[(blockIdx.x * 2 + blockIdx.y) * 4 + warp] = the warp's sum over
// all repetitions.  A % 64 == 0, kdim % 16 == 0, kdim <= MXU_KMAX (the
// block's half of g in shared memory), g is (kdim, 128).
#define MXU_KMAX 1792

__global__ void __launch_bounds__(GT) k_probe_mxu(
    const __grid_constant__ CUtensorMap gmap, const int* tgt, int A, int kdim,
    int reps, float* partial) {
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
  if (lane == 0)
    partial[(blockIdx.x * 2 + blockIdx.y) * (GT / 32) + warp] = carry;
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
                                                 partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k_sum<<<1, PT, 0, st>>>(partial, A / 8, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
