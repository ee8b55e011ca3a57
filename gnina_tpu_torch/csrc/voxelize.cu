// The CNN rescore's voxeliser for Hopper (sm_90a): the atom-density grids
// of a chunk of poses, receptor and ligand, in one launch.
//
// Replaces no TPU kernel: the JAX package voxelises in plain XLA
// (gnina_tpu/ops/voxelize.py voxelize_batch and voxelize_windowed), and so
// does the port's plain version (gnina_tpu_torch/ops/voxelize.py), which
// the rescore runs on the CPU, with rotations and under autograd.  Here it
// replaces the plain slab loop on the card, which builds (poses, slabs,
// points, atoms) distance and density tensors through separate elementwise
// kernels, reduces them to channels with a one-hot matrix product and
// returns a permuted view that the first convolution copies again.
//
//   gt_voxelize   grids (B, C, n, n, n), contiguous, of one receptor and B
//                 ligand poses (or none) at B grid centres
//
// What it computes is voxelize_windowed(receptor) + voxelize_batch(ligand):
// for each grid point and channel, the sum over the channel's atoms of
//   exp(-2 d^2 / r^2)              for d <= r,
//   e^-2 (2 d / r - 3)^2           for r < d <= 1.5 r,   else 0,
// with r the atom's radius times the radius scale, d^2 the sum of squared
// coordinate differences (not the expansion: ops/voxelize.py says why),
// the grid points of grid_points_1d (origin = centre - res (n - 1) / 2,
// then origin + res i, each rounded as PyTorch rounds it), masked atoms and
// channel -1 skipped, all in float32 with IEEE division, square root and
// the full-precision exp.  Only the order in which one channel's atoms are
// added differs from the plain version's matrix product: a few ulps.
//
// What bounds it on an H100 SXM: the grids.  28 channels of 48^3 float32
// are 12.4 MB a pose, written once, 3.7 us at 3.35 TB/s; the density
// evaluations within 1.5 r are about half a million a pose, under 0.1 us
// at the FP32 rate.  So the kernel must write every grid
// value once, in the layout the convolutions read, and keep the distance
// tests it spends on atoms out of reach cheap.  The design:
//  - One 256-thread block a (pose, tile of 8 x 8 x 16 grid points); a
//    thread owns 4 points along x at one (y, z), so 16 threads write 64
//    contiguous bytes of a z row.
//  - The block gathers the atoms whose reach (1.5 r, padded) overlaps its
//    tile into shared memory: the receptor rows of the x range the tile
//    can see, found by a block-wide search over the receptor sorted by x
//    (the rescore sorts it once a call, prepare_multi), then the pose's
//    ligand atoms.  The gather compacts with ballots in scan order, and
//    warp 0 sorts the gathered atoms by channel (a stable counting sort
//    with __match_any_sync), so the order of every sum is fixed: two
//    launches give the same bits, and no atomic touches a value.
//  - Channel by channel, each thread adds the channel's atoms into 4
//    registers and stores them: every grid value is written once, zeros
//    included, with no read.  More atoms than the shared list holds (512)
//    are taken in further passes that add to the values already stored.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define VX_TX 8            // tile points along x, y, z
#define VX_TY 8
#define VX_TZ 16
#define VX_THREADS 256
#define VX_XPT 4           // x points a thread: VX_TX * VX_TY * VX_TZ / threads
#define VX_CAP 512         // gathered atoms held in shared memory at once
#define VX_MAXC 64         // channels

static_assert(VX_TY * VX_TZ * (VX_TX / VX_XPT) == VX_THREADS,
              "a thread owns VX_XPT points of one (y, z) column");
static_assert(VX_CAP % VX_THREADS == 0 && VX_CAP >= 2 * VX_THREADS,
              "a gather round adds at most one atom a thread");

struct VoxArgs {
  const float* rec_xyz;        // (K, 3), valid rows sorted by x, then masked
  const int* rec_chan;         // (K,) channel, -1 = skip
  const float* rec_rad;        // (K,) radius before the scale
  const uint8_t* rec_mask;     // (K,) row present
  const float* rec_rmax;       // (1,) the largest of rec_rad (on the card)
  int K;
  const float* lig_xyz;        // (B, N, 3)
  const int* lig_chan;         // (B, N)
  const float* lig_rad;        // (B, N)
  const uint8_t* lig_mask;     // (B, N)
  int N;
  const float* centers;        // (B, 3)
  int C, n;
  float res, half, scale;      // half = res (n - 1) / 2
  int tiles_y, tiles_z;
};

struct Atom {                  // one gathered atom, 32 bytes
  float x, y, z, r2;           // r2 = r^2
  float lim2, k, tr, pad;      // 2.25 r^2, -2 / r^2, 2 / r
};

__device__ __forceinline__ float grid_point(float origin, float res, int i) {
  return __fadd_rn(origin, __fmul_rn(res, (float)i));
}

// Rows of the receptor whose key is below `target` (or at most `target`,
// inclusive): the keys are x for present rows, ascending, then +inf for the
// masked rows.  Every thread of the block calls it; 256 samples a round
// narrow the range 256-fold.
__device__ int block_rank(const VoxArgs& a, float target, bool inclusive) {
  int lo = 0, hi = a.K;        // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + VX_THREADS - 1) / VX_THREADS;
    const int i = lo + (int)threadIdx.x * step;
    int below = 0;
    if (i < hi) {
      const float key = a.rec_mask[i] ? a.rec_xyz[3 * i] : INFINITY;
      below = inclusive ? key <= target : key < target;
    }
    const int cnt = __syncthreads_count(below);
    if (cnt == 0) break;
    const int nlo = lo + (cnt - 1) * step + 1;
    hi = min(lo + cnt * step, hi);
    lo = nlo;
  }
  return lo;
}

__device__ __forceinline__ float density(float d2c, const Atom& at) {
  if (d2c <= at.r2) return expf(__fmul_rn(d2c, at.k));
  const float t = __fsub_rn(__fmul_rn(sqrtf(d2c), at.tr), 3.0f);
  return __fmul_rn(__fmul_rn(0.1353352832366127f, t), t);   // e^-2 t^2
}

__global__ void __launch_bounds__(VX_THREADS)
k_voxelize(VoxArgs a, float* __restrict__ out) {
  __shared__ Atom atoms[VX_CAP];
  __shared__ uint8_t chan[VX_CAP];
  __shared__ uint16_t order[VX_CAP];
  __shared__ int chstart[VX_MAXC + 1];
  __shared__ int run[VX_MAXC];
  __shared__ int warp_n[VX_THREADS / 32];

  const int n = a.n, C = a.C;
  const int b = blockIdx.y;
  const int tile = blockIdx.x;
  const int i0 = tile / (a.tiles_z * a.tiles_y) * VX_TX;
  const int j0 = (tile / a.tiles_z) % a.tiles_y * VX_TY;
  const int k0 = tile % a.tiles_z * VX_TZ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the pose's grid origin and the tile's extent, as grid_points_1d
  const float ox = __fsub_rn(a.centers[3 * b], a.half);
  const float oy = __fsub_rn(a.centers[3 * b + 1], a.half);
  const float oz = __fsub_rn(a.centers[3 * b + 2], a.half);
  const float x_lo = grid_point(ox, a.res, i0);
  const float x_hi = grid_point(ox, a.res, min(i0 + VX_TX, n) - 1);
  const float y_lo = grid_point(oy, a.res, j0);
  const float y_hi = grid_point(oy, a.res, min(j0 + VX_TY, n) - 1);
  const float z_lo = grid_point(oz, a.res, k0);
  const float z_hi = grid_point(oz, a.res, min(k0 + VX_TZ, n) - 1);

  // the thread's points
  const int gz = k0 + threadIdx.x % VX_TZ;
  const int gy = j0 + threadIdx.x / VX_TZ % VX_TY;
  const int gx0 = i0 + threadIdx.x / (VX_TZ * VX_TY) * VX_XPT;
  const float pz = grid_point(oz, a.res, gz);
  const float py = grid_point(oy, a.res, gy);
  float px[VX_XPT];
#pragma unroll
  for (int q = 0; q < VX_XPT; ++q) px[q] = grid_point(ox, a.res, gx0 + q);
  const bool live = gy < n && gz < n;

  // the receptor rows whose x lies within the largest reach of the tile;
  // the reach is padded so that rounding never drops an atom that touches
  // a point (an atom taken in excess adds exact zeros)
  int r0 = 0, r1 = 0;
  if (a.K > 0) {
    const float reach = 1.5f * a.rec_rmax[0] * a.scale * 1.001f + 1e-3f;
    r0 = block_rank(a, x_lo - reach, false);
    r1 = block_rank(a, x_hi + reach, true);
  }
  const int nrec = max(r1 - r0, 0);
  const int total = nrec + a.N;

  int scan = 0;
  bool first = true;
  do {
    // gather up to VX_CAP atoms that can reach the tile, in scan order
    int count = 0;
    while (scan < total && count <= VX_CAP - VX_THREADS) {
      const int v = scan + (int)threadIdx.x;
      bool take = false;
      Atom at;
      int ch = -1;
      if (v < total) {
        float x, y, z, rad;
        bool present;
        if (v < nrec) {
          const int i = r0 + v;
          present = a.rec_mask[i];
          ch = a.rec_chan[i];
          x = a.rec_xyz[3 * i];
          y = a.rec_xyz[3 * i + 1];
          z = a.rec_xyz[3 * i + 2];
          rad = a.rec_rad[i];
        } else {
          const size_t j = (size_t)b * a.N + (v - nrec);
          present = a.lig_mask[j];
          ch = a.lig_chan[j];
          x = a.lig_xyz[3 * j];
          y = a.lig_xyz[3 * j + 1];
          z = a.lig_xyz[3 * j + 2];
          rad = a.lig_rad[j];
        }
        if (present && ch >= 0 && ch < C) {
          const float r = __fmul_rn(rad, a.scale);
          const float reach = 1.5f * fabsf(r) * 1.001f + 1e-3f;
          take = x >= x_lo - reach && x <= x_hi + reach
              && y >= y_lo - reach && y <= y_hi + reach
              && z >= z_lo - reach && z <= z_hi + reach;
          if (take) {
            const float rinv = 1.0f / fmaxf(r, 1e-12f);
            at.x = x;
            at.y = y;
            at.z = z;
            at.r2 = __fmul_rn(r, r);
            at.lim2 = __fmul_rn(2.25f, at.r2);
            at.k = __fmul_rn(__fmul_rn(-2.0f, rinv), rinv);
            at.tr = __fmul_rn(2.0f, rinv);
            at.pad = 0.0f;
          }
        }
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, take);
      if (lane == 0) warp_n[warp] = __popc(ballot);
      __syncthreads();
      int before = count, after = count;
#pragma unroll
      for (int w = 0; w < VX_THREADS / 32; ++w) {
        before += w < warp ? warp_n[w] : 0;
        after += warp_n[w];
      }
      if (take) {
        const int pos = before + __popc(ballot & ((1u << lane) - 1u));
        atoms[pos] = at;
        chan[pos] = (uint8_t)ch;
      }
      count = after;
      scan += VX_THREADS;
      __syncthreads();
    }

    // warp 0: a stable counting sort of the gathered atoms by channel
    if (warp == 0) {
      for (int c = lane; c < C; c += 32) run[c] = 0;
      __syncwarp();
      for (int base = 0; base < count; base += 32) {
        const int i = base + lane;
        const int ch = i < count ? chan[i] : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, ch);
        if (i < count && lane == __ffs(peers) - 1) run[ch] += __popc(peers);
        __syncwarp();
      }
      if (lane == 0) {
        int s = 0;
        for (int c = 0; c < C; ++c) {
          chstart[c] = s;
          s += run[c];
          run[c] = chstart[c];
        }
        chstart[C] = s;
      }
      __syncwarp();
      for (int base = 0; base < count; base += 32) {
        const int i = base + lane;
        const int ch = i < count ? chan[i] : -1;
        const unsigned peers = __match_any_sync(0xffffffffu, ch);
        if (i < count)
          order[run[ch] + __popc(peers & ((1u << lane) - 1u))] = (uint16_t)i;
        __syncwarp();
        if (i < count && lane == __ffs(peers) - 1) run[ch] += __popc(peers);
        __syncwarp();
      }
    }
    __syncthreads();

    // channel by channel: each thread's 4 points, stored once
    for (int c = 0; c < C; ++c) {
      float acc[VX_XPT];
#pragma unroll
      for (int q = 0; q < VX_XPT; ++q) acc[q] = 0.0f;
      const int e1 = chstart[c + 1];
      for (int e = chstart[c]; e < e1; ++e) {
        const Atom at = atoms[order[e]];
        const float dy = py - at.y, dz = pz - at.z;
        const float dyz = fmaf(dz, dz, dy * dy);
#pragma unroll
        for (int q = 0; q < VX_XPT; ++q) {
          const float dx = px[q] - at.x;
          const float d2c = fmaxf(fmaf(dx, dx, dyz), 1e-12f);
          if (d2c <= at.lim2) acc[q] += density(d2c, at);
        }
      }
      if (live) {
        const size_t row = (((size_t)b * C + c) * n) * n * n
                         + (size_t)gy * n + gz;
#pragma unroll
        for (int q = 0; q < VX_XPT; ++q) {
          if (gx0 + q < n) {
            float* o = out + row + (size_t)(gx0 + q) * n * n;
            *o = first ? acc[q] : *o + acc[q];
          }
        }
      }
    }
    first = false;
    __syncthreads();           // the next pass reuses the shared lists
  } while (scan < total);
}

extern "C" {

const char* gt_voxelize_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int gt_voxelize(const float* rec_xyz, const int* rec_chan,
                const float* rec_rad, const uint8_t* rec_mask,
                const float* rec_rmax, int K, const float* lig_xyz,
                const int* lig_chan, const float* lig_rad,
                const uint8_t* lig_mask, int N, const float* centers, int B,
                int C, int n, float res, float half, float scale, float* out,
                void* stream) {
  if (B < 1 || B > 65535 || C < 1 || C > VX_MAXC || n < 1 || K < 0 || N < 0)
    return (int)cudaErrorInvalidValue;
  VoxArgs a;
  a.rec_xyz = rec_xyz;
  a.rec_chan = rec_chan;
  a.rec_rad = rec_rad;
  a.rec_mask = rec_mask;
  a.rec_rmax = rec_rmax;
  a.K = K;
  a.lig_xyz = lig_xyz;
  a.lig_chan = lig_chan;
  a.lig_rad = lig_rad;
  a.lig_mask = lig_mask;
  a.N = N;
  a.centers = centers;
  a.C = C;
  a.n = n;
  a.res = res;
  a.half = half;
  a.scale = scale;
  a.tiles_y = (n + VX_TY - 1) / VX_TY;
  a.tiles_z = (n + VX_TZ - 1) / VX_TZ;
  const int tiles = (n + VX_TX - 1) / VX_TX * a.tiles_y * a.tiles_z;
  k_voxelize<<<dim3(tiles, B), VX_THREADS, 0, (cudaStream_t)stream>>>(a, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
