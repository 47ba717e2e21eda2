// Nearest valid neighbour distance, for Hopper.
//
// Replaces: src/repro/kernels/pairwise.py :: nearest_dist_pallas (kernel
// body _kernel), behind repro.kernels.ops.nearest_dist.
//
// What it computes: out[i] = min over valid j of
//   |a_i|^2 + |b_j|^2 - 2 a_i . b_j
// in f32 for a [M, D], b [N, D] (D <= 8) and b_valid [N]; 1e30 where no
// b_j is valid.
//
// Arithmetic.  The kernel evaluates the same expansion in another order:
//   t_j = fma(-2 a_z, b_z, fma(-2 a_y, b_y, fma(-2 a_x, b_x, |b_j|^2)))
//   out = |a|^2 + min_j t_j
// (-2 a is exact; |a|^2 and |b|^2 are sums of squares rounded term by
// term, as the plain version's are).  With u = 2^-24 and D = 3, the plain
// version's error is at most about 4u (|a|^2 + |b|^2) + 6u |a| |b| (two
// squared norms, a dot product, a sum and a difference), the kernel's
// about 3u (|a|^2 + |b|^2) + 3u (|b|^2 + 2 |a| |b|) (two squared norms and
// three rounded partial sums t_k, each at most |b|^2 + 2 |a| |b|).  The
// worst case is a = b_j, where the true value is 0 and every term cancels:
// at |a| = |b| = 5 m the two differ by at most 350u + 375u = 4.3e-5,
// inside ND_TOL = 1e-4 absolute + relative (chip_smoke.py).  The bound
// grows with |a|^2; tests/test_torch_kernels.py emulates the kernel's
// order in f32 at a = b_j and 5 m from the origin, where the two differ
// by at most 1.2e-5.
//
// Design.  The TPU tiles (M, N) into MXU matmuls and carries each row's
// running min in its output block across the sequential N axis.  Here:
//   rows    each of a block's 256 threads owns R rows of a in registers,
//           pre-scaled by -2, and their |a|^2: R = 4, or R = 1 where M is
//           too small to fill the card with 4 (kernels/pairwise.py::
//           nd_split);
//   split   the N rows of b are cut into `split` contiguous shares, one
//           per block of a thread-block cluster (1 to 8 blocks, about one
//           block an SM in all: 63 row blocks x 2 at M = 64,000, 8 x 8 at
//           the chamfer shape M = 2000);
//   staging each block stages its share in tiles, compacted to the valid
//           rows: every load of a tile is started before the warp ballots
//           and the one shared atomic per warp that place the rows; a row
//           is one float4 (x, y, z, |b|^2) for D <= 3, three for D <= 8;
//   pairs   every thread reads each staged row once (a broadcast LDS.128)
//           and feeds it to its R rows: D FFMA and one FMNMX per pair;
//   combine every block leaves its minima in shared memory; after a
//           cluster barrier rank 0 takes the min over the cluster through
//           distributed shared memory, adds |a|^2 and writes the row.
// Min is exact and order-free, so the atomic order of the compaction
// changes nothing: the output is the same bits on every run.
//
// What bounds it on this card: operations.  At M = 64,000 and N = 4096
// (D = 3, 3309 valid b rows) the least work is D FMAs and one min per
// valid pair, M * n_valid * (2D + 1) = 1.48 GFLOP: 22 us at the 67 TFLOP/s
// fp32 rate, against 1.1 MB of input.  The kernel executes 4 instructions
// per pair plus one shared load per 4 pairs and its staging; that mix of
// dependent FFMA chains, FMNMX and shared loads runs at well under one
// instruction a cycle on each SM sub-partition.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;                     // kernels/pairwise.py
constexpr int kMaxSplit = 8;                      // portable cluster size
constexpr float kNone = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

// K coordinate lanes (3 or 8), then |b|^2, in W float4s per staged row;
// R rows of a per thread.
template <int K, int R>
__global__ void __launch_bounds__(kThreads)
    nearest_dist_kernel(const float* __restrict__ a,
                        const float* __restrict__ b,
                        const uint8_t* __restrict__ valid, int M, int N, int D,
                        int share, float* __restrict__ out) {
  constexpr int W = (K + 4) / 4;
  constexpr int kTile = (2048 / W) / kThreads * kThreads;   // rows staged
  constexpr int kIter = kTile / kThreads;
  __shared__ float4 s_b[kTile * W];
  __shared__ float s_best[kThreads * R];
  __shared__ int s_n[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nsplit = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x, lane = tid & 31;
  const int row0 = blockIdx.x * kThreads * R;
  const int n_begin = static_cast<int>(
      min(static_cast<long long>(rank) * share, static_cast<long long>(N)));
  const int n_end = static_cast<int>(
      min(static_cast<long long>(n_begin) + share, static_cast<long long>(N)));

  float am[R][K];                               // -2 a
  float a2[R], best[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r * kThreads + tid;
    a2[r] = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float x =
          (i < M && k < D) ? __ldg(a + static_cast<size_t>(i) * D + k) : 0.f;
      a2[r] = __fadd_rn(a2[r], __fmul_rn(x, x));
      am[r][k] = -2.f * x;
    }
    best[r] = INFINITY;
  }

  if (tid < 2) s_n[tid] = 0;
  __syncthreads();
  int t = 0;
  for (int n0 = n_begin; n0 < n_end; n0 += kTile, t ^= 1) {
    // stage the valid rows of this tile, compacted: every load of the
    // tile first (one round trip), then the ballots
    bool v[kIter];
    float x[kIter][K];
#pragma unroll
    for (int it = 0; it < kIter; ++it) {
      const int n = n0 + it * kThreads + tid;
      v[it] = n < n_end && valid[n] != 0;
#pragma unroll
      for (int k = 0; k < K; ++k)
        x[it][k] = (n < n_end && k < D)
                       ? __ldg(b + static_cast<size_t>(n) * D + k) : 0.f;
    }
#pragma unroll
    for (int it = 0; it < kIter; ++it) {
      const unsigned m = __ballot_sync(kFull, v[it]);
      int at = 0;
      if (lane == 0 && m != 0) at = atomicAdd(&s_n[t], __popc(m));
      at = __shfl_sync(kFull, at, 0) + __popc(m & ((1u << lane) - 1u));
      if (v[it]) {
        float row[4 * W] = {};
        float b2 = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          row[k] = x[it][k];
          b2 = __fadd_rn(b2, __fmul_rn(row[k], row[k]));
        }
        row[K] = b2;
#pragma unroll
        for (int q = 0; q < W; ++q)
          s_b[at * W + q] = make_float4(row[4 * q], row[4 * q + 1],
                                        row[4 * q + 2], row[4 * q + 3]);
      }
    }
    __syncthreads();
    const int nv = s_n[t];
    if (tid == 0) s_n[t ^ 1] = 0;           // the next tile's counter
#pragma unroll 8
    for (int j = 0; j < nv; ++j) {
      float row[4 * W];
#pragma unroll
      for (int q = 0; q < W; ++q) {
        const float4 f = s_b[j * W + q];
        row[4 * q] = f.x;
        row[4 * q + 1] = f.y;
        row[4 * q + 2] = f.z;
        row[4 * q + 3] = f.w;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float d2 = row[K];
#pragma unroll
        for (int k = 0; k < K; ++k) d2 = fmaf(am[r][k], row[k], d2);
        best[r] = fminf(best[r], d2);
      }
    }
    __syncthreads();                        // the tile has been read
  }

  // min over the cluster's shares of b, taken by rank 0
#pragma unroll
  for (int r = 0; r < R; ++r) s_best[r * kThreads + tid] = best[r];
  cluster.sync();
  if (rank == 0) {
    for (int q = 1; q < nsplit; ++q) {
      const float* other = cluster.map_shared_rank(s_best, q);
#pragma unroll
      for (int r = 0; r < R; ++r)
        best[r] = fminf(best[r], other[r * kThreads + tid]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = row0 + r * kThreads + tid;
      if (i < M) out[i] = best[r] == INFINITY ? kNone : a2[r] + best[r];
    }
  }
  cluster.sync();                           // rank 0 has read every block
}

}  // namespace

// a [M, D], b [N, D] f32 row-major, valid [N] bool (one byte each),
// out [M] f32; 1 <= D <= 8, M, N >= 1.  The split (kernels/pairwise.py::
// nd_split): `rows` (1 or 4) rows of a a thread, so 256 * rows a block, and
// `split` blocks per row block, each taking `share` rows of b.  One
// launch.  Returns -1 for a shape or split the kernel does not take, else
// the launch's error (0 = launched).
extern "C" int nearest_dist_launch(const float* a, const float* b,
                                   const uint8_t* valid, int M, int N, int D,
                                   int rows, int split, int share, float* out,
                                   void* stream) {
  if (M < 1 || N < 1 || D < 1 || D > 8 || (rows != 1 && rows != 4) ||
      split < 1 || split > kMaxSplit || share < 1 ||
      static_cast<long long>(split) * share < N)
    return -1;
  const int block_rows = kThreads * rows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + block_rows - 1) / block_rows, split, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = split;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void (*kernel)(const float*, const float*, const uint8_t*, int, int, int,
                 int, float*) =
      D <= 3 ? (rows == 4 ? nearest_dist_kernel<3, 4> : nearest_dist_kernel<3, 1>)
             : (rows == 4 ? nearest_dist_kernel<8, 4> : nearest_dist_kernel<8, 1>);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, a, b, valid, M, N, D, share, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
