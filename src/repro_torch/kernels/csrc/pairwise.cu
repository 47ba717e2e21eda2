// Nearest valid neighbour distance, for Hopper.
//
// Replaces: src/repro/kernels/pairwise.py :: nearest_dist_pallas (kernel
// body _kernel), behind repro.kernels.ops.nearest_dist.
//
// What it computes: out[i] = min over valid j of
//   |a_i|^2 + |b_j|^2 - 2 a_i . b_j
// in f32 for a [M, D], b [N, D] (D <= 8) and b_valid [N]; 1e30 where no
// b_j is valid.  This is the TPU kernel's expansion, not (a - b)^2: the two
// round differently.  The sum and the difference are rounded separately
// (no fused multiply-add across them), as the reference's array ops are.
//
// Design.  The TPU tiles (M, N) into MXU matmuls and carries each row's
// running min in its output block across the sequential N axis.  Here each
// thread owns one row of a in registers, zero-padded to DP = 4 or 8 lanes
// (a zero adds nothing to a sum), and the block walks b in tiles staged in
// shared memory with their |b|^2 and validity; every thread reads the same
// b row at once (a broadcast).  The running min stays in a register and no
// atomics are used, so the result is the same on every run.
//
// What bounds it on this card: operations.  At M = 64,000 and N = 4096
// (D = 3) it does M * N * (2D + 3) = 2.4 GFLOP, 35 us at the 67 TFLOP/s
// fp32 rate, against 1.1 MB of input.  The loop body is a DP-wide dot
// product, two adds and a min per pair, all in fp32 FMA units.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTileN = 512;
constexpr float kInf = 1e30f;

template <int DP>
__global__ void __launch_bounds__(kThreads)
    nearest_dist_kernel(const float* __restrict__ a,
                        const float* __restrict__ b,
                        const uint8_t* __restrict__ valid, int M, int N, int D,
                        float* __restrict__ out) {
  __shared__ float4 sb[kTileN * DP / 4];
  __shared__ float sb2[kTileN];
  __shared__ int sv[kTileN];

  const int i = blockIdx.x * kThreads + threadIdx.x;
  float ai[DP];
  float a2 = 0.f;
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    ai[d] = (i < M && d < D) ? a[static_cast<size_t>(i) * D + d] : 0.f;
    a2 = __fadd_rn(a2, __fmul_rn(ai[d], ai[d]));
  }

  float best = kInf;
  for (int n0 = 0; n0 < N; n0 += kTileN) {
    __syncthreads();                   // the last tile has been read
    for (int j = threadIdx.x; j < kTileN; j += kThreads) {
      const int n = n0 + j;
      float bj[DP];
      float b2 = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        bj[d] = (n < N && d < D) ? b[static_cast<size_t>(n) * D + d] : 0.f;
        b2 = __fadd_rn(b2, __fmul_rn(bj[d], bj[d]));
      }
#pragma unroll
      for (int q = 0; q < DP / 4; ++q)
        sb[j * (DP / 4) + q] =
            make_float4(bj[4 * q], bj[4 * q + 1], bj[4 * q + 2], bj[4 * q + 3]);
      sb2[j] = b2;
      sv[j] = n < N && valid[n] != 0;
    }
    __syncthreads();
    const int cnt = min(kTileN, N - n0);
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      if (!sv[j]) continue;            // the same j for every thread
      float ab = 0.f;
#pragma unroll
      for (int q = 0; q < DP / 4; ++q) {
        const float4 x = sb[j * (DP / 4) + q];
        ab = fmaf(ai[4 * q], x.x, ab);
        ab = fmaf(ai[4 * q + 1], x.y, ab);
        ab = fmaf(ai[4 * q + 2], x.z, ab);
        ab = fmaf(ai[4 * q + 3], x.w, ab);
      }
      const float d2 = __fsub_rn(__fadd_rn(a2, sb2[j]), __fmul_rn(2.f, ab));
      best = fminf(best, d2);
    }
  }
  if (i < M) out[i] = best;
}

}  // namespace

// a [M, D], b [N, D] f32 row-major, valid [N] bool (one byte each),
// out [M] f32; 1 <= D <= 8, M, N >= 1.  Returns -1 for a shape the kernel
// does not take, else cudaGetLastError() after the launch (0 = launched).
extern "C" int nearest_dist_launch(const float* a, const float* b,
                                   const uint8_t* valid, int M, int N, int D,
                                   float* out, void* stream) {
  if (M < 1 || N < 1 || D < 1 || D > 8) return -1;
  const int grid = (M + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 4)
    nearest_dist_kernel<4><<<grid, kThreads, 0, s>>>(a, b, valid, M, N, D, out);
  else
    nearest_dist_kernel<8><<<grid, kThreads, 0, s>>>(a, b, valid, M, N, D, out);
  return static_cast<int>(cudaGetLastError());
}
