// RWKV-6 wkv recurrence for Hopper: each head's f32 state kept on chip.
//
// Replaces no Pallas kernel.  The JAX package's wkv is plain jnp: a
// lax.scan over _wkv_chunk (src/repro/models/rwkv.py:103, the scan at
// :159 in rwkv_time_mix), which the port ran as an eager loop over chunks
// (kernels/wkv6.py::wkv6_plain).  That loop formed a [B, C, C, h, dk] f32
// array of decay differences in every chunk (671 MB at 16 x 64 x 64 x 40 x
// 64) and masked, exponentiated, multiplied and summed it: rwkv6-3b's
// prefill of 16 x 4096 tokens spent 8.3 of its 9.5 s there.  This kernel is
// the serving path's wkv (kernels/ops.py::wkv6); training keeps the chunk
// loop, which autograd differentiates.
//
// What it computes, per row b and head h, for t = 0 .. S-1 (dh = 64):
//   y_t[j]    = sum_i r_t[i] S[i][j] + (sum_i r_t[i] u[i] k_t[i]) v_t[j]
//   S[i][j]  <- w_t[i] S[i][j] + k_t[i] v_t[j],   w_t = exp(lw_t) <= 1
// from S = state0[b, h] and into end_state[b, h].  r, k, v, lw and y are
// [B, S, h, dh] f32, u [h, dh], the states [B, h, dh, dh] ([i][j] = key i,
// value j).  All arithmetic is f32 FMA: no tensor-core product, no TF32.
// The recurrent form multiplies only by w <= 1, so no exponent of a
// positive number arises, and it needs no -inf mask and no padding: any
// S >= 1 runs, and a prefill from a cache starts from its state.
//
// What bounds it on this card.  Each input is read once and y written
// once: at 16 x 4096 x 40 x 64, four f32 inputs and y of 671 MB each and
// the state read and written (21 MB), 3.38 GB, 1.01 ms at 3.35 TB/s.  Its
// arithmetic is an FMA for y and a multiply and an FMA for the update of
// each of a head's 64 x 64 state entries a token, 53.7 GFLOP: 0.80 ms at
// 67 TFLOP/s.  So the bytes bound it, with the FP32 pipes close behind;
// a step's work is serial within a head, so the kernel also needs every
// head resident at once to keep the pipes fed.
//
// Design.  One block of 64 threads per (row, head), each thread a tile of
// the state, the whole sequence in one launch:
//   state   thread (g, c) = (tid / 8, tid % 8) holds S[i][j] for the 8
//           keys i in {4c .. 4c+3} and {32+4c .. 32+4c+3} and the 8 values
//           j in {8g .. 8g+7}, 64 f32 in registers for the whole sequence,
//           and u for its 8 keys; it reads state0's tile once and writes
//           the end state's once;
//   staging the head's r, k, lw and v come through shared memory kT steps
//           at a time, with cp.async into two buffers: the next tile's
//           loads are in flight while the serial loop runs over this one.
//           Each step's 64 values are one 256-byte run of the input; when
//           a tile has landed, thread i turns key i's lw into w = exp(lw)
//           in place;
//   steps   for each step a thread reads its 8 keys' r, k and w and its 8
//           values' v as eight 16-byte shared loads (the 8 threads of a
//           group read 128 contiguous bytes: no bank conflict), sums
//           r_i S_ij over its keys for each of its values (8 chains of 8
//           FMAs), updates its 64 S_ij with one FMA each on k_i v_j, adds
//           v_j times its keys' share of the current token's sum r u k,
//           and the group of 8 threads that share the values adds its 8
//           partial sums by halves over three shuffle rounds (7 shuffles),
//           which leaves thread tid with y_t[tid]: one 256-byte coalesced
//           store a step a block.
// A thread holding a whole column S[:, j] instead reads all 64 keys' r, k
// and w every step, 48 16-byte shared loads against 8 here, and shared
// memory's 128 bytes a clock set the pace: 4.29 ms against 3.14 at
// rwkv6-3b's prefill on an H100.  Staging 8 steps a tile (16 KB of shared
// memory a block) rather than 16 took 2.74 ms against 3.14.  640 blocks
// there; the launch bounds hold a thread to 204 registers so that five
// blocks fit an SM and every block is resident in one wave (at 250
// registers four fit, and a second wave of 112 blocks ran the whole
// sequence again: 4.70 ms against 4.29).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;       // head size
constexpr int kT = 8;        // steps staged a tile
constexpr int kMinBlocks = 5;  // blocks an SM: 640 in one wave on 132 SMs
constexpr int kArrays = 4;   // r, k, lw (then w), v
constexpr int kR = 0, kK = 1, kW = 2, kV = 3;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the 8 keys of thread column c: 4c .. 4c+3, then 32+4c .. 32+4c+3
__device__ __forceinline__ int key_of(int c, int ii) {
  return (ii < 4 ? 4 * c : 32 + 4 * c - 4) + ii;
}

// row[a0 .. a0+3] then row[a1 .. a1+3], from two 16-byte shared loads
__device__ __forceinline__ void unpack(const float* row, int a0, int a1,
                                       float* out) {
  const float4 a = *reinterpret_cast<const float4*>(row + a0);
  const float4 b = *reinterpret_cast<const float4*>(row + a1);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

// y_j over the group of 8 lanes sharing values 8g .. 8g+7: each lane holds
// 8 partial sums p[jj]; by halves (lane bit 4, 2, 1) a lane keeps the half
// its bit picks and adds its partner's copy of it.  Lane c ends with the
// sum for jj = c.
__device__ __forceinline__ float group_sum(float* p, int c) {
  const bool b4 = c & 4, b2 = c & 2, b1 = c & 1;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float send = b4 ? p[q] : p[q + 4], keep = b4 ? p[q + 4] : p[q];
    p[q] = keep + __shfl_xor_sync(kFull, send, 4);
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float send = b2 ? p[q] : p[q + 2], keep = b2 ? p[q + 2] : p[q];
    p[q] = keep + __shfl_xor_sync(kFull, send, 2);
  }
  const float send = b1 ? p[0] : p[1], keep = b1 ? p[1] : p[0];
  return keep + __shfl_xor_sync(kFull, send, 1);
}

__global__ void __launch_bounds__(kD, kMinBlocks)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ lw,
                const float* __restrict__ u,
                const float* __restrict__ state0, int S, int H,
                float* __restrict__ y, float* __restrict__ end_state) {
  __shared__ __align__(16) float s_in[2][kArrays][kT][kD];

  const int tid = threadIdx.x;
  const int g = tid >> 3, c = tid & 7;       // value group, key column
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  // element (b, t, h, 0) of a [B, S, H, 64] array; rows of a step H * 64
  const size_t head0 = (static_cast<size_t>(b) * S * H + h) * kD;
  const size_t step = static_cast<size_t>(H) * kD;
  const size_t st0 = (static_cast<size_t>(b) * H + h) * kD * kD;
  const int n_tiles = (S + kT - 1) / kT;

  // the tile's kArrays x kT x 16 16-byte chunks, kT a thread
  auto load = [&](int n, int buf) {
#pragma unroll
    for (int m = 0; m < kT; ++m) {
      const int q = m * kD + tid;
      const int a = q / (kT * 16), t = (q / 16) % kT, ch = q % 16;
      const int ts = n * kT + t;
      const float* src = a == kR ? r : a == kK ? k : a == kW ? lw : v;
      if (ts < S)
        cp_async16(&s_in[buf][a][t][ch * 4], src + head0 + ts * step + ch * 4);
    }
  };

  load(0, 0);
  cp_async_commit();

  float s[8][8];                             // S[key_of(c, ii)][8g + jj]
#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    const float* row = state0 + st0 + key_of(c, ii) * kD + 8 * g;
    const float4 a = *reinterpret_cast<const float4*>(row);
    const float4 bq = *reinterpret_cast<const float4*>(row + 4);
    s[ii][0] = a.x; s[ii][1] = a.y; s[ii][2] = a.z; s[ii][3] = a.w;
    s[ii][4] = bq.x; s[ii][5] = bq.y; s[ii][6] = bq.z; s[ii][7] = bq.w;
  }
  float ui[8];
#pragma unroll
  for (int ii = 0; ii < 8; ++ii) ui[ii] = u[h * kD + key_of(c, ii)];

  for (int n = 0; n < n_tiles; ++n) {
    const int buf = n & 1;
    const int t0 = n * kT;
    const int steps = min(kT, S - t0);
    if (n + 1 < n_tiles) load(n + 1, buf ^ 1);
    cp_async_commit();                  // an empty group past the last tile
    cp_async_wait_one();                // this thread's chunks of tile n
    __syncthreads();                    // everyone's chunks of tile n

    // prepare: thread tid turns key tid's log-decays into decays
#pragma unroll
    for (int t = 0; t < kT; ++t)
      if (t < steps) s_in[buf][kW][t][tid] = expf(s_in[buf][kW][t][tid]);
    __syncthreads();

    for (int t = 0; t < steps; ++t) {
      float ri[8], ki[8], wi[8], vj[8], p[8];
      unpack(s_in[buf][kR][t], 4 * c, 32 + 4 * c, ri);
      unpack(s_in[buf][kK][t], 4 * c, 32 + 4 * c, ki);
      unpack(s_in[buf][kW][t], 4 * c, 32 + 4 * c, wi);
      unpack(s_in[buf][kV][t], 8 * g, 8 * g + 4, vj);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) p[jj] = 0.f;
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          p[jj] = fmaf(ri[ii], s[ii][jj], p[jj]);
          s[ii][jj] = fmaf(wi[ii], s[ii][jj], ki[ii] * vj[jj]);
        }
      }
      // the current token's term, v_j sum_i r_i u_i k_i, over this
      // thread's keys, joins its partial sums before the group adds them
      float bonus = 0.f;
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) bonus = fmaf(ri[ii] * ui[ii], ki[ii], bonus);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) p[jj] = fmaf(bonus, vj[jj], p[jj]);
      y[head0 + (t0 + t) * step + tid] = group_sum(p, c);
    }
    __syncthreads();                    // tile n read: its buffer is free
  }

#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    float* row = end_state + st0 + key_of(c, ii) * kD + 8 * g;
    *reinterpret_cast<float4*>(row) =
        make_float4(s[ii][0], s[ii][1], s[ii][2], s[ii][3]);
    *reinterpret_cast<float4*>(row + 4) =
        make_float4(s[ii][4], s[ii][5], s[ii][6], s[ii][7]);
  }
}

}  // namespace

// r, k, v, lw, y [B, S, H, 64] f32 contiguous; u [H, 64]; state0,
// end_state [B, H, 64, 64].  One launch of B * H blocks on `stream`.
// Returns -1 for a shape the kernel does not take, else the launch's error
// (0 = launched).
extern "C" int wkv6_launch(const float* r, const float* k, const float* v,
                           const float* lw, const float* u,
                           const float* state0, int B, int S, int H, int dh,
                           float* y, float* end_state, void* stream) {
  if (B < 1 || S < 1 || H < 1 || dh != kD ||
      static_cast<long long>(B) * H >= (1LL << 31))
    return -1;
  wkv6_kernel<<<B * H, kD, 0, static_cast<cudaStream_t>(stream)>>>(
      r, k, v, lw, u, state0, S, H, y, end_state);
  return static_cast<int>(cudaGetLastError());
}
