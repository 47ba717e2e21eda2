// Fused query score + predicate bias + top-k for Hopper.
//
// Replaces: src/repro/kernels/query_topk.py :: query_topk_bias_pallas
// (kernel body _bias_kernel, block fold _merge_topk).
//
// What it computes: score[q, n] = qs[q] . embeds[n] + bias[q, n] for Q
// queries against an [N, E] embedding table; a slot whose bias is <= NEG/2
// (NEG = -1e30) is excluded.  Per query it returns the top k (score desc,
// ties to the lower slot) as [Q, k] f32 scores and i32 slots; positions
// past the included count are NEG / -1, and an excluded slot never
// outranks that padding.
//
// Design.  The TPU kernel streams the table through VMEM in sequential
// grid steps and keeps the running top-k in its output refs.  Hopper
// blocks run in parallel, so the work splits in two launches:
//   score_kernel: each block takes kRows table rows and a tile of up to
//     kMaxQ queries held in shared memory.  Each warp computes its rows'
//     dot products with plain fp32 FMA (no TF32, no library matmul),
//     reading the row as float4 where E allows, kUnroll loads in flight
//     per lane; it applies the bias rule, and the block sorts each
//     query's kRows candidates by (score desc, slot asc) with a bitonic
//     network in shared memory; the best min(k, kRows) go out as that
//     block's list.
//   merge_kernel: one block per query k-way merges the per-block sorted
//     lists under the same order (k rounds of a block-wide arg-best over
//     the list heads), padding with NEG / -1 once no candidate is left.
//
// What bounds it on this card: the table read.  At N = 10,000 and E = 512
// it is 20.5 MB, about 6 us at 3.35 TB/s, against 2*Q*N*E flops (0.16
// GFLOP at Q = 16, about 2.4 us at 67 TFLOP/s fp32).  The design reads the
// table once per query tile (once for Q <= 16) with coalesced warp loads.
// Latency, not bandwidth, is what this design has to fight at these
// sizes: with one 4-byte load outstanding per lane, and one dependent
// bias load per (query, row), the sweep took the same 0.11 ms on an H100
// at N = 512 and at N = 4096 (both one wave of blocks).  Hence float4
// row loads, kUnroll of them issued before their FMAs, and the bias tile
// staged in shared memory by one coalesced pass.  Tensor cores, TMA and a
// fused merge are later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;          // table rows per block (power of two)
constexpr int kUnroll = 4;         // row loads in flight per lane
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ = 16;          // queries per block (register accumulators)
constexpr int kMergeThreads = 256;
constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

// a ranks before b: included first, then score desc, then slot asc
__device__ __forceinline__ bool better(float sa, int ia, float sb, int ib) {
  if (ia < 0) return false;
  if (ib < 0) return true;
  return sa > sb || (sa == sb && ia < ib);
}

__device__ __forceinline__ float fma_dot(float a, float b, float acc) {
  return fmaf(a, b, acc);
}

__device__ __forceinline__ float fma_dot(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// T = float4 when E % 4 == 0 and the table is 16-byte aligned, else float
template <typename T>
__global__ void score_kernel(const float* __restrict__ qs,
                             const float* __restrict__ emb,
                             const float* __restrict__ bias, int Q, int N,
                             int E, int qtile, int L, int nchunks,
                             float* __restrict__ cand_s,
                             int* __restrict__ cand_i) {
  extern __shared__ float4 smem4[];                    // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  float* sq = smem;                                    // [qtile, E]
  float* ss = sq + qtile * E;                          // [qtile, kRows]
  int* si = reinterpret_cast<int*>(ss + qtile * kRows);  // [qtile, kRows]

  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * qtile;
  const int nq = min(qtile, Q - q0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int j = threadIdx.x; j < nq * E; j += kThreads)
    sq[j] = qs[static_cast<size_t>(q0) * E + j];
  // the block's bias tile in one coalesced pass, staged where the scores
  // will go: ss[q, r] = bias[q0 + q, chunk * kRows + r]
  for (int j = threadIdx.x; j < nq * kRows; j += kThreads) {
    const int n = chunk * kRows + j % kRows;
    ss[j] = n < N ? bias[static_cast<size_t>(q0 + j / kRows) * N + n] : kNeg;
  }
  __syncthreads();

  constexpr int V = sizeof(T) / sizeof(float);
  const int ev = E / V;                                // T elements per row
  const T* sqv = reinterpret_cast<const T*>(sq);
  for (int r = warp; r < kRows; r += kWarps) {
    const int n = chunk * kRows + r;
    float acc[kMaxQ];
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) acc[q] = 0.f;
    if (n < N) {
      const T* row =
          reinterpret_cast<const T*>(emb + static_cast<size_t>(n) * E);
      for (int e0 = lane; e0 < ev; e0 += 32 * kUnroll) {
        T x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)    // issue every load first
          if (e0 + 32 * u < ev) x[u] = row[e0 + 32 * u];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int e = e0 + 32 * u;
          if (e < ev) {
#pragma unroll
            for (int q = 0; q < kMaxQ; ++q)
              if (q < nq) acc[q] = fma_dot(x[u], sqv[q * ev + e], acc[q]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kMaxQ; ++q) {
      if (q >= nq) break;                              // warp-uniform
      float x = acc[q];
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
      if (lane == 0) {             // only this warp touches row r
        const float b = ss[q * kRows + r];
        const bool inc = n < N && b > kNeg * 0.5f;
        ss[q * kRows + r] = inc ? x + b : -CUDART_INF_F;
        si[q * kRows + r] = inc ? n : -1;
      }
    }
  }
  __syncthreads();

  // bitonic sort of each query's kRows candidates, best first
  for (int size = 2; size <= kRows; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < nq * (kRows / 2); t += kThreads) {
        const int q = t / (kRows / 2), p = t % (kRows / 2);
        const int i = 2 * stride * (p / stride) + (p % stride);
        const int j = i + stride;
        float* s = ss + q * kRows;
        int* id = si + q * kRows;
        const bool up = (i & size) == 0;
        const bool swap = up ? better(s[j], id[j], s[i], id[i])
                             : better(s[i], id[i], s[j], id[j]);
        if (swap) {
          const float ts = s[i];
          s[i] = s[j];
          s[j] = ts;
          const int ti = id[i];
          id[i] = id[j];
          id[j] = ti;
        }
      }
      __syncthreads();
    }
  }

  for (int t = threadIdx.x; t < nq * L; t += kThreads) {
    const int q = t / L, j = t % L;
    const int id = si[q * kRows + j];
    const size_t o = (static_cast<size_t>(q0 + q) * nchunks + chunk) * L + j;
    cand_s[o] = id >= 0 ? ss[q * kRows + j] : kNeg;
    cand_i[o] = id;
  }
}

__global__ void merge_kernel(const float* __restrict__ cand_s,
                             const int* __restrict__ cand_i, int nchunks,
                             int L, int k, int* __restrict__ heads,
                             float* __restrict__ out_s,
                             int* __restrict__ out_i) {
  const int q = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* cs = cand_s + static_cast<size_t>(q) * nchunks * L;
  const int* ci = cand_i + static_cast<size_t>(q) * nchunks * L;
  int* hd = heads + static_cast<size_t>(q) * nchunks;  // owner-thread only

  __shared__ float ws[kMergeThreads / 32];
  __shared__ int wi[kMergeThreads / 32], wl[kMergeThreads / 32];
  __shared__ int s_list;

  // each thread owns lists c = tid (mod threads) and tracks its best head
  float bs = 0.f;
  int bi = -1, bl = -1;
  for (int c = threadIdx.x; c < nchunks; c += kMergeThreads) {
    hd[c] = 0;
    const float s = cs[c * L];
    const int i = ci[c * L];
    if (better(s, i, bs, bi)) { bs = s; bi = i; bl = c; }
  }

  for (int r = 0; r < k; ++r) {
    float s = bs;
    int i = bi, l = bl;
    for (int o = 16; o > 0; o >>= 1) {
      const float s2 = __shfl_xor_sync(kFull, s, o);
      const int i2 = __shfl_xor_sync(kFull, i, o);
      const int l2 = __shfl_xor_sync(kFull, l, o);
      if (better(s2, i2, s, i)) { s = s2; i = i2; l = l2; }
    }
    if (lane == 0) { ws[warp] = s; wi[warp] = i; wl[warp] = l; }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kMergeThreads / 32; ++w)
        if (better(ws[w], wi[w], s, i)) { s = ws[w]; i = wi[w]; l = wl[w]; }
      out_s[static_cast<size_t>(q) * k + r] = i >= 0 ? s : kNeg;
      out_i[static_cast<size_t>(q) * k + r] = i;
      s_list = i >= 0 ? l : -1;
    }
    __syncthreads();
    const int won = s_list;
    if (won >= 0 && won % kMergeThreads == static_cast<int>(threadIdx.x)) {
      // the owner pops the winning head and rescans its lists
      hd[won] += 1;
      bs = 0.f; bi = -1; bl = -1;
      for (int c = threadIdx.x; c < nchunks; c += kMergeThreads) {
        const int h = hd[c];
        if (h >= L) continue;
        const float s2 = cs[c * L + h];
        const int i2 = ci[c * L + h];
        if (better(s2, i2, bs, bi)) { bs = s2; bi = i2; bl = c; }
      }
    }
    __syncthreads();
  }
}

// The score kernel's launch plan: the one place that knows its shared-memory
// layout (qtile queries of E floats, then a [qtile, kRows] score tile and a
// [qtile, kRows] slot tile) and the merge's scratch shape.
struct Plan {
  int nchunks;     // table-row blocks: ceil(N / kRows)
  int L;           // candidates each block keeps per query: min(k, kRows)
  int qtile;       // queries that share one table read (<= kMaxQ)
  int smem_bytes;  // the score kernel's dynamic shared memory
};

// 0, or -1 when one query's row does not fit in the current device's
// opt-in shared memory per block, or a CUDA error code.
int make_plan(int Q, int N, int E, int k, Plan* p) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long row_bytes =
      (static_cast<long long>(E) + 2 * kRows) * sizeof(float);
  const long long fit = optin / row_bytes;
  const int qmax = Q < kMaxQ ? Q : kMaxQ;
  p->qtile = fit < qmax ? static_cast<int>(fit) : qmax;
  if (p->qtile < 1) return -1;
  p->smem_bytes = static_cast<int>(p->qtile * row_bytes);
  p->nchunks = (N + kRows - 1) / kRows;
  p->L = k < kRows ? k : kRows;
  return 0;
}

}  // namespace

// Scratch the caller allocates for query_topk_bias_launch: cand_s / cand_i
// [Q, nchunks, L] and heads [Q, nchunks].  Returns make_plan's code.
extern "C" int query_topk_bias_scratch(int Q, int N, int E, int k,
                                       int* nchunks, int* L) {
  Plan p;
  const int err = make_plan(Q, N, E, k, &p);
  if (err == 0) {
    *nchunks = p.nchunks;
    *L = p.L;
  }
  return err;
}

// qs [Q, E], emb [N, E], bias [Q, N] f32; scratch as
// query_topk_bias_scratch reports it.  Outputs: out_s [Q, k] f32, out_i
// [Q, k] i32.  Returns make_plan's code, else cudaGetLastError() after the
// launches (0 = launched).
extern "C" int query_topk_bias_launch(const float* qs, const float* emb,
                                      const float* bias, int Q, int N, int E,
                                      int k, float* cand_s, int* cand_i,
                                      int* heads, float* out_s, int* out_i,
                                      void* stream) {
  Plan p;
  const int plan_err = make_plan(Q, N, E, k, &p);
  if (plan_err != 0) return plan_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(p.nchunks, (Q + p.qtile - 1) / p.qtile);
  const bool vec4 = E % 4 == 0 && reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  void (*kernel)(const float*, const float*, const float*, int, int, int,
                 int, int, int, float*, int*) =
      vec4 ? &score_kernel<float4> : &score_kernel<float>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, p.smem_bytes, s>>>(qs, emb, bias, Q, N, E,
                                              p.qtile, p.L, p.nchunks,
                                              cand_s, cand_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_kernel<<<Q, kMergeThreads, 0, s>>>(cand_s, cand_i, p.nchunks, p.L,
                                           k, heads, out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}
