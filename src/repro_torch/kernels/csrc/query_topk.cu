// Fused query score + predicate bias + top-k for Hopper, in one launch.
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
// blocks run in parallel, so each block takes kRows = 32 table rows (so
// that N = 4096 gives 128 blocks and N = 10,240 gives 320: the card is
// filled even by one query) and a tile of up to kMaxQ queries held in
// shared memory:
//   scores: each warp owns kRows / 8 = 4 rows and issues the float4
//     loads of all four (4 per row and lane for one query, 2 for a query
//     tile, whose 64 accumulators a lane must also hold: at about 128
//     registers two blocks fit on an SM) before its FMAs; plain fp32 FMA
//     (no TF32, no library matmul), the query tile read from shared memory
//     once per load; the bias tile is staged by one coalesced pass and the
//     bias rule applied per score;
//   block top-L: a block holds 32 candidates per query, one per lane of a
//     warp, so a warp-level bitonic sort by shuffles orders them by
//     (score desc, slot asc) and the best L = min(k, 32) go to scratch;
//   merge: every block then takes a ticket (atomicAdd on a counter, after
//     a __threadfence()); the last min(Q, 32) blocks to do so wait until
//     every block has (they are resident, so the rest can still be
//     scheduled beside them) and merge the per-block sorted lists, one
//     warp per query, the queries dealt over those blocks: a tournament
//     over the list heads (warp arg-best by shuffles), the owner of the
//     winning list advancing it, padding with NEG / -1 once the best head
//     is excluded.  Where they fit, a query's lists are first copied into
//     shared memory, so a round of the tournament waits on no global load.
//     The last merger resets the counters for the next launch.
//
// Any k >= 1: a block keeps L = min(k, kRows) candidates, which is every
// row it scores once k >= kRows, and the merge pads with NEG / -1 once the
// best head is excluded, so k past the included count (k > N too) costs
// no more rounds than there are included slots.  Every offset into qs,
// emb, bias, the scratch lists and the outputs is formed in 64 bits
// (size_t), so Q * N and N * E may pass 2^31; only Q, N, E and k
// themselves are 32-bit.
//
// What bounds it on this card: the table read.  At N = 10,240 and E = 512
// it is 21 MB, about 6.3 us at 3.35 TB/s, against 2*Q*N*E flops (0.17
// GFLOP at Q = 16, about 2.5 us at 67 TFLOP/s fp32).  At one query (SQ,
// N = 4096, 8.4 MB, 2.5 us) latency decides: one launch, loads in flight
// on every SM, and a merge of 128 short lists by one warp.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRows = 32;          // table rows per block = one warp of lanes
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kMaxQ = 16;          // queries per block (register accumulators)
constexpr int kMaxMergers = 32;    // blocks that merge (one query per warp)
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

// sort one (score, slot) per lane across the warp, best in lane 0
__device__ __forceinline__ void warp_sort(float& s, int& i, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float os = __shfl_xor_sync(kFull, s, stride);
      const int oi = __shfl_xor_sync(kFull, i, stride);
      const bool lower = (lane & stride) == 0;
      const bool best_first = (lane & size) == 0 || size == 32;
      // the pair's (lower, upper) values and whether upper ranks first
      const bool upper_wins = lower ? better(os, oi, s, i)
                                    : better(s, i, os, oi);
      // best_first: the lower lane keeps the better one
      if (upper_wins == best_first) {
        s = os;
        i = oi;
      }
    }
  }
}

// Merge one query's nchunks sorted lists of L candidates into its top k,
// one warp: a tournament over the list heads (warp arg-best by shuffles);
// lane c % 32 owns list c, keeps its best head and, when that head wins,
// advances the list and rescans its lists.  kStaged: cs / ci / hd lie in
// shared memory (copied there first), else cs / ci are the global lists
// (read past L1, they were written by other blocks) and hd is scratch.
template <bool kStaged>
__device__ void merge_query(const float* cs, const int* ci, int* hd,
                            int nchunks, int L, int k, float* out_s,
                            int* out_i, int lane) {
  auto ld_s = [](const float* p) { return kStaged ? *p : __ldcg(p); };
  auto ld_i = [](const int* p) { return kStaged ? *p : __ldcg(p); };
  float bs = 0.f;
  int bi = -1, bl = -1;
  for (int c = lane; c < nchunks; c += 32) {
    hd[c] = 0;
    const float s = ld_s(cs + c * L);
    const int i = ld_i(ci + c * L);
    if (better(s, i, bs, bi)) { bs = s; bi = i; bl = c; }
  }
  int r = 0;
  for (; r < k; ++r) {
    float s = bs;
    int i = bi, l = bl;
    for (int o = 16; o > 0; o >>= 1) {
      const float s2 = __shfl_xor_sync(kFull, s, o);
      const int i2 = __shfl_xor_sync(kFull, i, o);
      const int l2 = __shfl_xor_sync(kFull, l, o);
      if (better(s2, i2, s, i)) { s = s2; i = i2; l = l2; }
    }
    if (i < 0) break;                            // only excluded slots left
    if (lane == 0) {
      out_s[r] = s;
      out_i[r] = i;
    }
    if (l % 32 == lane) {          // the owner pops the head, rescans
      hd[l] += 1;
      bs = 0.f; bi = -1; bl = -1;
      for (int c = lane; c < nchunks; c += 32) {
        const int h = hd[c];
        if (h >= L) continue;
        const float s2 = ld_s(cs + c * L + h);
        const int i2 = ld_i(ci + c * L + h);
        if (better(s2, i2, bs, bi)) { bs = s2; bi = i2; bl = c; }
      }
    }
  }
  for (int j = r + lane; j < k; j += 32) {
    out_s[j] = kNeg;
    out_i[j] = -1;
  }
}

// T = float4 when E % 4 == 0 and the table and the queries are 16-byte
// aligned, else float.
// kQ: register accumulators per row (1 for a single query, else kMaxQ);
// kU: loads in flight per row and lane (fewer at kQ = kMaxQ, so that two
// blocks fit on an SM).  kStaged: the merge copies each query's lists into
// shared memory first (when they fit).
template <typename T, int kQ, int kU, bool kStaged>
__global__ void __launch_bounds__(kThreads, 2)
    topk_kernel(const float* __restrict__ qs, const float* __restrict__ emb,
                const float* __restrict__ bias, int Q, int N, int E, int k,
                int qtile, int L, int nchunks, int mergers,
                float* __restrict__ cand_s, int* __restrict__ cand_i,
                int* __restrict__ heads, unsigned* __restrict__ ticket,
                float* __restrict__ out_s, int* __restrict__ out_i) {
  extern __shared__ float4 smem4[];                    // 16-byte aligned
  float* smem = reinterpret_cast<float*>(smem4);
  float* sq = smem;                                    // [qtile, E]
  float* ss = sq + qtile * E;                          // [qtile, kRows]
  int* si = reinterpret_cast<int*>(ss + qtile * kRows);  // [qtile, kRows]
  __shared__ int s_rank;

  const int chunk = blockIdx.x;
  const int q0 = blockIdx.y * qtile;
  const int nq = min(qtile, Q - q0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  constexpr int V = sizeof(T) / sizeof(float);
  const int ev = E / V;                                // T elements per row
  {  // the query tile, every load of a thread issued before its stores
    const T* src = reinterpret_cast<const T*>(qs) + static_cast<size_t>(q0) *
                                                        ev;
    T* dst = reinterpret_cast<T*>(sq);
    for (int j0 = threadIdx.x; j0 < nq * ev; j0 += 8 * kThreads) {
      T x[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (j0 + u * kThreads < nq * ev) x[u] = __ldg(src + j0 + u * kThreads);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (j0 + u * kThreads < nq * ev) dst[j0 + u * kThreads] = x[u];
    }
  }
  // the block's bias tile in one coalesced pass, staged where the scores
  // will go: ss[q, r] = bias[q0 + q, chunk * kRows + r]
  for (int j = threadIdx.x; j < nq * kRows; j += kThreads) {
    const int n = chunk * kRows + j % kRows;
    ss[j] = n < N ? bias[static_cast<size_t>(q0 + j / kRows) * N + n] : kNeg;
  }
  __syncthreads();

  // ---------------------------------------------------------- scores
  const T* sqv = reinterpret_cast<const T*>(sq);
  const int r0 = warp * kRowsPerWarp;
  const T* rows[kRowsPerWarp];
  bool live[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int n = chunk * kRows + r0 + r;
    live[r] = n < N;
    rows[r] = reinterpret_cast<const T*>(emb + static_cast<size_t>(
                                                   live[r] ? n : 0) * E);
  }
  float acc[kRowsPerWarp][kQ];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[r][q] = 0.f;
  // lane l sums elements l, l + 32, l + 64, ... of each row in order
  for (int e0 = lane; e0 < ev; e0 += 32 * kU) {
    T x[kRowsPerWarp][kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)               // issue every load first
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        if (live[r] && e0 + 32 * u < ev) x[r][u] = __ldg(rows[r] + e0 + 32 * u);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + 32 * u;
      if (e < ev) {
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          if (q < nq) {
            const T qv = sqv[q * ev + e];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r)
              if (live[r]) acc[r][q] = fma_dot(x[r][u], qv, acc[r][q]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = r0 + r, n = chunk * kRows + row;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      if (q >= nq) break;                              // warp-uniform
      float x = acc[r][q];
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
      if (lane == 0) {             // only this warp touches this row
        const float b = ss[q * kRows + row];
        const bool inc = live[r] && b > kNeg * 0.5f;
        ss[q * kRows + row] = inc ? x + b : -CUDART_INF_F;
        si[q * kRows + row] = inc ? n : -1;
      }
    }
  }
  __syncthreads();

  // ------------------------------------ block top-L: one warp per query
  for (int q = warp; q < nq; q += kWarps) {
    float s = ss[q * kRows + lane];
    int i = si[q * kRows + lane];
    warp_sort(s, i, lane);
    if (lane < L) {
      const size_t o = (static_cast<size_t>(q0 + q) * nchunks + chunk) * L +
                       lane;
      cand_s[o] = i >= 0 ? s : kNeg;
      cand_i[o] = i;
    }
  }

  // ------------------------------- the last `mergers` blocks merge
  __threadfence();                 // this block's lists before its ticket
  __syncthreads();
  const unsigned total = gridDim.x * gridDim.y;
  if (threadIdx.x == 0)
    s_rank = static_cast<int>(total - 1 - atomicAdd(ticket, 1u));
  __syncthreads();
  const int rank = s_rank;         // 0 for the last block to finish
  if (rank >= mergers) return;
  if (threadIdx.x == 0)            // every other block has its lists out
    while (*reinterpret_cast<volatile unsigned*>(ticket) < total)
      __nanosleep(64);
  __syncthreads();
  __threadfence();

  const int per = nchunks * L;     // candidates of one query
  // merger `rank` takes queries rank, rank + mergers, ...: one per warp
  for (int q = rank + mergers * warp; q < Q; q += mergers * kWarps) {
    const float* gs = cand_s + static_cast<size_t>(q) * per;
    const int* gi = cand_i + static_cast<size_t>(q) * per;
    float* os = out_s + static_cast<size_t>(q) * k;
    int* oi = out_i + static_cast<size_t>(q) * k;
    if constexpr (kStaged) {
      // this warp's region after the score tiles are done with: lists, then
      // list heads
      float* ms = smem + static_cast<size_t>(warp) * (2 * per + nchunks);
      int* mi = reinterpret_cast<int*>(ms + per);
      int* mh = mi + per;
      for (int j0 = lane; j0 < per; j0 += 32 * 16) {   // 16 loads in flight
        float xs[16];
        int xi[16];
#pragma unroll
        for (int u = 0; u < 16; ++u)
          if (j0 + 32 * u < per) {
            xs[u] = __ldcg(gs + j0 + 32 * u);
            xi[u] = __ldcg(gi + j0 + 32 * u);
          }
#pragma unroll
        for (int u = 0; u < 16; ++u)
          if (j0 + 32 * u < per) {
            ms[j0 + 32 * u] = xs[u];
            mi[j0 + 32 * u] = xi[u];
          }
      }
      __syncwarp();
      merge_query<true>(ms, mi, mh, nchunks, L, k, os, oi, lane);
      __syncwarp();                // the region is reused for the next query
    } else {
      merge_query<false>(gs, gi, heads + static_cast<size_t>(q) * nchunks,
                         nchunks, L, k, os, oi, lane);
    }
  }
  // the last merger to finish zeroes both counters for the next launch
  __syncthreads();
  if (threadIdx.x == 0 && atomicAdd(ticket + 1, 1u) == mergers - 1) {
    ticket[0] = 0;
    ticket[1] = 0;
  }
}

// The kernel's launch plan: the one place that knows its shared-memory
// layout (qtile queries of E floats, then a [qtile, kRows] score tile and a
// [qtile, kRows] slot tile; in the merging block, one region of
// 2 * nchunks * L + nchunks words per warp) and the merge's scratch shape.
struct Plan {
  int nchunks;     // table-row blocks: ceil(N / kRows)
  int L;           // candidates each block keeps per query: min(k, kRows)
  int qtile;       // queries that share one table read (<= kMaxQ)
  int mergers;     // blocks that merge, each a share of the queries
  bool staged;     // the merge runs from shared memory
  int smem_bytes;  // dynamic shared memory
};

// 0, or -1 when one query's row does not fit in the current device's
// opt-in shared memory per block, -2 when the query tiles exceed the
// grid's y limit (65535), or a CUDA error code.
int make_plan(int Q, int N, int E, int k, Plan* p) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  optin -= 64;                                         // static s_last
  const long long row_bytes =
      (static_cast<long long>(E) + 2 * kRows) * sizeof(float);
  const long long fit = optin / row_bytes;
  const int qmax = Q < kMaxQ ? Q : kMaxQ;
  p->qtile = fit < qmax ? static_cast<int>(fit) : qmax;
  if (p->qtile < 1) return -1;
  const long long qtiles = (static_cast<long long>(Q) + p->qtile - 1) /
                           p->qtile;
  if (qtiles > 65535) return -2;
  p->nchunks = (N + kRows - 1) / kRows;
  p->L = k < kRows ? k : kRows;
  const long long total = static_cast<long long>(p->nchunks) * qtiles;
  p->mergers = static_cast<int>(Q < kMaxMergers ? Q : kMaxMergers);
  if (p->mergers > total) p->mergers = static_cast<int>(total);
  const int per_merger = (Q + p->mergers - 1) / p->mergers;
  const long long score = p->qtile * row_bytes;
  const long long merge =
      static_cast<long long>(per_merger < kWarps ? per_merger : kWarps) *
      (2LL * p->nchunks * p->L + p->nchunks) * sizeof(float);
  // staging keeps two blocks on an SM: at most half the opt-in memory
  p->staged = merge <= optin / 2 || merge <= score;
  p->smem_bytes = static_cast<int>(p->staged && merge > score ? merge
                                                              : score);
  return 0;
}

template <typename T, int kQ, int kU, bool kStaged>
int launch(const Plan& p, dim3 grid, cudaStream_t s, const float* qs,
           const float* emb, const float* bias, int Q, int N, int E, int k,
           float* cand_s, int* cand_i, int* heads, unsigned* ticket,
           float* out_s, int* out_i) {
  auto kernel = &topk_kernel<T, kQ, kU, kStaged>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_bytes);
  if (err == cudaSuccess)          // all of the SM's shared memory: 2 blocks
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, p.smem_bytes, s>>>(
      qs, emb, bias, Q, N, E, k, p.qtile, p.L, p.nchunks, p.mergers, cand_s,
      cand_i, heads, ticket, out_s, out_i);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kStaged>
int launch_q(const Plan& p, dim3 grid, cudaStream_t s, const float* qs,
             const float* emb, const float* bias, int Q, int N, int E, int k,
             float* cand_s, int* cand_i, int* heads, unsigned* ticket,
             float* out_s, int* out_i) {
  return p.qtile == 1
             ? launch<T, 1, 4, kStaged>(p, grid, s, qs, emb, bias, Q, N, E, k,
                                        cand_s, cand_i, heads, ticket, out_s,
                                        out_i)
             : launch<T, kMaxQ, 2, kStaged>(p, grid, s, qs, emb, bias, Q, N,
                                            E, k, cand_s, cand_i, heads,
                                            ticket, out_s, out_i);
}

}  // namespace

// Scratch the caller allocates for query_topk_bias_launch: cand_s / cand_i
// [Q, nchunks, L] and heads [Q, nchunks], plus two counter words that are
// zero before the first launch (the kernel leaves them at zero).
// Returns make_plan's code.
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
// [Q, k] i32.  One launch.  Returns make_plan's code, else
// cudaGetLastError() after the launch (0 = launched).
extern "C" int query_topk_bias_launch(const float* qs, const float* emb,
                                      const float* bias, int Q, int N, int E,
                                      int k, float* cand_s, int* cand_i,
                                      int* heads, unsigned* ticket,
                                      float* out_s, int* out_i,
                                      void* stream) {
  Plan p;
  const int plan_err = make_plan(Q, N, E, k, &p);
  if (plan_err != 0) return plan_err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(p.nchunks, (Q + p.qtile - 1) / p.qtile);
  const bool vec4 = E % 4 == 0 && reinterpret_cast<uintptr_t>(emb) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(qs) % 16 == 0;
  if (vec4)
    return p.staged ? launch_q<float4, true>(p, grid, s, qs, emb, bias, Q, N,
                                             E, k, cand_s, cand_i, heads,
                                             ticket, out_s, out_i)
                    : launch_q<float4, false>(p, grid, s, qs, emb, bias, Q, N,
                                              E, k, cand_s, cand_i, heads,
                                              ticket, out_s, out_i);
  return p.staged ? launch_q<float, true>(p, grid, s, qs, emb, bias, Q, N, E,
                                          k, cand_s, cand_i, heads, ticket,
                                          out_s, out_i)
                  : launch_q<float, false>(p, grid, s, qs, emb, bias, Q, N, E,
                                           k, cand_s, cand_i, heads, ticket,
                                           out_s, out_i);
}
