// The gradient of blocked (flash) attention, for Hopper.
//
// Replaces: the gradient of src/repro/kernels/flash_attention.py ::
// flash_attention_pallas, whose forward csrc/flash_attention.cu ports.  The
// TPU package has no Pallas backward: it trains through the jnp
// blocked_attention (src/repro/models/attention.py) under jax.grad.  The
// port's forward is the hand-written kernel, so training on the card needs
// this one.
//
// What it computes, per (batch b, query head h), for
//   s = softcap(q . k^T * dqk^-0.5),  p = softmax(mask(s)),  o = p . v,
// given the forward's per-row log-sum-exp lse = log(sum_kept exp(s)) (the
// natural log over the scaled, softcapped score; csrc/flash_attention.cu
// writes it when asked), so p = exp(s - lse) on the kept keys:
//   dv = p~^T . do        (p~ = p rounded to v's dtype, as the forward
//                           rounds p before p . v)
//   dp = do . v^T,   D = rowsum(do * o)
//   ds = p * (dp - D) * (1 - t^2) * dqk^-0.5  (t = s / softcap = tanh(...);
//                                              1 without a softcap)
//   dq = ds . k,     dk = ds^T . q
// In bf16, ds is rounded to bf16 before dq and dk (the tensor cores take
// bf16 operands); scores, dp, D and every accumulator stay f32.  q
// [B, S, H, dqk], k [B, T, Kv, dqk], v [B, T, Kv, dv] and o, do
// [B, S, H, dv] are read through their strides (the head dim contiguous;
// T, the keys, differs from S only without the causal mask and the
// window, as in whisper's cross-attention),
// query head h reading kv head h / (H / Kv); dk and dv of kv head j sum
// over its G = H / Kv query heads.  dq, dk [.., dqk] and dv [.., dv] are
// written contiguous in q's dtype.  (dqk, dv) is (64, 64), (128, 128),
// (192, 128), DeepSeek MLA's prefill (a q / k head of qk_nope + qk_rope =
// 128 + 64, a v head of 128), (120, 120), h2o-danube-3's head, or (96, 96),
// phi-3's:
// S = Q . K^T contracts over dqk and dP = dO . V^T over dv; Q, K, dQ and
// dK are ceil(dqk / 64) panels of 64 columns, V, dO and dV ceil(dv / 64).
// Masks as the forward: causal kpos <= qpos, window qpos - kpos < window,
// and keys at or past T never count: a key row past T gets no gradient
// (it is not stored), and a query row past S (zero-filled) adds nothing to
// dk or dv (its p is masked to 0).
//
// Design: two launches, no float atomics, so two calls give the same bits.
// The forward's lse replaces a statistics pass, so the scores are formed
// twice, once per launch: seven products of a 64 x 64 tile pair, against
// the five of a kernel that sums dq with atomics.
//   bf16 (tensor cores, wgmma m64n64k16, f32 accumulators):
//   1. flash_bwd_dq_kernel, one warpgroup per (b, h, 64-query tile), tiles
//      numbered latest query tile (the longest causal walk) first, three
//      blocks an SM at (64, 64) (the captioner's training shape's 384
//      blocks in one wave), two at (128, 128) and one at (192, 128), whose
//      Q, dO and two stages of K and V take 121 KB.  It
//      forms D = rowsum(do * o) and writes D * scale for launch 2, then
//      walks the key tiles the masks let in: S = Q . K^T and dP = dO . V^T
//      with both operands in shared memory (K-major, 128-byte swizzle), ds
//      in registers, rounded to bf16 into the A fragments of dQ += dS . K,
//      with K read in its stored [keys, dh] layout through the
//      instruction's transpose of B.
//   2. flash_bwd_dkdv_kernel, one block per (b, kv head, 64-key tile), key
//      tiles numbered from the first (the longest causal walk) first.  Keys
//      are rows: S^T = K . Q^T and dP^T = V . dO^T, then dV += P~^T . dO and
//      dK += dS^T . Q with dO and Q read as stored through the transpose of
//      B.  The block holds K and V and runs two warpgroups; its (query
//      head, query tile) pairs are dealt round-robin to them, and at the
//      end warpgroup 1 adds its dk, dv into warpgroup 0's through shared
//      memory, always in that order.  So the G heads of a kv head share
//      the block without a [G, ...] scratch, a second pass or atomics; at
//      the captioner's training shape the 128 blocks fit the card's 132
//      SMs in one wave.  At (192, 128) the block holds K and V (40 KB) and
//      per warpgroup two stages of Q, dO and stats (81 KB), 203 KB in all,
//      and a thread keeps dK (96 f32) and dV (64) with S^T and dP^T (32 +
//      32) live: 224 of its 255 registers before addresses.
//      It is launched as a programmatic dependent of launch 1: its
//      blocks load K and V while launch 1 finishes and wait
//      (griddepcontrol.wait) only before they read D.
//   Each warpgroup loads its next Q / dO (or K / V) tiles with cp.async
//   while the tensor cores work on the current ones (double buffering),
//   into the swizzled layout the wgmma descriptors read.  Per score the
//   elementwise work is two FFMAs, one ex2 and one FMUL (form_ds_tile);
//   the mask is applied only in the tiles that need it.
//   f32 (SIMT fp32 FMA, no TF32): the same two launches over 64 x 64 tiles
//   in shared memory, 256 threads each owning a 4 x 4 micro-tile of scores.
//   A head width that is not a multiple of 64 (120, 96) runs on the tiles
//   of the next one (128), as the forward does (csrc/flash_attention.cu): in
//   bf16 load_tile copies the true width of each row and zero-fills the
//   16-byte chunks past it (a cp.async of source size 0, as rows past S
//   are filled), so S = Q . K^T, dP = dO . V^T, dQ = dS . K, dK = dS^T . Q
//   and dV = P~^T . dO are exact in the true columns, and the stores skip
//   the columns past it at compile time and step rows by the true width;
//   in f32 a thread's column arrays round up to whole 16-column steps and
//   skip the columns past the width.  q, k, v, o and do are read where
//   they lie: no padded copy.  The scale stays the true width's dqk^-0.5.
//
// What bounds it on this card: bytes.  At the captioner's training shape
// (B = 8, S = 256, H = 12, Kv = 4, dh = 64, bf16, causal) q, k, v, o, do and
// lse read and dq, dk, dv written once are 16.9 MB, 5.0 us at 3.35 TB/s;
// the five products the function needs are 2.0 GFLOP, 2.0 us at the bf16
// tensor-core peak.  The design keeps every intermediate (scores, p, ds) in
// registers and reads each Q / dO tile once per key tile and each K / V tile
// once per query tile, from L2 after the first touch.  What keeps it from
// the bound at this shape is the short walk: a block handles at most four
// tile pairs per warpgroup, so the first loads from device memory (all
// blocks at once) and the serial chain of products and elementwise work
// per tile are not hidden behind other tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRows = 64;              // query rows and keys per tile

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;                       // do, the output's gradient
  const float* lse;                    // [B, H, S] the forward's log-sum-exp
  void* dq;
  void* dk;
  void* dv;
  float* dsum;                         // [B, H, S] D (bf16: D * scale),
                                       // from launch 1 to launch 2
  long long qs_b, qs_s, qs_h;          // element strides (b, s, head)
  long long ks_b, ks_s, ks_h;
  long long vs_b, vs_s, vs_h;
  long long os_b, os_s, os_h;
  long long gs_b, gs_s, gs_h;
  int B, S, T, H, Kv, causal, window;  // S queries, T keys
  float scale, softcap;
};

__device__ __forceinline__ bool allowed(const Args& a, int qpos, int kpos) {
  bool ok = qpos < a.S && kpos < a.T;
  if (a.causal) ok = ok && kpos <= qpos;
  if (a.window > 0) ok = ok && qpos - kpos < a.window;
  return ok;
}

// a 64 x 64 tile pair (queries from q0, keys from k0) that some mask cuts
__device__ __forceinline__ bool tile_masked(const Args& a, int q0, int k0) {
  return q0 + kRows > a.S || k0 + kRows > a.T ||
         (a.causal && k0 + kRows - 1 > q0) ||
         (a.window > 0 && q0 + kRows - 1 - k0 >= a.window);
}

// the key tiles [begin, end) that query tile q0 needs, and the query tiles
// that key tile k0 is kept by
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int* begin,
                                          int* end) {
  int e = (a.T + kRows - 1) / kRows;
  if (a.causal) e = min(e, (q0 + kRows - 1) / kRows + 1);
  *end = e;
  *begin = a.window > 0 ? max(0, q0 - a.window + 1) / kRows : 0;
}

__device__ __forceinline__ void query_tiles(const Args& a, int k0,
                                            int* begin, int* end) {
  *begin = a.causal ? k0 / kRows : 0;
  int e = (a.S + kRows - 1) / kRows;
  if (a.window > 0) {
    const int last = min(a.S, k0 + kRows - 1 + a.window);  // past the last
    e = min(e, (last + kRows - 1) / kRows);
  }
  *end = e;
}

// ------------------------------------------------------- bf16 (wgmma)
constexpr int kPanelBytes = kRows * 128;   // [64 rows, 64 bf16 cols]

// wgmma warpgroups of the dk/dv block: two, each with up to 255
// registers (dk and dv take 64 a thread at dh = 64, 128 at dh = 128).  At
// dh = 64 three groups time the same on an H100 and spill.
constexpr int kGroups = 2;

// Per (dqk, dv) pair: 64-column panels of a Q / K row and of a V / dO row,
// the bytes of a [64, dqk] and a [64, dv] tile, and shared memory (a
// [Q or K, dO or V] pair of tiles is kPair bytes)
template <int DQK, int DV>
struct Bwd {
  static constexpr int PQ = (DQK + 63) / 64, PV = (DV + 63) / 64;
  static constexpr int kQkBytes = PQ * kPanelBytes;
  static constexpr int kVBytes = PV * kPanelBytes;
  static constexpr int kPair = kQkBytes + kVBytes;
  static constexpr int kDqSmem = 3 * kPair + 1024;
  static constexpr int kStatBytes = 2 * 2 * kRows * 4;  // [stage][lse, D]
  static int dkdv_smem(int groups) {
    return kPair + groups * (2 * kPair + kStatBytes) + 1024;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (1024-byte
// aligned atoms of 8 rows x 128 bytes): start address, leading and stride
// byte offsets in 16-byte units, layout type 1 (128B swizzle) in bits 62-63
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving register reads or reuse across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d[32] (+)= A (shared, K-major) . B (shared, K-major): m64n64k16
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[32] += A (registers, bf16) . B (shared, MN-major): m64n64k16
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one 32-bit register of bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator layout of wgmma m64n64 (f32): warp w of the warpgroup owns
// rows 16w .. 16w + 15; with g = lane / 4, t = lane % 4, register 4j + e
// (e = 0, 1) holds row g, column 8j + 2t + e, and 4j + 2 + e row g + 8, the
// same column.  The A operand from registers (m64k16 bf16) follows
// mma.sync's m16n8k16 A layout per warp, so the registers of columns
// 16kk .. 16kk + 15 are A fragment kk (pack_a).
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&fa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fa[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    fa[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    fa[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    fa[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// d = A . B^T for two [64, 64 P] tiles in shared memory (both K-major: dh
// contiguous, P swizzled panels of 64 rows); 16 of dh per wgmma
template <int P>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * P; ++kk) {
    const uint32_t off = ((kk / 4) * kPanelBytes + (kk % 4) * 32) / 16;
    wgmma_ss_n64(d, da + off, db + off, kk > 0);
  }
  wgmma_commit();
}

// acc[P] += A (64 x 64, registers) . M, M a [64, D] tile read as stored
// ([rows = the product's depth, dh] with dh contiguous) through the
// transpose of B: 16 rows (2048 bytes of a panel) per wgmma
template <int P>
__device__ __forceinline__ void issue_rs(float (&acc)[P][32],
                                         uint32_t (&fa)[4][4], uint64_t dm) {
#pragma unroll
  for (int p = 0; p < P; ++p) fence_regs(acc[p]);
  fence_regs(fa);
  wgmma_fence();
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64_tb(acc[p], fa[kk], dm + (p * kPanelBytes + kk * 2048) / 16);
  wgmma_commit();
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's cp.async writes, visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// barrier of one warpgroup (ids 1..3; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// rows [row0, row0 + 64) of one head (base at (b, head)) into a swizzled
// [64, 64 ceil(D / 64)] tile at dst: 16-byte chunk c of row r lands at
// chunk c ^ (r % 8) of its 128-byte panel row, as TMA's 128-byte swizzle
// would put it; rows at or past S, and the chunks past the head's D columns
// (8 of them at D = 120, 16 at D = 96), are zero-filled.  Thread i of n
// copies chunks i, i + n, ...
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* base,
                                          long long stride, int row0, int S,
                                          int i0, int n) {
  constexpr int C = (D + 63) / 64 * 8;   // 16-byte chunks a tile row
  for (int i = i0; i < kRows * C; i += n) {
    const int r = i / C, c = i % C;
    const uint32_t at = dst + (c / 8) * kPanelBytes + r * 128 +
                        (((c % 8) ^ (r % 8)) << 4);
    const bool ok = row0 + r < S && c < D / 8;
    cp_async16(at, ok ? base + (row0 + r) * stride + c * 8 : base,
               ok ? 16 : 0);
  }
}

// p and ds of one 64 x 64 tile pair, in place: sc holds the raw dot
// products q . k and becomes p, dp holds dO . V and becomes ds.  Rows are
// queries in launch 1 (lse and D per row) and keys in launch 2 (lse and D
// per column), so the caller passes, for accumulator register 4j + e,
// lse * log2(e) (l2), D * scale (ds) and the mask (keep) as functions.
// Without a softcap a score costs two FFMAs, one ex2 and one FMUL:
//   p = ex2(s * scale * log2(e) - l2),  ds = p * (dp * scale - D * scale).
// The mask is tested only in tiles that need it (kMasked).
template <bool kMasked, typename L2, typename Ds, typename Keep>
__device__ __forceinline__ void form_ds_tile(const Args& a, float (&sc)[32],
                                             float (&dp)[32], L2 l2, Ds ds,
                                             Keep keep) {
  if (a.softcap > 0.f) {
    const float cin = a.scale / a.softcap, cout = a.softcap * kLog2e;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int j = r / 4, e = r % 4;
      const float th = tanhf(sc[r] * cin);
      float p = ex2(fmaf(th, cout, -l2(j, e)));
      if (kMasked && !keep(j, e)) p = 0.f;
      sc[r] = p;
      dp[r] = p * fmaf(dp[r], a.scale, -ds(j, e)) * (1.f - th * th);
    }
  } else {
    const float c = a.scale * kLog2e;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int j = r / 4, e = r % 4;
      float p = ex2(fmaf(sc[r], c, -l2(j, e)));
      if (kMasked && !keep(j, e)) p = 0.f;
      sc[r] = p;
      dp[r] = p * fmaf(dp[r], a.scale, -ds(j, e));
    }
  }
}

template <typename L2, typename Ds, typename Keep>
__device__ __forceinline__ void form_ds(const Args& a, float (&sc)[32],
                                        float (&dp)[32], bool masked, L2 l2,
                                        Ds ds, Keep keep) {
  if (masked)
    form_ds_tile<true>(a, sc, dp, l2, ds, keep);
  else
    form_ds_tile<false>(a, sc, dp, l2, ds, keep);
}

// three blocks an SM at dh = 64 (168 registers): the 384 blocks of the
// captioner's training shape then run in one wave on 132 SMs; two on the
// 128-wide tiles (dh 128, 120 and 96); one at (192, 128), whose 121 KB of
// shared memory leave no room for a second
template <int DQK, int DV>
__global__ void __launch_bounds__(128, (DQK + 63) / 64 == 1   ? 3
                                       : (DQK + 63) / 64 == 2 ? 2
                                                              : 1)
    flash_bwd_dq_kernel(const Args a) {
  using C = Bwd<DQK, DV>;
  constexpr int PQ = C::PQ, QB = C::kQkBytes, VB = C::kVBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ float s_d[kRows];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sg = base + QB;
  const uint32_t sk = sg + VB, sv = sk + 2 * QB;         // two stages each

  const int n_q = (a.S + kRows - 1) / kRows, BH = a.B * a.H;
  const int i = static_cast<int>(blockIdx.x);
  const int q0 = (n_q - 1 - i / BH) * kRows;            // latest tile first
  const int b = (i % BH) / a.H, h = i % a.H;
  const int kvh = h / (a.H / a.Kv);
  const int tid = threadIdx.x;
  using bf16 = __nv_bfloat16;
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.qs_b + h * a.qs_h;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.ks_b + kvh * a.ks_h;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.vs_b + kvh * a.vs_h;
  const bf16* O = static_cast<const bf16*>(a.o) + b * a.os_b + h * a.os_h;
  const bf16* G = static_cast<const bf16*>(a.g) + b * a.gs_b + h * a.gs_h;
  int kt_begin, kt_end;
  key_tiles(a, q0, &kt_begin, &kt_end);
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int qpos0 = q0 + warp * 16 + g, qpos1 = qpos0 + 8;
  const long long srow = (static_cast<long long>(b) * a.H + h) * a.S;
  const float l20 = qpos0 < a.S ? a.lse[srow + qpos0] * kLog2e : 0.f;
  const float l21 = qpos1 < a.S ? a.lse[srow + qpos1] * kLog2e : 0.f;

  // the dk/dv launch may start its prologue now (programmatic launch)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  load_tile<DQK>(sq, Q, a.qs_s, q0, a.S, tid, 128);
  load_tile<DV>(sg, G, a.gs_s, q0, a.S, tid, 128);
  load_tile<DQK>(sk, K, a.ks_s, kt_begin * kRows, a.T, tid, 128);
  load_tile<DV>(sv, V, a.vs_s, kt_begin * kRows, a.T, tid, 128);
  cp_async_commit();

  // D = rowsum(do * o) in f32, two threads a row, while the tiles load:
  // of a row's DV / 8 16-byte chunks the first thread sums the first
  // ceil(DV / 16) and the second the rest (8 and 7 at DV = 120, 6 and 6 at
  // DV = 96, the second from byte 96 of the row: 16-byte aligned), each in
  // order, then the first adds the second's sum to its own.  Launch 2
  // reads it as D * scale.
  {
    constexpr int CV = DV / 8, C0 = (CV + 1) / 2;
    const int r = tid / 2, half = tid % 2;
    float acc = 0.f;
    if (q0 + r < a.S) {
      const bf16* orow = O + (q0 + r) * a.os_s + half * C0 * 8;
      const bf16* grow = G + (q0 + r) * a.gs_s + half * C0 * 8;
#pragma unroll
      for (int c = 0; c < C0; ++c) {
        if (half * C0 + c >= CV) break;
        const uint4 uo = *reinterpret_cast<const uint4*>(orow + 8 * c);
        const uint4 ug = *reinterpret_cast<const uint4*>(grow + 8 * c);
        const __nv_bfloat162* ho = reinterpret_cast<const __nv_bfloat162*>(&uo);
        const __nv_bfloat162* hg = reinterpret_cast<const __nv_bfloat162*>(&ug);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fo = __bfloat1622float2(ho[e]);
          const float2 fg = __bfloat1622float2(hg[e]);
          acc = fmaf(fg.x, fo.x, acc);
          acc = fmaf(fg.y, fo.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      s_d[r] = acc * a.scale;
      if (q0 + r < a.S) a.dsum[srow + q0 + r] = acc * a.scale;
    }
  }
  __syncthreads();
  const float ds0 = s_d[warp * 16 + g], ds1 = s_d[warp * 16 + g + 8];

  const uint64_t dq_a = sw128_desc(sq, 16, 1024);
  const uint64_t dg_a = sw128_desc(sg, 16, 1024);
  const uint64_t dk_b = sw128_desc(sk, 16, 1024);          // stage 0
  const uint64_t dv_b = sw128_desc(sv, 16, 1024);
  const uint64_t dk_t = sw128_desc(sk, kPanelBytes, 1024);  // transposed
  constexpr uint64_t kStageK = QB / 16, kStageV = VB / 16;

  float acc[PQ][32];
#pragma unroll
  for (int p = 0; p < PQ; ++p)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[p][r] = 0.f;
  float sc[32], dp[32];
  uint32_t fa[4][4];

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int st = (kt - kt_begin) & 1, k0 = kt * kRows;
    if (kt + 1 < kt_end) {           // the next K, V tiles into the other stage
      load_tile<DQK>(sk + (st ^ 1) * QB, K, a.ks_s, k0 + kRows, a.T, tid,
                     128);
      load_tile<DV>(sv + (st ^ 1) * VB, V, a.vs_s, k0 + kRows, a.T, tid,
                    128);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    issue_ss<PQ>(sc, dq_a, dk_b + st * kStageK);   // S = Q . K^T
    issue_ss<C::PV>(dp, dg_a, dv_b + st * kStageV);  // dP = dO . V^T
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    const int kc = k0 + 2 * t;
    form_ds(
        a, sc, dp, tile_masked(a, q0, k0),
        [&](int, int e) { return e < 2 ? l20 : l21; },
        [&](int, int e) { return e < 2 ? ds0 : ds1; },
        [&](int j, int e) {
          return allowed(a, e < 2 ? qpos0 : qpos1, kc + 8 * j + (e & 1));
        });
    pack_a(dp, fa);
    issue_rs<PQ>(acc, fa, dk_t + st * kStageK);   // dQ += dS . K
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < PQ; ++p) fence_regs(acc[p]);
    __syncthreads();                  // stage st is free for the next load
  }

  bf16* dQ = static_cast<bf16*>(a.dq) +
             (static_cast<long long>(b) * a.S * a.H + h) * DQK + 2 * t;
#pragma unroll
  for (int p = 0; p < PQ; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = p * 64 + 8 * j;
      if (d >= DQK) break;             // columns past the head's width
      if (qpos0 < a.S)
        *reinterpret_cast<__nv_bfloat162*>(
            dQ + static_cast<long long>(qpos0) * a.H * DQK + d) =
            __floats2bfloat162_rn(acc[p][4 * j], acc[p][4 * j + 1]);
      if (qpos1 < a.S)
        *reinterpret_cast<__nv_bfloat162*>(
            dQ + static_cast<long long>(qpos1) * a.H * DQK + d) =
            __floats2bfloat162_rn(acc[p][4 * j + 2], acc[p][4 * j + 3]);
    }
}

// a warpgroup's [64 rows, P * 64] f32 accumulator as bf16 rows of an
// output of D columns whose row r0 + i starts at out + i * stride (this
// thread's rows r0 and r0 + 8, its column 2t already in out); rows at or
// past S and columns at or past D are skipped
template <int P, int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out,
                                           long long stride, int r0, int S,
                                           const float (&acc)[P][32]) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int d = p * 64 + 8 * j;
      if (d >= D) break;
      if (r0 < S)
        *reinterpret_cast<__nv_bfloat162*>(out + r0 * stride + d) =
            __floats2bfloat162_rn(acc[p][4 * j], acc[p][4 * j + 1]);
      if (r0 + 8 < S)
        *reinterpret_cast<__nv_bfloat162*>(out + (r0 + 8) * stride + d) =
            __floats2bfloat162_rn(acc[p][4 * j + 2], acc[p][4 * j + 3]);
    }
}

// Shared memory (dynamic, 1024-byte aligned): the K and V tiles, then for
// each warpgroup two stages of [Q tile, dO tile], then for each warpgroup
// two stages of [lse, D] (64 floats each).  At the end a warpgroup's Q / dO
// stages (2 * kPair bytes, (PQ + PV) * 16 KB) hold its f32 dk and dv for
// the fixed-order sum.
template <int DQK, int DV>
__global__ void __launch_bounds__(128 * kGroups, 1)
    flash_bwd_dkdv_kernel(const Args a) {
  using C = Bwd<DQK, DV>;
  constexpr int PQ = C::PQ, PV = C::PV, QB = C::kQkBytes, PAIR = C::kPair;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const int W = blockDim.x / 128;
  const int wg = threadIdx.x / 128, lt = threadIdx.x % 128;
  const uint32_t sk = base, sv = base + QB;
  const uint32_t mine = base + PAIR + wg * 2 * PAIR;     // [stage][Q, dO]
  float* const stats = reinterpret_cast<float*>(gbase + PAIR + W * 2 * PAIR) +
                       wg * 4 * kRows;                    // [stage][lse, D]

  const int BK = a.B * a.Kv;
  const int i = static_cast<int>(blockIdx.x);
  const int k0 = (i / BK) * kRows;                       // first tile first
  const int b = (i % BK) / a.Kv, kvh = i % a.Kv;
  const int G = a.H / a.Kv;
  using bf16 = __nv_bfloat16;
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.ks_b + kvh * a.ks_h;
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.vs_b + kvh * a.vs_h;
  int qt_begin, qt_end;
  query_tiles(a, k0, &qt_begin, &qt_end);
  const int nq = qt_end - qt_begin;
  const int n_items = G * nq;                  // (query head, query tile)
  const int n_mine = wg < n_items ? (n_items - wg + W - 1) / W : 0;

  // item n of this warpgroup: its query head and first query row
  auto head = [&](int n) { return kvh * G + (wg + n * W) / nq; };
  auto first_row = [&](int n) {
    return (qt_begin + (wg + n * W) % nq) * kRows;
  };
  auto load_item = [&](int n, int st) {
    const int h = head(n), q0 = first_row(n);
    const uint32_t dst = mine + st * PAIR;
    load_tile<DQK>(dst,
                   static_cast<const bf16*>(a.q) + b * a.qs_b + h * a.qs_h,
                   a.qs_s, q0, a.S, lt, 128);
    load_tile<DV>(dst + QB,
                  static_cast<const bf16*>(a.g) + b * a.gs_b + h * a.gs_h,
                  a.gs_s, q0, a.S, lt, 128);
    // lse (threads 0..63) and D (64..127) of the 64 query rows, 0 past S
    const int r = lt % kRows;
    const bool ok = q0 + r < a.S;
    const float* src = (lt < kRows ? a.lse : a.dsum) +
                       (static_cast<long long>(b) * a.H + h) * a.S +
                       (ok ? q0 + r : 0);
    cp_async4(smem_u32(stats + st * 2 * kRows + lt), src, ok ? 4 : 0);
  };

  load_tile<DQK>(sk, K, a.ks_s, k0, a.T, threadIdx.x, blockDim.x);
  load_tile<DV>(sv, V, a.vs_s, k0, a.T, threadIdx.x, blockDim.x);
  cp_async_commit();
  // D comes from launch 1: wait for it to finish (and its writes)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if (n_mine > 0) load_item(0, 0);
  cp_async_commit();
  cp_async_wait<1>();                  // K and V in (this thread's part)
  fence_proxy_async();
  __syncthreads();

  const int warp = lt / 32, lane = lt % 32, g = lane / 4, t = lane % 4;
  const int kpos0 = k0 + warp * 16 + g, kpos1 = kpos0 + 8;
  const uint64_t dk_a = sw128_desc(sk, 16, 1024);
  const uint64_t dv_a = sw128_desc(sv, 16, 1024);
  const uint64_t dq_b = sw128_desc(mine, 16, 1024);        // stage 0, Q
  const uint64_t dq_t = sw128_desc(mine, kPanelBytes, 1024);
  constexpr uint64_t kStage = PAIR / 16, kQ = QB / 16;

  float dk[PQ][32], dv[PV][32];
#pragma unroll
  for (int p = 0; p < PQ; ++p)
#pragma unroll
    for (int r = 0; r < 32; ++r) dk[p][r] = 0.f;
#pragma unroll
  for (int p = 0; p < PV; ++p)
#pragma unroll
    for (int r = 0; r < 32; ++r) dv[p][r] = 0.f;
  float sc[32], dp[32];
  uint32_t fp[4][4], fs[4][4];

  for (int n = 0; n < n_mine; ++n) {
    const int st = n & 1;
    if (n + 1 < n_mine) {
      load_item(n + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    group_sync(wg);
    const int q0 = first_row(n);
    const uint64_t q_b = dq_b + st * kStage, g_b = q_b + kQ;
    issue_ss<PQ>(sc, dk_a, q_b);                // S^T = K . Q^T
    issue_ss<PV>(dp, dv_a, g_b);                // dP^T = V . dO^T
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    const float* lse = stats + st * 2 * kRows;
    const float* dsum = lse + kRows;
    const int qc = q0 + 2 * t;
    form_ds(
        a, sc, dp, tile_masked(a, q0, k0),
        [&](int j, int e) {
          return lse[8 * j + 2 * t + (e & 1)] * kLog2e;
        },
        [&](int j, int e) { return dsum[8 * j + 2 * t + (e & 1)]; },
        [&](int j, int e) {
          return allowed(a, qc + 8 * j + (e & 1), e < 2 ? kpos0 : kpos1);
        });
    pack_a(sc, fp);                             // p~ (bf16)
    pack_a(dp, fs);                             // ds (bf16)
    const uint64_t q_t = dq_t + st * kStage, g_t = q_t + kQ;
    issue_rs<PV>(dv, fp, g_t);                  // dV += P~^T . dO
    issue_rs<PQ>(dk, fs, q_t);                  // dK += dS^T . Q
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < PQ; ++p) fence_regs(dk[p]);
#pragma unroll
    for (int p = 0; p < PV; ++p) fence_regs(dv[p]);
    group_sync(wg);                   // stage st is free for the next load
  }

  // warpgroups 1.. hand their sums to warpgroup 0 through their own stages
  // ((PQ + PV) * 32 * 128 floats), which adds them in order
  __syncthreads();
  float* red = reinterpret_cast<float*>(gbase + PAIR + wg * 2 * PAIR);
  if (wg > 0) {
#pragma unroll
    for (int p = 0; p < PQ; ++p)
#pragma unroll
      for (int r = 0; r < 32; ++r) red[(p * 32 + r) * 128 + lt] = dk[p][r];
#pragma unroll
    for (int p = 0; p < PV; ++p)
#pragma unroll
      for (int r = 0; r < 32; ++r)
        red[((PQ + p) * 32 + r) * 128 + lt] = dv[p][r];
  }
  __syncthreads();
  if (wg != 0) return;
  for (int w = 1; w < W; ++w) {
    const float* src = reinterpret_cast<const float*>(gbase + PAIR +
                                                      w * 2 * PAIR);
#pragma unroll
    for (int p = 0; p < PQ; ++p)
#pragma unroll
      for (int r = 0; r < 32; ++r) dk[p][r] += src[(p * 32 + r) * 128 + lt];
#pragma unroll
    for (int p = 0; p < PV; ++p)
#pragma unroll
      for (int r = 0; r < 32; ++r)
        dv[p][r] += src[((PQ + p) * 32 + r) * 128 + lt];
  }
  const long long row = static_cast<long long>(b) * a.T * a.Kv + kvh;
  store_rows<PQ, DQK>(static_cast<bf16*>(a.dk) + row * DQK + 2 * t,
                      static_cast<long long>(a.Kv) * DQK, kpos0, a.T, dk);
  store_rows<PV, DV>(static_cast<bf16*>(a.dv) + row * DV + 2 * t,
                     static_cast<long long>(a.Kv) * DV, kpos0, a.T, dv);
}

// ----------------------------------------------------------------- f32
constexpr int kThreads = 256;          // 16 x 16 threads, 4 x 4 each
constexpr int kLdw = kRows + 1;        // row stride of the [64, 64] tiles

// a thread's output columns tx, tx + 16, ... of a width-D row: ceil(D / 16)
// of them, the last past D when D is no multiple of 16 (120: 112 + tx; 96
// is six whole steps)
template <int D>
__host__ __device__ constexpr int cols16() { return (D + 15) / 16; }

// rows [row0, row0 + 64) of one head (base already at (b, head)) into
// dst [64][D + 1] floats; rows at or past S are zero
template <int D>
__device__ __forceinline__ void load_f32(float* dst, const float* base,
                                         long long stride, int row0, int S) {
  constexpr int C = D / 4;
  for (int i = threadIdx.x; i < kRows * C; i += kThreads) {
    const int row = i / C, c = i % C;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + row < S)
      x = *reinterpret_cast<const float4*>(base + (row0 + row) * stride +
                                           c * 4);
    float* out = dst + row * (D + 1) + c * 4;
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
}

// acc[r][c] = A[ty + 16 r] . Bm[tx + 16 c] over D (rows of [64][D + 1])
template <int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         int ty, int tx, float acc[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = A[(ty + 16 * r) * LD + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) y[c] = Bm[(tx + 16 * c) * LD + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(x[r], y[c], acc[r][c]);
  }
}

// out[r][c] += sum_j W[ty + 16 r][j] * M[j][tx + 16 c] for the columns
// below D (W [64][65], M [64][D + 1])
template <int D>
__device__ __forceinline__ void tile_acc(const float* W, const float* M,
                                         int ty, int tx,
                                         float out[4][cols16<D>()]) {
  constexpr int LD = D + 1;
#pragma unroll 4
  for (int j = 0; j < kRows; ++j) {
    float w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = W[(ty + 16 * r) * kLdw + j];
#pragma unroll
    for (int c = 0; c < cols16<D>(); ++c) {
      if (D % 16 == 0 || tx + 16 * c < D) {
        const float mv = M[j * LD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) out[r][c] = fmaf(w[r], mv, out[r][c]);
      }
    }
  }
}

// the scaled, softcapped score of one dot product, and the softcap's
// factor d s / d x = 1 - t^2 (1 without a softcap)
__device__ __forceinline__ float score(const Args& a, float dot,
                                       float* capfac) {
  float x = dot * a.scale;
  float f = 1.f;
  if (a.softcap > 0.f) {
    const float t = tanhf(x / a.softcap);
    x = t * a.softcap;
    f = 1.f - t * t;
  }
  *capfac = f;
  return x;
}

// Q, K [64][DQK + 1] and dO, V [64][DV + 1] (rows of 193 and 129 floats
// at (192, 128): 181 KB in launch 1, 199 KB in launch 2)
template <int DQK, int DV>
constexpr int dq_f32_smem() {          // Q, dO, K, V; ds; D
  return (2 * kRows * (DQK + 1) + 2 * kRows * (DV + 1) + kRows * kLdw +
          kRows) * static_cast<int>(sizeof(float));
}

template <int DQK, int DV>
constexpr int dkdv_f32_smem() {        // K, V, Q, dO; p, ds; lse, D
  return (2 * kRows * (DQK + 1) + 2 * kRows * (DV + 1) + 2 * kRows * kLdw +
          2 * kRows) * static_cast<int>(sizeof(float));
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_f32_kernel(const Args a) {
  constexpr int LQ = DQK + 1, LV = DV + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + kRows * LQ;
  float* Ks = Gs + kRows * LV;
  float* Vs = Ks + kRows * LQ;
  float* Ws = Vs + kRows * LV;
  float* Dsh = Ws + kRows * kLdw;

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.Kv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* Q = static_cast<const float*>(a.q) + b * a.qs_b + h * a.qs_h;
  const float* K = static_cast<const float*>(a.k) + b * a.ks_b + kvh * a.ks_h;
  const float* V = static_cast<const float*>(a.v) + b * a.vs_b + kvh * a.vs_h;
  const float* O = static_cast<const float*>(a.o) + b * a.os_b + h * a.os_h;
  const float* G = static_cast<const float*>(a.g) + b * a.gs_b + h * a.gs_h;
  const long long srow = (static_cast<long long>(b) * a.H + h) * a.S;

  load_f32<DQK>(Qs, Q, a.qs_s, q0, a.S);
  load_f32<DV>(Gs, G, a.gs_s, q0, a.S);
  load_f32<DV>(Vs, O, a.os_s, q0, a.S);         // o, for D only
  __syncthreads();
  if (tid < kRows) {
    float acc = 0.f;
    for (int d = 0; d < DV; ++d) acc = fmaf(Gs[tid * LV + d],
                                            Vs[tid * LV + d], acc);
    Dsh[tid] = acc;
    if (q0 + tid < a.S) a.dsum[srow + q0 + tid] = acc;
  }
  float lse[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q0 + ty + 16 * r;
    lse[r] = qpos < a.S ? a.lse[srow + qpos] : 0.f;
  }

  int kt_begin, kt_end;
  key_tiles(a, q0, &kt_begin, &kt_end);
  float dq[4][cols16<DQK>()];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < cols16<DQK>(); ++c) dq[r][c] = 0.f;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();
    load_f32<DQK>(Ks, K, a.ks_s, k0, a.T);
    load_f32<DV>(Vs, V, a.vs_s, k0, a.T);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<DQK>(Qs, Ks, ty, tx, s);
    tile_dot<DV>(Gs, Vs, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty + 16 * r;
      const float drow = Dsh[ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float f;
        const float x = score(a, s[r][c], &f);
        const float p = allowed(a, qpos, k0 + tx + 16 * c)
                            ? expf(x - lse[r]) : 0.f;
        Ws[(ty + 16 * r) * kLdw + tx + 16 * c] =
            p * (dp[r][c] - drow) * f * a.scale;
      }
    }
    __syncthreads();
    tile_acc<DQK>(Ws, Ks, ty, tx, dq);
  }

  float* dQ = static_cast<float*>(a.dq);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q0 + ty + 16 * r;
    if (qpos >= a.S) continue;
    const long long row = ((static_cast<long long>(b) * a.S + qpos) * a.H + h)
                          * DQK;
#pragma unroll
    for (int c = 0; c < cols16<DQK>(); ++c)
      if (tx + 16 * c < DQK) dQ[row + tx + 16 * c] = dq[r][c];
  }
}

template <int DQK, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_f32_kernel(const Args a) {
  constexpr int LQ = DQK + 1, LV = DV + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kRows * LQ;
  float* Qs = Vs + kRows * LV;
  float* Gs = Qs + kRows * LQ;
  float* Ps = Gs + kRows * LV;
  float* Ws = Ps + kRows * kLdw;
  float* lsh = Ws + kRows * kLdw;
  float* Dsh = lsh + kRows;

  const int k0 = blockIdx.x * kRows, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Kv;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float* K = static_cast<const float*>(a.k) + b * a.ks_b + kvh * a.ks_h;
  const float* V = static_cast<const float*>(a.v) + b * a.vs_b + kvh * a.vs_h;
  load_f32<DQK>(Ks, K, a.ks_s, k0, a.T);
  load_f32<DV>(Vs, V, a.vs_s, k0, a.T);

  int qt_begin, qt_end;
  query_tiles(a, k0, &qt_begin, &qt_end);

  float dk[4][cols16<DQK>()], dv[4][cols16<DV>()];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int c = 0; c < cols16<DQK>(); ++c) dk[r][c] = 0.f;
#pragma unroll
    for (int c = 0; c < cols16<DV>(); ++c) dv[r][c] = 0.f;
  }

  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const float* Q = static_cast<const float*>(a.q) + b * a.qs_b + h * a.qs_h;
    const float* Gd = static_cast<const float*>(a.g) + b * a.gs_b +
                      h * a.gs_h;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kRows;
      __syncthreads();
      load_f32<DQK>(Qs, Q, a.qs_s, q0, a.S);
      load_f32<DV>(Gs, Gd, a.gs_s, q0, a.S);
      if (tid < kRows) {
        const int qpos = q0 + tid;
        const long long at = (static_cast<long long>(b) * a.H + h) * a.S +
                             qpos;
        lsh[tid] = qpos < a.S ? a.lse[at] : 0.f;
        Dsh[tid] = qpos < a.S ? a.dsum[at] : 0.f;
      }
      __syncthreads();
      // keys as rows (ty + 16 r), queries as columns (tx + 16 c)
      float s[4][4], dp[4][4];
      tile_dot<DQK>(Ks, Qs, ty, tx, s);
      tile_dot<DV>(Vs, Gs, ty, tx, dp);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kpos = k0 + ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tx + 16 * c;
          float f;
          const float x = score(a, s[r][c], &f);
          const float p = allowed(a, q0 + col, kpos)
                              ? expf(x - lsh[col]) : 0.f;
          Ps[(ty + 16 * r) * kLdw + col] = p;
          Ws[(ty + 16 * r) * kLdw + col] =
              p * (dp[r][c] - Dsh[col]) * f * a.scale;
        }
      }
      __syncthreads();
      tile_acc<DV>(Ps, Gs, ty, tx, dv);
      tile_acc<DQK>(Ws, Qs, ty, tx, dk);
    }
  }

  float* dK = static_cast<float*>(a.dk);
  float* dV = static_cast<float*>(a.dv);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kpos = k0 + ty + 16 * r;
    if (kpos >= a.T) continue;
    const long long row = (static_cast<long long>(b) * a.T + kpos) * a.Kv +
                          kvh;
#pragma unroll
    for (int c = 0; c < cols16<DQK>(); ++c)
      if (tx + 16 * c < DQK) dK[row * DQK + tx + 16 * c] = dk[r][c];
#pragma unroll
    for (int c = 0; c < cols16<DV>(); ++c)
      if (tx + 16 * c < DV) dV[row * DV + tx + 16 * c] = dv[r][c];
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, int smem,
           cudaStream_t stream, const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV>
int run_bf16(const Args& a, cudaStream_t st) {
  using C = Bwd<DQK, DV>;
  const int tiles = (a.S + kRows - 1) / kRows;     // query tiles
  const int ktiles = (a.T + kRows - 1) / kRows;    // key tiles
  int err = launch(flash_bwd_dq_kernel<DQK, DV>, dim3(tiles * a.B * a.H),
                   128, C::kDqSmem, st, a);
  if (err != 0) return err;
  const int pairs = (a.H / a.Kv) * tiles;      // most (head, tile) pairs
  const int groups = pairs < kGroups ? pairs : kGroups;
  const int smem = C::dkdv_smem(groups);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<DQK, DV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ktiles * a.B * a.Kv);
  cfg.blockDim = dim3(128 * groups);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, flash_bwd_dkdv_kernel<DQK, DV>, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int DQK, int DV>
int run_f32(const Args& a, cudaStream_t st) {
  const int tiles = (a.S + kRows - 1) / kRows;     // query tiles
  const int ktiles = (a.T + kRows - 1) / kRows;    // key tiles
  int err = launch(flash_bwd_dq_f32_kernel<DQK, DV>, dim3(tiles, a.H, a.B),
                   kThreads, dq_f32_smem<DQK, DV>(), st, a);
  if (err != 0) return err;
  return launch(flash_bwd_dkdv_f32_kernel<DQK, DV>, dim3(ktiles, a.Kv, a.B),
                kThreads, dkdv_f32_smem<DQK, DV>(), st, a);
}

}  // namespace

// q [B, S, H, dh], k [B, T, Kv, dh], v [B, T, Kv, dv] and o, do
// [B, S, H, dv], all bf16 (is_bf16 = 1) or all f32, the head dim
// contiguous, rows 16-byte aligned; T != S only with causal = 0 and
// window = 0; strides (in elements) in the order q (b, s, h), k, v, o,
// do.  lse [B, H, S] f32 is the forward's log-sum-exp.  dq [B, S, H, dh],
// dk [B, T, Kv, dh] and dv [B, T, Kv, dv]
// are contiguous in the same dtype; dsum is [B, H, S] f32 scratch.
// (dh, dv) is (64, 64), (128, 128), (192, 128), (120, 120) or (96, 96); the
// scale is dh^-0.5 of the true width; H % Kv == 0.  Returns -1 for a
// shape the kernels do not take, else cudaGetLastError() after the
// launches (0 = both launched).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* dsum, const long long* strides, int B, int S, int T, int H, int Kv,
    int dh, int dv_width, int is_bf16, int causal, int window, float softcap,
    void* stream) {
  const int pair = dh == 64 && dv_width == 64     ? 0
                   : dh == 128 && dv_width == 128 ? 1
                   : dh == 192 && dv_width == 128 ? 2
                   : dh == 120 && dv_width == 120 ? 3
                   : dh == 96 && dv_width == 96   ? 4
                                                  : -1;
  if (B < 1 || S < 1 || T < 1 || Kv < 1 || H % Kv != 0 || pair < 0 ||
      window < 0 || H > 65535 || B > 65535 || (T != S && (causal || window)))
    return -1;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.g = dout;
  a.lse = static_cast<const float*>(lse);
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.dsum = static_cast<float*>(dsum);
  a.qs_b = strides[0]; a.qs_s = strides[1]; a.qs_h = strides[2];
  a.ks_b = strides[3]; a.ks_s = strides[4]; a.ks_h = strides[5];
  a.vs_b = strides[6]; a.vs_s = strides[7]; a.vs_h = strides[8];
  a.os_b = strides[9]; a.os_s = strides[10]; a.os_h = strides[11];
  a.gs_b = strides[12]; a.gs_s = strides[13]; a.gs_h = strides[14];
  a.B = B; a.S = S; a.T = T; a.H = H; a.Kv = Kv; a.causal = causal;
  a.window = window;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  a.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return pair == 0   ? run_bf16<64, 64>(a, st)
           : pair == 1 ? run_bf16<128, 128>(a, st)
           : pair == 2 ? run_bf16<192, 128>(a, st)
           : pair == 3 ? run_bf16<120, 120>(a, st)
                       : run_bf16<96, 96>(a, st);
  return pair == 0   ? run_f32<64, 64>(a, st)
         : pair == 1 ? run_f32<128, 128>(a, st)
         : pair == 2 ? run_f32<192, 128>(a, st)
         : pair == 3 ? run_f32<120, 120>(a, st)
                     : run_f32<96, 96>(a, st);
}
