// Blocked (flash) attention with an online softmax, for Hopper.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention_pallas
// (kernel body _kernel), and with it the prefill attention of the model
// path, repro.models.attention.blocked_attention, which is that kernel's
// jnp oracle.
//
// What it computes, per (batch b, query head h):
//   o = softmax(mask(softcap(q . k^T * dqk^-0.5))) . v
// with q [B, S, H, dqk], k [B, T, Kv, dqk] and v [B, T, Kv, dv] read through
// their strides, o [B, S, H, dv]; T, the keys, may differ from S only
// without the causal mask and the window (whisper's cross-attention: 448 or
// 1 decoder queries against 1500 encoder keys); (dqk, dv) is (64, 64), (128, 128), (192, 128),
// DeepSeek MLA's prefill (a q / k head of qk_nope + qk_rope = 128 + 64, a v
// head of 128), (120, 120), h2o-danube-3's head, or (96, 96), phi-3's
// (the last dimension contiguous); query head h reads kv head h / (H / Kv),
// so K and V are never repeated in memory.  Arithmetic kept from the TPU
// kernel: scores in f32 from the input dtype, masked entries set to
// NEG = -1e30 (causal kpos <= qpos, window qpos - kpos < window, and always
// kpos < T: the TPU kernel leaves zero-padded keys unmasked when S is not a
// multiple of its tile, the port masks them as the oracles do), the running
// (m, l, acc) state in f32, p rounded to v's dtype before the PV product,
// and the output acc / max(l, 1e-30) in q's dtype.  When asked (a non-null
// lse), it also writes each row's log-sum-exp, lse = log(sum_kept exp(s)),
// f32 [B, H, S], in the natural log of the scaled, softcapped score: the
// gradient kernel (csrc/flash_attention_bwd.cu) forms p = exp(s - lse) from
// it.  Without lse nothing of the forward changes.
//
// Design.  The TPU walks an (H, Sq/Bq, Sk/Bk) grid in order and carries
// (m, l, acc) in VMEM scratch across the key axis.  Here one block owns one
// (b, h, query tile) and loops over key tiles, so the key loop that the
// TPU grid ran in sequence is a loop inside the block and the state stays
// in registers.  Key tiles that lie wholly above the causal diagonal or
// wholly before the window are skipped: a tile masked for every row adds
// exp(NEG - m) = 0, and tiles masked for some rows before their first
// valid key are cleared by alpha = exp(NEG - m) = 0 once it arrives, so
// skipping is exact.
//   bf16 (flash_wgmma_kernel): 128-query x 128-key tiles, the Pallas
//     kernel's own tile.  Three warpgroups, specialised:
//     - a producer warp issues TMA loads (one 4-D tensor map per operand,
//       dims (dh, S or T, heads, B), 128-byte swizzle, rows past each
//       operand's own length zero-filled)
//       of the Q tile once, then of each K and V tile into a ring of
//       stages guarded by full / empty mbarriers (K and V have separate
//       full barriers, so Q . K^T starts before V lands);
//     - two consumer warpgroups own 64 query rows each.  S = Q . K^T is
//       one wgmma m64n128k16 per 16 of dh with both operands read from
//       shared memory through swizzled descriptors; p is rounded to bf16
//       in registers and becomes the A operand of O += P . V (wgmma
//       m64n64k16, A from registers), with V read in its stored
//       [keys, dh] layout through the instruction's transpose of B: no
//       transpose pass, no ldmatrix, no scalar fragment loads.
//     Within a warpgroup, Q . K^T of key tile j is issued ahead of
//     P . V of tile j-1, so its softmax overlaps that product (and the
//     other warpgroup's products).  The softmax runs in base 2 (one FFMA
//     and one ex2.approx per score) and applies the full mask only to
//     tiles that need it: the diagonal tile, the ragged last tile and
//     window-edge tiles.  wgmma descriptors are built once and stepped
//     by constants.  Blocks are
//     persistent, one per SM, and take the (b, h, query tile) tiles
//     heaviest first, dealt back and forth across the blocks, so the
//     causal triangle's long tiles start first and every block gets about
//     the same work; the next tile's loads run under the current one's
//     last product and output stores.
//   A head width that is not a multiple of 64 (120, 96) runs on the tiles
//     of the next one (128): the tensor maps carry the true width, so TMA
//     fills the last panel's columns past it with zeros, as it fills rows
//     past S; Q . K^T and P . V are exact with zero columns, and the
//     epilogue stores only the columns below dv.  q, k and v are read
//     where they lie: no padded copy, no extra HBM traffic.
//   f32 (flash_f32_kernel): 256 threads, four per query row, 64-query x
//     64-key tiles; scores and P . V in fp32 FMA from shared memory (no
//     TF32).  It serves the f32 parity and replay runs.
//
// What bounds it on this card: operations.  At the captioner's prefill
// (B = 8, S = 1024, H = 12, Kv = 4, dh = 64, bf16, causal) the unmasked
// work is about 12.9 GFLOP, 13 us at the 989 TFLOP/s bf16 tensor-core
// peak, against 33.6 MB of q, k, v and o, 10 us at 3.35 TB/s.  At dh = 64
// a 128 x 128 tile costs as many exponentials (on the 16-per-clock MUFU
// pipe) as tensor-core clocks, so the two consumer warpgroups overlap one
// group's softmax with the other's matrix products.  At DeepSeek-V3's
// MLA prefill (B = 4, S = 1024, H = Kv = 128, (192, 128), bf16, causal)
// it is bytes: 671 MB of q, k, v and o, 0.200 ms at 3.35 TB/s, against
// 172 GFLOP, 0.174 ms.  There k's 64 rope columns are one head broadcast
// to all 128 (materialised by the caller and read 128 times), and Q . K^T
// takes 12 k-steps of 16 where P . V keeps dh = 128's 64 x 128 f32
// accumulator per warpgroup.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ------------------------------------------------------- bf16 (wgmma)
constexpr int kTile = 128;             // query rows and keys per tile
constexpr int kPanel = 64;             // bf16 columns per 128-byte swizzle row
constexpr int kPanelBytes = kTile * kPanel * 2;     // one [128, 64] panel
// two consumer warpgroups of 64 query rows and a producer warpgroup;
// setmaxnreg gives the consumers 232 registers and the producer 40 (all of
// the SM's 65,536)
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// Per (dqk, dv) pair: panels per Q / K row and per V row (a width that is
// not a multiple of 64 rounds up to whole panels), Q buffers, and ring
// stages (at dh = 64 three beside two Q tiles timed a little faster
// than four on an H100; dh = 128 has room for two).  At (192, 128) two Q
// buffers and two stages would take 2 x 48 + 2 x (48 + 32) = 256 KB, past
// the 227 KB a block may use: one Q buffer and two stages take 208 KB.
// With one Q buffer the next tile's Q loads only once this tile's last
// Q . K^T is done.
template <int DQ, int DV>
struct Cfg {
  static constexpr int PQ = (DQ + kPanel - 1) / kPanel;
  static constexpr int PV = (DV + kPanel - 1) / kPanel;
  static constexpr int kQBufs = DQ == DV ? 2 : 1;
  static constexpr int kStages = DQ == 64 ? 3 : 2;
  static constexpr int kQkBytes = PQ * kPanelBytes;    // a Q or K tile
  static constexpr int kVBytes = PV * kPanelBytes;     // a V tile
  static constexpr int kSmemBytes =
      kQBufs * kQkBytes + kStages * (kQkBytes + kVBytes) + 1024;
};

struct Tile {                          // what the consumers need besides TMA
  __nv_bfloat16* o;
  long long os_b, os_s, os_h;          // element strides of o
  int B, S, T, H, Kv, causal, window;  // S queries, T keys
  float scale;                         // dqk^-0.5
  float softcap;                       // 0 = off
  float* lse;                          // [B, H, S] or null
};

// heaviest query tile first: linear tile i -> (query tile, b, h)
__device__ __forceinline__ void block_tile(int i, int n_q, int BH, int H,
                                           int* qt, int* b, int* h) {
  *qt = n_q - 1 - i / BH;
  const int bh = i % BH;
  *b = bh / H;
  *h = bh % H;
}

// the key-tile range [begin, end) of T keys that the query tile starting at
// q0 needs
__device__ __forceinline__ void key_range(int T, int causal, int window,
                                          int q0, int block_q, int block_k,
                                          int* begin, int* end) {
  int e = (T + block_k - 1) / block_k;
  if (causal) e = min(e, (q0 + block_q - 1) / block_k + 1);
  *end = e;
  *begin = window > 0 ? max(0, q0 - window + 1) / block_k : 0;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one [128 rows, 64 cols] box of a 4-D tensor map into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3) : "memory");
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

// d[64] += A (shared, K-major) . B (shared, K-major): m64n128k16
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
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

// Accumulator layout of wgmma m64nN (f32): warp w of the warpgroup owns
// rows 16w .. 16w + 15; with g = lane / 4, t = lane % 4, register
// 4j + e (e = 0, 1) holds row g, column 8j + 2t + e, and 4j + 2 + e row
// g + 8, the same column.  The A operand from registers (m64k16 bf16)
// follows mma.sync's m16n8k16 A layout per warp, so the score registers
// of key columns 16kk .. 16kk + 15 are P's A fragment kk.

// The products take descriptors built once (per tile for Q, per kernel for
// the K and V rings) and step them by compile-time byte offsets / 16 in
// the start-address field (smem addresses stay below 2^18 bytes, so the
// field never carries), instead of packing a descriptor per wgmma.

// S = Q K^T for one warpgroup: dq its 64 rows of the Q tile, dk a K tile;
// 16 of dh per wgmma, both operands K-major in swizzled shared memory
template <int D>
__device__ __forceinline__ void gemm_qk(float (&sc)[64], uint64_t dq,
                                        uint64_t dk) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;         // bytes into the panel row
    const uint32_t off = ((kk / 4) * kPanelBytes + col) / 16;
    wgmma_ss_n128(sc, dq + off, dk + off, kk > 0);
  }
}

// O += P V: V read as stored ([keys, dh], dh contiguous) through the
// transpose of B; 16 keys (2048 bytes of a panel) per wgmma
template <int P>
__device__ __forceinline__ void gemm_pv(float (&o)[P][32],
                                        const uint32_t (&pa)[8][4],
                                        uint64_t dv) {
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs_n64_tb(o[p], pa[kk], dv + (p * kPanelBytes + kk * 2048) / 16);
}

// Each product pins its operand registers (fence_regs) before its
// wgmma.fence, so no register write drifts into the asynchronous section:
// ptxas would serialise the wgmmas if one did.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint64_t dq,
                                         uint64_t dk) {
  fence_regs(sc);
  wgmma_fence();
  gemm_qk<D>(sc, dq, dk);
  wgmma_commit();
}

template <int P>
__device__ __forceinline__ void issue_pv(float (&o)[P][32],
                                         uint32_t (&pa)[8][4], uint64_t dv) {
#pragma unroll
  for (int p = 0; p < P; ++p) fence_regs(o[p]);
  fence_regs(pa);
  wgmma_fence();
  gemm_pv<P>(o, pa, dv);
  wgmma_commit();
}

// one arrival per consumer warp on an mbarrier
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(smem_u32(bar));
}

// One online-softmax step over a 64 x 128 score tile (rows qpos0 and
// qpos1 = qpos0 + 8 of this thread): softcap, the mask where the tile
// needs one, the running max (m0, m1) and this thread's partial row sums
// (l0, l1); the scores become p, and (al0, al1) rescale the output.
// The exponentials run in base 2 with log2(e) folded into one FFMA, and
// the maximum stays in score units: masked scores are the finite NEG, and
// a row with nothing unmasked yet gets p = 0 (the plain version's p = 1
// there is cleared by alpha = 0 at the row's first unmasked key, which
// every row below S has; the output is the same).
__device__ __forceinline__ void online_softmax(
    float (&sc)[64], float& m0, float& m1, float& l0, float& l1, float& al0,
    float& al1, const Tile& a, int k0, int rmin, int qpos0, int qpos1,
    int t) {
  constexpr int NJ = kTile / 8;        // 8-column chunks
  float c = a.scale * kLog2e;
  if (a.softcap > 0.f) {
    const float cin = a.scale / a.softcap, cout = a.softcap * kLog2e;
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) sc[j] = tanhf(sc[j] * cin) * cout;
    c = 1.f;
  }
  if (k0 + kTile > a.T || (a.causal && k0 + kTile - 1 > rmin) ||
      (a.window > 0 && rmin + 63 - k0 >= a.window)) {
    // key k0 + 2t + c of row qpos is kept when lo < c <= hi: c < T - k0 -
    // 2t, c <= qpos - k0 - 2t (causal), c > qpos - k0 - 2t - window
    const int base = k0 + 2 * t;
    int hi0 = a.T - 1 - base, hi1 = hi0, lo0 = -1, lo1 = -1;
    if (a.causal) {
      hi0 = min(hi0, qpos0 - base);
      hi1 = min(hi1, qpos1 - base);
    }
    if (a.window > 0) {
      lo0 = qpos0 - base - a.window;
      lo1 = qpos1 - base - a.window;
    }
    if (a.window > 0) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + (e & 1);
          const bool ok = e < 2 ? c > lo0 && c <= hi0 : c > lo1 && c <= hi1;
          if (!ok) sc[4 * j + e] = kNeg;
        }
    } else {                           // lo = -1: one test per score
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + (e & 1) > (e < 2 ? hi0 : hi1)) sc[4 * j + e] = kNeg;
    }
  }
  // two partial maxima and sums per row: shorter dependency chains
  float mx0 = m0, mx1 = m1, my0 = kNeg, my1 = kNeg;
#pragma unroll
  for (int j = 0; j < NJ; j += 2) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    my0 = fmaxf(my0, fmaxf(sc[4 * j + 4], sc[4 * j + 5]));
    my1 = fmaxf(my1, fmaxf(sc[4 * j + 6], sc[4 * j + 7]));
  }
  mx0 = fmaxf(mx0, my0);
  mx1 = fmaxf(mx1, my1);
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  al0 = ex2((m0 - mx0) * c);
  al1 = ex2((m1 - mx1) * c);
  m0 = mx0;
  m1 = mx1;
  const float mc0 = mx0 == kNeg ? 0.f : mx0 * c;
  const float mc1 = mx1 == kNeg ? 0.f : mx1 * c;
  float rs0 = 0.f, rs1 = 0.f, rt0 = 0.f, rt1 = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    sc[4 * j] = ex2(fmaf(sc[4 * j], c, -mc0));
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], c, -mc0));
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], c, -mc1));
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], c, -mc1));
    if (j % 2 == 0) {
      rs0 += sc[4 * j] + sc[4 * j + 1];
      rs1 += sc[4 * j + 2] + sc[4 * j + 3];
    } else {
      rt0 += sc[4 * j] + sc[4 * j + 1];
      rt1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
  }
  l0 = l0 * al0 + (rs0 + rt0);         // this thread's columns only
  l1 = l1 * al1 + (rs1 + rt1);
}

// p (f32, score layout) -> P's bf16 A fragments
__device__ __forceinline__ void pack_p(const float (&sc)[64],
                                       uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// the tile of round r of a persistent block: tiles are numbered heaviest
// first and dealt to the blocks back and forth (0 .. G-1, G-1 .. 0, ...),
// so each block's sum of tile lengths is close to the mean
__device__ __forceinline__ int snake_tile(int r) {
  const int G = gridDim.x;
  return r * G + ((r & 1) ? G - 1 - static_cast<int>(blockIdx.x)
                          : static_cast<int>(blockIdx.x));
}

// Persistent: one block per SM walks its tiles (snake_tile).  Shared
// memory (dynamic, 1024-byte aligned): kQBufs Q buffers of [PQ panels]
// [128][64], then kStages K tiles of that shape and kStages V tiles of
// [PV][128][64]; every panel is one TMA box with the 128-byte swizzle.
// The ring's stage and phase run on across tiles; each Q buffer has its
// own full / empty pair, released once its tile's last Q . K^T is done, so
// with two buffers the next tile's Q and first K / V tiles load while this
// tile still runs.
template <int DQ, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Tile a) {
  using C = Cfg<DQ, DV>;
  constexpr int PQ = C::PQ, P = C::PV, kStages = C::kStages;
  constexpr int kQBufs = C::kQBufs;
  constexpr int kQkBytes = C::kQkBytes, kVBytes = C::kVBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q[kQBufs], bar_q_empty[kQBufs],
      bar_k[kStages], bar_v[kStages], bar_empty[kStages];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t sk = base + kQBufs * kQkBytes;  // after the Q tiles
  const uint32_t sv = sk + kStages * kQkBytes;
  // the Q buffer of round r and the phase of its barriers
  auto q_buf = [](int r) { return kQBufs == 2 ? r & 1 : 0; };
  auto q_phase = [](int r) {
    return static_cast<uint32_t>((kQBufs == 2 ? r >> 1 : r) & 1);
  };
  const int n_q = (a.S + kTile - 1) / kTile;
  const int n_tiles = n_q * a.B * a.H;
  const int G = a.H / a.Kv;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kQBufs; ++i) {
      mbar_init(smem_u32(&bar_q[i]), 1);
      mbar_init(smem_u32(&bar_q_empty[i]), kConsumers * 4);  // one per warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&bar_k[s]), 1);
      mbar_init(smem_u32(&bar_v[s]), 1);
      mbar_init(smem_u32(&bar_empty[s]), kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     kProducerRegs) : "memory");
    if (threadIdx.x == kConsumers * 128) {
      uint32_t it = 0;                          // K / V tiles issued
      for (int r = 0;; ++r) {
        const int tile = snake_tile(r);
        if (tile >= n_tiles) break;
        int qt, b, h, kt_begin, kt_end;
        block_tile(tile, n_q, a.B * a.H, a.H, &qt, &b, &h);
        key_range(a.T, a.causal, a.window, qt * kTile, kTile, kTile,
                  &kt_begin, &kt_end);
        const int qb = q_buf(r);                // Q buffer of this tile
        mbar_wait(smem_u32(&bar_q_empty[qb]), q_phase(r) ^ 1);
        mbar_expect_tx(smem_u32(&bar_q[qb]), kQkBytes);
        for (int p = 0; p < PQ; ++p)
          tma_load(sq + qb * kQkBytes + p * kPanelBytes, &tq,
                   smem_u32(&bar_q[qb]), p * kPanel, qt * kTile, h, b);
        for (int kt = kt_begin; kt < kt_end; ++kt, ++it) {
          const int s = it % kStages;
          mbar_wait(smem_u32(&bar_empty[s]), ((it / kStages) & 1) ^ 1);
          const uint32_t dk = sk + s * kQkBytes, dv = sv + s * kVBytes;
          mbar_expect_tx(smem_u32(&bar_k[s]), kQkBytes);
          for (int p = 0; p < PQ; ++p)
            tma_load(dk + p * kPanelBytes, &tk, smem_u32(&bar_k[s]),
                     p * kPanel, kt * kTile, h / G, b);
          mbar_expect_tx(smem_u32(&bar_v[s]), kVBytes);
          for (int p = 0; p < P; ++p)
            tma_load(dv + p * kPanelBytes, &tv, smem_u32(&bar_v[s]),
                     p * kPanel, kt * kTile, h / G, b);
        }
      }
    }
  } else {
    // ----------------------------------------------------- consumers
    // Per tile, Q . K^T of key tile j is issued before P . V of tile j-1,
    // so the softmax of tile j runs while the tensor cores do that P . V;
    // a tile's last P . V goes out with the next tile's first Q . K^T,
    // and its output is stored while that tile's first softmax runs.  (No
    // wgmma sits under a branch that depends on data: ptxas serialises
    // wgmma on such paths.)  Rows past S are computed and not stored.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     kConsumerRegs) : "memory");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const uint64_t dk0 = sw128_desc(sk, 16, 1024);          // ring stage 0
    const uint64_t dv0 = sw128_desc(sv, kPanelBytes, 1024);
    constexpr uint64_t kStepK = kQkBytes / 16, kStepV = kVBytes / 16;
    constexpr int DQP = PQ * kPanel;            // Q . K^T over whole panels
    float m0, m1, l0, l1, al0, al1;
    float o[P][32];
    float sc[64];
    uint32_t pa[8][4];
    uint32_t it = 0;                            // K / V tiles consumed

    // the current tile: its Q rows, key tiles, output rows and lse entries
    // (null past S, and lse null when not asked for)
    int r = 0, kt_begin = 0, nk = 0, rmin = 0, qpos0 = 0, qpos1 = 0, qb = 0;
    uint64_t dq = 0;
    __nv_bfloat16* out0 = nullptr;
    __nv_bfloat16* out1 = nullptr;
    float* lse0 = nullptr;
    float* lse1 = nullptr;
    auto start_tile = [&](int tile) {
      int qt, b, h, kt_end;
      block_tile(tile, n_q, a.B * a.H, a.H, &qt, &b, &h);
      key_range(a.T, a.causal, a.window, qt * kTile, kTile, kTile,
                &kt_begin, &kt_end);
      nk = kt_end - kt_begin;
      rmin = qt * kTile + wg * 64;
      qpos0 = rmin + warp * 16 + g;
      qpos1 = qpos0 + 8;
      qb = q_buf(r);
      dq = sw128_desc(sq + qb * kQkBytes + wg * 64 * 128, 16, 1024);
      __nv_bfloat16* O = a.o + b * a.os_b + h * a.os_h + 2 * t;
      out0 = qpos0 < a.S ? O + static_cast<long long>(qpos0) * a.os_s
                         : nullptr;
      out1 = qpos1 < a.S ? O + static_cast<long long>(qpos1) * a.os_s
                         : nullptr;
      if (a.lse != nullptr) {
        float* L = a.lse + (static_cast<long long>(b) * a.H + h) * a.S;
        lse0 = qpos0 < a.S ? L + qpos0 : nullptr;
        lse1 = qpos1 < a.S ? L + qpos1 : nullptr;
      }
      mbar_wait(smem_u32(&bar_q[qb]), q_phase(r));
      m0 = m1 = kNeg;
      l0 = l1 = 0.f;
    };
    auto softmax = [&](int kt) {
      online_softmax(sc, m0, m1, l0, l1, al0, al1, a, kt * kTile, rmin,
                     qpos0, qpos1, t);
    };
    // o / (la, lb) of a finished tile into its rows (the columns below DV:
    // past them the accumulator holds the zero columns of a padded panel),
    // and where asked its rows' lse from the maxima (ma, mb) and sums: m is
    // in score units (times c in base 2), so lse = (m * c + log2(l)) * ln 2
    auto store = [&](float la, float lb, float ma, float mb,
                     __nv_bfloat16* r0, __nv_bfloat16* r1, float* e0,
                     float* e1) {
      la += __shfl_xor_sync(0xffffffffu, la, 1);
      la += __shfl_xor_sync(0xffffffffu, la, 2);
      lb += __shfl_xor_sync(0xffffffffu, lb, 1);
      lb += __shfl_xor_sync(0xffffffffu, lb, 2);
      const float c = a.softcap > 0.f ? 1.f : a.scale * kLog2e;
      if (e0 != nullptr && t == 0) *e0 = (ma * c + log2f(la)) * kLn2;
      if (e1 != nullptr && t == 0) *e1 = (mb * c + log2f(lb)) * kLn2;
      // acc / max(l, 1e-30) as acc times one reciprocal per row: the 32
      // IEEE divisions a thread made took a sixth of the kernel's time
      const float inv0 = 1.f / fmaxf(la, 1e-30f);
      const float inv1 = 1.f / fmaxf(lb, 1e-30f);
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int d = p * kPanel + 8 * i;
          if (d >= DV) continue;             // resolved at compile time
          if (r0 != nullptr)
            *reinterpret_cast<__nv_bfloat162*>(r0 + d) = __floats2bfloat162_rn(
                o[p][4 * i] * inv0, o[p][4 * i + 1] * inv0);
          if (r1 != nullptr)
            *reinterpret_cast<__nv_bfloat162*>(r1 + d) = __floats2bfloat162_rn(
                o[p][4 * i + 2] * inv1, o[p][4 * i + 3] * inv1);
        }
    };
    auto zero_o_pack = [&]() {
#pragma unroll
      for (int p = 0; p < P; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
      pack_p(sc, pa);
    };

    int tile = snake_tile(0);
    if (tile < n_tiles) {
      start_tile(tile);
      {                                         // the first Q . K^T alone
        const uint32_t s = it % kStages;
        mbar_wait(smem_u32(&bar_k[s]), (it / kStages) & 1);
        issue_qk<DQP>(sc, dq, dk0 + s * kStepK);
        wgmma_wait<0>();
        fence_regs(sc);
        if (nk == 1) release(&bar_q_empty[qb], lane);
        softmax(kt_begin);
        zero_o_pack();
      }
      for (;;) {
        for (int j = 1; j < nk; ++j) {
          const uint32_t cur = it + j, s = cur % kStages;
          const uint32_t prev = cur - 1, sp = prev % kStages;
          mbar_wait(smem_u32(&bar_k[s]), (cur / kStages) & 1);
          mbar_wait(smem_u32(&bar_v[sp]), (prev / kStages) & 1);
          issue_qk<DQP>(sc, dq, dk0 + s * kStepK);
          issue_pv<P>(o, pa, dv0 + sp * kStepV);
          wgmma_wait<1>();                      // Q . K^T done, P . V not
          fence_regs(sc);
          if (j == nk - 1) release(&bar_q_empty[qb], lane);
          softmax(kt_begin + j);
          wgmma_wait<0>();
#pragma unroll
          for (int p = 0; p < P; ++p) fence_regs(o[p]);
          fence_regs(pa);
          release(&bar_empty[sp], lane);
#pragma unroll
          for (int p = 0; p < P; ++p)
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              o[p][4 * i] *= al0;
              o[p][4 * i + 1] *= al0;
              o[p][4 * i + 2] *= al1;
              o[p][4 * i + 3] *= al1;
            }
          pack_p(sc, pa);
        }
        // this tile's last P . V is still to go out
        const uint32_t last = it + nk - 1, sl = last % kStages;
        it += nk;
        tile = snake_tile(++r);
        if (tile >= n_tiles) {                  // it goes out alone
          mbar_wait(smem_u32(&bar_v[sl]), (last / kStages) & 1);
          issue_pv<P>(o, pa, dv0 + sl * kStepV);
          wgmma_wait<0>();
#pragma unroll
          for (int p = 0; p < P; ++p) fence_regs(o[p]);
          fence_regs(pa);
          release(&bar_empty[sl], lane);
          store(l0, l1, m0, m1, out0, out1, lse0, lse1);
          break;
        }
        const float lp0 = l0, lp1 = l1;         // the finished tile's
        const float mp0 = m0, mp1 = m1;
        __nv_bfloat16* const p0 = out0;
        __nv_bfloat16* const p1 = out1;
        float* const e0 = lse0;
        float* const e1 = lse1;
        start_tile(tile);
        const uint32_t s = it % kStages;
        mbar_wait(smem_u32(&bar_k[s]), (it / kStages) & 1);
        mbar_wait(smem_u32(&bar_v[sl]), (last / kStages) & 1);
        issue_qk<DQP>(sc, dq, dk0 + s * kStepK);
        issue_pv<P>(o, pa, dv0 + sl * kStepV);
        wgmma_wait<1>();
        fence_regs(sc);
        if (nk == 1) release(&bar_q_empty[qb], lane);
        softmax(kt_begin);
        wgmma_wait<0>();
#pragma unroll
        for (int p = 0; p < P; ++p) fence_regs(o[p]);
        fence_regs(pa);
        release(&bar_empty[sl], lane);
        store(lp0, lp1, mp0, mp1, p0, p1, e0, e1);
        zero_o_pack();
      }
    }
  }
}

// ----------------------------------------------------------------- f32
constexpr int kBlockQ = 64;            // f32 query and key tiles
constexpr int kBlockK = 64;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs_b, qs_s, qs_h;   // element strides; the head dim is contiguous
  long long ks_b, ks_s, ks_h;
  long long vs_b, vs_s, vs_h;
  long long os_b, os_s, os_h;
  int S, T, H, Kv, causal, window;     // S queries, T keys
  float scale, softcap;
  float* lse;                          // [B, H, S] or null
};

// scale, softcap and mask of one score
__device__ __forceinline__ float score(const Args& a, float dot, int qpos,
                                       int kpos) {
  float x = dot * a.scale;
  if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
  bool ok = kpos < a.T;
  if (a.causal) ok = ok && kpos <= qpos;
  if (a.window > 0) ok = ok && qpos - kpos < a.window;
  return ok ? x : kNeg;
}

constexpr int kF32Threads = 256;       // four threads per query row

// Qs, Ks [64][DQ+1]; Vs [64][DV]; Ps [64][65] (148 KB at (192, 128))
template <int DQ, int DV>
constexpr int f32_smem_bytes() {
  return (2 * kBlockQ * (DQ + 1) + kBlockK * DV + kBlockQ * (kBlockK + 1)) *
         static_cast<int>(sizeof(float));
}

template <int DQ, int DV>
__global__ void __launch_bounds__(kF32Threads)
    flash_f32_kernel(const Args a) {
  constexpr int LD = DQ + 1;
  constexpr int LDP = kBlockK + 1;
  constexpr int C4 = DQ / 4;           // float4 chunks per Q / K row
  constexpr int C4V = DV / 4;          // and per V row
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * LD;
  float* Vs = Ks + kBlockK * LD;
  float* Ps = Vs + kBlockK * DV;

  const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.Kv);
  const int tid = threadIdx.x, r = tid >> 2, c = tid & 3;
  const float* Q = static_cast<const float*>(a.q) + b * a.qs_b + h * a.qs_h;
  const float* K = static_cast<const float*>(a.k) + b * a.ks_b + kvh * a.ks_h;
  const float* V = static_cast<const float*>(a.v) + b * a.vs_b + kvh * a.vs_h;
  float* O = static_cast<float*>(a.o) + b * a.os_b + h * a.os_h;

  for (int i = tid; i < kBlockQ * C4; i += kF32Threads) {
    const int row = i / C4, c4 = i % C4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + row < a.S)
      x = *reinterpret_cast<const float4*>(Q + (q0 + row) * a.qs_s + c4 * 4);
    float* dst = &Qs[row * LD + c4 * 4];
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  }

  const int qpos = q0 + r;
  float m = kNeg, l = 0.f;
  float acc[DV / 4];                   // output dims c, c + 4, c + 8, ...
#pragma unroll
  for (int i = 0; i < DV / 4; ++i) acc[i] = 0.f;

  int kt_begin, kt_end;
  key_range(a.T, a.causal, a.window, q0, kBlockQ, kBlockK, &kt_begin,
            &kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    for (int i = tid; i < kBlockK * C4; i += kF32Threads) {
      const int row = i / C4, c4 = i % C4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + row < a.T)
        kx = *reinterpret_cast<const float4*>(K + (k0 + row) * a.ks_s + c4 * 4);
      float* dst = &Ks[row * LD + c4 * 4];
      dst[0] = kx.x; dst[1] = kx.y; dst[2] = kx.z; dst[3] = kx.w;
    }
    for (int i = tid; i < kBlockK * C4V; i += kF32Threads) {
      const int row = i / C4V, c4 = i % C4V;
      float4 vx = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + row < a.T)
        vx = *reinterpret_cast<const float4*>(V + (k0 + row) * a.vs_s + c4 * 4);
      *reinterpret_cast<float4*>(&Vs[row * DV + c4 * 4]) = vx;
    }
    __syncthreads();

    // this thread's keys: c, c + 4, ..., c + 60
    float s[kBlockK / 4];
#pragma unroll
    for (int j = 0; j < kBlockK / 4; ++j) s[j] = 0.f;
    for (int d = 0; d < DQ; ++d) {
      const float qd = Qs[r * LD + d];
#pragma unroll
      for (int j = 0; j < kBlockK / 4; ++j)
        s[j] = fmaf(qd, Ks[(c + 4 * j) * LD + d], s[j]);
    }
    float mx = m;
#pragma unroll
    for (int j = 0; j < kBlockK / 4; ++j) {
      s[j] = score(a, s[j], qpos, k0 + c + 4 * j);
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = expf(m - mx);
    m = mx;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK / 4; ++j) {
      s[j] = expf(s[j] - mx);
      rs += s[j];
      Ps[r * LDP + c + 4 * j] = s[j];
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    l = l * alpha + rs;
    __syncwarp();                      // row r's P is written by its own warp
#pragma unroll
    for (int i = 0; i < DV / 4; ++i) acc[i] *= alpha;
    for (int j = 0; j < kBlockK; ++j) {
      const float pj = Ps[r * LDP + j];
#pragma unroll
      for (int i = 0; i < DV / 4; ++i)
        acc[i] = fmaf(pj, Vs[j * DV + c + 4 * i], acc[i]);
    }
  }

  if (qpos < a.S) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DV / 4; ++i) O[qpos * a.os_s + c + 4 * i] = acc[i] / den;
    if (a.lse != nullptr && c == 0)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.S + qpos] = m + logf(l);
  }
}

template <typename Kernel, typename... A>
int launch(Kernel kernel, dim3 grid, int threads, int smem,
           cudaStream_t stream, const A&... args) {
  if (smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library links no libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// L = dims (dh, S, heads, B), byte strides of S, heads, B, box (4 values),
// as flash_attention.tma_layout computes them; the box is one panel of
// kTile rows.  0, -1 for a box the
// kernel does not take, -3 when the encoder is missing, else -2.
int encode(CUtensorMap* map, const void* ptr, const long long* L) {
  if (L[7] != kPanel || L[8] != kTile || L[9] != 1 || L[10] != 1) return -1;
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -3;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(L[0]),
                              static_cast<cuuint64_t>(L[1]),
                              static_cast<cuuint64_t>(L[2]),
                              static_cast<cuuint64_t>(L[3])};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(L[4]),
                                 static_cast<cuuint64_t>(L[5]),
                                 static_cast<cuuint64_t>(L[6])};
  const cuuint32_t box[4] = {kPanel, kTile, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -2;
}

template <int DQ, int DV>
int launch_wgmma(int B, int S, int H, const long long* tma, const void* q,
                 const void* k, const void* v, const Tile& t,
                 cudaStream_t st) {
  alignas(64) CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, tma);
  if (err == 0) err = encode(&tk, k, tma + 11);
  if (err == 0) err = encode(&tv, v, tma + 22);
  if (err != 0) return err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = ((S + kTile - 1) / kTile) * B * H;
  const dim3 grid(tiles < sms ? tiles : sms);      // persistent blocks
  return launch(flash_wgmma_kernel<DQ, DV>, grid, kThreads,
                Cfg<DQ, DV>::kSmemBytes, st, tq, tk, tv, t);
}

}  // namespace

// q [B, S, H, dh], k [B, T, Kv, dh], v [B, T, Kv, dv], o [B, S, H, dv],
// all bf16 (is_bf16 = 1) or all f32, the head dim contiguous; T != S only
// with causal = 0 and window = 0; strides (in
// elements) in the order q (b, s, h), k, v, o.  lse is null or f32
// [B, H, S], contiguous: each row's log-sum-exp.  For bf16, tma holds q's,
// k's and v's tensor-map layouts (11 values each, see encode).  (dh, dv)
// is (64, 64), (128, 128), (192, 128), (120, 120) or (96, 96); H % Kv ==
// 0.  Returns -1 for a shape the kernel does not take, -2 / -3 when a
// tensor map cannot be encoded, else cudaGetLastError() after the launch
// (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      const long long* strides,
                                      const long long* tma, int B, int S,
                                      int T, int H, int Kv, int dh, int dv,
                                      int is_bf16, int causal, int window,
                                      float softcap, void* stream) {
  const int pair = dh == 64 && dv == 64     ? 0
                   : dh == 128 && dv == 128 ? 1
                   : dh == 192 && dv == 128 ? 2
                   : dh == 120 && dv == 120 ? 3
                   : dh == 96 && dv == 96   ? 4
                                            : -1;
  if (B < 1 || S < 1 || T < 1 || Kv < 1 || H % Kv != 0 || pair < 0 ||
      (T != S && (causal || window)))
    return -1;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    Tile t;
    t.o = static_cast<__nv_bfloat16*>(o);
    t.os_b = strides[9]; t.os_s = strides[10]; t.os_h = strides[11];
    t.B = B; t.S = S; t.T = T; t.H = H; t.Kv = Kv; t.causal = causal;
    t.window = window; t.scale = scale; t.softcap = softcap;
    t.lse = static_cast<float*>(lse);
    return pair == 0   ? launch_wgmma<64, 64>(B, S, H, tma, q, k, v, t, st)
           : pair == 1 ? launch_wgmma<128, 128>(B, S, H, tma, q, k, v, t, st)
           : pair == 2 ? launch_wgmma<192, 128>(B, S, H, tma, q, k, v, t, st)
           : pair == 3 ? launch_wgmma<120, 120>(B, S, H, tma, q, k, v, t, st)
                       : launch_wgmma<96, 96>(B, S, H, tma, q, k, v, t, st);
  }
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.qs_b = strides[0]; a.qs_s = strides[1]; a.qs_h = strides[2];
  a.ks_b = strides[3]; a.ks_s = strides[4]; a.ks_h = strides[5];
  a.vs_b = strides[6]; a.vs_s = strides[7]; a.vs_h = strides[8];
  a.os_b = strides[9]; a.os_s = strides[10]; a.os_h = strides[11];
  a.S = S; a.T = T; a.H = H; a.Kv = Kv; a.causal = causal;
  a.window = window;
  a.scale = scale;
  a.softcap = softcap;
  a.lse = static_cast<float*>(lse);
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  return pair == 0   ? launch(flash_f32_kernel<64, 64>, grid, kF32Threads,
                              f32_smem_bytes<64, 64>(), st, a)
         : pair == 1 ? launch(flash_f32_kernel<128, 128>, grid, kF32Threads,
                              f32_smem_bytes<128, 128>(), st, a)
         : pair == 2 ? launch(flash_f32_kernel<192, 128>, grid, kF32Threads,
                              f32_smem_bytes<192, 128>(), st, a)
         : pair == 3 ? launch(flash_f32_kernel<120, 120>, grid, kF32Threads,
                              f32_smem_bytes<120, 120>(), st, a)
                     : launch(flash_f32_kernel<96, 96>, grid, kF32Threads,
                              f32_smem_bytes<96, 96>(), st, a);
}
