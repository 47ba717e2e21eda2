// Blocked (flash) attention with an online softmax, for Hopper.
//
// Replaces: src/repro/kernels/flash_attention.py :: flash_attention_pallas
// (kernel body _kernel), and with it the prefill attention of the model
// path, repro.models.attention.blocked_attention, which is that kernel's
// jnp oracle.
//
// What it computes, per (batch b, query head h):
//   o = softmax(mask(softcap(q . k^T * dh^-0.5))) . v
// with q [B, S, H, dh] and k, v [B, S, Kv, dh] read through their strides
// (the last dimension contiguous); query head h reads kv head h / (H / Kv),
// so K and V are never repeated in memory.  Arithmetic kept from the TPU
// kernel: scores in f32 from the input dtype, masked entries set to
// NEG = -1e30 (causal kpos <= qpos, window qpos - kpos < window, and always
// kpos < S: the TPU kernel leaves zero-padded keys unmasked when S is not a
// multiple of its tile, the port masks them as the oracles do), the running
// (m, l, acc) state in f32, p rounded to v's dtype before the PV product,
// and the output acc / max(l, 1e-30) in q's dtype.
//
// Design.  The TPU walks an (H, Sq/Bq, Sk/Bk) grid in order and carries
// (m, l, acc) in VMEM scratch across the key axis.  Here one block owns one
// (b, h, 64-query tile) and loops over 64-key tiles staged in shared
// memory, so the key loop that the TPU grid ran in sequence is a loop
// inside the block and the state stays in registers.  Key tiles that lie
// wholly above the causal diagonal or wholly before the window are
// skipped: a tile masked for every row adds exp(NEG - m) = 0, and tiles
// masked for some rows before their first valid key are cleared by
// alpha = exp(NEG - m) = 0 once it arrives, so skipping is exact.
//   bf16: four warps, 16 query rows each; Q . K^T and P . V on the tensor
//     cores with mma.sync m16n8k16 (bf16 in, f32 accumulate).  Q's A
//     fragments stay in registers; the score fragments become P's A
//     fragments without a trip through shared memory.  V is stored
//     transposed in shared memory so that each B fragment is one 32-bit
//     load.
//   f32: 256 threads, four per query row; scores and P . V in fp32 FMA
//     from shared memory (no TF32).
//
// What bounds it on this card: operations.  At the captioner's prefill
// (B = 8, S = 1024, H = 12, Kv = 4, dh = 64, bf16, causal) the unmasked
// work is about 12.9 GFLOP, 13 us at the 989 TFLOP/s bf16 tensor-core
// peak, against 33.6 MB of q, k, v and o, 10 us at 3.35 TB/s.  mma.sync
// reaches a fraction of the wgmma peak; wgmma, TMA and warp
// specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr float kNeg = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qs_b, qs_s, qs_h;   // element strides; the head dim is contiguous
  long long ks_b, ks_s, ks_h;
  long long vs_b, vs_s, vs_h;
  long long os_b, os_s, os_h;
  int S, H, Kv, causal, window;
  float scale, softcap;
};

// the key-tile range [begin, end) that a query tile starting at q0 needs
__device__ __forceinline__ void tile_range(const Args& a, int q0, int* begin,
                                           int* end) {
  int e = (a.S + kBlockK - 1) / kBlockK;
  if (a.causal) e = min(e, (q0 + kBlockQ - 1) / kBlockK + 1);
  *end = e;
  *begin = a.window > 0 ? max(0, q0 - a.window + 1) / kBlockK : 0;
}

// scale, softcap and mask of one score
__device__ __forceinline__ float score(const Args& a, float dot, int qpos,
                                       int kpos) {
  float x = dot * a.scale;
  if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
  bool ok = kpos < a.S;
  if (a.causal) ok = ok && kpos <= qpos;
  if (a.window > 0) ok = ok && qpos - kpos < a.window;
  return ok ? x : kNeg;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one 32-bit register of bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---------------------------------------------------------------- bf16
// Fragment layout of mma.m16n8k16 (g = lane / 4, t = lane % 4):
//   A 16x16: {a0 a1} row g, cols 2t..2t+1; {a2 a3} row g+8, same cols;
//            {a4 a5} row g, cols 2t+8..; {a6 a7} row g+8, cols 2t+8..
//   B 16x8:  {b0 b1} k 2t..2t+1, col g;   {b2 b3} k 2t+8.., col g
//   C 16x8:  c0 c1 row g, cols 2t..2t+1;  c2 c3 row g+8, same cols
template <int D>
__global__ void __launch_bounds__(128)
    flash_bf16_kernel(const Args a) {
  constexpr int LDK = D + 8;           // row pitch of Ks (bank-conflict free)
  constexpr int LDV = kBlockK + 8;     // row pitch of Vt
  constexpr int CH = D / 8;            // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 Ks[kBlockK * LDK];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * LDV];

  const int q0 = blockIdx.x * kBlockQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.Kv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* Q =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.qs_b + h * a.qs_h;
  const __nv_bfloat16* K =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.ks_b + kvh * a.ks_h;
  const __nv_bfloat16* V =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.vs_b + kvh * a.vs_h;
  __nv_bfloat16* O =
      static_cast<__nv_bfloat16*>(a.o) + b * a.os_b + h * a.os_h;

  // stage the Q tile in Ks (zeros past S), then keep its A fragments
  for (int i = tid; i < kBlockQ * CH; i += 128) {
    const int r = i / CH, c = i % CH;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (q0 + r < a.S)
      x = *reinterpret_cast<const uint4*>(Q + (q0 + r) * a.qs_s + c * 8);
    *reinterpret_cast<uint4*>(&Ks[r * LDK + c * 8]) = x;
  }
  __syncthreads();
  uint32_t qf[D / 16][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    qf[kk][0] = ld32(&Ks[r0 * LDK + kk * 16 + 2 * t]);
    qf[kk][1] = ld32(&Ks[(r0 + 8) * LDK + kk * 16 + 2 * t]);
    qf[kk][2] = ld32(&Ks[r0 * LDK + kk * 16 + 8 + 2 * t]);
    qf[kk][3] = ld32(&Ks[(r0 + 8) * LDK + kk * 16 + 8 + 2 * t]);
  }

  const int qpos0 = q0 + r0, qpos1 = qpos0 + 8;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  int kt_begin, kt_end;
  tile_range(a, q0, &kt_begin, &kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();                   // every warp is done with the last tile
    for (int i = tid; i < kBlockK * CH; i += 128) {
      const int r = i / CH, c = i % CH;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (k0 + r < a.S)
        x = *reinterpret_cast<const uint4*>(K + (k0 + r) * a.ks_s + c * 8);
      *reinterpret_cast<uint4*>(&Ks[r * LDK + c * 8]) = x;
    }
    // V key-fastest, so a warp's transposed stores hit distinct banks
    for (int i = tid; i < kBlockK * CH; i += 128) {
      const int r = i % kBlockK, c = i / kBlockK;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (k0 + r < a.S)
        x = *reinterpret_cast<const uint4*>(V + (k0 + r) * a.vs_s + c * 8);
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
      for (int e = 0; e < 8; ++e) Vt[(c * 8 + e) * LDV + r] = ve[e];
    }
    __syncthreads();

    // S = Q K^T: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* kr = &Ks[(j * 8 + g) * LDK + kk * 16 + 2 * t];
        mma_bf16(s[j], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kp = k0 + j * 8 + 2 * t;
      s[j][0] = score(a, s[j][0], qpos0, kp);
      s[j][1] = score(a, s[j][1], qpos0, kp + 1);
      s[j][2] = score(a, s[j][2], qpos1, kp);
      s[j][3] = score(a, s[j][3], qpos1, kp + 1);
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float al0 = expf(m0 - mx0), al1 = expf(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - mx0);
      s[j][1] = expf(s[j][1] - mx0);
      s[j][2] = expf(s[j][2] - mx1);
      s[j][3] = expf(s[j][3] - mx1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
    rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
    rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
    l0 = l0 * al0 + rs0;
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= al0;
      acc[dn][1] *= al0;
      acc[dn][2] *= al1;
      acc[dn][3] *= al1;
    }

    // O += P V: the score C fragments of key tiles 2kk, 2kk+1 are P's A
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const __nv_bfloat16* vr = &Vt[(dn * 8 + g) * LDV + kk * 16 + 2 * t];
        mma_bf16(acc[dn], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int d = dn * 8 + 2 * t;
    if (qpos0 < a.S)
      *reinterpret_cast<__nv_bfloat162*>(O + qpos0 * a.os_s + d) =
          __floats2bfloat162_rn(acc[dn][0] / den0, acc[dn][1] / den0);
    if (qpos1 < a.S)
      *reinterpret_cast<__nv_bfloat162*>(O + qpos1 * a.os_s + d) =
          __floats2bfloat162_rn(acc[dn][2] / den1, acc[dn][3] / den1);
  }
}

// ----------------------------------------------------------------- f32
constexpr int kF32Threads = 256;       // four threads per query row

template <int D>
constexpr int f32_smem_bytes() {       // Qs, Ks [64][D+1]; Vs [64][D]; Ps [64][65]
  return (2 * kBlockQ * (D + 1) + kBlockK * D + kBlockQ * (kBlockK + 1)) *
         static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_f32_kernel(const Args a) {
  constexpr int LD = D + 1;
  constexpr int LDP = kBlockK + 1;
  constexpr int C4 = D / 4;            // float4 chunks per row
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBlockQ * LD;
  float* Vs = Ks + kBlockK * LD;
  float* Ps = Vs + kBlockK * D;

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
  float acc[D / 4];                    // output dims c, c + 4, c + 8, ...
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;

  int kt_begin, kt_end;
  tile_range(a, q0, &kt_begin, &kt_end);
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    for (int i = tid; i < kBlockK * C4; i += kF32Threads) {
      const int row = i / C4, c4 = i % C4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + row < a.S) {
        kx = *reinterpret_cast<const float4*>(K + (k0 + row) * a.ks_s + c4 * 4);
        vx = *reinterpret_cast<const float4*>(V + (k0 + row) * a.vs_s + c4 * 4);
      }
      float* dst = &Ks[row * LD + c4 * 4];
      dst[0] = kx.x; dst[1] = kx.y; dst[2] = kx.z; dst[3] = kx.w;
      *reinterpret_cast<float4*>(&Vs[row * D + c4 * 4]) = vx;
    }
    __syncthreads();

    // this thread's keys: c, c + 4, ..., c + 60
    float s[kBlockK / 4];
#pragma unroll
    for (int j = 0; j < kBlockK / 4; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
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
    for (int i = 0; i < D / 4; ++i) acc[i] *= alpha;
    for (int j = 0; j < kBlockK; ++j) {
      const float pj = Ps[r * LDP + j];
#pragma unroll
      for (int i = 0; i < D / 4; ++i)
        acc[i] = fmaf(pj, Vs[j * D + c + 4 * i], acc[i]);
    }
  }

  if (qpos < a.S) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < D / 4; ++i) O[qpos * a.os_s + c + 4 * i] = acc[i] / den;
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, int smem, const Args& a,
           cudaStream_t stream) {
  if (smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, S, H, dh], k / v [B, S, Kv, dh], o [B, S, H, dh], all bf16
// (is_bf16 = 1) or all f32, the head dim contiguous; strides (in elements)
// in the order q (b, s, h), k, v, o.  dh is 64 or 128; H % Kv == 0.
// Returns -1 for a shape the kernel does not take, else cudaGetLastError()
// after the launch (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int B, int S,
                                      int H, int Kv, int dh, int is_bf16,
                                      int causal, int window, float softcap,
                                      void* stream) {
  if (B < 1 || S < 1 || Kv < 1 || H % Kv != 0 || (dh != 64 && dh != 128))
    return -1;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o;
  a.qs_b = strides[0]; a.qs_s = strides[1]; a.qs_h = strides[2];
  a.ks_b = strides[3]; a.ks_s = strides[4]; a.ks_h = strides[5];
  a.vs_b = strides[6]; a.vs_s = strides[7]; a.vs_h = strides[8];
  a.os_b = strides[9]; a.os_s = strides[10]; a.os_h = strides[11];
  a.S = S; a.H = H; a.Kv = Kv; a.causal = causal; a.window = window;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  a.softcap = softcap;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dh == 64 ? launch(flash_bf16_kernel<64>, grid, 128, 0, a, s)
                    : launch(flash_bf16_kernel<128>, grid, 128, 0, a, s);
  return dh == 64 ? launch(flash_f32_kernel<64>, grid, kF32Threads,
                           f32_smem_bytes<64>(), a, s)
                  : launch(flash_f32_kernel<128>, grid, kF32Threads,
                           f32_smem_bytes<128>(), a, s);
}
