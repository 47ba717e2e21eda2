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
//   s = softcap(q . k^T * dh^-0.5),  p = softmax(mask(s)),  o = p . v:
//   dv = p~^T . do        (p~ = p rounded to v's dtype, as the forward
//                           rounds p before p . v)
//   dp = do . v^T,   D = rowsum(do * o),   ds = p * (dp - D)
//   dx = ds * (1 - t^2) * dh^-0.5   (t = s / softcap = tanh(...); 1 without
//                                    a softcap)
//   dq = dx . k,     dk = dx^T . q
// with q, o, do [B, S, H, dh] and k, v [B, S, Kv, dh] read through their
// strides (the head dim contiguous), query head h reading kv head
// h / (H / Kv); dk and dv of kv head j sum over its G = H / Kv query
// heads.  Operands are read in their own dtype (bf16 or f32) and every
// product accumulates in f32; dq, dk and dv are written contiguous in q's
// dtype.  Masks as the forward: causal kpos <= qpos, window
// qpos - kpos < window, and keys at or past S never count.
//
// Design: two launches, no float atomics, so two calls give the same bits.
//   1. flash_bwd_dq_kernel, one block per (b, h, 64-query tile).  It
//      loads the Q, dO and O tiles, forms D, walks the key tiles the masks
//      let in once to recompute each row's softmax max m and sum l (the
//      forward's online rule; the forward stays as it is and writes no
//      statistics), writes m, l and D for the second launch, then walks
//      them again: p = exp(s - m) / l, dp = dO . V^T, ds, dq += dx . K.
//   2. flash_bwd_dkdv_kernel, one block per (b, kv head, 64-key tile).  K
//      and V stay in shared memory while it walks the G query heads and
//      the query tiles the masks let in, recomputing s^T, p^T and dp^T
//      with keys as rows, and keeps dk and dv in registers.
// Every product is SIMT fp32 FMA over 64 x 64 tiles in shared memory
// (rows padded to dh + 1 floats, so no bank conflicts), each of the 256
// threads owning a 4 x 4 micro-tile of scores and 4 rows x dh/16 columns
// of its accumulators.  Tensor cores (mma / wgmma) and TMA are later work.
//
// What bounds it on this card: operations.  Five products of
// 2 * B * H * S * S_eff * dh flops (S_eff the keys a query keeps) against
// q, k, v, o, do read and dq, dk, dv written once.  At the captioner's
// training shape (B = 8, S = 256, H = 12, Kv = 4, dh = 64, bf16, causal)
// that is about 1.3 GFLOP, 1.3 us at the bf16 tensor-core peak, against
// 15.7 MB, 4.7 us at 3.35 TB/s: bytes bound the ideal kernel.  This one
// recomputes the scores three times and runs on the fp32 pipe (67 TFLOP/s),
// so it sits far from either bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kRows = 64;              // query rows and keys per tile
constexpr int kThreads = 256;          // 16 x 16 threads, 4 x 4 each
constexpr int kLdw = kRows + 1;        // row stride of the [64, 64] tiles

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* g;                       // do, the output's gradient
  void* dq;
  void* dk;
  void* dv;
  float* m;                            // [B, H, S] row max, row sum, D
  float* l;
  float* dsum;
  long long qs_b, qs_s, qs_h;          // element strides (b, s, head)
  long long ks_b, ks_s, ks_h;
  long long vs_b, vs_s, vs_h;
  long long os_b, os_s, os_h;
  long long gs_b, gs_s, gs_h;
  int S, H, Kv, causal, window;
  float scale, softcap;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T at src (16-byte aligned) -> 16 / sizeof(T) floats
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// rows [row0, row0 + 64) of one head (base already at (b, head)) into
// dst [64][D + 1] floats; rows at or past S are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base,
                                          long long stride, int row0, int S) {
  constexpr int E = 16 / static_cast<int>(sizeof(T));
  constexpr int C = D / E;
  for (int i = threadIdx.x; i < kRows * C; i += kThreads) {
    const int row = i / C, c = i % C;
    float tmp[E];
    if (row0 + row < S) {
      load16(base + (row0 + row) * stride + c * E, tmp);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) tmp[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < E; ++e) dst[row * (D + 1) + c * E + e] = tmp[e];
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
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ty + 16 * r) * LD + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = Bm[(tx + 16 * c) * LD + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// out[r][c] += sum_j W[ty + 16 r][j] * M[j][tx + 16 c]
// (W [64][65], M [64][D + 1])
template <int D>
__device__ __forceinline__ void tile_acc(const float* W, const float* M,
                                         int ty, int tx,
                                         float out[4][D / 16]) {
  constexpr int LD = D + 1;
#pragma unroll 4
  for (int j = 0; j < kRows; ++j) {
    float w[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = W[(ty + 16 * r) * kLdw + j];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float mv = M[j * LD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r) out[r][c] = fmaf(w[r], mv, out[r][c]);
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

__device__ __forceinline__ bool allowed(const Args& a, int qpos, int kpos) {
  bool ok = qpos < a.S && kpos < a.S;
  if (a.causal) ok = ok && kpos <= qpos;
  if (a.window > 0) ok = ok && qpos - kpos < a.window;
  return ok;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr int dq_smem_bytes() {        // Q, dO, K, V [64][D+1]; ds; D
  return (4 * kRows * (D + 1) + kRows * kLdw + kRows) *
         static_cast<int>(sizeof(float));
}

template <int D>
constexpr int dkdv_smem_bytes() {      // K, V, Q, dO; p~, ds; m, l, D
  return (4 * kRows * (D + 1) + 2 * kRows * kLdw + 3 * kRows) *
         static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Args a) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + kRows * LD;
  float* Ks = Gs + kRows * LD;
  float* Vs = Ks + kRows * LD;
  float* Ws = Vs + kRows * LD;
  float* Dsh = Ws + kRows * kLdw;

  const int q0 = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.Kv);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* Q = static_cast<const T*>(a.q) + b * a.qs_b + h * a.qs_h;
  const T* K = static_cast<const T*>(a.k) + b * a.ks_b + kvh * a.ks_h;
  const T* V = static_cast<const T*>(a.v) + b * a.vs_b + kvh * a.vs_h;
  const T* O = static_cast<const T*>(a.o) + b * a.os_b + h * a.os_h;
  const T* G = static_cast<const T*>(a.g) + b * a.gs_b + h * a.gs_h;

  load_tile<T, D>(Qs, Q, a.qs_s, q0, a.S);
  load_tile<T, D>(Gs, G, a.gs_s, q0, a.S);
  load_tile<T, D>(Vs, O, a.os_s, q0, a.S);      // o, for D only
  __syncthreads();
  if (tid < kRows) {
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = fmaf(Gs[tid * LD + d], Vs[tid * LD + d],
                                           acc);
    Dsh[tid] = acc;
  }
  __syncthreads();

  // the key tiles any row of this tile keeps
  int kt_end = (a.S + kRows - 1) / kRows;
  if (a.causal) kt_end = min(kt_end, (q0 + kRows - 1) / kRows + 1);
  const int kt_begin = a.window > 0 ? max(0, q0 - a.window + 1) / kRows : 0;

  // pass 1: each row's max m and sum l, by the forward's online rule
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) { m[r] = kNeg; l[r] = 0.f; }
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();
    load_tile<T, D>(Ks, K, a.ks_s, k0, a.S);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty + 16 * r;
      bool ok[4];
      float mx = m[r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float f;
        s[r][c] = score(a, s[r][c], &f);
        ok[c] = allowed(a, qpos, k0 + tx + 16 * c);
        if (ok[c]) mx = fmaxf(mx, s[r][c]);
      }
      mx = half_warp_max(mx);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) rs += ok[c] ? expf(s[r][c] - mx) : 0.f;
      rs = half_warp_sum(rs);
      l[r] = l[r] * expf(m[r] - mx) + rs;
      m[r] = mx;
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q0 + ty + 16 * r;
    if (tx == 0 && qpos < a.S) {
      const long long at = (static_cast<long long>(b) * a.H + h) * a.S + qpos;
      a.m[at] = m[r];
      a.l[at] = l[r];
      a.dsum[at] = Dsh[ty + 16 * r];
    }
  }

  // pass 2: dq += dx . K
  float dq[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dq[r][c] = 0.f;
  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kRows;
    __syncthreads();
    load_tile<T, D>(Ks, K, a.ks_s, k0, a.S);
    load_tile<T, D>(Vs, V, a.vs_s, k0, a.S);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(Qs, Ks, ty, tx, s);
    tile_dot<D>(Gs, Vs, ty, tx, dp);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qpos = q0 + ty + 16 * r;
      const float drow = Dsh[ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float f;
        const float x = score(a, s[r][c], &f);
        const float p = allowed(a, qpos, k0 + tx + 16 * c)
                            ? expf(x - m[r]) / l[r] : 0.f;
        Ws[(ty + 16 * r) * kLdw + tx + 16 * c] =
            p * (dp[r][c] - drow) * f * a.scale;
      }
    }
    __syncthreads();
    tile_acc<D>(Ws, Ks, ty, tx, dq);
  }

  T* dQ = static_cast<T*>(a.dq);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q0 + ty + 16 * r;
    if (qpos >= a.S) continue;
    const long long row = ((static_cast<long long>(b) * a.S + qpos) * a.H + h)
                          * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dQ[row + tx + 16 * c] = from_f<T>(dq[r][c]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const Args a) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kRows * LD;
  float* Qs = Vs + kRows * LD;
  float* Gs = Qs + kRows * LD;
  float* Ps = Gs + kRows * LD;
  float* Ws = Ps + kRows * kLdw;
  float* msh = Ws + kRows * kLdw;
  float* lsh = msh + kRows;
  float* Dsh = lsh + kRows;

  const int k0 = blockIdx.x * kRows, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Kv;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* K = static_cast<const T*>(a.k) + b * a.ks_b + kvh * a.ks_h;
  const T* V = static_cast<const T*>(a.v) + b * a.vs_b + kvh * a.vs_h;
  load_tile<T, D>(Ks, K, a.ks_s, k0, a.S);
  load_tile<T, D>(Vs, V, a.vs_s, k0, a.S);

  // the query tiles any key of this tile is kept by
  const int qt_begin = a.causal ? k0 / kRows : 0;
  int qt_end = (a.S + kRows - 1) / kRows;
  if (a.window > 0) {
    const int last = min(a.S, k0 + kRows - 1 + a.window);  // past the last
    qt_end = min(qt_end, (last + kRows - 1) / kRows);
  }

  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) { dk[r][c] = 0.f; dv[r][c] = 0.f; }

  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const T* Q = static_cast<const T*>(a.q) + b * a.qs_b + h * a.qs_h;
    const T* Gd = static_cast<const T*>(a.g) + b * a.gs_b + h * a.gs_h;
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * kRows;
      __syncthreads();
      load_tile<T, D>(Qs, Q, a.qs_s, q0, a.S);
      load_tile<T, D>(Gs, Gd, a.gs_s, q0, a.S);
      if (tid < kRows) {
        const int qpos = q0 + tid;
        if (qpos < a.S) {
          const long long at = (static_cast<long long>(b) * a.H + h) * a.S +
                               qpos;
          msh[tid] = a.m[at];
          lsh[tid] = a.l[at];
          Dsh[tid] = a.dsum[at];
        } else {
          msh[tid] = 0.f;
          lsh[tid] = 1.f;
          Dsh[tid] = 0.f;
        }
      }
      __syncthreads();
      // keys as rows (ty + 16 r), queries as columns (tx + 16 c)
      float s[4][4], dp[4][4];
      tile_dot<D>(Ks, Qs, ty, tx, s);
      tile_dot<D>(Vs, Gs, ty, tx, dp);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kpos = k0 + ty + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = tx + 16 * c;
          float f;
          const float x = score(a, s[r][c], &f);
          const float p = allowed(a, q0 + col, kpos)
                              ? expf(x - msh[col]) / lsh[col] : 0.f;
          Ps[(ty + 16 * r) * kLdw + col] = to_f(from_f<T>(p));
          Ws[(ty + 16 * r) * kLdw + col] =
              p * (dp[r][c] - Dsh[col]) * f * a.scale;
        }
      }
      __syncthreads();
      tile_acc<D>(Ps, Gs, ty, tx, dv);
      tile_acc<D>(Ws, Qs, ty, tx, dk);
    }
  }

  T* dK = static_cast<T*>(a.dk);
  T* dV = static_cast<T*>(a.dv);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kpos = k0 + ty + 16 * r;
    if (kpos >= a.S) continue;
    const long long row =
        ((static_cast<long long>(b) * a.S + kpos) * a.Kv + kvh) * D;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      dK[row + tx + 16 * c] = from_f<T>(dk[r][c]);
      dV[row + tx + 16 * c] = from_f<T>(dv[r][c]);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int smem, cudaStream_t stream,
           const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int run(const Args& a, int B, cudaStream_t st) {
  const int tiles = (a.S + kRows - 1) / kRows;
  int err = launch(flash_bwd_dq_kernel<T, D>, dim3(tiles, a.H, B),
                   dq_smem_bytes<D>(), st, a);
  if (err != 0) return err;
  return launch(flash_bwd_dkdv_kernel<T, D>, dim3(tiles, a.Kv, B),
                dkdv_smem_bytes<D>(), st, a);
}

}  // namespace

// q, o, do [B, S, H, dh] and k, v [B, S, Kv, dh], all bf16 (is_bf16 = 1)
// or all f32, the head dim contiguous, rows 16-byte aligned; strides (in
// elements) in the order q (b, s, h), k, v, o, do.  dq [B, S, H, dh] and
// dk, dv [B, S, Kv, dh] are contiguous in the same dtype; m, l and dsum
// are [B, H, S] f32 scratch.  dh is 64 or 128; H % Kv == 0.  Returns -1
// for a shape the kernels do not take, else cudaGetLastError() after the
// launches (0 = both launched).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* m, void* l,
    void* dsum, const long long* strides, int B, int S, int H, int Kv, int dh,
    int is_bf16, int causal, int window, float softcap, void* stream) {
  if (B < 1 || S < 1 || Kv < 1 || H % Kv != 0 || (dh != 64 && dh != 128) ||
      window < 0 || H > 65535)
    return -1;
  Args a;
  a.q = q; a.k = k; a.v = v; a.o = o; a.g = dout;
  a.dq = dq; a.dk = dk; a.dv = dv;
  a.m = static_cast<float*>(m);
  a.l = static_cast<float*>(l);
  a.dsum = static_cast<float*>(dsum);
  a.qs_b = strides[0]; a.qs_s = strides[1]; a.qs_h = strides[2];
  a.ks_b = strides[3]; a.ks_s = strides[4]; a.ks_h = strides[5];
  a.vs_b = strides[6]; a.vs_s = strides[7]; a.vs_h = strides[8];
  a.os_b = strides[9]; a.os_s = strides[10]; a.os_h = strides[11];
  a.gs_b = strides[12]; a.gs_s = strides[13]; a.gs_h = strides[14];
  a.S = S; a.H = H; a.Kv = Kv; a.causal = causal; a.window = window;
  a.scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  a.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dh == 64 ? run<__nv_bfloat16, 64>(a, B, st)
                    : run<__nv_bfloat16, 128>(a, B, st);
  return dh == 64 ? run<float, 64>(a, B, st) : run<float, 128>(a, B, st);
}
