// Fused frame-ingest geometry for Hopper: lift -> compact -> downsample ->
// stats, for all D detections of one keyframe, in one launch.
//
// Replaces: src/repro/kernels/lift_compact.py :: lift_compact_pallas
// (kernel body _kernel, slot rule _select_slots).
//
// What it computes, for depth [H, W] and D instance masks [D, H, W]:
// every valid pixel (mask set and depth > Z_EPS) of object d gets its rank
// r among d's valid pixels in row-major order; rank r is kept iff the
// stride downsample to `budget` reads it (slot = ceil(r * B / n) maps back
// to r under floor(slot * n / B)), where n = min(count, lift_cap).  A kept
// pixel is back-projected through the intrinsics and the cam->world pose
// and stored at points[d, slot].  Centroid and bbox run over the kept
// points; slots at or past n_out = min(n, budget) are zero.
//
// Design.  The TPU kernel walks the pixel tiles in order, carrying each
// object's running rank in scratch, and scatters through a one-hot
// [D, T, P] matmul on the MXU.  Hopper blocks run in parallel and in no
// order, so here each object gets one thread-block cluster of C <= 8
// blocks (the portable cluster size), and block r of it owns the pixel
// range [r * share, (r + 1) * share) of the object (the split is made on
// the host: kernels/lift_compact.py::work_split, 8 blocks of 288 threads
// an object at the main path's 144x256, two blocks an SM):
//   pass 1  each thread reads 16 consecutive pixels (one 16-byte mask load
//           and four 16-byte depth loads where the row is aligned), keeps
//           their valid flags as bits in a register and their depths in
//           shared memory; a block-level exclusive scan of the per-thread
//           counts gives every pixel its rank inside the block;
//   ranks   every block stores its count into the shared memory of every
//           block of the cluster with st.async, which the receiving
//           block's mbarrier counts (no cluster barrier, no memory fence);
//           each block then knows its base rank (the counts of the blocks
//           before it) and the object's n;
//   pass 2  each thread steps through the output slots whose ranks fall
//           among its pixels (one division a thread, not one a pixel) and
//           stores each kept point straight into its slot, with no
//           atomics.  Centroid sums and bbox min / max are reduced in a
//           fixed shuffle order and sent to rank 0 the same way;
//   finish  every block zeroes its share of the unused slots [n_out,
//           budget); rank 0 waits for the C partials, folds them in rank
//           order and writes n_out, centroid and bbox.
// One cluster barrier, at the start and waited on only after pass 1, makes
// sure every block has begun and set up its mbarriers before another
// stores into it.  No global scratch, no float atomics: results do not
// vary run to run.  A block whose range exceeds one register chunk (512
// threads x 16 pixels) loops over chunks: pass 1 counts them all and
// keeps the first chunk, pass 2 reads the later chunks again and carries a
// running base.  So any H*W works (720x1280 at stride 1: 8 blocks of 15
// chunks), and the main path reads its masks exactly once.
//
// What bounds it on this card.  It moves about 1.3 MB in (the bool masks
// dominate) and 0.8 MB out per 144x256 keyframe with 32 detections: under
// 1 us at 3.35 TB/s.  Latency sets its time, not the bytes: the launch,
// one cold HBM round trip for the masks, the count exchange, and the walk
// over the kept points of the block that holds the most (the first
// lift_cap ranks of a dense object fall in its first blocks).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kPix = 16;                    // pixels per thread per chunk
constexpr int kMaxThreads = 512;            // kernels/lift_compact.py
constexpr int kMaxCluster = 8;              // portable cluster size
constexpr int kStats = 9;                   // sum xyz, min xyz, max xyz
constexpr float kZEps = 1e-4f;              // geometry.lift_depth's floor
constexpr float kBig = 1e9f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// A cluster barrier in two halves: arrive (no memory ordering), then wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The same shared-memory address in block `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

// wait until the barrier's first phase has completed
__device__ __forceinline__ void mbar_wait0(uint32_t bar) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar) : "memory");
  } while (!done);
}

// Store 4 bytes into another block's shared memory (cluster addresses);
// its mbarrier `bar` counts them when they have landed.
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];\n" ::"r"(addr), "r"(v), "r"(bar) : "memory");
}

// Valid flags (bit i = pixel p0 + i) and depths of the 16 pixels from p0,
// pixels at or past `end` invalid.  `mask` is the object's [H*W] mask.
__device__ __forceinline__ uint32_t load16(const float* __restrict__ depth,
                                           const uint8_t* __restrict__ mask,
                                           int p0, int end, float (&z)[kPix]) {
  uint32_t bits = 0;
  const bool vec = p0 + kPix <= end &&
                   ((reinterpret_cast<uintptr_t>(mask + p0) |
                     reinterpret_cast<uintptr_t>(depth + p0)) & 15) == 0;
  if (vec) {
    const uint4 m = __ldg(reinterpret_cast<const uint4*>(mask + p0));
    const float4* dz = reinterpret_cast<const float4*>(depth + p0);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = __ldg(dz + q);
      z[4 * q] = v.x;
      z[4 * q + 1] = v.y;
      z[4 * q + 2] = v.z;
      z[4 * q + 3] = v.w;
    }
    const uint32_t mw[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const bool set = ((mw[i / 4] >> (8 * (i % 4))) & 0xffu) != 0;
      bits |= static_cast<uint32_t>(set && z[i] > kZEps) << i;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPix; ++i) {
      const int p = p0 + i;
      const bool in = p < end;
      z[i] = in ? __ldg(depth + p) : 0.f;
      bits |= static_cast<uint32_t>(in && mask[p] != 0 && z[i] > kZEps) << i;
    }
  }
  return bits;
}

// grid (C, D), cluster (C, 1, 1), blockDim.x a multiple of 32 <= 512.
__global__ void __launch_bounds__(kMaxThreads, 2)
    lift_cluster_kernel(const float* __restrict__ depth,
                        const uint8_t* __restrict__ masks,
                        const float* __restrict__ intr,
                        const float* __restrict__ pose, int hw, int w,
                        int stride, int budget, int lift_cap, int share,
                        float* __restrict__ points, int* __restrict__ n_out,
                        float* __restrict__ centroid,
                        float* __restrict__ bbox_min,
                        float* __restrict__ bbox_max) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nblk = static_cast<int>(cluster.num_blocks());
  const int d = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int chunk = blockDim.x * kPix;
  const int begin = static_cast<int>(
      min(static_cast<long long>(rank) * share, static_cast<long long>(hw)));
  const int end = static_cast<int>(
      min(static_cast<long long>(begin) + share, static_cast<long long>(hw)));
  const uint8_t* mask = masks + static_cast<size_t>(d) * hw;

  __shared__ int s_warp[32], s_rest[32];
  __shared__ int s_counts[kMaxCluster];
  __shared__ float s_par[16];               // fx fy cx cy, pose rows 0-2
  __shared__ float s_z[kPix][kMaxThreads];  // the chunk's depths, by thread
  __shared__ float s_red[32][kStats];
  __shared__ float s_stats[kMaxCluster][kStats];
  __shared__ alignas(8) uint64_t s_bar[2];  // counts in; statistics in

  // Each block's count goes to every block, and each block's statistics
  // to rank 0, as asynchronous stores that the receiver's mbarrier counts:
  // no cluster barrier and no memory fence after the start.  The start
  // barrier (waited on after pass 1) makes sure every block has begun and
  // set up its mbarriers before another block stores into it.
  const uint32_t bar_counts = smem_u32(&s_bar[0]);
  const uint32_t bar_stats = smem_u32(&s_bar[1]);
  if (tid == 0) {
    mbar_init(bar_counts, 1);
    mbar_init(bar_stats, 1);
    mbar_expect_tx(bar_counts, nblk * 4);
    mbar_expect_tx(bar_stats, nblk * kStats * 4);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_arrive_relaxed();
  if (tid < 16) s_par[tid] = tid < 4 ? intr[tid] : pose[tid - 4];

  // pass 1: count, and scan the first chunk, whose flags stay in a
  // register and depths in shared memory
  float z[kPix];
  const uint32_t bits0 = load16(depth, mask, begin + tid * kPix, end, z);
#pragma unroll
  for (int i = 0; i < kPix; ++i) s_z[i][tid] = z[i];
  const int c_first = __popc(bits0);
  int c_rest = 0;                           // the later chunks' pixels
  for (int c0 = begin + chunk; c0 < end; c0 += chunk)
    c_rest += __popc(load16(depth, mask, c0 + tid * kPix, end, z));
  const int incl = warp_inclusive_scan(c_first, lane);
  c_rest = warp_sum(c_rest);
  if (lane == 31) s_warp[warp] = incl;
  if (lane == 0) s_rest[warp] = c_rest;
  __syncthreads();
  int off = 0, tot = 0, rest = 0;
  for (int k = 0; k < nwarps; ++k) {
    const int t = s_warp[k];
    off += k < warp ? t : 0;
    tot += t;
    rest += s_rest[k];
  }
  cluster_wait();
  if (tid < nblk)                           // this block's count, to all
    st_async(map_rank(smem_u32(&s_counts[rank]), tid),
             static_cast<uint32_t>(tot + rest), map_rank(bar_counts, tid));
  mbar_wait0(bar_counts);

  int base = 0, total = 0;
  for (int r = 0; r < nblk; ++r) {
    base += r < rank ? s_counts[r] : 0;
    total += s_counts[r];
  }
  const int nl = min(total, lift_cap);
  const int no = min(nl, budget);

  // pass 2: ranks, the kept slots, back-projection, block statistics
  float st[kStats] = {0.f, 0.f, 0.f, kBig, kBig, kBig, -kBig, -kBig, -kBig};
  for (int c0 = begin; c0 < end; c0 += chunk) {
    const int p0 = c0 + tid * kPix;
    uint32_t bits = bits0;
    int c = c_first, pre = off + incl - c_first, ctot = tot;
    if (c0 != begin) {                      // a later chunk: read, scan
      bits = load16(depth, mask, p0, end, z);
#pragma unroll
      for (int i = 0; i < kPix; ++i) s_z[i][tid] = z[i];
      c = __popc(bits);
      const int inc = warp_inclusive_scan(c, lane);
      __syncthreads();                      // s_warp has been read
      if (lane == 31) s_warp[warp] = inc;
      __syncthreads();
      int o = 0;
      ctot = 0;
      for (int k = 0; k < nwarps; ++k) {
        const int t = s_warp[k];
        o += k < warp ? t : 0;
        ctot += t;
      }
      pre = o + inc - c;
    }
    const int rho0 = base + pre;            // rank of the first valid px
    base += ctot;
    if (c > 0 && rho0 < nl) {
      // the kept slots whose rank lies in [rho0, rho0 + c): slot i keeps
      // rank r(i) = floor(i * nl / budget) if nl > budget, else r(i) = i;
      // r is stepped by nl / budget with its remainder, so one division
      // per thread (not per pixel) finds the first slot
      int i, r, rem = 0, step_q = 1, step_r = 0;
      if (nl > budget) {
        i = (rho0 * budget + nl - 1) / nl;     // first i with r(i) >= rho0
        r = i * nl / budget;
        rem = i * nl - r * budget;
        step_q = nl / budget;
        step_r = nl - step_q * budget;
      } else {
        i = rho0;
        r = rho0;
      }
      const int r_end = min(rho0 + c, nl);
      const int row0 = p0 / w, col0 = p0 - row0 * w;
      uint32_t m = bits;                       // valid pixels from rank cur
      int cur = rho0;
      for (; r < r_end && i < budget; ++i) {
        for (; cur < r; ++cur) m &= m - 1;
        const int k = __ffs(m) - 1;            // the pixel of rank r
        int col = col0 + k, row = row0;
        while (col >= w) {
          col -= w;
          ++row;
        }
        const float zz = s_z[k][tid];
        const float xf = (static_cast<float>(col) + 0.5f) * stride;
        const float yf = (static_cast<float>(row) + 0.5f) * stride;
        const float x = (xf - s_par[2]) / s_par[0] * zz;
        const float y = (yf - s_par[3]) / s_par[1] * zz;
        float* out = points + (static_cast<size_t>(d) * budget + i) * 3;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float* pr = s_par + 4 + 4 * q;
          const float wc = pr[0] * x + pr[1] * y + pr[2] * zz + pr[3];
          out[q] = wc;
          st[q] += wc;
          st[3 + q] = fminf(st[3 + q], wc);
          st[6 + q] = fmaxf(st[6 + q], wc);
        }
        r += step_q;
        rem += step_r;
        if (rem >= budget) {
          rem -= budget;
          ++r;
        }
      }
    }
  }

  // block statistics: warp shuffles, then warps folded in order, into
  // rank 0's shared memory
#pragma unroll
  for (int s = 0; s < kStats; ++s) {
    float x = st[s];
    for (int o = 16; o > 0; o >>= 1) {
      const float y = __shfl_xor_sync(kFull, x, o);
      x = s < 3 ? x + y : (s < 6 ? fminf(x, y) : fmaxf(x, y));
    }
    if (lane == 0) s_red[warp][s] = x;
  }
  __syncthreads();
  if (tid < kStats) {
    const int s = tid;
    float x = s_red[0][s];
    for (int k = 1; k < nwarps; ++k)
      x = s < 3 ? x + s_red[k][s]
                : (s < 6 ? fminf(x, s_red[k][s]) : fmaxf(x, s_red[k][s]));
    st_async(map_rank(smem_u32(&s_stats[rank][s]), 0), __float_as_uint(x),
             map_rank(bar_stats, 0));
  }

  // this block's share of the unused slots
  float* prow = points + static_cast<size_t>(d) * budget * 3;
  for (int j = no * 3 + rank * blockDim.x + tid; j < budget * 3;
       j += nblk * blockDim.x)
    prow[j] = 0.f;

  if (rank == 0 && tid < 3) {               // fold the blocks in rank order
    mbar_wait0(bar_stats);
    float sum = s_stats[0][tid], mn = s_stats[0][3 + tid],
          mx = s_stats[0][6 + tid];
    for (int r = 1; r < nblk; ++r) {
      sum += s_stats[r][tid];
      mn = fminf(mn, s_stats[r][3 + tid]);
      mx = fmaxf(mx, s_stats[r][6 + tid]);
    }
    centroid[d * 3 + tid] = sum / static_cast<float>(max(no, 1));
    bbox_min[d * 3 + tid] = no > 0 ? mn : 0.f;
    bbox_max[d * 3 + tid] = no > 0 ? mx : 0.f;
    if (tid == 0) n_out[d] = no;
  }
}

}  // namespace

// depth [H, W] f32; masks [D, H, W] uint8/bool; intr [4] f32 (full-res);
// pose [4, 4] f32 cam->world.  The split (kernels/lift_compact.py::
// work_split): `cluster` blocks per object, each of `threads` threads
// owning `share` pixels.  Outputs: points [D, budget, 3], n_out [D] i32,
// centroid / bbox_min / bbox_max [D, 3].  One launch.  Returns -1 for a
// split the kernel does not take, else the launch's error (0 = launched).
extern "C" int lift_compact_launch(const float* depth, const uint8_t* masks,
                                   const float* intr, const float* pose,
                                   int d, int h, int w, int stride,
                                   int budget, int lift_cap, int cluster,
                                   int share, int threads, float* points,
                                   int* n_out, float* centroid,
                                   float* bbox_min, float* bbox_max,
                                   void* stream) {
  const long long hw = static_cast<long long>(h) * w;
  if (d < 1 || d > 65535 || hw < 1 || cluster < 1 || cluster > kMaxCluster ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      share < 1 || share % kPix != 0 ||
      static_cast<long long>(cluster) * share < hw)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, d, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, lift_cluster_kernel, depth, masks, intr, pose,
      static_cast<int>(hw), w, stride, budget, lift_cap, share, points, n_out,
      centroid, bbox_min, bbox_max);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
