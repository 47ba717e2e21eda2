// Fused frame-ingest geometry for Hopper: lift -> compact -> downsample ->
// stats, for all D detections of one keyframe.
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
// order, and a one-hot matmul would be pure waste here, so:
//   (a) count_kernel:    one block per (tile, object) counts valid pixels;
//   (b) scatter_kernel:  each block first sums the counts of its object's
//       earlier tiles (its base rank) and of all tiles (n), in tile order;
//   (c) scatter_kernel:  a block-level exclusive scan of the valid flags
//       gives every pixel its rank; each kept pixel owns exactly one
//       output slot, so it is stored directly, with no atomics.  Centroid
//       sums and bbox min/max go to per-(object, tile) partials;
//   finalize_kernel:     one block per object folds the partials in tile
//       order (results do not vary run to run: no float atomics), writes
//       n_out, centroid = sum / max(n_out, 1), zeroes the bbox of empty
//       objects, and zeroes the unused point slots.
//
// What bounds it on this card.  It moves about 1.3 MB in (the bool masks
// dominate) and 0.8 MB out per 144x256 keyframe with 32 detections: under
// 1 us at 3.35 TB/s.  Three small launches cost more than that, so the
// kernel is launch-bound; making it one persistent launch is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 1024;                 // pixels per (tile, object) block
constexpr int kThreads = 256;
constexpr int kPix = kTile / kThreads;      // consecutive pixels per thread
constexpr int kWarps = kThreads / 32;
constexpr int kStats = 9;                   // sum xyz, min xyz, max xyz
constexpr float kZEps = 1e-4f;              // geometry.lift_depth's floor
constexpr float kBig = 1e9f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool valid_px(const float* __restrict__ depth,
                                         const uint8_t* __restrict__ mask,
                                         int p, int hw) {
  return p < hw && mask[p] != 0 && depth[p] > kZEps;
}

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

// _select_slots: the output slot of valid-pixel rank `rho`, and whether the
// fused downsample keeps it.  The clip of rho to lift_cap comes before the
// multiply, so rho * budget stays inside int32 (the wrapper checks
// lift_cap * budget < 2^31).
__device__ __forceinline__ bool select_slot(int rho, int nl, int budget,
                                            int lift_cap, int* slot_out) {
  const int nl_safe = max(nl, 1);
  const int rho_c = min(rho, lift_cap);
  int slot;
  bool hit;
  if (nl > budget) {
    slot = (rho_c * budget + nl_safe - 1) / nl_safe;
    hit = (slot * nl) / budget == rho_c;
  } else {
    slot = rho_c;
    hit = rho_c < budget;
  }
  *slot_out = slot;
  return rho < nl && hit && slot < budget;
}

// (a) valid-pixel count per (object, tile)
__global__ void count_kernel(const float* __restrict__ depth,
                             const uint8_t* __restrict__ masks, int hw,
                             int ntiles, int* __restrict__ counts) {
  const int tile = blockIdx.x, d = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint8_t* mask = masks + static_cast<size_t>(d) * hw;
  int c = 0;
  for (int j = threadIdx.x; j < kTile; j += kThreads)
    c += valid_px(depth, mask, tile * kTile + j, hw);
  c = warp_sum(c);
  __shared__ int warp_tot[kWarps];
  if (lane == 0) warp_tot[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += warp_tot[w];
    counts[d * ntiles + tile] = s;
  }
}

// (b) + (c) ranks, slot selection, back-projection, per-tile stats
__global__ void scatter_kernel(const float* __restrict__ depth,
                               const uint8_t* __restrict__ masks,
                               const float* __restrict__ intr,
                               const float* __restrict__ pose, int hw, int w,
                               int ntiles, int stride, int budget,
                               int lift_cap, const int* __restrict__ counts,
                               float* __restrict__ points,
                               float* __restrict__ partials) {
  const int tile = blockIdx.x, d = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint8_t* mask = masks + static_cast<size_t>(d) * hw;

  __shared__ int s_base, s_total;
  __shared__ int warp_tot[kWarps];
  __shared__ float red[kWarps][kStats];

  // (b) this tile's base rank and the object's total, in tile order
  if (warp == 0) {
    int before = 0, total = 0;
    for (int t = lane; t < ntiles; t += 32) {
      const int c = counts[d * ntiles + t];
      total += c;
      if (t < tile) before += c;
    }
    before = warp_sum(before);
    total = warp_sum(total);
    if (lane == 0) {
      s_base = before;
      s_total = total;
    }
  }

  // (c) block-level exclusive scan of the valid flags
  const int p0 = tile * kTile + threadIdx.x * kPix;
  bool v[kPix];
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    v[i] = valid_px(depth, mask, p0 + i, hw);
    cnt += v[i];
  }
  const int incl = warp_inclusive_scan(cnt, lane);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  int warp_off = 0;
  for (int k = 0; k < warp; ++k) warp_off += warp_tot[k];
  int rho = s_base + warp_off + incl - cnt;
  const int nl = min(s_total, lift_cap);

  const float fx = intr[0], fy = intr[1], cx = intr[2], cy = intr[3];
  float st[kStats] = {0.f, 0.f, 0.f, kBig, kBig, kBig, -kBig, -kBig, -kBig};
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    if (!v[i]) continue;
    int slot;
    if (select_slot(rho, nl, budget, lift_cap, &slot)) {
      const int p = p0 + i;
      const int row = p / w;
      const float z = depth[p];
      const float xf = (static_cast<float>(p - row * w) + 0.5f) * stride;
      const float yf = (static_cast<float>(row) + 0.5f) * stride;
      const float x = (xf - cx) / fx * z;
      const float y = (yf - cy) / fy * z;
      float* out = points + (static_cast<size_t>(d) * budget + slot) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float wc = pose[c * 4 + 0] * x + pose[c * 4 + 1] * y +
                         pose[c * 4 + 2] * z + pose[c * 4 + 3];
        out[c] = wc;
        st[c] += wc;
        st[3 + c] = fminf(st[3 + c], wc);
        st[6 + c] = fmaxf(st[6 + c], wc);
      }
    }
    ++rho;
  }

  // per-tile stats: warp shuffles, then warps folded in order
#pragma unroll
  for (int s = 0; s < kStats; ++s) {
    float x = st[s];
    for (int o = 16; o > 0; o >>= 1) {
      const float y = __shfl_xor_sync(kFull, x, o);
      x = s < 3 ? x + y : (s < 6 ? fminf(x, y) : fmaxf(x, y));
    }
    if (lane == 0) red[warp][s] = x;
  }
  __syncthreads();
  if (threadIdx.x < kStats) {
    const int s = threadIdx.x;
    float x = red[0][s];
    for (int k = 1; k < kWarps; ++k)
      x = s < 3 ? x + red[k][s]
                : (s < 6 ? fminf(x, red[k][s]) : fmaxf(x, red[k][s]));
    partials[(static_cast<size_t>(d) * ntiles + tile) * kStats + s] = x;
  }
}

// n_out, centroid, bbox from the partials in tile order; zero unused slots
__global__ void finalize_kernel(const int* __restrict__ counts,
                                const float* __restrict__ partials,
                                int ntiles, int budget, int lift_cap,
                                float* __restrict__ points,
                                int* __restrict__ n_out,
                                float* __restrict__ centroid,
                                float* __restrict__ bbox_min,
                                float* __restrict__ bbox_max) {
  const int d = blockIdx.x;
  __shared__ int s_no;
  if (threadIdx.x == 0) {
    int total = 0;
    for (int t = 0; t < ntiles; ++t) total += counts[d * ntiles + t];
    const int no = min(min(total, lift_cap), budget);
    float st[kStats] = {0.f, 0.f, 0.f, kBig, kBig, kBig, -kBig, -kBig, -kBig};
    for (int t = 0; t < ntiles; ++t) {
      const float* p = partials + (static_cast<size_t>(d) * ntiles + t) * kStats;
      for (int c = 0; c < 3; ++c) {
        st[c] += p[c];
        st[3 + c] = fminf(st[3 + c], p[3 + c]);
        st[6 + c] = fmaxf(st[6 + c], p[6 + c]);
      }
    }
    const float denom = static_cast<float>(max(no, 1));
    for (int c = 0; c < 3; ++c) {
      centroid[d * 3 + c] = st[c] / denom;
      bbox_min[d * 3 + c] = no > 0 ? st[3 + c] : 0.f;
      bbox_max[d * 3 + c] = no > 0 ? st[6 + c] : 0.f;
    }
    n_out[d] = no;
    s_no = no;
  }
  __syncthreads();
  float* row = points + static_cast<size_t>(d) * budget * 3;
  for (int j = s_no * 3 + threadIdx.x; j < budget * 3; j += blockDim.x)
    row[j] = 0.f;
}

}  // namespace

extern "C" int lift_compact_tile_pixels() { return kTile; }

// depth [H, W] f32; masks [D, H, W] uint8/bool; intr [4] f32 (full-res);
// pose [4, 4] f32 cam->world.  Scratch: counts [D, ntiles] i32, partials
// [D, ntiles, 9] f32 with ntiles = ceil(H*W / kTile).  Outputs: points
// [D, budget, 3], n_out [D] i32, centroid / bbox_min / bbox_max [D, 3].
// Returns cudaGetLastError() after the launches (0 = launched).
extern "C" int lift_compact_launch(const float* depth, const uint8_t* masks,
                                   const float* intr, const float* pose,
                                   int d, int h, int w, int stride,
                                   int budget, int lift_cap, int* counts,
                                   float* partials, float* points, int* n_out,
                                   float* centroid, float* bbox_min,
                                   float* bbox_max, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hw = h * w;
  const int ntiles = (hw + kTile - 1) / kTile;
  const dim3 grid(ntiles, d);
  count_kernel<<<grid, kThreads, 0, s>>>(depth, masks, hw, ntiles, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scatter_kernel<<<grid, kThreads, 0, s>>>(depth, masks, intr, pose, hw, w,
                                           ntiles, stride, budget, lift_cap,
                                           counts, points, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  finalize_kernel<<<d, kThreads, 0, s>>>(counts, partials, ntiles, budget,
                                         lift_cap, points, n_out, centroid,
                                         bbox_min, bbox_max);
  return static_cast<int>(cudaGetLastError());
}
