// Cumulative per-node class histograms of one BFS step of the tree grower.
//
// Replaces the TPU kernel flake16_framework_tpu/ops/trees.py
// _hist_cumsum_kernel (launched by _pallas_cum_hists). That kernel fed the
// MXU two bf16 one-hot products per feature, [N, W] x [N, B], then
// cumsummed over bins. Here the one-hots never exist: for tree t and
// feature f,
//
//   cw[t, f, w, b]  = sum_{b' <= b} sum_n [rel[t,n] == w] * w[t,n] * [bin[s,f,n] == b']
//   cwy[t, f, w, b] = the same with wy[t,n]
//
// where s = t / trees_per_group is tree t's bin set: the grower batches the
// trees of several folds, and each fold's trees read that fold's bins.
//
// What bounds it: bytes. A step must write 2 x [T, F, W, B] f32 (104.9 MB
// at T = 100, F = 16, W = 128, B = 64) and read 9.7 MB: 34.2 us at
// 3.35 TB/s. The split scan downstream reads every row, so rows that no
// sample reached are written as zeros too. Most of the grower's real steps
// reach few rows (the first hold 1, 2, 4, ... nodes, the last few
// samples), so the kernel is a store stream with the histogram work hidden
// under it. What keeps it above the bound is each tile's pass over its
// tree's samples: dependent loads whose latency the stores do not cover.
//
// Design:
// - One block of 1024 threads a (tree, group of G = 4 features) tile. One
//   pass over a tree's rel, w and wy feeds G histograms, so a step reads
//   the sample arrays F / G times, not F times. The tile's 131 KB of
//   shared memory leaves one block resident per SM: at the main path's
//   shape 400 tiles on 132 SMs, 3.03 waves.
// - Packed integer counts. On this card an f32 shared-memory atomicAdd is
//   a compare-and-swap loop. A cell is one 32-bit word holding both
//   classes as 16-bit counts (w low, wy high), added with one native
//   integer atomic a sample and feature: half the shared memory and a
//   quarter of the atomic instructions of two f32 cells. The packing is
//   exact while the weights are whole numbers and a tile's in-window
//   weights sum below 2^16 in each class, so no cell can carry into its
//   neighbour. The block checks both as it adds (each thread sums what it
//   added, saturating; one warp reduction and two shared atomics a warp).
//   A tile that fails either check (never the grower's: its weights are
//   bootstrap counts or 0/1, at most 8000 a tree) is added again in f32,
//   one class a pass; the result is then exact wherever f32 sums are.
// - Accumulation reads rel four samples at a time (int4), skips a quad
//   whose samples are all out of the window, and reads w and wy (float4)
//   and the bins only for quads with an in-window sample. It marks each
//   row it touches.
// - Scan and store, a warp a row, B / 32 bins a lane. A marked row is
//   read (and zeroed for a second pass), summed within the lane, scanned
//   across the warp with __shfl_up_sync and stored from registers with
//   vector streaming stores (st.global.cs). An unmarked row is stored as
//   zeros without touching shared memory. No serial row scan, no integer
//   division per element, and nothing spent on the rows nobody reached
//   but their store.
//
// Exactness: every count is a whole number below 2^24, so the f32 scan
// is exact in any order and the result is bitwise equal to the plain
// version whatever order the atomics and the scan take.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// Vector loads and stores of K consecutive floats (K = 1, 2, 4, 8).
template <int K>
struct Vec;
template <>
struct Vec<1> {
  __device__ static void load(const float* p, float* v) { v[0] = p[0]; }
  __device__ static void zero(float* p) { p[0] = 0.f; }
  __device__ static void store(float* p, const float* v) { __stcs(p, v[0]); }
};
template <>
struct Vec<2> {
  __device__ static void load(const float* p, float* v) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x;
    v[1] = a.y;
  }
  __device__ static void zero(float* p) {
    *reinterpret_cast<float2*>(p) = make_float2(0.f, 0.f);
  }
  __device__ static void store(float* p, const float* v) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  }
};
template <>
struct Vec<4> {
  __device__ static void load(const float* p, float* v) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
  __device__ static void zero(float* p) {
    *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ static void store(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};
template <>
struct Vec<8> {
  __device__ static void load(const float* p, float* v) {
    Vec<4>::load(p, v);
    Vec<4>::load(p + 4, v + 4);
  }
  __device__ static void zero(float* p) {
    Vec<4>::zero(p);
    Vec<4>::zero(p + 4);
  }
  __device__ static void store(float* p, const float* v) {
    Vec<4>::store(p, v);
    Vec<4>::store(p + 4, v + 4);
  }
};

// Launch geometry: features a tile (a block's pass over a tree's samples
// feeds this many histograms) and threads a block. One block a tile.
constexpr int kGroup = 4;
constexpr int kThreads = 1024;

// Shared-memory layout: the cells [kGroup][n_nodes][n_bins], 32 bits each
// (a packed pair of 16-bit counts, or one class in f32), a whole number of
// float4s as kGroup is 4; then n_nodes row marks rounded up to 16 bytes,
// and two 32-bit weight totals padded to 16 bytes.
__host__ __device__ inline int cell_words(int n_nodes, int n_bins) {
  return kGroup * n_nodes * n_bins;
}
__host__ __device__ inline int mark_stride(int n_nodes) {
  return (n_nodes + 15) & ~15;
}
__host__ __device__ inline int hist_smem(int n_nodes, int n_bins) {
  return cell_words(n_nodes, n_bins) * 4 + mark_stride(n_nodes) + 16;
}

// What a pass over the samples adds to the cells: both classes packed as
// 16-bit counts (w in the low half, wy in the high half) with integer
// atomics, or one class (w or wy) as f32.
enum Mode { kPacked = 0, kClassW = 1, kClassWy = 2 };
constexpr unsigned kHalf = 65536u;

// Whether a weight can go into a 16-bit half: a whole number below 2^16.
__device__ __forceinline__ bool small_whole(float x) {
  return x >= 0.f && x < 65536.f && x == truncf(x);
}

struct Tile {
  unsigned* cells;
  uint8_t* mark;
  const uint8_t* bin0;  // the bins of the tile's first feature
  int n, gsz, n_nodes, n_bins;
};

// One in-window sample i of row r: marks the row and adds to the cells of
// its bins in the tile's gsz features. In kPacked mode ``bad`` is set for
// a weight that is not a small whole number, and sw/swy sum the weights
// added, saturating at 2^16.
__device__ __forceinline__ void add_sample(const Tile& tl, int mode, int i,
                                           int r, float wi, float wyi,
                                           bool& bad, unsigned& sw,
                                           unsigned& swy) {
  tl.mark[r] = 1;
  const int tile_cells = tl.n_nodes * tl.n_bins;
  unsigned* c = tl.cells + r * tl.n_bins;
  if (mode == kPacked) {
    const bool ok = small_whole(wi) && small_whole(wyi);
    bad |= !ok;
    const unsigned a = ok ? static_cast<unsigned>(wi) : 0u;
    const unsigned b = ok ? static_cast<unsigned>(wyi) : 0u;
    sw = min(sw + a, kHalf);
    swy = min(swy + b, kHalf);
    const unsigned v = (b << 16) + a;
    for (int j = 0; j < tl.gsz; ++j)
      atomicAdd(c + j * tile_cells + tl.bin0[static_cast<size_t>(j) * tl.n + i],
                v);
  } else {
    const float x = mode == kClassW ? wi : wyi;
    for (int j = 0; j < tl.gsz; ++j)
      atomicAdd(reinterpret_cast<float*>(c + j * tile_cells) +
                    tl.bin0[static_cast<size_t>(j) * tl.n + i],
                x);
  }
}

// One pass of a tile over its tree's samples (rel_t, w_t, wy_t, 16-byte
// aligned from sample ``head``). In kPacked mode it adds the block's
// weight sums to totals[0..1] and returns whether a weight was not a small
// whole number.
__device__ __forceinline__ bool accumulate(const Tile& tl, int mode,
                                           const int32_t* rel_t,
                                           const float* w_t, const float* wy_t,
                                           int head, unsigned* totals) {
  const int n = tl.n;
  const int n_quads = (n - head) >> 2;
  const int tail = head + 4 * n_quads;
  const unsigned un = static_cast<unsigned>(tl.n_nodes);
  bool bad = false;
  unsigned sw = 0, swy = 0;
  // Samples before the first 16-byte boundary of the tree's row, and
  // after the last whole quad, go one at a time.
  for (int i = threadIdx.x; i < head + (n - tail); i += blockDim.x) {
    const int s = i < head ? i : tail + (i - head);
    const int r = rel_t[s];
    if (static_cast<unsigned>(r) >= un) continue;
    const float wi = w_t[s];
    if (wi == 0.f) continue;
    add_sample(tl, mode, s, r, wi, wy_t[s], bad, sw, swy);
  }
  const int4* rel4 = reinterpret_cast<const int4*>(rel_t + head);
  const float4* w4 = reinterpret_cast<const float4*>(w_t + head);
  const float4* wy4 = reinterpret_cast<const float4*>(wy_t + head);
  for (int q = threadIdx.x; q < n_quads; q += blockDim.x) {
    const int4 r = rel4[q];
    const bool in0 = static_cast<unsigned>(r.x) < un;
    const bool in1 = static_cast<unsigned>(r.y) < un;
    const bool in2 = static_cast<unsigned>(r.z) < un;
    const bool in3 = static_cast<unsigned>(r.w) < un;
    if (!(in0 | in1 | in2 | in3)) continue;
    const float4 a = w4[q];
    const float4 b = wy4[q];
    const int i = head + 4 * q;
    if (in0 && a.x != 0.f)
      add_sample(tl, mode, i, r.x, a.x, b.x, bad, sw, swy);
    if (in1 && a.y != 0.f)
      add_sample(tl, mode, i + 1, r.y, a.y, b.y, bad, sw, swy);
    if (in2 && a.z != 0.f)
      add_sample(tl, mode, i + 2, r.z, a.z, b.z, bad, sw, swy);
    if (in3 && a.w != 0.f)
      add_sample(tl, mode, i + 3, r.w, a.w, b.w, bad, sw, swy);
  }
  if (mode == kPacked) {
    sw = __reduce_add_sync(0xffffffffu, sw);
    swy = __reduce_add_sync(0xffffffffu, swy);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(totals, sw);
      atomicAdd(totals + 1, swy);
    }
  }
  return bad;
}

// The scan and store of a tile, a warp a row, K bins a lane. A marked
// row's cells are read (and zeroed for a second pass), summed within the
// lane and scanned across the warp; an unmarked row is stored as zeros. In
// kPacked mode both classes go out (to cw and cwy), otherwise the one
// class of ``mode``. ``out`` is the tile's offset in cw and cwy.
template <int K>
__device__ __forceinline__ void scan_store(const Tile& tl, int mode,
                                           float* cw, float* cwy,
                                           size_t out) {
  const int lane = threadIdx.x & 31;
  const int n_bins = tl.n_bins;
  const int tile_cells = tl.n_nodes * n_bins;
  const bool full_rows = n_bins == 32 * K;
  const bool both = mode == kPacked;
  float* dst = mode == kClassWy ? cwy : cw;
  const int lo = lane * K;
  for (int rr = threadIdx.x >> 5; rr < tl.gsz * tl.n_nodes;
       rr += blockDim.x >> 5) {
    const int j = rr / tl.n_nodes;
    const int r = rr - j * tl.n_nodes;
    float a[K], b[K];
    if (tl.mark[r]) {
      float* c = reinterpret_cast<float*>(tl.cells + j * tile_cells +
                                          r * n_bins + lo);
      float u[K];
      if (full_rows) {
        Vec<K>::load(c, u);
        Vec<K>::zero(c);
      } else {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const bool in = lo + k < n_bins;
          u[k] = in ? c[k] : 0.f;
          if (in) c[k] = 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const unsigned v = __float_as_uint(u[k]);
        a[k] = both ? __uint2float_rn(v & 0xffffu) : u[k];
        b[k] = both ? __uint2float_rn(v >> 16) : 0.f;
      }
#pragma unroll
      for (int k = 1; k < K; ++k) {
        a[k] += a[k - 1];
        b[k] += b[k - 1];
      }
      float sa = a[K - 1], sb = b[K - 1];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float xa = __shfl_up_sync(0xffffffffu, sa, o);
        const float xb = __shfl_up_sync(0xffffffffu, sb, o);
        if (lane >= o) {
          sa += xa;
          sb += xb;
        }
      }
      float ea = __shfl_up_sync(0xffffffffu, sa, 1);
      float eb = __shfl_up_sync(0xffffffffu, sb, 1);
      if (lane == 0) ea = eb = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        a[k] += ea;
        b[k] += eb;
      }
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) a[k] = b[k] = 0.f;
    }
    const size_t o = out + static_cast<size_t>(j) * tile_cells +
                     static_cast<size_t>(r) * n_bins + lo;
    if (full_rows) {
      Vec<K>::store(dst + o, a);
      if (both) Vec<K>::store(cwy + o, b);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (lo + k < n_bins) {
          __stcs(dst + o + k, a[k]);
          if (both) __stcs(cwy + o + k, b[k]);
        }
      }
    }
  }
}

// K bins a lane: K * 32 >= n_bins. One block a (tree, kGroup features)
// tile, blockIdx.x = tree * ceil(n_feat / kGroup) + feature group; dynamic
// shared memory as laid out by hist_smem.
template <int K>
__global__ void __launch_bounds__(kThreads, 1) hist_cumsum_kernel(
    const int32_t* __restrict__ rel, const float* __restrict__ w,
    const float* __restrict__ wy, const uint8_t* __restrict__ bin_t,
    float* __restrict__ cw, float* __restrict__ cwy, int n, int n_feat,
    int n_nodes, int n_bins, int trees_per_group) {
  extern __shared__ float4 smem4[];
  unsigned* cells = reinterpret_cast<unsigned*>(smem4);
  uint8_t* mark =
      reinterpret_cast<uint8_t*>(cells + cell_words(n_nodes, n_bins));
  unsigned* totals =
      reinterpret_cast<unsigned*>(mark + mark_stride(n_nodes));
  const int n_groups = (n_feat + kGroup - 1) / kGroup;
  const int tile_cells = n_nodes * n_bins;
  const int t = blockIdx.x / n_groups;
  const int f0 = (blockIdx.x - t * n_groups) * kGroup;
  const size_t row0 = static_cast<size_t>(t) * n;
  const size_t bin_set = static_cast<size_t>(t / trees_per_group);
  const Tile tl{cells, mark, bin_t + (bin_set * n_feat + f0) * n, n,
                min(kGroup, n_feat - f0), n_nodes, n_bins};
  const int32_t* rel_t = rel + row0;
  const float* w_t = w + row0;
  const float* wy_t = wy + row0;
  const int head = min(n, static_cast<int>((4 - (row0 & 3)) & 3));
  const size_t out = (static_cast<size_t>(t) * n_feat + f0) * tile_cells;

  for (int i = threadIdx.x; i < hist_smem(n_nodes, n_bins) / 16;
       i += blockDim.x)
    smem4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  const bool bad = accumulate(tl, kPacked, rel_t, w_t, wy_t, head, totals);
  if (!__syncthreads_or(bad) && totals[0] < kHalf && totals[1] < kHalf) {
    scan_store<K>(tl, kPacked, cw, cwy, out);
    return;
  }
  // A weight that is not a small whole number, or a tile whose weights
  // could overflow a 16-bit count: zero the marked rows, then add and
  // store each class on its own in f32.
  const int lane = threadIdx.x & 31;
  for (int rr = threadIdx.x >> 5; rr < tl.gsz * n_nodes;
       rr += blockDim.x >> 5) {
    const int j = rr / n_nodes;
    const int r = rr - j * n_nodes;
    if (!mark[r]) continue;
    for (int b = lane; b < n_bins; b += 32)
      cells[j * tile_cells + r * n_bins + b] = 0u;
  }
  for (int mode = kClassW; mode <= kClassWy; ++mode) {
    __syncthreads();
    accumulate(tl, mode, rel_t, w_t, wy_t, head, totals);
    __syncthreads();
    scan_store<K>(tl, mode, cw, cwy, out);
  }
}

constexpr int kMaxDevices = 64;

using Kernel = void (*)(const int32_t*, const float*, const float*,
                        const uint8_t*, float*, float*, int, int, int, int,
                        int);

int bins_per_lane(int n_bins) {
  return n_bins <= 32 ? 1 : n_bins <= 64 ? 2 : n_bins <= 128 ? 4 : 8;
}

Kernel kernel_for(int k) {
  switch (k) {
    case 1: return hist_cumsum_kernel<1>;
    case 2: return hist_cumsum_kernel<2>;
    case 4: return hist_cumsum_kernel<4>;
    default: return hist_cumsum_kernel<8>;
  }
}

// Per device and kernel instance, the largest dynamic shared memory the
// kernel was opened up to so far; the attribute is set only when a launch
// needs more.
std::atomic<int> smem_allowed[kMaxDevices][4];

int instance(int k) { return k == 1 ? 0 : k == 2 ? 1 : k == 4 ? 2 : 3; }

// Makes ``device`` current and opens the kernel instance for this window
// up to the shared memory it needs.
cudaError_t prepare(int device, int n_nodes, int n_bins) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int k = bins_per_lane(n_bins);
  const int smem = hist_smem(n_nodes, n_bins);
  if (smem <= smem_allowed[device][instance(k)].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel_for(k)),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess) smem_allowed[device][instance(k)].store(smem);
  return err;
}

}  // namespace

// Resident blocks per SM and the SM count for a launch at this window on
// CUDA device ``device``; returns a CUDA error code (0 on success).
extern "C" int hist_cumsum_occupancy(int n_nodes, int n_bins, int device,
                                     int* blocks_per_sm, int* n_sm) {
  cudaError_t err = prepare(device, n_nodes, n_bins);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel_for(bins_per_lane(n_bins)), kThreads,
        hist_smem(n_nodes, n_bins));
  return static_cast<int>(err);
}

// Launches on ``stream`` of CUDA device ``device``, one block of kThreads
// a (tree, kGroup features) tile; bin_t holds n_tree / trees_per_group
// bin sets of [n_feat, n], one for each run of trees_per_group trees.
// Returns cudaGetLastError() (0 on success). This library has its own CUDA
// runtime, whose current device is not the caller's, so the device is made
// current here. The caller allocates the outputs, checks shapes, types,
// shared memory and 16-byte alignment of rel, w and wy, and synchronises.
extern "C" int hist_cumsum_launch(const void* rel, const void* w,
                                  const void* wy, const void* bin_t, void* cw,
                                  void* cwy, int n_tree, int n, int n_feat,
                                  int n_nodes, int n_bins,
                                  int trees_per_group, int device,
                                  void* stream) {
  const cudaError_t err = prepare(device, n_nodes, n_bins);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = n_tree * ((n_feat + kGroup - 1) / kGroup);
  if (n_tiles == 0) return 0;
  kernel_for(bins_per_lane(n_bins))<<<n_tiles, kThreads,
                                      hist_smem(n_nodes, n_bins),
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rel), static_cast<const float*>(w),
      static_cast<const float*>(wy), static_cast<const uint8_t*>(bin_t),
      static_cast<float*>(cw), static_cast<float*>(cwy), n, n_feat, n_nodes,
      n_bins, trees_per_group);
  return static_cast<int>(cudaGetLastError());
}
