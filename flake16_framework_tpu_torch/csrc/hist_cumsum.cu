// Cumulative per-node class histograms of one BFS step of the tree grower.
//
// Replaces the TPU kernel flake16_framework_tpu/ops/trees.py
// _hist_cumsum_kernel (launched by _pallas_cum_hists). That kernel fed the
// MXU two bf16 one-hot products per feature, [N, W] x [N, B], then
// cumsummed over bins. Here the one-hots never exist: for tree t and
// feature f,
//
//   cw[t, f, w, b]  = sum_{b' <= b} sum_n [rel[t,n] == w] * w[t,n] * [bin[f,n] == b']
//   cwy[t, f, w, b] = the same with wy[t,n]
//
// Design: one block per (feature, tree). The block keeps a [W, B] x 2 f32
// histogram in shared memory (66.5 KB at W = 128, B = 64), its threads
// stride over the samples and atomicAdd the in-window ones into it, then
// scan each row over bins in place and store the [W, B] tiles with
// coalesced writes.
//
// Bound: bytes, not operations. A step reads rel/w/wy [T, N] and the
// [F, N] uint8 bins and writes 2 x [T, F, W, B] f32; the adds are a few per
// in-window sample. The design reads each tree's sample arrays once per
// feature (the F blocks of a tree share them through L2), skips samples
// outside the window or of zero weight before touching the bins, keeps
// every partial sum on chip and writes each output element once. Rows are
// padded to B + 1 floats so the per-row scans do not conflict on banks.
//
// Exactness: weights are small integers and every per-node sum is at most
// the sample capacity (< 2^24), so the f32 sums are exact in any order and
// the result is bitwise equal to the plain version whatever order the
// atomics take.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) hist_cumsum_kernel(
    const int32_t* __restrict__ rel, const float* __restrict__ w,
    const float* __restrict__ wy, const uint8_t* __restrict__ bin_t,
    float* __restrict__ cw, float* __restrict__ cwy, int n, int n_feat,
    int n_nodes, int n_bins) {
  extern __shared__ float smem[];
  const int stride = n_bins + 1;
  const int f = blockIdx.x;
  const int t = blockIdx.y;
  const int rows = 2 * n_nodes;  // rows [0, W) hold w, rows [W, 2W) hold wy
  for (int i = threadIdx.x; i < rows * stride; i += blockDim.x) smem[i] = 0.f;
  __syncthreads();

  const int32_t* rel_t = rel + static_cast<size_t>(t) * n;
  const float* w_t = w + static_cast<size_t>(t) * n;
  const float* wy_t = wy + static_cast<size_t>(t) * n;
  const uint8_t* bin_f = bin_t + static_cast<size_t>(f) * n;
  float* hwy = smem + n_nodes * stride;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned r = static_cast<unsigned>(rel_t[i]);
    if (r >= static_cast<unsigned>(n_nodes)) continue;
    const float wi = w_t[i];
    if (wi == 0.f) continue;
    const int cell = r * stride + bin_f[i];
    atomicAdd(smem + cell, wi);
    atomicAdd(hwy + cell, wy_t[i]);
  }
  __syncthreads();

  for (int row = threadIdx.x; row < rows; row += blockDim.x) {
    float* h = smem + row * stride;
    float acc = 0.f;
    for (int b = 0; b < n_bins; ++b) {
      acc += h[b];
      h[b] = acc;
    }
  }
  __syncthreads();

  const size_t base = (static_cast<size_t>(t) * n_feat + f) * n_nodes * n_bins;
  const int tile = n_nodes * n_bins;
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int r = i / n_bins;
    const int cell = r * stride + (i - r * n_bins);
    cw[base + i] = smem[cell];
    cwy[base + i] = hwy[cell];
  }
}

constexpr int kMaxDevices = 64;

// Per device, the largest dynamic shared memory the kernel was opened up
// to so far; the attribute is set only when a launch needs more.
std::atomic<int> smem_allowed[kMaxDevices];

}  // namespace

// Launches on ``stream`` of CUDA device ``device``; returns
// cudaGetLastError() (0 on success). This library has its own CUDA runtime,
// whose current device is not the caller's, so the device is made current
// here. The caller allocates the outputs, checks shapes and types, and
// synchronises.
extern "C" int hist_cumsum_launch(const void* rel, const void* w,
                                  const void* wy, const void* bin_t, void* cw,
                                  void* cwy, int n_tree, int n, int n_feat,
                                  int n_nodes, int n_bins, int device,
                                  void* stream) {
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = 2 * n_nodes * (n_bins + 1) * static_cast<int>(sizeof(float));
  if (smem > smem_allowed[device].load()) {
    err = cudaFuncSetAttribute(hist_cumsum_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_allowed[device].store(smem);
  }
  const dim3 grid(n_feat, n_tree);
  hist_cumsum_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rel), static_cast<const float*>(w),
      static_cast<const float*>(wy), static_cast<const uint8_t*>(bin_t),
      static_cast<float*>(cw), static_cast<float*>(cwy), n, n_feat, n_nodes,
      n_bins);
  return static_cast<int>(cudaGetLastError());
}
