// Path-dependent Tree SHAP for one cap bucket of work items.
//
// Replaces the TPU kernel flake16_framework_tpu/ops/treeshap.py _unit_kernel
// (body _unit_block_math, launched by _unit_partials). A work item is one
// root-to-leaf path of one tree in compact form: ``cap`` slots whose live
// prefix [0, u) holds a unique feature fid, its zero fraction z and the
// interval (lo, hi] the path allows it, plus the leaf's class-0 probability
// ``scale``. For work item r and sample s:
//
//   o_k = (x[s, fid_k] > lo_k) & (x[s, fid_k] <= hi_k)   for each live slot
//   EXTEND over the live slots gives the permutation weights w[0..u]
//   UNWIND of slot k gives total_k;  partial[c, fid_k, s] += (o_k - z_k) * total_k * scale
//
// where c is the chunk of work items the row belongs to.
//
// Bound: f32 operations, not bytes. Each (work item, sample) pair costs
// O(u^2) multiplies and IEEE divisions, and the inputs (a few floats per
// slot, [S, F] samples) are tiny beside that. The TPU kernel selected rows
// with one-hot masks and HIGHEST-precision dots, because that is what
// Mosaic lowers safely; here every slot is indexed directly, so none of
// that extra arithmetic exists:
//   - one thread per sample; a block covers kTile samples and one chunk of
//     work items, staged kStage at a time in shared memory, so all threads
//     of a block walk the same path and every branch on u is uniform;
//   - the kernel is templated on the bucket's cap rounded up to a power of
//     two, so the weights w[CAP + 2] sit in registers (every index into
//     them is a compile-time constant after unrolling); u is read at run
//     time, so caps 6 and 7 run in the 8 instance;
//   - the slot -> feature scatter goes to a [F][kTile] accumulator in
//     shared memory (a register array indexed by fid would spill), each
//     thread its own column, so there are no bank conflicts and no atomics.
//
// Output is deterministic: each block writes its chunk's partial
// [n_chunks, F, S] once, and the caller sums the chunk axis in a fixed
// order. Division stays IEEE (no fast math).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;    // samples a block, one a thread
constexpr int kStage = 32;    // work items staged in shared memory at a time
constexpr int kMaxFeat = 16;  // Flake16 is the widest feature set
constexpr float kZMin = 1e-30f;

template <int CAP>
__global__ void __launch_bounds__(kTile) treeshap_unit_kernel(
    const int32_t* __restrict__ fid, const float* __restrict__ z,
    const float* __restrict__ lo, const float* __restrict__ hi,
    const int32_t* __restrict__ u, const float* __restrict__ scale,
    const float* __restrict__ x, float* __restrict__ partial, int n_rows,
    int cap, int n_samples, int n_feat, int chunk) {
  __shared__ float xs[kMaxFeat][kTile];
  __shared__ float acc[kMaxFeat][kTile];
  __shared__ int s_fid[kStage][CAP];
  __shared__ float s_z[kStage][CAP];
  __shared__ float s_lo[kStage][CAP];
  __shared__ float s_hi[kStage][CAP];
  __shared__ int s_u[kStage];
  __shared__ float s_scale[kStage];

  const int tid = threadIdx.x;
  const int s = blockIdx.x * kTile + tid;
  const bool in_range = s < n_samples;
  // xs and acc are per-thread columns: only thread tid touches [.][tid].
  for (int f = 0; f < n_feat; ++f) {
    xs[f][tid] = in_range ? x[static_cast<size_t>(s) * n_feat + f] : 0.f;
    acc[f][tid] = 0.f;
  }

  const int row0 = blockIdx.y * chunk;
  const int row1 = min(row0 + chunk, n_rows);
  for (int base = row0; base < row1; base += kStage) {
    const int n_stage = min(kStage, row1 - base);
    __syncthreads();  // the previous stage is consumed
    for (int i = tid; i < n_stage * cap; i += kTile) {
      const int p = i / cap;
      const int k = i - p * cap;
      const size_t g = static_cast<size_t>(base + p) * cap + k;
      s_fid[p][k] = fid[g];
      s_z[p][k] = z[g];
      s_lo[p][k] = lo[g];
      s_hi[p][k] = hi[g];
    }
    for (int p = tid; p < n_stage; p += kTile) {
      s_u[p] = min(max(u[base + p], 0), cap);
      s_scale[p] = scale[base + p];
    }
    __syncthreads();

    for (int p = 0; p < n_stage; ++p) {
      const int uu = s_u[p];  // uniform over the block
      if (uu == 0) continue;  // dead rows add nothing

      unsigned omask = 0;  // one fractions of the live slots, as bits
      for (int k = 0; k < uu; ++k) {
        const float xv = xs[s_fid[p][k]][tid];
        if (xv > s_lo[p][k] && xv <= s_hi[p][k]) omask |= 1u << k;
      }

      // EXTEND: w[i] <- z w[i] (l - i) / (l + 1) + o w[i-1] i / (l + 1),
      // high positions first so w[i-1] is still the old value. Positions
      // above k + 1 are zero before and after step k.
      float w[CAP + 2];
#pragma unroll
      for (int i = 0; i < CAP + 2; ++i) w[i] = 0.f;
      w[0] = 1.f;
      float l = 1.f;
      for (int k = 0; k < uu; ++k) {
        const float zk = s_z[p][k];
        const float ok = ((omask >> k) & 1u) ? 1.f : 0.f;
        const float lp1 = l + 1.f;
#pragma unroll
        for (int i = CAP + 1; i >= 0; --i) {
          if (i <= k + 1) {
            const float stay = zk * w[i] * (l - static_cast<float>(i)) / lp1;
            float up = 0.f;
            if (i > 0)
              up = ok * w[i > 0 ? i - 1 : 0] * static_cast<float>(i) / lp1;
            w[i] = stay + up;
          }
        }
        l = lp1;
      }

      float w_last = 0.f;  // w[l - 1] = w[uu]
#pragma unroll
      for (int i = 1; i <= CAP; ++i)
        if (i == uu) w_last = w[i];

      // UNWIND each live slot: positions j = l - 2 .. 0.
      const float sc = s_scale[p];
      for (int k = 0; k < uu; ++k) {
        const float zk = s_z[p][k];
        const float zs = fmaxf(zk, kZMin);
        const bool o1 = (omask >> k) & 1u;
        float total = 0.f;
        float nxt = w_last;
#pragma unroll
        for (int j = CAP - 1; j >= 0; --j) {
          if (j < uu) {
            const float wj = w[j];
            const float lm1j = (l - 1.f) - static_cast<float>(j);
            if (o1) {
              const float tmp = nxt * l / (static_cast<float>(j) + 1.f);
              total += tmp;
              nxt = wj - tmp * zs * lm1j / l;
            } else {
              total += wj * l / (zs * lm1j);
            }
          }
        }
        acc[s_fid[p][k]][tid] += ((o1 ? 1.f : 0.f) - zk) * total * sc;
      }
    }
  }

  if (in_range) {
    float* out = partial + static_cast<size_t>(blockIdx.y) * n_feat * n_samples;
    for (int f = 0; f < n_feat; ++f)
      out[static_cast<size_t>(f) * n_samples + s] = acc[f][tid];
  }
}

template <int CAP>
void launch(const dim3& grid, cudaStream_t stream, const void* fid,
            const void* z, const void* lo, const void* hi, const void* u,
            const void* scale, const void* x, void* partial, int n_rows,
            int cap, int n_samples, int n_feat, int chunk) {
  treeshap_unit_kernel<CAP><<<grid, kTile, 0, stream>>>(
      static_cast<const int32_t*>(fid), static_cast<const float*>(z),
      static_cast<const float*>(lo), static_cast<const float*>(hi),
      static_cast<const int32_t*>(u), static_cast<const float*>(scale),
      static_cast<const float*>(x), static_cast<float*>(partial), n_rows, cap,
      n_samples, n_feat, chunk);
}

}  // namespace

// Launches on ``stream`` of CUDA device ``device``; returns
// cudaGetLastError() (0 on success). fid, z, lo, hi are [n_rows, cap]
// row-major, u and scale [n_rows], x [n_samples, n_feat], partial
// [ceil(n_rows / chunk), n_feat, n_samples]. The caller allocates, checks
// shapes and types, and sums the chunk axis.
extern "C" int treeshap_unit_launch(const void* fid, const void* z,
                                    const void* lo, const void* hi,
                                    const void* u, const void* scale,
                                    const void* x, void* partial, int n_rows,
                                    int cap, int n_samples, int n_feat,
                                    int chunk, int device, void* stream) {
  if (cap < 1 || cap > 16 || n_feat < 1 || n_feat > kMaxFeat || chunk < 1 ||
      n_rows < 1 || n_samples < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_samples + kTile - 1) / kTile, (n_rows + chunk - 1) / chunk);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cap <= 2)
    launch<2>(grid, st, fid, z, lo, hi, u, scale, x, partial, n_rows, cap,
              n_samples, n_feat, chunk);
  else if (cap <= 4)
    launch<4>(grid, st, fid, z, lo, hi, u, scale, x, partial, n_rows, cap,
              n_samples, n_feat, chunk);
  else if (cap <= 8)
    launch<8>(grid, st, fid, z, lo, hi, u, scale, x, partial, n_rows, cap,
              n_samples, n_feat, chunk);
  else
    launch<16>(grid, st, fid, z, lo, hi, u, scale, x, partial, n_rows, cap,
               n_samples, n_feat, chunk);
  return static_cast<int>(cudaGetLastError());
}
