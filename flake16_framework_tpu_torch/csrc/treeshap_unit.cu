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
// Bound: f32 issue slots. Each (work item, sample) pair needs O(u^2)
// multiply-adds on a few registers, and the inputs (a few floats per slot,
// [S, F] samples) are tiny beside that. The reference divides inside every
// per-sample loop, but every divisor depends only on the step, the position,
// u and the slot's z, never on the sample. So nothing per sample divides:
//   - EXTEND runs in the scaled basis q[i] = w[i] (k + 1)! / i! (after k
//     steps), where step k is q[i] <- z_k (k + 1 - i) q[i] + o_k q[i - 1]:
//     one FMA a position, with z_k (k + 1 - i) precomputed once per path in
//     shared memory; w[j] = q[j] F_u[j] at the end, F_u[j] = j! / (u + 1)!.
//   - UNWIND of an o = 1 slot is total += nxt C_u[j];
//     nxt = w[j] - nxt D[k][j] with C_u[j] = (u + 1) / (j + 1) and
//     D[k][j] = zs_k (u - j) / (j + 1) (zs = max(z, 1e-30)): two FMAs a
//     position. An o = 0 slot's total is S0 / zs_k with one shared
//     S0 = sum_j w[j] H_u[j], H_u[j] = (u + 1) / (u - j), so its
//     contribution is S0 * (-z_k / zs_k * scale), the factor per path.
//   - The per-u tables C, E = (u - j) / (j + 1), H and F come from the
//     wrapper (kernels/treeshap_unit.py::unit_tables) as one kernel parameter,
//     so the compiler reads them from the constant bank as FFMA operands.
//   - The body is instantiated for every exact u in 1..16 and dispatched
//     per staged row by a block-uniform test of u: every loop has a constant
//     trip count, w stays in registers and no position is visited that u
//     does not need. The wrapper sorts a bucket's rows by u, so a chunk
//     holds one u, or a few.
//   - Each slot's o = 1 recursion runs branch-free in every lane and the
//     result is selected by o; a warp skips it only when no lane has o = 1.
//   - One thread per sample; a block covers kTile samples and one chunk of
//     work items, kStage at a time in shared memory, so all threads of a
//     block walk the same path and every coefficient is warp-uniform. The
//     slot -> feature scatter goes to a [F][kTile] shared accumulator, each
//     thread its own column: no bank conflicts and no atomics.
//
// Output is deterministic: each block writes its chunk's partial
// [n_chunks, F, S] once, and the caller sums the chunk axis in a fixed
// order. Every operation is IEEE (no fast math); the one reciprocal per
// (path, slot) is __frcp_rn.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;    // samples a block, one a thread
constexpr int kMaxCap = 16;   // widest work item
constexpr int kStage = 8;     // work items staged in shared memory at a time
constexpr int kMaxFeat = 16;  // Flake16 is the widest feature set
constexpr float kZMin = 1e-30f;
static_assert(kStage * kMaxCap == kTile, "one (row, slot) a thread");

// Rows of the coefficient tables, each [u][j] for u in 0..16 (row 0 unused).
enum { kC = 0, kE = 1, kH = 2, kF = 3, kTables = 4 };
struct Tables {
  float v[kTables][kMaxCap + 1][kMaxCap + 1];
};

// Offset of EXTEND step k's row z_k (k + 1 - i), i = 0..k, in a path's
// coefficients; rows are padded to 4 floats so they load as float4.
__host__ __device__ constexpr int zm_off(int k) {
  return 4 * (k + 2 * (k / 4) * (k / 4 - 1) + (k % 4) * (k / 4));
}
constexpr int kZmLen = zm_off(kMaxCap);  // 160

__shared__ float xs[kMaxFeat][kTile];
__shared__ float acc[kMaxFeat][kTile];
__shared__ int s_fid[kStage][kMaxCap];
__shared__ float s_lo[kStage][kMaxCap];
__shared__ float s_hi[kStage][kMaxCap];
__shared__ int s_u[kStage];
__shared__ __align__(16) float s_zm[kStage][kZmLen];          // z_k (k+1-i)
__shared__ __align__(16) float s_d[kStage][kMaxCap][kMaxCap];  // zs_k E_u[j]
__shared__ float s_r1[kStage][kMaxCap];  // (1 - z_k) scale
__shared__ float s_r0[kStage][kMaxCap];  // -(z_k / zs_k) scale

// One staged path of exactly N live slots against this thread's sample.
template <int N>
__device__ __forceinline__ void walk(const Tables& tab, int p, int tid) {
  const float* tc = tab.v[kC][N];
  const float* th = tab.v[kH][N];
  const float* tf = tab.v[kF][N];

  unsigned om = 0;  // one fractions of the live slots, as bits
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float xv = xs[s_fid[p][k]][tid];
    if (xv > s_lo[p][k] && xv <= s_hi[p][k]) om |= 1u << k;
  }

  // EXTEND in the scaled basis; positions above k + 1 are zero at step k.
  float w[N + 1];
  w[0] = 1.f;
#pragma unroll
  for (int i = 1; i <= N; ++i) w[i] = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const bool ok = (om >> k) & 1u;
    const float* zm = &s_zm[p][zm_off(k)];
    w[k + 1] = ok ? w[k] : 0.f;
#pragma unroll
    for (int i = k; i >= 1; --i) w[i] = fmaf(zm[i], w[i], ok ? w[i - 1] : 0.f);
    w[0] *= zm[0];
  }
#pragma unroll
  for (int j = 0; j <= N; ++j) w[j] *= tf[j];

  // The o = 0 slots share one sum.
  float s0 = 0.f;
#pragma unroll
  for (int j = N - 1; j >= 0; --j) s0 = fmaf(w[j], th[j], s0);

  // UNWIND each live slot.
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const bool ok = (om >> k) & 1u;
    float total = 0.f;
    if (__any_sync(0xffffffffu, ok)) {
      const float* d = s_d[p][k];
      float nxt = w[N];
#pragma unroll
      for (int j = N - 1; j >= 0; --j) {
        total = fmaf(nxt, tc[j], total);
        nxt = fmaf(-nxt, d[j], w[j]);
      }
    }
    acc[s_fid[p][k]][tid] += ok ? total * s_r1[p][k] : s0 * s_r0[p][k];
  }
}

template <int N>
__device__ __forceinline__ void walk_exact(const Tables& tab, int p, int uu,
                                           int tid) {
  if (uu == N) {
    walk<N>(tab, p, tid);
  } else if constexpr (N > 1) {
    walk_exact<N - 1>(tab, p, uu, tid);
  }
}

__global__ void __launch_bounds__(kTile) treeshap_unit_kernel(
    const __grid_constant__ Tables tab, const int32_t* __restrict__ fid,
    const float* __restrict__ z, const float* __restrict__ lo,
    const float* __restrict__ hi, const int32_t* __restrict__ u,
    const float* __restrict__ scale, const float* __restrict__ x,
    float* __restrict__ partial, int n_rows, int cap, int n_samples,
    int n_feat, int chunk) {
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
  // Thread tid stages slot sk of staged row sp and its coefficients.
  const int sp = tid / kMaxCap;
  const int sk = tid % kMaxCap;
  for (int base = row0; base < row1; base += kStage) {
    const int n_stage = min(kStage, row1 - base);
    __syncthreads();  // the previous stage is consumed
    if (sp < n_stage) {
      const int r = base + sp;
      const int uu = min(max(u[r], 0), cap);
      if (sk == 0) s_u[sp] = uu;
      if (sk < uu) {
        const size_t g = static_cast<size_t>(r) * cap + sk;
        s_fid[sp][sk] = fid[g];
        s_lo[sp][sk] = lo[g];
        s_hi[sp][sk] = hi[g];
        const float zk = z[g];
        const float zs = fmaxf(zk, kZMin);
        const float sc = scale[r];
        s_r1[sp][sk] = (1.f - zk) * sc;
        s_r0[sp][sk] = -(zk * __frcp_rn(zs)) * sc;
        float* zm = &s_zm[sp][zm_off(sk)];
        for (int i = 0; i <= sk; ++i)
          zm[i] = zk * static_cast<float>(sk + 1 - i);
        for (int j = 0; j < uu; ++j) s_d[sp][sk][j] = zs * tab.v[kE][uu][j];
      }
    }
    __syncthreads();

    for (int p = 0; p < n_stage; ++p) {
      // s_u is uniform over the block; dead rows (u = 0) add nothing.
      walk_exact<kMaxCap>(tab, p, s_u[p], tid);
    }
  }

  if (in_range) {
    float* out = partial + static_cast<size_t>(blockIdx.y) * n_feat * n_samples;
    for (int f = 0; f < n_feat; ++f)
      out[static_cast<size_t>(f) * n_samples + s] = acc[f][tid];
  }
}

}  // namespace

// Launches on ``stream`` of CUDA device ``device``; returns
// cudaGetLastError() (0 on success). ``tables`` is a host pointer to the
// [4][17][17] f32 coefficient tables (C, E, H, F by u and j); fid, z, lo,
// hi are [n_rows, cap] row-major, u and scale [n_rows], x [n_samples,
// n_feat], partial [ceil(n_rows / chunk), n_feat, n_samples]. The caller
// allocates, checks shapes and types, and sums the chunk axis.
extern "C" int treeshap_unit_launch(const void* tables, const void* fid,
                                    const void* z, const void* lo,
                                    const void* hi, const void* u,
                                    const void* scale, const void* x,
                                    void* partial, int n_rows, int cap,
                                    int n_samples, int n_feat, int chunk,
                                    int device, void* stream) {
  if (cap < 1 || cap > kMaxCap || n_feat < 1 || n_feat > kMaxFeat ||
      chunk < 1 || n_rows < 1 || n_samples < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_samples + kTile - 1) / kTile, (n_rows + chunk - 1) / chunk);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  const Tables tab = *static_cast<const Tables*>(tables);
  treeshap_unit_kernel<<<grid, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      tab, static_cast<const int32_t*>(fid), static_cast<const float*>(z),
      static_cast<const float*>(lo), static_cast<const float*>(hi),
      static_cast<const int32_t*>(u), static_cast<const float*>(scale),
      static_cast<const float*>(x), static_cast<float*>(partial), n_rows, cap,
      n_samples, n_feat, chunk);
  return static_cast<int>(cudaGetLastError());
}
