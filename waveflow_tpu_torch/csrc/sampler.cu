// Fused inverse-CDF sampler for Hopper (sm_90a): one exact draw per walker
// from a density built on ψ = c · T, the piecewise-linear table spline.
// Two kinds, one kernel template:
//   SQUARED  p(x) ∝ ψ(x)²          (squared-B-spline conditionals, K1)
//   LINEAR   p(x) ∝ max(ψ(x), 0)   (M-spline priors, K2)
//
// Replaces: waveflow_tpu/ops/pallas_sampler.py, `_sampler_kernel`
// (pl.pallas_call at :144) with kind='squared' (entry
// pallas_sample_squared_amplitude at :189) and kind='linear' (entry
// pallas_sample_linear_density at :205).  Same chain, same semantics:
//   ψ on the mesh = coeffs @ table            (n_bases FMAs per mesh point)
//   LINEAR only: ψ clamped at 0 before the masses
//   cell masses  SQUARED m_c = h (ψ_l² + ψ_l Δ + Δ²/3)
//                LINEAR  m_c = h (ψ_l + Δ/2)
//   inclusive prefix-sum CDF over the cells, total = cdf[n_cells - 1]
//   j = #{cells c : cdf[c] <= u · total}, clipped to [0, n_cells - 1]
//   q = u · total - cdf[j - 1]  (cdf[-1] = 0)
//   SQUARED: in-cell cubic m(s) = h (a² s + a d s² + d² s³ / 3) = q solved
//   by n_bisect bisection steps + n_newton clipped Newton steps;
//   LINEAR: in-cell quadratic h (a s + d s² / 2) = q in closed form,
//   s = (sqrt(a² + 2 d q/h) − a) / d, or q / (h a) where |d| < 1e-12,
//   clipped to [0, 1];
//   x = (j + s) h.
// The prefix sum runs in another association order than the TPU's
// Hillis-Steele lane scan and XLA's cumsum, which moves draws near cell
// edges by up to ~6e-5 (0.1 mesh cell) — the documented tolerance.
//
// What bounds it on this card: the ψ evaluation, 2 · n_bases · n_mesh flops
// per walker (~0.11 MFLOP at the flagship) and, more, the reads of the
// (n_bases, n_mesh) f32 table (224 KB at the flagship — too large to stage
// in shared memory beside the scratch, so it stays L2-resident).  Per
// walker only coeffs and u are read from HBM and one float written.  The
// design:
//   * WPB walkers share a 256-thread block, so each table element read from
//     L2 feeds WPB FMAs (threads stride the mesh: coalesced reads);
//   * ψ for those walkers lives in shared memory, never in HBM;
//   * each thread then owns CPT consecutive cells of one walker: its masses
//     and local sums stay in registers, a warp-shuffle block scan gives the
//     CDF, a block reduction gives j, and the owners of cells j - 1 and j
//     publish q, a and Δ;
//   * one thread runs the short serial in-cell solve and writes x.
// The kind is a template parameter, so each instantiation compiles to its
// own straight-line code and the SQUARED one is the kernel it was before
// the LINEAR kind was added.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CPT = 8;          // cells per thread: n_cells <= 2048
constexpr int WPB = 4;          // walkers per block
constexpr int MAX_BASES = 64;
constexpr int SQUARED = 0;
constexpr int LINEAR = 1;

__device__ __forceinline__ float cell_mass(float h, float a, float d,
                                           float s) {
  return h * (a * a * s + a * d * s * s + d * d * (s * s * s) / 3.f);
}

// closed-form root of h (a s + d s² / 2) = q in [0, 1]; the products are
// rounded one by one (no fused multiply-add), as the plain version's are
__device__ __forceinline__ float solve_linear_cell(float h, float a, float d,
                                                   float q) {
  const float qn = q / h;
  const float disc = sqrtf(fmaxf(
      __fadd_rn(__fmul_rn(a, a), __fmul_rn(__fmul_rn(2.f, d), qn)), 0.f));
  const bool flat = fabsf(d) < 1e-12f;
  const float s = flat ? qn / fmaxf(a, 1e-12f) : (disc - a) / d;
  return fminf(fmaxf(s, 0.f), 1.f);
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
sampler_kernel(const float* __restrict__ u, const float* __restrict__ coeffs,
               const float* __restrict__ table_t, float* __restrict__ out,
               int B, int n_bases, int n_mesh, float h, int n_bisect,
               int n_newton) {
  extern __shared__ float psi_s[];                 // WPB * n_mesh
  __shared__ float c_s[WPB][MAX_BASES];
  __shared__ float warp_sum[WARPS];
  __shared__ int warp_cnt[WARPS];
  __shared__ float total_s, cdf_prev_s, a_s, d_s;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int row0 = blockIdx.x * WPB;
  const int n_cells = n_mesh - 1;

  for (int i = t; i < WPB * n_bases; i += THREADS) {
    const int w = i / n_bases, j = i - w * n_bases;
    c_s[w][j] = row0 + w < B ? coeffs[static_cast<size_t>(row0 + w) * n_bases + j]
                             : 0.f;
  }
  __syncthreads();

  // ψ at every mesh point for the block's walkers: one table read per WPB FMAs
  for (int p = t; p < n_mesh; p += THREADS) {
    float acc[WPB];
#pragma unroll
    for (int w = 0; w < WPB; ++w) acc[w] = 0.f;
    for (int j = 0; j < n_bases; ++j) {
      const float tv = table_t[static_cast<size_t>(j) * n_mesh + p];
#pragma unroll
      for (int w = 0; w < WPB; ++w) acc[w] = fmaf(c_s[w][j], tv, acc[w]);
    }
#pragma unroll
    for (int w = 0; w < WPB; ++w)
      psi_s[w * n_mesh + p] = KIND == LINEAR ? fmaxf(acc[w], 0.f) : acc[w];
  }
  __syncthreads();

  const int c0 = t * CPT;  // first cell this thread owns
  for (int w = 0; w < WPB; ++w) {
    const int row = row0 + w;
    if (row >= B) break;  // uniform across the block
    const float* psi = psi_s + w * n_mesh;

    // masses of the owned cells, as running (inclusive) local sums
    float cdf[CPT];
    float local = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = c0 + i;
      float m = 0.f;
      if (c < n_cells) {
        const float pl = psi[c];
        const float d = psi[c + 1] - pl;
        if constexpr (KIND == SQUARED)
          m = h * (pl * pl + pl * d + d * d / 3.f);
        else
          m = h * (pl + 0.5f * d);
      }
      local += m;
      cdf[i] = local;
    }
    // block-wide exclusive scan of the per-thread sums
    float incl = local;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += v;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    float warp_off = 0.f;
    for (int k = 0; k < warp; ++k) warp_off += warp_sum[k];
    excl += warp_off;
#pragma unroll
    for (int i = 0; i < CPT; ++i) cdf[i] += excl;
    // total = inclusive cdf at the last cell, from its owner
    const int last = n_cells - 1;
    if (last >= c0 && last < c0 + CPT) {
#pragma unroll
      for (int i = 0; i < CPT; ++i)
        if (c0 + i == last) total_s = cdf[i];
    }
    __syncthreads();
    const float target = u[row] * total_s;

    // j = #{cells with inclusive cdf <= target}
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < CPT; ++i) cnt += (c0 + i < n_cells && cdf[i] <= target);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    if (lane == 0) warp_cnt[warp] = cnt;
    __syncthreads();
    int j = 0;
    for (int k = 0; k < WARPS; ++k) j += warp_cnt[k];
    j = min(max(j, 0), n_cells - 1);

    // owners of cells j - 1 and j publish cdf[j - 1], ψ_l and Δ
    if (j == 0 && t == 0) cdf_prev_s = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = c0 + i;
      if (c == j - 1) cdf_prev_s = cdf[i];
      if (c == j) {
        a_s = psi[c];
        d_s = psi[c + 1] - psi[c];
      }
    }
    __syncthreads();

    if (t == 0) {
      const float q = target - cdf_prev_s;
      const float a = a_s, d = d_s;
      float s;
      if constexpr (KIND == SQUARED) {
        float lo = 0.f, hi = 1.f;
        for (int it = 0; it < n_bisect; ++it) {
          const float mid = 0.5f * (lo + hi);
          if (cell_mass(h, a, d, mid) > q) hi = mid; else lo = mid;
        }
        s = 0.5f * (lo + hi);
        for (int it = 0; it < n_newton; ++it) {
          const float v = a + d * s;
          const float dm = fmaxf(h * v * v, 1e-14f);
          s = fminf(fmaxf(s - (cell_mass(h, a, d, s) - q) / dm, lo), hi);
        }
      } else {
        s = solve_linear_cell(h, a, d, q);
      }
      out[row] = (static_cast<float>(j) + s) * h;
    }
    __syncthreads();  // shared scratch is reused by the next walker
  }
}

template <int KIND>
int launch(const float* u, const float* coeffs, const float* table_t,
           float* out, int B, int n_bases, int n_mesh, float h, int n_bisect,
           int n_newton, void* stream) {
  if (B <= 0) return 0;
  if (n_mesh - 1 > THREADS * CPT || n_mesh < 2 || n_bases > MAX_BASES)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * WPB * static_cast<size_t>(n_mesh);
  cudaError_t err = cudaFuncSetAttribute(
      sampler_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (B + WPB - 1) / WPB;
  sampler_kernel<KIND>
      <<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          u, coeffs, table_t, out, B, n_bases, n_mesh, h, n_bisect, n_newton);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sampler_launch(const float* u, const float* coeffs,
                              const float* table_t, float* out, int B,
                              int n_bases, int n_mesh, float h, int n_bisect,
                              int n_newton, void* stream) {
  return launch<SQUARED>(u, coeffs, table_t, out, B, n_bases, n_mesh, h,
                         n_bisect, n_newton, stream);
}

extern "C" int sampler_linear_launch(const float* u, const float* coeffs,
                                     const float* table_t, float* out, int B,
                                     int n_bases, int n_mesh, float h,
                                     void* stream) {
  return launch<LINEAR>(u, coeffs, table_t, out, B, n_bases, n_mesh, h, 0, 0,
                        stream);
}

extern "C" const char* sampler_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
