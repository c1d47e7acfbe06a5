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
// What bounds it on this card: instruction issue on the SIMT pipes.  The ψ
// evaluation is 2 · n_bases · n_mesh f32 flops per walker (~0.11 MFLOP at
// the flagship), and the cell masses, the scan and the locate add ~25
// instructions for each of the ~2000 cells; per walker only coeffs and u are
// read from device memory and one float written.  What kept the first
// version 7x above the FMA bound was the reads around the FMAs: every block
// of 4 walkers pulled the whole (n_bases, n_mesh) table (224 KB at the
// flagship) from L2 again, one global and four shared loads fed four FMAs, ψ
// went through shared memory, every cell mass paid an IEEE division, and the
// block waited on one thread's serial in-cell solve for every walker.  The
// design:
//   * the table lives in shared memory, loaded ONCE per persistent block
//     (one block per SM, grid-stride over groups of G walkers) by 1-D bulk
//     copies, one per basis row, onto one mbarrier; ψ never goes to shared
//     memory, which is what makes room for the table;
//   * a "half" of 256 threads owns the whole mesh for W walkers: each
//     thread owns CPT = 8 consecutive mesh points and cells from the start
//     and accumulates ψ at its points for the W walkers in registers
//     (acc[W][8], summed over the bases in ascending order with fmaf),
//     reading per basis two 16-byte table loads and the W coefficients as
//     one broadcast load, one basis ahead of the FMAs — 3 shared loads per
//     8 W FMAs.  Half the lanes read their two 16-byte halves in the other
//     order, so that a quarter-warp touches 32 different banks; the halves
//     are put back once, after the loop.  ψ at the thread's ninth point (the
//     right edge of its last cell) is the next thread's first: one shuffle
//     per walker, one shared word per warp boundary.  Groups of 8 walkers
//     run as two halves (512 threads, 4 walkers each) in step, sharing the
//     table and the barriers: twice the warps to hide latency with, at
//     half the registers per thread;
//   * the masses and the running sums stay in registers; the scan keeps the
//     first version's association order (8-cell serial sums, Hillis-Steele
//     warp scan, warp offsets added in order), so the draws are unchanged;
//     a half's W walkers go through it together and share its three block
//     barriers; the total is rebuilt by every thread from the owner's two
//     published terms in the owner's order, which saves a barrier; Δ²/3 is
//     a product and a fused correction that round as the division does;
//   * the in-cell solves are deferred: (j, target, cdf[j-1]) of each walker
//     go into a ring of 256 entries, and when it is full (and at the end)
//     one thread per entry rebuilds ψ_l and Δ of its cell from the table
//     (the mesh loop's sum, so the same bits) and solves it — 256 walkers at
//     once, and nobody waits on a serial solve per group;
//   * the next group's coefficients are prefetched into registers while the
//     current group is computed.
// Measured on an H100 at 65,536 walkers, the mesh loop and the cell work
// take about the same time (~0.2 ms each); the cell work is bound by its
// instruction count (~300 per walker and thread), the mesh loop runs at ~65%
// of the FMA rate with 16 warps per SM.  Together ~3.2x the FMA bound
// (PERF.md).
// Kind LINEAR (K2, 16 bases at the density model's prior, 20,000 walkers):
// the masses are cheap (h (ψ_l + Δ/2), no third()) and the table is 128 KB,
// but the kernel is bound the same way.  Taken apart on that card (PERF.md):
// cell work 42% of the time, mesh loop 34%, table fill, staging, solves and
// launch the rest; the mesh loop's loads 2%; the three barriers of the cell
// work 8%; within the cell work the unswap and clamp of ψ, the warp scan and
// the compares of the locate 4% each — no piece is large.  The SASS holds
// ~670 instructions of cell work and ~600 of mesh loop per thread and group
// of 4 walkers, executed at about half the peak rate.  What was tried for
// it and measured: halves as independent workers with named barriers of
// their own, also skewed by a fraction of a group
// (no gain with two, 4% with three, which spill at 80 registers); a
// warp-uniform shortcut in the locate (5% slower: the vote and the second
// pass cost more than the compares they save); three halves in step (no
// gain); the warps' sums added in order once per warp by a chain of shuffles
// over lanes instead of 14 additions per walker in every thread (2% with
// 16 warps, 4% slower with 8: not kept).  What stayed, for both kinds and
// with the draws unchanged to the bit: the counts of the locate are reduced
// by one warp-wide integer reduction (redux) instead of five shuffle steps
// (on an NVIDIA H100 80GB HBM3 at 700.00 W by CUDA events: LINEAR at 20,000
// walkers 0.0930 -> 0.0897 ms, SQUARED at 65,536 0.4014 -> 0.3940 ms;
// PERF.md names the runs).  The operations bound (0.0221 ms) counts 5 operations per cell
// where the kernel executes ~20, and getting nearer needs another algorithm
// for the cell work, not a schedule.
// Not here: tensor cores for the ψ product.  The path needs f32 accuracy
// (TF32 keeps ~3 digits); a split-TF32 wgmma version is worth a look only
// once this SIMT kernel sits at its FMA bound.
// The kind, W and the number of halves are template parameters, so each
// instantiation compiles to its own straight-line code.  The launch plan (G,
// grid, threads, dynamic shared bytes) comes from ops/cuda_sampler.py::plan;
// a table that does not fit the block's shared memory is streamed: the same
// kernel with the table left in device memory and read through L1/L2 in the
// mesh loop (the first version's traffic; the price of a wider basis).

#include <cuda_runtime.h>

#include "hopper_copy.cuh"

namespace {

constexpr int HALF_THREADS = 256;  // the threads that own one mesh
constexpr int WARPS = HALF_THREADS / 32;
constexpr int CPT = 8;          // cells per thread: n_cells <= 2048
constexpr int CREG = 2;         // prefetch registers: G * n_bases <= 2 * threads
constexpr int RING = 256;       // deferred in-cell solves, one per thread
constexpr int SQUARED = 0;
constexpr int LINEAR = 1;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// floats of the staged table: the rows back to back, padded so that every
// thread may read its 8 points of the last row
__host__ __device__ constexpr int table_floats(int n_bases, int n_mesh) {
  return round4(n_bases * n_mesh + (HALF_THREADS * CPT > n_mesh
                                       ? HALF_THREADS * CPT - n_mesh
                                       : 0));
}

// dynamic shared bytes; ops/cuda_sampler.py::plan computes the same number
// for groups of G walkers; without the table where it is streamed
__host__ __device__ constexpr long long smem_bytes(int n_bases, int n_mesh,
                                                   int G, bool staged) {
  return 4LL * ((staged ? table_floats(n_bases, n_mesh) : 0) +
                round4(n_bases * G) +
                G * (3 * WARPS + 4) + 3 * RING) + 16;
}

// x / 3 rounded as the division rounds it, without dividing: the product
// with RN(1/3), then one fused correction of its residual (Markstein).  The
// division costs ~25 instructions, and there is one for each of a walker's
// ~2000 cell masses (0.23 ms of 0.78 at 65,536 walkers before it went).
__device__ __forceinline__ float third(float x) {
  const float q = __fmul_rn(x, 0.333333343f);
  return fmaf(fmaf(-3.f, q, x), 0.333333343f, q);
}

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

// The masses of a thread's CPT cells from ψ at their CPT + 1 edges, as
// running sums in cdf; returns the last.  CHECK: cells from n_valid on lie
// past the mesh and carry no mass (whatever their ψ holds).
template <int KIND, bool CHECK>
__device__ __forceinline__ float running_masses(const float (&psi)[CPT + 1],
                                                float (&cdf)[CPT], float h,
                                                int n_valid) {
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const float pl = psi[i];
    const float d = psi[i + 1] - pl;
    float m;
    if constexpr (KIND == SQUARED)
      m = h * (pl * pl + pl * d + third(__fmul_rn(d, d)));
    else
      m = h * (pl + 0.5f * d);
    if (CHECK && i >= n_valid) m = 0.f;
    run = __fadd_rn(run, m);  // never fused with the product that made m
    cdf[i] = run;
  }
  return run;
}

template <int KIND>
__device__ __forceinline__ float solve_cell(float h, float a, float d, float q,
                                            int n_bisect, int n_newton) {
  if constexpr (KIND == SQUARED) {
    float lo = 0.f, hi = 1.f;
    for (int it = 0; it < n_bisect; ++it) {
      const float mid = 0.5f * (lo + hi);
      if (cell_mass(h, a, d, mid) > q) hi = mid; else lo = mid;
    }
    float s = 0.5f * (lo + hi);
    for (int it = 0; it < n_newton; ++it) {
      const float v = a + d * s;
      const float dm = fmaxf(h * v * v, 1e-14f);
      s = fminf(fmaxf(s - (cell_mass(h, a, d, s) - q) / dm, lo), hi);
    }
    return s;
  } else {
    return solve_linear_cell(h, a, d, q);
  }
}

// One block: HALVES x 256 threads.  A half owns the whole mesh (8 cells per
// thread) for W of the group's G = HALVES * W walkers; the halves run in step
// and share the table, the barriers and the ring.
// STAGED = false is the same kernel for a table too large for shared memory:
// the table stays where it is and the mesh loop reads it through L1/L2.
template <int KIND, int W, int HALVES, bool STAGED>
__global__ void __launch_bounds__(HALF_THREADS * HALVES, 1)
sampler_kernel(const float* __restrict__ u, const float* __restrict__ coeffs,
               const float* __restrict__ table_t, float* __restrict__ out,
               int B, int n_bases, int n_mesh, float h, int n_bisect,
               int n_newton) {
  constexpr int THREADS = HALF_THREADS * HALVES;
  constexpr int G = W * HALVES;
  extern __shared__ __align__(16) unsigned char smem[];
  float* tab_s = reinterpret_cast<float*>(smem);    // the table, row by row
  float* c_s = tab_s + (STAGED ? table_floats(n_bases, n_mesh) : 0);
                                                          // [n_bases][G]
  const float* tab = STAGED ? tab_s : table_t;
  float* wsum_s = c_s + round4(n_bases * G);              // [G][WARPS]
  int* wcnt_s = reinterpret_cast<int*>(wsum_s + G * WARPS);  // [G][WARPS]
  float* first_s = reinterpret_cast<float*>(wcnt_s + G * WARPS);
                                          // [G][WARPS + 1] ψ at warp edges
  float* u_s = first_s + G * (WARPS + 1);                 // [G]
  float* run_last_s = u_s + G;             // [G] last cell: in-thread sum
  float* excl_last_s = run_last_s + G;     // [G] last cell: in-warp offset
  float* ring_tgt = excl_last_s + G;       // [RING] u · total
  float* ring_prev = ring_tgt + RING;      // [RING] cdf[j - 1]
  int* ring_j = reinterpret_cast<int*>(ring_prev + RING);  // [RING]
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring_j + RING);

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = (t >> 5) % WARPS;   // within the half
  const int w0 = t / HALF_THREADS * W;  // first walker of this half
  const int n_cells = n_mesh - 1;
  const int last = n_cells - 1;
  const int n_groups = (B + G - 1) / G;
  const bool vec = (n_mesh & 3) == 0;  // rows 16-byte aligned: bulk copies
  const int c0 = t % HALF_THREADS * CPT;  // first point and cell of the thread
  const bool all_cells = c0 + CPT <= n_cells;  // none of them past the mesh

  // coefficients and uniforms of a group, fetched one group ahead: element
  // i of the group's (G, n_bases) block belongs to walker cw and goes to
  // c_s[cdst]
  float cpre[CREG];
  int cw[CREG], cdst[CREG];
#pragma unroll
  for (int q = 0; q < CREG; ++q) {
    const int i = t + q * THREADS;
    cw[q] = i < G * n_bases ? i / n_bases : G;     // G: no element
    cdst[q] = (i - cw[q] * n_bases) * G + cw[q];
  }
  float upre = 0.f;
  auto prefetch = [&](int g) {
    const size_t base = static_cast<size_t>(g) * G * n_bases;
#pragma unroll
    for (int q = 0; q < CREG; ++q) {
      cpre[q] = 0.f;
      if (g < n_groups && cw[q] < G && g * G + cw[q] < B)
        cpre[q] = coeffs[base + t + q * THREADS];
    }
    upre = (g < n_groups && t < G && g * G + t < B) ? u[g * G + t] : 0.f;
  };
  prefetch(blockIdx.x);

  if (STAGED && vec) {
    if (t == 0) {
      hopper::mbar_init(bar);
      hopper::mbar_expect_tx(bar, sizeof(float) * n_bases * n_mesh);
      for (int j = 0; j < n_bases; ++j)
        hopper::bulk_copy_g2s(tab_s + j * n_mesh,
                              table_t + static_cast<size_t>(j) * n_mesh,
                              sizeof(float) * n_mesh, bar);
    }
  } else if (STAGED) {
    for (int i = t; i < n_bases * n_mesh; i += THREADS) tab_s[i] = table_t[i];
  }

  // half the lanes read their two 16-byte halves in the other order
  const bool swap = (lane >> 2) & 1;
  const float* pa = tab_s + c0 + (swap ? 4 : 0);
  const float* pb = tab_s + c0 + (swap ? 0 : 4);
  const float* pc = c_s + w0;

  int slot = 0;                  // ring entries in use
  int g_first = blockIdx.x;      // group of ring entry 0
  for (int g = blockIdx.x; g < n_groups; g += gridDim.x) {
#pragma unroll
    for (int q = 0; q < CREG; ++q)
      if (cw[q] < G) c_s[cdst[q]] = cpre[q];
    if (t < G) u_s[t] = upre;
    __syncthreads();
    prefetch(g + gridDim.x);
    if (STAGED && vec && g == blockIdx.x) hopper::mbar_wait(bar, 0);

    // ψ at the thread's 8 points for its half's W walkers
    float acc[W][CPT];
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int i = 0; i < CPT; ++i) acc[w][i] = 0.f;
    // table values and coefficients of basis j, read one basis ahead
    auto load = [&](int j, float (&ta)[4], float (&tb)[4], float (&c)[W]) {
      if (!STAGED) {
        // points past the mesh are not read; their cells carry no mass
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qa = c0 + (swap ? 4 : 0) + i, qb = c0 + (swap ? 0 : 4) + i;
          ta[i] = qa < n_mesh ? __ldg(table_t + j * n_mesh + qa) : 0.f;
          tb[i] = qb < n_mesh ? __ldg(table_t + j * n_mesh + qb) : 0.f;
        }
      } else if (vec) {
        const float4 va = *reinterpret_cast<const float4*>(pa + j * n_mesh);
        const float4 vb = *reinterpret_cast<const float4*>(pb + j * n_mesh);
        ta[0] = va.x; ta[1] = va.y; ta[2] = va.z; ta[3] = va.w;
        tb[0] = vb.x; tb[1] = vb.y; tb[2] = vb.z; tb[3] = vb.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ta[i] = pa[j * n_mesh + i];
          tb[i] = pb[j * n_mesh + i];
        }
      }
      if constexpr (W == 4) {
        const float4 v = *reinterpret_cast<const float4*>(pc + j * G);
        c[0] = v.x; c[1] = v.y; c[2] = v.z; c[3] = v.w;
      } else {
        static_assert(W == 2, "a half takes 2 or 4 walkers");
        const float2 v = *reinterpret_cast<const float2*>(pc + j * G);
        c[0] = v.x; c[1] = v.y;
      }
    };
    float ta[4], tb[4], c[W];
    load(0, ta, tb, c);
#pragma unroll 4
    for (int j = 0; j < n_bases; ++j) {
      float na[4], nb[4], nc[W];
      load(min(j + 1, n_bases - 1), na, nb, nc);  // the last one is not used
#pragma unroll
      for (int w = 0; w < W; ++w)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[w][i] = fmaf(c[w], ta[i], acc[w][i]);
          acc[w][4 + i] = fmaf(c[w], tb[i], acc[w][4 + i]);
        }
#pragma unroll
      for (int i = 0; i < 4; ++i) { ta[i] = na[i]; tb[i] = nb[i]; }
#pragma unroll
      for (int w = 0; w < W; ++w) c[w] = nc[w];
    }

    // halves back in place; the ninth point from the next thread
    float psi[W][CPT + 1];
#pragma unroll
    for (int w = 0; w < W; ++w) {
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const float v = swap ? acc[w][i ^ 4] : acc[w][i];
        psi[w][i] = KIND == LINEAR ? fmaxf(v, 0.f) : v;
      }
      psi[w][CPT] = __shfl_down_sync(0xffffffffu, psi[w][0], 1);
      if (lane == 0) first_s[(w0 + w) * (WARPS + 1) + warp] = psi[w][0];
    }
    if (t < G) {
      // point 256 * CPT exists only on the largest mesh the kernel takes
      float v = 0.f;
      if (HALF_THREADS * CPT < n_mesh)
        for (int j = 0; j < n_bases; ++j)
          v = fmaf(c_s[j * G + t], tab[j * n_mesh + HALF_THREADS * CPT], v);
      first_s[t * (WARPS + 1) + WARPS] = KIND == LINEAR ? fmaxf(v, 0.f) : v;
    }
    __syncthreads();
    if (lane == 31) {
#pragma unroll
      for (int w = 0; w < W; ++w)
        psi[w][CPT] = first_s[(w0 + w) * (WARPS + 1) + warp + 1];
    }

    // masses of the owned cells, as running (inclusive) in-thread sums;
    // only the last threads of the mesh own cells past its end
    float cdf[W][CPT], incl[W];
#pragma unroll
    for (int w = 0; w < W; ++w)
      incl[w] = all_cells ? running_masses<KIND, false>(psi[w], cdf[w], h, CPT)
                          : running_masses<KIND, true>(psi[w], cdf[w], h,
                                                       n_cells - c0);
    // warp scans of the per-thread sums, the W walkers interleaved
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float v = __shfl_up_sync(0xffffffffu, incl[w], o);
        if (lane >= o) incl[w] += v;
      }
    }
    float excl[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      excl[w] = __shfl_up_sync(0xffffffffu, incl[w], 1);
      if (lane == 0) excl[w] = 0.f;
      if (lane == 31) wsum_s[(w0 + w) * WARPS + warp] = incl[w];
    }
    // the last cell's owner publishes the two terms of the total
    if (last >= c0 && last < c0 + CPT) {
#pragma unroll
      for (int w = 0; w < W; ++w)
#pragma unroll
        for (int i = 0; i < CPT; ++i)
          if (c0 + i == last) {
            run_last_s[w0 + w] = cdf[w][i];
            excl_last_s[w0 + w] = excl[w];
          }
    }
    __syncthreads();
    const int last_warp = last / (32 * CPT);
    int cnt[W];
    float target[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      // the warps' sums, added in order up to this warp and up to the last
      // cell's warp
      float ws[WARPS];
#pragma unroll
      for (int q = 0; q < WARPS / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            wsum_s + (w0 + w) * WARPS + 4 * q);
        ws[4 * q] = v.x; ws[4 * q + 1] = v.y; ws[4 * q + 2] = v.z; ws[4 * q + 3] = v.w;
      }
      float warp_off = 0.f, last_off = 0.f;
#pragma unroll
      for (int k = 0; k < WARPS - 1; ++k) {
        if (k < warp) warp_off += ws[k];
        if (k < last_warp) last_off += ws[k];
      }
      excl[w] += warp_off;
#pragma unroll
      for (int i = 0; i < CPT; ++i) cdf[w][i] += excl[w];
      // total = inclusive cdf at the last cell, summed as its owner sums it
      const float total = run_last_s[w0 + w] + (excl_last_s[w0 + w] + last_off);
      target[w] = u_s[w0 + w] * total;
      // j = #{cells with inclusive cdf <= target}
      int n = 0;
#pragma unroll
      for (int i = 0; i < CPT; ++i)
        n += ((all_cells || c0 + i < n_cells) && cdf[w][i] <= target[w]);
      cnt[w] = n;
    }
    // the warp's count: one warp-wide integer reduction per walker
#pragma unroll
    for (int w = 0; w < W; ++w)
      cnt[w] = __reduce_add_sync(0xffffffffu, cnt[w]);
    if (lane == 0) {
#pragma unroll
      for (int w = 0; w < W; ++w) wcnt_s[(w0 + w) * WARPS + warp] = cnt[w];
    }
    __syncthreads();

    // j, the target and (from the owner of cell j - 1) cdf[j - 1] go into the
    // ring; ψ_l and Δ of cell j are rebuilt by the thread that solves it
#pragma unroll
    for (int w = 0; w < W; ++w) {
      int j = 0;
#pragma unroll
      for (int q = 0; q < WARPS / 4; ++q) {
        const int4 v = *reinterpret_cast<const int4*>(
            wcnt_s + (w0 + w) * WARPS + 4 * q);
        j += v.x + v.y + v.z + v.w;
      }
      j = min(max(j, 0), n_cells - 1);
      const int e = slot + w0 + w;
      if (c0 == 0) {
        ring_j[e] = j;
        ring_tgt[e] = target[w];
        if (j == 0) ring_prev[e] = 0.f;
      }
      // (compared cell by cell: an index computed from j would send the
      // register array to local memory)
      if (j - 1 >= c0 && j - 1 < c0 + CPT) {
#pragma unroll
        for (int i = 0; i < CPT; ++i)
          if (c0 + i == j - 1) ring_prev[e] = cdf[w][i];
      }
    }
    slot += G;

    // ring full, or no group left: one in-cell solve per thread
    if (slot + G > RING || g + gridDim.x >= n_groups) {
      __syncthreads();
      if (t < slot) {
        const int row = (g_first + (t / G) * static_cast<int>(gridDim.x)) * G + t % G;
        if (row < B) {
          // ψ at the two ends of cell j, summed as the mesh loop sums it
          const int j = ring_j[t];
          const float* crow = coeffs + static_cast<size_t>(row) * n_bases;
          float a = 0.f, b = 0.f;
          for (int k = 0; k < n_bases; ++k) {
            const float ck = crow[k];
            a = fmaf(ck, tab[k * n_mesh + j], a);
            b = fmaf(ck, tab[k * n_mesh + j + 1], b);
          }
          if constexpr (KIND == LINEAR) {
            a = fmaxf(a, 0.f);
            b = fmaxf(b, 0.f);
          }
          const float s = solve_cell<KIND>(h, a, b - a, ring_tgt[t] - ring_prev[t],
                                           n_bisect, n_newton);
          out[row] = (static_cast<float>(j) + s) * h;
        }
      }
      slot = 0;
      g_first = g + gridDim.x;
    }
  }
}

template <int KIND, int W, int HALVES, bool STAGED>
int launch_as(const float* u, const float* coeffs, const float* table_t,
              float* out, int B, int n_bases, int n_mesh, float h,
              int n_bisect, int n_newton, int grid, int smem, void* stream) {
  constexpr int G = W * HALVES;
  constexpr int THREADS = HALF_THREADS * HALVES;
  if (smem != smem_bytes(n_bases, n_mesh, G, STAGED) ||
      G * n_bases > CREG * THREADS || grid < 1 || grid > (B + G - 1) / G)
    return static_cast<int>(cudaErrorInvalidValue);
  sampler_kernel<KIND, W, HALVES, STAGED>
      <<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          u, coeffs, table_t, out, B, n_bases, n_mesh, h, n_bisect, n_newton);
  return static_cast<int>(cudaGetLastError());
}

// G walkers per group: 2 and 4 on one half of 256 threads, 8 as two halves of
// 4 (512 threads); a streamed table always takes groups of 8
template <int KIND>
int launch(const float* u, const float* coeffs, const float* table_t,
           float* out, int B, int n_bases, int n_mesh, float h, int n_bisect,
           int n_newton, int G, int staged, int grid, int smem, void* stream) {
  if (B <= 0) return 0;
  if (n_mesh - 1 > HALF_THREADS * CPT || n_mesh < 2 || n_bases < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!staged)
    return G != 8 ? static_cast<int>(cudaErrorInvalidValue)
                  : launch_as<KIND, 4, 2, false>(u, coeffs, table_t, out, B,
                                                 n_bases, n_mesh, h, n_bisect,
                                                 n_newton, grid, smem, stream);
  switch (G) {
    case 2:
      return launch_as<KIND, 2, 1, true>(u, coeffs, table_t, out, B, n_bases,
                                         n_mesh, h, n_bisect, n_newton, grid,
                                         smem, stream);
    case 4:
      return launch_as<KIND, 4, 1, true>(u, coeffs, table_t, out, B, n_bases,
                                         n_mesh, h, n_bisect, n_newton, grid,
                                         smem, stream);
    case 8:
      return launch_as<KIND, 4, 2, true>(u, coeffs, table_t, out, B, n_bases,
                                         n_mesh, h, n_bisect, n_newton, grid,
                                         smem, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int KIND, int W, int HALVES>
cudaError_t allow_smem(int bytes) {
  return cudaFuncSetAttribute(sampler_kernel<KIND, W, HALVES, true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

// Once per device: the SM count and the largest dynamic shared memory a
// block may ask for, which every staged instantiation is then allowed.
extern "C" int sampler_init(int* n_sm, int* smem_limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(smem_limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int lim = *smem_limit;
  const cudaError_t errs[] = {
      allow_smem<SQUARED, 2, 1>(lim), allow_smem<SQUARED, 4, 1>(lim),
      allow_smem<SQUARED, 4, 2>(lim), allow_smem<LINEAR, 2, 1>(lim),
      allow_smem<LINEAR, 4, 1>(lim),  allow_smem<LINEAR, 4, 2>(lim)};
  for (cudaError_t e : errs)
    if (e != cudaSuccess) return static_cast<int>(e);
  return 0;
}

extern "C" int sampler_launch(const float* u, const float* coeffs,
                              const float* table_t, float* out, int B,
                              int n_bases, int n_mesh, float h, int n_bisect,
                              int n_newton, int G, int staged, int grid,
                              int smem, void* stream) {
  return launch<SQUARED>(u, coeffs, table_t, out, B, n_bases, n_mesh, h,
                         n_bisect, n_newton, G, staged, grid, smem, stream);
}

extern "C" int sampler_linear_launch(const float* u, const float* coeffs,
                                     const float* table_t, float* out, int B,
                                     int n_bases, int n_mesh, float h, int G,
                                     int staged, int grid, int smem,
                                     void* stream) {
  return launch<LINEAR>(u, coeffs, table_t, out, B, n_bases, n_mesh, h, 0, 0,
                        G, staged, grid, smem, stream);
}

extern "C" const char* sampler_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
