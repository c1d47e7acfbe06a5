// Fused basis jet for Hopper (sm_90a): the exact spline basis T_j^{(d)}(x),
// d = 0..3, at every evaluation site x.
//
// Replaces: waveflow_tpu/ops/pallas_jet.py, the inner `kernel` of
// make_pallas_basis_jet (pl.pallas_call at :86).  On the TPU that kernel
// builds W = onehot(cell) (x) (1, s, ..., s^{ncoef-1}) as a dense
// (256, K_pad = 256) tile in VMEM and contracts it on the MXU against the
// padded A_jet (256, 128): 256 MACs per output, almost all against zeros.
//
// Here the one-hot structure is used instead of multiplied out:
//     out[r, (d, j)] = sum_{k < ncoef} s_r^k * A_jet[cell_r * ncoef + k, (d, j)]
// i.e. ncoef (= 8 at the flagship) FMAs per output, accumulated in the order
// k = 0 .. ncoef - 1.
//
// What bounds it on this card: the output.  Each site reads 4 bytes and
// writes 4 * n_out bytes (n_out = 4 * n_bases = 112..116), and does
// 2 * ncoef * n_out flops, ~4 flops per byte written — far below the
// H100's f32 ridge, so at large R it is bound by the store bandwidth, and
// at the flagship's R = 512 by the launch.  The design therefore gives one
// warp to a site and one float4 of the n_out outputs to a lane (28 or 29 of
// 32 lanes busy): the cell is uniform in the warp, x[r] is one broadcast
// load, the s-powers live in registers, and a lane does ncoef 16-byte loads
// of A_jet, 4 * ncoef FMAs and one 16-byte streaming store (the output is
// not read again here).  No shared scratch and no block-wide barrier per
// site.  Two regimes, chosen by the wrapper (ops/cuda_jet.py::plan):
//   direct — no staging: 4 warps per block, one site per warp, so R = 512
//     already gives 128 blocks on 132 SMs; A_jet (<= 82 KB) is read through
//     the read-only path and stays in L1/L2.  Measured on the H100 it is the
//     faster regime up to R of a few ten thousand, and within 10% above.
//   staged — the largest R.  Persistent blocks of 16 warps, two per SM;
//     A_jet is brought into dynamic shared memory once per block by ONE 1-D
//     bulk copy reported to an mbarrier; warps take sites round-robin, SITES
//     at a time, so each lane keeps SITES independent FMA chains and 16-byte
//     stores in flight.  The on-chip reads of A_jet (ncoef times the output
//     bytes, from L1 or from shared memory) cost about as much as the stores
//     to device memory: the kernel sits at ~1.3-1.5x its byte bound.
// The linear out-of-domain extension and the derivative rules stay in the
// torch autograd.Function around this kernel (ops/poly_eval.py), as they
// stay around the Pallas call in the JAX package.

#include <cuda_runtime.h>

#include <initializer_list>

#include "hopper_copy.cuh"

namespace {

constexpr int DIRECT_THREADS = 128;  // 4 warps, one site each
constexpr int STAGED_THREADS = 512;  // 16 warps, two blocks per SM
constexpr int SITES = 2;             // sites a warp has in flight when staged

// NCOEF > 0: the coefficient loop is unrolled (every load of a site issued
// before its first FMA); NCOEF = 0: any ncoef, as a run-time loop.
template <int NCOEF, int U, bool STAGED>
__device__ __forceinline__ void eval_sites(const float* __restrict__ x,
                                           const float4* __restrict__ a4,
                                           float4* __restrict__ out4, int r0,
                                           int stride, int R, int n_cells,
                                           int ncoef_rt, int nvec, int lane) {
  const int ncoef = NCOEF > 0 ? NCOEF : ncoef_rt;
  float s[U];
  int base[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = r0 + u * stride;
    const float pos = (r < R ? __ldg(x + r) : 0.f) * static_cast<float>(n_cells);
    // fmaxf maps a NaN pos to cell 0 (in bounds); s keeps the NaN, so the
    // site's jet is NaN, as the plain core's and JAX's are
    const float idx =
        fminf(fmaxf(floorf(pos), 0.f), static_cast<float>(n_cells - 1));
    s[u] = pos != pos ? pos : fminf(fmaxf(pos - idx, 0.f), 1.f);
    base[u] = static_cast<int>(idx) * ncoef * nvec;
  }
  for (int v = lane; v < nvec; v += 32) {
    float4 acc[U];
    float p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      p[u] = 1.f;
    }
#pragma unroll
    for (int k = 0; k < ncoef; ++k) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4* src = a4 + base[u] + k * nvec + v;
        const float4 a = STAGED ? *src : __ldg(src);
        acc[u].x = fmaf(p[u], a.x, acc[u].x);
        acc[u].y = fmaf(p[u], a.y, acc[u].y);
        acc[u].z = fmaf(p[u], a.z, acc[u].z);
        acc[u].w = fmaf(p[u], a.w, acc[u].w);
        p[u] *= s[u];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * stride;
      if (r < R) __stcs(out4 + static_cast<size_t>(r) * nvec + v, acc[u]);
    }
  }
}

template <int NCOEF>
__global__ void __launch_bounds__(DIRECT_THREADS)
basis_jet_direct(const float* __restrict__ x, const float* __restrict__ a_jet,
                 float* __restrict__ out, int R, int n_cells, int ncoef,
                 int n_out) {
  // the grid covers R: one site per warp, no loop
  const int r = blockIdx.x * (DIRECT_THREADS / 32) + (threadIdx.x >> 5);
  if (r < R)
    eval_sites<NCOEF, 1, false>(x, reinterpret_cast<const float4*>(a_jet),
                                reinterpret_cast<float4*>(out), r, 0, R,
                                n_cells, ncoef, n_out >> 2, threadIdx.x & 31);
}

template <int NCOEF>
__global__ void __launch_bounds__(STAGED_THREADS, 2)
basis_jet_staged(const float* __restrict__ x, const float* __restrict__ a_jet,
                 float* __restrict__ out, int R, int n_cells, int ncoef,
                 int n_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t a_bytes = sizeof(float) * n_cells * ncoef * n_out;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + a_bytes);
  if (threadIdx.x == 0) {
    hopper::mbar_init(bar);
    hopper::mbar_expect_tx(bar, a_bytes);
    hopper::bulk_copy_g2s(smem, a_jet, a_bytes, bar);
  }
  __syncthreads();
  hopper::mbar_wait(bar, 0);

  const int lane = threadIdx.x & 31;
  const int warps = STAGED_THREADS / 32;
  const int total = gridDim.x * warps;
  for (int r = blockIdx.x * warps + (threadIdx.x >> 5); r < R;
       r += total * SITES)
    eval_sites<NCOEF, SITES, true>(x, reinterpret_cast<const float4*>(smem),
                                   reinterpret_cast<float4*>(out), r, total, R,
                                   n_cells, ncoef, n_out >> 2, lane);
}

using kernel_t = void (*)(const float*, const float*, float*, int, int, int,
                          int);

// the unrolled instantiations cover spline degrees 3..6 (ncoef = degree + 2)
template <int NCOEF>
kernel_t kernel_of(bool staged) {
  return staged ? basis_jet_staged<NCOEF> : basis_jet_direct<NCOEF>;
}

kernel_t pick(bool staged, int ncoef) {
  switch (ncoef) {
    case 5: return kernel_of<5>(staged);
    case 6: return kernel_of<6>(staged);
    case 7: return kernel_of<7>(staged);
    case 8: return kernel_of<8>(staged);
    default: return kernel_of<0>(staged);
  }
}

}  // namespace

// Once per device: the SM count and the largest dynamic shared memory a
// block may ask for, which every staged instantiation is then allowed.
extern "C" int basis_jet_init(int* n_sm, int* smem_limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(smem_limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int ncoef : {0, 5, 6, 7, 8}) {
    err = cudaFuncSetAttribute(pick(true, ncoef),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               *smem_limit);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// The launch plan (staged or direct, grid, threads, dynamic shared bytes)
// comes from ops/cuda_jet.py::plan and is checked here against the kernel's
// own constants.
extern "C" int basis_jet_launch(const float* x, const float* a_jet,
                                float* out, int R, int n_cells, int ncoef,
                                int n_out, int staged, int grid, int threads,
                                int smem, void* stream) {
  if (R <= 0) return 0;
  const size_t a_bytes = sizeof(float) * static_cast<size_t>(n_cells) * ncoef * n_out;
  if (n_cells < 1 || ncoef < 1 || n_out < 4 || n_out % 4 != 0 || grid < 1 ||
      (!staged && static_cast<long long>(grid) * (DIRECT_THREADS / 32) < R) ||
      threads != (staged ? STAGED_THREADS : DIRECT_THREADS) ||
      smem != (staged ? static_cast<long long>(a_bytes) + 16 : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const kernel_t kernel = pick(staged != 0, ncoef);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, a_jet, out, R, n_cells, ncoef, n_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* basis_jet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
