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
// i.e. ncoef (= 8 at the flagship) FMAs per output.
//
// What bounds it on this card: the output.  Each site reads 4 bytes and
// writes 4 * n_out bytes (n_out = 4 * n_bases = 112..116), and does
// 2 * ncoef * n_out flops, ~4 flops per byte written — far below the
// H100's f32 ridge, so at large R it is bound by the store bandwidth, and
// at the flagship's R = 512 by the launch.  The design therefore:
//   * keeps A_jet (n_cells * ncoef * n_out f32, <= 82 KB) in dynamic shared
//     memory, loaded once per block; blocks are persistent (2 per SM,
//     grid-stride over row tiles), so A_jet is read from L2 once per block
//     and not once per tile;
//   * gives one thread per output column, so the stores of a row are
//     contiguous and coalesced;
//   * computes each row's cell and s-powers once per tile (ROWS rows) into
//     shared memory, where every column thread reads them as a broadcast.
// The linear out-of-domain extension and the derivative rules stay in the
// torch autograd.Function around this kernel (ops/poly_eval.py), as they
// stay around the Pallas call in the JAX package.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 32;      // evaluation sites per tile
constexpr int THREADS = 128;  // >= n_out at every supported basis size

__global__ void __launch_bounds__(THREADS)
basis_jet_kernel(const float* __restrict__ x, const float* __restrict__ a_jet,
                 float* __restrict__ out, int R, int n_cells, int ncoef,
                 int n_out) {
  extern __shared__ float smem[];
  const int K = n_cells * ncoef;
  float* a_s = smem;                                  // K * n_out
  float* pw_s = a_s + K * n_out;                      // ROWS * ncoef
  int* cell_s = reinterpret_cast<int*>(pw_s + ROWS * ncoef);  // ROWS

  for (int i = threadIdx.x; i < K * n_out; i += blockDim.x) a_s[i] = a_jet[i];

  const int n_tiles = (R + ROWS - 1) / ROWS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = tile * ROWS;
    __syncthreads();  // a_s loaded; previous tile's pw_s/cell_s consumed
    if (threadIdx.x < ROWS) {
      const int r = r0 + threadIdx.x;
      const float pos = (r < R ? x[r] : 0.f) * static_cast<float>(n_cells);
      const float idx =
          fminf(fmaxf(floorf(pos), 0.f), static_cast<float>(n_cells - 1));
      const float s = fminf(fmaxf(pos - idx, 0.f), 1.f);
      cell_s[threadIdx.x] = static_cast<int>(idx);
      float p = 1.f;
      for (int k = 0; k < ncoef; ++k) {
        pw_s[threadIdx.x * ncoef + k] = p;
        p *= s;
      }
    }
    __syncthreads();
    const int rows = min(ROWS, R - r0);
    for (int rr = 0; rr < rows; ++rr) {
      const float* a_row = a_s + cell_s[rr] * ncoef * n_out;
      const float* pw = pw_s + rr * ncoef;
      for (int col = threadIdx.x; col < n_out; col += blockDim.x) {
        float acc = 0.f;
        for (int k = 0; k < ncoef; ++k)
          acc = fmaf(pw[k], a_row[k * n_out + col], acc);
        out[static_cast<size_t>(r0 + rr) * n_out + col] = acc;
      }
    }
  }
}

}  // namespace

extern "C" int basis_jet_launch(const float* x, const float* a_jet,
                                float* out, int R, int n_cells, int ncoef,
                                int n_out, void* stream) {
  if (R <= 0) return 0;
  const size_t smem = sizeof(float) * (static_cast<size_t>(n_cells) * ncoef *
                                           n_out + ROWS * ncoef) +
                      sizeof(int) * ROWS;
  cudaError_t err = cudaFuncSetAttribute(
      basis_jet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, n_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (R + ROWS - 1) / ROWS;
  const int grid = n_tiles < 2 * n_sm ? n_tiles : 2 * n_sm;
  basis_jet_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      x, a_jet, out, R, n_cells, ncoef, n_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* basis_jet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
