// Table-lerp spline evaluation for Hopper (sm_90a):
//     y[n] = sum_i coeffs[n, i] * lerp(table[:, i], x[n])
// with cell = clip(floor(x * n_cells), 0, n_cells - 1), frac = x * n_cells -
// cell NOT clipped, so a point outside [0, 1] extends its edge cell linearly.
//
// Replaces: waveflow_tpu/ops/pallas_spline.py, `_spline_eval_kernel`
// (pl.pallas_call at :77, entry spline_eval_pallas at :60).  On the TPU a
// row gather serialises through the scalar units, so that kernel builds a
// dense (256, n_mesh) matrix of lerp weights — two non-zeros per row — and
// multiplies it against the whole table on the MXU.  On this card a gather
// is cheap, so the one-hot product is not carried over: each row reads the
// two table rows that bracket x[n], n_bases contiguous floats each in the
// (n_mesh, n_bases) layout, lerps them, multiplies by its coefficients and
// reduces.
//
// What bounds it on this card: bytes.  A row reads n_bases + 1 floats from
// device memory and writes one; the table (n_mesh * n_bases floats, ~150 KB
// at the density model's prior) is shared by all rows and stays in L2.  It
// does ~4 flops per coefficient read, far below the f32 ridge.  At the
// density path's N = 40,000 the whole call moves ~3 MB, about a microsecond
// of memory time, so the launch dominates.  The design:
//   * LANES = 8 lanes of a warp share a row: lane l takes bases l, l + 8, …,
//     so the 8 lanes read 32 contiguous bytes of the coefficient row and of
//     each table row per step, and a warp covers 4 rows;
//   * an xor-shuffle over the 8 lanes reduces the row's partial sums;
//   * no shared memory and no staging: one pass, one float written per row.
// The table is an argument, so the same kernel serves every derivative
// order (the x-derivative of the order-d evaluation is the order-(d+1)
// evaluation, ops/spline_eval.py).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 8;                  // lanes per row
constexpr int ROWS_PER_BLOCK = THREADS / LANES;

__global__ void __launch_bounds__(THREADS)
spline_eval_kernel(const float* __restrict__ table,
                   const float* __restrict__ coeffs,
                   const float* __restrict__ x, float* __restrict__ out,
                   int N, int n_mesh, int n_bases) {
  const int sub = threadIdx.x % LANES;
  const long long row =
      static_cast<long long>(blockIdx.x) * ROWS_PER_BLOCK + threadIdx.x / LANES;
  const int n_cells = n_mesh - 1;
  float acc = 0.f;
  if (row < N) {
    // the product is rounded before the floor and the subtraction (no fused
    // multiply-add), so cell and frac are the plain version's
    const float pos = __fmul_rn(x[row], static_cast<float>(n_cells));
    const float cell_f =
        fminf(fmaxf(floorf(pos), 0.f), static_cast<float>(n_cells - 1));
    const float frac = pos - cell_f;
    const int cell = static_cast<int>(cell_f);
    const float* t_l = table + static_cast<size_t>(cell) * n_bases;
    const float* t_r = t_l + n_bases;
    const float* c = coeffs + static_cast<size_t>(row) * n_bases;
    for (int i = sub; i < n_bases; i += LANES) {
      const float y_l = t_l[i];
      acc = fmaf(c[i], fmaf(t_r[i] - y_l, frac, y_l), acc);
    }
  }
  // all 32 lanes take part in the shuffles, rows past N with acc = 0
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (row < N && sub == 0) out[row] = acc;
}

}  // namespace

extern "C" int spline_eval_launch(const float* table, const float* coeffs,
                                  const float* x, float* out, int N,
                                  int n_mesh, int n_bases, void* stream) {
  if (N <= 0) return 0;
  if (n_mesh < 2 || n_bases < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (N + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  spline_eval_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      table, coeffs, x, out, N, n_mesh, n_bases);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spline_eval_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
