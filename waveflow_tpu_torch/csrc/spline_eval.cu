// Table-lerp spline evaluation for Hopper (sm_90a), forward and backward:
//     y[n]      = sum_i c[n, i] * lerp(T_d[:, i], x[n])
//     g_c[n, i] = g[n] * lerp(T_d[:, i], x[n])
//     g_x[n]    = g[n] * sum_i c[n, i] * lerp(T_{d+1}[:, i], x[n])
// with cell = clip(floor(x * n_cells), 0, n_cells - 1), frac = x * n_cells -
// cell NOT clipped, so a point outside [0, 1] extends its edge cell linearly.
// The x-derivative of the order-d evaluation is the order-(d+1) evaluation
// (ops/spline_eval.py), zero where order d + 1 is not tabulated.
// Two more forms serve the forward-mode chain of the table backend:
//   * a table may be read in STEP mode (a bit of `step`): the fraction is
//     taken as 0, so the row at the cell is read as it is.  Over the slope
//     table n_cells * (T_d[j + 1] - T_d[j]) that is the x-derivative of the
//     plain lerp, piecewise constant (ops/spline_eval.py, kind 'S');
//   * the PAIR entry evaluates two tables at one x with one set of
//     coefficients (the value and derivative of IMADE's table forward):
//     the cell is located once and the coefficients read once;
//   * the JET entry (spline_eval_jet_kernel) evaluates, at one x, every
//     term that the forward-mode chain of one evaluation site asks for
//     under jvp levels alone (ops/spline_eval.py): up to 16 terms
//         out[t, n] = sum_i C[m_t][n, i] * B(d_t, mode_t, x[n])_i
//     over up to 4 coefficient components C[m] (the coefficients and their
//     tangents), B the lerp of order d or, in step mode, its slope
//     n_cells * (T_d[cell + 1] - T_d[cell]).  Where the per-call entries
//     take 9 launches for one IMADE site under two jvp levels (4 pair
//     launches on the value tables, 1 on the slope tables, 4 more), each
//     locating the cell and reading rows again, the jet takes one.
//
// Replaces: waveflow_tpu/ops/pallas_spline.py, `_spline_eval_kernel`
// (pl.pallas_call at :77, entry spline_eval_pallas at :60) and the lerped
// basis `W @ table` that its body holds, which the reference's derivative
// rule evaluates again for the coefficient gradient.  On the TPU a row gather
// serialises through the scalar units, so that kernel builds a dense
// (256, n_mesh) matrix of lerp weights — two non-zeros per row — and
// multiplies it against the whole table on the MXU.  On this card a gather is
// cheap, so the one-hot product is not carried over.
//
// What bounds it on this card: bytes, and below ~10^5 rows the launch.  A
// forward row reads n_bases + 1 floats and writes one; a backward row reads
// n_bases + 2 and writes n_bases + 1.  The tables (n_mesh * n_bases floats
// each, 128 KB at the density model's prior) are shared by all rows and stay
// in L1/L2.  ~4 flops per coefficient read: far below the f32 ridge.  At the
// density path's N = 40,000 a forward moves ~3 MB and a backward ~6 MB, one to
// two microseconds of memory time, so what the kernel can lose is latency: the
// chain x[row] -> cell -> table rows is two dependent trips to memory.  The
// design:
//   * a row's two bracketing table rows, cell and cell + 1, are one
//     contiguous span of 2 * n_bases floats in the (n_mesh, n_bases) layout;
//     a lane group of `lanes` threads (a power of two, chosen by
//     ops/cuda_spline.py::plan from n_bases) shares a row, and each lane takes
//     chunks of 4 consecutive bases: one 16-byte load of the coefficients and
//     one of each table row per chunk (VEC).  Where n_bases is not a multiple
//     of 4, or a pointer is not 16-byte aligned, the rows are not aligned
//     either and the same chunks go through scalar loads (the launcher checks
//     and picks; the assignment of bases to lanes, and so the result to the
//     bit, is the same);
//   * one row per lane group.  Keeping 2 or 4 rows in flight per group (all
//     their x read and their cells located first, then all their loads
//     started before the first is used) was measured on an NVIDIA H100 80GB
//     HBM3 at 700.00 W and was slower at every N from 512 to 4,000,000,
//     forward and backward (PERF.md names the runs): twice the warps hide
//     the chain better than twice the loads per warp, so it is not here;
//   * coefficients and gradients are read once and outputs written once:
//     streaming loads and stores (`__ldcs` / `__stcs`), so they do not push
//     the tables out of L1; the tables go through the read-only path;
//   * order of the sum over the bases: a lane adds its chunks' products in
//     ascending base order with fmaf, then an xor-shuffle tree (distance
//     lanes / 2, ..., 1) adds the lanes.  At 16 bases and 4 lanes that is
//     ((0..3) + (8..11)) + ((4..7) + (12..15)) with each quadruple summed in
//     order; it stays inside 2e-5 of the largest output against both plain
//     versions;
//   * the backward is ONE kernel: cell and fraction located once (the
//     forward's arithmetic), g_c written as 16-byte streaming stores, g_x
//     reduced as the forward reduces y — bitwise g * (the forward at order
//     d + 1) — and written as zeros at the top order; either output is skipped
//     when its pointer is null;
//   * no shared memory: a trial with the table staged in the shared memory
//     of persistent blocks by one bulk copy was 2.3 to 2.5 times slower at
//     every N from 40,000 to 4,000,000 (PERF.md); the 128 KB live in L1/L2
//     just as well and the fill is paid by every block.
// The launch plan (lanes, grid) comes from ops/cuda_spline.py::plan and
// is checked here against the kernel's own constants.
//
// The jet entry is bytes and launches too: a row gather and a 29-long dot
// per term, far below the f32 ridge, and no tile product for wgmma or TMA
// to serve.  Its design:
//   * CELL RECORDS, built once per evaluator at its first jet launch
//     (ops/cuda_spline.py::cell_records): for cell j and order d the row
//     T_d[j] and the f32 delta T_d[j + 1] - T_d[j], padded with zeros to a
//     multiple of 4 bases (29 -> 32).  JAX's [value | delta] cell tables, laid out so that every
//     table load is one float4 (no scalar path for 29 bases) and all that a
//     row's terms read is one contiguous span of the record (4 orders x 2 x
//     32 floats = 1 KB, in L2).  Step mode reads the delta alone and forms
//     the slope as __fmul_rn(delta, n_cells), the evaluator's slope table
//     to the bit; no second row is read;
//   * one lane group per row, one locate, one read of everything: each
//     component's row read once (__ldcs), each (order, mode) basis chunk
//     computed once and used by every term that names it, one accumulator
//     per term in registers, summed with the per-call entries' assignment
//     of bases to lanes, in-lane fmaf order and xor-shuffle tree.  So every
//     output equals the per-call kernel's output for the same term to the
//     bit: a padded base adds a zero product, as the scalar path does;
//   * the (chunk, component) -> output pointer table travels by value in
//     the launch (JetOuts), every index into it a constant after unrolling,
//     so the accumulators stay in registers and a term's branch is
//     warp-uniform; each term writes a tensor of its own;
//   * blocks of 64 threads (ops/cuda_spline.py::plan_jet; 32 to 256 are
//     accepted): a few hundred rows spread over many SMs.  Measured on an
//     NVIDIA H100 80GB HBM3 at 700.00 W, 64 was fastest or within 2% of it
//     at N = 512, 8,192 and 40,000 on both sites (PERF.md).  The block size
//     does not change the arithmetic of a row;
//   * no shared memory: the records of the four evaluators of the table
//     backend (about 8 MB) sit in the 50 MB L2.
//
// The BACKWARD JET entry (spline_eval_bwd_jet_kernel) serves a grad-level
// evaluation site of the table backend: at one x per row it writes
//     g_c[n, :] = Σ_t w_t[n] · B(d_t, mode_t, x[n])            (up to 4 terms)
//     g_x[n]    = Σ_u v_u[n] · Σ_i C_mu[n, i] · B(d_u, mode_u, x[n])_i   (2)
// where a weight w_t is one gradient component or the product of two
// (g · t_x, rounded by __fmul_rn as the separate elementwise product
// rounds), B the lerp of order d or, in step mode, its slope.  The terms of
// g_c sum in groups: each group left to right, then the groups left to
// right.  Where the per-call chain launches the backward kernel once per
// kind of the site (or the basis alone twice per kind for a tangent) and
// adds the kinds' outputs in further kernels, this entry takes one launch:
// an IMADE pair site's backward is 2 kinds (g·B on two value tables, g_x
// from two more), its tangent 4 terms (t_g·B^R + (g·t_x)·B^S per kind).
// What bounds it: bytes (a row reads x, its weights and coefficient row
// and writes n_bases + 1 floats), and below ~10^4 rows the launch.  Its
// design:
//   * the jet's cell records: the cell located once, every table load one
//     float4 at 29 bases, step mode the delta row alone;
//   * each coefficient row and each weight read once; each term's basis
//     chunk formed from the records (a repeated (order, mode) is read again
//     from L1);
//   * the counts of terms are template arguments (an instance per count of
//     g_c and g_x terms), so the loops over terms unroll to the launch's
//     and no register is held for a term it lacks: at most 66 registers
//     where a draft that read the counts from the launch held 76;
//     on an NVIDIA H100 80GB HBM3 at 700.00 W its device time at 40,000
//     rows fell from 0.0121 / 0.0086 / 0.0083 ms to 0.0100 / 0.0070 /
//     0.0065 ms for an IMADE site's backward / tangent / the prior's
//     backward (PERF.md names the runs);
//   * every output equals the per-call chain's to the bit: each product
//     __fmul_rn(w, B) as the backward kernel's g * lerp, the sums __fadd_rn
//     in the chain's order (the per-kind sums `_add` makes, the tangent's
//     (t_g0·B^R0 + (g0·t_x)·B^S0) + (t_g1·B^R1 + (g1·t_x)·B^S1) in which
//     forward AD adds the per-kind tangents), and each g_x term with the
//     backward kernel's lanes, in-lane fmaf order and xor-shuffle tree,
//     then v · y; a kind with no x-derivative adds the 0 the backward
//     kernel writes;
//   * g_c staged: a block's rows of g_c are one contiguous span (rows ×
//     n_bases floats), but a 29-float row is not 16-byte aligned, so each
//     lane writes its chunk into shared memory and the block stores the
//     span with 16-byte streaming stores (a block of a multiple of 4 rows
//     starts every span on a 16-byte boundary; otherwise, and for the
//     tail, 4-byte stores);
//   * blocks of 128 threads (ops/cuda_spline.py::plan_bwd_jet; 64 to 256
//     are accepted): measured on an NVIDIA H100 80GB HBM3 at 700.00 W, 128
//     was fastest or within 4% of it at N = 512, 8,192 and 40,000 in the
//     three forms (examples/kernel_sweep_torch.py --only spline_bwd_jet,
//     PERF.md).  The block size does not change the arithmetic of a row.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 4;  // consecutive bases a lane takes per load
static_assert(CHUNK == 4, "a chunk is one float4");

// cell and unclipped in-cell fraction of x; the product is rounded before
// the floor and the subtraction (no fused multiply-add), so both are the
// plain version's
__device__ __forceinline__ float locate(float xv, int n_cells, int* cell) {
  const float pos = __fmul_rn(xv, static_cast<float>(n_cells));
  const float cell_f =
      fminf(fmaxf(floorf(pos), 0.f), static_cast<float>(n_cells - 1));
  *cell = static_cast<int>(cell_f);
  return pos - cell_f;
}

// bases i .. i + 3 of a row that is read many times (a table)
template <bool VEC>
__device__ __forceinline__ void load_table(const float* p, int i, int n,
                                           float (&v)[CHUNK]) {
  if constexpr (VEC) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) v[k] = i + k < n ? __ldg(p + i + k) : 0.f;
  }
}

// the same of a row that is read once (coefficients)
template <bool VEC>
__device__ __forceinline__ void load_once(const float* p, int i, int n,
                                          float (&v)[CHUNK]) {
  if constexpr (VEC) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p + i));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) v[k] = i + k < n ? __ldcs(p + i + k) : 0.f;
  }
}

// sum over the lanes of a row's group; all 32 lanes of the warp take part
__device__ __forceinline__ float lane_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The row of this thread's lane group, its cell and fraction.  A group past
// N computes on row N - 1 and writes nothing.
struct Row {
  long long row;
  long long at;      // the row that is read: min(row, N - 1)
  float frac;
  int cell;

  __device__ __forceinline__ Row(const float* __restrict__ x, int N,
                                 int n_cells, int lanes_log2) {
    row = static_cast<long long>(blockIdx.x) * (THREADS >> lanes_log2) +
          (threadIdx.x >> lanes_log2);
    at = row < N ? row : N - 1;
    frac = locate(__ldcs(x + at), n_cells, &cell);
  }
};

// PAIR: a second table, table_b, evaluated into out_b
template <bool VEC, bool PAIR>
__global__ void __launch_bounds__(THREADS)
spline_eval_kernel(const float* __restrict__ table,
                   const float* __restrict__ table_b,
                   const float* __restrict__ coeffs,
                   const float* __restrict__ x, float* __restrict__ out,
                   float* __restrict__ out_b, int N, int n_cells,
                   int n_bases, int lanes_log2, int step) {
  const int lanes = 1 << lanes_log2;
  const int sub = threadIdx.x & (lanes - 1);
  const Row r(x, N, n_cells, lanes_log2);
  const size_t span = static_cast<size_t>(r.cell) * n_bases;
  // a table read in step mode takes the row at the cell: with frac = 0 the
  // lerp below returns y_l exactly
  const float frac_a = (step & 1) ? 0.f : r.frac;
  const float frac_b = (step & 2) ? 0.f : r.frac;
  float acc = 0.f, acc_b = 0.f;
  for (int i = CHUNK * sub; i < n_bases; i += CHUNK * lanes) {
    float c[CHUNK], y_l[CHUNK], y_r[CHUNK];
    load_table<VEC>(table + span, i, n_bases, y_l);
    load_table<VEC>(table + span + n_bases, i, n_bases, y_r);
    load_once<VEC>(coeffs + r.at * n_bases, i, n_bases, c);
#pragma unroll
    for (int k = 0; k < CHUNK; ++k)
      acc = fmaf(c[k], fmaf(y_r[k] - y_l[k], frac_a, y_l[k]), acc);
    if constexpr (PAIR) {
      float z_l[CHUNK], z_r[CHUNK];
      load_table<VEC>(table_b + span, i, n_bases, z_l);
      load_table<VEC>(table_b + span + n_bases, i, n_bases, z_r);
#pragma unroll
      for (int k = 0; k < CHUNK; ++k)
        acc_b = fmaf(c[k], fmaf(z_r[k] - z_l[k], frac_b, z_l[k]), acc_b);
    }
  }
  const float y = lane_sum(acc, lanes);
  if (sub == 0 && r.row < N) __stcs(out + r.row, y);
  if constexpr (PAIR) {
    const float y_b = lane_sum(acc_b, lanes);
    if (sub == 0 && r.row < N) __stcs(out_b + r.row, y_b);
  }
}

// table_d1, g_coeffs and g_x may each be null: no order d + 1 (g_x = 0), and
// an output that nobody asked for; coeffs is read only for g_x and may be
// null without it.  `step` bit 0 reads table_d in step mode, bit 1 table_d1
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
spline_eval_bwd_kernel(const float* __restrict__ table_d,
                       const float* __restrict__ table_d1,
                       const float* __restrict__ coeffs,
                       const float* __restrict__ x,
                       const float* __restrict__ grad,
                       float* __restrict__ g_coeffs, float* __restrict__ g_x,
                       int N, int n_cells, int n_bases, int lanes_log2,
                       int step) {
  const int lanes = 1 << lanes_log2;
  const int sub = threadIdx.x & (lanes - 1);
  const Row r(x, N, n_cells, lanes_log2);
  const bool chain = g_x != nullptr && table_d1 != nullptr;
  const float frac_d = (step & 1) ? 0.f : r.frac;
  const float frac_d1 = (step & 2) ? 0.f : r.frac;
  const float g = __ldcs(grad + r.at);
  const size_t span = static_cast<size_t>(r.cell) * n_bases;
  float acc = 0.f;
  for (int i = CHUNK * sub; i < n_bases; i += CHUNK * lanes) {
    float c[CHUNK], y_l[CHUNK], y_r[CHUNK], z_l[CHUNK], z_r[CHUNK];
    if (g_coeffs != nullptr) {
      load_table<VEC>(table_d + span, i, n_bases, y_l);
      load_table<VEC>(table_d + span + n_bases, i, n_bases, y_r);
    }
    if (chain) {
      load_table<VEC>(table_d1 + span, i, n_bases, z_l);
      load_table<VEC>(table_d1 + span + n_bases, i, n_bases, z_r);
      load_once<VEC>(coeffs + r.at * n_bases, i, n_bases, c);
    }
    if (g_coeffs != nullptr && r.row < N) {
      float w[CHUNK];
#pragma unroll
      for (int k = 0; k < CHUNK; ++k)
        w[k] = g * fmaf(y_r[k] - y_l[k], frac_d, y_l[k]);
      float* dst = g_coeffs + r.row * n_bases + i;
      if constexpr (VEC) {
        __stcs(reinterpret_cast<float4*>(dst),
               make_float4(w[0], w[1], w[2], w[3]));
      } else {
#pragma unroll
        for (int k = 0; k < CHUNK; ++k)
          if (i + k < n_bases) __stcs(dst + k, w[k]);
      }
    }
    if (chain) {
#pragma unroll
      for (int k = 0; k < CHUNK; ++k)
        acc = fmaf(c[k], fmaf(z_r[k] - z_l[k], frac_d1, z_l[k]), acc);
    }
  }
  if (g_x != nullptr) {
    const float y = lane_sum(acc, lanes);
    if (sub == 0 && r.row < N) __stcs(g_x + r.row, chain ? g * y : 0.f);
  }
}

// ---- the jet entry ----------------------------------------------------------

constexpr int JET_TERMS = 16;
constexpr int JET_COMPONENTS = 4;
constexpr int JET_ORDERS = 4;
constexpr int JET_CHUNKS = 2 * JET_ORDERS;  // (order, lerp or step)
constexpr int JET_MAX_THREADS = 256;

// the output of each (basis chunk, component) product, (N,): chunk 2 d is
// the lerp of order d, 2 d + 1 its step-mode slope; null where no term
// takes it.  Each output is a tensor of its own, as a per-call launch
// writes it (forward AD keeps the tangent of a rule's output beside its
// storage: one shared buffer would cost a fill and a copy per output), and
// every index into the table is a constant after unrolling (an index read
// from the launch would put the table in local memory)
struct JetOuts {
  float* out[JET_CHUNKS][JET_COMPONENTS];
};

// records: (n_cells, n_orders, 2, n_pad); c0..c3: (N, n_bases) or null.
// VEC: the components' rows are 16-byte aligned
template <bool VEC>
__global__ void __launch_bounds__(JET_MAX_THREADS)
spline_eval_jet_kernel(const float* __restrict__ records,
                       const float* __restrict__ c0,
                       const float* __restrict__ c1,
                       const float* __restrict__ c2,
                       const float* __restrict__ c3,
                       const float* __restrict__ x, const JetOuts outs,
                       int N, int n_cells, int n_bases, int n_orders,
                       int lanes_log2) {
  const int lanes = 1 << lanes_log2;
  const int sub = threadIdx.x & (lanes - 1);
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> lanes_log2) +
      (threadIdx.x >> lanes_log2);
  const long long at = row < N ? row : N - 1;
  int cell;
  const float frac = locate(__ldcs(x + at), n_cells, &cell);
  const float scale = static_cast<float>(n_cells);
  const int n_pad = (n_bases + CHUNK - 1) / CHUNK * CHUNK;
  const float* __restrict__ rec =
      records + static_cast<size_t>(cell) * (2 * n_orders * n_pad);
  const float* const comp[JET_COMPONENTS] = {c0, c1, c2, c3};
  bool need_c[JET_COMPONENTS], need_b[JET_CHUNKS];
#pragma unroll
  for (int m = 0; m < JET_COMPONENTS; ++m) need_c[m] = false;
#pragma unroll
  for (int b = 0; b < JET_CHUNKS; ++b) {
    need_b[b] = false;
#pragma unroll
    for (int m = 0; m < JET_COMPONENTS; ++m)
      if (outs.out[b][m] != nullptr) need_b[b] = need_c[m] = true;
  }
  float acc[JET_CHUNKS][JET_COMPONENTS];
#pragma unroll
  for (int b = 0; b < JET_CHUNKS; ++b)
#pragma unroll
    for (int m = 0; m < JET_COMPONENTS; ++m) acc[b][m] = 0.f;
  for (int i = CHUNK * sub; i < n_pad; i += CHUNK * lanes) {
    float c[JET_COMPONENTS][CHUNK];
#pragma unroll
    for (int m = 0; m < JET_COMPONENTS; ++m) {
      if (need_c[m]) {
        load_once<VEC>(comp[m] + at * n_bases, i, n_bases, c[m]);
      } else {
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) c[m][k] = 0.f;
      }
    }
    float B[JET_CHUNKS][CHUNK];
#pragma unroll
    for (int d = 0; d < JET_ORDERS; ++d) {
#pragma unroll
      for (int k = 0; k < CHUNK; ++k) B[2 * d][k] = B[2 * d + 1][k] = 0.f;
      if (need_b[2 * d] || need_b[2 * d + 1]) {
        float delta[CHUNK];
        load_table<true>(rec + (2 * d + 1) * n_pad, i, n_pad, delta);
        if (need_b[2 * d + 1]) {
#pragma unroll
          for (int k = 0; k < CHUNK; ++k)
            B[2 * d + 1][k] = __fmul_rn(delta[k], scale);
        }
        if (need_b[2 * d]) {
          float y[CHUNK];
          load_table<true>(rec + 2 * d * n_pad, i, n_pad, y);
#pragma unroll
          for (int k = 0; k < CHUNK; ++k)
            B[2 * d][k] = fmaf(delta[k], frac, y[k]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < JET_CHUNKS; ++b)
#pragma unroll
      for (int m = 0; m < JET_COMPONENTS; ++m)
        if (outs.out[b][m] != nullptr) {
#pragma unroll
          for (int k = 0; k < CHUNK; ++k)
            acc[b][m] = fmaf(c[m][k], B[b][k], acc[b][m]);
        }
  }
#pragma unroll
  for (int b = 0; b < JET_CHUNKS; ++b)
#pragma unroll
    for (int m = 0; m < JET_COMPONENTS; ++m)
      if (outs.out[b][m] != nullptr) {
        const float y = lane_sum(acc[b][m], lanes);
        if (sub == 0 && row < N) __stcs(outs.out[b][m] + row, y);
      }
}

// ---- the backward jet entry ------------------------------------------------

constexpr int BWD_VECS = 6;        // gradient components and tangents, (N,)
constexpr int BWD_C_TERMS = 4;     // terms of g_c
constexpr int BWD_X_TERMS = 2;     // terms of g_x
constexpr int BWD_COMPONENTS = 2;  // coefficient components g_x reads
constexpr int BWD_MAX_THREADS = 256;

// one launch's terms, by value (every loop over them unrolled, so the
// fields are read from the parameter space and a term's branch is
// warp-uniform).  c term t: weight vec[c_a[t]] (times vec[c_b[t]] where
// c_b[t] >= 0), basis (c_order[t], c_step[t]), c_open[t]: it opens a group.
// x term u: weight vec[x_v[u]], coefficients comp[x_comp[u]], basis
// (x_order[u], x_step[u]); x_order[u] < 0 adds 0
struct BwdTerms {
  const float* vec[BWD_VECS];
  const float* comp[BWD_COMPONENTS];
  int c_a[BWD_C_TERMS], c_b[BWD_C_TERMS], c_order[BWD_C_TERMS],
      c_step[BWD_C_TERMS], c_open[BWD_C_TERMS];
  int x_v[BWD_X_TERMS], x_comp[BWD_X_TERMS], x_order[BWD_X_TERMS],
      x_step[BWD_X_TERMS];
};

// v[j] where j == index (an unrolled select keeps v in registers)
__device__ __forceinline__ float pick(const float (&v)[BWD_VECS], int index) {
  float r = 0.f;
#pragma unroll
  for (int j = 0; j < BWD_VECS; ++j)
    if (j == index) r = v[j];
  return r;
}

// the basis chunk i .. i + 3 of order d at this row's cell: the lerp
// fmaf(delta, frac, row), or in step mode the slope delta · n_cells
__device__ __forceinline__ void basis_chunk(const float* rec, int n_pad,
                                            int i, int d, bool step,
                                            float frac, float scale,
                                            float (&b)[CHUNK]) {
  float delta[CHUNK];
  load_table<true>(rec + (2 * d + 1) * n_pad, i, n_pad, delta);
  if (step) {
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) b[k] = __fmul_rn(delta[k], scale);
  } else {
    float y[CHUNK];
    load_table<true>(rec + 2 * d * n_pad, i, n_pad, y);
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) b[k] = fmaf(delta[k], frac, y[k]);
  }
}

// records: (n_cells, n_orders, 2, n_pad); NC terms of g_c (N, n_bases) and
// NX of g_x (N,), an output with no terms null.  Dynamic shared memory:
// (blockDim.x / lanes) * n_bases floats when NC > 0.  VEC: the components'
// rows are 16-byte aligned.  The term counts are template arguments, so
// every loop over terms unrolls to what the launch has and no register
// is held for a term it does not
template <bool VEC, int NC, int NX>
__global__ void __launch_bounds__(BWD_MAX_THREADS)
spline_eval_bwd_jet_kernel(const float* __restrict__ records,
                           const float* __restrict__ x, const BwdTerms p,
                           float* __restrict__ g_c, float* __restrict__ g_x,
                           int N, int n_cells, int n_bases, int n_orders,
                           int lanes_log2) {
  extern __shared__ __align__(16) float stage[];
  const int lanes = 1 << lanes_log2;
  const int sub = threadIdx.x & (lanes - 1);
  const int rows = blockDim.x >> lanes_log2;
  const int local = threadIdx.x >> lanes_log2;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const long long row = row0 + local;
  const long long at = row < N ? row : N - 1;
  int cell;
  const float frac = locate(__ldcs(x + at), n_cells, &cell);
  const float scale = static_cast<float>(n_cells);
  const int n_pad = (n_bases + CHUNK - 1) / CHUNK * CHUNK;
  const float* __restrict__ rec =
      records + static_cast<size_t>(cell) * (2 * n_orders * n_pad);
  float v[BWD_VECS];
#pragma unroll
  for (int j = 0; j < BWD_VECS; ++j)
    v[j] = p.vec[j] != nullptr ? __ldcs(p.vec[j] + at) : 0.f;
  float w[NC > 0 ? NC : 1];
#pragma unroll
  for (int t = 0; t < NC; ++t) {
    w[t] = pick(v, p.c_a[t]);
    if (p.c_b[t] >= 0) w[t] = __fmul_rn(w[t], pick(v, p.c_b[t]));
  }
  float acc[NX > 0 ? NX : 1];
#pragma unroll
  for (int u = 0; u < NX; ++u) acc[u] = 0.f;
  for (int i = CHUNK * sub; i < n_pad; i += CHUNK * lanes) {
    if constexpr (NC > 0) {
      float total[CHUNK] = {}, group[CHUNK] = {};
      bool summed = false;
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        float b[CHUNK];
        basis_chunk(rec, n_pad, i, p.c_order[t], p.c_step[t], frac, scale, b);
        const bool open = t == 0 || p.c_open[t];
        if (open && t > 0) {
#pragma unroll
          for (int k = 0; k < CHUNK; ++k)
            total[k] = summed ? __fadd_rn(total[k], group[k]) : group[k];
          summed = true;
        }
#pragma unroll
        for (int k = 0; k < CHUNK; ++k) {
          const float term = __fmul_rn(w[t], b[k]);
          group[k] = open ? term : __fadd_rn(group[k], term);
        }
      }
      float* dst = stage + local * n_bases + i;
#pragma unroll
      for (int k = 0; k < CHUNK; ++k)
        if (i + k < n_bases)
          dst[k] = summed ? __fadd_rn(total[k], group[k]) : group[k];
    }
    if constexpr (NX > 0) {
      float c[BWD_COMPONENTS][CHUNK];
#pragma unroll
      for (int m = 0; m < BWD_COMPONENTS; ++m) {
        if (p.comp[m] != nullptr) {
          load_once<VEC>(p.comp[m] + at * n_bases, i, n_bases, c[m]);
        } else {
#pragma unroll
          for (int k = 0; k < CHUNK; ++k) c[m][k] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < NX; ++u) {
        if (p.x_order[u] < 0) continue;
        float b[CHUNK];
        basis_chunk(rec, n_pad, i, p.x_order[u], p.x_step[u], frac, scale, b);
#pragma unroll
        for (int k = 0; k < CHUNK; ++k)
          acc[u] = fmaf(p.x_comp[u] == 0 ? c[0][k] : c[1][k], b[k], acc[u]);
      }
    }
  }
  if constexpr (NX > 0) {
    float gx = 0.f;
#pragma unroll
    for (int u = 0; u < NX; ++u) {
      const float y = lane_sum(acc[u], lanes);
      const float term =
          p.x_order[u] >= 0 ? __fmul_rn(pick(v, p.x_v[u]), y) : 0.f;
      gx = u == 0 ? term : __fadd_rn(gx, term);
    }
    if (sub == 0 && row < N) __stcs(g_x + row, gx);
  }
  if constexpr (NC > 0) {
    __syncthreads();
    const long long left = N - row0;
    const int span = static_cast<int>(left < rows ? left : rows) * n_bases;
    float* dst = g_c + row0 * n_bases;
    int j = threadIdx.x;
    if (reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
      const int n4 = span / CHUNK;
      for (; j < n4; j += blockDim.x)
        __stcs(reinterpret_cast<float4*>(dst) + j,
               reinterpret_cast<const float4*>(stage)[j]);
      j = CHUNK * n4 + threadIdx.x;
    }
    for (; j < span; j += blockDim.x) __stcs(dst + j, stage[j]);
  }
}

// the instance of (VEC, NC, NX) for a launch; NX = 0 reads no components,
// so VEC does not matter there
template <int NC, int NX>
void launch_bwd_jet(bool vec, int grid, int threads, size_t smem,
                    cudaStream_t s, const float* records, const float* x,
                    const BwdTerms& p, float* g_c, float* g_x, int N,
                    int n_cells, int n_bases, int n_orders, int lanes_log2) {
  if (vec && NX > 0)
    spline_eval_bwd_jet_kernel<true, NC, NX><<<grid, threads, smem, s>>>(
        records, x, p, g_c, g_x, N, n_cells, n_bases, n_orders, lanes_log2);
  else
    spline_eval_bwd_jet_kernel<false, NC, NX><<<grid, threads, smem, s>>>(
        records, x, p, g_c, g_x, N, n_cells, n_bases, n_orders, lanes_log2);
}

template <int NC>
void launch_bwd_jet_nx(int n_x, bool vec, int grid, int threads,
                       size_t smem, cudaStream_t s, const float* records,
                       const float* x, const BwdTerms& p, float* g_c,
                       float* g_x, int N, int n_cells, int n_bases,
                       int n_orders, int lanes_log2) {
  static_assert(BWD_X_TERMS == 2, "one case per count of g_x terms");
  if (n_x == 0)
    launch_bwd_jet<NC, 0>(vec, grid, threads, smem, s, records, x, p, g_c,
                          g_x, N, n_cells, n_bases, n_orders, lanes_log2);
  else if (n_x == 1)
    launch_bwd_jet<NC, 1>(vec, grid, threads, smem, s, records, x, p, g_c,
                          g_x, N, n_cells, n_bases, n_orders, lanes_log2);
  else
    launch_bwd_jet<NC, 2>(vec, grid, threads, smem, s, records, x, p, g_c,
                          g_x, N, n_cells, n_bases, n_orders, lanes_log2);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// lanes: a power of two up to 32; grid: the blocks that cover N rows at
// THREADS / lanes rows per block, no more
int check_plan(int N, int n_mesh, int n_bases, int lanes, int grid,
               int* lanes_log2) {
  if (n_mesh < 2 || n_bases < 1 || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = THREADS / lanes;
  if (grid != (N + per_block - 1) / per_block)
    return static_cast<int>(cudaErrorInvalidValue);
  *lanes_log2 = 0;
  while ((1 << *lanes_log2) < lanes) ++*lanes_log2;
  return 0;
}

}  // namespace

extern "C" int spline_eval_launch(const float* table, const float* coeffs,
                                  const float* x, float* out, int N,
                                  int n_mesh, int n_bases, int lanes, int grid,
                                  int step, void* stream) {
  if (N <= 0) return 0;
  int lanes_log2 = 0;
  if (const int err = check_plan(N, n_mesh, n_bases, lanes, grid, &lanes_log2))
    return err;
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_bases % 4 == 0 && aligned16(table) && aligned16(coeffs))
    spline_eval_kernel<true, false><<<grid, THREADS, 0, s>>>(
        table, nullptr, coeffs, x, out, nullptr, N, n_mesh - 1, n_bases,
        lanes_log2, step);
  else
    spline_eval_kernel<false, false><<<grid, THREADS, 0, s>>>(
        table, nullptr, coeffs, x, out, nullptr, N, n_mesh - 1, n_bases,
        lanes_log2, step);
  return static_cast<int>(cudaGetLastError());
}

// two tables of one shape at one x: out_a from table_a, out_b from table_b;
// `step` bit 0 reads table_a in step mode, bit 1 table_b
extern "C" int spline_eval_pair_launch(const float* table_a,
                                       const float* table_b,
                                       const float* coeffs, const float* x,
                                       float* out_a, float* out_b, int N,
                                       int n_mesh, int n_bases, int lanes,
                                       int grid, int step, void* stream) {
  if (N <= 0) return 0;
  int lanes_log2 = 0;
  if (const int err = check_plan(N, n_mesh, n_bases, lanes, grid, &lanes_log2))
    return err;
  if (table_b == nullptr || out_b == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_bases % 4 == 0 && aligned16(table_a) && aligned16(table_b) &&
      aligned16(coeffs))
    spline_eval_kernel<true, true><<<grid, THREADS, 0, s>>>(
        table_a, table_b, coeffs, x, out_a, out_b, N, n_mesh - 1, n_bases,
        lanes_log2, step);
  else
    spline_eval_kernel<false, true><<<grid, THREADS, 0, s>>>(
        table_a, table_b, coeffs, x, out_a, out_b, N, n_mesh - 1, n_bases,
        lanes_log2, step);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int spline_eval_bwd_launch(const float* table_d,
                                      const float* table_d1,
                                      const float* coeffs, const float* x,
                                      const float* grad, float* g_coeffs,
                                      float* g_x, int N, int n_mesh,
                                      int n_bases, int lanes, int grid,
                                      int step, void* stream) {
  if (N <= 0) return 0;
  int lanes_log2 = 0;
  if (const int err = check_plan(N, n_mesh, n_bases, lanes, grid, &lanes_log2))
    return err;
  if ((g_coeffs == nullptr && g_x == nullptr) ||
      (g_x != nullptr && table_d1 != nullptr && coeffs == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_bases % 4 == 0 && aligned16(table_d) && aligned16(table_d1) &&
      aligned16(coeffs) && aligned16(g_coeffs))
    spline_eval_bwd_kernel<true><<<grid, THREADS, 0, s>>>(
        table_d, table_d1, coeffs, x, grad, g_coeffs, g_x, N, n_mesh - 1,
        n_bases, lanes_log2, step);
  else
    spline_eval_bwd_kernel<false><<<grid, THREADS, 0, s>>>(
        table_d, table_d1, coeffs, x, grad, g_coeffs, g_x, N, n_mesh - 1,
        n_bases, lanes_log2, step);
  return static_cast<int>(cudaGetLastError());
}

// terms: n_terms triples (component, order, step) and out: n_terms output
// pointers, both on the host; components that no term names may be null
extern "C" int spline_eval_jet_launch(const float* records, const float* c0,
                                      const float* c1, const float* c2,
                                      const float* c3, const float* x,
                                      float* const* out, const int* terms,
                                      int n_terms, int N, int n_cells,
                                      int n_bases, int n_orders, int lanes,
                                      int threads, int grid, void* stream) {
  if (N <= 0) return 0;
  const auto invalid = static_cast<int>(cudaErrorInvalidValue);
  if (records == nullptr || x == nullptr || out == nullptr ||
      terms == nullptr || n_cells < 1 || n_bases < 1 || n_orders < 1 ||
      n_orders > JET_ORDERS || n_terms < 1 || n_terms > JET_TERMS ||
      !aligned16(records))
    return invalid;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      threads < 32 || threads > JET_MAX_THREADS ||
      (threads & (threads - 1)) != 0)
    return invalid;
  const int per_block = threads / lanes;
  if (grid != (N + per_block - 1) / per_block) return invalid;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < lanes) ++lanes_log2;
  const float* comp[JET_COMPONENTS] = {c0, c1, c2, c3};
  JetOuts outs;
  for (int b = 0; b < JET_CHUNKS; ++b)
    for (int m = 0; m < JET_COMPONENTS; ++m) outs.out[b][m] = nullptr;
  for (int t = 0; t < n_terms; ++t) {
    const int m = terms[3 * t], d = terms[3 * t + 1], step = terms[3 * t + 2];
    if (out[t] == nullptr || m < 0 || m >= JET_COMPONENTS ||
        comp[m] == nullptr || d < 0 || d >= n_orders ||
        (step != 0 && step != 1))
      return invalid;
    float*& slot = outs.out[2 * d + step][m];
    if (slot != nullptr) return invalid;  // the same term twice
    slot = out[t];
  }
  bool vec = n_bases % 4 == 0;
  for (int m = 0; m < JET_COMPONENTS; ++m)
    if (comp[m] != nullptr && !aligned16(comp[m])) vec = false;
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec)
    spline_eval_jet_kernel<true><<<grid, threads, 0, s>>>(
        records, c0, c1, c2, c3, x, outs, N, n_cells, n_bases, n_orders,
        lanes_log2);
  else
    spline_eval_jet_kernel<false><<<grid, threads, 0, s>>>(
        records, c0, c1, c2, c3, x, outs, N, n_cells, n_bases, n_orders,
        lanes_log2);
  return static_cast<int>(cudaGetLastError());
}

// c_terms: n_c quintuples (a, b, order, step, opens a group), b < 0 for one
// factor; x_terms: n_x quadruples (v, component, order, step), order < 0
// for a kind with no x-derivative; both on the host.  vecs: n_vecs (N,)
// pointers; c0, c1: (N, n_bases) or null.  n_c = 0 with g_c null, n_x = 0
// with g_x null
extern "C" int spline_eval_bwd_jet_launch(
    const float* records, const float* c0, const float* c1, const float* x,
    const float* const* vecs, int n_vecs, const int* c_terms, int n_c,
    const int* x_terms, int n_x, float* g_c, float* g_x, int N, int n_cells,
    int n_bases, int n_orders, int lanes, int threads, int grid,
    void* stream) {
  if (N <= 0) return 0;
  const auto invalid = static_cast<int>(cudaErrorInvalidValue);
  if (records == nullptr || x == nullptr || n_cells < 1 || n_bases < 1 ||
      n_orders < 1 || !aligned16(records) || n_vecs < 1 ||
      n_vecs > BWD_VECS || vecs == nullptr)
    return invalid;
  if ((g_c == nullptr) != (n_c == 0) || (g_x == nullptr) != (n_x == 0) ||
      n_c < 0 || n_c > BWD_C_TERMS || n_x < 0 || n_x > BWD_X_TERMS ||
      (n_c == 0 && n_x == 0))
    return invalid;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      threads < 32 || threads > BWD_MAX_THREADS ||
      (threads & (threads - 1)) != 0 || threads < lanes)
    return invalid;
  const int rows = threads / lanes;
  if (grid != (N + rows - 1) / rows) return invalid;
  const size_t smem =
      g_c != nullptr ? sizeof(float) * rows * static_cast<size_t>(n_bases)
                     : 0;
  if (smem > 48 * 1024) return invalid;
  BwdTerms p = {};
  for (int j = 0; j < n_vecs; ++j) {
    if (vecs[j] == nullptr) return invalid;
    p.vec[j] = vecs[j];
  }
  p.comp[0] = c0;
  p.comp[1] = c1;
  for (int t = 0; t < n_c; ++t) {
    const int* q = c_terms + 5 * t;
    if (q[0] < 0 || q[0] >= n_vecs || q[1] >= n_vecs || q[2] < 0 ||
        q[2] >= n_orders || (q[3] != 0 && q[3] != 1))
      return invalid;
    p.c_a[t] = q[0];
    p.c_b[t] = q[1] < 0 ? -1 : q[1];
    p.c_order[t] = q[2];
    p.c_step[t] = q[3];
    p.c_open[t] = q[4] != 0;
  }
  for (int t = n_c; t < BWD_C_TERMS; ++t) p.c_b[t] = -1;
  for (int u = 0; u < n_x; ++u) {
    const int* q = x_terms + 4 * u;
    if (q[0] < 0 || q[0] >= n_vecs || q[1] < 0 || q[1] >= BWD_COMPONENTS ||
        q[2] >= n_orders || (q[3] != 0 && q[3] != 1) ||
        (q[2] >= 0 && p.comp[q[1]] == nullptr))
      return invalid;
    p.x_v[u] = q[0];
    p.x_comp[u] = q[1];
    p.x_order[u] = q[2] < 0 ? -1 : q[2];
    p.x_step[u] = q[3];
  }
  // a component g_x does not read is not loaded
  if (n_x == 0) p.comp[0] = p.comp[1] = nullptr;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < lanes) ++lanes_log2;
  bool vec = n_bases % 4 == 0;
  for (int m = 0; m < BWD_COMPONENTS; ++m)
    if (p.comp[m] != nullptr && !aligned16(p.comp[m])) vec = false;
  const auto s = static_cast<cudaStream_t>(stream);
  static_assert(BWD_C_TERMS == 4, "one case per count of g_c terms");
  switch (n_c) {
    case 0:
      launch_bwd_jet_nx<0>(n_x, vec, grid, threads, smem, s, records, x, p,
                           g_c, g_x, N, n_cells, n_bases, n_orders,
                           lanes_log2);
      break;
    case 1:
      launch_bwd_jet_nx<1>(n_x, vec, grid, threads, smem, s, records, x, p,
                           g_c, g_x, N, n_cells, n_bases, n_orders,
                           lanes_log2);
      break;
    case 2:
      launch_bwd_jet_nx<2>(n_x, vec, grid, threads, smem, s, records, x, p,
                           g_c, g_x, N, n_cells, n_bases, n_orders,
                           lanes_log2);
      break;
    case 3:
      launch_bwd_jet_nx<3>(n_x, vec, grid, threads, smem, s, records, x, p,
                           g_c, g_x, N, n_cells, n_bases, n_orders,
                           lanes_log2);
      break;
    default:
      launch_bwd_jet_nx<4>(n_x, vec, grid, threads, smem, s, records, x, p,
                           g_c, g_x, N, n_cells, n_bases, n_orders,
                           lanes_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spline_eval_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
