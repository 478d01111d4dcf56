// Hand-written Hopper (sm_90a) kernels for the matrix-free RBF Gram matvec.
//
// rbf_matvec_* replaces rbf_matvec_pallas (src/repro/kernels/rbf_matvec.py:77):
//
//   Y = theta^2 * exp(-1/2 |x_i - x_j|^2 / lambda^2) V      (X: (n, d), V: (n, r))
//
// with the Gram tiles formed and consumed on chip, never stored.
// rbf_matvec_rect_* replaces rbf_matvec_rect_pallas (rbf_matvec.py:134), the
// per-rank product of the sharded RBF operator: rows X_rows (m, d) of this
// rank against every column X_cols (n, d), Y (m, r) = K(X_rows, X_cols) V.
// As in Pallas, where the rectangular kernel is _rbf_matvec_kernel unchanged
// on another grid, both entry points launch the same kernels below; the
// rectangular one always computes the column norms over X_cols apart from
// the row norms, and its grid is (ceil(m / 64) row tiles) x (splits).  With
// m = n / 8 (eight ranks) there are few row tiles, so the launcher's split
// count grows to keep about 2048 blocks in flight.
//
// What bounds it: operations.  One call does 2 m n d flops for the cross
// term X_i X_j^T, ~8 m n for the distances and exp, and 2 m n r for the
// product with V, while it reads only (m + n) d + n r elements.  At
// n = 36 551, d = 784 that is ~2.1 TFLOP against ~0.5 GB.  When rows and
// columns are the same X, K is symmetric and the function needs each pair
// only once (an off-diagonal tile K_ij serves both Y_i and Y_j): about
// 1.05 TFLOP, the work its bound counts.  This kernel forms every tile.
// The rectangular block has no symmetry: its bound is the full
// 2 m n d + 2 m n r + 8 m n (1.06e11 at m = 4 096, n = 16 384, d = 784).
//
// Design (a simple SIMT kernel that is right first; no tensor cores: TF32
// would lose the digits that |x_i|^2 + |x_j|^2 - 2 x_i.x_j cancels, and the
// f64 path accumulates in f64 as the reference's f64 CPU arm does):
//
//   * A pre-pass writes the squared row norms of X / lambda (one warp a row).
//   * Block (i, s) owns a 64-row tile i and walks the 64-column tiles of
//     its column range s in order (the Pallas "arbitrary" j axis, cut into
//     `splits` ranges so that enough blocks fill the card).
//   * Per column tile: the cross term is accumulated from 16-feature chunks
//     of both tiles staged in shared memory, each thread owning a 4 x 4
//     sub-tile in registers (rows ty + 16a, columns tx + 16b); then
//     d2 = max(|x_i|^2 + |x_j|^2 - 2 cross, 0) and exp(-d2 / 2) (exp, not
//     __expf) go to a 64 x 64 tile in shared memory, theta^2 V_j beside it,
//     and each thread adds its (row, column-of-V) outputs of K_ij V_j to
//     registers.
//   * Each block writes its (64, r) partial once to partials[s]; a second
//     kernel sums the `splits` partials in order.  No atomics: runs repeat
//     bit for bit.
//   * 1 / lambda and theta^2 are scalar arguments: no scaled copy of X is
//     made.  Ragged tails in m, n, d and r are masked (loads of zeros; a
//     zero row of V contributes nothing).  r > 32 runs in chunks of 32.
//
// Plain C interface: the entry point returns cudaGetLastError() (0 = ok) and
// launches on the stream it is given.  Scratch (norms, partials) and the
// output are allocated by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kTile = 64;      // rows and columns of a Gram tile
constexpr int kDepth = 16;     // features staged per step
constexpr int kSub = kTile / 16;
constexpr int kMaxR = 32;      // right-hand sides per launch
constexpr int kOutPerThread = kTile * kMaxR / kThreads;
constexpr int kNormRowsPerBlock = kThreads / 32;

template <typename T>
struct TileSmem {
  T xi[kTile][kDepth + 1];
  T xj[kTile][kDepth + 1];
  T kt[kTile][kTile + 1];
  T vs[kTile][kMaxR];
};

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// sq[row] = |x[row] * inv_ls|^2, one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads) row_sq_norms(
    const T* __restrict__ x, int64_t rows, int d, T inv_ls,
    T* __restrict__ sq) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kNormRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp
  T s = T(0);
  for (int c = lane; c < d; c += 32) {
    const T v = x[row * d + c] * inv_ls;
    s += v * v;
  }
  s = warp_sum(s);
  if (lane == 0) sq[row] = s;
}

// Partial Y over one column range: partials[split][row][c] for the block's
// 64 rows, columns c < rc of V (V has row stride ldv).
template <typename T>
__global__ void __launch_bounds__(kThreads) rbf_tile_matvec(
    const T* __restrict__ xr, const T* __restrict__ xc,
    const T* __restrict__ sq_r, const T* __restrict__ sq_c, int64_t m,
    int64_t n, int d, const T* __restrict__ v, int rc, int64_t ldv,
    T inv_ls, T theta2, int64_t cols_per_split, T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TileSmem<T>& sm = *reinterpret_cast<TileSmem<T>*>(smem_raw);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t i0 = (int64_t)blockIdx.x * kTile;
  const int split = blockIdx.y;
  const int64_t c_begin = (int64_t)split * cols_per_split;
  const int64_t c_end =
      c_begin + cols_per_split < n ? c_begin + cols_per_split : n;
  const int outs = kTile * rc;

  T sq_i[kSub];
#pragma unroll
  for (int a = 0; a < kSub; ++a) {
    const int64_t gi = i0 + ty + 16 * a;
    sq_i[a] = gi < m ? sq_r[gi] : T(0);
  }
  T yacc[kOutPerThread];
#pragma unroll
  for (int q = 0; q < kOutPerThread; ++q) yacc[q] = T(0);

  for (int64_t j0 = c_begin; j0 < c_end; j0 += kTile) {
    T acc[kSub][kSub];
#pragma unroll
    for (int a = 0; a < kSub; ++a) {
#pragma unroll
      for (int b = 0; b < kSub; ++b) acc[a][b] = T(0);
    }

    for (int k0 = 0; k0 < d; k0 += kDepth) {
      for (int e = tid; e < kTile * kDepth; e += kThreads) {
        const int row = e / kDepth;
        const int col = e - row * kDepth;
        const int gk = k0 + col;
        const int64_t gi = i0 + row;
        const int64_t gj = j0 + row;
        sm.xi[row][col] = (gi < m && gk < d) ? xr[gi * d + gk] * inv_ls : T(0);
        sm.xj[row][col] = (gj < c_end && gk < d) ? xc[gj * d + gk] * inv_ls : T(0);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        T a_v[kSub];
        T b_v[kSub];
#pragma unroll
        for (int a = 0; a < kSub; ++a) a_v[a] = sm.xi[ty + 16 * a][kk];
#pragma unroll
        for (int b = 0; b < kSub; ++b) b_v[b] = sm.xj[tx + 16 * b][kk];
#pragma unroll
        for (int a = 0; a < kSub; ++a) {
#pragma unroll
          for (int b = 0; b < kSub; ++b) acc[a][b] += a_v[a] * b_v[b];
        }
      }
      __syncthreads();
    }

    // The Gram tile and theta^2 V_j, side by side in shared memory.
#pragma unroll
    for (int b = 0; b < kSub; ++b) {
      const int64_t gj = j0 + tx + 16 * b;
      const T sq_j = gj < c_end ? sq_c[gj] : T(0);
#pragma unroll
      for (int a = 0; a < kSub; ++a) {
        T d2 = (sq_i[a] + sq_j) - T(2) * acc[a][b];
        d2 = d2 < T(0) ? T(0) : d2;  // NaN passes through, as in max()
        sm.kt[ty + 16 * a][tx + 16 * b] = exp_t(T(-0.5) * d2);
      }
    }
    for (int e = tid; e < kTile * rc; e += kThreads) {
      const int row = e / rc;
      const int c = e - row * rc;
      const int64_t gj = j0 + row;
      sm.vs[row][c] = gj < c_end ? theta2 * v[gj * ldv + c] : T(0);
    }
    __syncthreads();

#pragma unroll
    for (int q = 0; q < kOutPerThread; ++q) {
      const int o = tid + q * kThreads;
      if (o < outs) {
        const int row = o / rc;
        const int c = o - row * rc;
        T s = T(0);
#pragma unroll 8
        for (int jj = 0; jj < kTile; ++jj) s += sm.kt[row][jj] * sm.vs[jj][c];
        yacc[q] += s;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int q = 0; q < kOutPerThread; ++q) {
    const int o = tid + q * kThreads;
    if (o < outs) {
      const int row = o / rc;
      const int c = o - row * rc;
      const int64_t gi = i0 + row;
      if (gi < m) partials[((int64_t)split * m + gi) * rc + c] = yacc[q];
    }
  }
}

// y[row * ldy + c] = sum over splits, in order, of partials[split][row][c].
template <typename T>
__global__ void __launch_bounds__(kThreads) sum_splits(
    const T* __restrict__ partials, int splits, int64_t m, int rc,
    T* __restrict__ y, int64_t ldy) {
  const int64_t total = m * rc;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    T s = T(0);
    for (int sp = 0; sp < splits; ++sp) s += partials[(int64_t)sp * total + e];
    const int64_t row = e / rc;
    y[row * ldy + (e - row * rc)] = s;
  }
}

template <typename T>
int launch_rbf_matvec(const void* x_rows, const void* x_cols, void* sq_rows,
                      void* sq_cols, int64_t m, int64_t n, int d,
                      const void* v, int r, double inv_ls, double theta2,
                      int splits, int64_t cols_per_split, void* partials,
                      void* y, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T inv = static_cast<T>(inv_ls);
  const T th2 = static_cast<T>(theta2);
  const int64_t norm_blocks = (m + kNormRowsPerBlock - 1) / kNormRowsPerBlock;
  row_sq_norms<T><<<(unsigned)norm_blocks, kThreads, 0, st>>>(
      static_cast<const T*>(x_rows), m, d, inv, static_cast<T*>(sq_rows));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (sq_cols != sq_rows) {
    const int64_t col_blocks = (n + kNormRowsPerBlock - 1) / kNormRowsPerBlock;
    row_sq_norms<T><<<(unsigned)col_blocks, kThreads, 0, st>>>(
        static_cast<const T*>(x_cols), n, d, inv, static_cast<T*>(sq_cols));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  const int smem = (int)sizeof(TileSmem<T>);
  err = cudaFuncSetAttribute(rbf_tile_matvec<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((m + kTile - 1) / kTile), (unsigned)splits);
  const int64_t reduce_blocks_wanted = (m * kMaxR + kThreads - 1) / kThreads;
  const unsigned reduce_blocks =
      (unsigned)(reduce_blocks_wanted < 4096 ? reduce_blocks_wanted : 4096);
  for (int c0 = 0; c0 < r; c0 += kMaxR) {
    const int rc = r - c0 < kMaxR ? r - c0 : kMaxR;
    rbf_tile_matvec<T><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(x_rows), static_cast<const T*>(x_cols),
        static_cast<const T*>(sq_rows), static_cast<const T*>(sq_cols), m, n,
        d, static_cast<const T*>(v) + c0, rc, (int64_t)r, inv, th2,
        cols_per_split, static_cast<T*>(partials));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sum_splits<T><<<reduce_blocks, kThreads, 0, st>>>(
        static_cast<const T*>(partials), splits, m, rc,
        static_cast<T*>(y) + c0, (int64_t)r);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

#define REPRO_RBF_MATVEC_ENTRY_POINT(T, SUFFIX)                                \
  extern "C" int rbf_matvec_##SUFFIX(                                          \
      const void* x_rows, const void* x_cols, void* sq_rows, void* sq_cols,    \
      int64_t m, int64_t n, int d, const void* v, int r, double inv_ls,        \
      double theta2, int splits, int64_t cols_per_split, void* partials,       \
      void* y, void* stream) {                                                 \
    return launch_rbf_matvec<T>(x_rows, x_cols, sq_rows, sq_cols, m, n, d, v,  \
                                r, inv_ls, theta2, splits, cols_per_split,     \
                                partials, y, stream);                          \
  }

REPRO_RBF_MATVEC_ENTRY_POINT(float, f32)
REPRO_RBF_MATVEC_ENTRY_POINT(double, f64)

// K8: the same launch on (m rows x n columns).  The caller passes distinct
// norm buffers for X_rows (m) and X_cols (n), so both passes of the norm
// pre-kernel run.
#define REPRO_RBF_MATVEC_RECT_ENTRY_POINT(T, SUFFIX)                           \
  extern "C" int rbf_matvec_rect_##SUFFIX(                                     \
      const void* x_rows, const void* x_cols, void* sq_rows, void* sq_cols,    \
      int64_t m, int64_t n, int d, const void* v, int r, double inv_ls,        \
      double theta2, int splits, int64_t cols_per_split, void* partials,       \
      void* y, void* stream) {                                                 \
    if (sq_rows == sq_cols) return (int)cudaErrorInvalidValue;                 \
    return launch_rbf_matvec<T>(x_rows, x_cols, sq_rows, sq_cols, m, n, d, v,  \
                                r, inv_ls, theta2, splits, cols_per_split,     \
                                partials, y, stream);                          \
  }

REPRO_RBF_MATVEC_RECT_ENTRY_POINT(float, f32)
REPRO_RBF_MATVEC_RECT_ENTRY_POINT(double, f64)
