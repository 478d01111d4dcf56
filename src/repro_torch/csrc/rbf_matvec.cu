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
// on another grid, both entry points launch the same tile kernel: the square
// one in its symmetric mode, the rectangular one in its full mode with a
// norm buffer for each side.
//
// What bounds it: operations.  The cross term X_i X_j^T is a GEMM of
// 2 m n d flops (the distances, exp and K V add ~8 m n + 2 m n r) on
// (m + n) d + n r elements read.  When rows and columns are the same X, K
// is symmetric and each unordered pair of 128-row tiles is formed once: an
// off-diagonal tile K_IJ adds K_IJ V_J to Y_I and K_IJ^T V_I to Y_J, so the
// cross term costs n (n + 128) d flops.  At n = 36 551, d = 784 that is
// ~1.05 TFLOP, 15.7 ms at the 67 TFLOP/s of the FP64 tensor cores.
//
// Design:
//
//   * A pre-pass writes the squared row norms |x|^2 of the unscaled X (one
//     warp a row).  1 / lambda^2 is folded into the epilogue:
//     d2 = max(((|x_i|^2 + |x_j|^2) - 2 x_i.x_j) / lambda^2, 0), so X is
//     staged as it is, with no scaled copy.
//   * A block owns one 128-row tile I and a segment of its column tiles,
//     and forms one 128 x 128 Gram tile at a time.  Its 8 warps stream the
//     two 128-row slabs of X through shared memory in feature chunks, 4
//     stages deep, by cp.async: 16-byte copies when d * sizeof(T) is a
//     multiple of 16 and X is 16-byte aligned, element copies otherwise.
//     Rows are padded (f64 20 doubles for a 16-feature chunk, f32 36 floats
//     for 32), so the fragment loads below are free of bank conflicts.
//       f64: the FP64 tensor cores (DMMA, mma.sync m16n8k4), warps 2 x 4
//     on 64 x 32 sub-tiles: per 4 features, 8 A and 4 B fragment loads
//     feed 16 products into 64 f64 accumulators a thread.
//       f32: no TF32 (its 10-bit mantissa cannot hold |x_i|^2 + |x_j|^2 -
//     2 x_i.x_j to the f32 tolerance): 8 x 8 FMA micro-tiles a thread,
//     two features per 8-byte shared-memory load.
//   * Epilogue: exp (not __expf) of each tile entry goes to a 128 x 129
//     tile in shared memory laid over the drained stage ring; 128 threads
//     then form the tile's rows times theta^2 V_J (Y_I, summed over the
//     segment in shared memory) and, for an off-diagonal tile of the
//     symmetric mode, the other 128 its columns times theta^2 V_I (Y_J).
//     A template parameter sizes that product for r = 1, <= 8 or <= 16
//     right-hand sides; wider V runs in chunks.
//   * Symmetric schedule: with T row tiles, row tile I takes the tiles
//     (I, (I + o) mod T) for o = 0 .. L_I - 1, L_I = (T + 1) / 2 when T is
//     odd; when T is even, T / 2 + 1 for I < T / 2 and T / 2 for the rest.
//     Every unordered pair appears once, and every row the same number of
//     tiles within one.  Each row's list is cut into `nseg` segments whose
//     lengths differ by at most one; the caller picks nseg for the fewest
//     waves of equal blocks.  A block walks its segment rotated by I, so
//     the 16 neighbouring rows of a block group (consecutive block indices)
//     read the same few column slabs at a time and X stays in the L2.
//   * No float atomics: Y_I of segment s goes to rowpart[s], and the
//     transposed product of tile (I, J = I + o) to colpart[o - 1] at J's
//     rows; a second kernel sums the row parts by segment and then the
//     column parts by offset, in that fixed order.  Runs repeat bit for
//     bit.  colpart holds (L - 1) n r_chunk values, r_chunk = min(r, 16):
//     669 MB at n = 36 551, r >= 16, but n^2 / 32 bytes a right-hand side
//     in f64 as n grows.  So the caller runs the symmetric mode only while
//     colpart fits its scratch budget, and the square product on the full
//     grid (the rectangular mode, no colpart, twice the tiles) past it.
//   * The rectangular mode walks column tiles J = lo .. hi - 1 of its
//     segment (no symmetry, no column parts), every row of a block group
//     on the same J at once.  Ragged tails in m, n, d and r are masked:
//     zero-filled loads, and a zero row of V contributes nothing.
//
// Plain C interface: the entry point returns cudaGetLastError() (0 = ok) and
// launches on the stream it is given.  Scratch (norms, rowpart, colpart) and
// the output are allocated by the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;    // rows and columns of a Gram tile
constexpr int kStages = 4;    // cp.async ring depth
constexpr int kLdk = kTile + 1;
constexpr int kRowGroup = 16;  // row tiles of consecutive blocks
constexpr int kMaxR = 16;      // right-hand sides per launch
constexpr int kNormRowsPerBlock = kThreads / 32;

template <typename T>
struct Chunk;
template <>
struct Chunk<double> {
  static constexpr int kDepth = 16;  // features a stage holds
  static constexpr int kLd = 20;     // row stride: 20 = 4 (mod 16) 8-byte banks
};
template <>
struct Chunk<float> {
  static constexpr int kDepth = 32;
  static constexpr int kLd = 36;     // 36 = 4 (mod 32) 4-byte banks
};

template <typename T, int RC>
constexpr int tile_smem_bytes() {
  constexpr int ring = kStages * 2 * kTile * Chunk<T>::kLd * (int)sizeof(T);
  constexpr int gram = kTile * kLdk * (int)sizeof(T);
  return (ring > gram ? ring : gram) + 3 * kTile * RC * (int)sizeof(T);
}

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

// Tiles of row tile i in the symmetric schedule over t row tiles.
__host__ __device__ __forceinline__ int sym_len(int i, int t) {
  return (t & 1) ? (t + 1) / 2 : (i < t / 2 ? t / 2 + 1 : t / 2);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(BYTES), "r"(valid ? BYTES : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The product's gate: a device flag vector of `lanes` bools, `stride`
// elements apart (the solver's active flags).  Null: ungated.  Gated off
// (no flag set), every launch of the product writes zeros where it would
// have written its output and returns, so a frozen solver step costs three
// near-empty launches instead of the Gram tiles.
struct Gate {
  const bool* flags;
  int lanes;
  int64_t stride;

  __device__ __forceinline__ bool off() const {
    if (flags == nullptr) return false;
    for (int l = 0; l < lanes; ++l)
      if (flags[l * stride]) return false;
    return true;
  }
};

// sq[row] = |x[row]|^2, one warp per row.
template <typename T>
__global__ void __launch_bounds__(kThreads) row_sq_norms(
    const T* __restrict__ x, int64_t rows, int d, T* __restrict__ sq, Gate gate) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kNormRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp
  if (gate.off()) {
    if (lane == 0) sq[row] = T(0);
    return;
  }
  T s = T(0);
  for (int c = lane; c < d; c += 32) {
    const T v = x[row * d + c];
    s += v * v;
  }
  s = warp_sum(s);
  if (lane == 0) sq[row] = s;
}

// Features [k0, k0 + kDepth) of rows i0.. (side 0, from xr) and j0.. (side
// 1, from xc) into a stage; zeros past m, n and d.
template <typename T, int BYTES>
__device__ __forceinline__ void load_stage_w(T* stage, const T* __restrict__ xr,
                                             const T* __restrict__ xc, int64_t i0,
                                             int64_t j0, int64_t m, int64_t n, int d,
                                             int k0) {
  constexpr int kPer = BYTES / (int)sizeof(T);          // elements a copy
  constexpr int kCopies = Chunk<T>::kDepth / kPer;      // copies a row
  constexpr int kLd = Chunk<T>::kLd;
  // Kept rolled: unrolled, its addresses push the f64 accumulators to spill.
#pragma unroll 1
  for (int e = threadIdx.x; e < 2 * kTile * kCopies; e += kThreads) {
    const int side = e / (kTile * kCopies);
    const int rest = e - side * kTile * kCopies;
    const int row = rest / kCopies;
    const int q = rest - row * kCopies;
    const int64_t grow = (side ? j0 : i0) + row;
    const int k = k0 + q * kPer;
    const bool valid = grow < (side ? n : m) && k < d;
    const T* src = side ? xc : xr;
    cp_async<BYTES>(stage + (side * kTile + row) * kLd + q * kPer,
                    valid ? src + grow * d + k : src, valid);
  }
}

template <typename T>
__device__ __forceinline__ void load_stage(T* stage, const T* xr, const T* xc, int64_t i0,
                                           int64_t j0, int64_t m, int64_t n, int d, int k0,
                                           bool vec) {
  if (vec) {
    load_stage_w<T, 16>(stage, xr, xc, i0, j0, m, n, d, k0);
  } else {
    load_stage_w<T, (int)sizeof(T)>(stage, xr, xc, i0, j0, m, n, d, k0);
  }
}

// Cross-term accumulators of one thread.
//   f64: acc[mi][ni][v] is row (warp / 4) * 64 + 16 mi + g + 8 (v / 2),
//        column (warp % 4) * 32 + 8 ni + 2 t + v % 2, lane = 4 g + t.
//   f32: acc[a][b] is row ty + 16 a, column tx + 16 b (tx, ty below).
template <typename T>
struct Acc;
template <>
struct Acc<double> {
  double v[4][4][4];
};
template <>
struct Acc<float> {
  float v[8][8];
};

__device__ __forceinline__ void zero(Acc<double>& a) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) a.v[i][j][v] = 0.0;
}

__device__ __forceinline__ void zero(Acc<float>& a) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) a.v[i][j] = 0.0f;
}

// One stage (16 features) of the f64 cross term on the FP64 tensor cores.
__device__ __forceinline__ void tile_step(const double* stage, Acc<double>& acc) {
  constexpr int kLd = Chunk<double>::kLd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const double* a_base = stage + ((warp >> 2) * 64 + g) * kLd + t;
  const double* b_base = stage + (kTile + (warp & 3) * 32 + g) * kLd + t;
#pragma unroll
  for (int kk = 0; kk < Chunk<double>::kDepth; kk += 4) {
    double a[4][2], b[4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      a[mi][0] = a_base[(16 * mi) * kLd + kk];
      a[mi][1] = a_base[(16 * mi + 8) * kLd + kk];
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) b[ni] = b_base[(8 * ni) * kLd + kk];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        double(&c)[4] = acc.v[mi][ni];
        asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
            "{%0,%1,%2,%3};\n"
            : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
            : "d"(a[mi][0]), "d"(a[mi][1]), "d"(b[ni]));
      }
  }
}

// Lane layout of the f32 micro-tiles: 8 columns by 4 rows of threads a
// warp, so a warp's B loads touch 8 rows and its A loads 4.
__device__ __forceinline__ int f32_tx() {
  return (threadIdx.x & 7) + 8 * ((threadIdx.x >> 5) & 1);
}
__device__ __forceinline__ int f32_ty() {
  return ((threadIdx.x >> 3) & 3) + 4 * (threadIdx.x >> 6);
}

// One stage (32 features) of the f32 cross term by FMAs.
__device__ __forceinline__ void tile_step(const float* stage, Acc<float>& acc) {
  constexpr int kLd = Chunk<float>::kLd;
  const float* a_base = stage + f32_ty() * kLd;
  const float* b_base = stage + (kTile + f32_tx()) * kLd;
#pragma unroll 2
  for (int kk = 0; kk < Chunk<float>::kDepth; kk += 2) {
    float2 a[8], b[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      a[i] = *reinterpret_cast<const float2*>(a_base + 16 * i * kLd + kk);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      b[j] = *reinterpret_cast<const float2*>(b_base + 16 * j * kLd + kk);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc.v[i][j] = fmaf(a[i].x, b[j].x, acc.v[i][j]);
        acc.v[i][j] = fmaf(a[i].y, b[j].y, acc.v[i][j]);
      }
  }
}

template <typename T>
__device__ __forceinline__ T gauss(T sq_i, T sq_j, T cross, T inv_ls2) {
  T d2 = ((sq_i + sq_j) - T(2) * cross) * inv_ls2;
  d2 = d2 < T(0) ? T(0) : d2;  // NaN passes through, as in max()
  return exp_t(T(-0.5) * d2);
}

template <typename T>
__device__ __forceinline__ T norm_at(const T* sq, int64_t i0, int row, int64_t rows) {
  return i0 + row < rows ? sq[i0 + row] : T(0);
}

// The Gram tile from the accumulators into gram[row][col] (stride kLdk).
__device__ __forceinline__ void store_gram(const Acc<double>& acc, double* gram,
                                           const double* sq_r, const double* sq_c,
                                           int64_t i0, int64_t j0, int64_t m, int64_t n,
                                           double inv_ls2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp >> 2) * 64 + g, c0 = (warp & 3) * 32 + 2 * t;
  double sqj[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int v = 0; v < 2; ++v) sqj[ni][v] = norm_at(sq_c, j0, c0 + 8 * ni + v, n);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 16 * mi + 8 * h;
      const double sqi = norm_at(sq_r, i0, row, m);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int v = 0; v < 2; ++v)
          gram[row * kLdk + c0 + 8 * ni + v] =
              gauss(sqi, sqj[ni][v], acc.v[mi][ni][2 * h + v], inv_ls2);
    }
}

__device__ __forceinline__ void store_gram(const Acc<float>& acc, float* gram,
                                           const float* sq_r, const float* sq_c,
                                           int64_t i0, int64_t j0, int64_t m, int64_t n,
                                           float inv_ls2) {
  const int tx = f32_tx(), ty = f32_ty();
  float sqj[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) sqj[b] = norm_at(sq_c, j0, tx + 16 * b, n);
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const float sqi = norm_at(sq_r, i0, ty + 16 * a, m);
#pragma unroll
    for (int b = 0; b < 8; ++b)
      gram[(ty + 16 * a) * kLdk + tx + 16 * b] = gauss(sqi, sqj[b], acc.v[a][b], inv_ls2);
  }
}

// theta^2 V[row0 + k][c] for k < 128, c < RC into vs[k][c]; zeros past
// rows and rc.
template <typename T, int RC>
__device__ __forceinline__ void stage_v(T* vs, const T* __restrict__ v, int64_t row0,
                                        int64_t rows, int rc, int64_t ldv, T theta2) {
  for (int e = threadIdx.x; e < kTile * RC; e += kThreads) {
    const int k = e / RC, c = e - (e / RC) * RC;
    const int64_t gr = row0 + k;
    vs[e] = (gr < rows && c < rc) ? theta2 * v[gr * ldv + c] : T(0);
  }
}

// Partial Y over one segment of one row tile.  sym: the square product in
// the symmetric schedule (m == n, xr == xc); otherwise the rectangular
// product over column tiles.  rowpart is (nseg, m, rc); colpart (L - 1, n,
// rc) in the symmetric mode.
template <typename T, int RC>
__global__ void __launch_bounds__(kThreads, 1) rbf_tiles(
    const T* __restrict__ xr, const T* __restrict__ xc, const T* __restrict__ sq_r,
    const T* __restrict__ sq_c, int64_t m, int64_t n, int d, const T* __restrict__ v,
    int rc, int64_t ldv, T inv_ls2, T theta2, int sym, int nseg, int vec,
    T* __restrict__ rowpart, T* __restrict__ colpart, Gate gate) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kStageElems = 2 * kTile * Chunk<T>::kLd;
  constexpr int kRing = kStages * kStageElems;
  constexpr int kGram = kTile * kLdk;
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* gram = ring;  // laid over the drained ring in the epilogue
  T* vs_i = ring + (kRing > kGram ? kRing : kGram);
  T* vs_j = vs_i + kTile * RC;
  T* ys = vs_j + kTile * RC;

  const int tid = threadIdx.x;
  const int tr = (int)((m + kTile - 1) / kTile);
  const int tc = (int)((n + kTile - 1) / kTile);
  const int b = blockIdx.x;
  const int group = b / (kRowGroup * nseg);
  const int in_group = b - group * kRowGroup * nseg;
  const int group_rows = min(kRowGroup, tr - group * kRowGroup);
  const int seg = in_group / group_rows;
  const int ti = group * kRowGroup + (in_group - seg * group_rows);
  const int len_i = sym ? sym_len(ti, tc) : tc;
  const int lo = (int)((int64_t)seg * len_i / nseg);
  const int len = (int)((int64_t)(seg + 1) * len_i / nseg) - lo;
  const int64_t i0 = (int64_t)ti * kTile;
  const int nk = (d + Chunk<T>::kDepth - 1) / Chunk<T>::kDepth;

  // Gated off: this segment's row parts are zero; the column parts are
  // left unwritten (sum_parts, gated off too, reads neither).
  if (gate.off()) {
    for (int e = tid; e < kTile * rc; e += kThreads) {
      const int64_t row = i0 + e / rc;
      if (row < m) rowpart[((int64_t)seg * m + row) * rc + e % rc] = T(0);
    }
    return;
  }

  if (sym) stage_v<T, RC>(vs_i, v, i0, n, rc, ldv, theta2);
  for (int e = tid; e < kTile * RC; e += kThreads) ys[e] = T(0);
  __syncthreads();

  for (int step = 0; step < len; ++step) {
    int p = step;
    if (sym) {
      p = (step - ti) % len;
      if (p < 0) p += len;
    }
    const int o = lo + p;
    const int tj = sym ? (ti + o) % tc : o;
    const int64_t j0 = (int64_t)tj * kTile;

    Acc<T> acc;
    zero(acc);
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < nk)
        load_stage(ring + st * kStageElems, xr, xc, i0, j0, m, n, d,
                   st * Chunk<T>::kDepth, vec);
      cp_async_commit();
    }
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk kc has landed; chunk kc - 1's stage is free
      const int next = kc + kStages - 1;
      if (next < nk)
        load_stage(ring + (next % kStages) * kStageElems, xr, xc, i0, j0, m, n, d,
                   next * Chunk<T>::kDepth, vec);
      cp_async_commit();
      tile_step(ring + (kc % kStages) * kStageElems, acc);
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring

    store_gram(acc, gram, sq_r, sq_c, i0, j0, m, n, inv_ls2);
    stage_v<T, RC>(vs_j, v, j0, n, rc, ldv, theta2);
    __syncthreads();

    if (tid < kTile) {  // row tid: Y_I += K_IJ theta^2 V_J
      T out[RC];
#pragma unroll
      for (int c = 0; c < RC; ++c) out[c] = T(0);
      const T* krow = gram + tid * kLdk;
#pragma unroll 4
      for (int k = 0; k < kTile; ++k) {
        const T kv = krow[k];
#pragma unroll
        for (int c = 0; c < RC; ++c) out[c] += kv * vs_j[k * RC + c];
      }
#pragma unroll
      for (int c = 0; c < RC; ++c) ys[tid * RC + c] += out[c];
    } else if (sym && o > 0) {  // column j: Y_J += K_IJ^T theta^2 V_I
      const int j = tid - kTile;
      T out[RC];
#pragma unroll
      for (int c = 0; c < RC; ++c) out[c] = T(0);
#pragma unroll 4
      for (int k = 0; k < kTile; ++k) {
        const T kv = gram[k * kLdk + j];
#pragma unroll
        for (int c = 0; c < RC; ++c) out[c] += kv * vs_i[k * RC + c];
      }
      if (j0 + j < n) {
        T* dst = colpart + ((int64_t)(o - 1) * n + j0 + j) * rc;
#pragma unroll
        for (int c = 0; c < RC; ++c)
          if (c < rc) dst[c] = out[c];
      }
    }
    __syncthreads();  // the gram tile is read before the ring refills
  }

  if (tid < kTile && i0 + tid < m) {
    T* dst = rowpart + ((int64_t)seg * m + i0 + tid) * rc;
#pragma unroll
    for (int c = 0; c < RC; ++c)
      if (c < rc) dst[c] = ys[tid * RC + c];
  }
}

// y[row * ldy + c] = the segments' row parts in order, then (sym) the
// column parts in order of offset.
template <typename T>
__global__ void __launch_bounds__(kThreads) sum_parts(
    const T* __restrict__ rowpart, int nseg, const T* __restrict__ colpart, int sym,
    int64_t m, int rc, T* __restrict__ y, int64_t ldy, Gate gate) {
  const int64_t total = m * rc;
  const int tc = (int)((m + kTile - 1) / kTile);
  const int lmax = sym ? sym_len(0, tc) : 1;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const bool off = gate.off();
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += stride) {
    const int64_t row = e / rc;
    if (off) {
      y[row * ldy + (e - row * rc)] = T(0);
      continue;
    }
    T s = T(0);
    for (int sp = 0; sp < nseg; ++sp) s += rowpart[(int64_t)sp * total + e];
    const int tj = (int)(row / kTile);
    for (int o = 1; o < lmax; ++o) {
      const int ti = (tj - o + tc) % tc;
      if (o < sym_len(ti, tc)) s += colpart[(int64_t)(o - 1) * total + e];
    }
    y[row * ldy + (e - row * rc)] = s;
  }
}

template <typename T, int RC>
cudaError_t launch_tiles(const T* xr, const T* xc, const T* sq_r, const T* sq_c, int64_t m,
                         int64_t n, int d, const T* v, int rc, int64_t ldv, T inv_ls2,
                         T theta2, int sym, int nseg, int vec, T* rowpart, T* colpart,
                         Gate gate, cudaStream_t st) {
  constexpr int smem = tile_smem_bytes<T, RC>();
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      rbf_tiles<T, RC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (opt_in != cudaSuccess) return opt_in;
  const int64_t blocks = (m + kTile - 1) / kTile * nseg;
  rbf_tiles<T, RC><<<(unsigned)blocks, kThreads, smem, st>>>(
      xr, xc, sq_r, sq_c, m, n, d, v, rc, ldv, inv_ls2, theta2, sym, nseg, vec, rowpart,
      colpart, gate);
  return cudaGetLastError();
}

template <typename T>
int launch_rbf_matvec(const void* x_rows, const void* x_cols, void* sq_rows, void* sq_cols,
                      int64_t m, int64_t n, int d, const void* v, int r, double inv_ls,
                      double theta2, int sym, int nseg, void* rowpart, void* colpart, void* y,
                      Gate gate, void* stream) {
  if (m < 1 || n < 1 || d < 1 || r < 1 || nseg < 1 || (gate.flags != nullptr && gate.lanes < 1))
    return (int)cudaErrorInvalidValue;
  if (sym && (m != n || x_rows != x_cols || sq_rows != sq_cols))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xr = static_cast<const T*>(x_rows);
  const T* xc = static_cast<const T*>(x_cols);
  const int64_t norm_blocks = (m + kNormRowsPerBlock - 1) / kNormRowsPerBlock;
  row_sq_norms<T><<<(unsigned)norm_blocks, kThreads, 0, st>>>(xr, m, d,
                                                             static_cast<T*>(sq_rows), gate);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (sq_cols != sq_rows) {
    const int64_t col_blocks = (n + kNormRowsPerBlock - 1) / kNormRowsPerBlock;
    row_sq_norms<T><<<(unsigned)col_blocks, kThreads, 0, st>>>(xc, n, d,
                                                               static_cast<T*>(sq_cols), gate);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  const int vec = ((uintptr_t)x_rows % 16 == 0) && ((uintptr_t)x_cols % 16 == 0) &&
                  ((int64_t)d * (int64_t)sizeof(T)) % 16 == 0;
  const T inv_ls2 = static_cast<T>(inv_ls * inv_ls);
  const T th2 = static_cast<T>(theta2);
  const int64_t reduce_wanted = (m * kMaxR + kThreads - 1) / kThreads;
  const unsigned reduce_blocks = (unsigned)(reduce_wanted < 4096 ? reduce_wanted : 4096);
  for (int c0 = 0; c0 < r; c0 += kMaxR) {
    const int rc = r - c0 < kMaxR ? r - c0 : kMaxR;
    const T* vc = static_cast<const T*>(v) + c0;
    const T* sr = static_cast<const T*>(sq_rows);
    const T* sc = static_cast<const T*>(sq_cols);
    T* rp = static_cast<T*>(rowpart);
    T* cp = static_cast<T*>(colpart);
    if (rc == 1) {
      err = launch_tiles<T, 1>(xr, xc, sr, sc, m, n, d, vc, rc, r, inv_ls2, th2, sym, nseg,
                               vec, rp, cp, gate, st);
    } else if (rc <= 8) {
      err = launch_tiles<T, 8>(xr, xc, sr, sc, m, n, d, vc, rc, r, inv_ls2, th2, sym, nseg,
                               vec, rp, cp, gate, st);
    } else {
      err = launch_tiles<T, 16>(xr, xc, sr, sc, m, n, d, vc, rc, r, inv_ls2, th2, sym, nseg,
                                vec, rp, cp, gate, st);
    }
    if (err != cudaSuccess) return (int)err;
    sum_parts<T><<<reduce_blocks, kThreads, 0, st>>>(rp, nseg, cp, sym, m, rc,
                                                     static_cast<T*>(y) + c0, (int64_t)r, gate);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// K3: the square product, in the symmetric schedule (sym = 1) or on the
// full grid (sym = 0, colpart unused).  One norm buffer serves both sides.
#define REPRO_RBF_MATVEC_ENTRY_POINT(T, SUFFIX)                                    \
  extern "C" int rbf_matvec_##SUFFIX(const void* x, void* sq, int64_t n, int d,    \
                                     const void* v, int r, double inv_ls,          \
                                     double theta2, int sym, int nseg,             \
                                     void* rowpart, void* colpart, void* y,        \
                                     const void* gate, int lanes,                  \
                                     int64_t gate_stride, void* stream) {          \
    const Gate g = {static_cast<const bool*>(gate), lanes, gate_stride};           \
    return launch_rbf_matvec<T>(x, x, sq, sq, n, n, d, v, r, inv_ls, theta2,       \
                                sym != 0, nseg, rowpart, colpart, y, g, stream);   \
  }

REPRO_RBF_MATVEC_ENTRY_POINT(float, f32)
REPRO_RBF_MATVEC_ENTRY_POINT(double, f64)

// K8: the same tile kernel on (m rows x n columns), no symmetry.  The
// caller passes distinct norm buffers for X_rows (m) and X_cols (n), so both
// passes of the norm pre-kernel run.
#define REPRO_RBF_MATVEC_RECT_ENTRY_POINT(T, SUFFIX)                               \
  extern "C" int rbf_matvec_rect_##SUFFIX(                                         \
      const void* x_rows, const void* x_cols, void* sq_rows, void* sq_cols,        \
      int64_t m, int64_t n, int d, const void* v, int r, double inv_ls,            \
      double theta2, int nseg, void* rowpart, void* y, const void* gate,           \
      int lanes, int64_t gate_stride, void* stream) {                              \
    if (sq_rows == sq_cols) return (int)cudaErrorInvalidValue;                     \
    const Gate g = {static_cast<const bool*>(gate), lanes, gate_stride};           \
    return launch_rbf_matvec<T>(x_rows, x_cols, sq_rows, sq_cols, m, n, d, v, r,   \
                                inv_ls, theta2, 0, nseg, rowpart, nullptr, y, g,   \
                                stream);                                           \
  }

REPRO_RBF_MATVEC_RECT_ENTRY_POINT(float, f32)
REPRO_RBF_MATVEC_RECT_ENTRY_POINT(double, f64)
