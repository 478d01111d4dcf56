// Hand-written Hopper (sm_90a) kernels for the def-CG hot path.
//
// Each kernel replaces one Pallas TPU kernel of src/repro/kernels/cg_fused.py:
//
//   fused_cg_update          <- fused_cg_update_pallas          (cg_fused.py:122)
//   fused_rz_reduce          <- fused_rz_reduce_pallas          (cg_fused.py:252)
//   fused_deflate_direction  <- fused_deflate_direction_pallas  (cg_fused.py:426)
//   self_gram                <- self_gram_pallas                (cg_fused.py:558)
//   recombine_blocks         <- recombine_blocks_pallas         (cg_fused.py:639)
//   lsmr_update              <- lsmr_update_pallas              (cg_fused.py:336)
//
// All six are bound by device-memory bytes on the H100 (a few flops per
// element read), so each reads every input element once and writes every
// output element once.  The Pallas kernels carry reductions across a
// sequential grid in SMEM; here blocks run in no order, so every reduction is
// two-stage: per-block partials into a scratch buffer, then a second kernel
// that sums the partials in a fixed order.  No float atomics: runs repeat bit
// for bit.  Ragged tails are masked in-kernel (the TPU wrappers pad to
// (rows*128) tiles instead).
//
// Plain C interface: every entry point returns cudaGetLastError() (0 = ok)
// and launches on the stream it is given.  Scratch and outputs are allocated
// by the caller.  Accumulation is in the working type (f64 stays f64).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 16;          // deflation basis rows (k)
constexpr int kMaxGramRows = 128;  // rows of the stacked window S = [Z; AZ]
constexpr int kSmallGramRows = 64; // def-CG's windows: 2(k + ell) <= 64
constexpr int kGramTile = 32;      // columns of S staged in shared memory

// Upper-triangle pairs each thread owns for a window of `rows` rows.
__host__ __device__ constexpr int pairs_per_thread(int rows) {
  return (rows * (rows + 1) / 2 + kThreads - 1) / kThreads;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Sum over the block in a fixed order; the result is valid in thread 0.
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T warp_part[kWarps];
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  T s = T(0);
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) s += warp_part[w];
  }
  return s;
}

// Row q of the upper triangle (i <= j) of an m2 x m2 matrix, row-major.
__device__ __forceinline__ void pair_ij(int q, int m2, int* i, int* j) {
  int row = 0;
  int len = m2;
  while (q >= len) {
    q -= len;
    ++row;
    --len;
  }
  *i = row;
  *j = row + q;
}

// The k + 1 per-thread sums acc[0..k] of a block, summed over the block in a
// fixed order and written to row blockIdx.x of a (blocks, k + 1) partials
// buffer.
template <typename T>
__device__ __forceinline__ void store_block_partials(const T (&acc)[kMaxK + 1],
                                                     int k,
                                                     T* __restrict__ partials) {
  __shared__ T warp_part[kMaxK + 1][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j <= kMaxK; ++j) {
    if (j <= k) {
      const T v = warp_sum(acc[j]);
      if (lane == 0) warp_part[j][warp] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x <= k) {
    T s = T(0);
    for (int w = 0; w < kWarps; ++w) s += warp_part[threadIdx.x][w];
    partials[(int64_t)blockIdx.x * (k + 1) + threadIdx.x] = s;
  }
}

// ---------------------------------------------------------------------------
// fused_cg_update: x + a p, r - a ap, |r_new|^2, AW r_new
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) cg_update_partial(
    const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ p,
    const T* __restrict__ ap, const T* __restrict__ alpha_ptr,
    const T* __restrict__ aw, int k, int64_t n, T* __restrict__ xo,
    T* __restrict__ ro, T* __restrict__ partials) {
  const T alpha = *alpha_ptr;
  T acc[kMaxK + 1];
#pragma unroll
  for (int j = 0; j <= kMaxK; ++j) acc[j] = T(0);

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T rn = r[i] - alpha * ap[i];
    xo[i] = x[i] + alpha * p[i];
    ro[i] = rn;
    acc[0] += rn * rn;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < k) acc[j + 1] += aw[(int64_t)j * n + i] * rn;
    }
  }

  store_block_partials(acc, k, partials);
}

// ---------------------------------------------------------------------------
// fused_rz_reduce: r^T z, AW z (the preconditioned def-CG iteration's second
// pass: z = M^-1 r exists only after the residual update)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) rz_reduce_partial(
    const T* __restrict__ r, const T* __restrict__ z,
    const T* __restrict__ aw, int k, int64_t n, T* __restrict__ partials) {
  T acc[kMaxK + 1];
#pragma unroll
  for (int j = 0; j <= kMaxK; ++j) acc[j] = T(0);

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T zi = z[i];
    acc[0] += r[i] * zi;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < k) acc[j + 1] += aw[(int64_t)j * n + i] * zi;
    }
  }
  store_block_partials(acc, k, partials);
}

// Column c of a (rows, width) partials buffer, summed in a fixed order.
// Column 0 goes to *first, column c > 0 to rest[c - 1].
template <typename T>
__global__ void __launch_bounds__(kThreads) reduce_columns(
    const T* __restrict__ partials, int rows, int width, T* __restrict__ first,
    T* __restrict__ rest) {
  const int c = blockIdx.x;
  T s = T(0);
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    s += partials[(int64_t)i * width + c];
  }
  s = block_sum(s);
  if (threadIdx.x == 0) {
    if (c == 0) {
      *first = s;
    } else {
      rest[c - 1] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// fused_deflate_direction: p_new = beta p + r - mu^T W, optional (p, ap) row
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) deflate_direction(
    const T* __restrict__ r, const T* __restrict__ p,
    const T* __restrict__ beta_ptr, const T* __restrict__ w,
    const T* __restrict__ mu, int k, int64_t n, T* __restrict__ po,
    const T* __restrict__ ap, const int64_t* __restrict__ idx_ptr,
    T* __restrict__ p_buf, T* __restrict__ ap_buf) {
  __shared__ T mus[kMaxK];
  if (threadIdx.x < k) mus[threadIdx.x] = mu[threadIdx.x];
  __syncthreads();
  const T beta = *beta_ptr;
  const bool record = p_buf != nullptr;
  const int64_t row = record ? *idx_ptr : 0;

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T pi = p[i];
    T acc = beta * pi + r[i];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < k) acc -= mus[j] * w[(int64_t)j * n + i];
    }
    po[i] = acc;
    if (record) {
      p_buf[row * n + i] = pi;
      ap_buf[row * n + i] = ap[i];
    }
  }
}

// ---------------------------------------------------------------------------
// self_gram: S S^T for S of shape (m2, n)
// ---------------------------------------------------------------------------

// Block b owns columns [b*cols, (b+1)*cols) and writes the upper triangle of
// its partial gram (m2*(m2+1)/2 entries) to partials[b].  Instantiated for up
// to kRows rows: 64 (def-CG's windows; 9 pairs a thread) and 128 (the
// least-squares windows; 8 256 pairs, 33 a thread).  Each thread's (i, j)
// is packed into one int so its pair indices and sums stay in registers;
// the (128, 33) tile takes 33.8 KB of static shared memory in f64.  The
// 64-row instance keeps its register count, and so its occupancy: at 40
// rows the 128-row instance is 1.2x slower in f64 and 1.6x in f32
// (tools/self_gram_instances.py).
template <typename T, int kRows>
__global__ void __launch_bounds__(kThreads) self_gram_partial(
    const T* __restrict__ s, int m2, int64_t n, int64_t cols,
    T* __restrict__ partials) {
  constexpr int kPairs = pairs_per_thread(kRows);
  __shared__ T tile[kRows][kGramTile + 1];
  const int npairs = m2 * (m2 + 1) / 2;

  int pij[kPairs];  // (i << 8) | j, or -1 past npairs
  T acc[kPairs];
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int idx = threadIdx.x + q * kThreads;
    acc[q] = T(0);
    pij[q] = -1;
    if (idx < npairs) {
      int i, j;
      pair_ij(idx, m2, &i, &j);
      pij[q] = (i << 8) | j;
    }
  }

  const int64_t c0 = (int64_t)blockIdx.x * cols;
  const int64_t c1 = c0 + cols < n ? c0 + cols : n;
  for (int64_t t0 = c0; t0 < c1; t0 += kGramTile) {
    for (int e = threadIdx.x; e < m2 * kGramTile; e += kThreads) {
      const int row = e / kGramTile;
      const int col = e - row * kGramTile;
      const int64_t c = t0 + col;
      tile[row][col] = c < c1 ? s[(int64_t)row * n + c] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPairs; ++q) {
      if (pij[q] >= 0) {
        const T* ri = tile[pij[q] >> 8];
        const T* rj = tile[pij[q] & 0xff];
        T a = acc[q];
#pragma unroll 8
        for (int col = 0; col < kGramTile; ++col) {
          a += ri[col] * rj[col];
        }
        acc[q] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kPairs; ++q) {
    const int idx = threadIdx.x + q * kThreads;
    if (idx < npairs) partials[(int64_t)blockIdx.x * npairs + idx] = acc[q];
  }
}

// One block per upper-triangle entry: sum the partials in block order and
// write the entry to both (i, j) and (j, i).
template <typename T>
__global__ void __launch_bounds__(kThreads) self_gram_reduce(
    const T* __restrict__ partials, int nparts, int m2, T* __restrict__ out) {
  const int q = blockIdx.x;
  const int npairs = m2 * (m2 + 1) / 2;
  T v = T(0);
  for (int b = threadIdx.x; b < nparts; b += blockDim.x) {
    v += partials[(int64_t)b * npairs + q];
  }
  v = block_sum(v);
  if (threadIdx.x == 0) {
    int i, j;
    pair_ij(q, m2, &i, &j);
    out[i * m2 + j] = v;
    out[j * m2 + i] = v;
  }
}

// ---------------------------------------------------------------------------
// recombine_blocks: [u^T S_top; u^T S_bot] for S (2m, n), u (m, k)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads) recombine_blocks(
    const T* __restrict__ s, const T* __restrict__ u, int m, int k, int64_t n,
    T* __restrict__ out) {
  __shared__ T us[(kMaxGramRows / 2) * kMaxK];
  for (int e = threadIdx.x; e < m * k; e += blockDim.x) us[e] = u[e];
  __syncthreads();

  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; c < n;
       c += stride) {
    T top[kMaxK];
    T bot[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      top[j] = T(0);
      bot[j] = T(0);
    }
    for (int i = 0; i < m; ++i) {
      const T zt = s[(int64_t)i * n + c];
      const T zb = s[(int64_t)(m + i) * n + c];
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (j < k) {
          const T uij = us[i * k + j];
          top[j] += uij * zt;
          bot[j] += uij * zb;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < k) {
        out[(int64_t)j * n + c] = top[j];
        out[(int64_t)(k + j) * n + c] = bot[j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// lsmr_update: hbar' = h - c0 hbar, x' = x + c1 hbar', h' = v - c2 h
// ---------------------------------------------------------------------------

// One LSMR iteration's three vector recurrences (lsmr_update_pallas,
// cg_fused.py:336).  Bound by bytes: it reads x, hbar, h, v once and writes
// x', hbar', h' once (7n elements for 6n flops), so one grid-stride pass
// keeps hbar' in a register between its two uses.  c0, c1, c2 are 0-d device
// tensors computed by the Givens recurrences on the card: the kernel reads
// them through pointers and the loop never waits on the host.  No reduction,
// so blocks share nothing and the grid can fill every SM.
template <typename T>
__global__ void __launch_bounds__(kThreads) lsmr_update(
    const T* __restrict__ x, const T* __restrict__ hbar,
    const T* __restrict__ h, const T* __restrict__ v,
    const T* __restrict__ c0_ptr, const T* __restrict__ c1_ptr,
    const T* __restrict__ c2_ptr, int64_t n, T* __restrict__ xo,
    T* __restrict__ hbo, T* __restrict__ ho) {
  const T c0 = *c0_ptr;
  const T c1 = *c1_ptr;
  const T c2 = *c2_ptr;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const T hi = h[i];
    const T hb = hi - c0 * hbar[i];
    xo[i] = x[i] + c1 * hb;
    hbo[i] = hb;
    ho[i] = v[i] - c2 * hi;
  }
}

// ---------------------------------------------------------------------------
// host launchers
// ---------------------------------------------------------------------------

template <typename T>
int launch_cg_update(const void* x, const void* r, const void* p,
                     const void* ap, const void* alpha, const void* aw, int k,
                     int64_t n, void* xo, void* ro, void* partials,
                     int nblocks, void* rr, void* awr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cg_update_partial<T><<<nblocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(p), static_cast<const T*>(ap),
      static_cast<const T*>(alpha), static_cast<const T*>(aw), k, n,
      static_cast<T*>(xo), static_cast<T*>(ro), static_cast<T*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_columns<T><<<k + 1, kThreads, 0, st>>>(
      static_cast<const T*>(partials), nblocks, k + 1, static_cast<T*>(rr),
      static_cast<T*>(awr));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rz_reduce(const void* r, const void* z, const void* aw, int k,
                     int64_t n, void* partials, int nblocks, void* rz,
                     void* awz, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rz_reduce_partial<T><<<nblocks, kThreads, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(z),
      static_cast<const T*>(aw), k, n, static_cast<T*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_columns<T><<<k + 1, kThreads, 0, st>>>(
      static_cast<const T*>(partials), nblocks, k + 1, static_cast<T*>(rz),
      static_cast<T*>(awz));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_deflate(const void* r, const void* p, const void* beta,
                   const void* w, const void* mu, int k, int64_t n, void* po,
                   const void* ap, const void* idx, void* p_buf, void* ap_buf,
                   int nblocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  deflate_direction<T><<<nblocks, kThreads, 0, st>>>(
      static_cast<const T*>(r), static_cast<const T*>(p),
      static_cast<const T*>(beta), static_cast<const T*>(w),
      static_cast<const T*>(mu), k, n, static_cast<T*>(po),
      static_cast<const T*>(ap), static_cast<const int64_t*>(idx),
      static_cast<T*>(p_buf), static_cast<T*>(ap_buf));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_self_gram(const void* s, int m2, int64_t n, int64_t cols,
                     int nblocks, void* partials, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m2 <= kSmallGramRows) {
    self_gram_partial<T, kSmallGramRows><<<nblocks, kThreads, 0, st>>>(
        static_cast<const T*>(s), m2, n, cols, static_cast<T*>(partials));
  } else {
    self_gram_partial<T, kMaxGramRows><<<nblocks, kThreads, 0, st>>>(
        static_cast<const T*>(s), m2, n, cols, static_cast<T*>(partials));
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int npairs = m2 * (m2 + 1) / 2;
  self_gram_reduce<T><<<npairs, kThreads, 0, st>>>(
      static_cast<const T*>(partials), nblocks, m2, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_recombine(const void* s, const void* u, int m, int k, int64_t n,
                     void* out, int nblocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  recombine_blocks<T><<<nblocks, kThreads, 0, st>>>(
      static_cast<const T*>(s), static_cast<const T*>(u), m, k, n,
      static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_lsmr_update(const void* x, const void* hbar, const void* h,
                       const void* v, const void* c0, const void* c1,
                       const void* c2, int64_t n, void* xo, void* hbo,
                       void* ho, int nblocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lsmr_update<T><<<nblocks, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(hbar),
      static_cast<const T*>(h), static_cast<const T*>(v),
      static_cast<const T*>(c0), static_cast<const T*>(c1),
      static_cast<const T*>(c2), n, static_cast<T*>(xo),
      static_cast<T*>(hbo), static_cast<T*>(ho));
  return (int)cudaGetLastError();
}

}  // namespace

#define REPRO_CG_FUSED_ENTRY_POINTS(T, SUFFIX)                                 \
  extern "C" int fused_cg_update_##SUFFIX(                                     \
      const void* x, const void* r, const void* p, const void* ap,             \
      const void* alpha, const void* aw, int k, int64_t n, void* xo,           \
      void* ro, void* partials, int nblocks, void* rr, void* awr,              \
      void* stream) {                                                          \
    return launch_cg_update<T>(x, r, p, ap, alpha, aw, k, n, xo, ro,           \
                               partials, nblocks, rr, awr, stream);            \
  }                                                                            \
  extern "C" int fused_rz_reduce_##SUFFIX(                                     \
      const void* r, const void* z, const void* aw, int k, int64_t n,          \
      void* partials, int nblocks, void* rz, void* awz, void* stream) {        \
    return launch_rz_reduce<T>(r, z, aw, k, n, partials, nblocks, rz, awz,     \
                               stream);                                        \
  }                                                                            \
  extern "C" int fused_deflate_direction_##SUFFIX(                             \
      const void* r, const void* p, const void* beta, const void* w,           \
      const void* mu, int k, int64_t n, void* po, const void* ap,              \
      const void* idx, void* p_buf, void* ap_buf, int nblocks,                 \
      void* stream) {                                                          \
    return launch_deflate<T>(r, p, beta, w, mu, k, n, po, ap, idx, p_buf,      \
                             ap_buf, nblocks, stream);                         \
  }                                                                            \
  extern "C" int self_gram_##SUFFIX(const void* s, int m2, int64_t n,          \
                                    int64_t cols, int nblocks, void* partials, \
                                    void* out, void* stream) {                 \
    return launch_self_gram<T>(s, m2, n, cols, nblocks, partials, out,         \
                               stream);                                        \
  }                                                                            \
  extern "C" int recombine_blocks_##SUFFIX(const void* s, const void* u,       \
                                           int m, int k, int64_t n, void* out, \
                                           int nblocks, void* stream) {        \
    return launch_recombine<T>(s, u, m, k, n, out, nblocks, stream);           \
  }                                                                            \
  extern "C" int lsmr_update_##SUFFIX(                                         \
      const void* x, const void* hbar, const void* h, const void* v,           \
      const void* c0, const void* c1, const void* c2, int64_t n, void* xo,     \
      void* hbo, void* ho, int nblocks, void* stream) {                        \
    return launch_lsmr_update<T>(x, hbar, h, v, c0, c1, c2, n, xo, hbo, ho,    \
                                 nblocks, stream);                             \
  }

REPRO_CG_FUSED_ENTRY_POINTS(float, f32)
REPRO_CG_FUSED_ENTRY_POINTS(double, f64)
