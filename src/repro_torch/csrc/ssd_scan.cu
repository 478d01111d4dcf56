// Hand-written Hopper (sm_90a) kernels for the Mamba2 SSD chunked scan (K10).
//
// ssd_scan_* replaces ssd_scan_pallas (src/repro/kernels/ssd_scan.py:92, body
// _ssd_kernel :41).  For each (batch, head) and chunk k of c rows, with
// cs = cumsum(a dt) inside the chunk (f32, a fixed order):
//
//   G  = C B^T                                          (c x c, per group)
//   M  = exp(cs_t - cs_s) dt_s  for s <= t, else 0      (masked before the exp)
//   Y  = (M o G) X + exp(cs) (C H_k^T)                  (c x p)
//   H_{k+1} = exp(cs_c) H_k + X^T (exp(cs_c - cs) dt o B)   (p x n, f32)
//
// B and C are read by group (head / (h / g)), never repeated in memory.  The
// state can start from `h0` (b, h, p, n) and the final state can be written
// to `h_out`: the serving path's prefill.  Rows past l (the padded tail of
// the last chunk) load dt = 0 and x = B = C = 0, so they leave the state
// unchanged and the final state is exact.
//
// What bounds it: bytes.  x, B, C and dt are read once and y written once:
// at mamba2-1.3b's prefill (b 4, l 4096, h 64, p 64, g 1, n 128, c 128)
// 0.28 GB, 0.084 ms at 3.35 TB/s.  The operations it needs are fewer: M is
// lower-triangular, so C B^T (once per group and chunk) and (M o G) X take
// only their causal half, c(c + 1) n and c(c + 1) p flops, beside C H^T and
// X^T bw's 4c p n per chunk and head: 43 GFLOP there, 0.044 ms at the bf16
// tensor cores' 989 TFLOP/s.
//
// Design: the SSD decomposition of arXiv 2405.21060, section 6, in three
// launches on the caller's stream, so that every (batch, head, chunk) is an
// independent item (8 192 at the prefill, not 256 serial walks):
//
//   (a) chunk states, one block per (batch, chunk, heads of one group):
//       cs by a warp scan, w = exp(cs_c - cs) dt, S_k = X^T (w o B) into an
//       f32 scratch (b, h, chunks, p, n), cs into (b, h, chunks, c) and
//       exp(cs_c) into (b, h, chunks);
//   (b) state passing, one thread per (batch, head, state element), the
//       (batch, head) pairs on grid.x (no 65 535 limit), the blocks of
//       state elements on grid.y,
//       chunks in order, in f32, in place: S_k is replaced by H_k, the
//       state that enters chunk k, while H_{k+1} = exp(cs_c,k) H_k + S_k
//       runs from h0 (or 0); the last H goes to h_out;
//   (c) chunk outputs, one block per (batch, chunk, heads of one group):
//       Y = (M o G) X + exp(cs) (C H_k^T).
//
// The scratch is 4 b h chunks (p n + c + 1) bytes (272 MB at the prefill)
// and costs about 1.1 GB of traffic (S written, read and written again, H
// read), ~0.32 ms at 3.35 TB/s.  Chaining (b) into (a) instead (each block
// waiting on its predecessor's H_k through flags) measured no faster on
// the card: the per-head link latency sat on the chain's critical path.
//
// bf16 inputs run on the tensor cores: mma.sync.m16n8k16 bf16 -> f32, with
// K9's fragment code (csrc/flash_attention.cu).  A factor that is not bf16
// (X scaled by w in (a); M o G and the f32 state in (c)) is fed as a
// two-term split v = hi + lo, hi = bf16(v), lo = bf16(v - hi), two MMAs,
// so its products keep about 16 significant bits and ssd_plain (f32
// arithmetic) stays the yardstick at the bf16 tolerance.  C B^T has bf16
// inputs and is exact up to summation order.
//
//   * 256 threads (8 warps) a block; each block takes `hpb` heads of one
//     group (the wrapper's plan: up to 8), so one block forms G = C B^T once
//     and keeps it in registers for all its heads (at g = 1 that removes
//     G's c^2 n from 7 of every 8 heads).
//   * (a): warp w owns S rows 16 (w % 4) .. and 64 columns (w / 4); per
//     k-step of 16 rows of the chunk it loads X^T by ldmatrix.trans, scales
//     the fragment by w_t and splits it, and multiplies with B fragments
//     (ldmatrix.trans): 32 f32 accumulators.  66 KB of shared memory, up
//     to 3 blocks an SM.
//   * (c): warp w owns 16 rows t of the chunk (rows 16 w for w < 4, 16 (11 -
//     w) above, so the two warps of one scheduler share the causal work
//     evenly); G's row tile stays in 64 accumulators across heads, and only
//     the column tiles at or below the diagonal are formed.  Per head: H_k
//     is staged as f32, split into bf16 hi / lo tiles once per block, and
//     C H_k^T runs as two MMAs per tile; the rows are scaled by exp(cs_t);
//     then (M o G) is made in registers from G and split, and used as A
//     fragments as they lie (the m16n8 C layout is the m16k16 A layout), X
//     by ldmatrix.trans.  M's exponentials (ex2.approx): below the diagonal
//     tile as a row factor exp(cs_t - cs_r) times a column factor exp(cs_r -
//     cs_s) dt_s formed once per head (r the column tile's last row, both
//     exponents <= 0), on the diagonal tile one per element, masked first.
//     195 KB of shared memory, one block an SM.
//   * Every per-head input (X, dt, H_k, cs) goes to shared memory by
//     cp.async, double-buffered: head i + 1 loads while head i computes.
//     B, C and X rows are 16-byte copies straight from their views when the
//     wrapper finds them aligned (`vec`: p, n, the strides and the pointers
//     multiples of 8 elements), element copies otherwise.  Rows of 64 or
//     128 bf16 are XOR-swizzled in 16-byte chunks (chunk ^ (row & 7)), so
//     every ldmatrix phase reads 8 rows from 8 distinct bank groups.
//   * x, B and C are read where they lie: a view whose last dimension is
//     contiguous, heads packed, with a batch and a row stride of its own
//     (the torch.split of the Mamba mixer), so the wrapper copies nothing.
//
// f32 inputs keep the Pallas body's f32 arithmetic on the CUDA cores (no
// tensor cores, no TF32) on the same three passes, one 256-thread block per
// (batch, head, chunk): (a) forms w o B in shared memory and S in 4 x 8
// register tiles; (c) forms C H_k^T, G in 8 x 8 register tiles, M o G over
// C, then (M o G) X (198 KB of shared memory, one block an SM).
//
// c, p and n are rounded up to 16 in shared memory with zero rows and
// columns (rows past c: dt = 0, which changes nothing).  c <= 128, p <= 64,
// n <= 128.  Every output element is written by one thread, sums run in a
// fixed order and no float atomics are used, so two launches agree bit for
// bit.  The D skip is not here: the wrapper adds y + x d in the reference's
// dtype order.
//
// Plain C interface: the entry point launches the three passes on the
// stream and the grids it is given (the wrapper's plan, checked against
// what the kernels index) and returns the first cudaGetLastError() that is
// not 0.  Outputs and scratch are allocated by the caller.  Training's
// backward and forward-mode arms (ssd_scan_bwd_*, ssd_scan_jvp_*) are
// namespace grad below; the training forward is this entry point with its
// states scratch and cs kept.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;  // 8 warps
constexpr int kMaxC = 128, kMaxP = 64, kMaxN = 128;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Args {
  const T* x;           // (b, l, h, p) view: x[bi xb + t xl + head p + col]
  const float* dt;      // (b, l, h)
  const float* a;       // (h,)
  const T* bm;          // (b, l, g, n) view, strides bb, bl
  const T* cm;          // (b, l, g, n) view, strides cb, cl
  const float* h0;      // (b, h, p, n) or null
  T* y;                 // (b, l, h, p), contiguous
  float* h_out;         // (b, h, p, n) or null
  float* states;        // (b, h, chunks, p, n): S_k after (a), H_k after (b)
  float* cs;            // (b, h, chunks, c)
  float* decay;         // (b, h, chunks): exp(cs_c)
  long long xb, xl, bb, bl, cb, cl;
  int L, H, P, G, N, c, nch, hpb, vec;
};

__host__ __device__ inline int round16(int v) { return (v + 15) / 16 * 16; }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// One warp: cs[r] = sum over rows <= r of a dt (dts holds 128 rows, 0 past
// the chunk's valid rows).  Each lane sums its four consecutive rows in
// order, the lane totals are scanned by shuffles and the lane's exclusive
// prefix is added: a fixed order.  cs_c is the value at row c - 1;
// w[r] = exp(cs_c - cs[r]) dt[r].  cs (rows < c) and exp(cs_c) also go to
// global memory for the state and output passes.
__device__ void chunk_weights(const float* dts, float a_h, float* css, float* ws, float* cs_g,
                              float* decay, int c) {
  const int lane = threadIdx.x & 31;
  float v[4], run = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    run += dts[4 * lane + i] * a_h;
    v[i] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += up;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.f;
  float pick = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] += excl;
    if (i == ((c - 1) & 3)) pick = v[i];
  }
  const float tot = __shfl_sync(kFull, pick, (c - 1) >> 2);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * lane + i;
    css[r] = v[i];
    ws[r] = expf(tot - v[i]) * dts[r];
    if (r < c) cs_g[r] = v[i];
  }
  if (lane == 0) *decay = expf(tot);
}

// ---------------------------------------------------------------------------
// (b) state passing, shared by both dtypes
// ---------------------------------------------------------------------------

// Chunks whose loads are issued before their stores.  In place, a store
// may alias any later load, so each batch's loads wait behind the previous
// batch's stores: with 8 a batch the pass moved about half the bytes a
// second of a copy (PERF.md §6); 32 covers the prefill's chunks.  One state
// element a thread: four (16-byte accesses) with 32 loads in flight needed
// more than 255 registers.
constexpr int kPassBatch = 32;

__global__ void __launch_bounds__(kThreads)
ssd_scan_state_pass(float* __restrict__ states, const float* __restrict__ decay,
                    const float* __restrict__ h0, float* __restrict__ h_out, int nch, int pn) {
  const int e = blockIdx.y * kThreads + threadIdx.x;
  if (e >= pn) return;
  const size_t bh = blockIdx.x;
  float* s = states + bh * nch * pn + e;
  const float* dk = decay + bh * nch;
  float hcur = h0 != nullptr ? h0[bh * pn + e] : 0.f;
  for (int k0 = 0; k0 < nch; k0 += kPassBatch) {
    float v[kPassBatch];
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j)
      if (k0 + j < nch) v[j] = s[(size_t)(k0 + j) * pn];
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j) {
      if (k0 + j < nch) {
        s[(size_t)(k0 + j) * pn] = hcur;
        hcur = dk[k0 + j] * hcur + v[j];
      }
    }
  }
  if (h_out != nullptr) h_out[bh * pn + e] = hcur;
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int kTC = kMaxC / 16, kTP = kMaxP / 16, kTN = kMaxN / 16;

// Shared floats of (a) and (c) for padded sizes cp, pp, np_.
__host__ __device__ inline size_t state_floats(int cp, int pp, int np_) {
  return (size_t)cp * pp + (size_t)cp * (np_ + 1) + 3 * kMaxC;
}
__host__ __device__ inline size_t out_floats(int cp, int pp, int np_) {
  const int ldn = np_ + 1;
  const int cw = cp * ldn > cp * (cp + 1) ? cp * ldn : cp * (cp + 1);
  return (size_t)cp * pp + (size_t)cp * ldn + cw + (size_t)pp * ldn + 2 * kMaxC;
}

// Rows [0, cp) of a (rows, cols) block at src (row stride ld) into a
// shared f32 tile of width w; zeros past `valid` rows and `cols` columns.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, long long ld,
                                          int cp, int w, int valid, int cols) {
  for (int e = threadIdx.x; e < cp * w; e += kThreads) {
    const int r = e / w, col = e % w;
    dst[e] = (r < valid && col < cols) ? to_f32(src[r * ld + col]) : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_chunk_state_simt(const Args<float> A) {
  const int cp = round16(A.c), pp = round16(A.P), np_ = round16(A.N);
  const int ldn = np_ + 1;
  extern __shared__ float smem[];
  float* xs = smem;               // cp x pp
  float* bs = xs + cp * pp;       // cp x ldn: B, then exp(cs_c - cs) dt o B
  float* dts = bs + cp * ldn;     // kMaxC
  float* css = dts + kMaxC;
  float* ws = css + kMaxC;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int tx = tid % 16, ty = tid / 16;
  const int head = blockIdx.x, k = blockIdx.y, bi = blockIdx.z;
  const int grp = head / (A.H / A.G);
  const int t0 = k * A.c;
  const int valid = min(A.c, A.L - t0);
  const size_t item = ((size_t)bi * A.H + head) * A.nch + k;

  load_rows(xs, A.x + bi * A.xb + t0 * A.xl + head * A.P, A.xl, cp, pp, valid, A.P);
  load_rows(bs, A.bm + bi * A.bb + t0 * A.bl + grp * A.N, A.bl, cp, ldn, valid, A.N);
  if (tid < kMaxC)
    dts[tid] = tid < valid ? A.dt[((size_t)bi * A.L + t0 + tid) * A.H + head] : 0.f;
  __syncthreads();
  if (warp == 0)
    chunk_weights(dts, A.a[head], css, ws, A.cs + item * A.c, A.decay + item, A.c);
  __syncthreads();
  for (int e = tid; e < cp * np_; e += kThreads) {
    const int r = e / np_, col = e % np_;
    bs[r * ldn + col] *= ws[r];
  }
  __syncthreads();

  // S = X^T bw: this thread's rows ty + 16i (of p), columns tx + 16j (of n).
  const int tp = pp / 16, tn = np_ / 16;
  float acc[kTP][kTN];
#pragma unroll
  for (int i = 0; i < kTP; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  for (int s = 0; s < cp; ++s) {
    float xv[kTP], bv[kTN];
#pragma unroll
    for (int i = 0; i < kTP; ++i) xv[i] = i < tp ? xs[s * pp + ty + 16 * i] : 0.f;
#pragma unroll
    for (int j = 0; j < kTN; ++j) bv[j] = j < tn ? bs[s * ldn + tx + 16 * j] : 0.f;
#pragma unroll
    for (int i = 0; i < kTP; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
  }
  float* out = A.states + item * A.P * A.N;
#pragma unroll
  for (int i = 0; i < kTP; ++i) {
    const int r = ty + 16 * i;
    if (r >= A.P) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = tx + 16 * j;
      if (col < A.N) out[r * A.N + col] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_chunk_out_simt(const Args<float> A) {
  const int cp = round16(A.c), pp = round16(A.P), np_ = round16(A.N);
  const int ldn = np_ + 1, ldw = cp + 1;
  extern __shared__ float smem[];
  float* xs = smem;               // cp x pp
  float* bs = xs + cp * pp;       // cp x ldn
  float* cw = bs + cp * ldn;      // cp x ldn: C, then cp x ldw: M o G
  const int cw_size = cp * ldn > cp * ldw ? cp * ldn : cp * ldw;
  float* hs = cw + cw_size;       // pp x ldn: H_k
  float* css = hs + pp * ldn;     // kMaxC
  float* dts = css + kMaxC;       // kMaxC

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int head = blockIdx.x, k = blockIdx.y, bi = blockIdx.z;
  const int grp = head / (A.H / A.G);
  const int t0 = k * A.c;
  const int valid = min(A.c, A.L - t0);
  const size_t item = ((size_t)bi * A.H + head) * A.nch + k;

  load_rows(xs, A.x + bi * A.xb + t0 * A.xl + head * A.P, A.xl, cp, pp, valid, A.P);
  load_rows(bs, A.bm + bi * A.bb + t0 * A.bl + grp * A.N, A.bl, cp, ldn, valid, A.N);
  load_rows(cw, A.cm + bi * A.cb + t0 * A.cl + grp * A.N, A.cl, cp, ldn, valid, A.N);
  load_rows(hs, A.states + item * A.P * A.N, (long long)A.N, pp, ldn, A.P, A.N);
  if (tid < kMaxC) {
    css[tid] = A.cs[item * A.c + min(tid, A.c - 1)];
    dts[tid] = tid < valid ? A.dt[((size_t)bi * A.L + t0 + tid) * A.H + head] : 0.f;
  }
  __syncthreads();
  const int tc = cp / 16, tp = pp / 16;

  // Y = exp(cs_t) (C H_k^T): rows ty + 16i, columns tx + 16j.
  float yacc[kTC][kTP];
#pragma unroll
  for (int i = 0; i < kTC; ++i)
#pragma unroll
    for (int j = 0; j < kTP; ++j) yacc[i][j] = 0.f;
  for (int kk = 0; kk < np_; ++kk) {
    float cv[kTC], hv[kTP];
#pragma unroll
    for (int i = 0; i < kTC; ++i) cv[i] = i < tc ? cw[(ty + 16 * i) * ldn + kk] : 0.f;
#pragma unroll
    for (int j = 0; j < kTP; ++j) hv[j] = j < tp ? hs[(tx + 16 * j) * ldn + kk] : 0.f;
#pragma unroll
    for (int i = 0; i < kTC; ++i)
#pragma unroll
      for (int j = 0; j < kTP; ++j) yacc[i][j] = fmaf(cv[i], hv[j], yacc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < kTC; ++i) {
    if (i >= tc) break;
    const float e = expf(css[ty + 16 * i]);
#pragma unroll
    for (int j = 0; j < kTP; ++j) yacc[i][j] *= e;
  }

  // G = C B^T in registers: rows t = ty + 16i, columns s = tx + 16j.
  float g[kTC][kTC];
#pragma unroll
  for (int i = 0; i < kTC; ++i)
#pragma unroll
    for (int j = 0; j < kTC; ++j) g[i][j] = 0.f;
  for (int kk = 0; kk < np_; ++kk) {
    float cv[kTC], bv[kTC];
#pragma unroll
    for (int i = 0; i < kTC; ++i) {
      cv[i] = i < tc ? cw[(ty + 16 * i) * ldn + kk] : 0.f;
      bv[i] = i < tc ? bs[(tx + 16 * i) * ldn + kk] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kTC; ++i)
#pragma unroll
      for (int j = 0; j < kTC; ++j) g[i][j] = fmaf(cv[i], bv[j], g[i][j]);
  }
  __syncthreads();  // every thread has read C

  // M o G over C.
#pragma unroll
  for (int i = 0; i < kTC; ++i) {
    if (i >= tc) break;
    const int t = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      if (j >= tc) break;
      const int s = tx + 16 * j;
      const float m = s <= t ? expf(css[t] - css[s]) * dts[s] : 0.f;
      cw[t * ldw + s] = m * g[i][j];
    }
  }
  __syncthreads();

  // Y += (M o G) X, written in x's dtype.
  for (int s = 0; s < cp; ++s) {
    float wv[kTC], xv[kTP];
#pragma unroll
    for (int i = 0; i < kTC; ++i) wv[i] = i < tc ? cw[(ty + 16 * i) * ldw + s] : 0.f;
#pragma unroll
    for (int j = 0; j < kTP; ++j) xv[j] = j < tp ? xs[s * pp + tx + 16 * j] : 0.f;
#pragma unroll
    for (int i = 0; i < kTC; ++i)
#pragma unroll
      for (int j = 0; j < kTP; ++j) yacc[i][j] = fmaf(wv[i], xv[j], yacc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < kTC; ++i) {
    const int r = ty + 16 * i;
    if (i >= tc || r >= valid) continue;
    float* yrow = A.y + (((size_t)bi * A.L + t0 + r) * A.H + head) * A.P;
#pragma unroll
    for (int j = 0; j < kTP; ++j) {
      const int col = tx + 16 * j;
      if (col < A.P) yrow[col] = yacc[i][j];
    }
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kXW = kMaxP;  // bf16 row width of the X tiles
constexpr int kBW = kMaxN;  // ... of the B, C and split-state tiles
constexpr int kTile = kMaxC * kBW;   // elements of a B or C tile
constexpr int kXTile = kMaxC * kXW;  // ... of an X tile
constexpr int kHTile = kMaxP * kBW;  // ... of a state tile
constexpr float kLog2e = 1.4426950408889634f;

// (a): B, X twice, dt twice, cs, w.
constexpr size_t kStateSmem = sizeof(bf16) * (kTile + 2 * kXTile) + sizeof(float) * 4 * kMaxC;
// (c): C, B, X twice, H_k split (hi, lo), H_k staged as f32 twice, cs and
// dt twice, the column factors of M.
constexpr size_t kOutSmem = sizeof(bf16) * (2 * kTile + 2 * kXTile + 2 * kHTile) +
                            sizeof(float) * (2 * kHTile + 5 * kMaxC);

// Element offset of 16-byte chunk `chunk` of row `row` in a tile of W-wide
// bf16 rows (W = 64 or 128): the chunk is XORed with row % 8, so the 8
// rows an ldmatrix phase reads fall in 8 distinct 16-byte bank groups.
template <int W>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * W + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [0, rows) of a swizzled tile of W-wide bf16 rows from global rows
// src + r ld (zeros at or past `valid` rows and `cols` columns).  With
// `vec`, 16-byte cp.async copies (cols a multiple of 8, src and ld 16-byte
// aligned); else element loads through registers.
template <int W>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* __restrict__ src, long long ld,
                                          int rows, int valid, int cols, bool vec) {
  constexpr int kChunks = W / 8;
  if (vec) {
    for (int e = threadIdx.x; e < rows * kChunks; e += kThreads) {
      const int r = e / kChunks, ch = e % kChunks;
      const bool ok = r < valid && ch * 8 < cols;
      cp_async16(tile + swz<W>(r, ch), ok ? src + r * ld + ch * 8 : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * W; e += kThreads) {
      const int r = e / W, col = e % W;
      tile[swz<W>(r, col >> 3) + (col & 7)] =
          (r < valid && col < cols) ? src[r * ld + col] : __float2bfloat16(0.f);
    }
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// d += a b for a 16 x 16 bf16 A (row), a 16 x 8 bf16 B (col), f32 d.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (v0, v1) = hi + lo: hi the bf16 pair nearest, lo the bf16 pair nearest
// the remainder (v0 in the low halves).
__device__ __forceinline__ void split2(float v0, float v1, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

__device__ __forceinline__ float2 unpack(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// 2^x by one MUFU.EX2 (results below 2^-126 flush to zero).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The chunk's rows of head `head`'s x and dt into stage buffers.
__device__ __forceinline__ void load_x_dt(const Args<bf16>& A, bf16* xt, float* dts, int bi,
                                          int head, int t0, int cp, int valid) {
  load_tile<kXW>(xt, A.x + bi * A.xb + t0 * A.xl + head * A.P, A.xl, cp, valid, A.P, A.vec);
  if (threadIdx.x < kMaxC) {
    const int r = threadIdx.x;
    const bool ok = r < valid;
    cp_async4(dts + r, A.dt + ((size_t)bi * A.L + t0 + (ok ? r : 0)) * A.H + head, ok);
  }
}

// Fragment layouts (lane = 4 g + t4): an m16n8 f32 accumulator holds
// (row g, cols 2t4, 2t4+1) in d[0..1] and (row g + 8, same cols) in d[2..3];
// an m16k16 A fragment holds (row g, k 2t4..) in a[0], (row g + 8) in a[1],
// k 8 + 2t4.. in a[2] and a[3]; a k16n8 B fragment holds (k 2t4, 2t4+1;
// col g) in b0 and k + 8 in b1.  ldmatrix.x4 lane l addresses row l % 8 of
// matrix l / 8 (mr, mi below).

// acc += (X o w)^T B over the chunk's cp rows for the warp's 16 rows mt..
// of p and 64 columns nh.. of n: X (time, p) by ldmatrix.trans, scaled by
// w_t and split, B (time, n) by ldmatrix.trans.  Pass (a), and with dY,
// e^cs and C in the places of X, w and B the backward's (a').
__device__ __forceinline__ void state_mma(float (&acc)[8][4], const bf16* xs, const float* ws,
                                          const bf16* bt, int cp, int np_, int mt, int nh) {
  const int lane = threadIdx.x & 31;
  const int t4 = lane & 3, mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int kk = 0; kk < kMaxC / 16; ++kk) {  // 16 rows of the chunk a step
    if (16 * kk >= cp) break;
    unsigned xa[4], ahi[4], alo[4];
    // A = (X o w)^T: X is stored (time, p), so ldmatrix.trans.
    ldsm_x4_trans(xa, xs + swz<kXW>(16 * kk + mr + (mi >> 1) * 8, 2 * mt + (mi & 1)));
    const float2 w0 = *reinterpret_cast<const float2*>(ws + 16 * kk + 2 * t4);
    const float2 w1 = *reinterpret_cast<const float2*>(ws + 16 * kk + 8 + 2 * t4);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 wv = r < 2 ? w0 : w1;
      const float2 xv = unpack(xa[r]);
      split2(xv.x * wv.x, xv.y * wv.y, ahi[r], alo[r]);
    }
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {  // 16 state columns: two tiles
      if (64 * nh + 16 * jp >= np_) break;
      unsigned b[4];
      ldsm_x4_trans(b, bt + swz<kBW>(16 * kk + mr + (mi & 1) * 8, 8 * nh + 2 * jp + (mi >> 1)));
      mma(acc[2 * jp], ahi, b[0], b[1]);
      mma(acc[2 * jp], alo, b[0], b[1]);
      mma(acc[2 * jp + 1], ahi, b[2], b[3]);
      mma(acc[2 * jp + 1], alo, b[2], b[3]);
    }
  }
}

// The warp's (16 x 64) tile of a (P x N) f32 state at `out` (rows mt, nh as
// in state_mma), plus `hfac` times the same elements of `add` when given.
__device__ __forceinline__ void store_state(const float (&acc)[8][4], float* out, int P, int N,
                                            int mt, int nh, const float* add = nullptr,
                                            float hfac = 0.f) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = 16 * mt + g + 8 * h2;
    if (r >= P) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * nh + 8 * j + 2 * t4;
      if (col >= N) continue;
      float v0 = acc[j][2 * h2], v1 = acc[j][2 * h2 + 1];
      if (add != nullptr) {
        v0 += hfac * add[r * N + col];
        if (col + 1 < N) v1 += hfac * add[r * N + col + 1];
      }
      float* o = out + r * N + col;
      if (pairs) {
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        o[0] = v0;
        if (col + 1 < N) o[1] = v1;
      }
    }
  }
}

// The warp's two rows ra, rb (< valid) of a (b, l, h, p) bf16 output from
// an m16n8 accumulator tile set over p: `row0` is the chunk's first row of
// the head, rows `ld` apart.
__device__ __forceinline__ void store_rows(const float (&acc)[8][4], bf16* row0, long long ld,
                                           int ra, int rb, int valid, int P) {
  const int t4 = threadIdx.x & 3;
  const bool pairs = (P & 1) == 0;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = h2 ? rb : ra;
    if (r >= valid) continue;
    bf16* row = row0 + r * ld;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * t4;
      if (col >= P) continue;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(acc[j][2 * h2], acc[j][2 * h2 + 1]);
      } else {
        row[col] = __float2bfloat16(acc[j][2 * h2]);
        if (col + 1 < P) row[col + 1] = __float2bfloat16(acc[j][2 * h2 + 1]);
      }
    }
  }
}

// The (P x N) f32 state at src (rows of N floats) split into bf16 hi / lo
// tiles of kBW-wide swizzled rows, rows [0, pp) x columns [0, np_), zeros
// past P and N.  16-byte loads when N is a multiple of 4.
__device__ __forceinline__ void split_state(bf16* hi, bf16* lo, const float* __restrict__ src,
                                            int P, int N, int pp, int np_) {
  const int q4 = np_ / 4;
  for (int e = threadIdx.x; e < pp * q4; e += kThreads) {
    const int r = e / q4, q = e % q4, col = 4 * q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < P) {
      const float* row = src + (size_t)r * N;
      if ((N & 3) == 0) {
        if (col < N) v = *reinterpret_cast<const float4*>(row + col);
      } else {
        v.x = col < N ? row[col] : 0.f;
        v.y = col + 1 < N ? row[col + 1] : 0.f;
        v.z = col + 2 < N ? row[col + 2] : 0.f;
        v.w = col + 3 < N ? row[col + 3] : 0.f;
      }
    }
    unsigned h01, l01, h23, l23;
    split2(v.x, v.y, h01, l01);
    split2(v.z, v.w, h23, l23);
    const int off = swz<kBW>(r, q >> 1) + (q & 1) * 4;
    *reinterpret_cast<uint2*>(hi + off) = make_uint2(h01, h23);
    *reinterpret_cast<uint2*>(lo + off) = make_uint2(l01, l23);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_chunk_state_tc(const Args<bf16> A) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* bt = reinterpret_cast<bf16*>(smem_raw);        // B: kMaxC x kBW
  bf16* xt = bt + kTile;                                // X: 2 stages of kMaxC x kXW
  float* dts = reinterpret_cast<float*>(xt + 2 * kXTile);  // 2 stages of kMaxC
  float* css = dts + 2 * kMaxC;
  float* ws = css + kMaxC;

  const int warp = threadIdx.x >> 5;
  const int k = blockIdx.y, bi = blockIdx.z;
  const int head0 = blockIdx.x * A.hpb;
  const int grp = head0 / (A.H / A.G);
  const int t0 = k * A.c;
  const int valid = min(A.c, A.L - t0);
  const int cp = round16(A.c), pp = round16(A.P), np_ = round16(A.N);
  const int mt = warp & 3, nh = warp >> 2;  // S rows 16 mt.., columns 64 nh..
  const bool active = 16 * mt < pp && 64 * nh < np_;

  load_tile<kBW>(bt, A.bm + bi * A.bb + t0 * A.bl + grp * A.N, A.bl, cp, valid, A.N, A.vec);
  load_x_dt(A, xt, dts, bi, head0, t0, cp, valid);
  cp_async_commit();
  if (A.hpb > 1) load_x_dt(A, xt + kXTile, dts + kMaxC, bi, head0 + 1, t0, cp, valid);
  cp_async_commit();

  for (int i = 0; i < A.hpb; ++i) {
    const int st = i & 1, head = head0 + i;
    const size_t item = ((size_t)bi * A.H + head) * A.nch + k;
    const bf16* xs = xt + st * kXTile;
    cp_async_wait<1>();  // everything but head i + 1 has landed
    __syncthreads();
    if (warp == 0)
      chunk_weights(dts + st * kMaxC, A.a[head], css, ws, A.cs + item * A.c, A.decay + item,
                    A.c);
    __syncthreads();

    if (active) {
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      state_mma(acc, xs, ws, bt, cp, np_, mt, nh);
      store_state(acc, A.states + item * A.P * A.N, A.P, A.N, mt, nh);
    }
    __syncthreads();  // stage st and w are consumed
    if (i + 2 < A.hpb)
      load_x_dt(A, xt + st * kXTile, dts + st * kMaxC, bi, head0 + i + 2, t0, cp, valid);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

// Head `head`'s x, dt, cs and H_k into stage buffers (H_k as f32).
__device__ __forceinline__ void load_head_out(const Args<bf16>& A, bf16* xt, float* hs,
                                              float* css, float* dts, int bi, int head, int k,
                                              int t0, int cp, int pp, int np_, int valid) {
  load_x_dt(A, xt, dts, bi, head, t0, cp, valid);
  const size_t item = ((size_t)bi * A.H + head) * A.nch + k;
  const float* src = A.states + item * A.P * A.N;
  if ((A.N & 3) == 0) {  // rows of N floats are 16-byte aligned
    const int q4 = np_ / 4;
    for (int e = threadIdx.x; e < pp * q4; e += kThreads) {
      const int r = e / q4, q = e % q4;
      const bool ok = r < A.P && 4 * q < A.N;
      cp_async16(hs + r * kMaxN + 4 * q, ok ? src + r * A.N + 4 * q : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < pp * np_; e += kThreads) {
      const int r = e / np_, col = e % np_;
      hs[r * kMaxN + col] = (r < A.P && col < A.N) ? src[r * A.N + col] : 0.f;
    }
  }
  if (threadIdx.x < kMaxC)
    cp_async4(css + threadIdx.x, A.cs + item * A.c + min((int)threadIdx.x, A.c - 1), true);
}

__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_chunk_out_tc(const Args<bf16> A) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ct = reinterpret_cast<bf16*>(smem_raw);  // C: kMaxC x kBW
  bf16* bt = ct + kTile;                         // B
  bf16* xt = bt + kTile;                         // X: 2 stages
  bf16* hhi = xt + 2 * kXTile;                   // H_k split: kMaxP x kBW each
  bf16* hlo = hhi + kHTile;
  float* hs = reinterpret_cast<float*>(hlo + kHTile);  // H_k f32: 2 stages of kMaxP x kMaxN
  float* css = hs + 2 * kHTile;                        // 2 stages of kMaxC
  float* dts = css + 2 * kMaxC;                        // 2 stages of kMaxC
  float* mcol = dts + 2 * kMaxC;                       // kMaxC

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int k = blockIdx.y, bi = blockIdx.z;
  const int head0 = blockIdx.x * A.hpb;
  const int grp = head0 / (A.H / A.G);
  const int t0 = k * A.c;
  const int valid = min(A.c, A.L - t0);
  const int cp = round16(A.c), pp = round16(A.P), np_ = round16(A.N);
  // This warp's 16 rows of the chunk: warps w and w + 4 share a scheduler,
  // and row tiles rt and 7 - rt carry 9 causal column tiles together.
  const int rt = warp < 4 ? warp : 11 - warp;
  const bool active = 16 * rt < cp;

  load_tile<kBW>(ct, A.cm + bi * A.cb + t0 * A.cl + grp * A.N, A.cl, cp, valid, A.N, A.vec);
  load_tile<kBW>(bt, A.bm + bi * A.bb + t0 * A.bl + grp * A.N, A.bl, cp, valid, A.N, A.vec);
  load_head_out(A, xt, hs, css, dts, bi, head0, k, t0, cp, pp, np_, valid);
  cp_async_commit();
  if (A.hpb > 1)
    load_head_out(A, xt + kXTile, hs + kHTile, css + kMaxC, dts + kMaxC, bi, head0 + 1, k, t0,
                  cp, pp, np_, valid);
  cp_async_commit();
  cp_async_wait<1>();  // C and B have landed
  __syncthreads();

  // G = C B^T for this warp's rows, column tiles at or below the diagonal.
  float gacc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) gacc[j][0] = gacc[j][1] = gacc[j][2] = gacc[j][3] = 0.f;
  if (active) {
#pragma unroll
    for (int kk = 0; kk < kMaxN / 16; ++kk) {
      if (16 * kk >= np_) break;
      unsigned ca[4];
      ldsm_x4(ca, ct + swz<kBW>(16 * rt + mr + (mi & 1) * 8, 2 * kk + (mi >> 1)));
#pragma unroll
      for (int jp = 0; jp < kMaxC / 16; ++jp) {  // 16 columns s: two tiles
        if (jp > rt) break;
        unsigned b[4];
        ldsm_x4(b, bt + swz<kBW>(16 * jp + mr + (mi >> 1) * 8, 2 * kk + (mi & 1)));
        mma(gacc[2 * jp], ca, b[0], b[1]);
        mma(gacc[2 * jp + 1], ca, b[2], b[3]);
      }
    }
  }

  const int ta = 16 * rt + g, tb = ta + 8;  // this thread's two rows
  for (int i = 0; i < A.hpb; ++i) {
    const int st = i & 1, head = head0 + i;
    const bf16* xs = xt + st * kXTile;
    const float* cs_s = css + st * kMaxC;
    const float* dt_s = dts + st * kMaxC;
    cp_async_wait<1>();  // everything but head i + 1 has landed
    __syncthreads();
    // M's column factors: M_ts = exp(cs_t - cs_r) exp(cs_r - cs_s) dt_s with r
    // the last row of s's 16-column tile; below the diagonal tile (s <= r <
    // t) both exponents are <= 0 as cs falls (a <= 0, dt >= 0, as the Mamba
    // mixer makes them), so neither factor overflows.
    if (threadIdx.x < kMaxC) {
      const int s = threadIdx.x;
      mcol[s] = ex2((cs_s[s | 15] - cs_s[s]) * kLog2e) * dt_s[s];
    }
    {  // H_k -> bf16 hi / lo tiles, once for the block
      const float* hsrc = hs + st * kHTile;
      const int q4 = np_ / 4;
      for (int e = threadIdx.x; e < pp * q4; e += kThreads) {
        const int r = e / q4, q = e % q4;
        const float4 v = *reinterpret_cast<const float4*>(hsrc + r * kMaxN + 4 * q);
        unsigned h01, l01, h23, l23;
        split2(v.x, v.y, h01, l01);
        split2(v.z, v.w, h23, l23);
        const int off = swz<kBW>(r, q >> 1) + (q & 1) * 4;
        *reinterpret_cast<uint2*>(hhi + off) = make_uint2(h01, h23);
        *reinterpret_cast<uint2*>(hlo + off) = make_uint2(l01, l23);
      }
    }
    __syncthreads();

    if (active) {
      float y[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
      // C H_k^T: B operand (k = state column, n = p row) from the (p, n) tiles.
#pragma unroll
      for (int kk = 0; kk < kMaxN / 16; ++kk) {
        if (16 * kk >= np_) break;
        unsigned ca[4];
        ldsm_x4(ca, ct + swz<kBW>(16 * rt + mr + (mi & 1) * 8, 2 * kk + (mi >> 1)));
#pragma unroll
        for (int dp = 0; dp < kMaxP / 16; ++dp) {
          if (16 * dp >= pp) break;
          const int off = swz<kBW>(16 * dp + mr + (mi >> 1) * 8, 2 * kk + (mi & 1));
          unsigned bh[4], bl[4];
          ldsm_x4(bh, hhi + off);
          ldsm_x4(bl, hlo + off);
          mma(y[2 * dp], ca, bh[0], bh[1]);
          mma(y[2 * dp], ca, bl[0], bl[1]);
          mma(y[2 * dp + 1], ca, bh[2], bh[3]);
          mma(y[2 * dp + 1], ca, bl[2], bl[3]);
        }
      }
      const float csa = cs_s[ta], csb = cs_s[tb];
      const float ea = expf(csa), eb = expf(csb);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y[j][0] *= ea;
        y[j][1] *= ea;
        y[j][2] *= eb;
        y[j][3] *= eb;
      }
      // (M o G) X, 16 columns s a step, s <= this warp's last row.
#pragma unroll
      for (int kk = 0; kk < kMaxC / 16; ++kk) {
        if (kk > rt) break;
        const int s0 = 16 * kk + 2 * t4;
        float w[2][4];
        if (kk < rt) {  // below the diagonal tile: row factor x column factor
          const float2 m0 = *reinterpret_cast<const float2*>(mcol + s0);
          const float2 m1 = *reinterpret_cast<const float2*>(mcol + s0 + 8);
          const float mc[4] = {m0.x, m0.y, m1.x, m1.y};
          const float cs_r = cs_s[16 * kk + 15];
          const float ra = ex2((csa - cs_r) * kLog2e), rb = ex2((csb - cs_r) * kLog2e);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              w[jj][e] = gacc[2 * kk + jj][e] * ((e < 2 ? ra : rb) * mc[2 * jj + (e & 1)]);
        } else {  // the diagonal tile: masked before the exp
          const float2 c0 = *reinterpret_cast<const float2*>(cs_s + s0);
          const float2 c1 = *reinterpret_cast<const float2*>(cs_s + s0 + 8);
          const float2 d0 = *reinterpret_cast<const float2*>(dt_s + s0);
          const float2 d1 = *reinterpret_cast<const float2*>(dt_s + s0 + 8);
          const float css4[4] = {c0.x, c0.y, c1.x, c1.y};
          const float dts4[4] = {d0.x, d0.y, d1.x, d1.y};
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = 2 * jj + (e & 1);
              const int s = s0 + 8 * jj + (e & 1);
              const int t = e < 2 ? ta : tb;
              const float cst = e < 2 ? csa : csb;
              w[jj][e] = s <= t ? gacc[2 * kk + jj][e] * (ex2((cst - css4[q]) * kLog2e) * dts4[q])
                                : 0.f;
            }
          }
        }
        unsigned whi[4], wlo[4];
        split2(w[0][0], w[0][1], whi[0], wlo[0]);
        split2(w[0][2], w[0][3], whi[1], wlo[1]);
        split2(w[1][0], w[1][1], whi[2], wlo[2]);
        split2(w[1][2], w[1][3], whi[3], wlo[3]);
#pragma unroll
        for (int dp = 0; dp < kMaxP / 16; ++dp) {
          if (16 * dp >= pp) break;
          unsigned b[4];
          ldsm_x4_trans(b, xs + swz<kXW>(16 * kk + mr + (mi & 1) * 8, 2 * dp + (mi >> 1)));
          mma(y[2 * dp], whi, b[0], b[1]);
          mma(y[2 * dp], wlo, b[0], b[1]);
          mma(y[2 * dp + 1], whi, b[2], b[3]);
          mma(y[2 * dp + 1], wlo, b[2], b[3]);
        }
      }
      store_rows(y, A.y + (((size_t)bi * A.L + t0) * A.H + head) * A.P, (long long)A.H * A.P,
                 ta, tb, valid, A.P);
    }
    __syncthreads();  // stage st and the split tiles are consumed
    if (i + 2 < A.hpb)
      load_head_out(A, xt + st * kXTile, hs + st * kHTile, css + st * kMaxC, dts + st * kMaxC,
                    bi, head0 + i + 2, k, t0, cp, pp, np_, valid);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

}  // namespace tc

// Launches on the caller's grids (the wrapper's plan): `grid` for the two
// chunk passes, `pass_grid` for the state pass.  Refuses sizes past the
// limits and grids that are not the ones the kernels index.
template <typename T>
int launch_ssd(const Args<T>& A, int b, dim3 grid, dim3 pass_grid, cudaStream_t stream) {
  if (b <= 0 || A.L <= 0 || A.H <= 0 || A.G <= 0 || A.H % A.G || A.P <= 0 || A.N <= 0 ||
      A.c <= 0 || A.c > kMaxC || A.P > kMaxP || A.N > kMaxN || A.nch != (A.L + A.c - 1) / A.c ||
      A.nch > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  constexpr bool kTensorCores = std::is_same<T, bf16>::value;
  const int hpb = kTensorCores ? A.hpb : 1;
  const int pn = A.P * A.N;
  if (hpb <= 0 || (A.H / A.G) % hpb || grid.x != (unsigned)(A.H / hpb) ||
      grid.y != (unsigned)A.nch || grid.z != (unsigned)b || (long long)b * A.H > 0x7fffffff ||
      pass_grid.x != (unsigned)(b * A.H) ||
      pass_grid.y != (unsigned)((pn + kThreads - 1) / kThreads) || pass_grid.z != 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (kTensorCores) {
    static const cudaError_t opt_in_a = cudaFuncSetAttribute(  // once per process
        tc::ssd_scan_chunk_state_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tc::kStateSmem);
    static const cudaError_t opt_in_c = cudaFuncSetAttribute(
        tc::ssd_scan_chunk_out_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)tc::kOutSmem);
    if (opt_in_a != cudaSuccess) return (int)opt_in_a;
    if (opt_in_c != cudaSuccess) return (int)opt_in_c;
    tc::ssd_scan_chunk_state_tc<<<grid, kThreads, tc::kStateSmem, stream>>>(A);
  } else {
    const int cp = round16(A.c), pp = round16(A.P), np_ = round16(A.N);
    static const cudaError_t opt_in_a = cudaFuncSetAttribute(
        simt::ssd_scan_chunk_state_simt, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * simt::state_floats(kMaxC, kMaxP, kMaxN)));
    static const cudaError_t opt_in_c = cudaFuncSetAttribute(
        simt::ssd_scan_chunk_out_simt, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * simt::out_floats(kMaxC, kMaxP, kMaxN)));
    if (opt_in_a != cudaSuccess) return (int)opt_in_a;
    if (opt_in_c != cudaSuccess) return (int)opt_in_c;
    simt::ssd_scan_chunk_state_simt<<<grid, kThreads,
                                      sizeof(float) * simt::state_floats(cp, pp, np_), stream>>>(A);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_scan_state_pass<<<pass_grid, kThreads, 0, stream>>>(A.states, A.decay, A.h0, A.h_out,
                                                          A.nch, pn);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if constexpr (kTensorCores) {
    tc::ssd_scan_chunk_out_tc<<<grid, kThreads, tc::kOutSmem, stream>>>(A);
  } else {
    const int cp = round16(A.c), pp = round16(A.P), np_ = round16(A.N);
    simt::ssd_scan_chunk_out_simt<<<grid, kThreads,
                                    sizeof(float) * simt::out_floats(cp, pp, np_), stream>>>(A);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The backward and the tangent map (training)
// ---------------------------------------------------------------------------
//
// With w_s = exp(cs_c - cs_s) dt_s, G = C B^T, E[t,s] = exp(cs_t - cs_s)
// [s <= t], M = E dt_s and Gamma_{k+1} the gradient reaching the state that
// leaves chunk k, the backward mirrors the forward's three passes:
//
//   (a') U_k = dY^T diag(exp(cs)) C for every (batch, head, chunk) item;
//   (b') the state pass run backwards in f32, in place: Gamma_k = U_k +
//        exp(cs_c,k) Gamma_{k+1} from Gamma_K = dh_out (or 0), slot k left
//        holding Gamma_{k+1}, Gamma_0 written to dh0, and each warp's partial
//        sum of <Gamma_{k+1}, H_k> written out (no atomics); up to
//        kPassBatch chunks' loads are issued before their stores, as in the
//        forward's pass;
//   (c') per item: G and Q = dY X^T; the row and column sums of dM o M (dM
//        = G o Q) and the column sums of dM o E; dX = (M o G)^T dY + diag(w)
//        B Gamma^T and omega_s = X_s Gamma B_s^T; dB = dG^T C + diag(w) X
//        Gamma and dC = dG B + diag(exp(cs)) dY H_k with dG = M o Q; psi_t =
//        C_t H_k^T dY_t^T; then dcs, its reverse cumulative sum dadt, ddt and
//        the item's da partial;
//   (r)  the dB and dC partials summed over each group in a fixed order and
//        rounded to the inputs' dtype, da summed over (batch, chunk) in order.
//
// The tangent map carries tangent pairs through the same passes: (a'') the
// tangent chunk state Xdot^T diag(w) B + X^T diag(wdot) B + X^T diag(w) Bdot
// + csdot_c exp(cs_c) H_k and csdot = cumsum(adot dt + a dtdot); (b'') the
// forward's own state pass from hdot0 (or 0); (c'') Ydot = (Mdot o G + M o
// Gdot) X + (M o G) Xdot + diag(exp(cs)) ((csdot o C + Cdot) H_k^T + C
// Hdot_k^T).  Both read the forward's states H_k and cs.  Every output
// element is written by one thread and every sum runs in a fixed order, so
// two launches agree bit for bit; no float atomics.
//
// What bounds them: bytes (x, B, C, dY or the tangents and the f32 states
// read once, the gradients written once: 22 us for the backward at
// mamba2-1.3b's training shape, b 2, l 1 024, h 64, p 64, n 128, c 128),
// against 15.1 GFLOP (backward) and 10.9 (tangent map) the function needs.
//
// f32 inputs: a first version that is right, on the CUDA cores (every
// product in f32, no TF32), one 256-thread block of 16 x 16 threads per
// item holding register tiles (rows ty + 16 i, columns tx + 16 j) over
// shared f32 tiles whose rows are padded to an odd stride; (c') in four
// launches through an (M o G, dG) scratch, the dB / dC partials one a head.
//
// bf16 inputs run on the tensor cores (the *_tc kernels), on the forward's
// layouts: one 256-thread block per (batch, chunk, heads of one group), up
// to 8 heads (the wrapper's plan), x, B, C and the tangents read in place
// from their views, rows of 64 / 128 bf16 XOR-swizzled for ldmatrix.  As in
// the forward, operands that are bf16 (x, B, C, dY, the tangents) go to
// mma.sync as they lie and every other factor (M o G, dG and its sum, Gamma,
// H_k, Hdot_k, the e^cs-, w- and wdot-scaled rows, Mdot o G + M o Gdot) as a
// two-term split hi + lo; f32 accumulators, each output rounded once.
//
//   * (a') is the forward's (a) with dY, e^cs and C for X, w and B.
//   * (c') is one kernel; the scores never leave the SM.  The warps own
//     rows s (16 a warp, paired as the forward pairs rows t) and form the
//     transposed scores G^T = B C^T and Q^T = X dY^T, only their causal
//     tiles (t >= s), so M o G and dG = M o Q land in registers as A
//     fragments with rows s: dX = (M o G)^T dY and dB's products take them as
//     they lie.  G^T is formed once a block into shared memory in fragment
//     order (each lane's four floats of an m16n8 tile contiguous: one
//     16-byte load a tile), since the dB and dC partials hold the
//     registers: each warp keeps its 16 rows of the block's dB (rows s) and
//     of its dC (rows t) in 64 + 64 accumulators across the heads (255
//     registers and 32 bytes of spill; a partial in shared memory, 64 KB,
//     would take the kernel's 214 KB past the 227 a block may use).  dG enters
//     both products linearly and B, C are the group's, so dG is summed over
//     the block's heads (in head order, in shared memory in fragment order)
//     and multiplied once a block: at the end the sum is split into (s, t)
//     hi / lo tiles (over the per-head tiles), read with ldmatrix for dG^T C
//     and with ldmatrix.trans (the dG side transposed) for dG B.  Per head:
//     B Gamma^T (omega), the causal tiles of Q^T with M by the forward's row
//     x column factor (ex2; masked on the diagonal tile), the dM sums, dX,
//     then diag(w) X Gamma into dB and diag(e^cs) dY H_k into dC (psi), with
//     Gamma, then H_k, split into one pair of tiles; dcs / dadt by warp 0
//     (a reverse warp scan).  214 KB of shared memory, one block an SM.
//   * (r) sums each group's block partials in block order (8 where f32 has
//     64 at the training shape) and, in its first block, da.
//   * (a'') is the forward's (a) with two split A operands, (Xdot o w + X o
//     wdot) against B and (X o w) against Bdot, plus csdot_c e^{cs_c} H_k;
//     csdot by the forward's warp scan.  (c'') is the forward's (c): rows t a
//     warp, G kept in registers and Gdot = Cdot B^T + C Bdot^T in shared
//     memory in fragment order across the heads (both in registers spilled;
//     B and Bdot's tiles then take H_k's and Hdot_k's splits), Mdot o G + M
//     o Gdot and M o G split as A fragments against X and Xdot, and csdot (C
//     H_k^T) + Cdot H_k^T + C Hdot_k^T for the state term.

namespace grad {

template <typename T>
struct GradArgs {
  const T* x;        // (b, l, h, p) view, strides xb, xl
  const T* bm;       // (b, l, g, n) view, strides bb, bl
  const T* cm;       // (b, l, g, n) view, strides cb, cl
  const float* dt;   // (b, l, h)
  const float* a;    // (h,)
  const float* hs;   // (b, h, chunks, p, n): the forward's H_k
  const float* cs;   // (b, h, chunks, c): the forward's cs
  long long xb, xl, bb, bl, cb, cl;
  int B, L, H, P, G, N, c, nch;
  int warps;                // the state pass's warps per (batch, head): dots per item
  int hpb, vec;             // bf16: heads a block; whether the views take 16-byte copies
  // The backward.
  const T* dy;              // (b, l, h, p), contiguous
  const float* dh_last;     // (b, h, p, n) or null
  T* dx;                    // (b, l, h, p)
  float* ddt;               // (b, l, h)
  float* da;                // (h,)
  T* db;                    // (b, l, g, n)
  T* dc;                    // (b, l, g, n)
  float* dh0;               // (b, h, p, n)
  float* grads;             // (b, h, chunks, p, n): U_k, then Gamma_{k+1}
  float* scores;            // f32: (b, h, chunks, 2, c, c): M o G, dG
  float* rows;              // f32: (b, h, chunks, 4, c): rowsum, colsum of dM o M, colsum dM o E, omega
  float* dots;              // (b h, chunks, warps of the state pass)
  float* dbp;               // (b, h / hpb, chunks, c, n): a head's (f32) or a block's (bf16)
  float* dcp;               // (b, h / hpb, chunks, c, n)
  float* dap;               // (b, h, chunks)
  // The tangent map.
  const T* tx;              // views like x, bm, cm
  const T* tbm;
  const T* tcm;
  const float* tdt;         // (b, l, h)
  const float* ta;          // (h,)
  const float* th0;         // (b, h, p, n) or null
  long long txb, txl, tbb, tbl, tcb, tcl;
  T* ty;                    // (b, l, h, p)
  float* th_last;           // (b, h, p, n)
  float* tstates;           // (b, h, chunks, p, n): tangent chunk states, then Hdot_k
  float* dcs;               // (b, h, chunks, c): csdot
  float* decay;             // (b, h, chunks): exp(cs_c)
};

constexpr int kTC = kMaxC / 16, kTP = kMaxP / 16, kTN = kMaxN / 16;

__device__ __forceinline__ void from_f32(float v, float* o) { *o = v; }
__device__ __forceinline__ void from_f32(float v, bf16* o) { *o = __float2bfloat16(v); }

// This block's item: (head, chunk, batch) from the grid, its group, first
// row, valid rows and index in the (b, h, chunks) scratch layouts.
struct Item {
  int head, k, bi, grp, t0, valid;
  size_t idx, bh;
};

template <typename T>
__device__ __forceinline__ Item item_of(const GradArgs<T>& A) {
  Item it;
  it.head = blockIdx.x;
  it.k = blockIdx.y;
  it.bi = blockIdx.z;
  it.grp = it.head / (A.H / A.G);
  it.t0 = it.k * A.c;
  it.valid = min(A.c, A.L - it.t0);
  it.bh = (size_t)it.bi * A.H + it.head;
  it.idx = it.bh * A.nch + it.k;
  return it;
}

// Rows [0, rows) x columns [0, width) of a shared f32 tile of row stride
// ld from src (row stride sld), times scale[r] when given; zeros at or past
// `valid` rows and `cols` columns.
template <typename TS>
__device__ __forceinline__ void load(float* dst, int ld, const TS* __restrict__ src, long long sld,
                                     int rows, int width, int valid, int cols,
                                     const float* scale = nullptr) {
  for (int e = threadIdx.x; e < rows * width; e += kThreads) {
    const int r = e / width, col = e % width;
    float v = 0.f;
    if (r < valid && col < cols) {
      v = to_f32(src[r * sld + col]);
      if (scale != nullptr) v *= scale[r];
    }
    dst[r * ld + col] = v;
  }
}

// acc[i][j] += sum over k < K of A(ty + 16 i, k) B(k, tx + 16 j), with
// A(r, k) = a[r ar + k ak] and B(k, col) = b[k bk + col bc] in shared
// memory; tiles i >= ti and j >= tj are left alone.
template <int TI, int TJ>
__device__ __forceinline__ void mm(float (&acc)[TI][TJ], const float* a, int ar, int ak,
                                   const float* b, int bk, int bc, int K, int ti, int tj) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int k = 0; k < K; ++k) {
    float av[TI], bv[TJ];
#pragma unroll
    for (int i = 0; i < TI; ++i) av[i] = i < ti ? a[(ty + 16 * i) * ar + k * ak] : 0.f;
#pragma unroll
    for (int j = 0; j < TJ; ++j) bv[j] = j < tj ? b[k * bk + (tx + 16 * j) * bc] : 0.f;
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int TI, int TJ>
__device__ __forceinline__ void zero(float (&acc)[TI][TJ]) {
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) acc[i][j] = 0.f;
}

// The padded sizes and odd row strides of an item's tiles.
struct Dims {
  int cp, pp, np_, ldc, ldp, ldn;
};

__host__ __device__ inline Dims dims_of(int c, int P, int N) {
  Dims d;
  d.cp = round16(c);
  d.pp = round16(P);
  d.np_ = round16(N);
  d.ldc = d.cp + 1;
  d.ldp = d.pp + 1;
  d.ldn = d.np_ + 1;
  return d;
}

// Shared floats of each kernel (the launch's dynamic shared memory).
__host__ __device__ inline size_t state_floats(const Dims& d) {  // (a')
  return (size_t)d.cp * d.ldp + (size_t)d.cp * d.ldn + kMaxC;
}
__host__ __device__ inline size_t big_tile(const Dims& d) {
  const size_t a = (size_t)d.cp * d.ldn, b = (size_t)d.cp * d.ldc;
  return a > b ? a : b;
}
__host__ __device__ inline size_t scores_floats(const Dims& d) {  // (c'1)
  const size_t r1 = 2 * (size_t)d.cp * d.ldn, red = 3 * (size_t)d.cp * 16;
  return (r1 > red ? r1 : red) + 2 * (size_t)d.cp * d.ldp + 2 * kMaxC;
}
__host__ __device__ inline size_t dx_floats(const Dims& d) {  // (c'2)
  return (size_t)d.cp * d.ldc + (size_t)d.cp * d.ldp + (size_t)d.cp * d.ldn +
         (size_t)d.pp * d.ldn + kMaxC + (size_t)d.cp * 16;
}
__host__ __device__ inline size_t db_floats(const Dims& d) {  // (c'3)
  return (size_t)d.cp * d.ldc + (size_t)d.cp * d.ldn + (size_t)d.cp * d.ldp +
         (size_t)d.pp * d.ldn + kMaxC;
}
__host__ __device__ inline size_t dc_floats(const Dims& d) {  // (c'4)
  return (size_t)d.cp * d.ldc + (size_t)d.cp * d.ldn + (size_t)d.cp * d.ldp +
         (size_t)d.pp * d.ldn + 4 * kMaxC + (size_t)d.cp * 16;
}
__host__ __device__ inline size_t jstate_floats(const Dims& d) {  // (a'')
  return 2 * (size_t)d.cp * d.ldp + 2 * (size_t)d.cp * d.ldn + 6 * kMaxC;
}
__host__ __device__ inline size_t small_tile(const Dims& d) {
  const size_t a = (size_t)d.cp * d.ldp, b = (size_t)d.pp * d.ldn;
  return a > b ? a : b;
}
__host__ __device__ inline size_t jout_floats(const Dims& d) {  // (c'')
  return 2 * big_tile(d) + 2 * small_tile(d) + 4 * kMaxC;
}

// cs of the item's rows (the last row's value past the chunk) and dt (0
// past the valid rows) into shared memory, rows [0, cp).
template <typename T>
__device__ __forceinline__ void load_cs_dt(const GradArgs<T>& A, const Item& it, const Dims& d,
                                           float* css, float* dts, const float* dtsrc) {
  for (int r = threadIdx.x; r < d.cp; r += kThreads) {
    css[r] = A.cs[it.idx * A.c + min(r, A.c - 1)];
    dts[r] = r < it.valid ? dtsrc[((size_t)it.bi * A.L + it.t0 + r) * A.H + it.head] : 0.f;
  }
}

// (a') U_k = dY^T diag(exp(cs)) C: rows p, columns n.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk_state(const GradArgs<T> A) {
  const Item it = item_of(A);
  const Dims d = dims_of(A.c, A.P, A.N);
  extern __shared__ float smem[];
  float* dys = smem;                     // cp x ldp
  float* cw = dys + d.cp * d.ldp;        // cp x ldn: exp(cs_t) C
  float* ecs = cw + d.cp * d.ldn;        // kMaxC
  for (int r = threadIdx.x; r < d.cp; r += kThreads)
    ecs[r] = r < it.valid ? expf(A.cs[it.idx * A.c + r]) : 0.f;
  __syncthreads();
  load(dys, d.ldp, A.dy + ((size_t)it.bi * A.L + it.t0) * A.H * A.P + it.head * A.P,
       (long long)A.H * A.P, d.cp, d.pp, it.valid, A.P);
  load(cw, d.ldn, A.cm + it.bi * A.cb + it.t0 * A.cl + it.grp * A.N, A.cl, d.cp, d.np_, it.valid,
       A.N, ecs);
  __syncthreads();
  float acc[kTP][kTN];
  zero(acc);
  mm(acc, dys, 1, d.ldp, cw, d.ldn, 1, d.cp, d.pp / 16, d.np_ / 16);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* out = A.grads + it.idx * A.P * A.N;
#pragma unroll
  for (int i = 0; i < kTP; ++i) {
    const int r = ty + 16 * i;
    if (r >= A.P) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = tx + 16 * j;
      if (col < A.N) out[r * A.N + col] = acc[i][j];
    }
  }
}

// (b') The state pass backwards, in place: one thread per (batch, head,
// state element), the (batch, head) pairs on grid.x.  Slot k of `grads`
// holds U_k on entry and Gamma_{k+1} on exit; each warp's sum of Gamma_{k+1}
// H_k over its 32 elements (a fixed shuffle tree) goes to `dots`.  Chunks
// are taken kPassBatch at a time from the last: their U_k, H_k and cs_c
// loads are all issued before the batch's stores (as in the forward's pass;
// the arithmetic and its order are the one-chunk-a-step loop's).  Two
// blocks an SM: left to itself the compiler took 168 registers, one block.
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_state_pass(float* __restrict__ grads, const float* __restrict__ hs,
                   const float* __restrict__ cs, const float* __restrict__ dh_last,
                   float* __restrict__ dh0, float* __restrict__ dots, int nch, int c, int pn) {
  const int e = blockIdx.y * kThreads + threadIdx.x;
  const bool on = e < pn;
  const size_t bh = blockIdx.x;
  const int warps = gridDim.y * (kThreads / 32);
  const int wid = blockIdx.y * (kThreads / 32) + (threadIdx.x >> 5);
  float g = (on && dh_last != nullptr) ? dh_last[bh * pn + e] : 0.f;
  for (int k1 = nch; k1 > 0; k1 -= kPassBatch) {  // chunks k1 - 1, k1 - 2, ...
    float u[kPassBatch], hv[kPassBatch], csc[kPassBatch];
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j) {
      const int k = k1 - 1 - j;
      u[j] = hv[j] = csc[j] = 0.f;
      if (k >= 0) {
        const size_t off = (bh * nch + k) * pn + e;
        if (on) {
          u[j] = grads[off];
          hv[j] = hs[off];
        }
        csc[j] = cs[(bh * nch + k) * c + c - 1];
      }
    }
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j) {
      const int k = k1 - 1 - j;
      if (k < 0) break;
      if (on) grads[(bh * nch + k) * pn + e] = g;
      float prod = g * hv[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) prod += __shfl_down_sync(kFull, prod, o);
      if ((threadIdx.x & 31) == 0) dots[(bh * nch + k) * warps + wid] = prod;
      g = expf(csc[j]) * g + u[j];
    }
  }
  if (on) dh0[bh * pn + e] = g;
}

// (c'1) G = C B^T and Q = dY X^T over the item's (t, s) tile; M o G and dG =
// M o Q to the scores scratch; the row and column sums of dM o M and the
// column sums of dM o E to the rows scratch.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_scores(const GradArgs<T> A) {
  const Item it = item_of(A);
  const Dims d = dims_of(A.c, A.P, A.N);
  extern __shared__ float smem[];
  const size_t r1 = scores_floats(d) - 2 * (size_t)d.cp * d.ldp - 2 * kMaxC;
  float* cw = smem;                      // cp x ldn: C
  float* bw = cw + d.cp * d.ldn;         // cp x ldn: B
  float* red = smem;                     // after G: 3 x cp x 16 partial sums
  float* dys = smem + r1;                // cp x ldp
  float* xs = dys + d.cp * d.ldp;        // cp x ldp
  float* css = xs + d.cp * d.ldp;        // kMaxC
  float* dts = css + kMaxC;              // kMaxC
  load_cs_dt(A, it, d, css, dts, A.dt);
  load(cw, d.ldn, A.cm + it.bi * A.cb + it.t0 * A.cl + it.grp * A.N, A.cl, d.cp, d.np_, it.valid,
       A.N);
  load(bw, d.ldn, A.bm + it.bi * A.bb + it.t0 * A.bl + it.grp * A.N, A.bl, d.cp, d.np_, it.valid,
       A.N);
  load(dys, d.ldp, A.dy + ((size_t)it.bi * A.L + it.t0) * A.H * A.P + it.head * A.P,
       (long long)A.H * A.P, d.cp, d.pp, it.valid, A.P);
  load(xs, d.ldp, A.x + it.bi * A.xb + it.t0 * A.xl + it.head * A.P, A.xl, d.cp, d.pp, it.valid,
       A.P);
  __syncthreads();
  const int tc = d.cp / 16;
  float g[kTC][kTC], q[kTC][kTC];
  zero(g);
  zero(q);
  mm(g, cw, d.ldn, 1, bw, 1, d.ldn, d.np_, tc, tc);
  mm(q, dys, d.ldp, 1, xs, 1, d.ldp, d.pp, tc, tc);
  __syncthreads();  // C and B are consumed: `red` takes their place

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float* pg = A.scores + it.idx * 2 * A.c * A.c;
  float* dg = pg + A.c * A.c;
  float rr[kTC], cc[kTC], ce[kTC];
#pragma unroll
  for (int i = 0; i < kTC; ++i) rr[i] = cc[i] = ce[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kTC; ++i) {
    if (i >= tc) break;
    const int t = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      if (j >= tc) break;
      const int s = tx + 16 * j;
      const float e = s <= t ? expf(css[t] - css[s]) : 0.f;
      const float m = e * dts[s];
      const float dm = g[i][j] * q[i][j];
      rr[i] += dm * m;
      cc[j] += dm * m;
      ce[j] += dm * e;
      if (t < A.c && s < A.c) {
        pg[t * A.c + s] = m * g[i][j];
        dg[t * A.c + s] = m * q[i][j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kTC; ++i) {
    if (i >= tc) break;
    red[(ty + 16 * i) * 16 + tx] = rr[i];
    red[d.cp * 16 + (tx + 16 * i) * 16 + ty] = cc[i];
    red[2 * d.cp * 16 + (tx + 16 * i) * 16 + ty] = ce[i];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < A.c; r += kThreads) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
    for (int u = 0; u < 16; ++u) {
      s0 += red[r * 16 + u];
      s1 += red[d.cp * 16 + r * 16 + u];
      s2 += red[2 * d.cp * 16 + r * 16 + u];
    }
    float* rw = A.rows + it.idx * 4 * A.c;
    rw[r] = s0;
    rw[A.c + r] = s1;
    rw[2 * A.c + r] = s2;
  }
}

// w_s = exp(cs_c - cs_s) dt_s for rows [0, cp) (0 past the valid rows).
template <typename T>
__device__ __forceinline__ void load_w(const GradArgs<T>& A, const Item& it, const Dims& d,
                                       float* ws) {
  const float csc = A.cs[it.idx * A.c + A.c - 1];
  for (int r = threadIdx.x; r < d.cp; r += kThreads)
    ws[r] = r < it.valid ? expf(csc - A.cs[it.idx * A.c + r]) *
                               A.dt[((size_t)it.bi * A.L + it.t0 + r) * A.H + it.head]
                         : 0.f;
}

// (c'2) dX = (M o G)^T dY + diag(w) B Gamma^T; omega_s = X_s . (B Gamma^T)_s.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_dx(const GradArgs<T> A) {
  const Item it = item_of(A);
  const Dims d = dims_of(A.c, A.P, A.N);
  extern __shared__ float smem[];
  float* ps = smem;                      // cp x ldc: M o G
  float* dys = ps + d.cp * d.ldc;        // cp x ldp
  float* bw = dys + d.cp * d.ldp;        // cp x ldn
  float* gam = bw + d.cp * d.ldn;        // pp x ldn: Gamma_{k+1}
  float* ws = gam + d.pp * d.ldn;        // kMaxC
  float* red = ws + kMaxC;               // cp x 16
  load(ps, d.ldc, A.scores + it.idx * 2 * A.c * A.c, (long long)A.c, d.cp, d.cp, A.c, A.c);
  load(dys, d.ldp, A.dy + ((size_t)it.bi * A.L + it.t0) * A.H * A.P + it.head * A.P,
       (long long)A.H * A.P, d.cp, d.pp, it.valid, A.P);
  load(bw, d.ldn, A.bm + it.bi * A.bb + it.t0 * A.bl + it.grp * A.N, A.bl, d.cp, d.np_, it.valid,
       A.N);
  load(gam, d.ldn, A.grads + it.idx * A.P * A.N, (long long)A.N, d.pp, d.np_, A.P, A.N);
  load_w(A, it, d, ws);
  __syncthreads();
  const int tc = d.cp / 16, tp = d.pp / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[kTC][kTP];
  zero(acc);
  mm(acc, bw, d.ldn, 1, gam, 1, d.ldn, d.np_, tc, tp);  // (B Gamma^T)[s][p]
  const T* xrow = A.x + it.bi * A.xb + it.t0 * A.xl + it.head * A.P;
#pragma unroll
  for (int i = 0; i < kTC; ++i) {
    if (i >= tc) break;
    const int s = ty + 16 * i;
    float om = 0.f;
#pragma unroll
    for (int j = 0; j < kTP; ++j) {
      const int p = tx + 16 * j;
      if (j < tp && s < it.valid && p < A.P) om += to_f32(xrow[s * A.xl + p]) * acc[i][j];
      acc[i][j] *= ws[s];
    }
    red[s * 16 + tx] = om;
  }
  mm(acc, ps, 1, d.ldc, dys, d.ldp, 1, d.cp, tc, tp);
#pragma unroll
  for (int i = 0; i < kTC; ++i) {
    const int s = ty + 16 * i;
    if (i >= tc || s >= it.valid) continue;
    T* out = A.dx + (((size_t)it.bi * A.L + it.t0 + s) * A.H + it.head) * A.P;
#pragma unroll
    for (int j = 0; j < kTP; ++j) {
      const int p = tx + 16 * j;
      if (j < tp && p < A.P) from_f32(acc[i][j], out + p);
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < A.c; r += kThreads) {
    float om = 0.f;
    for (int u = 0; u < 16; ++u) om += red[r * 16 + u];
    A.rows[it.idx * 4 * A.c + 3 * A.c + r] = om;
  }
}

// (c'3) The per-head dB partial dG^T C + diag(w) X Gamma: rows s, columns n.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_db(const GradArgs<T> A) {
  const Item it = item_of(A);
  const Dims d = dims_of(A.c, A.P, A.N);
  extern __shared__ float smem[];
  float* gs = smem;                      // cp x ldc: dG
  float* cw = gs + d.cp * d.ldc;         // cp x ldn: C
  float* xs = cw + d.cp * d.ldn;         // cp x ldp
  float* gam = xs + d.cp * d.ldp;        // pp x ldn
  float* ws = gam + d.pp * d.ldn;        // kMaxC
  load(gs, d.ldc, A.scores + it.idx * 2 * A.c * A.c + A.c * A.c, (long long)A.c, d.cp, d.cp, A.c,
       A.c);
  load(cw, d.ldn, A.cm + it.bi * A.cb + it.t0 * A.cl + it.grp * A.N, A.cl, d.cp, d.np_, it.valid,
       A.N);
  load(xs, d.ldp, A.x + it.bi * A.xb + it.t0 * A.xl + it.head * A.P, A.xl, d.cp, d.pp, it.valid,
       A.P);
  load(gam, d.ldn, A.grads + it.idx * A.P * A.N, (long long)A.N, d.pp, d.np_, A.P, A.N);
  load_w(A, it, d, ws);
  __syncthreads();
  const int tc = d.cp / 16, tn = d.np_ / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[kTC][kTN];
  zero(acc);
  mm(acc, xs, d.ldp, 1, gam, d.ldn, 1, d.pp, tc, tn);  // (X Gamma)[s][n]
#pragma unroll
  for (int i = 0; i < kTC; ++i) {
    const float w = i < tc ? ws[ty + 16 * i] : 0.f;
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] *= w;
  }
  mm(acc, gs, 1, d.ldc, cw, d.ldn, 1, d.cp, tc, tn);
  float* out = A.dbp + it.idx * A.c * A.N;
#pragma unroll
  for (int i = 0; i < kTC; ++i) {
    const int s = ty + 16 * i;
    if (i >= tc || s >= A.c) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = tx + 16 * j;
      if (j < tn && col < A.N) out[s * A.N + col] = acc[i][j];
    }
  }
}

// (c'4) The per-head dC partial dG B + diag(exp(cs)) dY H_k (rows t, columns
// n) and psi; then the item's dcs, dadt (reverse cumulative sum), ddt and da
// partial.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_dc(const GradArgs<T> A) {
  const Item it = item_of(A);
  const Dims d = dims_of(A.c, A.P, A.N);
  extern __shared__ float smem[];
  float* gs = smem;                      // cp x ldc: dG
  float* bw = gs + d.cp * d.ldc;         // cp x ldn: B
  float* dys = bw + d.cp * d.ldn;        // cp x ldp
  float* hsm = dys + d.cp * d.ldp;       // pp x ldn: H_k
  float* css = hsm + d.pp * d.ldn;       // kMaxC
  float* dts = css + kMaxC;              // kMaxC
  float* dcs = dts + kMaxC;              // kMaxC: dcs, then dadt
  float* wom = dcs + kMaxC;              // kMaxC: w omega
  float* red = wom + kMaxC;              // cp x 16
  load(gs, d.ldc, A.scores + it.idx * 2 * A.c * A.c + A.c * A.c, (long long)A.c, d.cp, d.cp, A.c,
       A.c);
  load(bw, d.ldn, A.bm + it.bi * A.bb + it.t0 * A.bl + it.grp * A.N, A.bl, d.cp, d.np_, it.valid,
       A.N);
  load(dys, d.ldp, A.dy + ((size_t)it.bi * A.L + it.t0) * A.H * A.P + it.head * A.P,
       (long long)A.H * A.P, d.cp, d.pp, it.valid, A.P);
  load(hsm, d.ldn, A.hs + it.idx * A.P * A.N, (long long)A.N, d.pp, d.np_, A.P, A.N);
  load_cs_dt(A, it, d, css, dts, A.dt);
  __syncthreads();
  const int tc = d.cp / 16, tn = d.np_ / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[kTC][kTN];
  zero(acc);
  mm(acc, dys, d.ldp, 1, hsm, d.ldn, 1, d.pp, tc, tn);  // Z = dY H_k: (t, n)
  const T* crow = A.cm + it.bi * A.cb + it.t0 * A.cl + it.grp * A.N;
#pragma unroll
  for (int i = 0; i < kTC; ++i) {
    if (i >= tc) break;
    const int t = ty + 16 * i;
    const float e = t < it.valid ? expf(css[t]) : 0.f;
    float psi = 0.f;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = tx + 16 * j;
      if (j < tn && t < it.valid && col < A.N) psi += to_f32(crow[t * A.cl + col]) * acc[i][j];
      acc[i][j] *= e;
    }
    red[t * 16 + tx] = psi;
  }
  mm(acc, gs, d.ldc, 1, bw, d.ldn, 1, d.cp, tc, tn);
  float* out = A.dcp + it.idx * A.c * A.N;
#pragma unroll
  for (int i = 0; i < kTC; ++i) {
    const int t = ty + 16 * i;
    if (i >= tc || t >= A.c) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = tx + 16 * j;
      if (j < tn && col < A.N) out[t * A.N + col] = acc[i][j];
    }
  }
  __syncthreads();

  // dcs per row: rowsum - colsum of dM o M + exp(cs) psi - w omega.
  const float* rw = A.rows + it.idx * 4 * A.c;
  const float csc = css[A.c - 1];
  for (int r = threadIdx.x; r < A.c; r += kThreads) {
    float psi = 0.f;
    for (int u = 0; u < 16; ++u) psi += red[r * 16 + u];
    const float w = expf(csc - css[r]) * dts[r];
    wom[r] = w * rw[3 * A.c + r];
    dcs[r] = rw[r] - rw[A.c + r] + (r < it.valid ? expf(css[r]) * psi : 0.f) - wom[r];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // The chunk's last row also carries exp(cs_c)'s and w's cs_c terms.
    const float* dp = A.dots + it.idx * A.warps;
    float dot = 0.f;
    for (int u = 0; u < A.warps; ++u) dot += dp[u];
    float wo = 0.f;
    for (int r = 0; r < A.c; ++r) wo += wom[r];
    dcs[A.c - 1] += wo + expf(csc) * dot;
    float run = 0.f, dap = 0.f;
    for (int r = A.c - 1; r >= 0; --r) {
      run += dcs[r];
      dcs[r] = run;
      dap += dts[r] * run;
    }
    A.dap[it.idx] = dap;
  }
  __syncthreads();
  const float ah = A.a[it.head];
  for (int r = threadIdx.x; r < it.valid; r += kThreads)
    A.ddt[((size_t)it.bi * A.L + it.t0 + r) * A.H + it.head] =
        rw[2 * A.c + r] + rw[3 * A.c + r] * expf(csc - css[r]) + ah * dcs[r];
}

// (r) dB and dC: the partials of each group (one a head in f32, one a
// block of hpb heads in bf16) summed in order, rounded once to the inputs'
// dtype; one thread per element.  In bf16 the first block then sums da as
// ssd_bwd_da does (f32 launches that kernel).
__device__ __forceinline__ void sum_da(const float* __restrict__ dap, float* da, int B, int H,
                                       int nch) {
  for (int hd = threadIdx.x; hd < H; hd += kThreads) {
    float s = 0.f;
    for (int bi = 0; bi < B; ++bi)
      for (int k = 0; k < nch; ++k) s += dap[((size_t)bi * H + hd) * nch + k];
    da[hd] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_group_sum(const GradArgs<T> A) {
  const size_t total = (size_t)A.B * A.L * A.G * A.N;
  const int parts = A.H / A.G / A.hpb, hb = A.H / A.hpb;  // partials a group, in all
  for (size_t e = blockIdx.x * (size_t)kThreads + threadIdx.x; e < total;
       e += (size_t)gridDim.x * kThreads) {
    const int col = (int)(e % A.N);
    size_t rest = e / A.N;
    const int grp = (int)(rest % A.G);
    rest /= A.G;
    const int t = (int)(rest % A.L);
    const size_t bi = rest / A.L;
    const int k = t / A.c, r = t % A.c;
    float sb = 0.f, sc = 0.f;
    for (int hh = 0; hh < parts; ++hh) {
      const size_t off = (((bi * hb + grp * parts + hh) * A.nch + k) * A.c + r) * A.N + col;
      sb += A.dbp[off];
      sc += A.dcp[off];
    }
    from_f32(sb, A.db + e);
    from_f32(sc, A.dc + e);
  }
  if constexpr (std::is_same<T, bf16>::value) {
    if (blockIdx.x == 0) sum_da(A.dap, A.da, A.B, A.H, A.nch);
  }
}

// (r) da: each head's partials summed over (batch, chunk) in order.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_da(const GradArgs<T> A) {
  sum_da(A.dap, A.da, A.B, A.H, A.nch);
}

// (a'') The tangent chunk state Xdot^T diag(w) B + X^T diag(wdot) B + X^T
// diag(w) Bdot + csdot_c exp(cs_c) H_k (rows p, columns n), csdot (one
// thread, in row order) and exp(cs_c).
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_jvp_chunk_state(const GradArgs<T> A) {
  const Item it = item_of(A);
  const Dims d = dims_of(A.c, A.P, A.N);
  extern __shared__ float smem[];
  float* x1 = smem;                      // cp x ldp: Xdot w + X wdot
  float* x2 = x1 + d.cp * d.ldp;         // cp x ldp: X w
  float* bw = x2 + d.cp * d.ldp;         // cp x ldn: B
  float* tbw = bw + d.cp * d.ldn;        // cp x ldn: Bdot
  float* css = tbw + d.cp * d.ldn;       // kMaxC each
  float* dts = css + kMaxC;
  float* tdts = dts + kMaxC;
  float* tcs = tdts + kMaxC;
  float* ws = tcs + kMaxC;
  float* tws = ws + kMaxC;
  load_cs_dt(A, it, d, css, dts, A.dt);
  load_cs_dt(A, it, d, tcs, tdts, A.tdt);  // tcs is overwritten below
  __syncthreads();
  const float ah = A.a[it.head], tah = A.ta[it.head];
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int r = 0; r < d.cp; ++r) {
      run += tah * dts[r] + ah * tdts[r];
      tcs[r] = run;
      if (r < A.c) A.dcs[it.idx * A.c + r] = run;
    }
    A.decay[it.idx] = expf(css[A.c - 1]);
  }
  __syncthreads();
  const float csc = css[A.c - 1], tcsc = tcs[A.c - 1];
  for (int r = threadIdx.x; r < d.cp; r += kThreads) {
    const float ew = expf(csc - css[r]);
    ws[r] = ew * dts[r];
    tws[r] = ws[r] * (tcsc - tcs[r]) + ew * tdts[r];
  }
  __syncthreads();
  const T* xsrc = A.x + it.bi * A.xb + it.t0 * A.xl + it.head * A.P;
  const T* txsrc = A.tx + it.bi * A.txb + it.t0 * A.txl + it.head * A.P;
  for (int e = threadIdx.x; e < d.cp * d.pp; e += kThreads) {
    const int r = e / d.pp, col = e % d.pp;
    float v1 = 0.f, v2 = 0.f;
    if (r < it.valid && col < A.P) {
      const float xv = to_f32(xsrc[r * A.xl + col]);
      v1 = to_f32(txsrc[r * A.txl + col]) * ws[r] + xv * tws[r];
      v2 = xv * ws[r];
    }
    x1[r * d.ldp + col] = v1;
    x2[r * d.ldp + col] = v2;
  }
  load(bw, d.ldn, A.bm + it.bi * A.bb + it.t0 * A.bl + it.grp * A.N, A.bl, d.cp, d.np_, it.valid,
       A.N);
  load(tbw, d.ldn, A.tbm + it.bi * A.tbb + it.t0 * A.tbl + it.grp * A.N, A.tbl, d.cp, d.np_,
       it.valid, A.N);
  __syncthreads();
  float acc[kTP][kTN];
  zero(acc);
  mm(acc, x1, 1, d.ldp, bw, d.ldn, 1, d.cp, d.pp / 16, d.np_ / 16);
  mm(acc, x2, 1, d.ldp, tbw, d.ldn, 1, d.cp, d.pp / 16, d.np_ / 16);
  const float hfac = tcsc * expf(csc);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float* hk = A.hs + it.idx * A.P * A.N;
  float* out = A.tstates + it.idx * A.P * A.N;
#pragma unroll
  for (int i = 0; i < kTP; ++i) {
    const int r = ty + 16 * i;
    if (r >= A.P) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = tx + 16 * j;
      if (col < A.N) out[r * A.N + col] = acc[i][j] + hfac * hk[r * A.N + col];
    }
  }
}

// (c'') Ydot = (Mdot o G + M o Gdot) X + (M o G) Xdot + diag(exp(cs))
// ((csdot o C + Cdot) H_k^T + C Hdot_k^T), with Gdot = Cdot B^T + C Bdot^T;
// G and Gdot stay in registers while their factors pass through two shared
// tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_jvp_chunk_out(const GradArgs<T> A) {
  const Item it = item_of(A);
  const Dims d = dims_of(A.c, A.P, A.N);
  extern __shared__ float smem[];
  const size_t bt = big_tile(d), st = small_tile(d);
  float* s0 = smem;                      // C, Cdot, C; W1; exp(cs)(csdot C + Cdot)
  float* s1 = s0 + bt;                   // B, B, Bdot; W0; exp(cs) C
  float* r2 = s1 + bt;                   // X; H_k
  float* r3 = r2 + st;                   // Xdot; Hdot_k
  float* css = r3 + st;                  // kMaxC each
  float* dts = css + kMaxC;
  float* tcs = dts + kMaxC;
  float* tdts = tcs + kMaxC;
  load_cs_dt(A, it, d, css, dts, A.dt);
  load_cs_dt(A, it, d, tcs, tdts, A.tdt);
  for (int r = threadIdx.x; r < d.cp; r += kThreads)
    tcs[r] = A.dcs[it.idx * A.c + min(r, A.c - 1)];
  const T* cg = A.cm + it.bi * A.cb + it.t0 * A.cl + it.grp * A.N;
  const T* bg = A.bm + it.bi * A.bb + it.t0 * A.bl + it.grp * A.N;
  const T* tcg = A.tcm + it.bi * A.tcb + it.t0 * A.tcl + it.grp * A.N;
  const T* tbg = A.tbm + it.bi * A.tbb + it.t0 * A.tbl + it.grp * A.N;
  load(s0, d.ldn, cg, A.cl, d.cp, d.np_, it.valid, A.N);
  load(s1, d.ldn, bg, A.bl, d.cp, d.np_, it.valid, A.N);
  __syncthreads();
  const int tc = d.cp / 16, tp = d.pp / 16;
  float g[kTC][kTC], gd[kTC][kTC];
  zero(g);
  zero(gd);
  mm(g, s0, d.ldn, 1, s1, 1, d.ldn, d.np_, tc, tc);  // C B^T
  __syncthreads();
  load(s0, d.ldn, tcg, A.tcl, d.cp, d.np_, it.valid, A.N);
  __syncthreads();
  mm(gd, s0, d.ldn, 1, s1, 1, d.ldn, d.np_, tc, tc);  // Cdot B^T
  __syncthreads();
  load(s0, d.ldn, cg, A.cl, d.cp, d.np_, it.valid, A.N);
  load(s1, d.ldn, tbg, A.tbl, d.cp, d.np_, it.valid, A.N);
  __syncthreads();
  mm(gd, s0, d.ldn, 1, s1, 1, d.ldn, d.np_, tc, tc);  // + C Bdot^T
  __syncthreads();

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kTC; ++i) {
    if (i >= tc) break;
    const int t = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kTC; ++j) {
      if (j >= tc) break;
      const int s = tx + 16 * j;
      const float e = s <= t ? expf(css[t] - css[s]) : 0.f;
      const float m = e * dts[s];
      const float tm = m * (tcs[t] - tcs[s]) + e * tdts[s];
      s0[t * d.ldc + s] = tm * g[i][j] + m * gd[i][j];
      s1[t * d.ldc + s] = m * g[i][j];
    }
  }
  load(r2, d.ldp, A.x + it.bi * A.xb + it.t0 * A.xl + it.head * A.P, A.xl, d.cp, d.pp, it.valid,
       A.P);
  load(r3, d.ldp, A.tx + it.bi * A.txb + it.t0 * A.txl + it.head * A.P, A.txl, d.cp, d.pp,
       it.valid, A.P);
  __syncthreads();
  float y[kTC][kTP];
  zero(y);
  mm(y, s0, d.ldc, 1, r2, d.ldp, 1, d.cp, tc, tp);
  mm(y, s1, d.ldc, 1, r3, d.ldp, 1, d.cp, tc, tp);
  __syncthreads();
  for (int e = threadIdx.x; e < d.cp * d.np_; e += kThreads) {
    const int r = e / d.np_, col = e % d.np_;
    float v0 = 0.f, v1 = 0.f;
    if (r < it.valid && col < A.N) {
      const float ec = expf(css[r]);
      const float cv = to_f32(cg[r * A.cl + col]);
      v0 = ec * (tcs[r] * cv + to_f32(tcg[r * A.tcl + col]));
      v1 = ec * cv;
    }
    s0[r * d.ldn + col] = v0;
    s1[r * d.ldn + col] = v1;
  }
  load(r2, d.ldn, A.hs + it.idx * A.P * A.N, (long long)A.N, d.pp, d.np_, A.P, A.N);
  load(r3, d.ldn, A.tstates + it.idx * A.P * A.N, (long long)A.N, d.pp, d.np_, A.P, A.N);
  __syncthreads();
  mm(y, s0, d.ldn, 1, r2, 1, d.ldn, d.np_, tc, tp);
  mm(y, s1, d.ldn, 1, r3, 1, d.ldn, d.np_, tc, tp);
#pragma unroll
  for (int i = 0; i < kTC; ++i) {
    const int t = ty + 16 * i;
    if (i >= tc || t >= it.valid) continue;
    T* out = A.ty + (((size_t)it.bi * A.L + it.t0 + t) * A.H + it.head) * A.P;
#pragma unroll
    for (int j = 0; j < kTP; ++j) {
      const int p = tx + 16 * j;
      if (j < tp && p < A.P) from_f32(y[i][j], out + p);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using tc::kBW;
using tc::kHTile;
using tc::kLog2e;
using tc::kTile;
using tc::kXTile;
using tc::kXW;
using tc::cp_async4;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ex2;
using tc::ldsm_x4;
using tc::ldsm_x4_trans;
using tc::load_tile;
using tc::mma;
using tc::split2;
using tc::split_state;
using tc::swz;
using tc::unpack;

// A block of the tensor-core passes: (heads of one group, chunk, batch).
struct Block {
  int k, bi, head0, grp, t0, valid, cp, pp, np_;
};

__device__ __forceinline__ Block block_of(const GradArgs<bf16>& A) {
  Block b;
  b.k = blockIdx.y;
  b.bi = blockIdx.z;
  b.head0 = blockIdx.x * A.hpb;
  b.grp = b.head0 / (A.H / A.G);
  b.t0 = b.k * A.c;
  b.valid = min(A.c, A.L - b.t0);
  b.cp = round16(A.c);
  b.pp = round16(A.P);
  b.np_ = round16(A.N);
  return b;
}

__device__ __forceinline__ size_t item_idx(const GradArgs<bf16>& A, const Block& b, int head) {
  return ((size_t)b.bi * A.H + head) * A.nch + b.k;
}

// The block's first rows of the (b, l, k, w) views it reads: x-like rows
// of `head`, B-like rows of the block's group.
__device__ __forceinline__ const bf16* head_rows(const bf16* v, long long sb, long long sl,
                                                 const GradArgs<bf16>& A, const Block& b,
                                                 int head) {
  return v + b.bi * sb + b.t0 * sl + head * A.P;
}
__device__ __forceinline__ const bf16* group_rows(const bf16* v, long long sb, long long sl,
                                                  const GradArgs<bf16>& A, const Block& b) {
  return v + b.bi * sb + b.t0 * sl + b.grp * A.N;
}
__device__ __forceinline__ const bf16* dy_rows(const GradArgs<bf16>& A, const Block& b,
                                               int head) {
  return A.dy + ((size_t)b.bi * A.L + b.t0) * A.H * A.P + head * A.P;
}

// Warp sums in a fixed butterfly order.
__device__ __forceinline__ float quad_sum(float v) {  // over the 4 lanes of a row
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// (a') U_k = (diag(e^cs) dY)^T C: the forward's pass (a) with dY, e^cs and C
// in the places of X, w and B.  Per head dY and cs are double-buffered by
// cp.async; C is loaded once for the block's heads.  67 KB of shared memory.
constexpr size_t kBwdStateSmem = sizeof(bf16) * (kTile + 2 * kXTile) + sizeof(float) * 3 * kMaxC;

__device__ __forceinline__ void load_dy_cs(const GradArgs<bf16>& A, const Block& b, bf16* yt,
                                           float* css, int head) {
  load_tile<kXW>(yt, dy_rows(A, b, head), (long long)A.H * A.P, b.cp, b.valid, A.P, A.vec);
  if (threadIdx.x < kMaxC)
    cp_async4(css + threadIdx.x,
              A.cs + item_idx(A, b, head) * A.c + min((int)threadIdx.x, A.c - 1), true);
}

__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_chunk_state_tc(const GradArgs<bf16> A) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ct = reinterpret_cast<bf16*>(smem_raw);            // C: kMaxC x kBW
  bf16* yt = ct + kTile;                                    // dY: 2 stages of kMaxC x kXW
  float* css = reinterpret_cast<float*>(yt + 2 * kXTile);  // cs: 2 stages of kMaxC
  float* ecs = css + 2 * kMaxC;                             // e^cs, 0 past the valid rows
  const Block b = block_of(A);
  const int warp = threadIdx.x >> 5;
  const int mt = warp & 3, nh = warp >> 2;  // U rows 16 mt.. (of p), columns 64 nh.. (of n)
  const bool active = 16 * mt < b.pp && 64 * nh < b.np_;
  load_tile<kBW>(ct, group_rows(A.cm, A.cb, A.cl, A, b), A.cl, b.cp, b.valid, A.N, A.vec);
  load_dy_cs(A, b, yt, css, b.head0);
  cp_async_commit();
  if (A.hpb > 1) load_dy_cs(A, b, yt + kXTile, css + kMaxC, b.head0 + 1);
  cp_async_commit();
  for (int i = 0; i < A.hpb; ++i) {
    const int st = i & 1, head = b.head0 + i;
    cp_async_wait<1>();  // everything but head i + 1 has landed
    __syncthreads();
    if (threadIdx.x < kMaxC) {
      const int r = threadIdx.x;
      ecs[r] = r < b.valid ? expf(css[st * kMaxC + r]) : 0.f;
    }
    __syncthreads();
    if (active) {
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      tc::state_mma(acc, yt + st * kXTile, ecs, ct, b.cp, b.np_, mt, nh);
      tc::store_state(acc, A.grads + item_idx(A, b, head) * A.P * A.N, A.P, A.N, mt, nh);
    }
    __syncthreads();  // stage st and e^cs are consumed
    if (i + 2 < A.hpb) load_dy_cs(A, b, yt + st * kXTile, css + st * kMaxC, head + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

// (c'), one kernel.  The warp's 16 rows (s for dX and dB, t for dC) are
// rs = warp for warps 0-3 and 11 - warp above, as the forward pairs them.
// G^T and the summed dG^T live in shared memory in fragment order: slot
// frag_slot(rs, jt) (+1) holds the m16n8 tiles of the warp's rows and
// columns 16 jt.. (+8) for jt >= rs, 32 lanes x 4 floats each.
constexpr int kFragSlots = 2 * (kMaxC / 16) * (kMaxC / 16 + 1) / 2;  // 72: the causal tiles

__device__ __forceinline__ int frag_slot(int rs, int jt) {
  return 2 * (8 * rs - rs * (rs - 1) / 2 + jt - rs);
}

// B, C, X, dY, a pair of split state tiles (Gamma, then H_k), G^T and the
// dG sum in fragment order, ten row vectors and the per-warp row sums.
constexpr size_t kBwdChunkSmem = sizeof(bf16) * (2 * kTile + 2 * kXTile + 2 * kHTile) +
                                 sizeof(float4) * 2 * kFragSlots * 32 +
                                 sizeof(float) * (10 + 8) * kMaxC;

__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_chunk_tc(const GradArgs<bf16> A) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* bt = reinterpret_cast<bf16*>(smem_raw);  // B: kMaxC x kBW
  bf16* ct = bt + kTile;                         // C
  bf16* xt = ct + kTile;                         // X: kMaxC x kXW
  bf16* yt = xt + kXTile;                        // dY
  bf16* shi = yt + kXTile;                       // Gamma_{k+1}, then H_k, split: kMaxP x kBW
  bf16* slo = shi + kHTile;
  bf16* dghi = xt;                               // at the end: the dG sum's (s, t) tiles, split
  bf16* dglo = xt + kTile;
  float4* gsm = reinterpret_cast<float4*>(slo + kHTile);  // G^T, fragment order
  float4* dgs = gsm + kFragSlots * 32;                    // the dG^T sum, fragment order
  float* css = reinterpret_cast<float*>(dgs + kFragSlots * 32);  // kMaxC each:
  float* dts = css + kMaxC;
  float* ws = dts + kMaxC;    // w
  float* ecs = ws + kMaxC;    // e^cs, 0 past the valid rows
  float* sfs = ecs + kMaxC;   // exp(cs_{s|15} - cs_s): M's column factor
  float* cmm = sfs + kMaxC;   // colsum dM o M
  float* cme = cmm + kMaxC;   // colsum dM o E
  float* om = cme + kMaxC;    // omega
  float* psi = om + kMaxC;
  float* dcs = psi + kMaxC;
  float* red = dcs + kMaxC;   // 8 x kMaxC: each row tile's partial of rowsum dM o M

  const Block b = block_of(A);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int rs = warp < 4 ? warp : 11 - warp;
  const int nt = b.cp / 16;
  const bool active = rs < nt;
  const int sa = 16 * rs + g, sb = sa + 8;  // this thread's two rows

  load_tile<kBW>(bt, group_rows(A.bm, A.bb, A.bl, A, b), A.bl, b.cp, b.valid, A.N, A.vec);
  load_tile<kBW>(ct, group_rows(A.cm, A.cb, A.cl, A, b), A.cl, b.cp, b.valid, A.N, A.vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // G^T = B C^T over the causal tiles; the dG sum starts at 0.
  if (active) {
    for (int jt = rs; jt < nt; ++jt) {
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kMaxN / 16; ++kk) {
        if (16 * kk >= b.np_) break;
        unsigned ba[4], cb[4];
        ldsm_x4(ba, bt + swz<kBW>(16 * rs + mr + (mi & 1) * 8, 2 * kk + (mi >> 1)));
        ldsm_x4(cb, ct + swz<kBW>(16 * jt + mr + (mi >> 1) * 8, 2 * kk + (mi & 1)));
        mma(acc[0], ba, cb[0], cb[1]);
        mma(acc[1], ba, cb[2], cb[3]);
      }
      const int sl = frag_slot(rs, jt);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        gsm[(sl + h2) * 32 + lane] = make_float4(acc[h2][0], acc[h2][1], acc[h2][2], acc[h2][3]);
        dgs[(sl + h2) * 32 + lane] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  }

  // The block's dB (rows s) and dC (rows t) partials: 16 columns n a pair.
  float db[16][4], dc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) db[j][e] = dc[j][e] = 0.f;

  for (int i = 0; i < A.hpb; ++i) {
    const int head = b.head0 + i;
    const size_t item = item_idx(A, b, head);
    __syncthreads();  // the previous head's tiles and vectors are consumed
    load_tile<kXW>(xt, head_rows(A.x, A.xb, A.xl, A, b, head), A.xl, b.cp, b.valid, A.P, A.vec);
    load_tile<kXW>(yt, dy_rows(A, b, head), (long long)A.H * A.P, b.cp, b.valid, A.P, A.vec);
    cp_async_commit();
    if (threadIdx.x < kMaxC) {
      const int r = threadIdx.x;
      css[r] = A.cs[item * A.c + min(r, A.c - 1)];
      dts[r] = r < b.valid ? A.dt[((size_t)b.bi * A.L + b.t0 + r) * A.H + head] : 0.f;
    }
    split_state(shi, slo, A.grads + item * A.P * A.N, A.P, A.N, b.pp, b.np_);  // Gamma_{k+1}
    cp_async_wait<0>();
    __syncthreads();
    const float csc = css[A.c - 1];
    if (threadIdx.x < kMaxC) {
      const int r = threadIdx.x;
      ws[r] = expf(csc - css[r]) * dts[r];
      ecs[r] = r < b.valid ? expf(css[r]) : 0.f;
      sfs[r] = ex2((css[r | 15] - css[r]) * kLog2e);
    }
    __syncthreads();

    if (active) {
      // dX = diag(w) B Gamma^T + (M o G)^T dY, rows s; omega from B Gamma^T.
      float dx[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) dx[j][0] = dx[j][1] = dx[j][2] = dx[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMaxN / 16; ++kk) {
        if (16 * kk >= b.np_) break;
        unsigned ba[4];
        ldsm_x4(ba, bt + swz<kBW>(16 * rs + mr + (mi & 1) * 8, 2 * kk + (mi >> 1)));
#pragma unroll
        for (int dp = 0; dp < kMaxP / 16; ++dp) {
          if (16 * dp >= b.pp) break;
          const int off = swz<kBW>(16 * dp + mr + (mi >> 1) * 8, 2 * kk + (mi & 1));
          unsigned gh[4], gl[4];
          ldsm_x4(gh, shi + off);
          ldsm_x4(gl, slo + off);
          mma(dx[2 * dp], ba, gh[0], gh[1]);
          mma(dx[2 * dp], ba, gl[0], gl[1]);
          mma(dx[2 * dp + 1], ba, gh[2], gh[3]);
          mma(dx[2 * dp + 1], ba, gl[2], gl[3]);
        }
      }
      float oa = 0.f, ob = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (8 * j >= b.pp) break;
        const float2 xa = unpack(*reinterpret_cast<const unsigned*>(xt + swz<kXW>(sa, j) + 2 * t4));
        const float2 xb = unpack(*reinterpret_cast<const unsigned*>(xt + swz<kXW>(sb, j) + 2 * t4));
        oa += xa.x * dx[j][0] + xa.y * dx[j][1];
        ob += xb.x * dx[j][2] + xb.y * dx[j][3];
      }
      oa = quad_sum(oa);
      ob = quad_sum(ob);
      if (t4 == 0) {
        om[sa] = oa;
        om[sb] = ob;
      }
      const float wa = ws[sa], wb = ws[sb];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dx[j][0] *= wa;
        dx[j][1] *= wa;
        dx[j][2] *= wb;
        dx[j][3] *= wb;
      }

      // The causal tiles t >= s of Q^T, M and the sums; dX += (M o G)^T dY.
      // Below the diagonal tile E = exp(cs_t - cs_r) exp(cs_r - cs_s), r the
      // warp's last row: both exponents <= 0 (cs falls).
      const float csr = css[16 * rs + 15];
      const int s2[2] = {sa, sb};
      float mm2[2] = {0.f, 0.f}, me2[2] = {0.f, 0.f};
      for (int jt = rs; jt < nt; ++jt) {
        float q[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kMaxP / 16; ++kk) {
          if (16 * kk >= b.pp) break;
          unsigned xa[4], yb[4];
          ldsm_x4(xa, xt + swz<kXW>(16 * rs + mr + (mi & 1) * 8, 2 * kk + (mi >> 1)));
          ldsm_x4(yb, yt + swz<kXW>(16 * jt + mr + (mi >> 1) * 8, 2 * kk + (mi & 1)));
          mma(q[0], xa, yb[0], yb[1]);
          mma(q[1], xa, yb[2], yb[3]);
        }
        const int sl = frag_slot(rs, jt);
        float pv[2][4], colp[2][2];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float4 g4 = gsm[(sl + h2) * 32 + lane];
          const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
          const float4 d4 = dgs[(sl + h2) * 32 + lane];
          float dg[4] = {d4.x, d4.y, d4.z, d4.w};
          colp[h2][0] = colp[h2][1] = 0.f;
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            const int t = 16 * jt + 8 * h2 + 2 * t4 + c2;
            const float tf = jt > rs ? ex2((css[t] - csr) * kLog2e) : 0.f;
#pragma unroll
            for (int r2 = 0; r2 < 2; ++r2) {
              const int e = 2 * r2 + c2;
              const int s = s2[r2];
              const float ev = jt > rs ? tf * sfs[s]
                               : (t >= s ? ex2((css[t] - css[s]) * kLog2e) : 0.f);
              const float mv = ev * dts[s];
              const float dm = gv[e] * q[h2][e];
              mm2[r2] += dm * mv;
              me2[r2] += dm * ev;
              colp[h2][c2] += dm * mv;
              pv[h2][e] = mv * gv[e];
              dg[e] += mv * q[h2][e];
            }
          }
          dgs[(sl + h2) * 32 + lane] = make_float4(dg[0], dg[1], dg[2], dg[3]);
        }
        // rowsum over this warp's rows s of each column t, to `red`.
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
          for (int c2 = 0; c2 < 2; ++c2) {
            float v = colp[h2][c2];
            v += __shfl_xor_sync(kFull, v, 4);
            v += __shfl_xor_sync(kFull, v, 8);
            v += __shfl_xor_sync(kFull, v, 16);
            if (g == 0) red[rs * kMaxC + 16 * jt + 8 * h2 + 2 * t4 + c2] = v;
          }
        unsigned phi[4], plo[4];
        split2(pv[0][0], pv[0][1], phi[0], plo[0]);
        split2(pv[0][2], pv[0][3], phi[1], plo[1]);
        split2(pv[1][0], pv[1][1], phi[2], plo[2]);
        split2(pv[1][2], pv[1][3], phi[3], plo[3]);
#pragma unroll
        for (int dp = 0; dp < kMaxP / 16; ++dp) {
          if (16 * dp >= b.pp) break;
          unsigned yb[4];
          ldsm_x4_trans(yb, yt + swz<kXW>(16 * jt + mr + (mi & 1) * 8, 2 * dp + (mi >> 1)));
          mma(dx[2 * dp], phi, yb[0], yb[1]);
          mma(dx[2 * dp], plo, yb[0], yb[1]);
          mma(dx[2 * dp + 1], phi, yb[2], yb[3]);
          mma(dx[2 * dp + 1], plo, yb[2], yb[3]);
        }
      }
#pragma unroll
      for (int r2 = 0; r2 < 2; ++r2) {
        const float mm = quad_sum(mm2[r2]), me = quad_sum(me2[r2]);
        if (t4 == 0) {
          cmm[s2[r2]] = mm;
          cme[s2[r2]] = me;
        }
      }
      tc::store_rows(dx, A.dx + (((size_t)b.bi * A.L + b.t0) * A.H + head) * A.P,
                     (long long)A.H * A.P, sa, sb, b.valid, A.P);

      // dB += diag(w) X Gamma, rows s.
      unsigned xa[kMaxP / 16][4];
#pragma unroll
      for (int kk = 0; kk < kMaxP / 16; ++kk)
        if (16 * kk < b.pp)
          ldsm_x4(xa[kk], xt + swz<kXW>(16 * rs + mr + (mi & 1) * 8, 2 * kk + (mi >> 1)));
#pragma unroll
      for (int jp = 0; jp < kMaxN / 16; ++jp) {
        if (16 * jp >= b.np_) break;
        float z[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kMaxP / 16; ++kk) {
          if (16 * kk >= b.pp) break;
          const int off = swz<kBW>(16 * kk + mr + (mi & 1) * 8, 2 * jp + (mi >> 1));
          unsigned gh[4], gl[4];
          ldsm_x4_trans(gh, shi + off);
          ldsm_x4_trans(gl, slo + off);
          mma(z[0], xa[kk], gh[0], gh[1]);
          mma(z[0], xa[kk], gl[0], gl[1]);
          mma(z[1], xa[kk], gh[2], gh[3]);
          mma(z[1], xa[kk], gl[2], gl[3]);
        }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          db[2 * jp + h2][0] += wa * z[h2][0];
          db[2 * jp + h2][1] += wa * z[h2][1];
          db[2 * jp + h2][2] += wb * z[h2][2];
          db[2 * jp + h2][3] += wb * z[h2][3];
        }
      }
    }
    __syncthreads();  // Gamma is consumed
    split_state(shi, slo, A.hs + item * A.P * A.N, A.P, A.N, b.pp, b.np_);  // H_k
    __syncthreads();

    if (active) {
      // dC += diag(e^cs) dY H_k, rows t; psi_t = C_t . (dY H_k)_t.
      unsigned ya[kMaxP / 16][4];
#pragma unroll
      for (int kk = 0; kk < kMaxP / 16; ++kk)
        if (16 * kk < b.pp)
          ldsm_x4(ya[kk], yt + swz<kXW>(16 * rs + mr + (mi & 1) * 8, 2 * kk + (mi >> 1)));
      const float ea = ecs[sa], eb = ecs[sb];
      float pa = 0.f, pb = 0.f;
#pragma unroll
      for (int jp = 0; jp < kMaxN / 16; ++jp) {
        if (16 * jp >= b.np_) break;
        float z[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kMaxP / 16; ++kk) {
          if (16 * kk >= b.pp) break;
          const int off = swz<kBW>(16 * kk + mr + (mi & 1) * 8, 2 * jp + (mi >> 1));
          unsigned hh[4], hl[4];
          ldsm_x4_trans(hh, shi + off);
          ldsm_x4_trans(hl, slo + off);
          mma(z[0], ya[kk], hh[0], hh[1]);
          mma(z[0], ya[kk], hl[0], hl[1]);
          mma(z[1], ya[kk], hh[2], hh[3]);
          mma(z[1], ya[kk], hl[2], hl[3]);
        }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float2 ca =
              unpack(*reinterpret_cast<const unsigned*>(ct + swz<kBW>(sa, 2 * jp + h2) + 2 * t4));
          const float2 cb =
              unpack(*reinterpret_cast<const unsigned*>(ct + swz<kBW>(sb, 2 * jp + h2) + 2 * t4));
          pa += ca.x * z[h2][0] + ca.y * z[h2][1];
          pb += cb.x * z[h2][2] + cb.y * z[h2][3];
          dc[2 * jp + h2][0] += ea * z[h2][0];
          dc[2 * jp + h2][1] += ea * z[h2][1];
          dc[2 * jp + h2][2] += eb * z[h2][2];
          dc[2 * jp + h2][3] += eb * z[h2][3];
        }
      }
      pa = quad_sum(pa);
      pb = quad_sum(pb);
      if (t4 == 0) {
        psi[sa] = pa;
        psi[sb] = pb;
      }
    }
    __syncthreads();

    // dcs per row: rowsum - colsum of dM o M + e^cs psi - w omega.
    if (threadIdx.x < A.c) {
      const int r = threadIdx.x;
      float rowsum = 0.f;
      for (int u = 0; u <= r / 16; ++u) rowsum += red[u * kMaxC + r];
      dcs[r] = rowsum - cmm[r] + ecs[r] * psi[r] - ws[r] * om[r];
    }
    __syncthreads();
    if (warp == 0) {
      // The chunk's last row also carries exp(cs_c)'s and w's cs_c terms;
      // then dadt, the reverse cumulative sum (lane l rows 4l..4l+3, a
      // reverse warp scan), and the item's da partial.
      const float* dp = A.dots + item * A.warps;
      float dot = 0.f, wo = 0.f;
      for (int u = lane; u < A.warps; u += 32) dot += dp[u];
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * lane + j;
        v[j] = r < A.c ? dcs[r] : 0.f;
        if (r < A.c) wo += ws[r] * om[r];
      }
      dot = warp_sum(dot);
      wo = warp_sum(wo);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * lane + j == A.c - 1) v[j] += wo + expf(csc) * dot;
      float run = 0.f;
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        run += v[j];
        v[j] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float dn = __shfl_down_sync(kFull, incl, o);
        if (lane + o < 32) incl += dn;
      }
      float excl = __shfl_down_sync(kFull, incl, 1);
      if (lane == 31) excl = 0.f;
      float dap = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * lane + j;
        v[j] += excl;
        if (r < A.c) {
          dcs[r] = v[j];
          dap += dts[r] * v[j];
        }
      }
      dap = warp_sum(dap);
      if (lane == 0) A.dap[item] = dap;
    }
    __syncthreads();
    if (threadIdx.x < b.valid) {
      const int r = threadIdx.x;
      A.ddt[((size_t)b.bi * A.L + b.t0 + r) * A.H + head] =
          cme[r] + om[r] * expf(csc - css[r]) + A.a[head] * dcs[r];
    }
  }

  // The dG sum's products, once a block: dB += dG^T C (rows s, k = t >= s),
  // dC += dG B (rows t, k = s <= t, the (s, t) tiles read transposed).
  __syncthreads();  // the last head's tiles are consumed
  if (active) {
    for (int jt = rs; jt < nt; ++jt) {
      const int sl = frag_slot(rs, jt);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const float4 v = dgs[(sl + h2) * 32 + lane];
        unsigned h01, l01, h23, l23;
        split2(v.x, v.y, h01, l01);
        split2(v.z, v.w, h23, l23);
        const int oa = swz<kBW>(sa, 2 * jt + h2) + 2 * t4, ob = swz<kBW>(sb, 2 * jt + h2) + 2 * t4;
        *reinterpret_cast<unsigned*>(dghi + oa) = h01;
        *reinterpret_cast<unsigned*>(dglo + oa) = l01;
        *reinterpret_cast<unsigned*>(dghi + ob) = h23;
        *reinterpret_cast<unsigned*>(dglo + ob) = l23;
      }
    }
  }
  __syncthreads();
  if (active) {
    for (int jt = rs; jt < nt; ++jt) {
      unsigned ah[4], al[4];
      const int off = swz<kBW>(16 * rs + mr + (mi & 1) * 8, 2 * jt + (mi >> 1));
      ldsm_x4(ah, dghi + off);
      ldsm_x4(al, dglo + off);
#pragma unroll
      for (int jp = 0; jp < kMaxN / 16; ++jp) {
        if (16 * jp >= b.np_) break;
        unsigned cb[4];
        ldsm_x4_trans(cb, ct + swz<kBW>(16 * jt + mr + (mi & 1) * 8, 2 * jp + (mi >> 1)));
        mma(db[2 * jp], ah, cb[0], cb[1]);
        mma(db[2 * jp], al, cb[0], cb[1]);
        mma(db[2 * jp + 1], ah, cb[2], cb[3]);
        mma(db[2 * jp + 1], al, cb[2], cb[3]);
      }
    }
    for (int ks = 0; ks <= rs; ++ks) {
      unsigned ah[4], al[4];
      const int off = swz<kBW>(16 * ks + mr + (mi >> 1) * 8, 2 * rs + (mi & 1));
      ldsm_x4_trans(ah, dghi + off);
      ldsm_x4_trans(al, dglo + off);
#pragma unroll
      for (int jp = 0; jp < kMaxN / 16; ++jp) {
        if (16 * jp >= b.np_) break;
        unsigned bb[4];
        ldsm_x4_trans(bb, bt + swz<kBW>(16 * ks + mr + (mi & 1) * 8, 2 * jp + (mi >> 1)));
        mma(dc[2 * jp], ah, bb[0], bb[1]);
        mma(dc[2 * jp], al, bb[0], bb[1]);
        mma(dc[2 * jp + 1], ah, bb[2], bb[3]);
        mma(dc[2 * jp + 1], al, bb[2], bb[3]);
      }
    }
    const size_t part = (((size_t)b.bi * gridDim.x + blockIdx.x) * A.nch + b.k) * A.c;
    const bool pairs = (A.N & 1) == 0;
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int r = r2 ? sb : sa;
      if (r >= A.c) continue;
      float* ob = A.dbp + (part + r) * A.N;
      float* oc = A.dcp + (part + r) * A.N;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 8 * j + 2 * t4;
        if (col >= A.N) continue;
        if (pairs) {
          *reinterpret_cast<float2*>(ob + col) = make_float2(db[j][2 * r2], db[j][2 * r2 + 1]);
          *reinterpret_cast<float2*>(oc + col) = make_float2(dc[j][2 * r2], dc[j][2 * r2 + 1]);
        } else {
          ob[col] = db[j][2 * r2];
          oc[col] = dc[j][2 * r2];
          if (col + 1 < A.N) {
            ob[col + 1] = db[j][2 * r2 + 1];
            oc[col + 1] = dc[j][2 * r2 + 1];
          }
        }
      }
    }
  }
}

// (a'') The tangent chunk state on the tensor cores: the forward's pass (a)
// with two split A operands, (Xdot o w + X o wdot)^T against B and (X o w)^T
// against Bdot, plus csdot_c exp(cs_c) H_k; csdot by the forward's warp
// scan (written out with exp(cs_c) for the state pass and (c'')).  Per head
// X, Xdot, dt, dtdot and cs double-buffered; B and Bdot once a block.
constexpr size_t kJvpStateSmem =
    sizeof(bf16) * (2 * kTile + 4 * kXTile) + sizeof(float) * 9 * kMaxC;

__device__ __forceinline__ void load_jvp_head(const GradArgs<bf16>& A, const Block& b, bf16* xt,
                                              bf16* txt, float* dts, float* tdts, float* css,
                                              int head) {
  load_tile<kXW>(xt, head_rows(A.x, A.xb, A.xl, A, b, head), A.xl, b.cp, b.valid, A.P, A.vec);
  load_tile<kXW>(txt, head_rows(A.tx, A.txb, A.txl, A, b, head), A.txl, b.cp, b.valid, A.P,
                 A.vec);
  if (threadIdx.x < kMaxC) {
    const int r = threadIdx.x;
    const bool ok = r < b.valid;
    const size_t at = ((size_t)b.bi * A.L + b.t0 + (ok ? r : 0)) * A.H + head;
    cp_async4(dts + r, A.dt + at, ok);
    cp_async4(tdts + r, A.tdt + at, ok);
    cp_async4(css + r, A.cs + item_idx(A, b, head) * A.c + min(r, A.c - 1), true);
  }
}

__global__ void __launch_bounds__(kThreads, 1) ssd_jvp_chunk_state_tc(const GradArgs<bf16> A) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* bt = reinterpret_cast<bf16*>(smem_raw);  // B
  bf16* tbt = bt + kTile;                        // Bdot
  bf16* xt = tbt + kTile;                        // X: 2 stages
  bf16* txt = xt + 2 * kXTile;                   // Xdot: 2 stages
  float* dts = reinterpret_cast<float*>(txt + 2 * kXTile);  // 2 stages each of dt, dtdot, cs
  float* tdts = dts + 2 * kMaxC;
  float* css = tdts + 2 * kMaxC;
  float* ws = css + 2 * kMaxC;  // w
  float* tws = ws + kMaxC;      // wdot
  float* tcs = tws + kMaxC;     // csdot
  const Block b = block_of(A);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t4 = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int mt = warp & 3, nh = warp >> 2;
  const bool active = 16 * mt < b.pp && 64 * nh < b.np_;
  load_tile<kBW>(bt, group_rows(A.bm, A.bb, A.bl, A, b), A.bl, b.cp, b.valid, A.N, A.vec);
  load_tile<kBW>(tbt, group_rows(A.tbm, A.tbb, A.tbl, A, b), A.tbl, b.cp, b.valid, A.N, A.vec);
  load_jvp_head(A, b, xt, txt, dts, tdts, css, b.head0);
  cp_async_commit();
  if (A.hpb > 1)
    load_jvp_head(A, b, xt + kXTile, txt + kXTile, dts + kMaxC, tdts + kMaxC, css + kMaxC,
                  b.head0 + 1);
  cp_async_commit();
  for (int i = 0; i < A.hpb; ++i) {
    const int st = i & 1, head = b.head0 + i;
    const size_t item = item_idx(A, b, head);
    const float* dt_s = dts + st * kMaxC;
    const float* tdt_s = tdts + st * kMaxC;
    const float* cs_s = css + st * kMaxC;
    cp_async_wait<1>();
    __syncthreads();
    if (warp == 0) {
      // csdot = cumsum(adot dt + a dtdot): the forward's scan (four rows a
      // lane in order, the lane totals by shuffles, then the lane's
      // exclusive prefix).
      const float ah = A.a[head], tah = A.ta[head];
      float v[4], run = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        run += tah * dt_s[4 * lane + j] + ah * tdt_s[4 * lane + j];
        v[j] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += up;
      }
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.f;
      float pick = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] += excl;
        if (j == ((A.c - 1) & 3)) pick = v[j];
      }
      const float tot = __shfl_sync(kFull, pick, (A.c - 1) >> 2);
      const float csc = cs_s[A.c - 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * lane + j;
        const float ew = expf(csc - cs_s[r]);
        tcs[r] = v[j];
        ws[r] = ew * dt_s[r];
        tws[r] = ws[r] * (tot - v[j]) + ew * tdt_s[r];
        if (r < A.c) A.dcs[item * A.c + r] = v[j];
      }
      if (lane == 0) A.decay[item] = expf(csc);
    }
    __syncthreads();
    if (active) {
      const bf16* xs = xt + st * kXTile;
      const bf16* txs = txt + st * kXTile;
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMaxC / 16; ++kk) {
        if (16 * kk >= b.cp) break;
        unsigned xa[4], txa[4], a1h[4], a1l[4], a2h[4], a2l[4];
        const int off = swz<kXW>(16 * kk + mr + (mi >> 1) * 8, 2 * mt + (mi & 1));
        ldsm_x4_trans(xa, xs + off);
        ldsm_x4_trans(txa, txs + off);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int t = 16 * kk + 8 * (r >> 1) + 2 * t4;
          const float2 wv = *reinterpret_cast<const float2*>(ws + t);
          const float2 twv = *reinterpret_cast<const float2*>(tws + t);
          const float2 xv = unpack(xa[r]), txv = unpack(txa[r]);
          split2(txv.x * wv.x + xv.x * twv.x, txv.y * wv.y + xv.y * twv.y, a1h[r], a1l[r]);
          split2(xv.x * wv.x, xv.y * wv.y, a2h[r], a2l[r]);
        }
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (64 * nh + 16 * jp >= b.np_) break;
          const int boff = swz<kBW>(16 * kk + mr + (mi & 1) * 8, 8 * nh + 2 * jp + (mi >> 1));
          unsigned bb[4], tb[4];
          ldsm_x4_trans(bb, bt + boff);
          ldsm_x4_trans(tb, tbt + boff);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            mma(acc[2 * jp + h2], a1h, bb[2 * h2], bb[2 * h2 + 1]);
            mma(acc[2 * jp + h2], a1l, bb[2 * h2], bb[2 * h2 + 1]);
            mma(acc[2 * jp + h2], a2h, tb[2 * h2], tb[2 * h2 + 1]);
            mma(acc[2 * jp + h2], a2l, tb[2 * h2], tb[2 * h2 + 1]);
          }
        }
      }
      const size_t pn = (size_t)A.P * A.N;
      tc::store_state(acc, A.tstates + item * pn, A.P, A.N, mt, nh, A.hs + item * pn,
                      tcs[A.c - 1] * expf(cs_s[A.c - 1]));
    }
    __syncthreads();  // stage st and the weights are consumed
    if (i + 2 < A.hpb)
      load_jvp_head(A, b, xt + st * kXTile, txt + st * kXTile, dts + st * kMaxC,
                    tdts + st * kMaxC, css + st * kMaxC, head + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();
}

// (c'') Ydot on the tensor cores: the forward's pass (c) carrying tangent
// pairs.  The warp's 16 rows t: rt = warp for warps 0-3, 11 - warp above.
// G stays in registers across the heads; Gdot, formed once a block too, in
// shared memory in fragment order (slot 2 (rt (rt + 1) / 2 + jp) (+1) for
// column tiles jp <= rt), since both in registers spilled.  C, Cdot, X,
// Xdot, and B and Bdot for G and Gdot, whose tiles then take H_k's and
// Hdot_k's splits; cs, dt, dtdot, csdot and M's column factor.
constexpr size_t kJvpOutSmem = sizeof(bf16) * (4 * kTile + 2 * kXTile) +
                               sizeof(float4) * kFragSlots * 32 + sizeof(float) * 5 * kMaxC;

__global__ void __launch_bounds__(kThreads, 1) ssd_jvp_chunk_out_tc(const GradArgs<bf16> A) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ct = reinterpret_cast<bf16*>(smem_raw);  // C
  bf16* tct = ct + kTile;                        // Cdot
  bf16* bt = tct + kTile;                        // B, then H_k hi | lo
  bf16* tbt = bt + kTile;                        // Bdot, then Hdot_k hi | lo
  bf16* hhi = bt, *hlo = bt + kHTile, *thi = tbt, *tlo = tbt + kHTile;
  bf16* xt = tbt + kTile;                        // X
  bf16* txt = xt + kXTile;                       // Xdot
  float4* tgs = reinterpret_cast<float4*>(txt + kXTile);  // Gdot, fragment order
  float* css = reinterpret_cast<float*>(tgs + kFragSlots * 32);  // kMaxC each
  float* dts = css + kMaxC;
  float* tdts = dts + kMaxC;
  float* tcs = tdts + kMaxC;
  float* ecol = tcs + kMaxC;  // exp(cs_{s|15} - cs_s)

  const Block b = block_of(A);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int rt = warp < 4 ? warp : 11 - warp;
  const bool active = 16 * rt < b.cp;
  load_tile<kBW>(ct, group_rows(A.cm, A.cb, A.cl, A, b), A.cl, b.cp, b.valid, A.N, A.vec);
  load_tile<kBW>(tct, group_rows(A.tcm, A.tcb, A.tcl, A, b), A.tcl, b.cp, b.valid, A.N, A.vec);
  load_tile<kBW>(bt, group_rows(A.bm, A.bb, A.bl, A, b), A.bl, b.cp, b.valid, A.N, A.vec);
  load_tile<kBW>(tbt, group_rows(A.tbm, A.tbb, A.tbl, A, b), A.tbl, b.cp, b.valid, A.N, A.vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // G = C B^T (registers) and Gdot = Cdot B^T + C Bdot^T (fragment order)
  // for this warp's rows, column tiles at or below the diagonal.
  const int gbase = 2 * (rt * (rt + 1) / 2);
  float gacc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) gacc[j][0] = gacc[j][1] = gacc[j][2] = gacc[j][3] = 0.f;
  if (active) {
#pragma unroll
    for (int kk = 0; kk < kMaxN / 16; ++kk) {
      if (16 * kk >= b.np_) break;
      unsigned ca[4];
      ldsm_x4(ca, ct + swz<kBW>(16 * rt + mr + (mi & 1) * 8, 2 * kk + (mi >> 1)));
#pragma unroll
      for (int jp = 0; jp < kMaxC / 16; ++jp) {
        if (jp > rt) break;
        unsigned bb[4];
        ldsm_x4(bb, bt + swz<kBW>(16 * jp + mr + (mi >> 1) * 8, 2 * kk + (mi & 1)));
        mma(gacc[2 * jp], ca, bb[0], bb[1]);
        mma(gacc[2 * jp + 1], ca, bb[2], bb[3]);
      }
    }
    for (int jp = 0; jp <= rt; ++jp) {
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kMaxN / 16; ++kk) {
        if (16 * kk >= b.np_) break;
        unsigned ca[4], tca[4], bb[4], tb[4];
        const int aoff = swz<kBW>(16 * rt + mr + (mi & 1) * 8, 2 * kk + (mi >> 1));
        const int boff = swz<kBW>(16 * jp + mr + (mi >> 1) * 8, 2 * kk + (mi & 1));
        ldsm_x4(ca, ct + aoff);
        ldsm_x4(tca, tct + aoff);
        ldsm_x4(bb, bt + boff);
        ldsm_x4(tb, tbt + boff);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          mma(acc[h2], tca, bb[2 * h2], bb[2 * h2 + 1]);
          mma(acc[h2], ca, tb[2 * h2], tb[2 * h2 + 1]);
        }
      }
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2)
        tgs[(gbase + 2 * jp + h2) * 32 + lane] =
            make_float4(acc[h2][0], acc[h2][1], acc[h2][2], acc[h2][3]);
    }
  }

  const int ta = 16 * rt + g, tb_ = ta + 8;  // this thread's two rows
  for (int i = 0; i < A.hpb; ++i) {
    const int head = b.head0 + i;
    const size_t item = item_idx(A, b, head);
    __syncthreads();  // B and Bdot, or the previous head's tiles, are consumed
    load_tile<kXW>(xt, head_rows(A.x, A.xb, A.xl, A, b, head), A.xl, b.cp, b.valid, A.P, A.vec);
    load_tile<kXW>(txt, head_rows(A.tx, A.txb, A.txl, A, b, head), A.txl, b.cp, b.valid, A.P,
                   A.vec);
    cp_async_commit();
    if (threadIdx.x < kMaxC) {
      const int r = threadIdx.x;
      const bool ok = r < b.valid;
      const size_t at = ((size_t)b.bi * A.L + b.t0 + r) * A.H + head;
      css[r] = A.cs[item * A.c + min(r, A.c - 1)];
      tcs[r] = A.dcs[item * A.c + min(r, A.c - 1)];
      dts[r] = ok ? A.dt[at] : 0.f;
      tdts[r] = ok ? A.tdt[at] : 0.f;
    }
    split_state(hhi, hlo, A.hs + item * A.P * A.N, A.P, A.N, b.pp, b.np_);
    split_state(thi, tlo, A.tstates + item * A.P * A.N, A.P, A.N, b.pp, b.np_);
    cp_async_wait<0>();
    __syncthreads();
    if (threadIdx.x < kMaxC) {
      const int s = threadIdx.x;
      ecol[s] = ex2((css[s | 15] - css[s]) * kLog2e);
    }
    __syncthreads();

    if (active) {
      float y[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.f;
      // The state term: e^cs o (csdot o (C H_k^T) + Cdot H_k^T + C Hdot_k^T).
#pragma unroll
      for (int kk = 0; kk < kMaxN / 16; ++kk) {
        if (16 * kk >= b.np_) break;
        unsigned ca[4];
        ldsm_x4(ca, ct + swz<kBW>(16 * rt + mr + (mi & 1) * 8, 2 * kk + (mi >> 1)));
#pragma unroll
        for (int dp = 0; dp < kMaxP / 16; ++dp) {
          if (16 * dp >= b.pp) break;
          const int off = swz<kBW>(16 * dp + mr + (mi >> 1) * 8, 2 * kk + (mi & 1));
          unsigned bh[4], bl[4];
          ldsm_x4(bh, hhi + off);
          ldsm_x4(bl, hlo + off);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            mma(y[2 * dp + h2], ca, bh[2 * h2], bh[2 * h2 + 1]);
            mma(y[2 * dp + h2], ca, bl[2 * h2], bl[2 * h2 + 1]);
          }
        }
      }
      const float csa = css[ta], csb = css[tb_];
      const float tca_ = tcs[ta], tcb_ = tcs[tb_];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y[j][0] *= tca_;
        y[j][1] *= tca_;
        y[j][2] *= tcb_;
        y[j][3] *= tcb_;
      }
#pragma unroll
      for (int kk = 0; kk < kMaxN / 16; ++kk) {
        if (16 * kk >= b.np_) break;
        unsigned ca[4], tca[4];
        const int aoff = swz<kBW>(16 * rt + mr + (mi & 1) * 8, 2 * kk + (mi >> 1));
        ldsm_x4(ca, ct + aoff);
        ldsm_x4(tca, tct + aoff);
#pragma unroll
        for (int dp = 0; dp < kMaxP / 16; ++dp) {
          if (16 * dp >= b.pp) break;
          const int off = swz<kBW>(16 * dp + mr + (mi >> 1) * 8, 2 * kk + (mi & 1));
          unsigned bh[4], bl[4], th[4], tl[4];
          ldsm_x4(bh, hhi + off);
          ldsm_x4(bl, hlo + off);
          ldsm_x4(th, thi + off);
          ldsm_x4(tl, tlo + off);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            mma(y[2 * dp + h2], tca, bh[2 * h2], bh[2 * h2 + 1]);
            mma(y[2 * dp + h2], tca, bl[2 * h2], bl[2 * h2 + 1]);
            mma(y[2 * dp + h2], ca, th[2 * h2], th[2 * h2 + 1]);
            mma(y[2 * dp + h2], ca, tl[2 * h2], tl[2 * h2 + 1]);
          }
        }
      }
      const float ea = expf(csa), eb = expf(csb);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        y[j][0] *= ea;
        y[j][1] *= ea;
        y[j][2] *= eb;
        y[j][3] *= eb;
      }
      // (Mdot o G + M o Gdot) X + (M o G) Xdot, 16 columns s a step.
#pragma unroll
      for (int kk = 0; kk < kMaxC / 16; ++kk) {
        if (kk > rt) break;
        const float cs_r = css[16 * kk + 15];
        const float ra = ex2((csa - cs_r) * kLog2e), rb = ex2((csb - cs_r) * kLog2e);
        float w1[2][4], w0[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float4 t4g = tgs[(gbase + 2 * kk + jj) * 32 + lane];
          const float tg4[4] = {t4g.x, t4g.y, t4g.z, t4g.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = 16 * kk + 8 * jj + 2 * t4 + (e & 1);
            const int t = e < 2 ? ta : tb_;
            float ev;
            if (kk < rt) {  // below the diagonal tile: row factor x column factor
              ev = (e < 2 ? ra : rb) * ecol[s];
            } else {        // the diagonal tile: masked before the exp
              ev = s <= t ? ex2(((e < 2 ? csa : csb) - css[s]) * kLog2e) : 0.f;
            }
            const float mv = ev * dts[s];
            const float tmv = mv * ((e < 2 ? tca_ : tcb_) - tcs[s]) + ev * tdts[s];
            const float gv = gacc[2 * kk + jj][e], tgv = tg4[e];
            w1[jj][e] = tmv * gv + mv * tgv;
            w0[jj][e] = mv * gv;
          }
        }
        unsigned w1h[4], w1l[4], w0h[4], w0l[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          split2(w1[r >> 1][2 * (r & 1)], w1[r >> 1][2 * (r & 1) + 1], w1h[r], w1l[r]);
          split2(w0[r >> 1][2 * (r & 1)], w0[r >> 1][2 * (r & 1) + 1], w0h[r], w0l[r]);
        }
#pragma unroll
        for (int dp = 0; dp < kMaxP / 16; ++dp) {
          if (16 * dp >= b.pp) break;
          const int off = swz<kXW>(16 * kk + mr + (mi & 1) * 8, 2 * dp + (mi >> 1));
          unsigned bx[4], tbx[4];
          ldsm_x4_trans(bx, xt + off);
          ldsm_x4_trans(tbx, txt + off);
#pragma unroll
          for (int h2 = 0; h2 < 2; ++h2) {
            mma(y[2 * dp + h2], w1h, bx[2 * h2], bx[2 * h2 + 1]);
            mma(y[2 * dp + h2], w1l, bx[2 * h2], bx[2 * h2 + 1]);
            mma(y[2 * dp + h2], w0h, tbx[2 * h2], tbx[2 * h2 + 1]);
            mma(y[2 * dp + h2], w0l, tbx[2 * h2], tbx[2 * h2 + 1]);
          }
        }
      }
      tc::store_rows(y, A.ty + (((size_t)b.bi * A.L + b.t0) * A.H + head) * A.P,
                     (long long)A.H * A.P, ta, tb_, b.valid, A.P);
    }
  }
}

// Checks of the sizes and of the caller's grids (the wrapper's grad_plan):
// `items` (heads / heads a block, chunks, batch) for the chunk passes,
// `pass` ((batch, head) pairs, blocks of state elements) for the state
// passes; f32 takes one head a block.
template <typename T>
bool grids_ok(const GradArgs<T>& A, dim3 items, dim3 pass) {
  const int pn = A.P * A.N;
  constexpr bool kTensorCores = std::is_same<T, bf16>::value;
  return A.B > 0 && A.L > 0 && A.H > 0 && A.G > 0 && A.H % A.G == 0 && A.P > 0 && A.N > 0 &&
         A.c > 0 && A.c <= kMaxC && A.P <= kMaxP && A.N <= kMaxN &&
         A.nch == (A.L + A.c - 1) / A.c && A.nch <= 65535 && A.B <= 65535 &&
         (long long)A.B * A.H <= 0x7fffffff && A.hpb > 0 && (kTensorCores || A.hpb == 1) &&
         (A.H / A.G) % A.hpb == 0 && items.x == (unsigned)(A.H / A.hpb) &&
         items.y == (unsigned)A.nch && items.z == (unsigned)A.B &&
         pass.x == (unsigned)(A.B * A.H) && pass.y == (unsigned)((pn + kThreads - 1) / kThreads) &&
         pass.z == 1 && A.warps == (int)pass.y * (kThreads / 32);
}

template <typename K>
cudaError_t opt_in(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// (r)'s grid: one thread per dB / dC element, at most 4 096 blocks.
template <typename T>
unsigned group_sum_blocks(const GradArgs<T>& A) {
  const size_t total = (size_t)A.B * A.L * A.G * A.N;
  return (unsigned)((total + kThreads - 1) / kThreads < 4096 ? (total + kThreads - 1) / kThreads
                                                            : 4096);
}

template <typename T>
int launch_bwd(const GradArgs<T>& A, dim3 items, dim3 pass, cudaStream_t st) {
  if (!grids_ok(A, items, pass)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {  // four launches on the tensor cores
    static const cudaError_t opted[] = {opt_in(ssd_bwd_chunk_state_tc, kBwdStateSmem),
                                        opt_in(ssd_bwd_chunk_tc, kBwdChunkSmem)};
    for (cudaError_t e : opted)
      if (e != cudaSuccess) return (int)e;
    ssd_bwd_chunk_state_tc<<<items, kThreads, kBwdStateSmem, st>>>(A);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_state_pass<<<pass, kThreads, 0, st>>>(A.grads, A.hs, A.cs, A.dh_last, A.dh0, A.dots,
                                                  A.nch, A.c, A.P * A.N);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_chunk_tc<<<items, kThreads, kBwdChunkSmem, st>>>(A);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_group_sum<T><<<group_sum_blocks(A), kThreads, 0, st>>>(A);
    return (int)cudaGetLastError();
  } else {
    const Dims big = dims_of(kMaxC, kMaxP, kMaxN), d = dims_of(A.c, A.P, A.N);
    static const cudaError_t opted[] = {  // once per process, at the largest sizes
        opt_in(ssd_bwd_chunk_state<T>, sizeof(float) * state_floats(big)),
        opt_in(ssd_bwd_scores<T>, sizeof(float) * scores_floats(big)),
        opt_in(ssd_bwd_dx<T>, sizeof(float) * dx_floats(big)),
        opt_in(ssd_bwd_db<T>, sizeof(float) * db_floats(big)),
        opt_in(ssd_bwd_dc<T>, sizeof(float) * dc_floats(big))};
    for (cudaError_t e : opted)
      if (e != cudaSuccess) return (int)e;
    ssd_bwd_chunk_state<T><<<items, kThreads, sizeof(float) * state_floats(d), st>>>(A);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_state_pass<<<pass, kThreads, 0, st>>>(A.grads, A.hs, A.cs, A.dh_last, A.dh0, A.dots,
                                                  A.nch, A.c, A.P * A.N);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_scores<T><<<items, kThreads, sizeof(float) * scores_floats(d), st>>>(A);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_dx<T><<<items, kThreads, sizeof(float) * dx_floats(d), st>>>(A);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_db<T><<<items, kThreads, sizeof(float) * db_floats(d), st>>>(A);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_dc<T><<<items, kThreads, sizeof(float) * dc_floats(d), st>>>(A);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_group_sum<T><<<group_sum_blocks(A), kThreads, 0, st>>>(A);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_bwd_da<T><<<1, kThreads, 0, st>>>(A);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int launch_jvp(const GradArgs<T>& A, dim3 items, dim3 pass, cudaStream_t st) {
  if (!grids_ok(A, items, pass)) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    static const cudaError_t opted[] = {opt_in(ssd_jvp_chunk_state_tc, kJvpStateSmem),
                                        opt_in(ssd_jvp_chunk_out_tc, kJvpOutSmem)};
    for (cudaError_t e : opted)
      if (e != cudaSuccess) return (int)e;
    ssd_jvp_chunk_state_tc<<<items, kThreads, kJvpStateSmem, st>>>(A);
  } else {
    const Dims big = dims_of(kMaxC, kMaxP, kMaxN), d = dims_of(A.c, A.P, A.N);
    static const cudaError_t opted[] = {
        opt_in(ssd_jvp_chunk_state<T>, sizeof(float) * jstate_floats(big)),
        opt_in(ssd_jvp_chunk_out<T>, sizeof(float) * jout_floats(big))};
    for (cudaError_t e : opted)
      if (e != cudaSuccess) return (int)e;
    ssd_jvp_chunk_state<T><<<items, kThreads, sizeof(float) * jstate_floats(d), st>>>(A);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_scan_state_pass<<<pass, kThreads, 0, st>>>(A.tstates, A.decay, A.th0, A.th_last, A.nch,
                                                 A.P * A.N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if constexpr (std::is_same<T, bf16>::value) {
    ssd_jvp_chunk_out_tc<<<items, kThreads, kJvpOutSmem, st>>>(A);
  } else {
    const Dims d = dims_of(A.c, A.P, A.N);
    ssd_jvp_chunk_out<T><<<items, kThreads, sizeof(float) * jout_floats(d), st>>>(A);
  }
  return (int)cudaGetLastError();
}

}  // namespace grad

// The backward's and the tangent map's entry points: the wrapper allocates
// outputs and scratch (grad_plan) and passes its grids.
template <typename T>
grad::GradArgs<T> grad_args(const void* x, const void* dt, const void* a, const void* bmat,
                            const void* cmat, const void* hs, const void* cs, int64_t xb,
                            int64_t xl, int64_t bb, int64_t bl, int64_t cb, int64_t cl, int b,
                            int L, int H, int P, int G, int N, int c, int hpb, int vec,
                            int sy) {
  grad::GradArgs<T> A = {};
  A.x = static_cast<const T*>(x);
  A.bm = static_cast<const T*>(bmat);
  A.cm = static_cast<const T*>(cmat);
  A.dt = static_cast<const float*>(dt);
  A.a = static_cast<const float*>(a);
  A.hs = static_cast<const float*>(hs);
  A.cs = static_cast<const float*>(cs);
  A.xb = xb, A.xl = xl, A.bb = bb, A.bl = bl, A.cb = cb, A.cl = cl;
  A.B = b, A.L = L, A.H = H, A.P = P, A.G = G, A.N = N, A.c = c;
  A.nch = (L + c - 1) / c;
  A.hpb = hpb, A.vec = vec;
  A.warps = sy * (kThreads / 32);
  return A;
}

}  // namespace

#define REPRO_SSD_ENTRY_POINT(T, SUFFIX)                                                    \
  extern "C" int ssd_scan_##SUFFIX(                                                         \
      const void* x, const void* dt, const void* a, const void* bmat, const void* cmat,     \
      const void* h0, void* y, void* h_out, void* states, void* cs, void* decay,            \
      int64_t xb, int64_t xl, int64_t bb, int64_t bl, int64_t cb, int64_t cl, int b, int L, \
      int H, int P, int G, int N, int c, int hpb, int vec, int gx, int gy, int gz, int sx,  \
      int sy, void* stream) {                                                               \
    Args<T> A{static_cast<const T*>(x), static_cast<const float*>(dt),                      \
              static_cast<const float*>(a), static_cast<const T*>(bmat),                    \
              static_cast<const T*>(cmat), static_cast<const float*>(h0),                   \
              static_cast<T*>(y), static_cast<float*>(h_out), static_cast<float*>(states),  \
              static_cast<float*>(cs), static_cast<float*>(decay), xb, xl, bb, bl, cb, cl,  \
              L, H, P, G, N, c, (L + c - 1) / c, hpb, vec};                                 \
    return launch_ssd<T>(A, b, dim3(gx, gy, gz), dim3(sx, sy),                              \
                         static_cast<cudaStream_t>(stream));                                \
  }

REPRO_SSD_ENTRY_POINT(float, f32)
REPRO_SSD_ENTRY_POINT(__nv_bfloat16, bf16)

#define REPRO_SSD_GRAD_ENTRY_POINTS(T, SUFFIX)                                                \
  extern "C" int ssd_scan_bwd_##SUFFIX(                                                       \
      const void* x, const void* dt, const void* a, const void* bmat, const void* cmat,       \
      const void* dy, const void* hs, const void* cs, const void* dh_last, void* dx,          \
      void* ddt, void* da, void* db, void* dc, void* dh0, void* grads, void* scores,          \
      void* rows, void* dots, void* dbp, void* dcp, void* dap, int64_t xb, int64_t xl,        \
      int64_t bb, int64_t bl, int64_t cb, int64_t cl, int b, int L, int H, int P, int G,      \
      int N, int c, int hpb, int vec, int ix, int iy, int iz, int sx, int sy,                 \
      void* stream) {                                                                         \
    grad::GradArgs<T> A = grad_args<T>(x, dt, a, bmat, cmat, hs, cs, xb, xl, bb, bl, cb, cl, \
                                       b, L, H, P, G, N, c, hpb, vec, sy);                    \
    A.dy = static_cast<const T*>(dy);                                                         \
    A.dh_last = static_cast<const float*>(dh_last);                                           \
    A.dx = static_cast<T*>(dx);                                                               \
    A.ddt = static_cast<float*>(ddt);                                                         \
    A.da = static_cast<float*>(da);                                                           \
    A.db = static_cast<T*>(db);                                                               \
    A.dc = static_cast<T*>(dc);                                                               \
    A.dh0 = static_cast<float*>(dh0);                                                         \
    A.grads = static_cast<float*>(grads);                                                     \
    A.scores = static_cast<float*>(scores);                                                   \
    A.rows = static_cast<float*>(rows);                                                       \
    A.dots = static_cast<float*>(dots);                                                       \
    A.dbp = static_cast<float*>(dbp);                                                         \
    A.dcp = static_cast<float*>(dcp);                                                         \
    A.dap = static_cast<float*>(dap);                                                         \
    return grad::launch_bwd<T>(A, dim3(ix, iy, iz), dim3(sx, sy),                             \
                               static_cast<cudaStream_t>(stream));                            \
  }                                                                                           \
  extern "C" int ssd_scan_jvp_##SUFFIX(                                                       \
      const void* x, const void* dt, const void* a, const void* bmat, const void* cmat,       \
      const void* hs, const void* cs, const void* tx, const void* tdt, const void* ta,        \
      const void* tbmat, const void* tcmat, const void* th0, void* ty, void* th_last,         \
      void* tstates, void* dcs, void* decay, int64_t xb, int64_t xl, int64_t bb, int64_t bl,  \
      int64_t cb, int64_t cl, int64_t txb, int64_t txl, int64_t tbb, int64_t tbl,             \
      int64_t tcb, int64_t tcl, int b, int L, int H, int P, int G, int N, int c, int hpb,     \
      int vec, int ix, int iy, int iz, int sx, int sy, void* stream) {                        \
    grad::GradArgs<T> A = grad_args<T>(x, dt, a, bmat, cmat, hs, cs, xb, xl, bb, bl, cb, cl, \
                                       b, L, H, P, G, N, c, hpb, vec, sy);                    \
    A.tx = static_cast<const T*>(tx);                                                         \
    A.tbm = static_cast<const T*>(tbmat);                                                     \
    A.tcm = static_cast<const T*>(tcmat);                                                     \
    A.tdt = static_cast<const float*>(tdt);                                                   \
    A.ta = static_cast<const float*>(ta);                                                     \
    A.th0 = static_cast<const float*>(th0);                                                   \
    A.txb = txb, A.txl = txl, A.tbb = tbb, A.tbl = tbl, A.tcb = tcb, A.tcl = tcl;             \
    A.ty = static_cast<T*>(ty);                                                               \
    A.th_last = static_cast<float*>(th_last);                                                 \
    A.tstates = static_cast<float*>(tstates);                                                 \
    A.dcs = static_cast<float*>(dcs);                                                         \
    A.decay = static_cast<float*>(decay);                                                     \
    return grad::launch_jvp<T>(A, dim3(ix, iy, iz), dim3(sx, sy),                             \
                               static_cast<cudaStream_t>(stream));                            \
  }

REPRO_SSD_GRAD_ENTRY_POINTS(float, f32)
REPRO_SSD_GRAD_ENTRY_POINTS(__nv_bfloat16, bf16)
